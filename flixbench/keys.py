"""Key streams made on the card from a seed.

``KeyRing`` is a keyed permutation of ``[0, 2**bits)``: position ``p`` of
the ring holds key ``ring.key(p)``, and distinct positions hold distinct
keys.  A traffic mix walks it: the live keys are a window of positions, a
batch deletes from the window's old end and inserts at its new end, so a
delete always hits a live key and an insert is always absent.  Any window
can be rebuilt from its position alone.

``scrambled_zipf`` is YCSB's ``ScrambledZipfianGenerator``: Zipfian ranks
over YCSB's ten billion items, hashed by 64-bit FNV-1a into the item count,
so the popular items lie anywhere in the key space.
"""

from __future__ import annotations

import numpy as np
import torch

ROUNDS = 4


class KeyRing:
    """Positions ``0 .. size - 1`` mapped to unique keys in ``[0, 2**bits)``
    by rounds of (xor a key, multiply by an odd constant, xor-shift), each a
    bijection modulo ``2**bits``."""

    def __init__(self, bits: int, size: int, seed: int):
        if not 1 <= bits <= 31 or size > 1 << bits:
            raise ValueError(f"a ring of {size} keys does not fit in {bits} bits")
        rng = np.random.default_rng([seed, 0x5EED])
        self.bits, self.size = bits, size
        self.mask = (1 << bits) - 1
        self.rounds = [
            (int(rng.integers(0, 1 << bits)), int(rng.integers(0, 1 << 30)) * 2 + 1)
            for _ in range(ROUNDS)
        ]

    def key(self, pos: torch.Tensor) -> torch.Tensor:
        """int32 keys of the (int64) ring positions, taken modulo the size."""
        x = pos.to(torch.int64) % self.size
        shift = (self.bits + 1) // 2
        for k, c in self.rounds:
            x = ((x ^ k) * c) & self.mask
            x = x ^ (x >> shift)
        return x.to(torch.int32)

    def window(self, start: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys and values (the position modulo the size: a row id) of the
        positions ``[start, start + n)``."""
        pos = torch.arange(start, start + n, dtype=torch.int64, device=device)
        return self.key(pos), (pos % self.size).to(torch.int32)


# YCSB's ZipfianGenerator constants for ScrambledZipfianGenerator
YCSB_ITEMS = 10_000_000_000
YCSB_ZETAN = 26.46902820178302  # zeta(YCSB_ITEMS, 0.99), as YCSB precomputes it
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 1099511628211


def _as_signed64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def fnv1a64(v: torch.Tensor) -> torch.Tensor:
    """YCSB's ``Utils.fnvhash64`` on int64 tensors (Java's wrapping longs,
    then ``Math.abs``)."""
    h = torch.full_like(v, _as_signed64(FNV_OFFSET))
    for _ in range(8):
        h = h ^ (v & 0xFF)
        h = h * FNV_PRIME  # wraps as Java's long does
        v = v >> 8
    return h.abs()


def scrambled_zipf(
    n: int, items: int, gen: torch.Generator, theta: float = 0.99
) -> torch.Tensor:
    """``n`` item indices in ``[0, items)`` (int64), YCSB's scrambled
    Zipfian with constant ``theta``: a Zipfian rank over ``YCSB_ITEMS``
    (Gray et al.'s method, as YCSB's ``nextLong``), hashed into ``items``."""
    if theta != 0.99:
        raise ValueError("YCSB's precomputed zeta holds for the constant 0.99 only")
    zeta2 = 1.0 + 0.5**theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / YCSB_ITEMS) ** (1.0 - theta)) / (1.0 - zeta2 / YCSB_ZETAN)
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
    uz = u * YCSB_ZETAN
    rank = (YCSB_ITEMS * (eta * u - eta + 1.0) ** alpha).to(torch.int64)
    rank = torch.where(uz < 1.0 + 0.5**theta, 1, rank)
    rank = torch.where(uz < 1.0, 0, rank)
    return fnv1a64(rank) % items
