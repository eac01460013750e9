"""Synthetic LM data pipeline (port of ``repro/data/pipeline.py``).

Production properties the trainer depends on:
  * **Deterministic**: batch ``i`` is a pure function of (seed, i) — any
    host can regenerate any step, so restarts need no data server handshake.
  * **Resumable**: iterator state is one integer (next step), stored in the
    checkpoint manifest.
  * **Sharded**: each data-parallel host generates only its slice (counter-
    based numpy generators, no cross-host coordination).

The generation is the reference's numpy, so every batch is byte-equal to
its batch; the tokens then go to the device in one copy a batch
(page-locked and asynchronous on the card), and ``tokens`` / ``targets`` are
two views of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import resolve_device


@dataclasses.dataclass
class DataState:
    seed: int
    next_step: int = 0


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0, ngram: int = 8):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.ngram = ngram
        # fixed "language": a bank of n-grams with zipfian unigrams
        rng = np.random.default_rng(seed)
        zipf_p = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        zipf_p /= zipf_p.sum()
        self.bank = rng.choice(vocab_size, size=(1024, ngram), p=zipf_p).astype(
            np.int32
        )

    def batch(self, step: int, batch_size: int, shard: int = 0, num_shards: int = 1):
        """Tokens for (step, shard): [batch_size // num_shards, seq_len]."""
        rng = np.random.default_rng((self.seed, step, shard))
        rows = batch_size // num_shards
        n_spans = self.seq_len // self.ngram + 1
        idx = rng.integers(0, self.bank.shape[0], size=(rows, n_spans))
        toks = self.bank[idx].reshape(rows, -1)[:, : self.seq_len]
        # sprinkle noise so the task isn't pure memorization
        noise = rng.integers(0, self.vocab_size, size=toks.shape)
        mask = rng.random(toks.shape) < 0.05
        return np.where(mask, noise, toks).astype(np.int32)


def _to_device(toks: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(toks)
    if dev.type == "cuda":  # a page-locked copy lets the host run ahead
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def make_batch_iterator(
    vocab_size: int,
    seq_len: int,
    batch_size: int,
    *,
    state: DataState,
    shard: int = 0,
    num_shards: int = 1,
    device=None,
):
    """Yields (step, batch_dict); advances ``state.next_step`` as it goes.
    The batch's int32 tensors are on the card unless ``device`` names
    another."""
    dev = resolve_device(device)
    src = SyntheticLM(vocab_size, seq_len + 1, seed=state.seed)

    def gen():
        while True:
            step = state.next_step
            toks = _to_device(src.batch(step, batch_size, shard, num_shards), dev)
            state.next_step = step + 1
            yield step, {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    return gen()
