"""Batches of raw index operations, made on the card from the seed.

Parameters (a traffic file's keys):

  source         where the mix comes from (read by no code)
  batch_ops      operations in a batch
  shares         share of each kind: insert, delete, update, point_hit,
                 point_miss, successor, range; counts are floors, and the
                 remainder goes to the largest share, so every batch has
                 the same counts whatever the seed
  hit_keys       "uniform" or "scrambled_zipf" over the live keys: the keys
                 of point hits and updates
  range_width    a RANGE op's hi - lo
  max_results    the batch's dense RANGE output budget
  warmup_steps   batches run before the window (set-up)
  trace_steps    batches of the window under the profiler in a traced run
  sample_steps   batches of the window whose answers are checked

The live keys are a window of a ``KeyRing`` of twice the build's keys.  A
batch deletes the ``delete`` oldest live keys and inserts as many fresh
ones (so ``insert`` and ``delete`` shares must be equal), with their ring
position as value.  An update (YCSB's) writes a fresh value to a live key
that the batch neither inserts nor deletes, as an INSERT, which upserts.
The engine takes at most one update a key and batch, so the caller
coalesces a batch's updates of one key: the last one drawn is sent, the
others become NOP slots (key EMPTY), and the batch keeps its size.  The
updates come from a generator of their own, so ``replay`` can walk them
again without the reads.  Point hits are drawn from the live keys after
the batch's own updates, misses from the ring's absent keys, successor and
range lower bounds uniformly from the key space.  The ops are shuffled:
the engine gets them unsorted.
"""

from __future__ import annotations

import dataclasses

import torch

from flixbench import opcodes
from flixbench.keys import KeyRing, scrambled_zipf

KINDS = ("insert", "delete", "update", "point_hit", "point_miss", "successor", "range")
UPDATE_STREAM = 0x5EED5EED  # the update generator's seed: the run's, xor this (low bits: a CPU generator keeps 32)
# batches are made a chunk at a time: up to CHUNK_OPS ops, at least one batch, at most 256
CHUNK_OPS, CHUNK_BATCHES = 1 << 22, 256
VALUE_BITS = 30  # an update's value is below 2**30


@dataclasses.dataclass
class Batch:
    tags: torch.Tensor
    keys: torch.Tensor
    vals: torch.Tensor
    base: int  # the ring position of the oldest live key before the batch
    n_ops: int


def counts_of(batch_ops: int, shares: dict) -> dict:
    unknown = set(shares) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown op kinds {sorted(unknown)}")
    counts = {k: int(batch_ops * shares.get(k, 0.0)) for k in KINDS}
    largest = max(KINDS, key=lambda k: shares.get(k, 0.0))
    counts[largest] += batch_ops - sum(counts.values())
    if counts["insert"] != counts["delete"]:
        raise ValueError("the ring keeps the live count steady: insert and delete shares differ")
    return counts


def make(params, config, seed, device):
    return IndexOps(params, config, seed, device)


class IndexOps:
    def __init__(self, params: dict, config: dict, seed: int, device):
        self.p, self.config, self.seed = params, config, seed
        self.n_live = config["build_keys"]
        self.space_bits = config["key_space_bits"]
        self.ring = KeyRing(self.space_bits, 2 * self.n_live, seed)
        self.counts = counts_of(params["batch_ops"], params["shares"])
        self.device = torch.device(device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.ugen = torch.Generator(device=device)
        self.ugen.manual_seed(seed ^ UPDATE_STREAM)
        self.rows = min(CHUNK_BATCHES, max(1, CHUNK_OPS // params["batch_ops"]))
        self.base = 0  # the oldest live ring position once the made batches ran
        self.ready: list[Batch] = []

    def initial(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The build's keys and values: the ring's first ``build_keys``."""
        return self.ring.window(0, self.n_live, self.device)

    def _randint(self, hi: int, shape, gen=None) -> torch.Tensor:
        return torch.randint(0, hi, shape, generator=gen or self.gen, device=self.device,
                             dtype=torch.int64)

    def _live_index(self, shape, items: int, gen) -> torch.Tensor:
        if self.p.get("hit_keys", "uniform") == "scrambled_zipf":
            n = shape[0] * shape[1]
            return scrambled_zipf(n, items, gen).reshape(shape)
        return self._randint(items, shape, gen)

    def _afters(self, base: int, rows: int) -> torch.Tensor:
        """``[rows, 1]``: each batch's oldest live ring position once its
        deletes ran, for the ``rows`` batches from ``base`` on."""
        d = self.counts["delete"]
        return base + d * torch.arange(1, rows + 1, device=self.device)[:, None]

    def _updates(self, base: int, rows: int):
        """The updates of ``rows`` batches from ``base`` on, a row each, in
        the order drawn: ring positions, values, and which ones are sent
        (the last drawn of each key in its batch)."""
        n = self.counts["update"]
        # live keys a batch neither deletes nor inserts: [after, base + n_live)
        idx = self._live_index((rows, n), self.n_live - self.counts["delete"], self.ugen)
        vals = torch.randint(0, 1 << VALUE_BITS, (rows, n), generator=self.ugen,
                             device=self.device, dtype=torch.int32)
        s, order = torch.sort(idx, dim=1, stable=True)
        last = torch.ones_like(idx, dtype=torch.bool)
        last[:, :-1] = s[:, 1:] != s[:, :-1]
        sent = torch.empty_like(last).scatter_(1, order, last)
        return self._afters(base, rows) + idx, vals, sent

    def _chunk(self):
        """The next ``rows`` batches, made at once: a few large calls on the
        card instead of many small ones a batch."""
        c, dev, base = self.counts, self.device, self.base
        rows = self.rows
        d, live, size = c["delete"], self.n_live, self.ring.size
        after = self._afters(base, rows)
        space = 1 << self.space_bits
        width = self.p.get("range_width", 0)
        ins_pos = after - d + live + torch.arange(d, device=dev)
        del_pos = after - d + torch.arange(d, device=dev)
        u_pos, u_vals, sent = self._updates(base, rows)
        hit_pos = after + self._live_index((rows, c["point_hit"]), live, self.gen)
        miss_pos = after + live + self._randint(size - live, (rows, c["point_miss"]))
        lo = self._randint(space - width, (rows, c["range"])).to(torch.int32)
        nop = torch.full_like(u_vals, opcodes.EMPTY)
        parts = [
            (opcodes.INSERT, self.ring.key(ins_pos), (ins_pos % size).to(torch.int32)),
            (opcodes.DELETE, self.ring.key(del_pos), None),
            (torch.where(sent, opcodes.INSERT, opcodes.NOP),
             torch.where(sent, self.ring.key(u_pos), nop), torch.where(sent, u_vals, 0)),
            (opcodes.POINT, self.ring.key(hit_pos), None),
            (opcodes.POINT, self.ring.key(miss_pos), None),
            (opcodes.SUCCESSOR, self._randint(space, (rows, c["successor"])).to(torch.int32),
             None),
            (opcodes.RANGE, lo, lo + width),
        ]
        tags = torch.cat([t.to(torch.int32) if torch.is_tensor(t) else
                          torch.full(k.shape, t, dtype=torch.int32, device=dev)
                          for t, k, _ in parts], dim=1)
        keys = torch.cat([k for _, k, _ in parts], dim=1)
        vals = torch.cat([torch.zeros_like(k) if v is None else v for _, k, v in parts], dim=1)
        order = torch.rand(keys.shape, generator=self.gen, device=dev).argsort(dim=1,
                                                                             stable=True)
        tags, keys, vals = (torch.gather(x, 1, order) for x in (tags, keys, vals))
        n = keys.shape[1]
        self.base = base + rows * d
        return [Batch(tags[j], keys[j], vals[j], base + j * d, n) for j in range(rows)]

    def next(self) -> Batch:
        if not self.ready:
            self.ready = self._chunk()[::-1]
        return self.ready.pop()

    def replay(self, n: int):
        """Walk the first ``n`` batches' updates again from the seed.

        Yields ``(i, base, table, inserted)`` before batch ``i`` for ``i`` in
        ``0 .. n - 1``, and ``(n, base, table, None)`` after the last:
        ``table[p % ring.size]`` is the value of the live key at ring
        position ``p`` then, and ``inserted`` the INSERT ops batch ``i``
        sends.  The yielded table changes as the walk goes on."""
        walk = IndexOps(self.p, self.config, self.seed, self.device)
        size, c = self.ring.size, self.counts
        rows = self.rows
        table = torch.arange(size, dtype=torch.int32, device=self.device)
        base = 0
        for i in range(n):
            j = i % rows
            if c["update"] and not j:
                pos, vals, sent = walk._updates(base, rows)
                inserted = (c["insert"] + sent.sum(dim=1)).tolist()
            yield i, base, table, inserted[j] if c["update"] else c["insert"]
            after = base + c["delete"]
            if c["insert"]:  # a reinserted key takes its ring position as value again
                ins = torch.arange(base + self.n_live, after + self.n_live, device=self.device)
                table[ins % size] = (ins % size).to(torch.int32)
            if c["update"]:
                table[pos[j][sent[j]] % size] = vals[j][sent[j]]
            base = after
        yield n, base, table, None
