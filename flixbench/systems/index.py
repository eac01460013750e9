"""The ordered index through its batch entry: ``make_ops`` (the one sort)
-> ``apply_ops_safe`` (whichever executor ``impl="auto"`` picks, restructure
and retry on overflow) -> ``unsort`` (the per-op answers back in
submission order), on one state that the window carries from batch to
batch.

The check walks the generated inputs again from the seed
(``IndexOps.replay``): every batch's stats against its counts (each insert
is fresh, each delete live, each sent update an upsert of a live key); the
sampled batches' every answer and stats against ``reference.sorted_index``
run from the live pairs before the batch; the final live pairs.  The
reference works every state and sort out again from the generated inputs.
"""

from __future__ import annotations

import torch

from flixbench import opcodes
from flixbench.reference import sorted_index

PER_OP = ("value", "succ_key", "range_start", "range_count")
DENSE = ("range_key", "range_val")
# the batch's stats that the engine keeps on the card; restructure_retries is a host int
CARD_STATS = ("inserted", "deleted", "overflowed_buckets", "range_truncated")
BATCH = ("tags", "keys", "vals")


def make(config, traffic, gen, seed, device):
    return IndexSystem(config, traffic, gen, seed, device)


class IndexSystem:
    def __init__(self, config, traffic, gen, seed, device):
        self.c, self.t, self.gen, self.seed, self.dev = config, traffic, gen, seed, device
        self.samples: dict[int, tuple] = {}  # slot -> (step, ops)
        self.steps = 0
        self.retries: list[int] = []
        self.traced: list = []  # a traced step's fences (the state's own tensor)

    def setup(self, traced_steps: int):
        """Builds the index, and every buffer the window fills, so that the
        window allocates nothing that it keeps."""
        from repro_torch import core

        keys, vals = self.gen.initial()
        self.state = core.build(keys, vals, node_size=self.c["node_size"],
                                nodes_per_bucket=self.c["nodes_per_bucket"],
                                fill=self.c["fill"], device=self.dev)
        self.cfg = core.ExecConfig(max_results=self.t["max_results"])
        i32 = {"dtype": torch.int32, "device": self.dev}
        # every step's card stats
        self.card_stats = torch.zeros((1 << 14, len(CARD_STATS)), dtype=torch.int64,
                                      device=self.dev)
        # the sampled steps' ops and answers
        k, n, m = self.t["sample_steps"], self.t["batch_ops"], self.t["max_results"]
        self.kept = {name: torch.empty((k, n), **i32) for name in BATCH + PER_OP}
        self.kept.update({name: torch.empty((k, m), **i32) for name in DENSE})
        # each traced step's bucket counts before it, and after the last
        nb = self.state.mkba.numel()
        self.nn = torch.empty((traced_steps + 1, nb), **i32) if traced_steps else None

    def next_input(self):
        return self.gen.next()

    def submit(self, b, spans):
        from repro_torch import core

        with spans.span("make_ops"):
            ops, perm = core.make_ops(b.tags, b.keys, b.vals, device=self.dev)
        pre = self.state
        with spans.span("apply"):
            self.state, res, stats = core.apply_ops_safe(pre, ops, config=self.cfg)
        with spans.span("unsort"):
            out = {k: core.unsort(res[k], perm) for k in PER_OP}
        out.update({k: res[k] for k in DENSE})
        if spans.traced:
            i = len(self.traced)
            if not i:
                self.nn[0].copy_(pre.num_nodes)
            self.nn[i + 1].copy_(self.state.num_nodes)
            self.traced.append(pre.mkba)
        return out, stats

    def record(self, result):
        stats = result[1]
        if self.steps == len(self.card_stats):  # doubles, rarely
            self.card_stats = torch.cat([self.card_stats, torch.zeros_like(self.card_stats)])
        torch.stack([stats[k] for k in CARD_STATS], out=self.card_stats[self.steps])
        self.retries.append(stats["restructure_retries"])
        self.steps += 1

    def keep(self, slot, b, result):
        for name in BATCH:
            self.kept[name][slot].copy_(getattr(b, name))
        for name, x in result[0].items():
            self.kept[name][slot].copy_(x)
        self.samples[slot] = (self.steps - 1, b.n_ops)

    def live_keys(self) -> int:
        return int(self.state.live_keys())

    def trace_readings(self) -> dict:
        """The bytes each traced batch needs; the batches made again from
        the seed, past the warm-up's."""
        from flixbench.roofline import apply_bytes

        again = type(self.gen)(self.t, self.c, self.seed, self.dev)
        for _ in range(self.t["warmup_steps"]):
            again.next()
        geo = (self.state.nodes_per_bucket, self.state.node_size, self.t["max_results"])
        return {"apply_bytes": [apply_bytes(again.next(), mkba, self.nn[i], self.nn[i + 1], *geo)
                                for i, mkba in enumerate(self.traced)]}

    def check(self):
        """``({name: (value, limit)}, failed, info)``: ``failed`` the steps
        found wrong, and one more when the final pairs are; frees the state
        first."""
        st = self.state
        live = st.keys != opcodes.EMPTY
        got_k, order = torch.sort(st.keys[live])
        got_v = st.vals[live][order]
        self.state = st = live = order = None
        if torch.device(self.dev).type == "cuda":
            torch.cuda.empty_cache()

        counts = self.gen.counts
        card_stats = self.card_stats[: self.steps].tolist()
        by_step = {i: slot for slot, (i, _) in self.samples.items()}
        bad = {}
        wrong_answers = checked = 0
        after = None  # the reference's pairs after a sampled batch
        for i, base, table, inserted in self.gen.replay(self.steps):
            keys, vals = self._window(base, table) if i in by_step or after else (None, None)
            if after:
                if not (torch.equal(keys, after[0]) and torch.equal(vals, after[1])):
                    raise RuntimeError("the reference's pairs after a batch are not the replay's")
                after = None
            if inserted is None:
                final = base
                break
            want = {"inserted": inserted, "deleted": counts["delete"],
                    "overflowed_buckets": 0, "restructure_retries": 0}
            step = {**dict(zip(CARD_STATS, card_stats[i])), "restructure_retries": self.retries[i]}
            bad[i] = sum(step[k] != v for k, v in want.items())
            if i not in by_step:
                continue
            slot = by_step[i]
            _, n_ops = self.samples[slot]
            got = {k: v[slot] for k, v in self.kept.items()}
            *after, ans, ref_stats = sorted_index.run_batch(
                keys, vals, got["tags"], got["keys"], got["vals"], self.t["max_results"])
            n = sum(int((got[k] != ans[k]).sum()) for k in PER_OP + DENSE)
            bad[i] += n + sum(step[k] != v for k, v in ref_stats.items() if k not in want)
            wrong_answers += n
            checked += n_ops
            del keys, vals, ans
        want_k, want_v = self._window(final, table)
        if want_k.numel() == got_k.numel():
            wrong_pairs = int(((want_k != got_k) | (want_v != got_v)).sum())
        else:
            wrong_pairs = max(want_k.numel(), got_k.numel())
        wrong_stats = sum(bad.values()) - wrong_answers
        checks = {"wrong_answers": (wrong_answers, 0), "wrong_stats": (wrong_stats, 0),
                  "wrong_pairs": (wrong_pairs, 0)}
        info = {"checked_steps": len(by_step), "checked_ops": checked,
                "steps_with_stats": self.steps, "live_pairs": int(got_k.numel())}
        # the final contents count as one more check that failed
        return checks, sum(n > 0 for n in bad.values()) + (wrong_pairs > 0), info

    def _window(self, base: int, table: torch.Tensor):
        """The live pairs when the oldest live key is at ring position
        ``base``, sorted by key, their values from the replay's table."""
        ring = self.gen.ring
        pos = torch.arange(base, base + self.gen.n_live, dtype=torch.int64, device=self.dev)
        keys, order = torch.sort(ring.key(pos))
        return keys, table[pos[order] % ring.size]
