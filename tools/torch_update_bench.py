#!/usr/bin/env python3
"""Time the port's insert and delete kernels on one CUDA card at
chip_smoke.py's phase-5 shapes, beside the staged stripe kernel on the same
keys, with the package under a given ``src`` directory (default: this
checkout's), so that two trees can be compared in one run:

    python3 tools/torch_update_bench.py [--src DIR] [--tag NAME]

It builds phase 5's state (2^24 unique uniform keys of a 2^27 space, 32-key
nodes, 16 a bucket) from ``chip_smoke``'s ``Traffic`` and ``SEED + 2``, and
takes the first insert round's 2^22 sorted fresh keys.  Insert: the insert
pass on that state.  Delete: the same keys, pre-filtered as ``flix_delete``
does, deleted from the state after the insert.  Each pass is held exactly
against its plain version, and the staged pass (``flix_apply_staged_pass``)
on the same keys given as an insert-only and as a delete-only batch of ops
is held to the pass's state outputs; then each pair is timed by CUDA events
in turns (pass, staged, staged, pass) beside ``chip_smoke.update_bytes``'s
bound, and each pass on an empty batch (every bucket on the keep path);
beside them, the time PyTorch takes to write both planes whole in place,
and the one searchsorted of the fences that each pass's time includes.
With every bucket taking ~4 keys, the staged times show what the
warp-per-bucket update path reaches when no bucket takes the keep path.
When it builds the library it prints ptxas's lines for the three kernels.
It needs a card and exits non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_update_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from repro_torch.kernels import flix_delete as fd  # noqa: E402
from repro_torch.kernels import flix_insert as fi  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402

REPS = 3  # launches per timed turn
build(args, fi, "flix_insert_kernel", "flix_delete_kernel", "flix_apply_staged_kernel")

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 2)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
chunk = traffic.perm[cs.FULL_KEYS : cs.FULL_KEYS + cs.FIG9_ROUND]
upd_k, order = torch.sort(chunk, stable=True)
upd_v = torch.arange(cs.FIG9_ROUND, dtype=torch.int32, device=dev)[order]
del chunk, order


def staged_args(st, tag, keys, vals):
    ops, _ = core.make_ops(torch.full_like(keys, tag), keys, vals)
    return (st.num_nodes, *fa.stripe_inputs(st, ops.tag, ops.key, ops.val)[0])


def run(name, st, fn, ref, pass_args, stage, extra_bytes, reads_node_max):
    """Hold the pass to its plain version and the staged pass to the pass's
    state outputs, then time both in turns."""
    got = fn(*pass_args)
    err = cs.max_abs_err(ref(*pass_args), got)
    if err:
        raise AssertionError(f"{args.tag} {name}: the kernel differs from its plain version "
                             f"({err})")
    err = cs.max_abs_err(got[:5], fa.flix_apply_staged_pass(*stage)[:5])
    if err:
        raise AssertionError(f"{args.tag} {name}: the staged pass differs ({err})")
    del got
    times = {"pass": [], "staged": []}
    for k, f in (("pass", lambda: fn(*pass_args)),
                 ("staged", lambda: fa.flix_apply_staged_pass(*stage)),
                 ("staged", lambda: fa.flix_apply_staged_pass(*stage)),
                 ("pass", lambda: fn(*pass_args))):
        times[k].append(cs.event_ms(f, REPS))
    bound = cs.update_bytes(st, extra_bytes, reads_node_max) / cs.HBM_BYTES_PER_S * 1e3
    p, s = times["pass"], times["staged"]
    print(f"{args.tag:>8} {name} ({cs.FIG9_ROUND} keys): {fn.__name__} {p[0]:.4f}, "
          f"{p[1]:.4f} ms; staged {s[0]:.4f}, {s[1]:.4f} ms; bound {bound:.4f} ms "
          f"({min(p) / bound:.2f}x, staged {min(s) / bound:.2f}x)", flush=True)
    # the same pass on an empty batch: every bucket takes the keep path
    empty = [a[:0] if a.dim() == 1 and a.numel() == cs.FIG9_ROUND else a for a in pass_args]
    print(f"{args.tag:>8} {name}, empty batch: {cs.event_ms(lambda: fn(*empty), REPS):.4f} ms",
          flush=True)


def warm_ms(fn):
    """event_ms after one untimed call (the kernel's first load)."""
    fn()
    return cs.event_ms(fn, REPS)


nb = state.num_buckets
# writing both planes whole in place, one PyTorch call each (no pass writes
# less): the write floor of every stripe pass
out_k, out_v = torch.empty_like(state.keys), torch.empty_like(state.vals)
fill_ms = warm_ms(lambda: (out_k.fill_(core.EMPTY), out_v.zero_()))
del out_k, out_v
print(f"{args.tag:>8} writing both planes by fill_ / zero_: {fill_ms:.4f} ms "
      f"({(state.keys.nbytes + state.vals.nbytes) / fill_ms / 1e9:.4f} TB/s)", flush=True)
ss_ms = warm_ms(lambda: torch.searchsorted(upd_k, state.mkba, right=True, out_int32=True))
print(f"{args.tag:>8} the passes' slice ends (torch.searchsorted of {nb} fences in the "
      f"{cs.FIG9_ROUND} keys): {ss_ms:.4f} ms", flush=True)
ins_args = (state.num_nodes, state.keys, state.vals, state.node_max, state.mkba, upd_k, upd_v)
run("insert", state, fi.flix_insert_pass, fi.flix_insert_reference, ins_args,
    staged_args(state, core.OP_INSERT, upd_k, upd_v), 8 * cs.FIG9_ROUND + 4 * nb,
    reads_node_max=True)
state, overflow = fi.flix_insert(state, upd_k, upd_v)
assert not int(overflow.max()), "the insert overflowed"
del ins_args, overflow

planes = (state.keys, state.vals, state.node_max, state.mkba)
present = fq.flix_point_query(*planes, upd_k) != core.NOT_FOUND
dk = torch.sort(torch.where(present, upd_k, core.EMPTY), stable=True).values
del present
del_args = (state.num_nodes, state.keys, state.vals, state.mkba, dk)
run("delete", state, fd.flix_delete_pass, fd.flix_delete_reference, del_args,
    staged_args(state, core.OP_DELETE, upd_k, torch.zeros_like(upd_k)), 4 * cs.FIG9_ROUND,
    reads_node_max=False)
