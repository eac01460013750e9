"""Deterministic tile autotuner for the staged stripe kernel (port of
``repro/kernels/autotune.py``).

The reference sweeps the TPU kernel's two tile knobs per (build_size,
batch_size) power-of-two bucket and records one winner per bucket in a
:class:`~repro_torch.core.config.TileTable`.  On the card the knobs mean:

  * ``block_b`` — the warps of one block of the staged stripe kernel
    (``csrc/flix_apply_staged.cu``, a warp per bucket), and so the buckets
    one block holds in flight, as the TPU kernel's ``block_b`` is the bucket
    stripes one grid step holds.  Each warp keeps its own two-slot ring and
    scratch in shared memory, so a block of W warps needs W times a warp's
    bytes: W is bounded by the 232,448 bytes a block may opt in to, and it
    sets how many blocks, and so warps, an SM holds at once (shared memory,
    warps and registers each limit that).
  * ``block_q`` — ops a window on the TPU.  It has no counterpart: a warp
    finds its op slice from the batch's per-bucket bounds.  The only
    candidate is the reference's default, 128, so that table rows keep
    their four columns and a table from either package loads in the other.

Two modes, as in the reference:

  * **model mode** (default): a closed-form model scores every candidate —
    feasibility (the block's shared memory, a Python mirror of
    ``warp_ints<StagedRing>`` in ``csrc/flix_warp.cuh``), then the stripe
    pass's bytes at the card's memory rate (the same for every W), plus a
    latency term in buckets a resident warp walks, with the tail of the last
    wave.  Pure integer arithmetic on the requested sizes and the card's
    constants below: the same sweep on any host picks the same tiles.
  * **measure mode** (``measure=True``, on a CUDA card only): the
    reference's synthetic build and half-POINT, half-INSERT batch, made on
    the card; ``apply_ops(impl="fused", pipeline="on", block_b=W)`` timed
    by CUDA events per feasible candidate after one warm-up call, the
    median of 3.

Either way the output is plain data: a ``TileTable`` (for
``ExecConfig(tile_table=...)``) and a JSON-ready record with the
reference's keys (``vmem_bytes`` and ``vmem_budget_bytes`` hold the block's
shared memory and its budget here).
"""

from __future__ import annotations

import math

from repro_torch.core.config import TileTable, _pow2_bucket
from repro_torch.kernels.flix_apply import STAGED_MAX_WARPS

# the reference's flix_query.DEFAULT_BLOCK_Q, the one op-window candidate
DEFAULT_BLOCK_Q = 128
CANDIDATE_BLOCK_Q = (DEFAULT_BLOCK_Q,)
CANDIDATE_BLOCK_B = (1, 2, 4, 8)

# The H100 SXM limits the model holds a candidate to (NVIDIA's data sheet
# and the CUDA occupancy rules for compute capability 9.0).
SMEM_BUDGET_BYTES = 232_448  # shared memory a block may opt in to (kSmemOptin)
SM_SMEM_BYTES = 228 * 1024  # shared memory of one SM
SMEM_RESERVED_PER_BLOCK = 1024  # the runtime's own per block
SMEM_ALLOC_UNIT = 128  # a block's shared memory is allocated in these
SM_MAX_WARPS = 64
SM_MAX_BLOCKS = 32
SM_REGISTERS = 65_536
SM_SUBPARTITIONS = 4  # registers are allocated per sub-partition
REG_ALLOC_UNIT = 256  # registers a warp is allocated in
NUM_SMS = 132
HBM_BYTES_PER_US = 3_350_000  # 3.35 TB/s
# registers a thread of the staged kernel's two instantiations, by the warps
# their launch bounds allow (blocks of up to 4 warps run the first): ptxas's
# lines for the sm_90a build, no spill (chip_smoke.py phase 2 prints them at
# each build, and phase 3k holds this model to the occupancy API)
STAGED_REGS_PER_THREAD = {4: 96, 8: 128}
# a bucket's latency on its warp beyond the bytes, in ns: phase 4's staged
# pass (2.8569 ms, PERF.md row 2) less its 1.4218 ms bound, over the 497
# buckets each of 132 x 16 warps walks at 2^20 buckets (H100 80GB HBM3, 700 W)
BUCKET_LATENCY_NS = 2_888

# csrc/flix_warp.cuh: a bucket's staged scalars, the default most warps a
# block, and the staged ring's slice capacities (op, insert, delete)
_BOUND_INTS = 8
_DEFAULT_MAX_WARPS = 4
_STAGED_RING = (32, 16, 16)
_I32 = 4  # bytes


def _round4(x: int) -> int:
    return (x + 3) & ~3


def warp_bytes(*, node_size: int, nodes_per_bucket: int) -> int:
    """Shared memory of one warp of the staged kernel: its two ring slots
    (``Ring<32, 16, 16>::ints``) and its scratch (``warp_ints``)."""
    npb, S = nodes_per_bucket, node_size * nodes_per_bucket
    op, ins, dele = _STAGED_RING
    ring = 2 * _round4(S) + _round4(npb) + _BOUND_INTS + 2 * op + 2 * ins + dele
    chunks = (S + 31) // 32
    return _I32 * _round4(2 * ring + 2 * _round4(S) + 2 * chunks + 7 * npb + 1)


def block_warps(block_b: int, *, node_size: int, nodes_per_bucket: int) -> int:
    """The warps of a launch's block (``warps_per_block``): ``block_b`` where
    given, else (0) as many as 4 whose shared memory fits, at least one."""
    if block_b:
        return block_b
    fit = SMEM_BUDGET_BYTES // warp_bytes(node_size=node_size,
                                          nodes_per_bucket=nodes_per_bucket)
    return min(max(fit, 1), _DEFAULT_MAX_WARPS)


def smem_bytes(block_q: int, block_b: int, *, node_size: int, nodes_per_bucket: int) -> int:
    """The resource of one candidate: the dynamic shared memory of one block
    of the staged kernel (``flix_apply_staged_smem_bytes``).  ``block_q`` has
    no part in it: the block holds no op window."""
    del block_q
    w = block_warps(block_b, node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    return w * warp_bytes(node_size=node_size, nodes_per_bucket=nodes_per_bucket)


def blocks_per_sm(block_b: int, *, node_size: int, nodes_per_bucket: int) -> int:
    """Blocks of the staged kernel one SM holds at once, the least of what
    shared memory, warps, registers and the block limit allow (0 where a
    block does not fit): the occupancy API's answer for the launch."""
    w = block_warps(block_b, node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    smem = w * warp_bytes(node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    bound = _DEFAULT_MAX_WARPS if w <= _DEFAULT_MAX_WARPS else STAGED_MAX_WARPS
    regs = STAGED_REGS_PER_THREAD[bound]
    regs_warp = -(-regs * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    regs_block = regs_warp * -(-w // SM_SUBPARTITIONS) * SM_SUBPARTITIONS
    if smem > SMEM_BUDGET_BYTES or w > STAGED_MAX_WARPS or regs_block > SM_REGISTERS:
        return 0
    alloc = -(-(smem + SMEM_RESERVED_PER_BLOCK) // SMEM_ALLOC_UNIT) * SMEM_ALLOC_UNIT
    by_regs = SM_REGISTERS // SM_SUBPARTITIONS // regs_warp * SM_SUBPARTITIONS // w
    return min(SM_SMEM_BYTES // alloc, SM_MAX_WARPS // w, by_regs, SM_MAX_BLOCKS)


def model_cost(
    block_q: int,
    block_b: int,
    *,
    build_size: int,
    batch_size: int,
    node_size: int,
    nodes_per_bucket: int,
) -> float:
    """Deterministic cost score for one candidate (lower is better), in ns.

    ``build_size`` counts slots, as ``core.ops`` passes it (nb = build_size
    / S buckets).  The stripe pass writes every stripe whole and reads and
    writes the batch once: those bytes at 3.35 TB/s, the same for every W.
    Then the walk: ``blocks_per_sm`` blocks of W warps on each of 132 SMs,
    at most a warp per bucket, each warp taking every T-th bucket of the T
    resident warps; each bucket costs a warp ``BUCKET_LATENCY_NS`` beyond
    its bytes, so the full waves cost ``nb // T`` of them and a partial last
    wave one more.
    """
    del block_q
    S = node_size * nodes_per_bucket
    nb = max(1, math.ceil(build_size / S))
    n = max(1, batch_size)
    moved = nb * (2 * S + 2 * nodes_per_bucket + 3) * _I32 + n * 4 * _I32
    bytes_ns = moved * 1000 // HBM_BYTES_PER_US
    w = block_warps(block_b, node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    per_sm = blocks_per_sm(block_b, node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    warps = min(per_sm * NUM_SMS, math.ceil(nb / w)) * w
    waves, tail = divmod(nb, warps)
    return float(bytes_ns + BUCKET_LATENCY_NS * (waves + (1 if tail else 0)))


def sweep_bucket(
    build_size: int,
    batch_size: int,
    *,
    node_size: int = 16,
    nodes_per_bucket: int = 8,
    candidates_q=CANDIDATE_BLOCK_Q,
    candidates_b=CANDIDATE_BLOCK_B,
    smem_budget: int = SMEM_BUDGET_BYTES,
    measure: bool = False,
    device=None,
) -> dict:
    """Score every candidate for one (build, batch) bucket; pick the winner.

    Returns a JSON-ready record: the bucket, every candidate's shared memory
    (``vmem_bytes``), resident warps an SM, feasibility and score, and the
    chosen ``(block_q, block_b)``.  Ties break on the sorted candidate
    order, so the sweep is a pure function of its inputs.  ``measure=True``
    times the feasible candidates on ``device`` (the card unless named;
    anything but CUDA raises).
    """
    geo = dict(node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    rows = []
    for bq in sorted(candidates_q):
        for bb in sorted(candidates_b):
            sb = smem_bytes(bq, bb, **geo)
            per_sm = blocks_per_sm(bb, **geo)
            feasible = sb <= smem_budget and per_sm > 0
            cost = (
                model_cost(bq, bb, build_size=build_size, batch_size=batch_size, **geo)
                if feasible
                else None
            )
            rows.append(
                {
                    "block_q": bq,
                    "block_b": bb,
                    "vmem_bytes": sb,
                    "resident_warps": per_sm * block_warps(bb, **geo),
                    "feasible": feasible,
                    "model_cost": cost,
                }
            )
    feas = [r for r in rows if r["feasible"]]
    if not feas:  # pathological geometry: fall back to the smallest tiles
        feas = [rows[0]]
        feas[0]["model_cost"] = 0.0
    if measure:
        _measure_rows(
            feas, build_size=build_size, batch_size=batch_size, device=device, **geo
        )
        key = lambda r: (r["wall_s"], r["block_q"], r["block_b"])  # noqa: E731
    else:
        key = lambda r: (r["model_cost"], r["block_q"], r["block_b"])  # noqa: E731
    best = min(feas, key=key)
    return {
        "build_bucket": _pow2_bucket(build_size),
        "batch_bucket": _pow2_bucket(batch_size),
        "block_q": best["block_q"],
        "block_b": best["block_b"],
        "measured": bool(measure),
        "candidates": rows,
    }


def _measure_rows(rows, *, build_size, batch_size, node_size, nodes_per_bucket, device):
    """Time each candidate's fused apply on the card: the reference's
    synthetic build of ``build_size`` keys from ``8 * build_size`` and its
    half-POINT, half-INSERT batch, made on the card from a seeded generator;
    ``wall_s`` is the median of 3 CUDA-event timings of ``apply_ops``, after
    one warm-up call of each candidate."""
    import torch

    from repro_torch.core.build import build
    from repro_torch.core.config import ExecConfig
    from repro_torch.core.ops import OP_INSERT, OP_POINT, apply_ops, make_ops
    from repro_torch.core.state import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"autotune(measure=True) times the staged kernel on a CUDA card, not {dev}"
        )
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    space = build_size * 8
    keys = torch.randperm(space, generator=gen, device=dev)[:build_size].to(torch.int32)
    state = build(keys, torch.arange(build_size, dtype=torch.int32, device=dev),
                  node_size=node_size, nodes_per_bucket=nodes_per_bucket, device=dev)
    half = max(1, batch_size // 2)
    qk = keys[torch.randint(0, build_size, (half,), generator=gen, device=dev)]
    ik = torch.randint(0, space, (batch_size - half,), generator=gen, device=dev,
                       dtype=torch.int32) | 1
    tags = torch.cat([torch.full((half,), OP_POINT, dtype=torch.int32, device=dev),
                      torch.full((batch_size - half,), OP_INSERT, dtype=torch.int32,
                                 device=dev)])
    ops, _ = make_ops(tags, torch.cat([qk, ik]), torch.cat([qk, ik]), device=dev)
    del keys, qk, ik, tags
    for r in rows:
        # every timed call runs on the one state: never donate it
        cfg = ExecConfig(impl="fused", pipeline="on", block_b=r["block_b"], donate=False)
        apply_ops(state, ops, config=cfg)  # warm-up: the library's build, the opt-in
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            apply_ops(state, ops, config=cfg)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        r["wall_s"] = sorted(times)[1]


def autotune(
    build_sizes,
    batch_sizes,
    *,
    node_size: int = 16,
    nodes_per_bucket: int = 8,
    candidates_q=CANDIDATE_BLOCK_Q,
    candidates_b=CANDIDATE_BLOCK_B,
    smem_budget: int = SMEM_BUDGET_BYTES,
    measure: bool = False,
    device=None,
) -> tuple[TileTable, dict]:
    """Sweep the cross product of size buckets → (TileTable, sweep record).

    The table is ready to thread through ``ExecConfig(tile_table=...)``;
    the record is JSON-ready and round-trips back via
    ``TileTable.from_json(record["table"])``.
    """
    sweeps = []
    entries = {}
    for build in sorted({_pow2_bucket(b) for b in build_sizes}):
        for batch in sorted({_pow2_bucket(q) for q in batch_sizes}):
            rec = sweep_bucket(
                build,
                batch,
                node_size=node_size,
                nodes_per_bucket=nodes_per_bucket,
                candidates_q=candidates_q,
                candidates_b=candidates_b,
                smem_budget=smem_budget,
                measure=measure,
                device=device,
            )
            sweeps.append(rec)
            entries[(build, batch)] = (rec["block_q"], rec["block_b"])
    table = TileTable(
        entries=tuple(
            (build, batch, bq, bb) for (build, batch), (bq, bb) in sorted(entries.items())
        )
    )
    record = {
        "node_size": node_size,
        "nodes_per_bucket": nodes_per_bucket,
        "vmem_budget_bytes": smem_budget,
        "measured": bool(measure),
        "table": table.to_json(),
        "sweeps": sweeps,
    }
    return table, record
