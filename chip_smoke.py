#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FliX (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero before the last
line, and no phase catches its own failure:

  1. card     — the device name, and nvidia-smi's name and power limit;
  2. build    — nvcc builds the kernel library from ``src/repro_torch/csrc``,
                one process per source, all started together;
  3. kernels  — each CUDA kernel against its plain torch version on the card,
                exactly (all int32).  flix_apply, its staged variant (held
                against the single-buffer kernel too) and the range gather:
                4 mixed batches and a boundary-key batch at 2^18 keys, a
                long-stripe geometry (2048 slots per bucket), and an
                overflow-then-retry case through ``apply_ops_safe``.
                flix_point_query, flix_successor, flix_insert and
                flix_delete: at 2^18 keys in the default geometry and in 8x8
                nodes, and at 2^16 keys in 64-node stripes, with mixed
                hit/miss queries, boundary keys, emptied buckets, duplicate
                delete keys and an insert batch that overflows a bucket;
                flix_point_query also on its edges at S = 8 (4x2) and S =
                2048 (32x64) with 2^20 keys: runs of several fence groups,
                every fence and the key above it, 100 repeats of one key, a
                bucket's keys three times over, emptied buckets, keys 0,
                MAX_VALID and EMPTY, NOT_FOUND values, batches of 1 and 77.
                flix_insert and flix_delete also on their edges at 32x16,
                8x8, 32x64 and 4x2 with 2^20 keys: a flood past cap, slices
                longer than the rings stage, emptied buckets, a bucket
                deleted whole, a full bucket that one more key overflows,
                inserts above the last node max, keys 0 and MAX_VALID, a
                slice repeated past cap, NOT_FOUND values, batches of 0 and
                1.
                flix_apply (3g) also on the edges of its persistent walk,
                against its plain version and the staged kernel, at 2^20
                keys in 32x16, 8x8, 32x64, 4x2, 6x4 and 3x3 (rows and
                stripes that no bulk copy may move):
                every other lap of the walk emptied, full buckets that one
                more key overflows, inserts into emptied buckets, non-zero
                vals at EMPTY slots, and states of 1, grid - 1 and grid + 1
                buckets.
                flix_range's count and scatter: ranges on bucket fences,
                hi <= lo, over emptied buckets, and a truncating budget;
                then (3e) their edges at 2^20 keys in 32x16, 8x8, 32x64 and
                4x2: bounds on and around every seventh fence, a run of 140
                emptied buckets with ranges inside and across it, hi <= lo,
                bounds at 0, EMPTY - 1 and EMPTY, narrow ranges inside a
                wide one, odd budgets that truncate (517, 100003), a state
                with no keys, states of 1, 1023 and 1025 buckets, and a
                2^20-op batch under a 1% RANGE mask; each pass once against
                its plain version (the count also on the ops in reverse
                order), flix_range against dense_range_scan.
                grouped_matmul within its float32 tolerance, in f32, bf16
                and both mixes: the reference's sweep shapes, empty groups,
                one group holding every row, T, D and F that are multiples
                of no tile (and D, F odd), rows outside every group (which
                must come out exactly zero from memory left NaN), a skewed
                split, a K tail, groups straddling row tiles and
                decode-sized groups, on every row-tile height; each launch
                must count under the variant the rule names (wgmma, mma or
                fma), unaligned views must keep mma and fma, and f32 x
                with 1e30, +-3.3e38, 1e-30, subnormal, +-inf and NaN entries
                must give the reference's inf and NaN and, elsewhere, its
                values within tolerance;
  4. main     — the paper's smallest build: 2^24 unique uniform keys from a
                2^27 key space at the default geometry (32-key nodes, 16 per
                bucket, fill 0.5: 2^20 buckets, ~4.4 GB of state), then 8
                batches of 2^20 ops (20% INSERT fresh, 20% DELETE live, 50%
                POINT half hits, 9% SUCCESSOR, 1% RANGE of width 64,
                max_results=65536) through make_ops → apply_ops_safe →
                unsort, each with ``pipeline="off"`` (the single-buffer
                stripe kernel), with ``pipeline="on"`` and ``donate=False``
                (the staged one, functional) and with the default config
                on a copy of the state (the staged kernel's donated pass,
                flix_apply_staged_inplace).  Each run must launch its stripe
                kernel and no other, and the range gather, must rank its
                RANGE ops by one launch of the count kernel
                (flix_apply_rank) and by no torch node_rank on the card, and
                must not retry; the runs are held against each other and
                against the port's plain-torch reference engine on the card,
                and the final state passes the invariant checker; on it, a
                mixed batch of 2^14 and one of 2^20 ops hold the donated
                pass to its plain version, the functional staged pass and
                the single-buffer kernel, and time it in turns with the
                staged pass beside its bound (``flixbench/roofline.py``'s
                bytes);
                ``core.merge_underfull`` then repacks it once, timed, with
                I1-I5 holding and every bucket's live pairs kept.  Each batch
                times the range gather and the count kernel at the fused
                call site by CUDA events, as a call and queued behind a
                sleep of the card, each beside its bound, an empty kernel,
                and the torch node_rank pair the count kernel replaced;
  5. fig9     — the paper's Fig. 9 round schedule (benchmarks/query_qtmf.py)
                through ``repro_torch.kernels.ops`` on a fresh build of the
                same size: 4 insert rounds of 2^22 fresh keys, then 4 delete
                rounds of those keys; after each round 2^24 all-hit and 2^24
                all-miss point queries and 2^22 uniform successor queries
                (benchmarks/successor.py).  Every call is held against the
                port's core function on the card, every round must launch its
                kernels, no insert may overflow, and the final state passes
                the invariant checker.  Each query launch prints its time,
                its bound and their ratio; each delete round also times its
                pre-filter (a point query of the 2^22 keys) beside that
                query's bound; each round also times the staged stripe
                kernel on its keys as an insert-only or delete-only batch
                of ops (its update path in every bucket);
  6. serve    — ``KVPageIndex(node_size=32, nodes_per_bucket=16,
                snapshot_window=2)`` on the card, holding 2^24 page keys
                (2^16 sequence slots x 256 pages, 2^20 buckets) with a TTL
                plane, for 12 steps with an advancing clock: 2^14 sequences
                append a page with a deadline, 2^18 lookups (half hits), 2^12
                get-or-sets, 2^8 sequences freed and earlier ones re-admitted
                with a 128-page prefill, 2^10 page enumerations under a 2^18
                range budget; every fourth step is read-only and the last
                reads ``as_of`` a pinned version.  Every step is held against
                a reference-engine index run on the same pre-step state, no
                step may retry, and the final state passes I1-I6 at its clock;
  7. range    — ``flix_range`` on a 2^24-key build: 2^16 narrow (~16 keys)
                and 2^12 wide (~256 keys) ranges (benchmarks/range_mix.py)
                under max_results = 2^20, held against ``dense_range_scan``;
                the count kernel and the scatter timed in turns, as a call
                and queued, beside their bounds, and the seam's parts apart
                (node metadata, the engine's _node_metadata it replaced,
                live_prefix, range_offsets, range_slot_ranks);
                ``range_query`` and ``with_successor_cache`` against their
                definitions;
  8. moe      — the flipped MoE FFN of examples/moe_routing.py (make_plan,
                dispatch, grouped_matmul up, silu, grouped_matmul down,
                combine) through ``repro_torch.kernels.ops`` at full width
                in bf16, widths from ``repro_torch.configs``: A
                deepseek-moe-16b, 128 tokens (decode_32k's global batch; 768
                slots over 64 experts); B the same, 4096 tokens (a prefill
                chunk); C mixtral-8x22b, 4096 tokens; and a skewed router at
                A's size (one expert takes every token, 16 take none).  Both
                GEMMs of each FFN must launch the kernel and equal
                ``grouped_matmul_reference``, and the FFN the dense oracle
                ``moe_ffn_reference``; all 8 GEMMs must run the wgmma
                variant.  The FFN's parts (make_plan, dispatch, up GEMM,
                silu, down GEMM, combine) are timed by CUDA events; each
                GEMM prints its variant, its kernel, plain and library
                (``torch._grouped_mm``) times, its bound (an f32 x bf16
                GEMM's operations counted as the split's 3 bf16 products at
                the bf16 rate) and PR 14's bound (67 TFLOP/s).  Cuts:
                one MoE layer of 28 or 56 (every layer repeats the same
                computation on other weights); deepseek's 2 shared experts
                are not on this path (``moe_dispatch`` has none);
  9. durable   — phase 6's index made durable (``repro_torch.checkpoint``),
                in a temporary directory deleted at the end: the 2^24-key
                build's first full snapshot by ``DurableFliX.create``;
                ``KVPageIndex(durability_dir=..., snapshot_every=4)``
                recovers it on the card to the build's canonical bytes;
                phase 6's 12 steps (the last read at the newest version),
                every update step committed through the WAL, held step for
                step against a reference-engine index that starts from the
                recovered state (StepResults, states, expiry planes) and
                timed beside the same step on an index without durability;
                a full and a delta snapshot (every 4th commit); the fused
                path's kernels launched by every commit.  Then a crash: the
                crash hook raises at ``wal.append.partial`` of the 10th
                commit and the index is dropped without ``close()``; a new
                index on the directory truncates the torn tail, replays the
                WAL through the fused path and lands on the oracle's
                canonical bytes at the last acknowledged seq; 3 more steps
                (the crashed one first) equal the oracle's.  Printed: WAL
                bytes and append + fsync per commit, each commit's overhead,
                each snapshot's bytes and its canonicalization on the card,
                crcs and write + fsync, each recovery's chain load, rebuild
                on the card and replay, beside the card's name and power
                limit;
 10. gateway   — the multi-tenant exactly-once gateway
                (``repro_torch.serve.Gateway``) over phase 6's content made
                durable in a temporary directory (deleted at the end), opened
                by ``KVPageIndex(durability_dir=..., snapshot_window=2)``:
                pumps of at most 2^14 ops, a queue of 2^16, a dedup window
                of 2^20 keys, frees of 256 pages, a 2^18 range budget, 8
                tenants (one hot, weight 3).  64 clients (``GatewayTraffic``)
                offer 1.5x what a pump drains for 24 ticks: allocs of pages
                below 256, lookups that hit and miss, page enumerations,
                frees and lookups pinned to the previous version; the hot
                tenant bursts, 4 clients send every request 4 times, 4 set
                deadlines 0-2 ticks ahead, every retryable rejection is sent
                again with its key.  The 12th update pump crashes at
                ``gateway.step.done`` (committed, durable, unacknowledged);
                a new index and gateway recover the directory and every
                client sends all its requests again from tick 0.  Every read
                equals a host model (pinned ones at their version), no key
                commits twice over the WAL's dedup trail and the later log,
                the crashed pump's keys resolve as duplicates, the recovered
                and final live pairs equal the model's, no step retries, and
                every update pump launches the staged stripe kernel and the
                fence rows (with page enumerations, the rank count and the
                gather too).  Printed: each pump's requests and ops and its
                host ms split into formation, ``index.step`` (synced) and
                resolution, its WAL record bytes and append + fsync; per
                run goodput, shed counts by code, queued latency p50 / p99
                in ticks; the recovery's split; peak device memory;
 11. tiered    — tiered residency (``repro_torch.core.residency``).  First
                (3i, after phase 3f) ``TieredFliX`` on the card against
                ``apply_ops_safe`` on a single-tier copy, exactly, I7 after
                every batch: phase 3a's 2^18-key state and batches under
                budgets of the whole index, a tenth and one bucket, batches
                confined to one bucket and to two (packed states of 1 and 2
                buckets), a read-only batch that leaves the mirror's bytes,
                an overflow that grows and replays at 4-key nodes, 2 a
                bucket, and ``compact()``.  (11a) ``benchmarks/
                tiered_scale.py``'s traffic at full width: 2^24 even keys
                (vals = keys >> 1) in 2^20 buckets of 16 32-key nodes
                (4,437,573,633 B single-tier), sweeps of 6 batches of 2^16
                ops over a hot window of 5% of the key space moved by half
                its width each batch, at two read points (read90: 90% reads,
                POINT 70% / SUCCESSOR 30%, 10% INSERT of fresh odd keys;
                read70) and two budgets (the whole index; a tenth,
                443,757,363 B).  Per read point and budget a checked sweep
                (every batch equal to ``apply_ops`` on a single-tier copy on
                the card, results and shared stats; at its end the host
                view's canonical bytes equal to the copy's, and I7), then 2
                timed sweeps on fresh copies, each batch's results held to
                the checked sweep's; every batch launches the staged stripe
                kernel and the fence rows, and at 10x stays within the
                budget.  Printed per batch of the checked sweep: touched
                buckets, promoted, demoted, resident bytes, and host ms
                split into the pre-pass, page-in (sync + gather), the packed
                fused pass (CUDA events), the meta refresh and page-out; per
                sweep the ops/s and the parts' sums; per read point
                goodput(10x) / goodput(1x), each the best timed sweep (the
                benchmark's rule).  (11b) Durable tiered
                serving: phase 6's content without its TTL plane made
                durable, opened by ``KVPageIndex(device_budget=full // 10,
                durability_dir=..., snapshot_every=4)`` with
                ``TieredFliX.materialize`` rigged to raise for the whole
                phase; the open may add at most 64 MiB to the card's peak;
                phase 6's step mix at 2^11 appends, 2^14 lookups (half hits),
                2^9 get-or-sets with deadlines (the TTL plane appears
                mid-stream), 2^6 frees with the slots freed the step before
                re-admitted with a 128-page prefill, 2^8 enumerations under a
                2^14 budget, drawn from a hot set of 2^11 of the 2^16
                sequence slots, every fourth step read-only; each step held
                against a single-tier reference-engine index; a crash at the
                6th commit's ``wal.append.partial``; a cold reopen onto the
                oracle's canonical bytes (host view) and I7; 2 more steps.
                Cut: depth only (6 batches a sweep; 8 steps);
 12. sharded   — the sharded index (``repro_torch.core.distributed``), 4
                shards on the one card.  First (3j, after 3i) 2 and 4 shards
                of 2^14 keys from a 100,000-key space against ``apply_ops``
                on one state of the union geometry, exactly (results, stats,
                every shard's slice): tests/test_shard_engine.py's mixed
                batch under both routings, an a2a batch at capacity 1 (its
                overflow reported, shard_apply_ops_safe's capacity retries
                counted), a 300-key burst that overflows the last shard and
                regrows through ``shard_restructure``, TTL with and without
                ``now``, a read-only and an all-NOP batch.  (12a) Phase 4's
                build range-partitioned into 4 shards of 2^18 buckets beside
                phase 4's single-device state; 4 batches of phase 4's mix
                under "replicated", then the same 4 under "a2a" (chunks of
                2^18, 2^17 rows a pair), through make_ops →
                ``shard_apply_ops_safe`` → unsort, each held against
                ``apply_ops_safe`` on the single state (results, stats,
                every shard's slice), each launching the stripe kernel and
                the fence rows once a shard and retrying nothing.  Printed
                per batch: host ms (synced), a CUDA-event split into
                routing, the RANGE counts phase, the shards' apply_ops and
                the combine; per routing the median and MOps/s beside the
                single-device path's.  (12b) Phase 6's content made durable
                by a ``ShardEngine`` over 4 shards, opened by
                ``KVPageIndex(shards=4, config=ExecConfig(routing="a2a"),
                durability_dir=..., snapshot_every=4)``; 8 of phase 6's
                steps (no pinned read), each against a single-device index
                (StepResults; live pairs after every update step, read shard
                by shard); a crash at the 6th commit's
                ``wal.append.partial``; a reopen with ``shards=4`` onto the
                oracle's canonical bytes; 2 more steps.  Printed: each
                step's ms and its overhead over a sharded index without
                durability, WAL bytes, a2a_retries, the recovery split.
                Cut: depth only (4 batches a routing; 8 steps);
 13. baselines  — the paper's baselines (``repro_torch.core.baselines``) beside
                FliX on Fig. 9's schedule (``benchmarks/query_qtmf.py:14-80``):
                phase 5's 2^24 keys from 2^27 in FliX at 32 x 16 (through
                ``repro_torch.kernels.ops``), the B-tree with its defaults
                (16-key leaves, 16 a bucket), LSM with 4096-pair chunks and
                ``lsm_levels(2n, 4096)`` = 15 levels, a hash table of
                ``int(2n / 0.8)`` slots and a sorted array of 2n; 4 insert
                rounds of 2^22 fresh keys, then 4 delete rounds of those
                keys; after each round 2^24 all-hit and 2^24 all-miss point
                queries per structure, each timed by CUDA events after a warm
                call, with its ``memory_bytes()`` and QTMF; after the last
                round 2^22 uniform successor queries for FliX, the sorted
                array and LSM.  Every answer equals FliX's on the same
                contents (a hash table that left keys unplaced is held on the
                keys it placed, the count printed).  The baselines are plain
                torch emulations of the paper's, as the reference's are jnp
                ones.  Nothing cut;
 14. lm        — the LM serving path (``repro_torch.models``,
                ``repro_torch.launch.serve``).  (14a) deepseek-moe-16b at its
                full width (D 2048, 16 heads of 128, 64 experts top 6 + 2
                shared, ``moe_d_ff`` 1408, vocab 102,400), depth cut to 2,
                float32 with capacity factor 8 (TF32 matmuls off): 16
                ``decode_step``s equal ``forward`` on those tokens within
                ``rtol=atol=2e-3`` and ``moe_ffn`` on 64 tokens its dense
                oracle within ``rtol=2e-3, atol=2e-4`` (the reference's own
                checks, ``tests/test_models.py:53-66``, ``:124-145``).
                (14b) ``main(["--arch", "deepseek-moe-16b", "--batch", "16",
                "--steps", "48", "--max-len", "128"])``: full width and
                depth, float32 parameters (67.5 GB) and cache, bfloat16
                compute, the driver's own checks, finite logits at every
                step, the index's live pairs equal a host model, the staged
                stripe kernel and the fence rows launched by each of the 3
                update steps (they carry no RANGE op, so the rank count and
                the gather stay idle); each decode step timed by CUDA
                events beside the bound of its float32 parameter bytes,
                each index step by the host clock, peak memory.  (14c)
                every driver path at reduced widths (``--arch
                musicgen-medium --reduced --batch 4 --steps 32 --max-len
                64``): the gateway over a durable index, a second run on
                its directory (the recovery line), pinned reads
                (``--snapshot-window 6``, and 2: ``SNAPSHOT_GONE``), page
                TTLs, tiered residency, 2 shards under a2a on the one card,
                and the reference engine.  Cut: 14a's depth only; 14b
                nothing but the driver's own batch and length;
 15. train     — the LM training path (``repro_torch.optim``, ``.data``,
                ``.train``, the pytree ``CheckpointManager``,
                ``repro_torch.launch.train``).  (15a) deepseek-moe-16b at
                full width, depth 2, float32 parameters: in float32 at batch
                2 x 64, ``remat=True``'s loss and gradients equal
                ``remat=False``'s (every leaf within 1e-5 of its largest
                |g|), ``chunked_lm_loss`` one unchunked cross entropy (rel
                1e-5), one ``train_step`` on the card the same step on the
                CPU at a reduced width (loss and norm rel 1e-5, moments 1e-4
                of a leaf's max, parameters within the rate, all but one in
                a thousand within 1e-3 of it); then the registry's bfloat16
                compute, batch 8 x 512, ``remat``, ``loss_chunk`` 512, the
                data pipeline's stream: 12 steps, each timed by CUDA events
                beside the bound (model FLOPs at 989 TFLOP/s or AdamW's 28
                bytes a parameter at 3.35 TB/s), loss and grad norm finite
                at every step, peak memory.  (15b) the driver as a user runs
                it: ``--arch mamba2-1.3b --batch 8 --seq 64 --steps 6`` (the
                registry config, 48 layers); musicgen-medium ``--reduced``
                12 steps, then ``--steps 16`` resuming from step 12; a
                crash injected after the step-10 checkpoint, whose rerun
                must end at an uninterrupted run's state (15a's
                tolerances).  (15c) ``examples/train_lm_torch.py`` (~88M
                parameters) for 300 steps: the loss must fall by 1 nat.  No
                FliX kernel may launch in phase 15.  Cut: 15a's depth only;
                15b's sequence length (64: the SSD's masked exp overflows
                in the backward pass at chunks of 128 and more);
 16. sharded — the sharded LM scaffolding (``repro_torch.sharding``,
                ``launch/mesh.py``, ``models/moe_a2a.py``,
                ``launch/steps.py``, ``launch/dryrun.py``,
                ``launch/roofline.py``) on a 4 x 2 mesh of the one card
                (``make_mesh_auto((4, 2), ..., ["cuda:0"] * 8)``).  (16a)
                deepseek-moe-16b at full width, depth 2, float32, capacity
                factor 8: ``moe_ffn_a2a`` on 256 tokens against
                ``moe_ffn_dense_oracle`` within 2e-4; then
                ``build_cell(..., moe_impl="a2a")``'s train step at batch 4
                x 64 (the smallest batch the data axis divides) against the
                single-device ``train_step`` on the same state (loss within
                1e-3, grad norm rel 1e-4, 15a's moment and parameter
                tolerances).  (16b) the a2a train cell at 8 x 512, the
                registry's bfloat16 compute: 6 steps timed by CUDA events
                beside 15a's single-device step, tok/s, peak memory, the
                collective bytes by kind a step; the prefill (8 x 512,
                ``moe_impl="auto"``: a2a) and decode (batch 16, max-len 128,
                auto: the gather path under ``dispatch_spec``) cells at depth
                2, capacity factor 8, against the single-device forward and
                ``decode_step``.  (16c) the dry run of deepseek-moe-16b
                ``train_4k`` on a 16 x 16 mesh of meta positions, its JSON
                and the roofline row with the H100's constants.  No FliX
                kernel may launch in phase 16.  Cuts: depth 2 (16a, 16b),
                16b's shape (8 x 512 of 256 x 4096), eight positions on one
                card;
 17. the kernels line, the card line, and the result line.

Phase 3k (after 3j): the staged kernel's warps a block, ``ExecConfig.
block_b``, at 2^20 keys in 32 x 16 and 16 x 8 and 2^18 in 32 x 64: every
candidate W of ``kernels/autotune.py`` whose block fits gives the default
launch's outputs byte for byte; its blocks an SM by the occupancy API times
W equal the autotuner's model; the model's shared-memory bytes equal the
library's; a W that does not fit raises ``ValueError`` naming it; the
config's ``block_b`` and a tuned tile table reach the launch through
``apply_ops``.  Phase 4b (after 4): ``autotune([2^24], [2^20], node_size=32,
nodes_per_bucket=16, measure=True)``, the model's pick, the measured pick and
every candidate's time.

Each phase prints its seconds.  The script needs one card and exits non-zero
without one, or when it runs without the repository's ``src/`` beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from statistics import fmean, median

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
FULL_KEYS = 1 << 24
FULL_SPACE = 1 << 27
FULL_OPS = 1 << 20
FULL_BATCHES = 8
FULL_MAX_RESULTS = 65536
FIG9_ROUND = 1 << 22  # keys per insert / delete round: a quarter of the build
FIG9_QUERIES = 1 << 24  # all-hit and all-miss point queries per round
FIG9_SUCC = 1 << 22  # uniform successor queries per round
BASELINE_CHUNK = 4096  # phase 13: LSM pairs a chunk (benchmarks/query_qtmf.py:24)
BASELINE_LOAD = 0.8  # phase 13: the hash table's load at 2n keys (paper §5.1)
SERVE_SEQS = 1 << 16  # sequence slots of the serving index
SERVE_PAGES = 256  # pages per slot in the installed build
SERVE_STEPS = 12
SERVE_APPENDS = 1 << 14  # sequences appending one page per update step
SERVE_LOOKUPS = 1 << 18
SERVE_GETSETS = 1 << 12
SERVE_FREES = 1 << 8
SERVE_PREFILL = 128  # pages of a re-admitted sequence
SERVE_RANGES = 1 << 10
SERVE_RANGE_BUDGET = 1 << 18
SERVE_TTL = 40  # clock units an appended page lives (4 steps)
DURABLE_SNAPSHOT_EVERY = 4  # phase 9: a snapshot every 4th commit
DURABLE_CRASH_COMMIT = 10  # phase 9: the commit whose half-written record ends the run
DURABLE_AFTER = 3  # phase 9: steps served after the recovery, the crashed one first
GATEWAY_CLIENTS = 64  # phase 10: each owns SERVE_SEQS / 64 sequence ids
GATEWAY_TENANTS = 8  # client c belongs to tenant c % 8; tenant 0 is the hot one
GATEWAY_BATCH_OPS = 1 << 14  # ops one pump commits at most (a free costs SERVE_PAGES)
GATEWAY_QUEUE_OPS = 1 << 16
GATEWAY_DEDUP = 1 << 20  # committed keys remembered: above every key of the run
GATEWAY_RANGE_BUDGET = 1 << 18
GATEWAY_LOAD = 1.5  # offered ops a tick over what one pump drains
GATEWAY_TICKS = 24
GATEWAY_DRAIN_TICKS = 40  # ticks after the last fresh requests, retries only
GATEWAY_MAX_RETRIES = 30  # sends of one key before its client gives up
GATEWAY_CRASH_PUMP = 12  # the update pump whose gateway.step.done ends the first run
TIERED_KEYS = 1 << 24  # phase 11a: even keys 0 .. 2^25 - 2 (benchmarks/tiered_scale.py)
TIERED_BATCH = 1 << 16  # ops a batch
TIERED_ROUNDS = 6  # batches a sweep
TIERED_HOT = 0.05  # the hot window's share of the key space
TIERED_POINTS = (("read90", 0.9), ("read70", 0.7))  # read share of a batch
TIERED_OVERSUB = 10  # the index over the device budget
TIERED_TIMED_SWEEPS = 2  # phase 11a: sweeps timed after the checked one (the benchmark's)
TIERED_SHARED_STATS = ("inserted", "deleted", "overflowed_buckets", "range_truncated")
TIERED_HOT_SEQS = 1 << 11  # phase 11b: the running batch's sequence slots
TIERED_SERVE = dict(steps=8, appends=1 << 11, lookups=1 << 14, getsets=1 << 9,
                    frees=1 << 6, ranges=1 << 8, range_budget=1 << 14)
TIERED_CRASH_COMMIT = 6  # phase 11b: the commit whose half-written record ends the run
TIERED_AFTER = 2  # phase 11b: steps served after the recovery, the crashed one first
TIERED_OPEN_SLACK = 64 << 20  # phase 11b: device bytes the cold open may allocate
SHARDS = 4  # phase 12: shards of the sharded index, all on the one card
SHARD_SMALL_KEYS = 1 << 14  # phase 3j: keys of the small sharded index
SHARD_SMALL_SPACE = 100_000  # phase 3j: their key space (tests/test_shard_engine.py's)
SHARD_BATCHES = 4  # phase 12a: batches of phase 4's mix a routing
SHARD_SERVE_STEPS = 8  # phase 12b: phase 6's steps served, the pinned read left out
SHARD_CRASH_COMMIT = 6  # phase 12b: the commit whose half-written record ends the run
SHARD_AFTER = 2  # phase 12b: steps served after the recovery, the crashed one first
RANGE_NARROW, RANGE_WIDE = 1 << 16, 1 << 12  # ranges of ~16 and ~256 keys
RANGE_MAX_RESULTS = 1 << 20
FENCE_BUCKETS = (1 << 20) + 3  # phase 3h: the main path's buckets, no multiple of a tile
RANGE_EDGE_KEYS = 1 << 20  # phase 3e: keys of each range edge case's state
# phase 3e: budgets at which csrc/flix_range.cu's gather takes 1, 2 and 4
# slots a thread on an H100 (132 SMs of 2048 resident threads); the middle
# one odd, so that a thread's last slot is alone; 2^19 - 3 ops also take 2
# a lane in the count kernel
RANGE_EDGE_BUDGETS = (1 << 17, (1 << 19) - 3, 1 << 21)
MOE_PREFILL = 4096  # tokens of a prefill chunk
# (run, configuration, tokens; None: decode_32k's global batch, skewed router)
MOE_RUNS = (
    ("A", "deepseek-moe-16b", None, False),
    ("B", "deepseek-moe-16b", MOE_PREFILL, False),
    ("C", "mixtral-8x22b", MOE_PREFILL, False),
    ("skew", "deepseek-moe-16b", None, True),
)
MOE_TIME_MS = 100  # CUDA-event window per timed GEMM
FFN_PART_REPS = 5  # FFN runs timed part by part
# phase 4's three paths: the single-buffer kernel, the functional staged
# kernel (what a caller that keeps its input runs) and the engine's default,
# the staged kernel's donated pass
STRIPE_KERNEL = {"off": "flix_apply", "staged": "flix_apply_staged",
                 "on": "flix_apply_staged_inplace"}
PHASE4_PATHS = {"off": dict(pipeline="off", donate=False),
                "staged": dict(pipeline="on", donate=False), "on": {}}
CSRC = "src/repro_torch/csrc/"
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "flix_apply": ("flix_apply.cu", "src/repro/kernels/flix_apply.py:88"),
    "flix_apply_staged": ("flix_apply_staged.cu",
                          "src/repro/kernels/flix_apply.py:414"),
    # the donated pass (plan and in-place write), where the reference donates
    # its state to the jitted kernel
    "flix_apply_staged_inplace": ("flix_apply_staged.cu",
                                  "src/repro/kernels/flix_apply.py:851"),
    "flix_apply_range": ("flix_range.cu", "src/repro/kernels/flix_apply.py:327"),
    # the jnp rank plumbing that flix_apply_pallas runs beside its kernel
    "flix_apply_rank": ("flix_range.cu", "src/repro/kernels/flix_apply.py:558"),
    "flix_point_query": ("flix_query.cu", "src/repro/kernels/flix_query.py:54"),
    "flix_successor": ("flix_successor.cu", "src/repro/kernels/flix_successor.py:45"),
    # the jnp scan that flix_successor_pallas runs beside its kernel
    "flix_fence_rows": ("flix_fence_rows.cu", "src/repro/kernels/flix_successor.py:150"),
    "flix_insert": ("flix_insert.cu", "src/repro/kernels/flix_insert.py:39"),
    "flix_delete": ("flix_delete.cu", "src/repro/kernels/flix_delete.py:48"),
    "flix_range_count": ("flix_range.cu", "src/repro/kernels/flix_range.py:53"),
    "flix_range_scatter": ("flix_range.cu", "src/repro/kernels/flix_range.py:82"),
    "grouped_matmul": ("grouped_matmul.cu", "src/repro/kernels/grouped_matmul.py:33"),
}


def log(*args):
    print(*args, flush=True)


class Traffic:
    """Unique uniform keys of one key space, with the live set tracked on
    the card so that deletes hit live keys and inserts are always fresh."""

    def __init__(self, space: int, n_keys: int, gen: torch.Generator):
        dev = gen.device
        self.space, self.gen = space, gen
        self.perm = torch.randperm(space, generator=gen, device=dev).to(torch.int32)
        self.alive = torch.zeros(space, dtype=torch.bool, device=dev)
        self.alive[self.perm[:n_keys].long()] = True
        self.fresh = n_keys

    def initial(self):
        keys = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        return keys, self._rand_vals(keys.numel())

    def _rand_vals(self, n):
        return torch.randint(0, 1 << 30, (n,), generator=self.gen, device=self.gen.device,
                             dtype=torch.int32)

    def _rand_keys(self, n):
        return torch.randint(0, self.space, (n,), generator=self.gen, device=self.gen.device,
                             dtype=torch.int32)

    def mixed(self, n: int, width: int = 64):
        """20% INSERT fresh, 20% DELETE live, 50% POINT (half hits), 9%
        SUCCESSOR, 1% RANGE [lo, lo+width)."""
        from repro_torch import core

        dev = self.gen.device
        n_ins = n_del = n // 5
        n_succ, n_rng = (n * 9) // 100, n // 100
        n_pt = n - n_ins - n_del - n_succ - n_rng
        ins = self.perm[self.fresh : self.fresh + n_ins]
        self.fresh += n_ins
        live = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        dels = live[torch.randperm(live.numel(), generator=self.gen, device=dev)[:n_del]]
        hits = live[torch.randint(0, live.numel(), (n_pt // 2,), generator=self.gen,
                                  device=dev)]
        rlo = self._rand_keys(n_rng)
        tags = torch.cat([
            torch.full((n_ins,), core.OP_INSERT, dtype=torch.int32, device=dev),
            torch.full((n_del,), core.OP_DELETE, dtype=torch.int32, device=dev),
            torch.full((n_pt,), core.OP_POINT, dtype=torch.int32, device=dev),
            torch.full((n_succ,), core.OP_SUCCESSOR, dtype=torch.int32, device=dev),
            torch.full((n_rng,), core.OP_RANGE, dtype=torch.int32, device=dev),
        ])
        keys = torch.cat([ins, dels, hits, self._rand_keys(n_pt - n_pt // 2),
                          self._rand_keys(n_succ), rlo])
        vals = torch.cat([self._rand_vals(n_ins), torch.zeros_like(keys[: n - n_ins - n_rng]),
                          rlo + width])
        self.alive[ins.long()] = True
        self.alive[dels.long()] = False
        return tags, keys, vals

    def boundary(self):
        """Keys 0 and MAX_VALID, duplicate reads, a deleted run of keys that
        empties whole buckets, and ranges over all three."""
        from repro_torch import core

        dev = self.gen.device
        live = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        a, b = int(live[1000]), int(live[1400])
        dels = live[1000:1400]
        fresh = self.perm[self.fresh : self.fresh + 8]
        self.fresh += 8
        edge = [core.MAX_VALID] + ([] if bool(self.alive[0]) else [0])  # MAX_VALID > space
        ins = torch.cat([torch.tensor(edge, dtype=torch.int32, device=dev), fresh])
        reads = torch.cat([
            live[torch.arange(0, 20 * 97, 97, device=dev)].repeat(4),
            torch.tensor([0, 1, core.MAX_VALID - 1, core.MAX_VALID, core.EMPTY],
                         dtype=torch.int32, device=dev),
            torch.arange(a - 5, b + 5, 7, dtype=torch.int32, device=dev),
        ])
        rlo = torch.tensor([a - 10, 0, core.MAX_VALID - 5, a, a], dtype=torch.int32, device=dev)
        rhi = torch.tensor([b + 10, 50, core.EMPTY, a, b], dtype=torch.int32, device=dev)
        n_r = reads.numel()
        tags = torch.cat([
            torch.full((ins.numel(),), core.OP_INSERT, dtype=torch.int32, device=dev),
            torch.full((dels.numel(),), core.OP_DELETE, dtype=torch.int32, device=dev),
            torch.where(torch.arange(n_r, device=dev) % 2 == 0, core.OP_POINT,
                        core.OP_SUCCESSOR).to(torch.int32),
            torch.full((rlo.numel(),), core.OP_RANGE, dtype=torch.int32, device=dev),
        ])
        keys = torch.cat([ins, dels, reads, rlo])
        vals = torch.cat([self._rand_vals(ins.numel()),
                          torch.zeros(dels.numel() + n_r, dtype=torch.int32, device=dev), rhi])
        self.alive[ins[ins < self.space].long()] = True
        self.alive[dels.long()] = False
        return tags, keys, vals


def max_abs_err(want, got):
    """The largest difference over paired outputs: an int for integer
    outputs, a float (inf where either side is not finite) for float ones."""
    err = 0
    for i, (w, g) in enumerate(zip(want, got)):
        if w.shape != g.shape:
            raise AssertionError(f"output {i}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not w.numel():
            continue
        if w.is_floating_point():
            d = (w.double() - g.double()).abs().max()
            err = max(err, float(d) if torch.isfinite(d) else float("inf"))
        else:
            err = max(err, int((w.long() - g.long()).abs().max()))
    return err


def close_err(want, got, label) -> float:
    """``got`` against ``want`` where both sum exact float32 products in
    float32, in different orders: within ``1e-4 * |want| + 1e-4 * max|want|``
    elementwise (NaN fails).  Returns the largest absolute error."""
    err = max_abs_err([want], [got])
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = (got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale
    if not bool(ok.all()):
        raise AssertionError(f"{label}: outside float32 tolerance (max_abs_err {err}, "
                             f"max|want| {scale})")
    return err


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events around
    calls queued behind a sleep of the card, so that the host's time to
    issue them (a wrapper's Python, the ctypes call) stays off the clock.
    The sleep doubles until it outlasts the issuing."""
    cycles = 1 << 24  # ~8 ms at the H100's clock
    while True:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ev[2].record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > issue_ms:
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 2


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class KernelCheck:
    """Runs both kernels against their plain versions on given inputs and
    keeps the worst error; raises on any disagreement."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}

    def hold(self, kernel, want, got, label):
        """One kernel's outputs against its plain version's: keep the worst
        error, raise on any."""
        torch.cuda.synchronize()
        e = max_abs_err(want, got)
        self.err[kernel] = max(self.err[kernel], e)
        if e:
            raise AssertionError(f"{label}: {kernel} disagrees with its plain version ({e})")
        return e

    def hold_close(self, kernel, want, got, label):
        """A float kernel's output against its plain version's, within
        :func:`close_err`'s tolerance; keep the worst error."""
        torch.cuda.synchronize()
        e = close_err(want, got, f"{label}: {kernel}")
        self.err[kernel] = max(self.err[kernel], e)
        return e

    def run(self, state, ops, max_results, label):
        from repro_torch import core
        from repro_torch.core.state import FliXState
        from repro_torch.kernels import flix_apply as fa
        from repro_torch.kernels import flix_range as fr

        args, _ = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
        got = fa.flix_apply_pass(*args)
        staged = fa.flix_apply_staged_pass(state.num_nodes, *args)
        torch.cuda.synchronize()
        want = fa.flix_apply_reference(*args)
        e1 = max_abs_err(want, got)
        e3 = max(max_abs_err(want, staged), max_abs_err(got, staged))
        self.err["flix_apply_staged"] = max(self.err["flix_apply_staged"], e3)
        e6 = check_donated(state, ops, args, staged, label)[0]
        self.err["flix_apply_staged_inplace"] = max(self.err["flix_apply_staged_inplace"], e6)
        del staged
        new = FliXState(*got[:5], mkba=state.mkba, needs_restructure=state.needs_restructure)
        is_range = ops.tag == core.OP_RANGE
        g, pref, *_ = fa.range_slots(new, is_range, ops.key, ops.val, max_results)
        rk = fa.flix_apply_range_pass(g, pref, new.node_count, new.keys, new.vals)
        meta = (new.keys, new.node_count, new.node_max, new.mkba, pref, ops.key, ops.val)
        rank = fr.flix_range_count(*meta, is_range=is_range, kernel="flix_apply_rank")
        torch.cuda.synchronize()
        e2 = max_abs_err(fr.flix_range_gather_reference(g, pref, new.node_count, new.keys,
                                                        new.vals), rk)
        e4 = max_abs_err(fr.flix_range_count_reference(*meta, is_range=is_range), rank)
        self.err["flix_apply"] = max(self.err["flix_apply"], e1)
        self.err["flix_apply_range"] = max(self.err["flix_apply_range"], e2)
        self.err["flix_apply_rank"] = max(self.err["flix_apply_rank"], e4)
        log(f"  {label}: flix_apply max_abs_err={e1}, flix_apply_staged max_abs_err={e3} "
            f"(against the plain version and the single-buffer kernel), "
            f"flix_apply_staged_inplace max_abs_err={e6}, "
            f"flix_apply_range max_abs_err={e2}, flix_apply_rank max_abs_err={e4}")
        if e1 or e2 or e3 or e4 or e6:
            raise AssertionError(f"{label}: a kernel disagrees with its plain version")
        return args, got


def cloned(state):
    """The state with copies of its planes, for a call that donates them."""
    import dataclasses

    return dataclasses.replace(state, keys=state.keys.clone(), vals=state.vals.clone(),
                               node_count=state.node_count.clone(),
                               node_max=state.node_max.clone())


def check_donated(state, ops, args, staged, label):
    """The donated pass (``flix_apply_inplace_pass``) on copies of the
    state's planes, against its plain version on other copies (every output
    and plane) and against the functional staged pass's outputs ``staged``:
    where no bucket overflows, the keys, counts, node max, num_nodes and
    reads equal and the values at live slots; where one does, the copies
    untouched.  Returns the largest difference from the plain version and
    the plain version's host ms."""
    from repro_torch.core.query import _bucket_index
    from repro_torch.core.state import EMPTY
    from repro_torch.kernels import flix_apply as fa

    copies = [cloned(state) for _ in range(2)]
    b = _bucket_index(state, ops.key)
    got, (want, plain_ms) = (
        host_ms(lambda: fn(c.num_nodes, c.node_count, c.needs_restructure, ops.val, b, c.keys,
                           c.vals, c.node_max, *args[3:]))
        for fn, c in zip((fa.flix_apply_inplace_pass, fa.flix_apply_inplace_reference),
                         copies))
    got = got[0]
    planes = [(c.keys, c.vals, c.node_count, c.node_max) for c in copies]
    err = max(max_abs_err(want, got), max_abs_err(planes[1], planes[0]))
    k, v, cnt, mx = planes[0]
    if int(got[3][2]) == 0 and not bool(state.needs_restructure):
        live = staged[0] != EMPTY
        same = (torch.equal(k, staged[0]) and torch.equal(v[live], staged[1][live])
                and torch.equal(cnt, staged[2]) and torch.equal(mx, staged[3])
                and torch.equal(got[0], staged[4]) and torch.equal(got[1], staged[7])
                and torch.equal(got[2], staged[8]))
    else:
        same = all(torch.equal(a, b) for a, b in zip(
            planes[0], (state.keys, state.vals, state.node_count, state.node_max)))
    if not same:
        raise AssertionError(f"{label}: the donated pass disagrees with the functional one")
    return err, plain_ms


def compare_engines(label, state, ops, config, *, expect_retries=None):
    """The engine on its default path (the kernels, donating a copy of the
    state) against the port's plain-torch reference engine on the card:
    equal state and results."""
    from repro_torch import core

    fused = core.apply_ops_safe(cloned(state), ops, config=config)
    ref = core.apply_ops_safe(state, ops, config=config.replace(impl="reference"))
    check_same(label, fused, ref)
    if expect_retries is not None:
        assert fused[2]["restructure_retries"] == expect_retries, fused[2]
    return fused


def check_same_state(label, gs, ws):
    """The reference's parity contract: every layout field byte-equal, vals
    equal at live slots."""
    from repro_torch.core.state import EMPTY

    assert gs.geometry == ws.geometry, (label, gs.geometry, ws.geometry)
    for f in ("keys", "node_count", "node_max", "num_nodes", "mkba", "needs_restructure"):
        if not torch.equal(getattr(gs, f), getattr(ws, f)):
            raise AssertionError(f"{label}: state field {f} differs from the reference")
    live = ws.keys != EMPTY
    if not torch.equal(gs.vals[live], ws.vals[live]):
        raise AssertionError(f"{label}: live vals differ from the reference")


def check_same(label, got, want):
    gs, gr, gst = got
    ws, wr, wst = want
    check_same_state(label, gs, ws)
    for k in wr:
        if not torch.equal(gr[k], wr[k]):
            raise AssertionError(f"{label}: result {k} differs from the reference")
    for k in wst:
        if int(gst[k]) != int(wst[k]):
            raise AssertionError(f"{label}: stat {k}: {int(gst[k])} != {int(wst[k])}")


def phase_kernels(dev, check: KernelCheck):
    from repro_torch import core

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = core.ExecConfig(max_results=8192)

    log("phase 3a: 2^18 keys, default geometry, 4 mixed batches + a boundary batch")
    traffic = Traffic(1 << 21, 1 << 18, gen)
    state = core.build(*traffic.initial())
    for i in range(5):
        tags, keys, vals = traffic.mixed(1 << 16) if i < 4 else traffic.boundary()
        ops, _ = core.make_ops(tags, keys, vals)
        check.run(state, ops, cfg.max_results, f"batch {i}")
        state = compare_engines(f"batch {i}", state, ops, cfg, expect_retries=0)[0]
    core.check_invariants(state)
    emptied = int((state.num_nodes == 0).sum())
    log(f"  engine == reference engine on all 5 batches; {emptied} emptied buckets")
    assert emptied > 0

    log("phase 3e: flix_range count and scatter on the same state")
    nb = state.num_buckets
    gone = torch.nonzero(state.num_nodes == 0)[:, 0]
    gone = gone[(gone > 0) & (gone < nb - 1)][:50]
    some = torch.randint(1, nb - 1, (200,), generator=gen, device=dev)
    b = torch.cat([gone, some])
    start = state.mkba[b - 1] + 1  # first key a bucket could hold
    lo = torch.cat([start, start, state.mkba[b], start + 7, traffic._rand_keys(2000)])
    hi = torch.cat([state.mkba[b] + 1, start - 5, state.mkba[b] + 1, start,
                    lo[-2000:] + torch.randint(-500, 4000, (2000,), generator=gen, device=dev)])
    lo, order = torch.sort(lo.to(torch.int32), stable=True)
    hi = hi.to(torch.int32)[order]
    for budget in (512, 1 << 21):
        got = range_case(check, state, lo, hi, budget, f"ranges @ max_results={budget}")
        log(f"  {lo.numel()} ranges, max_results={budget}: count and scatter equal their "
            f"plain versions, the scan equals dense_range_scan; truncated {int(got[4])}")
        assert (int(got[4]) > 0) == (budget == 512)
    gen_edges = torch.Generator(device=dev)  # its own draws: the cases after keep theirs
    gen_edges.manual_seed(SEED + 6)
    for ns, npb in ((32, 16), (8, 8), (32, 64), (4, 2)):
        range_edge_case(dev, check, gen_edges, ns, npb, RANGE_EDGE_KEYS)

    log("phase 3h: the fence-row kernel at 2^20 + 3 buckets")
    fence_rows_case(dev, check, gen)

    log("phase 3b: long stripes (64 nodes x 32 keys = 2048 slots per bucket)")
    traffic = Traffic(1 << 20, 1 << 14, gen)
    keys, vals = traffic.initial()
    state = core.build(keys, vals, node_size=32, nodes_per_bucket=64)
    ops, _ = core.make_ops(*traffic.mixed(1 << 13))
    check.run(state, ops, cfg.max_results, "long stripes")
    compare_engines("long stripes", state, ops, cfg, expect_retries=0)

    log("phase 3c: overflow then retry through apply_ops_safe (4-key nodes, 2 per bucket)")
    keys = torch.arange(0, 640, 10, dtype=torch.int32, device=dev)
    state = core.build(keys, keys, node_size=4, nodes_per_bucket=2)
    flood = torch.arange(1, 200, 2, dtype=torch.int32, device=dev)
    tags = torch.cat([
        torch.full((flood.numel(),), core.OP_INSERT, dtype=torch.int32, device=dev),
        torch.full((keys.numel(),), core.OP_POINT, dtype=torch.int32, device=dev),
        torch.full((keys.numel(),), core.OP_SUCCESSOR, dtype=torch.int32, device=dev),
        torch.full((2,), core.OP_RANGE, dtype=torch.int32, device=dev),
    ])
    bkeys = torch.cat([flood, keys, keys + 3, torch.tensor([0, 150], device=dev)])
    bvals = torch.cat([flood * 7, torch.zeros(2 * keys.numel(), dtype=torch.int32, device=dev),
                       torch.tensor([120, 400], device=dev)]).to(torch.int32)
    ops, _ = core.make_ops(tags, bkeys.to(torch.int32), bvals, pad_to=256)
    check.run(state, ops, cfg.max_results, "overflowing pass")
    fused = compare_engines("overflow retry", state, ops, cfg, expect_retries=1)
    log(f"  retried once into geometry {fused[0].geometry}")


def fence_rows_case(dev, check: KernelCheck, gen):
    """The fence-row kernel against ``next_rows`` at 2^20 + 3 buckets (no
    multiple of a tile), with the non-empty test from ``node_max``
    (flix_successor's) and from ``num_nodes`` (the fused apply's): a built
    state at the default geometry with a run of emptied buckets longer than
    a tile, scattered emptied buckets and an emptied tail; then planes of
    4-key nodes, 2 a bucket, with random non-monotone heads, a third of them
    drawn from four values, 40% of the buckets empty and a run of 3000,
    their junk keys left in place."""
    from repro_torch import core
    from repro_torch.kernels import flix_successor as fs

    nb = FENCE_BUCKETS
    keys = torch.randperm(32 * nb, generator=gen, device=dev, dtype=torch.int32)[: 16 * nb]
    state = core.build(keys, keys ^ 0x5A5A)  # 16 keys a bucket at the default geometry
    assert state.num_buckets == nb, state.num_buckets
    gone = torch.cat([torch.arange(1000, 4000, device=dev),
                      torch.arange(nb // 10, nb // 5, 5, device=dev),
                      torch.arange(nb - 40, nb, device=dev)])
    dead = state.keys[gone]
    state = core.delete(state, torch.sort(dead[dead != core.EMPTY]).values)[0]
    assert bool((state.num_nodes[gone] == 0).all())
    cases = [("built state", state.keys, state.vals, state.node_max, state.num_nodes)]
    del keys, dead

    def rand(*shape):
        return torch.randint(0, core.EMPTY, shape, generator=gen, device=dev, dtype=torch.int32)

    k, v = rand(nb, 2, 4), rand(nb, 2, 4) - (1 << 30)
    some = torch.rand(nb, generator=gen, device=dev) < 1 / 3
    four = torch.tensor([0, 7, 1000, core.MAX_VALID], dtype=torch.int32, device=dev)
    k[:, 0, 0] = torch.where(some, four[(rand(nb) % 4).long()], k[:, 0, 0])
    active = (rand(nb) % 2 + 1) * (torch.rand(nb, generator=gen, device=dev) >= 0.4)
    active[nb // 2 : nb // 2 + 3000] = 0
    active = active.to(torch.int32)
    nm = torch.where(torch.arange(2, device=dev) < active[:, None], rand(nb, 2), core.EMPTY)
    cases.append(("random heads", k, v, nm.to(torch.int32).contiguous(), active))
    for label, k, v, nm, nn in cases:
        for kw in (dict(node_max=nm), dict(num_nodes=nn)):
            check.hold("flix_fence_rows", fs.next_rows(k, v, **kw), fs.fence_rows(k, v, **kw),
                       f"fence rows, {label}, {list(kw)[0]}")
    log(f"  {nb} buckets (a built state with {gone.numel()} emptied buckets, and random "
        f"non-monotone heads with {int((active == 0).sum())} empty buckets): flix_fence_rows "
        f"equals next_rows from node_max and from num_nodes")


def range_case(check, state, lo, hi, max_results, label):
    """flix_range's two passes against their plain versions, and the whole
    scan against ``dense_range_scan``, on one state and sorted batch."""
    from repro_torch import core
    from repro_torch.core.query import live_prefix, range_offsets, range_slot_ranks
    from repro_torch.kernels import flix_range as fr

    pref = live_prefix(state.node_count)
    meta = (state.keys, state.node_count, state.node_max, state.mkba, pref, lo, hi)
    want = fr.flix_range_count_reference(*meta)
    check.hold("flix_range_count", want, fr.flix_range_count(*meta), label)
    rank_lo, full = want
    is_range = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    start, _, total, _ = range_offsets(full, is_range, max_results)
    g = range_slot_ranks(rank_lo, start, total, max_results)
    gargs = (g, pref, state.node_count, state.keys, state.vals)
    check.hold("flix_range_scatter", fr.flix_range_gather_reference(*gargs),
               fr.flix_range_scatter(*gargs), label)
    got = fr.flix_range(state.keys, state.vals, state.mkba, lo, hi, max_results=max_results)
    oracle = core.dense_range_scan(state, is_range, lo, hi, max_results=max_results)
    if max_abs_err(oracle, got):
        raise AssertionError(f"{label}: flix_range differs from dense_range_scan")
    return got


def range_edge_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """flix_range's count kernel and gather (as the scatter) against their
    plain versions on their edges, one launch each (the count also on the
    ops in reverse order: it needs no order), and ``flix_range`` against
    ``dense_range_scan`` where every op is a RANGE op: bounds on, below and
    above the fences; a run of 140 emptied buckets (140 equal entries of
    pref, where only the last owns a rank), with ranges inside it and
    across it; hi <= lo; bounds at 0, EMPTY - 1 and EMPTY with 0 and
    MAX_VALID stored; narrow ranges inside one wide range; budgets that are
    no multiple of 32 and truncate; a state with no keys; states of 1, 1023
    and 1025 buckets, gathered at 1, 2 and 4 slots a thread; and a mixed batch's sorted keys under a 1% RANGE mask
    (the fused path's form)."""
    from repro_torch import core
    from repro_torch.core.query import live_prefix, range_offsets, range_slot_ranks
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flix_range as fr

    label = f"range edges, {n_keys} keys, ns={ns} npb={npb}"

    def rand(n, lo=0, hi=1 << 28):
        return torch.randint(int(lo), int(hi), (n,), generator=gen, device=dev,
                             dtype=torch.int64)

    keys = torch.unique(rand(n_keys, 1))
    keys[-1] = core.MAX_VALID
    keys = torch.cat([keys.new_zeros(1), keys]).to(torch.int32)
    state = core.build(keys, keys ^ 0x33, node_size=ns, nodes_per_bucket=npb)
    nb = state.num_buckets
    run = torch.arange(nb // 3, nb // 3 + 140, device=dev)
    dead = state.keys[run]
    state = core.delete(state, sorted_i32(dead[dead != core.EMPTY], keys[5000:9000:3]))[0]
    assert bool((state.num_nodes[run] == 0).all()), label
    mk = state.mkba.long()
    r0, r1 = int(run[0]), int(run[-1])
    b = torch.arange(0, nb - 2, 7, device=dev)
    narrow = rand(20000, mk[100], mk[3100])
    inner = rand(2000, mk[r0 - 1] + 1, mk[r1])
    gone = state.keys[state.keys != core.EMPTY]
    empty = core.delete(state, torch.sort(gone).values)[0]
    assert int(empty.num_nodes.sum()) == 0, label
    lo_ge = rand(20000)
    hi_ge = lo_ge - rand(20000, 0, 3000)
    hi_ge[::4] = lo_ge[::4]
    hi_ge[::25] = lo_ge[::25] + (1 << 16)
    batch = rand(1 << 20)
    mask = torch.rand(1 << 20, generator=gen, device=dev) < 0.01
    big = RANGE_EDGE_BUDGETS[-1]
    edge_lo = torch.tensor([0, 0, 0, 1, core.EMPTY - 1, core.EMPTY - 1, core.EMPTY, core.EMPTY],
                           device=dev)
    edge_hi = torch.tensor([0, 1, core.EMPTY, core.EMPTY, core.EMPTY - 1, core.EMPTY,
                            core.EMPTY, 0], device=dev)
    wide = rand(20000)
    # name: (state, lo, hi, budgets, mask)
    cases = {
        "bucket_fences": (state, torch.cat([mk[b], mk[b] + 1, mk[b] - 1, mk[b]]),
                          torch.cat([mk[b] + 1, mk[b + 1], mk[b] + 1, mk[b + 2] + 1]),
                          (big,), None),
        "emptied_run": (state, torch.cat([inner, rand(500, mk[r0 - 6] + 1, mk[r0 - 1] + 1)]),
                        torch.cat([inner + 100, rand(500, mk[r1 + 1] + 1, mk[r1 + 4])]),
                        (big,), None),
        "lo_ge_hi": (state, lo_ge, hi_ge, (big,), None),
        "edge_keys": (state, torch.cat([edge_lo, mk[-3:], rand(20, mk[-2], core.MAX_VALID)]),
                      torch.cat([edge_hi, torch.full((23,), core.EMPTY, device=dev)]),
                      (1 << 22,), None),
        "all_overlap": (state, torch.cat([mk[100:101], narrow]),
                        torch.cat([mk[3100:3101], torch.minimum(narrow + rand(20000, 1, 1 << 12),
                                                                mk[3100])]),
                        (big,), None),
        "odd_budget": (state, wide, wide + rand(20000, 1, 1 << 20), (517, 100003), None),
        "empty_state": (empty, wide, wide + rand(20000, -10, 1 << 20), (big,), None),
        "masked": (state, batch, torch.where(mask, batch + rand(1 << 20, 1, 1 << 11),
                                             rand(1 << 20, -(1 << 31), 1 << 31)),
                   (1 << 16,), mask),
    }
    p = max(1, ns // 2)  # keys a bucket holds at build
    # the searches' step counts at their edges: nb fences for the count
    # kernel, nb + 1 pref entries for the gather; ranges on, below and above
    # every fence, gathered at 1, 2 and 4 slots a thread (RANGE_EDGE_BUDGETS)
    for n_b in (1, 1023, 1025):
        small = torch.sort(keys[torch.randperm(keys.numel(), generator=gen, device=dev)
                                [: n_b * p]]).values
        st = core.build(small, small ^ 0x33, node_size=ns, nodes_per_bucket=npb)
        assert st.num_buckets == n_b, (label, n_b, st.num_buckets)
        f = st.mkba.long()
        nxt = torch.cat([f[1:], f[-1:]])
        cases[f"nb_{n_b}"] = (st, torch.cat([f, f - 1, f + 1, small.long()]),
                              torch.cat([nxt + 1, f + 1, nxt, small.long() + 1]),
                              RANGE_EDGE_BUDGETS, None)
    i32 = torch.iinfo(torch.int32)
    out = []
    for case, (st, lo, hi, budgets, m) in cases.items():
        lo, order = torch.sort(lo, stable=True)
        lo = lo.to(torch.int32)
        hi = torch.clamp(hi[order], i32.min, i32.max).to(torch.int32)
        m = None if m is None else m[order]
        is_range = torch.ones_like(lo, dtype=torch.bool) if m is None else m
        pref = live_prefix(st.node_count)
        meta = (st.keys, st.node_count, st.node_max, st.mkba, pref, lo, hi)
        before = dict(LAUNCHES)
        want = fr.flix_range_count_reference(*meta, is_range=m)
        check.hold("flix_range_count", want, fr.flix_range_count(*meta, is_range=m),
                   f"{label}, {case}")
        back = (*meta[:5], lo.flip(0).contiguous(), hi.flip(0).contiguous())
        check.hold("flix_range_count", [w.flip(0) for w in want], fr.flix_range_count(
            *back, is_range=None if m is None else m.flip(0).contiguous()),
                   f"{label}, {case}, ops in reverse order")
        n_k2 = RANGE_EDGE_BUDGETS[1]  # 2 ops a lane, where all of a big case take 4
        if lo.numel() > 2 * n_k2:
            part = (*meta[:5], lo[:n_k2], hi[:n_k2])
            sub = None if m is None else m[:n_k2]
            check.hold("flix_range_count", fr.flix_range_count_reference(*part, is_range=sub),
                       fr.flix_range_count(*part, is_range=sub), f"{label}, {case}, {n_k2} ops")
        for budget in budgets:
            start, _, total, trunc = range_offsets(want[1], is_range, budget)
            gargs = (range_slot_ranks(want[0], start, total, budget), pref, st.node_count,
                     st.keys, st.vals)
            check.hold("flix_range_scatter", fr.flix_range_gather_reference(*gargs),
                       fr.flix_range_scatter(*gargs), f"{label}, {case} @ {budget}")
            if m is None:
                got = fr.flix_range(st.keys, st.vals, st.mkba, lo, hi, max_results=budget)
                oracle = core.dense_range_scan(st, is_range, lo, hi, max_results=budget)
                if max_abs_err(oracle, got):
                    raise AssertionError(f"{label}, {case}: flix_range differs from "
                                         "dense_range_scan")
            assert (int(trunc) > 0) == (case == "odd_budget"), (label, case, int(trunc))
        counted = {k: LAUNCHES[k] - before[k] for k in ("flix_range_count", "flix_range_scatter")}
        extra = 0 if m is not None else len(budgets)  # flix_range's own launches
        extra_count = extra + (lo.numel() > 2 * n_k2)
        assert counted == {"flix_range_count": 2 + extra_count,
                           "flix_range_scatter": len(budgets) + extra}, (label, case, counted)
        out.append(f"{case} {lo.numel()} ops, {int(want[1].sum())} keys")
    zero = int((cases["lo_ge_hi"][2] <= cases["lo_ge_hi"][1]).sum())
    log(f"  {label}: {nb} buckets (140 emptied in a row), count and scatter equal their plain "
        f"versions, flix_range equals dense_range_scan: " + "; ".join(out)
        + f" ({zero} with hi <= lo)")


@contextlib.contextmanager
def torch_rank_calls():
    """Within the block, count the calls of the plain ``node_rank`` (the
    torch form of the range ranks) on card tensors: yields the list they are
    appended to."""
    from repro_torch.core import query
    from repro_torch.kernels import flix_range as fr

    calls, plain = [], query.node_rank

    def counted(*args):
        if args[-1].is_cuda:
            calls.append(args[-1].numel())
        return plain(*args)

    query.node_rank = fr.node_rank = counted
    try:
        yield calls
    finally:
        query.node_rank = fr.node_rank = plain


def phase_main(dev):
    from repro_torch import core
    from repro_torch.core.query import node_rank
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flix_apply as fa
    from repro_torch.kernels import flix_range as fr
    from repro_torch.kernels import flix_successor as fs

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    log(f"phase 4: build {FULL_KEYS} unique uniform keys from a {FULL_SPACE} key space")
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    state, build_ms = host_ms(lambda: core.build(keys, vals))
    del keys, vals
    nb, npb, ns = state.geometry
    log(f"  geometry nb={nb} npb={npb} ns={ns}, {state.memory_bytes() / 1e9:.3f} GB of state, "
        f"build {build_ms:.1f} ms")
    cfg = core.ExecConfig(max_results=FULL_MAX_RESULTS)
    launches = {k: 0 for k in (*STRIPE_KERNEL.values(), "flix_apply_range",
                               "flix_apply_rank", "flix_fence_rows")}
    e2e = {pipe: [] for pipe in PHASE4_PATHS}
    k_ms = {"off": [], "staged": []}
    r_ms, r_queued_ms, rbounds, empty_ms = [], [], [], []
    rank_ms, rank_queued_ms, rank_bounds, node_rank_ms = [], [], [], []
    f_ms, f_call_ms, f_torch_ms, fbounds = [], [], [], []
    bounds = {"off": [], "staged": []}
    for i in range(FULL_BATCHES):
        tags, keys, vals = traffic.mixed(FULL_OPS)
        runs = {}
        for pipe, path in PHASE4_PATHS.items():
            # the default path donates its input: a copy, so that the others
            # and the checks below read the batch's input state
            src = cloned(state) if pipe == "on" else state
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with torch_rank_calls() as torch_ranks:
                ops, perm = core.make_ops(tags, keys, vals)
                new_state, res, stats = core.apply_ops_safe(
                    src, ops, config=cfg.replace(**path)
                )
                value = core.unsort(res["value"], perm)
                torch.cuda.synchronize()
            e2e[pipe].append((time.perf_counter() - t0) * 1e3)
            counts = {k: LAUNCHES[k] for k in launches}
            for k in (STRIPE_KERNEL[pipe], "flix_apply_range", "flix_fence_rows"):
                if counts[k] < 1:
                    raise AssertionError(f"batch {i} ({pipe}): kernel {k} was not launched")
            if counts["flix_apply_rank"] != 1 or torch_ranks:
                raise AssertionError(f"batch {i} ({pipe}): its RANGE ops were ranked by "
                                     f"{counts['flix_apply_rank']} count-kernel launches and "
                                     f"{len(torch_ranks)} torch node_rank calls (want 1, 0)")
            others = [k for p, k in STRIPE_KERNEL.items() if p != pipe and counts[k]]
            if others:
                raise AssertionError(f"batch {i} ({pipe}): {others} was launched")
            for k, c in counts.items():
                launches[k] += c
            assert stats["restructure_retries"] == 0, stats
            assert value.shape == (FULL_OPS,)
            runs[pipe] = (new_state, res, stats)
            del src
        check_same(f"full batch {i}: staged vs single-buffer", runs["staged"], runs["off"])
        check_same(f"full batch {i}: donated vs single-buffer", runs["on"], runs["off"])

        ref, ref_ms = host_ms(
            lambda: core.apply_ops_safe(state, ops, config=cfg.replace(impl="reference"))
        )
        for pipe, run in runs.items():
            check_same(f"full batch {i} ({STRIPE_KERNEL[pipe]})", run, ref)
        del ref
        new_state, res, stats = runs.pop("off")
        del runs

        # the kernels alone, re-launched on this batch's inputs in turns
        # (single, staged, staged, single; not counted)
        args, r = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
        args_nn = state.num_nodes
        single = lambda: fa.flix_apply_pass(*args)  # noqa: E731
        staged = lambda: fa.flix_apply_staged_pass(args_nn, *args)  # noqa: E731
        turns = [("off", single), ("staged", staged), ("staged", staged), ("off", single)]
        times = {"off": [], "staged": []}
        for pipe, fn in turns:
            times[pipe].append(event_ms(fn, 2))
        for pipe in times:
            k_ms[pipe].append(fmean(times[pipe]))
        is_range = ops.tag == core.OP_RANGE
        g, pref, *_ = fa.range_slots(new_state, is_range, ops.key, ops.val, cfg.max_results)
        rargs = (g, pref, new_state.node_count, new_state.keys, new_state.vals)
        gather = lambda: fa.flix_apply_range_pass(*rargs)  # noqa: E731
        r_ms.append(event_ms(gather, 10))
        r_queued_ms.append(queued_ms(gather, 10))
        empty_ms.append(queued_ms(lambda: torch.cuda._sleep(0), 10))  # an empty kernel
        # the RANGE ranks at the fused call site: the count kernel, and the
        # parent's torch node_rank pair over every op, in turns
        meta = (new_state.keys, new_state.node_count, new_state.node_max, new_state.mkba,
                pref, ops.key, ops.val)
        rank = lambda: fr.flix_range_count(*meta, is_range=is_range,  # noqa: E731
                                           kernel="flix_apply_rank")
        torch_rank = lambda: (node_rank(*meta[:5], ops.key),  # noqa: E731
                              node_rank(*meta[:5], ops.val))
        rt = [event_ms(rank, 10), event_ms(torch_rank, 3), event_ms(torch_rank, 3),
              event_ms(rank, 10)]
        rank_ms.append((rt[0] + rt[3]) / 2)
        node_rank_ms.append((rt[1] + rt[2]) / 2)
        rank_queued_ms.append(queued_ms(rank, 10))
        rank_bounds.append(range_count_bytes(new_state, ops.key, ops.val, is_range)
                           / HBM_BYTES_PER_S * 1e3)
        outs = fa.flix_apply_pass(*args)
        moved = {pipe: stripe_pass_bytes(state, ops, r, outs, staged=pipe == "staged")
                 for pipe in bounds}
        for pipe in bounds:
            bounds[pipe].append(moved[pipe] / HBM_BYTES_PER_S * 1e3)
        rbounds.append(gather_bytes(g, pref, npb) / HBM_BYTES_PER_S * 1e3)
        del outs
        # the fence rows of the post-update state (flix_apply.py's SUCCESSOR
        # fallback): the kernel, and the torch pass it replaced, in turns;
        # the kernel queued (its device time: its wrapper's host time is
        # longer) and as a call
        fargs = (new_state.keys, new_state.vals)
        fnn = new_state.num_nodes
        kernel_rows = lambda: fs.fence_rows(*fargs, num_nodes=fnn)  # noqa: E731
        torch_rows = lambda: fs.next_rows(*fargs, num_nodes=fnn)  # noqa: E731
        ft = [queued_ms(kernel_rows, 5), event_ms(torch_rows, 5), event_ms(torch_rows, 5),
              queued_ms(kernel_rows, 5)]
        f_ms.append((ft[0] + ft[3]) / 2)
        f_call_ms.append(event_ms(kernel_rows, 5))
        f_torch_ms.append((ft[1] + ft[2]) / 2)
        fbounds.append(fence_bytes(new_state, num_nodes=True) / HBM_BYTES_PER_S * 1e3)
        log(f"  batch {i}: end to end {e2e['off'][-1]:.3f} ms (pipeline off), "
            f"{e2e['staged'][-1]:.3f} ms (on, not donated), {e2e['on'][-1]:.3f} ms (the "
            f"default: donated), {FULL_OPS / e2e['on'][-1] * 1e3:.6g} ops/s (donated); "
            f"flix_apply {k_ms['off'][-1]:.4f} ms, flix_apply_staged {k_ms['staged'][-1]:.4f} "
            f"ms (bounds {bounds['off'][-1]:.4f} / {bounds['staged'][-1]:.4f} ms, "
            f"{moved['off']} / {moved['staged']} bytes), "
            f"range gather {r_ms[-1]:.4f} ms a call, {r_queued_ms[-1]:.4f} queued (bound "
            f"{rbounds[-1]:.5f} ms; an empty kernel {empty_ms[-1]:.4f} queued); RANGE ranks "
            f"by the count kernel {rank_ms[-1]:.4f} ms a call, {rank_queued_ms[-1]:.4f} "
            f"queued (bound {rank_bounds[-1]:.4f} ms), by the torch node_rank pair "
            f"{node_rank_ms[-1]:.4f} ms; fence rows {f_ms[-1]:.4f} ms queued, "
            f"{f_call_ms[-1]:.4f} ms a call (bound {fbounds[-1]:.4f} ms; the torch pass "
            f"{f_torch_ms[-1]:.4f} ms); "
            f"reference engine {ref_ms:.3f} ms; "
            f"launches {counts}; inserted {int(stats['inserted'])} deleted "
            f"{int(stats['deleted'])} range_truncated {int(stats['range_truncated'])}")
        state = new_state

    _, inv_ms = host_ms(lambda: core.check_invariants(state))
    core.check_range_results(ops, res, max_results=cfg.max_results)
    log(f"  invariants I1-I5 hold on the final state ({inv_ms:.0f} ms); "
        f"live keys {int(state.live_keys())}")
    for pipe in PHASE4_PATHS:
        kernel = (f", median {STRIPE_KERNEL[pipe]} {median(k_ms[pipe]):.4f} ms"
                  if pipe in k_ms else "")
        log(f"  {STRIPE_KERNEL[pipe]}'s path: median end to end {median(e2e[pipe]):.3f} ms"
            + kernel)
    donated = donated_line(state, traffic, cfg.max_results)

    # plain versions at the last batch's shapes: no yardstick of speed, they
    # repeat the kernels' arithmetic (the staged kernel's is the same one)
    want, plain_ms = host_ms(lambda: fa.flix_apply_reference(*args))
    e1 = max_abs_err(want, fa.flix_apply_pass(*args))
    e3 = max_abs_err(want, fa.flix_apply_staged_pass(args_nn, *args))
    del want
    rk = fa.flix_apply_range_pass(*rargs)
    rwant, rplain_ms = host_ms(lambda: fr.flix_range_gather_reference(*rargs))
    e2 = max_abs_err(rwant, rk)
    rank_want, rank_plain_ms = host_ms(
        lambda: fr.flix_range_count_reference(*meta, is_range=is_range))
    e5 = max_abs_err(rank_want, rank())
    fwant, fplain_ms = host_ms(torch_rows)
    e4 = max_abs_err(fwant, kernel_rows())
    log(f"  plain versions at main-path shapes: flix_apply {plain_ms:.3f} ms "
        f"(max_abs_err {e1}; flix_apply_staged's {e3}), range gather {rplain_ms:.3f} ms "
        f"(max_abs_err {e2}), RANGE ranks {rank_plain_ms:.3f} ms (max_abs_err {e5}), "
        f"fence rows {fplain_ms:.3f} ms (max_abs_err {e4})")
    log(f"  range gather: mean {fmean(r_ms):.4f} ms a call, {fmean(r_queued_ms):.4f} queued, "
        f"against its {fmean(rbounds):.5f} ms bound and an empty kernel's "
        f"{fmean(empty_ms):.4f} ms queued; RANGE ranks: the count kernel mean "
        f"{fmean(rank_ms):.4f} ms a call, {fmean(rank_queued_ms):.4f} queued, against its "
        f"{fmean(rank_bounds):.4f} ms bound; the torch node_rank pair it replaced "
        f"{fmean(node_rank_ms):.4f} ms")
    log(f"  fence rows: mean {fmean(f_ms):.4f} ms queued ({fmean(f_call_ms):.4f} ms a call) "
        f"against their {fmean(fbounds):.4f} ms bound; the torch pass they replace "
        f"{fmean(f_torch_ms):.4f} ms")
    if e1 or e2 or e3 or e4 or e5:
        raise AssertionError("a kernel disagrees with its plain version at main-path shapes")
    check_merge_underfull(state)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {
        "flix_apply": dict(launches=launches["flix_apply"], ms=fmean(k_ms["off"]),
                           plain_ms=plain_ms, bound_ms=fmean(bounds["off"]), err=e1),
        "flix_apply_staged": dict(launches=launches["flix_apply_staged"],
                                  ms=fmean(k_ms["staged"]), plain_ms=plain_ms,
                                  bound_ms=fmean(bounds["staged"]), err=e3),
        # launched by the main path's default batches; timed at the larger
        # batch of the donated lines (DONATED_OPS[-1] ops)
        "flix_apply_staged_inplace": dict(launches=launches["flix_apply_staged_inplace"],
                                          ms=donated[-1]["ms"],
                                          plain_ms=donated[-1]["plain_ms"],
                                          bound_ms=donated[-1]["bound_ms"],
                                          err=max(r["err"] for r in donated)),
        # ms: these kernels' device time (queued), since their wrappers' host
        # time is longer; call_ms: their time as a call
        "flix_apply_range": dict(launches=launches["flix_apply_range"], ms=fmean(r_queued_ms),
                                 call_ms=fmean(r_ms), plain_ms=rplain_ms,
                                 bound_ms=fmean(rbounds), err=e2),
        "flix_apply_rank": dict(launches=launches["flix_apply_rank"],
                                ms=fmean(rank_queued_ms), call_ms=fmean(rank_ms),
                                plain_ms=rank_plain_ms, bound_ms=fmean(rank_bounds), err=e5),
        "flix_fence_rows": dict(launches=launches["flix_fence_rows"], ms=fmean(f_ms),
                                call_ms=fmean(f_call_ms), plain_ms=fplain_ms,
                                bound_ms=fmean(fbounds), err=e4),
    }


DONATED_OPS = (1 << 14, 1 << 20)  # the benchmark's two YCSB-A batch sizes
DONATED_REPS = 6  # timed calls of each pass, in turns


def donated_line(state, traffic, max_results):
    """Phase 4's donated pass on its final state (32-key nodes, 16 a
    bucket, as the benchmark's flix-u26), one mixed batch of each of
    DONATED_OPS ops: held to the functional staged pass, the single-buffer
    witness and its plain version (:func:`check_donated`), then timed
    queued (device time) in turns with the functional staged pass, the
    planes of a copy restored before each donated call, beside its bound:
    the bytes ``flixbench/roofline.py``'s ``apply_bytes`` counts (the
    touched buckets' live rows read, the updated buckets' rows and metadata
    written, the ops and answers) at 3.35 TB/s.  Returns one dict a batch
    size."""
    import types

    from flixbench.roofline import apply_bytes
    from repro_torch import core
    from repro_torch.core.query import _bucket_index
    from repro_torch.kernels import flix_apply as fa

    nb, npb, ns = state.geometry
    rows = []
    for n in DONATED_OPS:
        ops, _ = core.make_ops(*traffic.mixed(n), device=state.device)
        args, _ = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
        staged = fa.flix_apply_staged_pass(state.num_nodes, *args)
        err = max_abs_err(staged, fa.flix_apply_pass(*args))
        e, plain_ms = check_donated(state, ops, args, staged, f"donated pass, {n} ops")
        err = max(err, e)
        copy = cloned(state)
        mine = (copy.keys, copy.vals, copy.node_count, copy.node_max)
        pristine = (state.keys, state.vals, state.node_count, state.node_max)
        cargs = (ops.val, _bucket_index(state, ops.key), copy.keys, copy.vals, copy.node_max,
                 *args[3:])
        out = {}

        def donated():
            out["d"] = fa.flix_apply_inplace_pass(copy.num_nodes, copy.node_count,
                                                  copy.needs_restructure, *cargs)

        def functional():
            out["f"] = fa.flix_apply_staged_pass(state.num_nodes, *args)

        times = {"donated": [], "staged": []}
        for i in range(DONATED_REPS):
            for name in (("donated", "staged") if i % 2 == 0 else ("staged", "donated")):
                if name == "donated":
                    for dst, src in zip(mine, pristine):  # the batch's input again
                        dst.copy_(src)
                times[name].append(queued_ms(donated if name == "donated" else functional, 1))
        counts = out["d"][3].tolist()
        batch = types.SimpleNamespace(tags=ops.tag, keys=ops.key, vals=ops.val)
        moved = apply_bytes(batch, state.mkba, state.num_nodes, staged[4], npb, ns,
                            max_results)
        bound = moved / HBM_BYTES_PER_S * 1e3
        row = dict(ops=n, ms=median(times["donated"]), staged_ms=median(times["staged"]),
                   bound_ms=bound, bytes=moved, err=err, plain_ms=plain_ms)
        log(f"  donated pass, {n} ops: {row['ms']:.4f} ms queued (median of "
            f"{DONATED_REPS}: {', '.join(f'{t:.4f}' for t in times['donated'])}) against its "
            f"{bound:.4f} ms bound ({moved} bytes, {row['ms'] / bound:.2f}x); the functional "
            f"staged pass {row['staged_ms']:.4f} ms on the same batch; {counts[3]} of {nb} "
            f"buckets merged ({counts[4]} checked), inserted {counts[0]} deleted {counts[1]} "
            f"overflowed {counts[2]}; max_abs_err {err} (single-buffer witness, plain version "
            f"{plain_ms:.1f} ms)")
        rows.append(row)
        del staged, copy, out, mine, cargs
    return rows


def check_merge_underfull(state) -> None:
    """``core.merge_underfull`` once on phase 4's final state: I1-I5 hold
    after it, and every bucket keeps its live pairs."""
    from repro_torch import core
    from repro_torch.core.state import flatten_bucket_sorted

    merged, ms = host_ms(lambda: core.merge_underfull(state))
    core.check_invariants(merged)
    bk, bv = flatten_bucket_sorted(state)
    mk, mv = flatten_bucket_sorted(merged)
    live = bk != core.EMPTY
    if not (torch.equal(bk, mk) and torch.equal(bv[live], mv[live])):
        raise AssertionError("merge_underfull changed a bucket's live pairs")
    log(f"  merge_underfull: {ms:.3f} ms on {int(state.live_keys())} keys; nodes "
        f"{int(state.total_nodes())} -> {int(merged.total_nodes())}; I1-I5 hold, every "
        f"bucket's live pairs kept")


def phase_autotune(dev):
    """The autotuner's measured sweep at phase 4's sizes
    (``kernels/autotune.py``): its synthetic 2^24-key build at 32-key nodes,
    16 a bucket, and a 2^20-op half-POINT, half-INSERT batch on the card;
    each feasible warps-a-block count timed through ``apply_ops(impl=
    "fused", pipeline="on", block_b=W)``.  Printed: the model's pick, the
    measured pick, every candidate's model cost and time.  Returns the
    launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import autotune as at

    geo = dict(node_size=32, nodes_per_bucket=16)
    log(f"phase 4b: autotune([{FULL_KEYS}], [{FULL_OPS}], measure=True) at 32-key nodes, "
        f"16 a bucket")
    model_table, model_rec = at.autotune([FULL_KEYS], [FULL_OPS], **geo)
    torch.cuda.synchronize()
    reset_launches()
    table, rec = at.autotune([FULL_KEYS], [FULL_OPS], measure=True, device=dev, **geo)
    torch.cuda.synchronize()
    launches = {"flix_apply_staged": LAUNCHES["flix_apply_staged"],
                "flix_fence_rows": LAUNCHES["flix_fence_rows"]}
    (sweep,) = rec["sweeps"]
    feas = [c for c in sweep["candidates"] if c["feasible"]]
    if launches["flix_apply_staged"] != 4 * len(feas) or LAUNCHES["flix_apply"]:
        raise AssertionError(f"phase 4b: launches {dict(LAUNCHES)}, expected 4 staged "
                             f"launches for each of {len(feas)} candidates")
    for c in sweep["candidates"]:
        model = next(m for m in model_rec["sweeps"][0]["candidates"]
                     if m["block_b"] == c["block_b"])
        timed = f"{c['wall_s'] * 1e3:.4f} ms" if "wall_s" in c else "not timed"
        log(f"  block_b={c['block_b']}: {c['vmem_bytes']} B of shared memory a block, "
            f"{c['resident_warps']} warps an SM, model cost {model['model_cost']} ns, "
            f"apply_ops {timed} (CUDA events, median of 3)")
    times = sorted(c["wall_s"] for c in feas)
    log(f"  model pick block_b={model_table.entries[0][3]}, measured pick "
        f"block_b={table.entries[0][3]}; spread across W {times[-1] / times[0]:.4f}x; "
        f"launches {launches}")
    return launches


def stripe_pass_bytes(state, ops, r, outs, *, staged: bool) -> int:
    """Bytes a stripe pass must move: the rows that hold keys read, the
    batch's inserts (key and val), deletes, slice bounds and op columns
    read, every output written once.  Of the node metadata, the
    single-buffer kernel (``staged=False``) is charged the whole
    ``node_max`` plane: its inputs mark the active rows only there.  The
    staged kernel is given ``num_nodes``, so it is charged that and the live
    ``node_max`` entries (the merge's regions), as :func:`update_bytes`
    charges the insert kernel."""
    n_ins, n_del = int(r.is_ins.sum()), int(r.is_del.sum())
    meta = (4 * state.num_buckets + 4 * live_nodes(state)) if staged else state.node_max.nbytes
    return (active_row_bytes(state) + meta + 8 * n_ins + 4 * n_del
            + 6 * 4 * state.num_buckets + ops.tag.nbytes + ops.key.nbytes
            + sum(o.nbytes for o in outs))


def live_nodes(state) -> int:
    """Nodes that hold keys (``node_max`` not EMPTY)."""
    from repro_torch.core.state import EMPTY

    return int((state.node_max != EMPTY).sum())


def active_row_bytes(state) -> int:
    """Bytes of the node rows (keys and vals) that hold keys: all that a
    pass over the stripes must read of them, since ``node_max`` marks the
    rest as empty.  The pass still writes every stripe whole."""
    return 8 * state.node_size * live_nodes(state)


def update_bytes(state, extra_bytes: int, reads_node_max: bool) -> int:
    """Bytes an insert or delete pass must move besides its batch
    (``extra_bytes``): num_nodes, the fences and the rows that hold keys
    read, and for an insert (``reads_node_max``) their node_max entries,
    which give the merge its regions (a delete needs none); stripes written
    whole, node_count / node_max rows and num_nodes written."""
    nb, live = state.num_buckets, live_nodes(state)
    reads = 8 * state.node_size * live + (4 * live if reads_node_max else 0) + 8 * nb
    writes = state.keys.nbytes + state.vals.nbytes + 2 * state.node_max.nbytes + 4 * nb
    return reads + writes + extra_bytes


def sorted_i32(*parts):
    return torch.sort(torch.cat([p.to(torch.int32) for p in parts]), stable=True).values


def kernel_ops_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """The four single-class kernels against their plain versions on one
    state: a delete batch that empties buckets and repeats keys, queries on
    the emptied state, and an insert batch that floods one bucket."""
    from repro_torch import core
    from repro_torch.kernels import flix_delete as fd
    from repro_torch.kernels import flix_insert as fi
    from repro_torch.kernels import flix_query as fq
    from repro_torch.kernels import flix_successor as fs
    from repro_torch.kernels import ops as kops

    label = f"{n_keys} keys, ns={ns} npb={npb}"
    space = 1 << 28  # sparse, so one bucket's key range can take a flood

    def rand(n, hi=space):
        return torch.randint(0, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    keys = torch.unique(rand(n_keys))
    state = core.build(keys, rand(keys.numel(), 1 << 30), node_size=ns, nodes_per_bucket=npb)
    cap = npb * ns
    edge = torch.tensor([0, core.MAX_VALID], dtype=torch.int32, device=dev)

    # deletes: a run of live keys that empties whole buckets, live keys three
    # times over, absent keys, the edges
    raw = sorted_i32(keys[1000:1400], keys[5000:5100].repeat(3), rand(2000), edge)
    planes = (state.keys, state.vals, state.node_max, state.mkba)
    present = fq.flix_point_query_reference(*planes, raw) != core.NOT_FOUND
    dk = torch.sort(torch.where(present, raw, core.EMPTY), stable=True).values
    args = (state.num_nodes, state.keys, state.vals, state.mkba, dk)
    check.hold("flix_delete", fd.flix_delete_reference(*args), fd.flix_delete_pass(*args), label)
    state = kops.flix_delete(state, raw)
    emptied = int((state.num_nodes == 0).sum())
    assert emptied > 0, label

    # queries on the emptied state: hits and misses, the run around the
    # emptied buckets, and the boundary keys
    top = torch.tensor([0, 1, core.MAX_VALID - 1, core.MAX_VALID, core.EMPTY - 1, core.EMPTY],
                       dtype=torch.int32, device=dev)
    q = sorted_i32(keys[rand(20000, keys.numel()).long()], rand(20000), keys[990:1410:3], top)
    planes = (state.keys, state.vals, state.node_max, state.mkba, q)
    check.hold("flix_point_query", [fq.flix_point_query_reference(*planes)],
               [fq.flix_point_query(*planes)], label)
    check.hold("flix_successor", fs.flix_successor_reference(*planes),
               fs.flix_successor(*planes), label)

    # inserts: fresh keys, the edges, and cap + 40 keys into one bucket's range
    b = state.num_buckets // 2
    lo, hi = int(state.mkba[b - 1]) + 1, int(state.mkba[b])
    flood = lo + torch.randperm(hi - lo + 1, generator=gen, device=dev)[: cap + 40]
    ik = torch.unique(torch.cat([rand(20000), flood.to(torch.int32), edge]))
    iv = rand(ik.numel(), 1 << 30)
    args = (state.num_nodes, state.keys, state.vals, state.node_max, state.mkba, ik, iv)
    got = fi.flix_insert_pass(*args)
    check.hold("flix_insert", fi.flix_insert_reference(*args), got, label)
    assert int(got[5][b]) == 2, (label, int(got[5][b]))  # pieces and the cut at cap
    log(f"  {label}: delete, point, successor and insert kernels equal their plain "
        f"versions; {emptied} emptied buckets, {int((got[5] > 0).sum())} overflowed")


def query_edge_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """flix_point_query against its plain version and core.point_query on
    its edges: runs of several fence groups, buckets emptied by deletes,
    every fence and the key above it, a slice of 100 repeats of one key, a
    whole bucket's keys three times over, keys 0, MAX_VALID and EMPTY, a
    NOT_FOUND value, and batches of 1 and 77 queries."""
    from repro_torch import core
    from repro_torch.kernels import flix_query as fq

    label = f"query edges, {n_keys} keys, ns={ns} npb={npb}"
    keys = torch.unique(torch.randint(1, 1 << 28, (n_keys,), generator=gen, device=dev,
                                      dtype=torch.int32))
    keys[-1] = core.MAX_VALID
    vals = keys ^ 0x33
    vals[::97] = core.NOT_FOUND
    state = core.build(torch.cat([keys, keys.new_zeros(1)]), torch.cat([vals, vals[:1]]),
                       node_size=ns, nodes_per_bucket=npb)
    state = core.delete(state, keys[5000:9000])[0]
    nb = state.num_buckets
    emptied = int((state.num_nodes == 0).sum())
    assert emptied > 0, label
    b = nb // 3
    lo = int(state.mkba[b - 1]) + 1
    mine = keys[(keys >= lo) & (keys <= int(state.mkba[b]))]
    pick = torch.randint(0, keys.numel(), (20000,), generator=gen, device=dev)
    top = torch.tensor([0, 1, core.MAX_VALID, core.EMPTY], dtype=torch.int32, device=dev)
    q = sorted_i32(state.mkba, state.mkba + 1, keys[pick], keys[pick] + 1,
                   keys[3000:3001].repeat(100), mine.repeat(3), keys[4990:9010], top)
    planes = (state.keys, state.vals, state.node_max, state.mkba)
    for qq in (q, q[:1], q[q.numel() // 2 : q.numel() // 2 + 77]):
        got = fq.flix_point_query(*planes, qq)
        check.hold("flix_point_query", [fq.flix_point_query_reference(*planes, qq)], [got],
                   label)
        check.hold("flix_point_query", [core.point_query(state, qq)], [got], f"{label} vs core")
    log(f"  {label}: {nb} buckets ({emptied} emptied), {q.numel()} queries and batches of "
        f"1 and 77: flix_point_query equals its plain version and core.point_query")


def successor_edge_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """flix_successor (the fence-row kernel, then the successor kernel)
    against its plain version and core.successor_query on its edges: a run
    of emptied buckets longer than two warps' runs, an emptied tail, every
    third bucket's largest key deleted (so that queries one above its new
    largest key and at its fence fall to the fence rows), every seventh
    bucket's head stored with NOT_FOUND, every fence and the key above it,
    100 repeats of one key, a bucket's keys three times over, keys 0,
    MAX_VALID and EMPTY, and batches of 1 and 77 queries."""
    from repro_torch import core
    from repro_torch.kernels import flix_successor as fs

    label = f"successor edges, {n_keys} keys, ns={ns} npb={npb}"
    keys = torch.unique(torch.randint(1, 1 << 28, (n_keys,), generator=gen, device=dev,
                                      dtype=torch.int32))
    keys[-1] = core.MAX_VALID
    vals = keys ^ 0x33
    vals[::97] = core.NOT_FOUND
    state = core.build(torch.cat([keys, keys.new_zeros(1)]), torch.cat([vals, vals[:1]]),
                       node_size=ns, nodes_per_bucket=npb)
    nb = state.num_buckets
    tail = state.keys[nb - 40:]
    state = core.delete(state, sorted_i32(keys[5000:9000], tail[tail != core.EMPTY]))[0]
    heads = state.keys[::7, 0, 0]
    heads = torch.sort(heads[heads != core.EMPTY]).values
    state = core.insert(state, heads, torch.full_like(heads, core.NOT_FOUND))[0]
    b3 = torch.arange(0, nb - 40, 3, device=dev)
    b3 = b3[state.node_count[b3].sum(1) > 1]
    top = state.node_max[b3, state.num_nodes[b3].long() - 1]
    state = core.delete(state, torch.sort(top).values)[0]
    core.check_invariants(state)
    empty = (state.num_nodes == 0).int()
    # the longest run of emptied buckets: positions since the last non-empty one
    idx = torch.arange(nb, device=dev)
    since = idx - torch.cummax(torch.where(empty == 0, idx, -1), 0).values
    assert int(since.max()) > 2 * 64 and bool((state.num_nodes[nb - 40:] == 0).all()), label
    top = state.node_max[b3, state.num_nodes[b3].long() - 1]
    past = torch.cat([top + 1, state.mkba[b3]])
    b = nb // 3
    mine = keys[(keys > int(state.mkba[b - 1])) & (keys <= int(state.mkba[b]))]
    pick = torch.randint(0, keys.numel(), (20000,), generator=gen, device=dev)
    edge = torch.tensor([0, 1, core.MAX_VALID, core.EMPTY], dtype=torch.int32, device=dev)
    q = sorted_i32(state.mkba, state.mkba + 1, keys[pick], keys[pick] + 1,
                   keys[3000:3001].repeat(100), mine.repeat(3), keys[4990:9010], past,
                   tail[tail != core.EMPTY], edge)
    planes = (state.keys, state.vals, state.node_max, state.mkba)
    check.hold("flix_fence_rows", fs.next_rows(*planes[:3]), fs.fence_rows(*planes[:3]), label)
    for qq in (q, q[:1], q[q.numel() // 2 : q.numel() // 2 + 77]):
        got = fs.flix_successor(*planes, qq)
        check.hold("flix_successor", fs.flix_successor_reference(*planes, qq), got, label)
        check.hold("flix_successor", core.successor_query(state, qq), got, f"{label} vs core")
        if qq is q:
            nf = int(((got[0] != core.EMPTY) & (got[1] == core.NOT_FOUND)).sum())
            none = int((got[0] == core.EMPTY).sum())
            assert nf > 0 and none > 0, label
    log(f"  {label}: {nb} buckets ({int(empty.sum())} emptied, the longest run "
        f"{int(since.max())}), {q.numel()} queries ({nf} answered by a key stored with "
        f"NOT_FOUND, {none} with no successor) and batches of 1 and 77: flix_successor "
        f"equals its plain version and core.successor_query")


def update_edge_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """flix_insert and flix_delete against their plain versions on their
    edges, on a state with more buckets than the card holds warps (so every
    warp's ring turns over): a flood of cap + 40 keys into one bucket
    (overflow 2), slices longer than the rings stage (32), buckets emptied
    by deletes and inserts into them, every key of two buckets deleted, a
    full bucket that one insert overflows, inserts above buckets' last node
    max, keys 0 and MAX_VALID upserted and deleted, a full bucket's keys
    repeated past cap in the delete batch, NOT_FOUND as a stored and an
    upserted value, and batches of 0 and 1."""
    from repro_torch import core
    from repro_torch.kernels import flix_delete as fd
    from repro_torch.kernels import flix_insert as fi
    from repro_torch.kernels import flix_query as fq

    label = f"update edges, {n_keys} keys, ns={ns} npb={npb}"
    S = ns * npb
    keys = torch.unique(torch.randint(1, 1 << 28, (n_keys,), generator=gen, device=dev,
                                      dtype=torch.int32))
    keys[-1] = core.MAX_VALID
    keys = torch.cat([keys.new_zeros(1), keys])
    vals = keys ^ 0x33
    vals[1::97] = core.NOT_FOUND
    state = core.build(keys, vals, node_size=ns, nodes_per_bucket=npb)
    state = core.delete(state, keys[5000:9000])[0]
    nb = state.num_buckets
    nn = state.num_nodes.cpu()

    def fresh(st, b, n):  # n keys of bucket b's range that it does not hold
        lo, hi = int(st.mkba[b - 1]) + 1, int(st.mkba[b])
        cand = lo + torch.randperm(hi - lo + 1, generator=gen, device=dev)[: n + S]
        cand = cand[~torch.isin(cand, st.keys[b].flatten())][:n].to(torch.int32)
        assert cand.numel() == n, (label, b, n)
        return cand

    b_flood, b_long, b_full, b_all = nb // 2, nb // 2 + 7, nb // 4, nb // 5
    gone = torch.nonzero(state.num_nodes == 0)[:, 0]
    gone = gone[(gone > 0) & (gone < nb - 1)][:3].tolist()
    assert len(gone) == 3 and int(nn[b_full]) == 1, label
    assert all(nn[b] > 0 for b in (b_flood, b_long, b_all, b_all + 1)), label
    # a full bucket: one node at build, then every slot through core.insert
    fill = fresh(state, b_full, S - int(state.node_count[b_full].sum()))
    state = core.insert(state, torch.sort(fill).values, torch.sort(fill).values)[0]
    # buckets whose top key is deleted, so that their fence lies above the max
    tops = torch.arange(nb // 8, nb // 8 + 400, 4, device=dev)
    tops = tops[(state.node_count[tops].sum(1) > 1)
                & ~torch.isin(tops, torch.tensor([b_flood, b_long, b_full, b_all, b_all + 1],
                                                 device=dev))]
    old = state.node_max[tops, state.num_nodes[tops].long() - 1]
    state = core.delete(state, torch.sort(old).values)[0]
    core.check_invariants(state)
    assert int(state.num_nodes[b_full]) == npb and int(state.node_count[b_full].sum()) == S

    live = state.keys[state.keys != core.EMPTY]
    lv = state.vals[state.keys != core.EMPTY]
    pick = live[torch.randint(0, live.numel(), (100,), generator=gen, device=dev)]
    rand = torch.randint(1, 1 << 28, (20000,), generator=gen, device=dev, dtype=torch.int32)
    ins = [(torch.tensor([0, core.MAX_VALID], dtype=torch.int32, device=dev),
            torch.tensor([11, 12], dtype=torch.int32, device=dev)),
           (pick, torch.full_like(pick, core.NOT_FOUND)),  # upserts to NOT_FOUND
           (fresh(state, b_flood, S + 40), None), (fresh(state, b_long, 40), None),
           (fresh(state, b_full, 1), None), (old, None), (rand, None)]
    ins += [(fresh(state, b, min(ns + 3, S)), None) for b in gone]
    ik = torch.cat([k for k, _ in ins])
    iv = torch.cat([v if v is not None else k * 3 + 1 for k, v in ins])
    ik, order = torch.sort(ik, stable=True)
    iv = iv[order]
    first = torch.cat([ik.new_ones(1, dtype=torch.bool), ik[1:] != ik[:-1]])
    ik, iv = ik[first].contiguous(), iv[first].contiguous()  # the first of each key wins

    full = state.keys[b_full].flatten()
    every = torch.cat([state.keys[b].flatten() for b in (b_all, b_all + 1)])
    raw = sorted_i32(full.repeat(2 + 33 // S), every[every != core.EMPTY],
                     torch.tensor([0, core.MAX_VALID], dtype=torch.int32, device=dev),
                     live[lv == core.NOT_FOUND][:50], keys[5000:5100],  # absent now
                     live[torch.randint(0, live.numel(), (20000,), generator=gen, device=dev)],
                     rand[:2000])
    planes = (state.keys, state.vals, state.node_max, state.mkba)
    present = fq.flix_point_query_reference(*planes, raw) != core.NOT_FOUND
    dk = torch.sort(torch.where(present, raw, core.EMPTY), stable=True).values

    per_bucket = torch.bincount(torch.searchsorted(state.mkba, dk), minlength=nb + 1)
    assert int(per_bucket[b_full]) > max(S, 32) and bool(present[raw == 0].all()), label
    for n in (ik.numel(), 0, 1):
        args = (state.num_nodes, state.keys, state.vals, state.node_max, state.mkba, ik[:n],
                iv[:n])
        got = fi.flix_insert_pass(*args)
        check.hold("flix_insert", fi.flix_insert_reference(*args), got, f"{label}, {n} inserts")
        if n > 1:
            flow = got[5].cpu()
            assert (int(flow[b_flood]), int(flow[b_full])) == (2, 1), (label, flow[b_flood])
            assert all(int(got[4][b]) > 0 for b in gone), label
    for n in (dk.numel(), 0, 1):
        args = (state.num_nodes, state.keys, state.vals, state.mkba, dk[:n])
        got = fd.flix_delete_pass(*args)
        check.hold("flix_delete", fd.flix_delete_reference(*args), got, f"{label}, {n} deletes")
        if n > 1:
            assert int(got[4][b_all]) == 0 and 0 < int(got[2][b_full].sum()) < S, label
            nf = live[lv == core.NOT_FOUND][:50]
            assert bool(torch.isin(nf, got[0]).all()), label  # never deleted
    log(f"  {label}: {nb} buckets, {ik.numel()} inserts and {dk.numel()} deletes (and "
        f"batches of 0 and 1): flix_insert and flix_delete equal their plain versions")


def apply_walk_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """The single-buffer stripe kernel (csrc/flix_apply.cu) against its
    plain version and the staged kernel on the edges of
    its persistent walk (a block takes buckets b, b + grid, ... through a
    ring of stages): a state of ``n_keys`` keys with many more buckets than
    the grid holds blocks, whose buckets of every other lap of the walk are
    emptied (an emptied bucket right after a full one in a block's walk),
    some of whose first-lap buckets are filled to every slot, and whose vals
    at every EMPTY slot are not 0; a mixed batch that inserts into emptied
    and full buckets; then states of 1, grid - 1 and grid + 1 buckets."""
    from repro_torch import core
    from repro_torch.core.state import FliXState
    from repro_torch.kernels import flix_apply as fa

    grid = fa.flix_apply_grid(npb, ns, dev)
    S, p = ns * npb, max(1, int(ns * 0.5))
    label = f"apply walk, {n_keys} keys, ns={ns} npb={npb}, grid {grid}"
    keys = torch.unique(torch.randint(1, 1 << 28, (n_keys,), generator=gen, device=dev,
                                      dtype=torch.int32))

    def rand(n, lo=0, hi=1 << 28):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    def batch(st, n):  # n ops: 20% inserts, 20% deletes of live keys, reads, 1% ranges
        live = st.keys[st.keys != core.EMPTY]
        k = torch.cat([rand(n // 5), live[torch.randint(0, live.numel(), (n // 5,),
                                                        generator=gen, device=dev)],
                       rand(n - 2 * (n // 5))])
        t = torch.full_like(k, core.OP_POINT)
        t[: n // 5], t[n // 5: 2 * (n // 5)] = core.OP_INSERT, core.OP_DELETE
        t[-(n // 10):] = core.OP_SUCCESSOR
        t[-(n // 100) - 1:] = core.OP_RANGE
        return t, k, torch.where(t == core.OP_RANGE, k + 64, k ^ 0x77)

    def hold(st, tags, bk, bv, what):
        sk, order = torch.sort(bk, stable=True)  # one op a key: the first
        first = order[torch.cat([sk.new_ones(1, dtype=torch.bool), sk[1:] != sk[:-1]])]
        ops, _ = core.make_ops(tags[first], bk[first], bv[first])
        return check.run(st, ops, 8192, what)[1]  # equal to the plain version

    state = core.build(keys, keys ^ 0x5A5A, node_size=ns, nodes_per_bucket=npb)
    nb = state.num_buckets
    lap = (torch.arange(nb, device=dev) // grid) % 2 == 1
    gone_keys = state.keys[lap]
    state = core.delete(state, torch.sort(gone_keys[gone_keys != core.EMPTY]).values)[0]
    full = torch.arange(7, min(grid, nb - 1), 7, device=dev)
    full = full[state.mkba[full] - state.mkba[full - 1] >= 2 * S][:64]  # room for S keys
    fill = []
    for b in full.tolist():  # every slot of the bucket, in its key range
        lo, hi = int(state.mkba[b - 1]) + 1, int(state.mkba[b])
        cand = lo + torch.randperm(hi - lo + 1, generator=gen, device=dev)[: 2 * S]
        cand = cand[~torch.isin(cand, state.keys[b].flatten())]
        fill.append(cand[: S - int(state.node_count[b].sum())].to(torch.int32))
    fill = torch.sort(torch.cat(fill)).values
    state = core.insert(state, fill, fill)[0]
    junk = rand(state.vals.numel(), 1, 1 << 30).view(state.vals.shape)
    state = FliXState(state.keys, torch.where(state.keys == core.EMPTY, junk, state.vals),
                      state.node_count, state.node_max, state.num_nodes, state.mkba,
                      state.needs_restructure)
    core.check_invariants(state)
    assert bool((state.num_nodes[full] == npb).all()) and bool((state.num_nodes[lap] == 0).all())

    emptied = torch.nonzero(lap)[:, 0][:: max(1, int(lap.sum()) // 200)][:200]
    lo = state.mkba[emptied - 1] + 1
    span = (state.mkba[emptied] - lo + 1).clamp(max=1 << 20)
    into_gone = lo + (torch.rand(emptied.numel(), generator=gen, device=dev) * span).int()
    over = state.mkba[full[::2]]  # one insert into each of half the full buckets
    over = over - torch.isin(over, state.keys).int()
    tags, bk, bv = batch(state, 1 << 16)
    extra = torch.cat([into_gone, over])
    tags = torch.cat([tags, torch.full_like(extra, core.OP_INSERT)])
    bk, bv = torch.cat([bk, extra]), torch.cat([bv, extra])
    want = hold(state, tags, bk, bv, label)
    assert int(want[5].sum()) > 0 and int((want[4][emptied] > 0).sum()) > 0, label
    for nb2 in (1, grid - 1, grid + 1):
        st = core.build(keys[: nb2 * p], keys[: nb2 * p], node_size=ns, nodes_per_bucket=npb)
        assert st.num_buckets == nb2, (label, nb2)
        hold(st, *batch(st, 4 * nb2 + 100), f"{label}, {nb2} buckets")
    log(f"  {label}: {nb} buckets ({int(lap.sum())} emptied, {full.numel()} full, junk vals "
        f"at EMPTY slots), then 1, grid - 1 and grid + 1 buckets: flix_apply equals its "
        f"plain version and the staged kernel")


def phase_walk(dev, check: KernelCheck):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    log("phase 3g: flix_apply's persistent walk, at 2^20 keys")
    # the last two: rows and stripes that no bulk copy may move
    for ns, npb in ((32, 16), (8, 8), (32, 64), (4, 2), (6, 4), (3, 3)):
        apply_walk_case(dev, check, gen, ns, npb, 1 << 20)


class StagedWarps:
    """Inside the block: the ``block_b`` of every call of
    ``flix_apply.flix_apply_staged_pass`` (the engine looks it up on the
    module), appended to ``seen``."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from repro_torch.kernels import flix_apply as fa

        self._orig = fa.flix_apply_staged_pass

        def spy(num_nodes, *args, block_b=0):
            self.seen.append(block_b)
            return self._orig(num_nodes, *args, block_b=block_b)

        fa.flix_apply_staged_pass = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flix_apply as fa

        fa.flix_apply_staged_pass = self._orig


def warps_case(dev, gen, ns, npb, n_keys):
    """The staged kernel at every warps-a-block count W of the autotuner's
    candidates on one geometry: each W whose block fits gives the W = 0
    launch's outputs byte for byte (and they equal the plain version); its
    blocks an SM (the occupancy API, ``flix_apply_staged_blocks_per_sm``)
    times W equal the model's resident warps; the model's mirror of the
    block's shared memory equals the library's; a W that does not fit
    raises ``ValueError`` naming the geometry and W.  Then ``ExecConfig(
    block_b=W)`` and a tuned tile table through ``apply_ops`` reach the
    launch and give the default config's batch."""
    from repro_torch import core
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import flix_apply as fa
    from repro_torch.kernels._build import load_library

    geo = dict(node_size=ns, nodes_per_bucket=npb)
    label = f"warps a block, {n_keys} keys, ns={ns} npb={npb}"
    traffic = Traffic(n_keys * 8, n_keys, gen)
    state = core.build(*traffic.initial(), **geo)
    ops, _ = core.make_ops(*traffic.mixed(1 << 16))
    args, _ = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
    want = fa.flix_apply_staged_pass(state.num_nodes, *args)
    if max_abs_err(fa.flix_apply_reference(*args), want):
        raise AssertionError(f"{label}: the W = 0 launch disagrees with its plain version")
    lib = load_library()
    rows = []
    for w in (0,) + at.CANDIDATE_BLOCK_B:
        mirror = at.smem_bytes(128, w, **geo)
        if lib.flix_apply_staged_smem_bytes(npb, ns, w) != mirror:
            raise AssertionError(f"{label}: W={w}: the model's {mirror} shared-memory bytes "
                                 f"!= the library's {lib.flix_apply_staged_smem_bytes(npb, ns, w)}")
        if mirror > at.SMEM_BUDGET_BYTES:
            try:
                fa.flix_apply_staged_pass(state.num_nodes, *args, block_b=w)
            except ValueError as e:
                if f"npb={npb}, ns={ns}" not in str(e) or f"{w} warps" not in str(e):
                    raise AssertionError(f"{label}: W={w} refused without naming it: {e}")
                rows.append(f"W={w} {mirror} B refused")
                continue
            raise AssertionError(f"{label}: W={w} ({mirror} B) was launched")
        got = fa.flix_apply_staged_pass(state.num_nodes, *args, block_b=w)
        if max_abs_err(want, got):
            raise AssertionError(f"{label}: W={w} disagrees with the W = 0 launch")
        api = fa.staged_blocks_per_sm(npb, ns, w, dev) * at.block_warps(w, **geo)
        model = at.blocks_per_sm(w, **geo) * at.block_warps(w, **geo)
        if api != model:
            raise AssertionError(f"{label}: W={w}: {api} resident warps an SM by the "
                                 f"occupancy API, {model} by the model")
        rows.append(f"W={w} {mirror} B, {api} warps an SM")
    cfg = core.ExecConfig(impl="fused", pipeline="on", max_results=8192)
    base = core.apply_ops(state, ops, config=cfg)
    build_size = state.num_buckets * state.bucket_capacity
    table, _ = at.autotune([build_size], [ops.size], **geo)
    pick = table.entries[0][3]
    with StagedWarps() as spy:
        for w in at.CANDIDATE_BLOCK_B:
            if at.blocks_per_sm(w, **geo):
                check_same(f"{label}: apply_ops at block_b={w}", core.apply_ops(
                    state, ops, config=cfg.replace(block_b=w)), base)
        check_same(f"{label}: apply_ops with a tile table", core.apply_ops(
            state, ops, config=cfg.replace(tile_table=table)), base)
    fits = [w for w in at.CANDIDATE_BLOCK_B if at.blocks_per_sm(w, **geo)]
    if spy.seen != fits + [pick]:
        raise AssertionError(f"{label}: the launches took block_b {spy.seen}, "
                             f"expected {fits + [pick]}")
    log(f"  {label}: " + "; ".join(rows) + f"; each fitting W equals the W = 0 launch and "
        f"the plain version; apply_ops reached the launch with block_b {spy.seen} (the "
        f"table's pick {pick}) and equals the default config")


def phase_warps(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    log("phase 3k: the staged kernel's warps a block (ExecConfig.block_b)")
    # the main geometry, a generic one, and a wide one where 8 warps do not fit
    for ns, npb, n_keys in ((32, 16, 1 << 20), (16, 8, 1 << 20), (32, 64, 1 << 18)):
        warps_case(dev, gen, ns, npb, n_keys)


def phase_kernel_ops(dev, check: KernelCheck):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    log("phase 3d: flix_point_query, flix_successor, flix_insert, flix_delete")
    for ns, npb, n_keys in ((32, 16, 1 << 18), (8, 8, 1 << 18), (32, 64, 1 << 16)):
        kernel_ops_case(dev, check, gen, ns, npb, n_keys)
    for ns, npb, n_keys in ((4, 2, 1 << 20), (32, 64, 1 << 20)):  # S = 8 and S = 2048
        query_edge_case(dev, check, gen, ns, npb, n_keys)
    for ns, npb in ((32, 16), (8, 8), (32, 64), (4, 2)):
        update_edge_case(dev, check, gen, ns, npb, 1 << 20)
    for ns, npb in ((32, 16), (8, 8), (32, 64), (4, 2)):  # last: the draws before stay
        successor_edge_case(dev, check, gen, ns, npb, 1 << 20)


def query_bytes(state, q, successor: bool) -> int:
    """Bytes a query kernel must move for these queries: each query read
    once and each answer written once, the fences, and the node_max rows,
    node key rows and answer values that these queries touch (for a
    successor past its bucket, the bucket's fence-row pair instead)."""
    nb, npb, ns = state.geometry
    b = torch.searchsorted(state.mkba, q)
    own = b < nb
    b, qo = b[own], q[own]
    nidx = (state.node_max[b] < qo[:, None]).sum(1)
    node = torch.clamp(nidx, max=npb - 1)
    pos = (state.keys[b, node] < qo[:, None]).sum(1)
    pos_c = torch.clamp(pos, max=ns - 1)
    moved = 4 * q.numel() + (8 if successor else 4) * q.numel() + 4 * nb
    moved += 4 * npb * torch.unique(b).numel() + 4 * ns * torch.unique(b * npb + node).numel()
    if successor:
        answered = (nidx < state.num_nodes[b]) & (pos < ns)
        moved += 8 * torch.unique(b[~answered]).numel()
    else:
        answered = (pos < ns) & (state.keys[b, node, pos_c] == qo)
    slot = (b * npb + node) * ns + pos_c
    return moved + 4 * torch.unique(slot[answered]).numel()


def fence_bytes(state, num_nodes: bool) -> int:
    """Bytes the fence-row kernel must move for a state's planes: per bucket
    its non-empty test (4 bytes of ``num_nodes``, or the first 32-byte
    sector of its ``node_max`` row, all of the row where the first entry is
    EMPTY), the sector of each non-empty bucket's head key, the sector of
    the head value of each distinct attaining bucket, and 8 bytes out."""
    from repro_torch.core.query import _successor_fence_rows
    from repro_torch.core.state import EMPTY

    nb, npb, ns = state.geometry
    sector = min(32, 4 * npb * ns)  # of a head key or value
    if num_nodes:
        test, live = 4 * nb, state.num_nodes > 0
    else:
        first = min(32, 4 * npb)
        rest = int((state.node_max[:, 0] == EMPTY).sum()) * (4 * npb - first)
        test, live = first * nb + rest, (state.node_max != EMPTY).any(1)
    _, sidx_pad = _successor_fence_rows(state.keys, live.to(torch.int32))
    attained = torch.unique(sidx_pad[1:]).numel()
    return test + sector * int(live.sum()) + sector * attained + 8 * nb


def phase_fig9(dev, check: KernelCheck):
    """The paper's Fig. 9 round schedule through the kernel entry points."""
    from repro_torch import core
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flix_apply as fa
    from repro_torch.kernels import flix_delete as fd
    from repro_torch.kernels import flix_insert as fi
    from repro_torch.kernels import flix_query as fq
    from repro_torch.kernels import flix_successor as fs
    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    log(f"phase 5: Fig. 9 schedule on {FULL_KEYS} keys from a {FULL_SPACE} key space: "
        f"4 insert + 4 delete rounds of {FIG9_ROUND} keys through repro_torch.kernels.ops")
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    state = core.build(keys, vals)
    del keys, vals
    nb, npb, ns = state.geometry
    pool = traffic.perm[FULL_KEYS : FULL_KEYS + 4 * FIG9_ROUND]
    names = ("flix_point_query", "flix_successor", "flix_fence_rows", "flix_insert",
             "flix_delete")
    launches = {k: 0 for k in names}
    times = {k: [] for k in names}
    bounds = {k: [] for k in names}
    plain = {}
    for rnd in range(8):
        ins = rnd < 4
        side_ms = {}  # the entry points' torch passes around the kernels
        chunk = pool[(rnd % 4) * FIG9_ROUND : (rnd % 4 + 1) * FIG9_ROUND]
        upd_k, order = torch.sort(chunk, stable=True)
        upd_v = torch.arange(FIG9_ROUND, dtype=torch.int32, device=dev)[order]
        traffic.alive[chunk.long()] = ins
        live = torch.nonzero(traffic.alive)[:, 0].to(torch.int32)
        hits = torch.sort(live[torch.randint(0, live.numel(), (FIG9_QUERIES,), generator=gen,
                                             device=dev)]).values
        # unique absent keys, a uniform draw of them: cutting the sorted
        # candidates would leave the top of the key space without misses
        cand = torch.unique(traffic._rand_keys(2 * FIG9_QUERIES))
        cand = cand[~traffic.alive[cand.long()]]
        assert cand.numel() >= FIG9_QUERIES, cand.numel()
        pick = torch.randperm(cand.numel(), generator=gen, device=dev)[:FIG9_QUERIES]
        misses = torch.sort(cand[pick]).values
        succ = torch.sort(traffic._rand_keys(FIG9_SUCC)).values
        del live, cand
        torch.cuda.synchronize()

        reset_launches()
        t0 = time.perf_counter()
        if ins:
            new_state, overflow = kops.flix_insert(state, upd_k, upd_v)
        else:
            new_state = kops.flix_delete(state, upd_k)
        v_hit = kops.flix_point_query(new_state, hits)
        v_miss = kops.flix_point_query(new_state, misses)
        s_key, s_val = kops.flix_successor(new_state, succ)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: LAUNCHES[k] for k in names}
        expect = {"flix_point_query": 2 if ins else 3, "flix_successor": 1,
                  "flix_fence_rows": 1, "flix_insert": int(ins), "flix_delete": int(not ins)}
        if counts != expect:
            raise AssertionError(f"fig9 round {rnd}: launches {counts}, expected {expect}")
        for k, c in counts.items():
            launches[k] += c

        # every call against the port's core function on the card
        if ins:
            (want, stats), core_upd_ms = host_ms(lambda: core.insert(state, upd_k, upd_v))
            if int(overflow.max()) or int(stats["overflowed_buckets"]):
                raise AssertionError(f"fig9 round {rnd}: an insert overflowed")
        else:
            (want, _), core_upd_ms = host_ms(lambda: core.delete(state, upd_k))
        check_same_state(f"fig9 round {rnd}", new_state, want)
        del want
        w_hit, core_q_ms = host_ms(lambda: core.point_query(new_state, hits))
        w_miss = core.point_query(new_state, misses)
        (w_key, w_val), core_s_ms = host_ms(lambda: core.successor_query(new_state, succ))
        for what, w, g in (("all-hit", w_hit, v_hit), ("all-miss", w_miss, v_miss),
                           ("successor key", w_key, s_key), ("successor val", w_val, s_val)):
            if not torch.equal(w, g):
                raise AssertionError(f"fig9 round {rnd}: {what} differs from core")
        if bool((v_hit == core.NOT_FOUND).any()) or bool((v_miss != core.NOT_FOUND).any()):
            raise AssertionError(f"fig9 round {rnd}: a hit missed or a miss hit")
        del w_hit, w_miss, w_key, w_val

        # the kernels alone on this round's inputs (re-launched, not counted)
        if ins:
            upd_name, upd_fn = "flix_insert", fi.flix_insert_pass
            upd_args = (state.num_nodes, state.keys, state.vals, state.node_max, state.mkba,
                        upd_k, upd_v)
            extra_bytes = 8 * FIG9_ROUND + 4 * nb  # the batch's keys and vals, overflow
        else:
            upd_name, upd_fn = "flix_delete", fd.flix_delete_pass
            planes = (state.keys, state.vals, state.node_max, state.mkba)

            def prefilter():  # flix_delete's cut to present keys, then its re-sort
                present = fq.flix_point_query(*planes, upd_k) != core.NOT_FOUND
                return torch.sort(torch.where(present, upd_k, core.EMPTY), stable=True).values

            dk = prefilter()
            upd_args = (state.num_nodes, state.keys, state.vals, state.mkba, dk)
            extra_bytes = 4 * FIG9_ROUND  # the batch's keys
            side_ms["delete pre-filter"] = event_ms(prefilter, 3)
            side_ms["pre-filter point query"] = event_ms(
                lambda: fq.flix_point_query(*planes, upd_k), 5)
            side_ms["pre-filter bound"] = (query_bytes(state, upd_k, successor=False)
                                           / HBM_BYTES_PER_S * 1e3)
        upd_ms = event_ms(lambda: upd_fn(*upd_args), 3)
        upd_bytes = update_bytes(state, extra_bytes, reads_node_max=ins)
        # the staged stripe kernel on the same keys as an insert-only or a
        # delete-only batch of ops: its update path in every bucket
        sops, _ = core.make_ops(torch.full_like(upd_k, core.OP_INSERT if ins else core.OP_DELETE),
                                upd_k, upd_v)
        sargs = (state.num_nodes, *fa.stripe_inputs(state, sops.tag, sops.key, sops.val)[0])
        side_ms["staged kernel, same keys"] = event_ms(
            lambda: fa.flix_apply_staged_pass(*sargs), 3)
        del sops, sargs
        times[upd_name].append(upd_ms)
        bounds[upd_name].append(upd_bytes / HBM_BYTES_PER_S * 1e3)
        planes = (new_state.keys, new_state.vals, new_state.node_max, new_state.mkba)
        q_ms, q_bytes = [], []
        for q in (hits, misses):
            q_ms.append(event_ms(lambda: fq.flix_point_query(*planes, q), 5))
            q_bytes.append(query_bytes(new_state, q, successor=False))
        nxk, nxv = fs.fence_rows(*planes[:3])
        s_ms = event_ms(lambda: fs.successor_pass(*planes, nxk, nxv, succ), 5)
        f_ms = queued_ms(lambda: fs.fence_rows(*planes[:3]), 5)  # device time alone
        side_ms["fence rows a call"] = event_ms(lambda: fs.fence_rows(*planes[:3]), 5)
        s_bytes = query_bytes(new_state, succ, successor=True)
        f_bytes = fence_bytes(new_state, num_nodes=False)
        q_bound = [b / HBM_BYTES_PER_S * 1e3 for b in q_bytes]
        times["flix_point_query"] += q_ms
        bounds["flix_point_query"] += q_bound
        times["flix_successor"].append(s_ms)
        bounds["flix_successor"].append(s_bytes / HBM_BYTES_PER_S * 1e3)
        times["flix_fence_rows"].append(f_ms)
        bounds["flix_fence_rows"].append(f_bytes / HBM_BYTES_PER_S * 1e3)
        log(f"  round {rnd} ({'insert' if ins else 'delete'} {FIG9_ROUND}): "
            f"{round_ms:.3f} ms for the round's five entry-point calls; "
            f"{upd_name} {upd_ms:.4f} ms (bound {bounds[upd_name][-1]:.4f} ms, {upd_bytes} B, "
            f"{FIG9_ROUND / upd_ms * 1e3:.6g} keys/s), core {core_upd_ms:.3f} ms; "
            f"point all-hit {q_ms[0]:.4f} ms (bound {q_bound[0]:.4f} ms, {q_bytes[0]} B, "
            f"{q_ms[0] / q_bound[0]:.2f}x, {FIG9_QUERIES / q_ms[0] * 1e3:.6g} q/s), all-miss "
            f"{q_ms[1]:.4f} ms (bound {q_bound[1]:.4f} ms, {q_bytes[1]} B, "
            f"{q_ms[1] / q_bound[1]:.2f}x, {FIG9_QUERIES / q_ms[1] * 1e3:.6g} q/s), "
            f"core {core_q_ms:.3f} ms (all-hit); "
            f"successor {s_ms:.4f} ms (bound {bounds['flix_successor'][-1]:.4f} ms, "
            f"{s_bytes} B, {s_ms / bounds['flix_successor'][-1]:.2f}x, "
            f"{FIG9_SUCC / s_ms * 1e3:.6g} q/s), core {core_s_ms:.3f} ms; fence rows "
            f"{f_ms:.4f} ms queued (bound {bounds['flix_fence_rows'][-1]:.4f} ms, {f_bytes} B, "
            f"{f_ms / bounds['flix_fence_rows'][-1]:.2f}x); "
            + "".join(f"{k} {v:.4f} ms; " for k, v in side_ms.items())
            + f"launches {counts}")

        # plain versions at this schedule's shapes, once each: no yardstick
        # of speed, they repeat the kernels' arithmetic
        if rnd in (3, 7):
            want, plain[upd_name] = host_ms(lambda: (fi.flix_insert_reference if ins
                                                     else fd.flix_delete_reference)(*upd_args))
            check.hold(upd_name, want, upd_fn(*upd_args), f"fig9 round {rnd}")
            del want
        if rnd == 7:
            want, plain["flix_point_query"] = host_ms(
                lambda: fq.flix_point_query_reference(*planes, hits))
            check.hold("flix_point_query", [want], [v_hit], "fig9 round 7")
            want, plain["flix_successor"] = host_ms(
                lambda: fs.flix_successor_reference(*planes, succ))
            check.hold("flix_successor", want, (s_key, s_val), "fig9 round 7")
            want, plain["flix_fence_rows"] = host_ms(lambda: fs.next_rows(*planes[:3]))
            check.hold("flix_fence_rows", want, (nxk, nxv), "fig9 round 7")
            del want
        state = new_state
        del new_state, upd_args

    _, inv_ms = host_ms(lambda: core.check_invariants(state))
    log(f"  invariants I1-I5 hold on the final state ({inv_ms:.0f} ms); live keys "
        f"{int(state.live_keys())}; launches over the schedule {launches}; plain versions "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in plain.items()))
    return {k: dict(launches=launches[k], ms=fmean(times[k]), plain_ms=plain[k],
                    bound_ms=fmean(bounds[k]), err=check.err[k]) for k in names}


def serve_build(dev):
    """The installed index content: every one of the 2^16 sequence slots
    holds pages [0, 256), slot s*256 + p, plus the index's seed key."""
    from repro_torch import core
    from repro_torch.serve import PAGE_BITS

    seq = torch.arange(SERVE_SEQS, dtype=torch.int32, device=dev)
    page = torch.arange(SERVE_PAGES, dtype=torch.int32, device=dev)
    keys = ((seq[:, None] << PAGE_BITS) | page[None, :]).reshape(-1)
    keys = torch.cat([keys, keys.new_full((1,), core.MAX_VALID)])
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    return core.build(keys, vals, node_size=32, nodes_per_bucket=16, device=dev)


def check_same_step(label, got, want):
    """Two StepResults: slots, the dense RANGE output and the stats equal."""
    if not torch.equal(got.slots, want.slots):
        raise AssertionError(f"{label}: slots differ from the reference index")
    for k in want.range_out or {}:
        if not torch.equal(got.range_out[k], want.range_out[k]):
            raise AssertionError(f"{label}: range {k} differs from the reference index")
    for k, v in want.stats.items():
        if int(got.stats[k]) != int(v):
            raise AssertionError(f"{label}: stat {k}: {int(got.stats[k])} != {int(v)}")


def serve_mix(**kw) -> dict:
    """One step's mix of work: phase 6's (the ``SERVE_*`` sizes), with
    ``kw`` overriding any of them."""
    mix = dict(steps=SERVE_STEPS, appends=SERVE_APPENDS, lookups=SERVE_LOOKUPS,
               getsets=SERVE_GETSETS, frees=SERVE_FREES, ranges=SERVE_RANGES,
               range_budget=SERVE_RANGE_BUDGET)
    mix.update(kw)
    return mix


class ServeTraffic:
    """The serving steps of phases 6, 9 and 11b over ``serve_build``'s
    content, and the host's model of the index that checks each step's
    answers: the base pages [0, base[s]) of each slot, their slots, the
    get-or-set pages, and the freed ids waiting for reuse.

    ``mix`` sizes a step (:func:`serve_mix`).  ``hot`` draws every step's
    work from that many sequence slots (an LLM server's running batch): a
    freed slot leaves the hot set, and the slots freed the update step
    before come back into it with their prefill.  Every sequence that stays
    appends at most once a step."""

    def __init__(self, seed: int, mix: dict | None = None, hot: int | None = None):
        self.rng = np.random.default_rng(seed)
        self.mix = mix if mix is not None else serve_mix()
        self.hot = None
        if hot is not None:
            self.hot = np.sort(self.rng.choice(SERVE_SEQS, hot, replace=False))
        self.base = np.full(SERVE_SEQS, SERVE_PAGES)
        self.slot0 = np.arange(SERVE_SEQS, dtype=np.int64) * SERVE_PAGES
        self.live = np.ones(SERVE_SEQS, bool)
        self.freed: list[int] = []
        self.getset_slot: dict[int, int] = {}
        self.prev_gs = np.zeros(0, np.int64)
        self.readmit = np.zeros(0, np.int64)

    def step(self, i: int) -> dict:
        """Step ``i``: its ``KVPageIndex.step`` arguments (``kw``) and what
        :meth:`check` needs.  Every fourth step is read-only; the mix's
        last step leaves out the sequences the newest version re-admitted
        (phase 6 reads it at the version before)."""
        from repro_torch import core
        from repro_torch.serve import PAGE_BITS

        rng, mix = self.rng, self.mix
        now = 10 * (i + 1)
        live_ids = np.nonzero(self.live)[0]
        if self.hot is not None:
            live_ids = live_ids[np.isin(live_ids, self.hot)]
        read_only = i % 4 == 3
        kw = dict(range_budget=mix["range_budget"], now=now)
        step = dict(i=i, kw=kw, now=now, read_only=read_only)
        frees = np.zeros(0, np.int64)
        if not read_only:
            n_free = mix["frees"]
            frees = rng.choice(live_ids, n_free, replace=False)
            self.readmit = readmit = np.array(self.freed[:n_free], np.int64)
            del self.freed[:n_free]
            stay = np.setdiff1d(live_ids, frees)
            n_app = min(mix["appends"], len(stay))
            appenders = rng.choice(stay, n_app, replace=False)
            r_pages = np.tile(np.arange(SERVE_PREFILL), len(readmit))
            a_seq = np.concatenate([appenders, np.repeat(readmit, SERVE_PREFILL)])
            a_page = np.concatenate([np.full(n_app, SERVE_PAGES + i), r_pages])
            r_slot0 = ((1 << 28) + i * n_free * SERVE_PREFILL
                       + np.arange(len(readmit)) * SERVE_PREFILL)
            a_slot = np.concatenate([(1 << 27) + i * n_app + np.arange(n_app),
                                     np.repeat(r_slot0, SERVE_PREFILL) + r_pages])
            a_dead = np.concatenate([np.full(n_app, now + SERVE_TTL),
                                     np.full(len(r_pages), int(core.NO_EXPIRY))])
            # get-or-sets: half re-ask the previous step's pages (hits while
            # their sequence lives), half ask fresh pages (misses)
            old = self.prev_gs[np.isin(self.prev_gs >> PAGE_BITS, frees, invert=True)]
            old = old[: mix["getsets"] // 2]
            fresh_seq = rng.choice(stay, mix["getsets"] - len(old), replace=False)
            fresh = (fresh_seq << PAGE_BITS) | (2048 + i)
            gs = np.concatenate([old, fresh])
            gs_slot = (1 << 29) + i * mix["getsets"] + np.arange(len(gs))
            kw.update(allocs=(a_seq, a_page, a_slot, a_dead),
                      getsets=(gs >> PAGE_BITS, gs & ((1 << PAGE_BITS) - 1), gs_slot,
                               np.full(len(gs), now + 80)),
                      free_seqs=frees, max_pages=SERVE_PAGES)
            step.update(frees=frees, readmit=readmit, r_slot0=r_slot0, gs=gs,
                        gs_slot=gs_slot,
                        ins_keys=np.concatenate([(a_seq << PAGE_BITS) | a_page, fresh]))
        # lookups: half hits on base pages of sequences that stay, half
        # misses on pages never allocated
        stay = np.setdiff1d(live_ids, frees)
        if i == mix["steps"] - 1:
            stay = np.setdiff1d(stay, self.readmit)
        n_look = mix["lookups"]
        h_seq = rng.choice(stay, n_look // 2)
        h_page = (rng.random(len(h_seq)) * self.base[h_seq]).astype(np.int64)
        if self.hot is None:
            m_seq = rng.integers(0, SERVE_SEQS, n_look // 2)
        else:
            m_seq = rng.choice(self.hot, n_look // 2)
        m_page = rng.integers(3000, 1 << PAGE_BITS, n_look // 2)
        kw["lookups"] = (np.concatenate([h_seq, m_seq]), np.concatenate([h_page, m_page]))
        r_seq = rng.choice(stay, mix["ranges"], replace=False)
        kw["ranges"] = (r_seq << PAGE_BITS, (r_seq + 1) << PAGE_BITS)
        step.update(h_seq=h_seq, h_page=h_page)
        return step

    @staticmethod
    def fullest(step: dict, state) -> int:
        """The fullest bucket the update step's inserts could make, which
        must stay within half a bucket: no bucket may overflow, so no step
        retries (``restructure_grow`` at this size asks for ~1.8 TB).  A
        tiered index answers from its host metadata."""
        if hasattr(state, "h_mkba"):
            per = np.bincount(np.searchsorted(state.h_mkba, step["ins_keys"]),
                              minlength=state.num_buckets)
            fullest = int((state.h_live + per).max())
            assert fullest <= state.nodes_per_bucket * state.node_size // 2, fullest
            return fullest
        ins = torch.as_tensor(step["ins_keys"], dtype=torch.int32, device=state.device)
        per = torch.bincount(torch.searchsorted(state.mkba, ins), minlength=state.num_buckets)
        fullest = int((state.node_count.sum(1) + per).max())
        assert fullest <= state.bucket_capacity // 2, fullest
        return fullest

    def check(self, step: dict, got) -> None:
        """The model's answers for the step (hits find their slot, misses
        do not, get-or-sets return the stored slot of a page they hit);
        then the model takes the step's updates."""
        i = step["i"]
        slots = got.slots.cpu().numpy().astype(np.int64)
        n_look = self.mix["lookups"]
        if not (slots[: n_look // 2] == self.slot0[step["h_seq"]] + step["h_page"]).all():
            raise AssertionError(f"serve step {i}: a lookup hit returned a wrong slot")
        if not (slots[n_look // 2 : n_look] == -1).all():
            raise AssertionError(f"serve step {i}: a lookup miss found a slot")
        if step["read_only"]:
            return
        gs, gs_slot, frees, readmit = step["gs"], step["gs_slot"], step["frees"], step["readmit"]
        want_gs = np.array([self.getset_slot.get(int(k), -1) for k in gs])
        if not (slots[n_look:] == want_gs).all():
            raise AssertionError(f"serve step {i}: a get-or-set returned a wrong slot")
        for k, sl in zip(gs.tolist(), gs_slot.tolist()):
            self.getset_slot.setdefault(k, sl)
        self.prev_gs = gs
        self.live[frees] = False
        self.base[frees] = 0
        self.freed.extend(frees.tolist())
        self.live[readmit] = True
        self.base[readmit] = SERVE_PREFILL
        self.slot0[readmit] = step["r_slot0"]
        if self.hot is not None:
            self.hot = np.union1d(np.setdiff1d(self.hot, frees), readmit)


SERVE_KERNELS = ("flix_apply", "flix_apply_staged", "flix_apply_range", "flix_apply_rank",
                 "flix_fence_rows")


def check_update_launches(label, counts):
    """An update step runs the fused path: the staged stripe kernel, the
    range gather, the rank count and the fence rows, once a plane (TTL)."""
    if min(counts[k] for k in SERVE_KERNELS[1:]) < 2:
        raise AssertionError(f"{label}: kernels not launched: {counts}")


def phase_serve(dev):
    """The serving path: KVPageIndex on the card, every step against an
    index on the reference engine that starts from the same state."""
    from repro_torch import core
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import KVPageIndex

    torch.cuda.reset_peak_memory_stats()
    traffic = ServeTraffic(SEED + 4)
    geometry = dict(node_size=32, nodes_per_bucket=16)
    idx = KVPageIndex(**geometry, snapshot_window=2, device=dev)
    ref = KVPageIndex(**geometry, config=core.ExecConfig(impl="reference"), device=dev)
    idx.state, build_ms = host_ms(lambda: serve_build(dev))
    nb, npb, ns = idx.state.geometry
    log(f"phase 6: KVPageIndex on {idx.live_pages()} page keys ({SERVE_SEQS} sequence slots "
        f"x {SERVE_PAGES} pages), nb={nb} npb={npb} ns={ns}, build {build_ms:.1f} ms")

    pins: dict[int, tuple] = {}
    launches = {k: 0 for k in SERVE_KERNELS}
    step_ms = {"update": [], "read": []}
    for i in range(SERVE_STEPS):
        step = traffic.step(i)
        kw, read_only = step["kw"], step["read_only"]
        fullest = None if read_only else ServeTraffic.fullest(step, idx.state)
        ref_kw = dict(kw)
        ref.state = idx.state
        if i == SERVE_STEPS - 1:  # a read at the version before the newest
            kw = dict(kw, as_of=idx.version - 1)
            del kw["now"]
            ref.state, ref_kw["now"] = pins[kw["as_of"]]

        torch.cuda.synchronize()
        reset_launches()
        got, ms = host_ms(lambda: idx.step(**kw))
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        want = ref.step(**ref_kw)
        check_same_step(f"serve step {i}", got, want)
        kind = "read" if read_only else "update"
        step_ms[kind].append(ms)
        if read_only:
            if any(counts.values()):
                raise AssertionError(f"serve step {i}: a read-only step launched {counts}")
        else:
            check_same_state(f"serve step {i}", idx.state, ref.state)
            if not torch.equal(idx.state.exps, ref.state.exps):
                raise AssertionError(f"serve step {i}: the expiry plane differs")
            check_update_launches(f"serve step {i}", counts)
            assert int(got.stats["restructure_retries"]) == 0, got.stats
            pins[idx.version] = (idx.state, step["now"])
            pins.pop(idx.version - 2, None)
        for k, c in counts.items():
            launches[k] += c
        ref.state = None
        traffic.check(step, got)
        trunc = int(got.stats["range_truncated"])
        log(f"  step {i} ({kind}{', as_of' if 'as_of' in kw else ''}, now={ref_kw['now']}): "
            f"{ms:.3f} ms; launches {counts}; expired {int(got.stats.get('expired', 0))}, "
            f"inserted {int(got.stats['inserted'])}, deleted {int(got.stats['deleted'])}, "
            f"range_truncated {trunc}" + ("" if read_only else f"; fullest bucket {fullest}"))

    last_now = max(n for _, n in pins.values())
    _, inv_ms = host_ms(lambda: core.check_invariants(idx.state, now=last_now))
    log(f"  invariants I1-I6 hold on the final state at now={last_now} ({inv_ms:.0f} ms); "
        f"live pages {idx.live_pages()}; versions retained {idx.retained_versions}")
    log(f"  step latency: update median {median(step_ms['update']):.3f} ms "
        f"(min {min(step_ms['update']):.3f}, max {max(step_ms['update']):.3f}), read-only "
        f"median {median(step_ms['read']):.3f} ms; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


class Crash(BaseException):
    """A simulated process death (nothing on the path may catch it)."""


class CrashAt:
    """A durable layer's ``crash_hook``: raises :class:`Crash` at the
    ``count``-th occurrence of ``event``."""

    def __init__(self, event: str, count: int):
        self.event, self.count, self.seen = event, count, 0

    def __call__(self, event: str) -> None:
        if event == self.event:
            self.seen += 1
            if self.seen == self.count:
                raise Crash(f"{event}#{self.count}")


def snapshot_line(label, t, smi, where="on the card") -> str:
    return (f"  {label}: {t['kind']} snapshot, payload {t['payload_bytes']} B + manifest "
            f"{t['manifest_bytes']} B; canonicalize {where} {t['canonicalize_s']:.3f} s, "
            f"framing + crcs + manifest {t['crc_s']:.3f} s, write + fsync "
            f"{t['write_fsync_s']:.3f} s ({smi})")


def recovery_line(label, dur, ms, smi) -> str:
    t = dur.timings
    return (f"  {label}: recovered seq {dur.seq} in {ms / 1e3:.3f} s: chain load "
            f"{t['chain_load_s']:.3f} s, rebuild on the card {t['rebuild_s']:.3f} s, replay of "
            f"{dur.replayed} records {t['replay_s']:.3f} s ({smi})")


def phase_durable(dev, smi):
    """Durability at phase 6's size, in a temporary directory deleted at
    the end: create a durable history from the build; recover it through
    ``KVPageIndex(durability_dir=...)``; phase 6's steps, WAL-ahead, held
    against a reference-engine index that starts from the recovered state;
    a crash at the 10th commit's half-written record; recovery onto the
    oracle's bytes; the remaining steps."""
    import tempfile

    from repro_torch import core
    from repro_torch.checkpoint import (
        DurableFliX,
        LocalEngine,
        WALCorruptionError,
        canonical_state_bytes,
        replay,
    )
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import KVPageIndex

    torch.cuda.reset_peak_memory_stats()
    geometry = dict(node_size=32, nodes_per_bucket=16)
    durable_kw = dict(**geometry, snapshot_every=DURABLE_SNAPSHOT_EVERY, device=dev)
    launches = {k: 0 for k in SERVE_KERNELS}
    with tempfile.TemporaryDirectory(prefix="flix-durable-") as tmp:
        d = Path(tmp) / "index"
        built = serve_build(dev)
        dur, create_ms = host_ms(
            lambda: DurableFliX.create(d, built, engine=LocalEngine(**geometry, device=dev)))
        dur.close()
        want = (d / "snap_000000000000" / "payload.bin").read_bytes()  # canonical bytes
        log(f"phase 9: durable history of {len(want)} canonical bytes "
            f"({(len(want) - 16) // 12} live keys, nb={built.num_buckets}) created in "
            f"{create_ms / 1e3:.3f} s")
        log(snapshot_line("create", dur.last_timings, smi))
        del built, dur

        hook = CrashAt("wal.append.partial", DURABLE_CRASH_COMMIT)
        idx, open_ms = host_ms(lambda: KVPageIndex(**durable_kw, durability_dir=d,
                                                   crash_hook=hook))
        log(recovery_line("KVPageIndex(durability_dir=...)", idx._durable, open_ms, smi))
        got_bytes, canon_ms = host_ms(lambda: canonical_state_bytes(idx.state))
        if got_bytes != want:
            raise AssertionError("phase 9: the recovered index's canonical bytes differ")
        log(f"  recovered geometry {tuple(idx.state.geometry)}; canonical bytes equal the "
            f"build's ({canon_ms:.0f} ms)")

        ref = KVPageIndex(**geometry, config=core.ExecConfig(impl="reference"), device=dev)
        # steps the durable index's pre-step states, which ref may hold too
        plain = KVPageIndex(**geometry, config=core.ExecConfig(donate=False), device=dev)
        ref.state = idx.state
        traffic = ServeTraffic(SEED + 4)  # phase 6's steps
        commits, crash_step, i = [], None, 0
        while crash_step is None:
            step = traffic.step(i)
            kw, read_only = step["kw"], step["read_only"]
            if not read_only:
                ServeTraffic.fullest(step, idx.state)
            pre = idx.state
            torch.cuda.synchronize()
            reset_launches()
            try:
                got, ms = host_ms(lambda: idx.step(**kw))
            except Crash:
                crash_step = step
                break
            counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
            plain.state = pre
            _, plain_ms = host_ms(lambda: plain.step(**kw))
            plain.state = None
            want_step = ref.step(**kw)
            check_same_step(f"durable step {i}", got, want_step)
            traffic.check(step, got)
            for k, c in counts.items():
                launches[k] += c
            line = f"  step {i} ({'read' if read_only else 'update'}): {ms:.3f} ms"
            if read_only:
                if any(counts.values()) or idx.durable_seq != len(commits):
                    raise AssertionError(f"durable step {i}: a read-only step logged or "
                                         f"launched {counts}")
                log(line + f", without durability {plain_ms:.3f} ms")
            else:
                check_same_state(f"durable step {i}", idx.state, ref.state)
                if not torch.equal(idx.state.exps, ref.state.exps):
                    raise AssertionError(f"durable step {i}: the expiry plane differs")
                check_update_launches(f"durable step {i}", counts)
                assert int(got.stats["restructure_retries"]) == 0, got.stats
                seq = idx.durable_seq
                assert seq == len(commits) + 1, seq
                wal = idx._durable.last_append
                commits.append(dict(ms=ms, plain_ms=plain_ms, **wal))
                log(line + f", without durability {plain_ms:.3f} ms (overhead "
                    f"{ms - plain_ms:.3f} ms); durable seq {seq}, WAL record {wal['bytes']} B, "
                    f"append + fsync {wal['append_fsync_s'] * 1e3:.3f} ms; launches {counts}")
                if seq % DURABLE_SNAPSHOT_EVERY == 0:
                    t = idx._durable.last_timings
                    if not (d / f"snap_{seq:012d}").is_dir():
                        raise AssertionError(f"durable step {i}: no snapshot at seq {seq}")
                    log(snapshot_line(f"seq {seq}", t, smi))
            i += 1
        if len(commits) != DURABLE_CRASH_COMMIT - 1 or i < SERVE_STEPS:
            raise AssertionError(f"phase 9: crashed after {len(commits)} commits, step {i}")
        kinds = {json.loads((d / f"snap_{s:012d}" / "manifest.json").read_text())["kind"]
                 for s in range(0, len(commits) + 1, DURABLE_SNAPSHOT_EVERY)}
        if kinds != {"full", "delta"}:
            raise AssertionError(f"phase 9: snapshot kinds {kinds}")
        acked = idx.durable_seq
        idx = None  # dropped without close(), as a dead process leaves it
        try:
            replay(d, truncate_torn=False)
            raise AssertionError("phase 9: no torn WAL tail after the crash")
        except WALCorruptionError as e:
            log(f"  crash at commit {DURABLE_CRASH_COMMIT} (step {i}), "
                f"wal.append.partial: torn tail ({e})")
        want_bytes, canon_ms = host_ms(lambda: canonical_state_bytes(ref.state))

        reset_launches()
        idx, open_ms = host_ms(lambda: KVPageIndex(**durable_kw, durability_dir=d))
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        log(recovery_line("after the crash", idx._durable, open_ms, smi))
        if idx.durable_seq != acked or idx._durable.replayed < 1:
            raise AssertionError(f"phase 9: recovered seq {idx.durable_seq}, acked {acked}, "
                                 f"replayed {idx._durable.replayed}")
        check_update_launches("phase 9 replay", counts)
        records = replay(d, truncate_torn=False)  # the torn tail is gone
        if records[-1][0] != acked:
            raise AssertionError(f"phase 9: the WAL ends at seq {records[-1][0]}")
        if canonical_state_bytes(idx.state) != want_bytes:
            raise AssertionError("phase 9: the recovered bytes differ from the oracle's")
        for k, c in counts.items():
            launches[k] += c
        log(f"  replay launches {counts}; canonical bytes at seq {acked} equal the oracle's "
            f"({canon_ms:.0f} ms)")

        step = crash_step
        for i in range(crash_step["i"], crash_step["i"] + DURABLE_AFTER):
            if i > crash_step["i"]:
                step = traffic.step(i)
            if not step["read_only"]:
                ServeTraffic.fullest(step, idx.state)
            reset_launches()
            got, ms = host_ms(lambda: idx.step(**step["kw"]))
            counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
            check_same_step(f"durable step {i} after recovery", got, ref.step(**step["kw"]))
            traffic.check(step, got)
            if not step["read_only"]:
                check_update_launches(f"durable step {i} after recovery", counts)
            if canonical_state_bytes(idx.state) != canonical_state_bytes(ref.state):
                raise AssertionError(f"durable step {i} after recovery: bytes differ")
            for k, c in counts.items():
                launches[k] += c
            log(f"  step {i} after recovery: {ms:.3f} ms, durable seq {idx.durable_seq}, "
                f"canonical bytes equal the oracle's; launches {counts}")
            if idx.durable_seq % DURABLE_SNAPSHOT_EVERY == 0:
                log(snapshot_line(f"seq {idx.durable_seq}", idx._durable.last_timings, smi))
        idx.close()
        overhead = [c["ms"] - c["plain_ms"] for c in commits]
        log(f"  per update commit: WAL record median {median(c['bytes'] for c in commits):.0f} B, "
            f"append + fsync median {median(c['append_fsync_s'] for c in commits) * 1e3:.3f} ms, "
            f"step median {median(c['ms'] for c in commits):.3f} ms against "
            f"{median(c['plain_ms'] for c in commits):.3f} ms without durability (overhead "
            f"median {median(overhead):.3f} ms); launches {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


class GatewayTraffic:
    """Phase 10's client population over ``serve_build``'s content, and the
    host's model of the index that checks every answer the gateway gives.

    64 clients, each with a private run of sequence ids and tenant c % 8;
    a client's fresh requests at a tick are a function of (client, tick,
    seed) alone, so a client sends them again after a crash with the same
    idempotency keys.  By request: 45% allocs of 1-8 pages below
    SERVE_PAGES of one sequence (never more keys in a bucket than the
    build put there, so no step retries), 40% lookups of 1-8 pages (pages
    below SERVE_PAGES, which hit unless freed, or at 3000 and above, which
    miss), 10% page enumerations of one sequence, 3% frees, 2% lookups
    pinned ``as_of`` the previous version.  The hot tenant's clients send
    four times their rate every fifth tick, clients 1-4 send every request
    four times, clients 5-7 and 15 set deadlines 0-2 ticks ahead.  The
    offered ops are GATEWAY_LOAD times what one pump drains.

    The model is the slot of every (sequence, page < SERVE_PAGES), -1 where
    unmapped, with the copies of the versions a pinned read may ask for."""

    DUPLICATING = (1, 2, 3, 4)
    STRAGGLERS = (5, 6, 7, 15)

    def __init__(self, seed: int):
        self.seed = seed
        self.span = SERVE_SEQS // GATEWAY_CLIENTS
        # mean ops a request: allocs and lookups 4.5, enumerations 1, frees SERVE_PAGES
        mean_cost = 0.87 * 4.5 + 0.10 + 0.03 * SERVE_PAGES
        self.rate = GATEWAY_LOAD * GATEWAY_BATCH_OPS / (GATEWAY_CLIENTS * mean_cost)
        self.slots = np.arange(SERVE_SEQS * SERVE_PAGES, dtype=np.int64).reshape(
            SERVE_SEQS, SERVE_PAGES)
        self.versions = {0: self.slots.copy()}

    @staticmethod
    def tenant(c: int) -> str:
        return "hot" if c % GATEWAY_TENANTS == 0 else f"t{c % GATEWAY_TENANTS}"

    def fresh(self, t: int, version: int) -> list:
        """Every client's fresh requests at tick ``t``, in client order, each
        repeated by the duplicating clients; pinned lookups read ``version
        - 1``."""
        from repro_torch.serve import PAGE_BITS, Request

        out = []
        for c in range(GATEWAY_CLIENTS):
            rng = np.random.default_rng([self.seed, c, t])
            burst = c % GATEWAY_TENANTS == 0 and t and t % 5 == 0
            base = c * self.span
            for i in range(int(rng.poisson(self.rate * (4 if burst else 1)))):
                key, tenant = f"c{c}:{t}:{i}", self.tenant(c)
                ahead = int(rng.integers(0, 3)) if c in self.STRAGGLERS else 20
                kw = dict(deadline=float(t + ahead))
                seq = base + int(rng.integers(0, self.span))
                r, k = rng.random(), int(rng.integers(1, 9))
                if r < 0.45:
                    pages = rng.choice(SERVE_PAGES, k, replace=False).tolist()
                    req = Request(tenant, key, "alloc", seqs=(seq,) * k, pages=tuple(pages),
                                  slots=tuple(rng.integers(0, 1 << 30, k).tolist()), **kw)
                elif r < 0.85 or r >= 0.98:
                    seqs = (base + rng.integers(0, self.span, k)).tolist()
                    hit = rng.random(k) < 0.5
                    pages = np.where(hit, rng.integers(0, SERVE_PAGES, k),
                                     rng.integers(3000, 1 << PAGE_BITS, k)).tolist()
                    if r >= 0.98:
                        kw["as_of"] = max(version - 1, 0)
                    req = Request(tenant, key, "lookup", seqs=tuple(seqs), pages=tuple(pages),
                                  **kw)
                elif r < 0.95:
                    req = Request(tenant, key, "pages", seqs=(seq,), **kw)
                else:
                    req = Request(tenant, key, "free", seqs=(seq,), **kw)
                out += [req] * (4 if c in self.DUPLICATING else 1)
        return out

    def apply(self, req) -> None:
        """One committed update request into the model."""
        if req.kind == "alloc":
            self.slots[req.seqs[0], list(req.pages)] = req.slots
        elif req.kind == "free":
            self.slots[req.seqs[0]] = -1

    def keep(self, version: int) -> None:
        """The model as committed version ``version``; a pinned read can ask
        for the last two only (``snapshot_window=2``)."""
        self.versions[version] = self.slots.copy()
        for v in [v for v in self.versions if v < version - 2]:
            del self.versions[v]

    def check_read(self, tk) -> None:
        """A read ticket's value against the model at its version: pinned
        reads at theirs, the rest after their pump's updates."""
        req = tk.request
        model = self.slots if req.as_of is None else self.versions[req.as_of]
        if req.kind == "lookup":
            seqs, pages = np.asarray(req.seqs), np.asarray(req.pages)
            want = np.where(pages < SERVE_PAGES,
                            model[seqs, np.minimum(pages, SERVE_PAGES - 1)], -1)
            if tk.value.dtype != np.int32 or not np.array_equal(tk.value, want):
                raise AssertionError(f"phase 10: lookup {req.key} differs from the model")
            return
        (got,) = tk.value
        row = model[req.seqs[0]]
        present = np.nonzero(row >= 0)[0]
        if (got["count"] != len(present) or got["pages"].dtype != np.int32
                or not np.array_equal(got["pages"], present)
                or not np.array_equal(got["slots"], row[present])):
            raise AssertionError(f"phase 10: page enumeration {req.key} differs from the model")

    def check_live_pairs(self, label: str, state) -> None:
        """The index's live pairs, read through ``bucket_segments``, equal
        the model's (plus the seed key, last)."""
        from repro_torch import core
        from repro_torch.checkpoint.serialize import bucket_segments
        from repro_torch.serve import PAGE_BITS

        _, keys, vals, _ = bucket_segments(state)
        s, p = np.nonzero(self.slots >= 0)
        if not (np.array_equal(keys[:-1], (s << PAGE_BITS) | p)
                and np.array_equal(vals[:-1], self.slots[s, p])
                and keys[-1] == core.MAX_VALID):
            raise AssertionError(f"phase 10: the {label} index's live pairs differ from the model")
        log(f"  {label} index: {len(keys) - 1} live page keys equal the model's")


class PumpClock:
    """Phase 10's gateway crash hook: stamps each pump's batch formation,
    its engine steps (the card synchronized) and the acknowledgements on
    the host clock, and raises :class:`Crash` at ``gateway.step.done`` of
    the ``crash_at``-th update pump: committed and durable, never
    acknowledged."""

    def __init__(self, crash_at: int | None = None):
        self.crash_at, self.updates, self.index = crash_at, 0, None
        self.t: dict[str, float] = {}

    def __call__(self, event: str) -> None:
        if event == "gateway.batch.formed":
            self.t["formed"] = time.perf_counter()
            self.seq0 = self.index.durable_seq
        elif event == "gateway.step.done":
            torch.cuda.synchronize()
            self.t["step"] = time.perf_counter()
            if self.index.durable_seq != self.seq0:
                self.updates += 1
                if self.updates == self.crash_at:
                    raise Crash(f"{event} of update pump {self.updates}")


class GatewayRun:
    """One run of phase 10's clients through a gateway: fresh requests for
    ``GATEWAY_TICKS`` ticks from tick 0, every retryable rejection sent
    again with its key when its ``retry_after`` has passed, one pump a
    tick; then ticks of retries alone until nothing is queued or waits for
    a retry.  Every pump is checked against the model and timed."""

    def __init__(self, label, gw, idx, clock, traffic, smi):
        self.label, self.gw, self.idx, self.clock = label, gw, idx, clock
        self.traffic, self.smi = traffic, smi
        self.tickets, self.attempts, self.retry_at = {}, {}, {}
        self.resolved: set[str] = set()
        self.commit_log: list[str] = []
        self.update_keys: list[str] = []  # the keys of acknowledged update pumps
        self.latency: list[float] = []
        self.pumps: list[dict] = []
        self.launches = {k: 0 for k in SERVE_KERNELS}
        self.ticks = 0

    def submit(self, req, now: float) -> None:
        self.tickets[req.key] = self.gw.submit(req, now=now)
        self.attempts[req.key] = self.attempts.get(req.key, 0) + 1

    def settle(self, now: float) -> None:
        for key, tk in self.tickets.items():
            if key in self.resolved or key in self.retry_at or not tk.done:
                continue
            self.resolved.add(key)
            if tk.ok and not tk.duplicate:
                self.latency.append(tk.finished_at - tk.submitted_at)
            if (tk.error is not None and tk.error.retryable
                    and self.attempts[key] <= GATEWAY_MAX_RETRIES):
                self.retry_at[key] = now + max(1.0, float(tk.error.retry_after or 1.0))
                self.resolved.discard(key)

    def run(self) -> None:
        t = 0
        while t < GATEWAY_TICKS or (t < GATEWAY_TICKS + GATEWAY_DRAIN_TICKS
                                    and (self.retry_at or self.gw.queue_depth)):
            now = float(t)
            for key in sorted(k for k, w in self.retry_at.items() if w <= now):
                del self.retry_at[key]
                self.submit(self.tickets[key].request, now)
            if t < GATEWAY_TICKS:
                for req in self.traffic.fresh(t, self.idx.version):
                    self.submit(req, now)
            self.pump(t)
            self.settle(now)
            t += 1
            self.ticks = t
        if self.retry_at or self.gw.queue_depth:
            raise AssertionError(f"phase 10: {self.label} did not drain")

    def pump(self, t: int) -> None:
        from repro_torch.kernels import LAUNCHES, reset_launches

        idx, clock = self.idx, self.clock
        version, seq = idx.version, idx.durable_seq
        clock.t = {}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep = self.gw.pump(now=float(t))
        t1 = time.perf_counter()
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        self.commit_log += rep.committed_keys
        reqs = [self.tickets[k].request for k in rep.committed_keys]
        update = idx.durable_seq != seq
        if update:  # the batch's keys in its WAL record: all but the pinned reads'
            self.update_keys += [r.key for r in reqs if r.as_of is None]
            for req in reqs:
                self.traffic.apply(req)
            self.traffic.keep(idx.version)
        if idx.version != version + update:
            raise AssertionError(f"phase 10: pump at tick {t} committed {idx.version - version} "
                                 "versions")
        if rep.failed_code is not None or int(rep.stats.get("range_truncated", 0)):
            raise AssertionError(f"phase 10: pump at tick {t}: {rep.failed_code}, {rep.stats}")
        for req in reqs:
            if req.kind in ("lookup", "pages"):
                self.traffic.check_read(self.tickets[req.key])
        main_pages = any(r.kind == "pages" and r.as_of is None for r in reqs)
        if update:
            ranked = 1 if main_pages else 0
            want = dict(flix_apply=0, flix_apply_staged=1, flix_fence_rows=1,
                        flix_apply_range=ranked, flix_apply_rank=ranked)
            if counts != want or int(rep.stats["restructure_retries"]):
                raise AssertionError(f"phase 10: update pump at tick {t} launched {counts}, "
                                     f"stats {rep.stats}")
        elif any(counts.values()):
            raise AssertionError(f"phase 10: a read-only pump launched {counts}")
        for k, c in counts.items():
            self.launches[k] += c
        if not rep.committed_keys and not rep.expired:
            return
        formed = clock.t.get("formed", t0)
        step = clock.t.get("step", t1)
        rec = dict(tick=t, update=update, requests=len(rep.committed_keys), ops=rep.n_ops,
                   formation=(formed - t0) * 1e3, step=(step - formed) * 1e3,
                   resolution=(t1 - step) * 1e3)
        line = (f"  {self.label} pump at tick {t} ({'update' if update else 'read-only'}): "
                f"{rec['requests']} requests, {rec['ops']} ops committed, {rep.expired} "
                f"expired; host ms formation {rec['formation']:.3f}, index.step "
                f"{rec['step']:.3f} (synced), resolution {rec['resolution']:.3f}")
        if update:
            wal = idx._durable.last_append
            rec.update(wal_bytes=wal["bytes"], fsync_ms=wal["append_fsync_s"] * 1e3)
            line += (f"; WAL record {wal['bytes']} B, append + fsync "
                     f"{rec['fsync_ms']:.3f} ms; launches {counts}")
        self.pumps.append(rec)
        log(f"{line} ({self.smi})")

    def summary(self) -> None:
        m = self.gw.metrics
        ups = [p for p in self.pumps if p["update"]]
        lat = np.asarray(self.latency)
        parts = ", ".join(f"{k} median {median(p[k] for p in self.pumps):.3f}"
                          for k in ("formation", "step", "resolution"))
        log(f"  {self.label}: {len(self.pumps)} pumps over {self.ticks} ticks ({len(ups)} "
            f"update); goodput {m['committed_requests'] / self.ticks:.1f} requests a tick "
            f"({m['committed_requests']} committed, {m['committed_ops']} ops; submitted "
            f"{m['submitted']}, duplicates {m['duplicates']}); shed by code {m['rejected']}, "
            f"expired at formation {m['expired']}; queued latency p50 "
            f"{np.percentile(lat, 50):.1f}, p99 {np.percentile(lat, 99):.1f} ticks; host ms "
            f"per pump: {parts}" + (
                f"; WAL record median {median(p['wal_bytes'] for p in ups):.0f} B, append + "
                f"fsync median {median(p['fsync_ms'] for p in ups):.3f} ms"
                if ups else "") + f" ({self.smi})")


def make_gateway(idx, clock, traffic):
    from repro_torch.serve import Gateway

    # each tenant's token bucket refills at its share of the offered ops a
    # tick and holds one tick of them: the hot tenant's bursts, the
    # duplicating clients' Poisson spread and the retries overdraw it
    rate = GATEWAY_LOAD * GATEWAY_BATCH_OPS / GATEWAY_TENANTS
    gw = Gateway(idx, max_batch_ops=GATEWAY_BATCH_OPS, max_queue_ops=GATEWAY_QUEUE_OPS,
                 dedup_window=GATEWAY_DEDUP, max_pages=SERVE_PAGES,
                 range_budget=GATEWAY_RANGE_BUDGET, default_rate=rate,
                 default_burst=rate, crash_hook=clock)
    for c in range(GATEWAY_TENANTS):
        gw.register_tenant(traffic.tenant(c), weight=3.0 if c == 0 else 1.0)
    return gw


def phase_gateway(dev, smi):
    """The multi-tenant exactly-once gateway over the durable index at
    phase 6's size, through a crash between commit and acknowledgement:
    ``serve_build``'s content made durable in a temporary directory
    (deleted at the end) and opened by ``KVPageIndex(durability_dir=...,
    snapshot_window=2)``; :class:`GatewayTraffic` through a ``Gateway``
    until the 12th update pump crashes at ``gateway.step.done``; a new index
    and gateway on the directory, and every client sending all its
    requests again from tick 0.  Every read equals the host model, no key
    commits twice, the crashed pump's keys resolve as duplicates, and the
    recovered and final indexes hold the model's live pairs."""
    import tempfile

    from repro_torch.checkpoint import DurableFliX, LocalEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import KVPageIndex

    torch.cuda.reset_peak_memory_stats()
    geometry = dict(node_size=32, nodes_per_bucket=16)
    index_kw = dict(**geometry, snapshot_window=2, device=dev)
    traffic = GatewayTraffic(SEED + 10)
    with tempfile.TemporaryDirectory(prefix="flix-gateway-") as tmp:
        d = Path(tmp) / "index"
        built = serve_build(dev)
        dur, create_ms = host_ms(
            lambda: DurableFliX.create(d, built, engine=LocalEngine(**geometry, device=dev)))
        dur.close()
        del built, dur
        clock = PumpClock(crash_at=GATEWAY_CRASH_PUMP)
        idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw, durability_dir=d))
        clock.index = idx
        log(f"phase 10: gateway over a durable KVPageIndex of {idx.live_pages()} page keys, "
            f"nb={idx.state.num_buckets}; durable history created in {create_ms / 1e3:.3f} s, "
            f"opened in {open_ms / 1e3:.3f} s; {GATEWAY_CLIENTS} clients, "
            f"{traffic.rate:.2f} fresh requests a client a tick (offered {GATEWAY_LOAD}x of "
            f"{GATEWAY_BATCH_OPS} ops a pump) ({smi})")
        first = GatewayRun("first run", make_gateway(idx, clock, traffic), idx, clock,
                           traffic, smi)
        try:
            first.run()
            raise AssertionError("phase 10: the crash hook never fired")
        except Crash as e:
            log(f"  crash at {e} (tick {first.ticks}): committed and durable at seq "
                f"{idx.durable_seq}, never acknowledged")
        first.summary()
        crashed_seq = idx.durable_seq
        if len(set(first.commit_log)) != len(first.commit_log):
            raise AssertionError("phase 10: a key committed twice in the first run")
        launches = dict(first.launches)
        metrics = [first.gw.metrics]
        first.gw = first.idx = clock.index = idx = None  # dropped without close()

        reset_launches()
        idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw, durability_dir=d))
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        log(recovery_line("after the crash", idx._durable, open_ms, smi))
        if idx.durable_seq != crashed_seq or counts["flix_apply_staged"] != idx._durable.replayed:
            raise AssertionError(f"phase 10: recovered seq {idx.durable_seq} of {crashed_seq}, "
                                 f"replay launches {counts}")
        for k, c in counts.items():
            launches[k] += c
        trail = idx.dedup_seed()
        last_seq, last_meta = trail[-1]
        trail_keys = [k for _, meta in trail for k in meta["keys"]]
        if last_seq != crashed_seq or not set(first.update_keys) <= set(trail_keys):
            raise AssertionError("phase 10: an acknowledged update is missing from the trail")
        for key in last_meta["keys"]:
            traffic.apply(first.tickets[key].request)
        traffic.versions = {0: traffic.slots.copy()}
        traffic.check_live_pairs("recovered", idx.state)

        clock = PumpClock()
        clock.index = idx
        second = GatewayRun("after recovery", make_gateway(idx, clock, traffic), idx, clock,
                            traffic, smi)
        second.run()
        second.summary()
        log_keys = trail_keys + second.commit_log
        if len(set(log_keys)) != len(log_keys):
            raise AssertionError("phase 10: a key committed twice over the trail and the "
                                 "post-recovery log")
        for key in last_meta["keys"]:
            tk = second.tickets[key]
            if not (tk.ok and tk.duplicate and tk.commit_seq == crashed_seq):
                raise AssertionError(f"phase 10: the crashed pump's key {key} did not resolve "
                                     "as a duplicate")
        metrics.append(second.gw.metrics)
        for m in metrics:
            if m["restructure_retries"] or m["engine_failures"]:
                raise AssertionError(f"phase 10: {m}")
            if not (m["rejected"].get("QUEUE_FULL") and m["rejected"].get("RATE_LIMITED")):
                raise AssertionError(f"phase 10: no QUEUE_FULL or RATE_LIMITED shed: {m}")
        traffic.check_live_pairs("final", idx.state)
        second.gw.close(now=float(second.ticks))
        for k, c in second.launches.items():
            launches[k] += c
        log(f"  {len(last_meta['keys'])} keys of the crashed pump resolved as duplicates; no "
            f"key committed twice over {len(trail_keys)} keys of the trail and "
            f"{len(second.commit_log)} committed after recovery; launches {launches}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


def state_on_cpu(state):
    """A copy of ``state`` on the CPU."""
    from repro_torch.core.state import FliXState

    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(FliXState)}
    return FliXState(**{k: None if v is None else v.cpu() for k, v in fields.items()})


def tiered_line(tiered) -> str:
    """A tiered apply's parts from ``TieredFliX.last_timings``: the packed
    pass is the fused path on an update batch, the reference engine on a
    read-only step."""
    t = tiered.last_timings
    return (f"touched {t['touched']}, working set {t['working_set']} (padded {t['padded']}); "
            f"host ms: touched_buckets {t['touched_ms']:.3f}, page-in {t['sync_ms'] + t['gather_ms']:.3f} "
            f"(sync {t['sync_ms']:.3f} + gather {t['gather_ms']:.3f}), packed pass "
            f"{t['pass_ms']:.3f} by CUDA events ({t['pass_host_ms']:.3f} host), meta refresh "
            f"{t['meta_ms']:.3f}, page-out {t['page_out_ms']:.3f}")


def residency_line(stats) -> str:
    return (f"promoted {int(stats['promoted'])}, demoted {int(stats['demoted'])}, resident "
            f"{int(stats['resident_bytes'])} B")


def check_tiered(label, got, want, counts=None):
    """A tiered batch against the single-tier engine on the same batch:
    results and the shared stats equal; with ``counts``, the committed batch
    ran the fused path's stripe kernel and its fence rows."""
    results, stats, _ = got
    _, want_results, want_stats = want
    for k in want_results:
        if not torch.equal(results[k], want_results[k]):
            raise AssertionError(f"{label}: result {k} differs from the single-tier engine")
    for k in TIERED_SHARED_STATS:
        if int(stats[k]) != int(want_stats[k]):
            raise AssertionError(f"{label}: stat {k}: {int(stats[k])} != {int(want_stats[k])}")
    if counts is not None and min(counts["flix_apply_staged"], counts["flix_fence_rows"]) < 1:
        raise AssertionError(f"{label}: a committed tiered batch did not launch the stripe "
                             f"kernel and the fence rows: {counts}")


def check_tiered_state(label, tiered, state):
    """The tiered index's synced mirror against a single-tier state (the
    parity contract: vals at live slots), and I7."""
    from repro_torch import core

    check_same_state(label, tiered.host_view(), state_on_cpu(state))
    core.check_tiered_invariants(tiered)


def local_batch(state, buckets, rng):
    """Ops confined to the adjacent ``buckets`` of ``state``: fresh keys
    inserted into each, half its live keys deleted and the rest read, and
    one RANGE from the first bucket's lowest key to the last's highest."""
    from repro_torch import core

    mkba = state.mkba.cpu().numpy().astype(np.int64)
    tags, keys = [], []
    for b in buckets:
        lo, hi = int(mkba[b - 1]) + 1, int(mkba[b])
        live = state.keys[b].reshape(-1).cpu().numpy()
        live = live[live != core.EMPTY]
        fresh = np.setdiff1d(rng.integers(lo, hi + 1, 8), live)
        for tag, k in ((core.OP_INSERT, fresh), (core.OP_DELETE, live[::2][:4]),
                       (core.OP_POINT, live[1::2][:4])):
            tags.append(np.full(len(k), tag, np.int32))
            keys.append(k)
    lo, hi = int(mkba[buckets[0] - 1]) + 1, int(mkba[buckets[-1]])
    tags.append(np.array([core.OP_RANGE], np.int32))
    keys.append(np.array([lo]))
    keys = np.concatenate(keys).astype(np.int32)
    vals = (keys * 3).astype(np.int32)
    vals[-1] = hi
    return np.concatenate(tags), keys, vals


def phase_tiered_small(dev):
    """Phase 3i: ``TieredFliX`` on the card against ``apply_ops_safe`` on a
    single-tier copy, exactly, with I7 after every batch: at 2^18 keys in
    the default geometry under three budgets (unbounded, a tenth, one
    bucket) over phase 3a's mixed and boundary batches and two batches
    confined to one bucket and to two (packed states of 1 and 2 buckets
    through the fused path); a read-only batch that must leave the mirror's
    bytes as they were; then an overflow that grows and replays at 4-key
    nodes, 2 a bucket, and ``compact()`` after most keys are deleted."""
    from repro_torch import core
    from repro_torch.checkpoint import canonical_state_bytes
    from repro_torch.kernels import LAUNCHES, reset_launches

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)  # phase 3a's draws
    cfg = core.ExecConfig(max_results=8192)
    traffic = Traffic(1 << 21, 1 << 18, gen)
    base = core.build(*traffic.initial())
    batches = [traffic.mixed(1 << 16) for _ in range(4)] + [traffic.boundary()]
    full = base.memory_bytes()
    log(f"phase 3i: TieredFliX at 2^18 keys, nb={base.num_buckets}, {full} B single-tier")

    def run(label, tiered, oracle, tags, keys, vals, *, safe=True):
        ops, _ = core.make_ops(tags, keys, vals)
        reset_launches()
        got = tiered.apply(ops, config=cfg)
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        want = (core.apply_ops_safe if safe else core.apply_ops)(
            oracle, ops, config=cfg.replace(donate=False))  # the next budget starts from base
        check_tiered(label, got, want, counts)
        if int(got[1]["restructure_retries"]) != int(want[2].get("restructure_retries", 0)):
            raise AssertionError(f"{label}: retries {got[1]} != {want[2]}")
        check_tiered_state(label, tiered, want[0])
        return want[0], got

    for name, budget in (("unbounded", None), ("a tenth", full // 10), ("one bucket", 1)):
        rng = np.random.default_rng(SEED + 9)
        tiered = core.TieredFliX.from_state(base, budget_bytes=budget)
        oracle = base
        widths = []
        for i, (tags, keys, vals) in enumerate(batches):
            oracle, _ = run(f"3i {name} batch {i}", tiered, oracle, tags, keys, vals)
            widths.append(tiered.last_timings["working_set"])
        live = oracle.node_count.sum(1).cpu().numpy()
        pairs = np.nonzero((live[1:-2] > 4) & (live[2:-1] > 4))[0] + 1
        b = int(pairs[len(pairs) // 2])
        # under one bucket: the first batch pages b in beside the resident
        # bucket, the second finds b alone resident (a packed state of one
        # bucket), the third adds b + 1 (two)
        for width, buckets in ((None, [b]), (1, [b]), (2, [b, b + 1])):
            oracle, got = run(f"3i {name} batch in buckets {buckets}", tiered, oracle,
                              *local_batch(oracle, buckets, rng))
            widths.append(tiered.last_timings["working_set"])
            if budget == 1 and width is not None and widths[-1] != width:
                raise AssertionError(f"3i {name}: working set {widths[-1]}, not {width}")
        if budget is not None and tiered.memory_bytes_resident() > max(budget, tiered.bucket_bytes):
            raise AssertionError(f"3i {name}: resident bytes over the budget")
        # a read-only batch: pages move, the logical content does not
        before = canonical_state_bytes(tiered.host_view())
        q = oracle.keys[oracle.keys != core.EMPTY][:: 97].to(torch.int32)
        tags = torch.where(torch.arange(q.numel(), device=dev) % 2 == 0, core.OP_POINT,
                           core.OP_SUCCESSOR).to(torch.int32)
        ops, _ = core.make_ops(tags, q)
        got = tiered.apply(ops, config=cfg, commit=False)
        check_tiered(f"3i {name} read-only", got, core.apply_ops(oracle, ops, config=cfg))
        if canonical_state_bytes(tiered.host_view()) != before:
            raise AssertionError(f"3i {name}: a read-only batch changed the mirror")
        core.check_tiered_invariants(tiered)
        log(f"  budget {name}: 8 batches and a read-only one equal the single-tier engine, "
            f"I7 after each; working sets {widths}; promoted {tiered.promoted_total}, demoted "
            f"{tiered.demoted_total}, resident {tiered.memory_bytes_resident()} B")
        if budget == 1 and not tiered.demoted_total:
            raise AssertionError("3i: the one-bucket budget never paged out")
        del tiered

    keys = torch.arange(0, 640, 10, dtype=torch.int32, device=dev)  # phase 3c's flood
    state = core.build(keys, keys, node_size=4, nodes_per_bucket=2)
    tiered = core.TieredFliX.from_state(state, budget_bytes=state.memory_bytes() // 10)
    flood = torch.arange(1, 200, 2, dtype=torch.int32, device=dev)
    tags = torch.cat([torch.full((flood.numel(),), core.OP_INSERT, dtype=torch.int32,
                                 device=dev),
                      torch.full((keys.numel(),), core.OP_SUCCESSOR, dtype=torch.int32,
                                 device=dev)])
    state, got = run("3i overflow", tiered, state, tags, torch.cat([flood, keys + 3]),
                     torch.cat([flood * 7, torch.zeros_like(keys)]))
    if not got[2]:
        raise AssertionError("3i: the flood did not grow and replay")
    grown = tiered.geometry
    live = torch.cat([keys, flood])
    dels = live[: live.numel() * 9 // 10]
    state, _ = run("3i delete 90%", tiered, state,
                   torch.full((dels.numel(),), core.OP_DELETE, dtype=torch.int32, device=dev),
                   dels, torch.zeros_like(dels))
    want, want_reclaimed = core.restructure_shrink(state)
    reclaimed = tiered.compact()
    if reclaimed != want_reclaimed or reclaimed <= 0:
        raise AssertionError(f"3i compact: reclaimed {reclaimed} != {want_reclaimed}")
    check_tiered_state("3i compact", tiered, want)
    log(f"  overflow at 4-key nodes, 2 a bucket: grew and replayed into geometry {grown}, "
        f"as apply_ops_safe does; after 90% deleted, compact() reclaimed {reclaimed} B into "
        f"geometry {tiered.geometry}, as restructure_shrink does; I7 after each")


def tiered_window_batches(rng, read_frac: float, dev) -> list:
    """``benchmarks/tiered_scale.py``'s batches at ``TIERED_BATCH`` ops: a hot
    window of ``TIERED_HOT`` of the key space, moved by half its width each
    batch; reads (POINT 70%, SUCCESSOR 30%) uniform in the window, the rest
    INSERTs of odd (absent) keys of the window."""
    from repro_torch import core

    span = 2 * TIERED_KEYS
    width = max(64, int(span * TIERED_HOT))
    out = []
    for t in range(TIERED_ROUNDS):
        lo = (t * width // 2) % max(1, span - width)
        n_read = int(TIERED_BATCH * read_frac)
        n_ins = TIERED_BATCH - n_read
        reads = rng.integers(lo, lo + width, n_read)
        odd = lo | 1
        ins = odd + 2 * rng.choice((lo + width - odd + 1) // 2, n_ins, replace=False)
        keys = np.concatenate([reads, ins]).astype(np.int32)
        tags = np.concatenate([
            rng.choice(np.array([core.OP_POINT, core.OP_SUCCESSOR], np.int32), n_read,
                       p=[0.7, 0.3]),
            np.full(n_ins, core.OP_INSERT, np.int32),
        ])
        out.append(core.make_ops(tags, keys, (keys * 3 + t).astype(np.int32), device=dev)[0])
    return out


def tiered_sums(parts: list[dict]) -> str:
    """A sweep's tiered parts summed over its batches (ms)."""
    keys = ("touched_ms", "sync_ms", "gather_ms", "pass_ms", "meta_ms", "page_out_ms")
    return ", ".join(f"{k[:-3]} {sum(t[k] for t in parts):.1f}" for k in keys)


def phase_tiered(dev, smi):
    """Phase 11a: the tiered engine at the paper's smallest build, 2^24 even
    keys (vals = keys >> 1) in 2^20 buckets of 16 32-key nodes, under
    ``benchmarks/tiered_scale.py``'s traffic at two read points and two
    budgets (the whole index, and a tenth of it).  Per read point and
    budget, as the benchmark does: a first sweep, checked (every batch
    equal to ``apply_ops`` on a single-tier copy on the card; at its end the
    host view's canonical bytes equal to the copy's, and I7), then
    ``TIERED_TIMED_SWEEPS`` more on fresh tiered copies, each batch's
    results held to the first sweep's single-tier ones; goodput is the best
    of those.  Every batch launches the stripe kernel and the fence rows,
    and at 10x stays within the budget."""
    from repro_torch import core
    from repro_torch.checkpoint import canonical_state_bytes
    from repro_torch.kernels import LAUNCHES, reset_launches

    keys = torch.arange(0, 2 * TIERED_KEYS, 2, dtype=torch.int32, device=dev)
    base, build_ms = host_ms(lambda: core.build(keys, keys >> 1, node_size=32,
                                                nodes_per_bucket=16))
    del keys
    full = base.memory_bytes()
    budget10 = full // TIERED_OVERSUB
    log(f"phase 11a: tiered engine on {TIERED_KEYS} keys, nb={base.num_buckets}, {full} B "
        f"single-tier (built in {build_ms:.1f} ms); budgets 1x (None) and "
        f"{TIERED_OVERSUB}x ({budget10} B); sweeps of {TIERED_ROUNDS} batches of "
        f"{TIERED_BATCH} ops over a {TIERED_HOT:.0%} hot window ({smi})")
    rng = np.random.default_rng(SEED + 11)
    launches = {k: 0 for k in SERVE_KERNELS}

    def run_batch(label, tiered, ops, want, budget):
        reset_launches()
        got, ms = host_ms(lambda: tiered.apply(ops))
        counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
        check_tiered(label, got, want, counts)
        if budget is not None and int(got[1]["resident_bytes"]) > budget:
            raise AssertionError(f"{label}: resident bytes over the budget")
        for k, c in counts.items():
            launches[k] += c
        return got, ms

    for point, read_frac in TIERED_POINTS:
        batches = tiered_window_batches(rng, read_frac, dev)
        goodput = {}
        for oversub, budget in ((1, None), (TIERED_OVERSUB, budget10)):
            label = f"11a {point} {oversub}x"
            tiered, adopt_ms = host_ms(lambda: core.TieredFliX.from_state(base,
                                                                          budget_bytes=budget))
            log(f"  {label}: from_state (one full page-out into page-locked memory) "
                f"{adopt_ms:.1f} ms")
            oracle, wants, engine_ms = base, [], 0.0
            for t, ops in enumerate(batches):
                want = core.apply_ops(oracle, ops)
                oracle = want[0]
                wants.append((None, want[1], want[2]))
                got, ms = run_batch(f"{label} batch {t}", tiered, ops, want, budget)
                engine_ms += ms
                log(f"    batch {t}: {ms:.3f} ms; {residency_line(got[1])}; "
                    f"{tiered_line(tiered)}")
            got_bytes, canon_ms = host_ms(lambda: canonical_state_bytes(tiered.host_view()))
            if got_bytes != canonical_state_bytes(oracle):
                raise AssertionError(f"{label}: the host view's canonical bytes differ")
            _, inv_ms = host_ms(lambda: core.check_tiered_invariants(tiered))
            if budget is not None and not tiered.demoted_total:
                raise AssertionError(f"{label}: nothing was paged out")
            log(f"  {label}, checked sweep: {TIERED_ROUNDS * TIERED_BATCH / engine_ms * 1e3:.0f} "
                f"ops/s ({engine_ms:.1f} ms); promoted {tiered.promoted_total}, demoted "
                f"{tiered.demoted_total}, resident {tiered.memory_bytes_resident()} B; host "
                f"view's canonical bytes equal the single-tier copy's ({canon_ms:.0f} ms on the "
                f"host), I7 holds ({inv_ms:.0f} ms)")
            del tiered, oracle, want, got
            rates = []
            for r in range(TIERED_TIMED_SWEEPS):
                tiered = core.TieredFliX.from_state(base, budget_bytes=budget)
                engine_ms, parts = 0.0, []
                for t, ops in enumerate(batches):
                    _, ms = run_batch(f"{label} sweep {r + 2} batch {t}", tiered, ops, wants[t],
                                      budget)
                    engine_ms += ms
                    parts.append(tiered.last_timings)
                rates.append(TIERED_ROUNDS * TIERED_BATCH / engine_ms * 1e3)
                log(f"  {label}, sweep {r + 2}: {rates[-1]:.0f} ops/s ({engine_ms:.1f} ms; "
                    f"{tiered_sums(parts)}); promoted {tiered.promoted_total}, demoted "
                    f"{tiered.demoted_total}")
                del tiered
            goodput[oversub] = max(rates)
        log(f"  {point}: tiered_degradation_ratio = goodput({TIERED_OVERSUB}x) / goodput(1x) = "
            f"{goodput[TIERED_OVERSUB]:.0f} / {goodput[1]:.0f} = "
            f"{goodput[TIERED_OVERSUB] / goodput[1]:.3f} ({smi})")
    log(f"  launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def tiered_open_line(label, dur, ms, smi) -> str:
    t = dur.timings
    return (f"  {label}: recovered seq {dur.seq} in {ms / 1e3:.3f} s: chain load "
            f"{t['chain_load_s']:.3f} s, host build {t['rebuild_s']:.3f} s, replay of "
            f"{dur.replayed} records {t['replay_s']:.3f} s ({smi})")


def phase_tiered_durable(dev, smi):
    """Phase 11b: durable tiered serving with cold-tier recovery.
    ``serve_build``'s content made durable (``LocalEngine``) in a temporary
    directory, opened by ``KVPageIndex(device_budget=full // 10,
    durability_dir=...)`` with ``TieredFliX.materialize`` rigged to raise
    for the whole phase; phase 6's step mix at ``TIERED_SERVE``'s sizes from
    a hot set of ``TIERED_HOT_SEQS`` sequences, each step held against a
    single-tier reference-engine index; a crash at the
    ``TIERED_CRASH_COMMIT``-th commit's ``wal.append.partial``; a cold
    reopen onto the oracle's canonical bytes; the remaining steps."""
    import tempfile

    from repro_torch import core
    from repro_torch.checkpoint import DurableFliX, LocalEngine, canonical_state_bytes
    from repro_torch.core.residency import TieredFliX
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import KVPageIndex

    geometry = dict(node_size=32, nodes_per_bucket=16)
    launches = {k: 0 for k in SERVE_KERNELS}
    materialize = TieredFliX.materialize

    def refuse(self):
        raise AssertionError("phase 11b: the whole index materialized on the card")

    with tempfile.TemporaryDirectory(prefix="flix-tiered-") as tmp:
        d = Path(tmp) / "index"
        built = serve_build(dev)
        budget = built.memory_bytes() // TIERED_OVERSUB
        dur, create_ms = host_ms(
            lambda: DurableFliX.create(d, built, engine=LocalEngine(**geometry, device=dev)))
        dur.close()
        del built, dur
        index_kw = dict(**geometry, durability_dir=d, snapshot_every=DURABLE_SNAPSHOT_EVERY,
                        device_budget=budget, device=dev)
        TieredFliX.materialize = refuse
        try:
            hook = CrashAt("wal.append.partial", TIERED_CRASH_COMMIT)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw, crash_hook=hook))
            grew = torch.cuda.max_memory_allocated() - before
            log(f"phase 11b: durable history of {idx.live_pages()} page keys created in "
                f"{create_ms / 1e3:.3f} s; tiered open with budget {budget} B "
                f"({idx.state.budget_buckets} buckets), device peak {grew} B over what was "
                f"allocated before it")
            log(tiered_open_line("KVPageIndex(device_budget=..., durability_dir=...)",
                                 idx._durable, open_ms, smi))
            if grew > TIERED_OPEN_SLACK:
                raise AssertionError(f"phase 11b: the open allocated {grew} B on the card")
            oracle = KVPageIndex(**geometry, config=core.ExecConfig(impl="reference"),
                                 device=dev)
            oracle.state = serve_build(dev)
            traffic = ServeTraffic(SEED + 12, mix=serve_mix(**TIERED_SERVE),
                                   hot=TIERED_HOT_SEQS)

            def serve(i, step, label):
                read_only = step["read_only"]
                if not read_only:
                    ServeTraffic.fullest(step, idx.state)
                reset_launches()
                got, ms = host_ms(lambda: idx.step(**step["kw"]))
                counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
                check_same_step(f"{label} {i}", got, oracle.step(**step["kw"]))
                traffic.check(step, got)
                if read_only:
                    if any(counts.values()):
                        raise AssertionError(f"{label} {i}: a read-only step launched {counts}")
                else:
                    check_update_launches(f"{label} {i}", counts)
                    assert int(got.stats["restructure_retries"]) == 0, got.stats
                if idx.resident_bytes > budget:
                    raise AssertionError(f"{label} {i}: resident bytes over the budget")
                for k, c in counts.items():
                    launches[k] += c
                log(f"  {label} {i} ({'read' if read_only else 'update'}, durable seq "
                    f"{idx.durable_seq}): {ms:.3f} ms; {residency_line(got.stats)}; "
                    f"{tiered_line(idx.state)}")
                if not read_only and idx.durable_seq % DURABLE_SNAPSHOT_EVERY == 0:
                    log(snapshot_line(f"seq {idx.durable_seq}", idx._durable.last_timings, smi,
                                      where="on the host"))

            crash_step, i = None, 0
            while crash_step is None:
                step = traffic.step(i)
                try:
                    serve(i, step, "step")
                except Crash:
                    crash_step = step
                    break
                i += 1
            acked = idx.durable_seq
            if acked != TIERED_CRASH_COMMIT - 1:
                raise AssertionError(f"phase 11b: crashed after {acked} commits")
            idx = None  # dropped without close(), as a dead process leaves it
            want_bytes = canonical_state_bytes(oracle.state)

            reset_launches()
            idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw))
            counts = {k: LAUNCHES[k] for k in SERVE_KERNELS}
            log(tiered_open_line("cold reopen after the crash", idx._durable, open_ms, smi))
            if idx.durable_seq != acked or idx._durable.replayed < 1:
                raise AssertionError(f"phase 11b: recovered seq {idx.durable_seq} of {acked}")
            check_update_launches("phase 11b replay", counts)
            for k, c in counts.items():
                launches[k] += c
            got_bytes, canon_ms = host_ms(lambda: canonical_state_bytes(idx.state.host_view()))
            if got_bytes != want_bytes:
                raise AssertionError("phase 11b: the recovered host view's bytes differ")
            core.check_tiered_invariants(idx.state)
            log(f"  replay launches {counts}; the host view's canonical bytes at seq {acked} "
                f"equal the oracle's ({canon_ms:.0f} ms on the host); I7 holds")
            for j in range(TIERED_AFTER):
                step = crash_step if j == 0 else traffic.step(crash_step["i"] + j)
                serve(crash_step["i"] + j, step, "step after recovery")
            if canonical_state_bytes(idx.state.host_view()) != canonical_state_bytes(oracle.state):
                raise AssertionError("phase 11b: the final bytes differ from the oracle's")
            idx.close()
        finally:
            TieredFliX.materialize = materialize
    log(f"  launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


SHARD_KERNELS = ("flix_apply_staged", "flix_fence_rows")


def shard_slice(state, s: int, nb_s: int):
    """Buckets ``[s * nb_s, (s + 1) * nb_s)`` of a single-device state: the
    part of it that shard ``s`` holds."""
    from repro_torch.core.state import FliXState

    rows = slice(s * nb_s, (s + 1) * nb_s)
    fields = {f: getattr(state, f)[rows] for f in
              ("keys", "vals", "node_count", "node_max", "num_nodes", "mkba")}
    exps = None if state.exps is None else state.exps[rows]
    return FliXState(**fields, needs_restructure=state.needs_restructure, exps=exps)


def check_sharded(label, got, want, *, same_geometry: bool = True):
    """A sharded call (``(idx, results, stats)``) against ``apply_ops`` on
    one state: results and the shared stats equal; at the same union
    geometry every shard's slice equal to the state's (vals at live slots,
    the expiry plane whole), else the live pairs equal."""
    from repro_torch.checkpoint import canonical_state_bytes
    from repro_torch.core import distributed as dist

    gi, gr, gst = got
    ws, wr, wst = want
    for k in wr:
        if not torch.equal(gr[k], wr[k]):
            raise AssertionError(f"{label}: result {k} differs from the single-device engine")
    for k in TIERED_SHARED_STATS + ("expired",):
        if k in wst and int(gst[k]) != int(wst[k]):
            raise AssertionError(f"{label}: stat {k}: {int(gst[k])} != {int(wst[k])}")
    if not same_geometry:
        if canonical_state_bytes(dist.shard_union(gi, ws.device)) != canonical_state_bytes(ws):
            raise AssertionError(f"{label}: the live pairs differ from the single-device engine")
        return
    if gi.geometry != ws.geometry:
        raise AssertionError(f"{label}: geometry {gi.geometry} != {ws.geometry}")
    nb_s = gi.states[0].num_buckets
    for s, st in enumerate(gi.states):
        part = shard_slice(ws, s, nb_s)
        check_same_state(f"{label}, shard {s}", st, part)
        if (st.exps is None) != (part.exps is None) or (
                part.exps is not None and not torch.equal(st.exps, part.exps)):
            raise AssertionError(f"{label}, shard {s}: the expiry plane differs")


def check_shard_launches(label, counts, n_shards: int, passes: int):
    """A sharded update call launches the stripe kernel once a shard for
    each pass (a plane, a replay), and the fence rows with it; nothing
    else."""
    want = {k: n_shards * passes for k in SHARD_KERNELS}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def shard_mixed_host(rng, keys, *, space=SHARD_SMALL_SPACE, n_ins=128, n_del=128, n_pt=384,
                     n_sc=384, n_rg=64, span=2_000):
    """``tests/test_shard_engine.py``'s ``_mixed_batch`` on the host: fresh
    inserts, live deletes, points and successors over and past the key
    space, RANGE ops wide enough to cross shard fences, and one RANGE over
    the whole key space."""
    from repro_torch import core

    absent = np.setdiff1d(rng.integers(0, space + 20_000, 4096).astype(np.int32), keys)
    n_ins = min(n_ins, absent.size)
    los = rng.integers(0, space, n_rg - 1).astype(np.int32)
    his = (los + rng.integers(1, span, n_rg - 1)).astype(np.int32)
    tags = np.concatenate([np.full(n_ins, core.OP_INSERT), np.full(n_del, core.OP_DELETE),
                           np.full(n_pt, core.OP_POINT), np.full(n_sc, core.OP_SUCCESSOR),
                           np.full(n_rg, core.OP_RANGE)]).astype(np.int32)
    bk = np.concatenate([absent[:n_ins], rng.choice(keys, n_del, replace=False),
                         rng.integers(0, space + 20_000, n_pt + n_sc), los, [0]])
    bv = np.concatenate([np.arange(n_ins) + 7_000_000, np.zeros(n_del + n_pt + n_sc),
                         his, [space + 20_000]])
    return tags, bk.astype(np.int32), bv.astype(np.int32)


def phase_shard_small(dev):
    """Phase 3j: the sharded engine (``repro_torch.core.distributed``) on the
    card, exactly, at 2 and 4 shards on one card: ``SHARD_SMALL_KEYS`` keys
    from a ``SHARD_SMALL_SPACE`` key space (16-key nodes, 8 a bucket), each
    call held against ``apply_ops`` on one state of the union geometry on
    the card (the union of the fresh index): the mixed batch of
    ``tests/test_shard_engine.py`` under both routings; an a2a batch at
    capacity 1, its overflow reported, then through shard_apply_ops_safe with
    its capacity retries counted; a clustered insert burst that overflows a
    shard (300 keys past the key space, into the last shard's last bucket)
    and regrows through ``shard_restructure`` (held against
    ``apply_ops_safe``, which regrows its own way: results and live pairs);
    TTL with and without ``now``; a read-only batch and an all-NOP one."""
    from repro_torch import core
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED + 13)
    keys = np.sort(rng.choice(SHARD_SMALL_SPACE, SHARD_SMALL_KEYS, replace=False)).astype(np.int32)
    vals = rng.integers(0, 1 << 30, keys.size).astype(np.int32)
    exps = np.where(rng.random(keys.size) < 0.25, rng.integers(1, 2000, keys.size),
                    int(core.NO_EXPIRY)).astype(np.int32)
    geometry = dict(node_size=16, nodes_per_bucket=8)
    k_t, v_t, e_t = (torch.from_numpy(a).to(dev) for a in (keys, vals, exps))
    n_calls = 0

    def run(label, idx, mesh, ops, cfg, *, safe=False, planes=1, launches=True, **kw):
        nonlocal n_calls
        torch.cuda.synchronize()
        reset_launches()
        fn = dist.shard_apply_ops_safe if safe else dist.shard_apply_ops
        got = fn(idx, ops, mesh, config=cfg, **kw)
        counts = {k: LAUNCHES[k] for k in LAUNCHES}
        if launches:
            replays = got[2].get("a2a_retries", 0) + got[2].get("restructure_retries", 0)
            check_shard_launches(label, counts, mesh.size, planes * (1 + replays))
        elif any(counts.values()):
            raise AssertionError(f"{label}: a read-only call launched {counts}")
        n_calls += 1
        return got

    for S in (2, 4):
        mesh = dist.make_shard_mesh(S, [dev] * S)
        idx = dist.shard_build(k_t, v_t, mesh, **geometry)
        single = dist.shard_union(idx, dev)
        tags, bk, bv = shard_mixed_host(rng, keys)
        ops = core.make_ops(tags, bk, bv, pad_to=2048, device=dev)[0]
        want = core.apply_ops(single, ops, config=core.ExecConfig(max_results=512))
        for routing in ("replicated", "a2a"):
            cfg = core.ExecConfig(routing=routing, max_results=512)
            got = run(f"3j S={S} {routing}", idx, mesh, ops, cfg)
            check_sharded(f"3j S={S} {routing}: mixed batch", got, want)
        # a2a at capacity 1: the overflow is reported; shard_apply_ops_safe
        # doubles its way to the chunk and lands on the same answers
        cfg = core.ExecConfig(routing="a2a", max_results=512, capacity=1)
        _, _, st = run(f"3j S={S} capacity 1", idx, mesh, ops, cfg)
        overflow = int(st["a2a_overflow"])
        got = run(f"3j S={S} capacity 1 (safe)", idx, mesh, ops, cfg, safe=True)
        st = got[2]
        if not (overflow > 0 and st["a2a_retries"] >= 1 and st["a2a_overflow_dropped"] >= overflow
                and int(st["a2a_overflow"]) == 0 and st["restructure_retries"] == 0):
            raise AssertionError(f"3j S={S}: capacity 1: overflow {overflow}, stats {st}")
        check_sharded(f"3j S={S}: a2a after {st['a2a_retries']} capacity retries", got, want)
        log(f"  3j S={S}: the mixed batch equal under both routings; a2a at capacity 1 dropped "
            f"{overflow} rows, shard_apply_ops_safe retried {st['a2a_retries']} times "
            f"({st['a2a_overflow_dropped']} rows dropped in all) to equal answers")
        # a clustered burst: 300 fresh keys past the key space, all in the
        # last shard's last bucket (128 slots), which overflows
        fresh = np.arange(SHARD_SMALL_SPACE, SHARD_SMALL_SPACE + 300, dtype=np.int32)
        bops = core.make_ops(np.full(fresh.size, core.OP_INSERT, np.int32), fresh, fresh * 3,
                             device=dev)[0]
        want_b = core.apply_ops_safe(single, bops, config=core.ExecConfig(donate=False))
        for routing in ("replicated", "a2a"):
            got = run(f"3j S={S} burst {routing}", idx, mesh, bops,
                      core.ExecConfig(routing=routing), safe=True)
            if got[2]["restructure_retries"] != 1 or want_b[2]["restructure_retries"] != 1:
                raise AssertionError(f"3j S={S}: the burst did not regrow ({got[2]})")
            check_sharded(f"3j S={S} {routing}: burst", got, want_b, same_geometry=False)
            core.check_invariants(dist.shard_union(got[0], dev))
        log(f"  3j S={S}: a {fresh.size}-key burst regrew {idx.geometry} -> "
            f"{got[0].geometry} by shard_restructure, fences {got[0].part_fences.tolist()}")
        # read-only and all-NOP batches: the reference engine, no launch
        tags, bk, bv = shard_mixed_host(rng, keys, n_ins=0, n_del=0, n_pt=512, n_sc=512,
                                        n_rg=32)
        rops = core.make_ops(tags, bk, bv, pad_to=1088, device=dev)[0]
        want_r = core.apply_ops(single, rops, config=core.ExecConfig(max_results=256))
        nops = core.make_ops(np.zeros(0, np.int32), np.zeros(0, np.int32), pad_to=64,
                             device=dev)[0]
        want_n = core.apply_ops(single, nops, config=core.ExecConfig())
        for routing in ("replicated", "a2a"):
            cfg = core.ExecConfig(routing=routing, max_results=256)
            check_sharded(f"3j S={S} {routing}: read-only",
                          run("3j read-only", idx, mesh, rops, cfg, launches=False), want_r)
            check_sharded(f"3j S={S} {routing}: all-NOP",
                          run("3j all-NOP", idx, mesh, nops, cfg.replace(max_results=128),
                              launches=False), want_n)
        # TTL: the plane built with the index, a pass at now and none
        tidx = dist.shard_build(k_t, v_t, mesh, **geometry, sorted_exps=e_t)
        tsingle = dist.shard_union(tidx, dev)
        now = 1000
        absent = np.setdiff1d(np.arange(0, SHARD_SMALL_SPACE, 3, dtype=np.int32), keys)
        gs_hit = rng.choice(keys, 48, replace=False)
        ttags = np.concatenate([np.full(96, core.OP_INSERT), np.full(96, core.OP_EXPIRE),
                                np.full(256, core.OP_POINT), np.full(128, core.OP_SUCCESSOR),
                                np.full(16, core.OP_RANGE)]).astype(np.int32)
        tk = np.concatenate([absent[:96], absent[96:144], gs_hit,
                             rng.integers(0, SHARD_SMALL_SPACE, 256 + 128 + 16)]).astype(np.int32)
        tv = np.concatenate([np.arange(96) + 7_000_000, np.arange(96) + 8_000_000,
                             np.zeros(256 + 128), tk[-16:] + 2_000]).astype(np.int32)
        te = np.concatenate([now + rng.integers(-5, 200, 96), now + rng.integers(1, 200, 96),
                             np.full(256 + 128 + 16, int(core.NO_EXPIRY))]).astype(np.int32)
        tops = core.make_ops(ttags, tk, tv, exps=te, pad_to=1024, device=dev)[0]
        expired = None
        for clock in (now, None):
            want_t = core.apply_ops(tsingle, tops, config=core.ExecConfig(max_results=512),
                                    now=clock)
            for routing in ("replicated", "a2a"):
                cfg = core.ExecConfig(routing=routing, max_results=512)
                got = run(f"3j S={S} TTL {routing}", tidx, mesh, tops, cfg, planes=2, now=clock)
                check_sharded(f"3j S={S} {routing}: TTL now={clock}", got, want_t)
            if clock is not None:
                expired = int(want_t[2]["expired"])
                if not expired:
                    raise AssertionError("3j: the expiry pass reclaimed nothing")
        log(f"  3j S={S}: read-only, all-NOP and TTL batches equal (now={now}: {expired} rows "
            f"expired; no clock)")
    log(f"  3j: {n_calls} sharded calls, each equal to apply_ops on the union geometry")


def span_split(events) -> dict:
    """Milliseconds of each ``shard.*`` span over one call's
    ``repro_torch.trace.EVENTS`` triples (CUDA events on one card; the four
    spans follow one another and nest in none of their own kind)."""
    out = {"route": 0.0, "range": 0.0, "apply": 0.0, "combine": 0.0}
    for name, a, b in events:
        if name.startswith("shard."):
            out[name.removeprefix("shard.")] += a.elapsed_time(b)
    return out


def phase_shard(dev, smi):
    """Phase 12a: the sharded engine at full width.  Phase 4's build (the
    same seed: 2^24 uniform keys from a 2^27 space, 32-key nodes, 16 a
    bucket) range-partitioned by ``shard_build`` into ``SHARDS`` shards of
    2^18 buckets on the card, beside phase 4's single-device state; the
    same ``SHARD_BATCHES`` batches of phase 4's mix run first under
    ``"replicated"``, then under ``"a2a"`` (chunks of 2^18, the default
    capacity of 2^17 a pair), each chain from the fresh index, through
    make_ops → ``shard_apply_ops_safe`` → unsort.  Every batch is held
    against make_ops → ``apply_ops_safe`` → unsort on the single state
    (results, stats, every shard's slice), and must launch the stripe
    kernel and the fence rows once a shard for each attempt: a globally
    sorted batch cut into chunks sends a chunk's rows to one or two shards,
    past the 2^17 rows a pair, so ``shard_apply_ops_safe`` replays it at the
    chunk size (its ``a2a_retries``, printed)."""
    from repro_torch import core, trace
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    mesh = dist.make_shard_mesh(SHARDS, [dev] * SHARDS)
    idx0, shard_ms = host_ms(lambda: dist.shard_build(keys, vals, mesh))
    single0, build_ms = host_ms(lambda: core.build(keys, vals, device=dev))
    del keys, vals
    if idx0.geometry != single0.geometry:
        raise AssertionError(f"phase 12a: {idx0.geometry} != {single0.geometry}")
    log(f"phase 12a: {SHARDS} shards of {idx0.states[0].num_buckets} buckets on {dev} "
        f"(union {idx0.geometry}, {dist.shard_memory_bytes(idx0) / 1e9:.3f} GB), shard_build "
        f"{shard_ms:.1f} ms, the single-device build {build_ms:.1f} ms ({smi})")
    batches = [traffic.mixed(FULL_OPS) for _ in range(SHARD_BATCHES)]
    launches = {k: 0 for k in SHARD_KERNELS}
    summary = {}
    for routing in ("replicated", "a2a"):
        cfg = core.ExecConfig(max_results=FULL_MAX_RESULTS, routing=routing)
        idx, single = idx0, single0
        e2e, single_e2e = [], []
        for i, (tags, bkeys, bvals) in enumerate(batches):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            ops, perm = core.make_ops(tags, bkeys, bvals, device=dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trace.EVENTS = events = []
            try:
                new_idx, res, stats = dist.shard_apply_ops_safe(
                    idx, ops, mesh, config=cfg, has_updates=True, has_ranges=True)
                end.record()
                value = core.unsort(res["value"], perm)
                torch.cuda.synchronize()
            finally:
                trace.EVENTS = None
            e2e.append((time.perf_counter() - t0) * 1e3)
            counts = {k: LAUNCHES[k] for k in LAUNCHES}
            # a capacity replay runs every shard's pass again
            check_shard_launches(f"12a {routing} batch {i}", counts, SHARDS,
                                 1 + stats["a2a_retries"])
            for k in launches:
                launches[k] += counts[k]
            if stats["restructure_retries"] or int(stats["a2a_overflow"]):
                raise AssertionError(f"12a {routing} batch {i}: regrew or dropped ({stats})")
            split = span_split(events)
            call_ms = start.elapsed_time(end)
            del events

            def single_batch():
                sops, sperm = core.make_ops(tags, bkeys, bvals, device=dev)
                out = core.apply_ops_safe(single, sops, config=cfg.replace(donate=False))
                return out, core.unsort(out[1]["value"], sperm)

            (want, want_value), ms = host_ms(single_batch)
            single_e2e.append(ms)
            check_sharded(f"12a {routing} batch {i}", (new_idx, res, stats), want)
            if not torch.equal(value, want_value):
                raise AssertionError(f"12a {routing} batch {i}: unsorted values differ")
            log(f"  {routing} batch {i}: {e2e[-1]:.3f} ms ({FULL_OPS / e2e[-1] / 1e3:.3f} "
                f"MOps/s; single-device {ms:.3f} ms); by CUDA events: route "
                f"{split['route']:.3f}, RANGE counts {split['range']:.3f}, apply_ops over the "
                f"shards {split['apply']:.3f}, combine {split['combine']:.3f} ms, together "
                f"{sum(split.values()):.3f} of the call's {call_ms:.3f} ms; launches "
                f"{ {k: counts[k] for k in SHARD_KERNELS} }; a2a_retries "
                f"{stats['a2a_retries']} (rows dropped {stats['a2a_overflow_dropped']}); "
                f"inserted {int(stats['inserted'])} deleted {int(stats['deleted'])} "
                f"range_truncated {int(stats['range_truncated'])}")
            idx, single = new_idx, want[0]
            del want, res, new_idx
        summary[routing] = (median(e2e), median(single_e2e))
        del idx, single
    for routing, (m, s) in summary.items():
        log(f"  {routing}: median {m:.3f} ms a batch, {FULL_OPS / m / 1e3:.3f} MOps/s; "
            f"single-device median {s:.3f} ms, {FULL_OPS / s / 1e3:.3f} MOps/s ({smi})")
    log(f"  launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_shard_durable(dev, smi):
    """Phase 12b: durable sharded serving.  ``serve_build``'s live pairs
    range-partitioned into ``SHARDS`` shards on the card and made durable
    by ``DurableFliX.create`` with a ``ShardEngine``, in a temporary
    directory; opened by ``KVPageIndex(shards=SHARDS, device=..., config=
    ExecConfig(routing="a2a"), durability_dir=..., snapshot_every=4)``;
    ``SHARD_SERVE_STEPS`` of phase 6's steps (no pinned read), each held
    against a single-device index fed the same steps (StepResults; after
    every update step the live pairs, read shard by shard through the
    engine's segments) and timed beside the same step on a sharded index
    without durability; a crash at the ``SHARD_CRASH_COMMIT``-th commit's
    ``wal.append.partial``; a reopen with ``shards=SHARDS`` onto the
    single-device oracle's canonical bytes; ``SHARD_AFTER`` more steps."""
    import tempfile

    from repro_torch import core
    from repro_torch.checkpoint import DurableFliX, ShardEngine, canonical_state_bytes
    from repro_torch.checkpoint.serialize import bucket_segments, pairs_to_bytes
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import KVPageIndex

    torch.cuda.reset_peak_memory_stats()
    geometry = dict(node_size=32, nodes_per_bucket=16)
    cfg = core.ExecConfig(routing="a2a")
    mesh = dist.make_shard_mesh(SHARDS, [dev] * SHARDS)
    launches = {k: 0 for k in SHARD_KERNELS}
    with tempfile.TemporaryDirectory(prefix="flix-sharded-") as tmp:
        d = Path(tmp) / "index"
        built = serve_build(dev)
        want_create = canonical_state_bytes(built)
        _, sk, sv, _ = bucket_segments(built)
        handle, shard_ms = host_ms(lambda: dist.shard_build(
            torch.from_numpy(sk).to(dev), torch.from_numpy(sv).to(dev), mesh, **geometry))
        engine = ShardEngine(mesh, config=cfg, **geometry)
        dur, create_ms = host_ms(lambda: DurableFliX.create(d, handle, engine=engine))
        dur.close()
        del handle, dur, sk, sv
        log(f"phase 12b: {len(want_create)} canonical bytes range-partitioned into {SHARDS} "
            f"shards on {dev} (shard_build {shard_ms:.1f} ms) and made durable by a "
            f"ShardEngine in {create_ms / 1e3:.3f} s")
        index_kw = dict(**geometry, shards=SHARDS, device=dev, config=cfg, durability_dir=d,
                        snapshot_every=DURABLE_SNAPSHOT_EVERY)

        def live_bytes(index):
            _, k, v, e = index._durable.engine.segments(index._durable.handle)
            return pairs_to_bytes(k, v, e)

        hook = CrashAt("wal.append.partial", SHARD_CRASH_COMMIT)
        idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw, crash_hook=hook))
        log(recovery_line("KVPageIndex(shards=4, durability_dir=...)", idx._durable, open_ms,
                          smi))
        if live_bytes(idx) != want_create:
            raise AssertionError("phase 12b: the opened index's live pairs differ")
        log(f"  opened: {idx.state.n_shards} shards, union geometry {idx.state.geometry}")
        oracle = KVPageIndex(**geometry, device=dev)
        oracle.state = built
        del built
        # without durability: the same engine work, a2a at the chunk size
        # as the durable engine runs it (shard_apply_ops_safe's default capacity
        # would replay a sorted step's chunks)
        plain = KVPageIndex(**geometry, shards=SHARDS, device=dev,
                            config=cfg.replace(capacity=FULL_OPS))
        traffic = ServeTraffic(SEED + 4)  # phase 6's steps
        commits, a2a_retries = [], 0

        def serve(i, step, label):
            nonlocal a2a_retries
            kw, read_only = step["kw"], step["read_only"]
            pre = idx.state
            torch.cuda.synchronize()
            reset_launches()
            got, ms = host_ms(lambda: idx.step(**kw))
            counts = {k: LAUNCHES[k] for k in LAUNCHES}
            want = oracle.step(**kw)
            if not torch.equal(got.slots, want.slots):
                raise AssertionError(f"{label} {i}: slots differ from the single-device index")
            for k in want.range_out or {}:
                if not torch.equal(got.range_out[k], want.range_out[k]):
                    raise AssertionError(f"{label} {i}: range {k} differs")
            for k in TIERED_SHARED_STATS + ("expired",):
                if k in want.stats and int(got.stats[k]) != int(want.stats[k]):
                    raise AssertionError(f"{label} {i}: stat {k} differs")
            traffic.check(step, got)
            a2a_retries += int(got.stats.get("a2a_retries", 0))
            line = f"  {label} {i} ({'read' if read_only else 'update'}): {ms:.3f} ms"
            if read_only:
                if any(counts.values()):
                    raise AssertionError(f"{label} {i}: a read-only step launched {counts}")
                log(line + f"; a2a_overflow {int(got.stats['a2a_overflow'])}")
                return
            check_shard_launches(f"{label} {i}", counts, SHARDS, 2)  # value and expiry planes
            assert int(got.stats["restructure_retries"]) == 0, got.stats
            for k in launches:
                launches[k] += counts[k]
            plain.state = pre
            _, plain_ms = host_ms(lambda: plain.step(**kw))
            plain.state = None
            wal = idx._durable.last_append
            commits.append(dict(ms=ms, plain_ms=plain_ms, **wal))
            same, canon_ms = host_ms(
                lambda: live_bytes(idx) == canonical_state_bytes(oracle.state))
            if not same:
                raise AssertionError(f"{label} {i}: live pairs differ from the single-device "
                                     "index")
            log(line + f", without durability {plain_ms:.3f} ms (overhead {ms - plain_ms:.3f} "
                f"ms); durable seq {idx.durable_seq}, WAL record {wal['bytes']} B, append + "
                f"fsync {wal['append_fsync_s'] * 1e3:.3f} ms; a2a_overflow "
                f"{int(got.stats['a2a_overflow'])}; live pairs equal ({canon_ms:.0f} ms); "
                f"launches { {k: counts[k] for k in SHARD_KERNELS} }")
            if idx.durable_seq % DURABLE_SNAPSHOT_EVERY == 0:
                log(snapshot_line(f"seq {idx.durable_seq}", idx._durable.last_timings, smi,
                                  where="shard by shard on the card"))

        crash_step, i = None, 0
        while crash_step is None and i < SHARD_SERVE_STEPS:
            step = traffic.step(i)
            try:
                serve(i, step, "step")
            except Crash:
                crash_step = step
                break
            i += 1
        acked = idx.durable_seq
        if crash_step is None or acked != SHARD_CRASH_COMMIT - 1:
            raise AssertionError(f"phase 12b: crashed after {acked} commits at step {i}")
        idx = None  # dropped without close(), as a dead process leaves it
        want_bytes = canonical_state_bytes(oracle.state)
        reset_launches()
        idx, open_ms = host_ms(lambda: KVPageIndex(**index_kw))
        counts = {k: LAUNCHES[k] for k in LAUNCHES}
        log(recovery_line("reopen after the crash, shards=4", idx._durable, open_ms, smi))
        if idx.durable_seq != acked or idx._durable.replayed < 1:
            raise AssertionError(f"phase 12b: recovered seq {idx.durable_seq} of {acked}")
        if live_bytes(idx) != want_bytes:
            raise AssertionError("phase 12b: the recovered bytes differ from the oracle's")
        for k in launches:
            launches[k] += counts[k]
        log(f"  crash at commit {SHARD_CRASH_COMMIT} (step {i}), wal.append.partial; replay "
            f"launches { {k: counts[k] for k in SHARD_KERNELS} }; canonical bytes at seq "
            f"{acked} equal the single-device oracle's")
        for j in range(SHARD_AFTER):
            step = crash_step if j == 0 else traffic.step(crash_step["i"] + j)
            serve(crash_step["i"] + j, step, "step after recovery")
        idx.close()
        overhead = [c["ms"] - c["plain_ms"] for c in commits]
        log(f"  a2a_retries {a2a_retries}; per update commit: WAL record median "
            f"{median(c['bytes'] for c in commits):.0f} B, append + fsync median "
            f"{median(c['append_fsync_s'] for c in commits) * 1e3:.3f} ms, step median "
            f"{median(c['ms'] for c in commits):.3f} ms against "
            f"{median(c['plain_ms'] for c in commits):.3f} ms without durability (overhead "
            f"median {median(overhead):.3f} ms); launches {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


def lsm_levels(total_keys: int, chunk: int) -> int:
    """Right-sized LSM level count, capacity about twice the final key count
    (``benchmarks/common.py:66-71``, copied: that file imports JAX)."""
    need = max(1, math.ceil(total_keys / chunk))
    return max(3, math.ceil(math.log2(need)) + 2)


def hold_baseline(label, q, want, got, unplaced: int = 0):
    """A baseline's point answers to the queries ``q`` against FliX's on the
    same contents, exactly; a hash table whose inserts left keys unplaced
    may answer NOT_FOUND for at most that many distinct keys, and is
    otherwise held on the keys it placed.  Returns those keys' count."""
    from repro_torch.core.state import NOT_FOUND

    bad = got != want
    if not bool(bad.any()):
        return 0
    missed = int(torch.unique(q[bad]).numel()) if unplaced else -1
    if not unplaced or not bool((got[bad] == NOT_FOUND).all()) or missed > unplaced:
        raise AssertionError(f"{label}: {int(bad.sum())} answers differ from FliX's "
                             f"({unplaced} keys left unplaced)")
    return missed


def phase_baselines(dev, smi):
    """The paper's baselines beside FliX on Fig. 9's schedule
    (``benchmarks/query_qtmf.py:14-80``): FliX at 32 x 16 through
    ``repro_torch.kernels.ops``, the B-tree with its defaults, LSM with
    4096-pair chunks and ``lsm_levels(2n, 4096)`` levels, a hash table of
    ``int(2n / 0.8)`` slots and a sorted array of 2n, each built from phase
    5's 2^24 keys; 4 insert rounds of 2^22 fresh keys, then 4 delete rounds
    of those keys; after each round 2^24 all-hit and 2^24 all-miss point
    queries per structure, each timed by CUDA events (a warm call first),
    with each structure's memory_bytes() and QTMF; after the last round
    2^22 successor queries for FliX, the sorted array and LSM.  Every
    answer is held against FliX's on the same contents.  The baselines are
    plain torch emulations of the paper's, as the reference's are jnp ones.
    Returns FliX's launches."""
    from repro_torch import core
    from repro_torch.core.baselines import btree
    from repro_torch.core.baselines import hash_table as ht
    from repro_torch.core.baselines import lsm
    from repro_torch.core.baselines import sorted_array as sa
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    n = FULL_KEYS
    log(f"phase 13: the baselines beside FliX, Fig. 9's schedule on {n} keys from a "
        f"{FULL_SPACE} key space, rounds of {FIG9_ROUND} keys ({smi})")
    torch.cuda.reset_peak_memory_stats()
    traffic = Traffic(FULL_SPACE, n, gen)
    keys, vals = traffic.initial()
    built = {}
    flix, built["flix"] = host_ms(lambda: core.build(keys, vals))
    bt, built["btree"] = host_ms(lambda: btree.build(keys, vals))
    levels = lsm_levels(2 * n, BASELINE_CHUNK)
    lsmu, built["lsmu"] = host_ms(
        lambda: lsm.insert(lsm.empty_state(BASELINE_CHUNK, levels), keys, vals))
    (h, unplaced), built["hashtable"] = host_ms(
        lambda: ht.insert(ht.empty_state(int(2 * n / BASELINE_LOAD)), keys, vals))
    unplaced = int(unplaced)
    sarr, built["sortedarray"] = host_ms(lambda: sa.build(keys, vals, 2 * n))
    del keys, vals
    log("  builds (host ms, synced): " + ", ".join(f"{k} {v:.1f}" for k, v in built.items())
        + f"; LSM {levels} levels of {BASELINE_CHUNK} x 2^i pairs; hash table "
        f"{h.capacity} slots, {unplaced} keys unplaced")
    pool = traffic.perm[n : n + 4 * FIG9_ROUND]
    names = ("flix_point_query", "flix_successor", "flix_fence_rows", "flix_insert",
             "flix_delete")
    launches = {k: 0 for k in names}
    for rnd in range(8):
        ins = rnd < 4
        chunk = pool[(rnd % 4) * FIG9_ROUND : (rnd % 4 + 1) * FIG9_ROUND]
        upd_k, order = torch.sort(chunk, stable=True)
        upd_v = torch.arange(FIG9_ROUND, dtype=torch.int32, device=dev)[order]
        upd_ms = {}
        reset_launches()
        if ins:
            (flix, overflow), upd_ms["flix"] = host_ms(
                lambda: kops.flix_insert(flix, upd_k, upd_v))
            if int(overflow.max()):
                raise AssertionError(f"baselines round {rnd}: a FliX insert overflowed")
            bt, upd_ms["btree"] = host_ms(lambda: btree.insert(bt, upd_k, upd_v))
            lsmu, upd_ms["lsmu"] = host_ms(lambda: lsm.insert(lsmu, upd_k, upd_v))
            (h, left), upd_ms["hashtable"] = host_ms(lambda: ht.insert(h, upd_k, upd_v))
            unplaced += int(left)
            sarr, upd_ms["sortedarray"] = host_ms(lambda: sa.insert(sarr, upd_k, upd_v))
        else:
            flix, upd_ms["flix"] = host_ms(lambda: kops.flix_delete(flix, upd_k))
            bt, upd_ms["btree"] = host_ms(lambda: btree.delete(bt, upd_k))
            lsmu, upd_ms["lsmu"] = host_ms(lambda: lsm.delete(lsmu, upd_k))
            h, upd_ms["hashtable"] = host_ms(lambda: ht.delete(h, upd_k))
            sarr, upd_ms["sortedarray"] = host_ms(lambda: sa.delete(sarr, upd_k))
        traffic.alive[chunk.long()] = ins
        live = torch.nonzero(traffic.alive)[:, 0].to(torch.int32)
        hits = torch.sort(live[torch.randint(0, live.numel(), (FIG9_QUERIES,), generator=gen,
                                             device=dev)]).values
        cand = torch.unique(traffic._rand_keys(2 * FIG9_QUERIES))
        cand = cand[~traffic.alive[cand.long()]]
        pick = torch.randperm(cand.numel(), generator=gen, device=dev)[:FIG9_QUERIES]
        misses = torch.sort(cand[pick]).values
        del live, cand, pick
        want = {"hit": kops.flix_point_query(flix, hits),
                "miss": kops.flix_point_query(flix, misses)}
        if rnd == 7:
            succ = torch.sort(traffic._rand_keys(FIG9_SUCC)).values
            s_want = kops.flix_successor(flix, succ)
        torch.cuda.synchronize()
        for k in names:
            launches[k] += LAUNCHES[k]
        if bool((want["hit"] == core.NOT_FOUND).any()) or bool(
                (want["miss"] != core.NOT_FOUND).any()):
            raise AssertionError(f"baselines round {rnd}: a FliX hit missed or a miss hit")
        structures = {
            "flix": (lambda q: kops.flix_point_query(flix, q), flix.memory_bytes()),
            "btree": (lambda q: btree.point_query(bt, q), bt.memory_bytes()),
            "lsmu": (lambda q: lsm.point_query(lsmu, q), lsmu.memory_bytes()),
            "hashtable": (lambda q: ht.point_query(h, q), h.memory_bytes()),
            "sortedarray": (lambda q: sa.point_query(sarr, q), sarr.memory_bytes()),
        }
        parts, missed = [], 0
        for name, (fn, mem) in structures.items():
            q_ms = {}
            for what, q in (("hit", hits), ("miss", misses)):
                got = fn(q)  # the warm call
                missed = max(missed, hold_baseline(
                    f"baselines round {rnd}: {name} {what}", q, want[what], got,
                    unplaced if name == "hashtable" else 0))
                del got
                q_ms[what] = event_ms(lambda: fn(q), 3)
            qtmf = FIG9_QUERIES / (q_ms["hit"] / 1e3) / mem
            parts.append(f"{name} {upd_ms[name]:.1f} ms {'insert' if ins else 'delete'}, "
                         f"all-hit {q_ms['hit']:.4f} ms, all-miss {q_ms['miss']:.4f} ms, "
                         f"{mem} B, QTMF {qtmf:.6g} q/s/B")
        log(f"  round {rnd}: " + "; ".join(parts)
            + (f"; hash table: {unplaced} keys unplaced so far, {missed} missed"
               if unplaced else ""))
        del hits, misses, want
    parts = []
    for name, fn in (("flix", lambda: kops.flix_successor(flix, succ)),
                     ("sortedarray", lambda: sa.successor_query(sarr, succ)),
                     ("lsmu", lambda: lsm.successor_query(lsmu, succ))):
        got = fn()
        for w, g, what in zip(s_want, got, ("key", "val")):
            if not torch.equal(w, g):
                raise AssertionError(f"baselines: {name} successor {what}s differ from FliX's")
        parts.append(f"{name} {event_ms(fn, 3):.4f} ms")
    log(f"  {FIG9_SUCC} successor queries after the last delete round (all equal FliX's): "
        + ", ".join(parts))
    log(f"  FliX launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi}); the baselines' "
        f"times are those of torch emulations, not of the paper's implementations")
    return launches


def range_count_bytes(state, lo, hi, is_range=None) -> int:
    """Bytes the count pass must move: each op's rank and count written, the
    mask read where there is one, and the bounds of the ops under it; for
    each bound that needs a rank (every such op's lo, and its hi where hi >
    lo: else the count is 0) the two fences that place it (``mkba[b-1] < q
    <= mkba[b]``); and, once per bucket or row that those bounds touch, the
    bucket's ``pref`` entry, its node_max and node_count rows, and the key
    row that holds the bound."""
    nb, npb, ns = state.geometry
    n = lo.numel()
    if is_range is not None:
        lo, hi = lo[is_range], hi[is_range]
    q = torch.cat([lo, hi[hi > lo]])
    b = torch.clamp(torch.searchsorted(state.mkba, q), max=nb - 1)
    fences = torch.unique(torch.cat([b, torch.clamp(b - 1, min=0)])).numel()
    nidx = (state.node_max[b] < q[:, None]).sum(1)
    rows = torch.unique((b * (npb + 1) + nidx)[nidx < npb]).numel()
    buckets = torch.unique(b).numel()
    mask = n if is_range is not None else 0
    return 8 * n + mask + 8 * lo.numel() + 4 * fences + (8 * npb + 4) * buckets + 4 * ns * rows


def gather_bytes(g, pref, npb) -> int:
    """Bytes a range gather must move: each slot's rank read and its key and
    value written, one key and value read per valid slot, and, once per
    bucket that a valid slot lands in, its ``pref`` entry and node_count
    row."""
    gv = g[g >= 0]
    buckets = torch.unique(torch.searchsorted(pref, gv, right=True) - 1).numel()
    return 12 * g.numel() + 8 * gv.numel() + 4 * (npb + 1) * buckets


def phase_range(dev, check):
    """The standalone RANGE scan on a 2^24-key build (range_mix's widths)."""
    from repro_torch import core
    from repro_torch.core.insert import _node_metadata
    from repro_torch.core.query import (
        _successor_fence_rows, live_prefix, range_offsets, range_slot_ranks,
    )
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flix_range as fr

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    state = core.build(keys, vals)
    del keys, vals
    nb, npb, ns = state.geometry
    gap = FULL_SPACE // FULL_KEYS  # mean key spacing, as range_mix.py sets it
    los, his = [], []
    for n, span in ((RANGE_NARROW, 16), (RANGE_WIDE, 256)):
        lo = torch.randint(0, FULL_SPACE - span * gap, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        los.append(lo)
        his.append(lo + span * gap)
    lo, order = torch.sort(torch.cat(los), stable=True)
    hi = torch.cat(his)[order]
    log(f"phase 7: flix_range on {FULL_KEYS} keys: {RANGE_NARROW} narrow and {RANGE_WIDE} wide "
        f"ranges, max_results={RANGE_MAX_RESULTS}")
    planes = (state.keys, state.vals, state.mkba, lo, hi)
    torch.cuda.synchronize()
    reset_launches()
    got, scan_ms = host_ms(lambda: fr.flix_range(*planes, max_results=RANGE_MAX_RESULTS))
    counts = {k: LAUNCHES[k] for k in ("flix_range_count", "flix_range_scatter")}
    if counts != {"flix_range_count": 1, "flix_range_scatter": 1}:
        raise AssertionError(f"flix_range launched {counts}")
    is_range = torch.ones(lo.shape, dtype=torch.bool, device=dev)
    want, oracle_ms = host_ms(lambda: core.dense_range_scan(
        state, is_range, lo, hi, max_results=RANGE_MAX_RESULTS))
    if max_abs_err(want, got):
        raise AssertionError("flix_range differs from dense_range_scan")
    emitted = int(got[3].sum())
    log(f"  equal to dense_range_scan: {emitted} keys emitted, truncated {int(got[4])}; "
        f"flix_range {scan_ms:.3f} ms end to end, dense_range_scan {oracle_ms:.3f} ms")
    del want

    # the passes and the seam alone, on the same inputs (not counted)
    pref = live_prefix(state.node_count)
    meta = (state.keys, state.node_count, state.node_max, state.mkba, pref, lo, hi)
    rank_lo, full = fr.flix_range_count(*meta)
    start, _, total, _ = range_offsets(full, is_range, RANGE_MAX_RESULTS)
    g = range_slot_ranks(rank_lo, start, total, RANGE_MAX_RESULTS)
    # the seam's parts: the node metadata (flix_range's pass, and the
    # engine's _node_metadata that it replaced), the live-count prefix, the
    # budget split and the slot ranks
    parts = {
        "node metadata": lambda: fr.node_metadata(state.keys),
        "the engine's _node_metadata": lambda: _node_metadata(state.keys),
        "live_prefix": lambda: live_prefix(state.node_count),
        "range_offsets": lambda: range_offsets(full, is_range, RANGE_MAX_RESULTS),
        "range_slot_ranks": lambda: range_slot_ranks(rank_lo, start, total,
                                                     RANGE_MAX_RESULTS),
    }
    seam_ms = {name: event_ms(fn, 5) for name, fn in parts.items()}
    replaced = "the engine's _node_metadata"
    if max_abs_err(_node_metadata(state.keys)[:2], fr.node_metadata(state.keys)):
        raise AssertionError("flix_range's node metadata differs from _node_metadata")
    gargs = (g, pref, state.node_count, state.keys, state.vals)
    count = lambda: fr.flix_range_count(*meta)  # noqa: E731
    scatter = lambda: fr.flix_range_scatter(*gargs)  # noqa: E731
    turns = [event_ms(count, 10), event_ms(scatter, 10), event_ms(scatter, 10),
             event_ms(count, 10)]
    c_ms, s_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    c_queued, s_queued = queued_ms(count, 10), queued_ms(scatter, 10)
    c_want, c_plain = host_ms(lambda: fr.flix_range_count_reference(*meta))
    check.hold("flix_range_count", c_want, (rank_lo, full), "phase 7")
    s_want, s_plain = host_ms(lambda: fr.flix_range_gather_reference(*gargs))
    check.hold("flix_range_scatter", s_want, fr.flix_range_scatter(*gargs), "phase 7")
    c_bytes = range_count_bytes(state, lo, hi)
    s_bytes = gather_bytes(g, pref, npb)
    log(f"  count {c_ms:.4f} ms a call, {c_queued:.4f} queued (bound "
        f"{c_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {c_bytes} B), scatter {s_ms:.4f} ms a "
        f"call, {s_queued:.4f} queued (bound {s_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
        f"{s_bytes} B); plain versions: count {c_plain:.3f} ms, scatter {s_plain:.3f} ms")
    log("  seam: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in seam_ms.items())
        + f"; flix_range's seam {sum(seam_ms.values()) - seam_ms[replaced]:.4f} ms")

    # range_query and with_successor_cache against their definitions
    q = 1 << 12
    mr = 256
    rq_k, rq_v, rq_c = core.range_query(state, lo[:q], hi[:q] - 1, max_results=mr)
    dk, dv, dstart, dcount, _ = core.dense_range_scan(
        state, is_range[:q], lo[:q], hi[:q], max_results=1 << 21)
    j = torch.arange(mr, device=dev)
    take = torch.clamp(dcount, max=mr)
    at = torch.clamp(dstart[:, None] + j[None, :], max=dk.numel() - 1)
    ok = j[None, :] < take[:, None]
    if not (torch.equal(rq_c, take) and torch.equal(rq_k, torch.where(ok, dk[at], core.EMPTY))
            and torch.equal(rq_v, torch.where(ok, dv[at], core.NOT_FOUND))):
        raise AssertionError("range_query differs from the dense scan of [lo, hi]")
    cached = core.with_successor_cache(state)
    smin, sidx = _successor_fence_rows(state.keys, state.num_nodes)
    assert core.with_successor_cache(cached) is cached
    assert torch.equal(cached.succ_smin, smin) and torch.equal(cached.succ_sidx, sidx)
    sq = torch.sort(traffic._rand_keys(1 << 22)).values
    for a, b in zip(core.successor_query(cached, sq), core.successor_query(state, sq)):
        assert torch.equal(a, b), "the successor cache changed an answer"
    log(f"  range_query ({q} ranges, max_results={mr}) equals the dense scan of [lo, hi]; "
        f"with_successor_cache is idempotent and leaves 2^22 successor answers unchanged")
    return {
        # ms: device time (queued), the wrappers' host time being longer than
        # the kernels'; call_ms: the time as a call
        "flix_range_count": dict(launches=counts["flix_range_count"], ms=c_queued,
                                 call_ms=c_ms, plain_ms=c_plain,
                                 bound_ms=c_bytes / HBM_BYTES_PER_S * 1e3, err=0),
        "flix_range_scatter": dict(launches=counts["flix_range_scatter"], ms=s_queued,
                                   call_ms=s_ms, plain_ms=s_plain,
                                   bound_ms=s_bytes / HBM_BYTES_PER_S * 1e3, err=0),
    }

def random_offsets(T: int, E: int, gen) -> torch.Tensor:
    """Ascending int32 offsets [E+1] from 0 to T at random cut points (ties
    give empty groups)."""
    cuts = torch.randint(0, T + 1, (E - 1,), generator=gen, device=gen.device)
    ends = torch.tensor([0, T], device=gen.device)
    return torch.sort(torch.cat([ends[:1], cuts, ends[1:]])).values.to(torch.int32)


def expected_variant(x, w) -> str:
    """grouped_matmul's variant by its stated rule: wgmma for bf16 weights
    where TMA can address both tensors, mma for other bf16 x bf16, fma for
    the rest."""
    D, F = x.shape[1], w.shape[2]
    bf16_x = x.dtype == torch.bfloat16
    tma = (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and F % 8 == 0
           and D % (8 if bf16_x else 4) == 0)
    if w.dtype == torch.bfloat16 and tma:
        return "wgmma"
    return "mma" if bf16_x and w.dtype == torch.bfloat16 else "fma"


def gemm_variant_run(x, w, offs, where):
    """One grouped_matmul launch that must count one launch of the variant
    the rule names; returns (output, variant)."""
    from repro_torch.kernels import GMM_VARIANTS
    from repro_torch.kernels import grouped_matmul as tg

    want = expected_variant(x, w)
    before = dict(GMM_VARIANTS)
    got = tg.grouped_matmul(x, w, offs)
    ran = [k for k in GMM_VARIANTS if GMM_VARIANTS[k] != before[k]]
    if ran != [want] or GMM_VARIANTS[want] != before[want] + 1:
        raise AssertionError(f"{where}: ran {ran}, expected one launch of {want}")
    return got, want


def same_non_finite_close_by_row(want, got, label) -> float:
    """Where ``want`` is inf or NaN, ``got`` is the same; elsewhere within
    ``1e-4 * |want| + 1e-4 * max|want|`` over the row's finite entries.
    Returns the largest absolute error over the finite entries."""
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))
            and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])):
        raise AssertionError(f"{label}: inf or NaN where the reference has none, or the reverse")
    fin = torch.isfinite(want)
    zero = torch.zeros_like(want)
    scale = torch.where(fin, want.abs(), zero).amax(1, keepdim=True)
    err = torch.where(fin, (got - want).abs(), zero)
    if not bool((err <= 1e-4 * torch.where(fin, want.abs(), zero) + 1e-4 * scale).all()):
        raise AssertionError(f"{label}: outside float32 tolerance ({float(err.max())})")
    return float(err.max())


def phase_gemm(dev, check: KernelCheck):
    """grouped_matmul against its plain version at small shapes, every
    dtype mix, each launch counted under the variant its rule names; rows
    outside every group must be exactly zero."""
    from repro_torch.kernels import grouped_matmul as tg

    log("phase 3f: grouped_matmul, small shapes, f32, bf16 and mixed")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    def fixed(*offs):
        return lambda: torch.tensor(offs, dtype=torch.int32, device=dev)

    cases = [  # label, T, D, F, offsets
        ("sweep 256x128x256 E=4", 256, 128, 256, lambda: random_offsets(256, 4, gen)),
        ("sweep 512x64x128 E=8", 512, 64, 128, lambda: random_offsets(512, 8, gen)),
        ("empty groups", 256, 64, 128, fixed(0, 0, 128, 128, 128, 256, 256, 256, 256)),
        ("one group holds every row", 300, 64, 72, fixed(0, 0, 300, 300)),
        ("ragged 1000x96x200", 1000, 96, 200, lambda: random_offsets(1000, 5, gen)),
        ("rows outside every group", 1000, 96, 200, fixed(37, 200, 200, 650, 900)),
        ("odd widths, 128-row tiles", 777, 99, 201, lambda: random_offsets(777, 6, gen)),
        ("odd widths, 32-row tiles", 200, 130, 75, lambda: random_offsets(200, 16, gen)),
        ("skewed: half in one group, 8 empty", 768, 256, 176,
         fixed(*[0] * 9, 384, 440, 500, 560, 610, 650, 720, 768)),
        ("K tail: D % 64 = 8", 300, 200, 136, lambda: random_offsets(300, 5, gen)),
        ("groups straddling row tiles", 512, 128, 264, fixed(0, 70, 190, 333, 512)),
        ("decode-sized groups", 96, 256, 384, lambda: random_offsets(96, 8, gen)),
    ]
    floats = (torch.float32, torch.bfloat16)
    worst, ran = 0.0, {}
    for label, T, D, F, make_offs in cases:
        for dx in floats:
            for dw in floats:
                offs = make_offs()
                E = offs.numel() - 1
                x = torch.randn((T, D), generator=gen, device=dev).to(dx)
                w = (torch.randn((E, D, F), generator=gen, device=dev) * 0.1).to(dw)
                # leave NaN where the output will likely be allocated: rows
                # outside every group must be zeroed by the kernel itself
                torch.full((T * F,), float("nan"), device=dev)
                where = f"{label} ({str(dx)[6:]} x {str(dw)[6:]})"
                got, variant = gemm_variant_run(x, w, offs, where)
                ran[variant] = ran.get(variant, 0) + 1
                want = tg.grouped_matmul_reference(x, w, offs)
                worst = max(worst, check.hold_close("grouped_matmul", want, got, where))
                lo, hi = int(offs[0]), int(offs[-1])
                outside = torch.cat([got[:lo], got[hi:]])
                if not torch.equal(outside, torch.zeros_like(outside)):
                    raise AssertionError(f"{where}: rows outside every group are not zero")
    log(f"  grouped_matmul: {len(cases)} cases x 4 dtype mixes within the float32 tolerance "
        f"of the plain version (max_abs_err {worst:.3g}); rows outside every group zero; "
        f"variants {ran}")

    # unaligned views keep PR 14's kernels; a 16-byte shift is aligned again
    T, D, F, E = 160, 64, 136, 4
    offs = random_offsets(T, E, gen)
    for dx, shift in ((torch.bfloat16, 1), (torch.bfloat16, 8), (torch.float32, 1)):
        x0 = torch.randn((T, D), generator=gen, device=dev).to(dx)
        w0 = (torch.randn((E, D, F), generator=gen, device=dev) * 0.1).bfloat16()
        x = torch.empty(T * D + shift, dtype=dx, device=dev)[shift:].view(T, D).copy_(x0)
        w = torch.empty(E * D * F + shift, dtype=torch.bfloat16,
                        device=dev)[shift:].view(E, D, F).copy_(w0)
        where = f"a view shifted {shift} elements ({str(dx)[6:]} x bfloat16)"
        got, variant = gemm_variant_run(x, w, offs, where)
        check.hold_close("grouped_matmul", tg.grouped_matmul_reference(x0, w0, offs), got,
                         where)
        log(f"  {where}: {variant}")

    # the split's edge values in f32 x, one a row, on 64- and 128-row tiles
    specials = (1e30, 3.3e38, -3.3e38, 1e-30, 1e-40, -1e-42, float("inf"), -float("inf"),
                float("nan"))
    for T, E in ((96, 8), (512, 4)):
        D, F = 128, 192
        offs = random_offsets(T, E, gen)
        x = torch.randn((T, D), generator=gen, device=dev)
        w = (torch.randn((E, D, F), generator=gen, device=dev) * 0.1).bfloat16()
        for i, v in enumerate(specials):
            x[7 * i + 3, (5 * i) % D] = v
        where = f"split edge values, T={T} E={E}"
        got, variant = gemm_variant_run(x, w, offs, where)
        want = tg.grouped_matmul_reference(x, w, offs)
        if bool(torch.isfinite(want[7 * 6 + 3]).any()) or not bool(
                torch.isfinite(want[7 * 1 + 3]).all()):
            raise AssertionError(f"{where}: the reference rows are not as placed")
        # its own tolerance, by row: the 3.3e38 rows' errors (relative ~1e-8)
        # stay out of the kernels line's max_abs_err
        err = same_non_finite_close_by_row(want, got, where)
        log(f"  {where}: {variant}, inf and NaN rows as the reference's, max_abs_err "
            f"{err:.3g} on the finite entries")


def moe_config(arch: str):
    from repro_torch import configs

    return configs.get(arch)


def gemm_bound(x, w, offs):
    """(ms, bound_by, flops, bytes, old_ms) of one grouped GEMM on these
    inputs: the larger of the bytes (the grouped rows of x read once, the
    weights of the non-empty experts read once, out written once as f32)
    over the memory rate and the tensor-core work over the bf16 rate: 2 *
    rows * D * F for bf16 x bf16, 3 * 2 * rows * D * F for an f32 x with
    bf16 w (the three exact bf16 pieces of the split).  old_ms is PR 14's
    bound, f32 work at the 67 TFLOP/s f32 rate, for any f32 operand."""
    o = torch.clamp(offs, 0, x.shape[0])
    rows = int(o[-1] - o[0])
    nonempty = int((o[1:] > o[:-1]).sum())
    _, D, F = w.shape
    moved = (rows * D * x.element_size() + nonempty * D * F * w.element_size()
             + x.shape[0] * F * 4)
    flops = 2 * rows * D * F
    bf16 = x.dtype == w.dtype == torch.bfloat16
    pieces = 1 if bf16 else 3 if w.dtype == torch.bfloat16 else None
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_old = max(t_bytes, flops / (BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S) * 1e3)
    t_ops = (pieces * flops / BF16_FLOP_PER_S if pieces else flops / FP32_FLOP_PER_S) * 1e3
    return (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            (pieces or 1) * flops, moved, t_old)


def timed_ms(fn) -> float:
    """Device time of one call of ``fn`` by CUDA events: one warm-up call,
    then as many calls as fill about ``MOE_TIME_MS`` (3 to 50)."""
    fn()
    first = event_ms(fn, 1)
    return event_ms(fn, max(3, min(50, int(MOE_TIME_MS / max(first, 1e-3)))))


def grouped_mm_ms(x, w, offs):
    """The yardstick ``torch._grouped_mm`` on the same inputs: (ms, note),
    ms None where no single PyTorch call computes the same function."""
    if not (x.dtype == w.dtype == torch.bfloat16):
        return None, "null: no single PyTorch call multiplies f32 by bf16 in f32"
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "null: this torch has no torch._grouped_mm"
    ends = offs[1:].int()  # cumulative group ends; offs[0] == 0 on this path
    notes = []
    for out_dtype in (torch.float32, None):
        call = lambda: fn(x, w, offs=ends, out_dtype=out_dtype)  # noqa: E731
        try:
            call()
        except RuntimeError as exc:
            notes.append(f"out_dtype={out_dtype} refused: {str(exc).splitlines()[0][:120]}")
            continue
        note = "f32 output" if out_dtype is torch.float32 else "bf16 output"
        return timed_ms(call), "; ".join(notes + [note])
    return None, "null: " + "; ".join(notes)


def ffn_part_ms(md, ops, x, logits, w_up, w_down, k, E) -> dict:
    """Device time of each part of the flipped FFN by CUDA events recorded
    between them on the stream (a part that waits on the host counts that
    wait): the median of FFN_PART_REPS runs after one warm-up."""
    names = ("make_plan", "dispatch", "up GEMM", "silu", "down GEMM", "combine")
    runs = []
    for _ in range(FFN_PART_REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        plan = md.make_plan(logits, k, E)
        ev[1].record()
        xs = md.dispatch(x, plan, k)
        ev[2].record()
        up = ops.grouped_matmul(xs, w_up, plan.group_offsets)
        ev[3].record()
        h = torch.nn.functional.silu(up)
        ev[4].record()
        ys = ops.grouped_matmul(h, w_down, plan.group_offsets)
        ev[5].record()
        md.combine(ys, plan, k)
        ev[6].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        del plan, xs, up, h, ys
    return {n: median(r[i] for r in runs[1:]) for i, n in enumerate(names)}


def moe_inputs(cfg, T: int, skew: bool, gen):
    """x ~ N(0,1), router [D, E] f32 and expert weights ~ N(0,1) * 0.02 in
    the configuration's dtype, router logits ``x.float() @ router``.  A
    skewed router gives expert 0 every token (a sixth of the slots under
    top-6: the most one expert can hold) and 16 experts none."""
    dev = gen.device
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    dt = getattr(torch, cfg.dtype)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = normal(T, D).to(dt)
    router = normal(D, E, scale=0.02)
    w_up = torch.empty((E, D, F), dtype=dt, device=dev)
    w_down = torch.empty((E, F, D), dtype=dt, device=dev)
    for e in range(E):  # one expert at a time: no f32 copy of all weights
        w_up[e] = normal(D, F, scale=0.02)
        w_down[e] = normal(F, D, scale=0.02)
    logits = x.float() @ router
    if skew:
        logits[:, 0] += 10.0
        logits[:, E - 16:] -= 1e4
    return x, logits, w_up, w_down


def phase_moe(dev, check: KernelCheck):
    from repro_torch.kernels import GMM_VARIANTS, LAUNCHES, ops, reset_launches
    from repro_torch.kernels import grouped_matmul as tg
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models.config import SHAPES

    # the plain versions and the dense oracle are f32 matmuls: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    gemms, launches, wgmma_runs = [], 0, 0
    for label, arch, tokens, skew in MOE_RUNS:
        t_run = time.perf_counter()
        cfg = moe_config(arch)
        E, k, D, F = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
        T = tokens or SHAPES["decode_32k"]["global_batch"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        x, logits, w_up, w_down = moe_inputs(cfg, T, skew, gen)
        log(f"phase 8 run {label}: {arch}, T={T} tokens, {T * k} slots, E={E} k={k} D={D} "
            f"F={F}, {cfg.dtype}")

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        plan = md.make_plan(logits, k, E)
        xs = md.dispatch(x, plan, k)
        up = ops.grouped_matmul(xs, w_up, plan.group_offsets)
        h = torch.nn.functional.silu(up)
        ys = ops.grouped_matmul(h, w_down, plan.group_offsets)
        out = md.combine(ys, plan, k)
        torch.cuda.synchronize()
        ffn_ms = (time.perf_counter() - t0) * 1e3
        n = LAUNCHES["grouped_matmul"]
        if n != 2 or GMM_VARIANTS["wgmma"] != 2:
            raise AssertionError(f"run {label}: grouped_matmul launched {n} times, by variant "
                                 f"{GMM_VARIANTS}; expected 2, both wgmma")
        launches += n
        wgmma_runs += GMM_VARIANTS["wgmma"]
        offs = plan.group_offsets
        sizes = offs[1:] - offs[:-1]
        n_empty, largest = int((sizes == 0).sum()), int(sizes.max())
        if skew:
            assert largest == T and n_empty >= 8, (largest, n_empty)
        assert out.shape == (T, D) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()), f"run {label}: non-finite output"
        parts = ffn_part_ms(md, ops, x, logits, w_up, w_down, k, E)
        log(f"  flipped FFN {ffn_ms:.3f} ms (host clock, first call); by CUDA events, median "
            f"of {FFN_PART_REPS}: " + ", ".join(f"{p} {ms:.4f}" for p, ms in parts.items())
            + f" ms (sum {sum(parts.values()):.4f}); groups: largest {largest}, empty "
            f"{n_empty}, mean {T * k / E:.1f}")

        for name, a, w, got in (("up", xs, w_up, up), ("down", h, w_down, ys)):
            want, plain_ms = host_ms(lambda: tg.grouped_matmul_reference(a, w, offs))
            err = check.hold_close("grouped_matmul", want, got, f"run {label} {name}")
            del want
            ms = timed_ms(lambda: tg.grouped_matmul(a, w, offs))
            lib_ms, lib_note = grouped_mm_ms(a, w, offs)
            bound, by, flops, moved, old = gemm_bound(a, w, offs)
            gemms.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
            lib = "null" if lib_ms is None else f"{lib_ms:.4f} ms"
            log(f"  {name} ({str(a.dtype)[6:]} x {str(w.dtype)[6:]}, {tg.kernel_variant(a, w)}):"
                f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib} ({lib_note}), "
                f"bound {bound:.4f} ms by {by} ({flops} tensor-core FLOP, {moved} B; "
                f"{ms / bound:.2f}x), PR 14's bound {old:.4f} ms ({ms / old:.2f}x), "
                f"max_abs_err {err:.3g}")
        want = md.moe_ffn_reference(x, logits, w_up, w_down, k)
        err = close_err(want, out, f"run {label}: FFN vs moe_ffn_reference")
        del want
        log(f"  FFN equals moe_ffn_reference (max_abs_err {err:.3g}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; run "
            f"{time.perf_counter() - t_run:.1f} s")
        del x, logits, w_up, w_down, xs, up, h, ys, out, plan
    log(f"  all {wgmma_runs} main-path GEMMs ran gmm_wgmma_kernel")
    ops_share = sum(g["bound_ms"] for g in gemms if g["bound_by"] == "operations")
    bytes_share = sum(g["bound_ms"] for g in gemms if g["bound_by"] == "bytes")
    log(f"  kernels line: means over the {len(gemms)} GEMMs; library_ms null, since the down "
        f"projections (f32 x bf16) have no single PyTorch call (up projections' "
        f"torch._grouped_mm times above)")
    return {
        "grouped_matmul": dict(
            launches=launches,
            ms=fmean(g["ms"] for g in gemms),
            plain_ms=fmean(g["plain_ms"] for g in gemms),
            bound_ms=fmean(g["bound_ms"] for g in gemms),
            bound_by="operations" if ops_share > bytes_share else "bytes",
            err=0,
        )
    }


LM_ARCH = "deepseek-moe-16b"
LM_EXACT_LAYERS = 2  # phase 14a: depth cut 28 -> 2
LM_EXACT = dict(rtol=2e-3, atol=2e-3)  # decode == forward (tests/test_models.py:53-66)
LM_ORACLE = dict(rtol=2e-3, atol=2e-4)  # moe_ffn == its dense oracle (:124-145)
LM_MOE_TOKENS = 64
LM_SERVE = ["--arch", LM_ARCH, "--batch", "16", "--steps", "48", "--max-len", "128"]
LM_PATH_BASE = ["--arch", "musicgen-medium", "--reduced", "--batch", "4", "--steps", "32",
                "--max-len", "64"]
def update_launches(counts) -> int:
    """The fewest of an index's update kernels: its stripe pass, functional
    or donated (an index without pinned versions donates), and the fence
    rows."""
    return min(counts["flix_apply_staged"] + counts["flix_apply_staged_inplace"],
               counts["flix_fence_rows"])


def lm_close(label, got, want, tol) -> float:
    """``got`` within ``rtol * |want| + atol`` of ``want`` elementwise, both
    finite; returns the largest absolute difference."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = float((got.double() - want.double()).abs().max())
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{label}: max_abs_err {err} outside {tol}")
    return err


def phase_lm_exact(dev):
    """deepseek-moe-16b at its full width, depth cut to 2, in float32 on the
    card: ``decode_step`` over 16 tokens equals ``forward`` on them, and
    ``moe_ffn`` on 64 tokens equals its dense oracle (the reference's own
    checks and tolerances)."""
    from repro_torch.models import model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: float32 would not be float32")
    cfg = dataclasses.replace(model.get_config(LM_ARCH), num_layers=LM_EXACT_LAYERS,
                              dtype="float32", moe_capacity_factor=8.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    log(f"phase 14a: {LM_ARCH} at full width (D {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top {cfg.top_k} + "
        f"{cfg.num_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}), "
        f"{cfg.num_layers} layers, float32, capacity factor 8")
    params = tf.init_params(gen, cfg)
    B, S = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    with torch.no_grad():
        full, f_ms = host_ms(lambda: tf.forward(params, cfg, tokens))
        cache = tf.init_cache(cfg, B, S, dtype=torch.float32, device=dev)
        err, d_ms = 0.0, []
        for t in range(S):
            (logits, cache), ms = host_ms(lambda: tf.decode_step(params, cfg, cache, tokens[:, t]))
            d_ms.append(ms)
            err = max(err, lm_close(f"14a decode step {t}", logits, full[:, t], LM_EXACT))
        log(f"  decode_step x {S} == forward within {LM_EXACT}: max_abs_err {err:.3e} "
            f"(max|logit| {float(full.abs().max()):.3f}); forward {f_ms:.1f} ms, decode "
            f"median {median(d_ms):.1f} ms a step (host clock, synced)")
        lp = {k: v[0] for k, v in params["layers"].items()}
        x = torch.randn(LM_MOE_TOKENS, cfg.d_model, generator=gen, device=dev)
        got = moe_lib.moe_ffn(x, lp, cfg)
        want = moe_lib.moe_ffn_dense_oracle(x, lp, cfg)
        err = lm_close("14a moe_ffn", got, want, LM_ORACLE)
    log(f"  moe_ffn on {LM_MOE_TOKENS} tokens == moe_ffn_dense_oracle within {LM_ORACLE}: "
        f"max_abs_err {err:.3e} (max|y| {float(want.abs().max()):.4f}); "
        f"model parameters {model.param_count(params):,}")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def run_serve(argv) -> tuple:
    """``repro_torch.launch.serve.main(argv)``, its printed lines echoed and
    returned with the finished index."""
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        idx = serve.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    return idx, lines


def index_live_pairs(idx) -> dict:
    """Every (key, slot) a single-device index holds, but its seed key."""
    from repro_torch.core.state import EMPTY, MAX_VALID

    keys, vals = idx.state.keys.reshape(-1), idx.state.vals.reshape(-1)
    live = (keys != EMPTY) & (keys != MAX_VALID)
    return dict(zip(keys[live].tolist(), vals[live].tolist()))


def phase_lm_serve(dev, smi):
    """The serving driver at deepseek-moe-16b's full width and depth: 16
    sequences, 48 decode steps, float32 parameters and cache, bfloat16
    compute; each decode step timed by CUDA events, each index step by the
    host clock (synced).  Returns the index's launches."""
    import gc

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_index
    from repro_torch.serve.kv_index import PAGE_BITS

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.get_config(LM_ARCH)
    n_params = model.param_count(model.abstract_params(cfg))
    bound_ms = n_params * 4 / HBM_BYTES_PER_S * 1e3
    log(f"phase 14b: python -m repro_torch.launch.serve {' '.join(LM_SERVE)} ({smi}); "
        f"{n_params:,} float32 parameters ({n_params * 4 / 2**30:.1f} GiB), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before")
    decode, finite, index_ms = [], [], []
    orig_decode, orig_step = tf.decode_step, kv_index.KVPageIndex.step

    def timed_decode(params, cfg, cache, token):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, cache = orig_decode(params, cfg, cache, token)
        ev[1].record()
        decode.append(ev)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    def timed_step(self, *a, **kw):
        out, ms = host_ms(lambda: orig_step(self, *a, **kw))
        index_ms.append(ms)
        return out

    reset_launches()
    t0 = time.perf_counter()
    with patched(tf, "decode_step", timed_decode), \
            patched(kv_index.KVPageIndex, "step", timed_step):
        idx, lines = run_serve(LM_SERVE)
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in KERNELS}
    torch.cuda.synchronize()
    steps, batch = 48, 16
    if len(decode) != steps or not bool(torch.stack(finite).all()):
        raise AssertionError(f"14b: {len(decode)} decode steps, finite {torch.stack(finite)}")
    want = {(b << PAGE_BITS) | p: b * 1000 + p for b in range(batch) for p in range(3)}
    if index_live_pairs(idx) != want:
        raise AssertionError("14b: the index's live pairs differ from the host model")
    updates = 3  # steps 0, 16 and 32
    if update_launches(launches) < updates:
        raise AssertionError(f"14b: an update step ran without its kernels: {launches}")
    ms = [s.elapsed_time(e) for s, e in decode]
    med = median(ms[1:])
    log(f"  decode: {med:.2f} ms a step (CUDA events, median of steps 2-{steps}; first "
        f"{ms[0]:.2f}, min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}) against the bound "
        f"{bound_ms:.2f} ms (the float32 parameters read once at 3.35 TB/s; {med / bound_ms:.2f}x); "
        f"{steps * batch / sum(ms) * 1e3:.1f} tok/s of decode device time")
    log(f"  index steps (host ms, synced): {', '.join(f'{m:.2f}' for m in index_ms)}; "
        f"launches {launches}; driver wall {wall:.1f} s; logits finite at every step; live "
        f"pairs equal the host model ({len(want)}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} ({smi})")
    del idx
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_lm_paths(dev):
    """Every path of the serving driver on the card at reduced widths
    (musicgen-medium, batch 4, 32 steps): each must pass the driver's own
    checks.
    Returns the index's launches."""
    import tempfile

    from repro_torch.kernels import LAUNCHES, reset_launches

    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(prefix="flix-lm-") as tmp:
        runs = [
            ("gateway, durable", ["--gateway", "--wal-dir", tmp], "gateway exactly-once ✓"),
            ("durable again", ["--wal-dir", tmp], f"recovered KV index from {tmp}"),
            ("pinned reads", ["--snapshot-window", "6"], "pinned snapshot read byte-identical"),
            ("window slides", ["--snapshot-window", "2"], "→ SNAPSHOT_GONE ✓"),
            ("page TTL", ["--page-ttl", "8"], "page TTLs honored ✓"),
            ("tiered", ["--device-budget", "500000"], "tiered residency ✓"),
            ("sharded", ["--shards", "2", "--index-routing", "a2a", "--device", "cuda"],
             "on 2 shards (a2a)"),
            ("reference engine", ["--index-impl", "reference"], "page enumeration in order ✓"),
        ]
        for label, extra, expect in runs:
            log(f"phase 14c: {label}: {' '.join(LM_PATH_BASE + extra)}")
            reset_launches()
            (_, lines), ms = host_ms(lambda: run_serve(LM_PATH_BASE + extra))
            counts = {k: LAUNCHES[k] for k in KERNELS}
            if not any(expect in line for line in lines):
                raise AssertionError(f"14c {label}: no line holds {expect!r}")
            kernels = update_launches(counts)
            if (kernels == 0) != (label == "reference engine"):
                raise AssertionError(f"14c {label}: launches {counts}")
            for k, c in counts.items():
                total[k] += c
            log(f"  {ms:.0f} ms; launches {({k: c for k, c in counts.items() if c})}")
    return total


TRAIN_LAYERS = 2  # phase 15a: depth cut 28 -> 2 (phase 14a's)
TRAIN_EXACT_BATCH = (2, 64)  # 15a, float32 checks: batch x seq
TRAIN_EXACT_CHUNK = 24  # 63 shifted positions: 2 chunks and a tail of 15
TRAIN_LR, TRAIN_WARMUP = 1e-3, 1  # 15a's checked step: the full rate at once
TRAIN_BATCH = (8, 512)  # 15a, timed bfloat16 steps
TRAIN_STEPS = 12
TRAIN_LOSS_RTOL = 1e-5  # float32 sums in other orders (a 102,400-way logsumexp)
TRAIN_GRAD_REL = 1e-5  # of a leaf's largest |g|: atomics in index_add_ / embedding backward
TRAIN_MOMENT_REL = 1e-4  # of a leaf's largest |m|, |v| after a step
TRAIN_SSM = ["--arch", "mamba2-1.3b", "--batch", "8", "--seq", "64", "--steps", "6"]
TRAIN_RESUME = ["--arch", "musicgen-medium", "--reduced", "--batch", "4", "--seq", "64",
                "--ckpt-every", "10"]
TRAIN_CRASH_STEP = 10  # 15b: the checkpoint after which the run dies
EXAMPLE_STEPS = 300  # 15c
EXAMPLE_MARGIN = 1.0  # 15c: nats the loss must fall by, from ~ln(8192) = 9.01
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)


SHARD_MESH = (4, 2)  # phase 16: data x model positions, all on the one card
SHARD_EXACT_BATCH = (4, 64)  # 16a: the smallest batch the data axis divides
SHARD_A2A_TOKENS = 256  # 16a: moe_ffn_a2a against the dense oracle
SHARD_ORACLE_ATOL = 2e-4  # tests/test_distributed.py:249
SHARD_LOSS_ATOL = 1e-3  # tests/test_distributed.py:155
SHARD_GNORM_RTOL = 1e-4  # float32 sums of the same products in other orders
SHARD_STEPS = 6  # 16b
SHARD_PREFILL = (8, 512)  # 16b: batch x seq
SHARD_DECODE = (16, 128, 8)  # 16b: batch, max-len, steps
SHARD_BF16_REL = 3e-2  # 16b: bfloat16 logits, of max|want| (tests/test_torch_models.py)
TIMED: dict = {}  # phase 15a's median step, read by 16b


class _Crash(Exception):
    """The failure phase 15b injects after a checkpoint."""


def whole_leaf(t):
    """A tensor, or a leaf placed on a mesh gathered whole (one at a time)."""
    from repro_torch import sharding

    return t.tensor() if isinstance(t, sharding.Placed) else t


def hold_close(label, got, want, rel) -> float:
    """Each leaf within ``rel`` of its largest |want| (compared in float32 on
    ``want``'s device); returns the worst ratio of error to that scale."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = whole_leaf(g).detach().to(w.device, torch.float32), w.detach().float()
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
            raise AssertionError(f"{label}: leaf {i} non-finite")
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max()) / scale
        if err > rel:
            raise AssertionError(f"{label}: leaf {i} off by {err:.3e} of max|want| > {rel}")
        worst = max(worst, err)
    return worst


def hold_train_state(label, got, want, lr_sum: float) -> str:
    """Two train states after the same steps: moments within
    ``TRAIN_MOMENT_REL``; parameters within ``lr_sum`` (where a gradient is
    within rounding of zero its Adam direction may differ, and the
    parameter by up to the rate a step), and all but one in a thousand of
    a leaf within ``1e-3 * lr_sum``."""
    from repro_torch.pytree import tree_leaves

    if int(got.opt.step) != int(want.opt.step):
        raise AssertionError(f"{label}: steps {int(got.opt.step)} != {int(want.opt.step)}")
    m = hold_close(f"{label} m", tree_leaves(got.opt.m), tree_leaves(want.opt.m),
                   TRAIN_MOMENT_REL)
    v = hold_close(f"{label} v", tree_leaves(got.opt.v), tree_leaves(want.opt.v),
                   TRAIN_MOMENT_REL)
    worst, off = 0.0, 0
    for g, w in zip(tree_leaves(got.params), tree_leaves(want.params)):
        d = (whole_leaf(g).detach().to(w.device, torch.float32) - w.float()).abs()
        n_off = int((d > 1e-3 * lr_sum).sum())
        if float(d.max()) > lr_sum or n_off > max(1, d.numel() // 1000):
            raise AssertionError(f"{label}: parameters off by {float(d.max()):.3e} "
                                 f"({n_off} of {d.numel()} beyond 1e-3 x {lr_sum:.3e})")
        worst, off = max(worst, float(d.max())), off + n_off
    return (f"m within {m:.2e}, v within {v:.2e} of max (tol {TRAIN_MOMENT_REL}); "
            f"parameters within {worst:.3e} (tol lr sum {lr_sum:.3e}), {off} beyond "
            f"1e-3 of it")


def train_step_flops(cfg, B: int, S: int) -> float:
    """Model FLOPs of one train step under remat, counted from the
    parameter tensors: each layer and the loss head run forward twice and
    backward once (4x the forward's FLOPs); attention over all S x S
    scores as the port computes them; the MoE layer's capacity windows at
    E x C slots."""
    from repro_torch.models import model
    from repro_torch.models.moe import capacity

    p = model.abstract_params(cfg)
    lp = {k: v[0] for k, v in p["layers"].items()}
    T = B * S
    dense = ("wq", "wk", "wv", "wo", "shared_gate", "shared_up", "shared_down", "router")
    if cfg.family != "moe":
        dense += ("w_gate", "w_up", "w_down")
    layer = 2 * T * sum(lp[k].numel() for k in dense if k in lp)
    layer += 4 * B * S * S * cfg.num_heads * cfg.resolved_head_dim
    if cfg.family == "moe":
        C = capacity(T, cfg.top_k, cfg.num_experts, cfg.moe_capacity_factor)
        layer += 2 * C * sum(lp[k].numel() for k in ("w_gate", "w_up", "w_down"))
    head = 2 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    return 4.0 * (cfg.num_layers * layer + head)


def adamw_bytes(n_params: int) -> int:
    """AdamW over float32 leaves: read p, g, m, v, write p, m, v."""
    return 28 * n_params


def run_train(argv) -> tuple:
    """``repro_torch.launch.train.main(argv)``, its printed lines echoed and
    returned with the final state."""
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    return state, lines


def logged_losses(label, lines) -> list[float]:
    losses = [float(line.split()[3]) for line in lines if line.startswith("step ")]
    if not losses or not all(math.isfinite(x) for x in losses) or lines[-1] != "done":
        raise AssertionError(f"{label}: lines {lines}")
    return losses


def free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_train_exact(dev):
    """deepseek-moe-16b at full width, depth 2, float32 parameters and
    compute on the card: remat's gradients equal no remat's,
    ``chunked_lm_loss`` one unchunked cross entropy, and one train step on
    the card the same step on the CPU at a reduced width."""
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import softmax_cross_entropy_sharded
    from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.train import step as tstep

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: float32 would not be float32")
    free_card()
    cfg = dataclasses.replace(model.get_config(LM_ARCH), num_layers=TRAIN_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    params = tf.init_params(gen, cfg)
    B, S = TRAIN_EXACT_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    log(f"phase 15a: {LM_ARCH} at full width (D {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top {cfg.top_k} + "
        f"{cfg.num_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}), "
        f"{cfg.num_layers} layers, {model.param_count(params):,} float32 parameters; "
        f"checks at batch {B} x {S}, float32 compute")

    def value_and_grad(remat):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        fn = tstep.make_loss_fn(cfg, remat=remat, loss_chunk=TRAIN_EXACT_CHUNK)
        loss = fn(tree_unflatten(params, leaves), batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    (on_loss, on_g), on_ms = host_ms(lambda: value_and_grad(True))
    (off_loss, off_g), off_ms = host_ms(lambda: value_and_grad(False))
    lerr = abs(float(on_loss) - float(off_loss)) / abs(float(off_loss))
    if lerr > TRAIN_LOSS_RTOL:
        raise AssertionError(f"15a remat loss {float(on_loss)} != {float(off_loss)}")
    gerr = hold_close("15a remat gradients", on_g, off_g, TRAIN_GRAD_REL)
    log(f"  remat=True == remat=False: loss {float(on_loss):.6f} (rel err {lerr:.2e}, tol "
        f"{TRAIN_LOSS_RTOL}), every gradient leaf within {gerr:.2e} of its max|g| (tol "
        f"{TRAIN_GRAD_REL}); loss + gradients {on_ms:.0f} ms with remat, {off_ms:.0f} without "
        f"(host clock, synced)")
    del on_g, off_g
    with torch.no_grad():
        hidden = tf.forward_hidden(params, cfg, batch["tokens"])[:, :-1]
        tg = batch["targets"][:, 1:]
        mask = torch.ones(tg.shape, dtype=torch.float32, device=dev)
        chunked = tstep.chunked_lm_loss(hidden, params["lm_head"], tg, mask,
                                        chunk=TRAIN_EXACT_CHUNK)
        whole = softmax_cross_entropy_sharded(hidden @ params["lm_head"], tg, mask)
    cerr = abs(float(chunked) - float(whole)) / abs(float(whole))
    if cerr > TRAIN_LOSS_RTOL:
        raise AssertionError(f"15a chunked loss {float(chunked)} != {float(whole)}")
    log(f"  chunked_lm_loss (chunks of {TRAIN_EXACT_CHUNK} over {S - 1}, a tail of "
        f"{(S - 1) % TRAIN_EXACT_CHUNK}) == one unchunked logsumexp cross entropy: "
        f"{float(chunked):.6f}, rel err {cerr:.2e} (tol {TRAIN_LOSS_RTOL})")
    del params, hidden

    small = cfg.reduced()
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(SEED + 16)
    cpu_state = tstep.train_state_init(cpu_gen, small, device="cpu")
    card_state = tree_map(lambda t: t.to(dev, copy=True), cpu_state)
    kw = dict(lr=TRAIN_LR, warmup=TRAIN_WARMUP, loss_chunk=TRAIN_EXACT_CHUNK)
    small_batch = {k: v % small.vocab_size for k, v in batch.items()}
    card_state, cm = tstep.make_train_step(small, **kw)(card_state, small_batch)
    cpu_state, pm = tstep.make_train_step(small, **kw)(
        cpu_state, {k: v.cpu() for k, v in small_batch.items()})
    for k in ("loss", "grad_norm"):
        err = abs(float(cm[k]) - float(pm[k])) / abs(float(pm[k]))
        if err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"15a step {k}: card {float(cm[k])} cpu {float(pm[k])}")
    lr_1 = float(tstep.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, 10_000)(cm["step"]))
    held = hold_train_state("15a card step vs CPU step", card_state, cpu_state, lr_1)
    log(f"  one train_step on the card == the same step on the CPU at reduced width "
        f"(D {small.d_model}, {small.num_experts} experts): loss {float(cm['loss']):.6f}, "
        f"grad norm {float(cm['grad_norm']):.6f} (rel tol {TRAIN_LOSS_RTOL}); {held}")


def phase_train_timed(dev, smi):
    """deepseek-moe-16b at full width, depth 2, float32 parameters, the
    registry's bfloat16 compute: 12 steps on the data pipeline's stream,
    each timed by CUDA events, beside the step's bound."""
    from repro_torch.data import DataState, make_batch_iterator
    from repro_torch.models import model
    from repro_torch.train import step as tstep

    free_card()
    cfg = dataclasses.replace(model.get_config(LM_ARCH), num_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    state = tstep.train_state_init(gen, cfg)
    n = model.param_count(state.params)
    B, S = TRAIN_BATCH
    flops = train_step_flops(cfg, B, S)
    bound_ms = max(flops / BF16_FLOPS, adamw_bytes(n) / HBM_BYTES_PER_S) * 1e3
    step_fn = tstep.make_train_step(cfg, remat=True, loss_chunk=512)
    it = make_batch_iterator(cfg.vocab_size, S, B, state=DataState(seed=SEED), device=dev)
    events, metrics = [], []
    t0 = time.perf_counter()
    for step, batch in it:
        if step >= TRAIN_STEPS:
            break
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, m = step_fn(state, batch)
        ev[1].record()
        events.append(ev)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    med = median(ms[1:])
    TIMED["15a"] = (med, torch.cuda.max_memory_allocated())
    for i, (m, t) in enumerate(zip(metrics, ms)):
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"15a step {i}: loss {loss}, grad norm {gn}")
        log(f"  step {i:2d} loss {loss:.4f} grad norm {gn:.4f} ({t:.2f} ms)")
    log(f"  train step (bfloat16 compute, batch {B} x {S}, remat, loss_chunk 512): {med:.2f} ms "
        f"(CUDA events, median of steps 2-{TRAIN_STEPS}; first {ms[0]:.2f}, min "
        f"{min(ms[1:]):.2f}, max {max(ms[1:]):.2f}) against the bound {bound_ms:.2f} ms "
        f"({med / bound_ms:.2f}x; the larger of {flops / 1e12:.2f} TFLOP at 989 TFLOP/s = "
        f"{flops / BF16_FLOPS * 1e3:.2f} ms and AdamW's {adamw_bytes(n) / 1e9:.1f} GB at "
        f"3.35 TB/s = {adamw_bytes(n) / HBM_BYTES_PER_S * 1e3:.2f} ms); "
        f"{B * S / med * 1e3:,.0f} tok/s; {n:,} parameters; wall {wall:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")


def phase_train_driver(dev):
    """The training driver as a user runs it: mamba2-1.3b at its full config,
    then musicgen-medium reduced through a checkpoint, a resume, and a
    crash after the step-10 checkpoint whose rerun must end at an
    uninterrupted run's state."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import model
    from repro_torch.optim import cosine_schedule

    free_card()
    cfg = model.get_config("mamba2-1.3b")
    log(f"phase 15b: python -m repro_torch.launch.train {' '.join(TRAIN_SSM)}; "
        f"{cfg.num_layers} layers, D {cfg.d_model}, "
        f"{model.param_count(model.abstract_params(cfg)):,} parameters")
    _, wall = host_ms(lambda: logged_losses("15b mamba2", run_train(TRAIN_SSM)[1]))
    log(f"  {wall / 1e3:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    free_card()
    with tempfile.TemporaryDirectory(prefix="flix-train-") as tmp:
        resume = TRAIN_RESUME + ["--ckpt-dir", f"{tmp}/resume"]
        log(f"phase 15b: {' '.join(resume)} --steps 12, then --steps 16")
        logged_losses("15b first run", run_train(resume + ["--steps", "12"])[1])
        _, lines = run_train(resume + ["--steps", "16"])
        logged_losses("15b resumed run", lines)
        if lines[0] != "resumed from step 12":
            raise AssertionError(f"15b: the rerun printed {lines[0]!r}")
        argv = TRAIN_RESUME + ["--steps", "16"]
        log(f"phase 15b: {' '.join(argv)} whole, then crashed after the step-"
            f"{TRAIN_CRASH_STEP} checkpoint and rerun")
        whole, _ = run_train(argv + ["--ckpt-dir", f"{tmp}/whole"])
        save = CheckpointManager.save

        def crash_after(self, step, tree, **kw):
            save(self, step, tree, **kw)
            if step == TRAIN_CRASH_STEP:
                self.wait()  # the checkpoint is committed, then the run dies
                raise _Crash

        crashed = argv + ["--ckpt-dir", f"{tmp}/crashed"]
        try:
            with patched(CheckpointManager, "save", crash_after):
                run_train(crashed)
            raise AssertionError("15b: the injected crash did not happen")
        except _Crash:
            log(f"  crashed after the step-{TRAIN_CRASH_STEP} checkpoint, as injected")
        got, lines = run_train(crashed)
        if lines[0] != f"resumed from step {TRAIN_CRASH_STEP}":
            raise AssertionError(f"15b: the rerun printed {lines[0]!r}")
        # the card's atomics make no two runs bitwise equal: every step counts
        lr = cosine_schedule(3e-4, 100, 16)
        lr_sum = sum(float(lr(torch.tensor(s))) for s in range(1, 17))
        log(f"  rerun == uninterrupted run: {hold_train_state('15b', got, whole, lr_sum)}")


def phase_train_example(dev):
    """``examples/train_lm_torch.py`` (the reference example's ~100M
    model) for 300 steps on the card: its loss must fall by the margin."""
    import importlib.util
    import io

    free_card()
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    log(f"phase 15c: python examples/train_lm_torch.py --steps {EXAMPLE_STEPS}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (first, last), ms = host_ms(lambda: example.main(["--steps", str(EXAMPLE_STEPS)]))
    for line in buf.getvalue().strip().splitlines():
        log(f"  | {line}")
    if not (math.isfinite(last) and last < first - EXAMPLE_MARGIN):
        raise AssertionError(f"15c: loss {first} -> {last}, not below by {EXAMPLE_MARGIN}")
    log(f"  loss fell {first:.4f} -> {last:.4f} (ln 8192 = {math.log(8192):.4f}), by "
        f"{first - last:.4f} > the margin {EXAMPLE_MARGIN}; {ms / 1e3:.1f} s, "
        f"{ms / EXAMPLE_STEPS:.1f} ms a step by the host clock")


@contextlib.contextmanager
def shape_cut(name: str, batch: int, seq: int):
    """``SHAPES[name]`` cut to ``batch`` x ``seq`` while ``build_cell`` reads it."""
    from repro_torch.models import config as mc

    old = mc.SHAPES[name]
    mc.SHAPES[name] = dict(old, global_batch=batch, seq_len=seq)
    try:
        yield
    finally:
        mc.SHAPES[name] = old


def shard_mesh(dev):
    from repro_torch.launch.mesh import make_mesh_auto

    return make_mesh_auto(SHARD_MESH, ("data", "model"), [dev] * math.prod(SHARD_MESH))


def collective_line(counts: dict, steps: int = 1) -> str:
    return ", ".join(f"{k} {v['count'] // steps} x, {v['bytes'] / steps / 1e9:.3f} GB"
                     for k, v in sorted(counts.items())) or "none"


def phase_shard_lm_exact(dev):
    """deepseek-moe-16b at full width, depth 2, float32, capacity factor 8,
    on a 4 x 2 mesh of the one card: ``moe_ffn_a2a`` against the dense
    oracle; the a2a train cell's step against the single-device step on
    the same state."""
    from repro_torch import sharding as sh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe_a2a import moe_ffn_a2a
    from repro_torch.optim import cosine_schedule
    from repro_torch.pytree import tree_map
    from repro_torch.train import step as tstep

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: float32 would not be float32")
    free_card()
    mesh = shard_mesh(dev)
    over = dict(dtype="float32", moe_capacity_factor=8.0)
    B, S = SHARD_EXACT_BATCH
    with shape_cut("train_4k", B, S):
        cell = build_cell(LM_ARCH, "train_4k", mesh, depth_periods=TRAIN_LAYERS,
                          moe_impl="a2a", loss_chunk=TRAIN_EXACT_CHUNK, overrides=over)
    from repro_torch.pytree import tree_leaves

    cfg = dataclasses.replace(cell.cfg, moe_impl="gather", moe_mesh=None)
    full = dataclasses.replace(model.get_config(LM_ARCH), num_layers=TRAIN_LAYERS)
    if ([t.shape for t in tree_leaves(model.abstract_params(cfg))]
            != [t.shape for t in tree_leaves(model.abstract_params(full))]):
        raise AssertionError("16a: padded(2) changed deepseek-moe-16b's parameter layout")
    log(f"phase 16a: {LM_ARCH} at full width, {cfg.num_layers} layers, float32, capacity "
        f"factor 8, on a {SHARD_MESH[0]} x {SHARD_MESH[1]} mesh of one card ({mesh})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    state = tstep.train_state_init(gen, cfg)
    lp = {k: v[0] for k, v in state.params["layers"].items()}
    x = torch.randn(SHARD_A2A_TOKENS, cfg.d_model, generator=gen, device=dev)
    with torch.no_grad():
        sh.reset_collectives()
        got, a2a_ms = host_ms(lambda: moe_ffn_a2a(x, lp, cell.cfg, mesh))
        a2a = sh.collective_counts()
        want = moe_lib.moe_ffn_dense_oracle(x, lp, cfg)
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= SHARD_ORACLE_ATOL):
        raise AssertionError(f"16a moe_ffn_a2a off the dense oracle by {err:.3e}")
    log(f"  moe_ffn_a2a on {SHARD_A2A_TOKENS} tokens ({SHARD_A2A_TOKENS // mesh.size} a "
        f"position, {cfg.num_experts // SHARD_MESH[1]} experts a model block) == "
        f"moe_ffn_dense_oracle: max_abs_err {err:.3e} (tol {SHARD_ORACLE_ATOL}, "
        f"max|y| {float(want.abs().max()):.4f}); {a2a_ms:.1f} ms (host clock, synced); "
        f"{collective_line(a2a)}")
    del lp, x, got, want

    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    ref = tree_map(torch.clone, state)
    ref, rm = tstep.make_train_step(cfg, loss_chunk=TRAIN_EXACT_CHUNK)(ref, batch)
    placed = sh.place(state, cell.jitted.in_specs[0], mesh)
    del state
    free_card()
    sh.reset_collectives()
    (placed, pm), ms = host_ms(lambda: cell.jitted(placed, batch))
    counts = sh.collective_counts()
    peak = torch.cuda.max_memory_allocated()
    lerr = abs(float(pm["loss"]) - float(rm["loss"]))
    gerr = abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) / abs(float(rm["grad_norm"]))
    if lerr > SHARD_LOSS_ATOL or gerr > SHARD_GNORM_RTOL:
        raise AssertionError(f"16a: loss {float(pm['loss'])} vs {float(rm['loss'])}, grad "
                             f"norm {float(pm['grad_norm'])} vs {float(rm['grad_norm'])}")
    lr_1 = float(cosine_schedule(3e-4, 100, 10_000)(rm["step"]))
    held = hold_train_state("16a sharded step vs single-device step", placed, ref, lr_1)
    log(f"  the a2a train cell's step at batch {B} x {S} == the single-device train_step on "
        f"the same state: loss {float(pm['loss']):.6f} vs {float(rm['loss']):.6f} (abs err "
        f"{lerr:.2e}, tol {SHARD_LOSS_ATOL}), grad norm rel err {gerr:.2e} (tol "
        f"{SHARD_GNORM_RTOL}); {held}; {ms:.0f} ms (host clock, synced); peak device "
        f"memory {peak / 2**30:.2f} GiB; {collective_line(counts)}")


def phase_shard_lm_timed(dev, smi):
    """The a2a train cell at 8 x 512 in the registry's bfloat16 compute, 6
    steps by CUDA events beside 15a's single-device step; the prefill and
    decode cells against the single-device forward and decode_step."""
    from repro_torch import sharding as sh
    from repro_torch.data import DataState, make_batch_iterator
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    from repro_torch.pytree import tree_map
    from repro_torch.train import step as tstep

    free_card()
    mesh = shard_mesh(dev)
    B, S = TRAIN_BATCH
    with shape_cut("train_4k", B, S):
        cell = build_cell(LM_ARCH, "train_4k", mesh, depth_periods=TRAIN_LAYERS,
                          moe_impl="a2a")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    state = tstep.train_state_init(gen, dataclasses.replace(cell.cfg, moe_impl="gather",
                                                            moe_mesh=None))
    n = model.param_count(state.params)
    placed = sh.place(state, cell.jitted.in_specs[0], mesh)
    del state
    log(f"phase 16b: build_cell({LM_ARCH!r}, 'train_4k' cut to {B} x {S}, {SHARD_MESH[0]} x "
        f"{SHARD_MESH[1]} mesh of one card, depth_periods={TRAIN_LAYERS}, moe_impl='a2a'); "
        f"{n:,} float32 parameters, bfloat16 compute; placed state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    it = make_batch_iterator(cell.cfg.vocab_size, S, B, state=DataState(seed=SEED), device=dev)
    events, metrics = [], []
    sh.reset_collectives()
    t0 = time.perf_counter()
    for step, batch in it:
        if step >= SHARD_STEPS:
            break
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        placed, m = cell.jitted(placed, batch)
        ev[1].record()
        events.append(ev)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sh.collective_counts()
    ms = [a.elapsed_time(b) for a, b in events]
    med = median(ms[1:])
    for i, (m, t) in enumerate(zip(metrics, ms)):
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"16b step {i}: loss {loss}, grad norm {gn}")
        log(f"  step {i:2d} loss {loss:.4f} grad norm {gn:.4f} ({t:.2f} ms)")
    single = TIMED.get("15a")
    beside = (f"; 15a's single-device step {single[0]:.2f} ms ({med / single[0]:.2f}x), its "
              f"peak {single[1] / 2**30:.2f} GiB" if single else "")
    log(f"  sharded train step: {med:.2f} ms (CUDA events, median of steps 2-{SHARD_STEPS}; "
        f"first {ms[0]:.2f}, min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}); "
        f"{B * S / med * 1e3:,.0f} tok/s; wall {wall:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{beside}; a step: "
        f"{collective_line(counts, SHARD_STEPS)} ({smi})")
    # the single controller's own copies, apart: the state gathered whole,
    # then written back into its blocks (the same bytes each step moves)
    parts = {"gather": [], "write back": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        whole = sh.gather(placed)
        ev[1].record()
        tree_map(sh.write_into, placed, whole)
        ev[2].record()
        torch.cuda.synchronize()
        parts["gather"].append(ev[0].elapsed_time(ev[1]))
        parts["write back"].append(ev[1].elapsed_time(ev[2]))
        del whole
    log("  of a step, measured apart (CUDA events, median of 3): " + ", ".join(
        f"{k} {median(v):.2f} ms" for k, v in parts.items()) + f" of the state's "
        f"{counts['all-gather']['bytes'] / SHARD_STEPS / 1e9:.3f} GB (read and written "
        f"once each way: {2 * counts['all-gather']['bytes'] / SHARD_STEPS / HBM_BYTES_PER_S * 1e3:.2f} "
        f"ms at 3.35 TB/s)")
    del placed, metrics
    free_card()

    over = dict(moe_capacity_factor=8.0)
    Bp, Sp = SHARD_PREFILL
    with shape_cut("prefill_32k", Bp, Sp):
        pcell = build_cell(LM_ARCH, "prefill_32k", mesh, depth_periods=TRAIN_LAYERS,
                           moe_impl="auto", overrides=over)
    single_cfg = dataclasses.replace(pcell.cfg, moe_impl="gather", moe_mesh=None)
    params = tf.init_params(gen, single_cfg, torch.bfloat16)
    toks = torch.randint(0, single_cfg.vocab_size, (Bp, Sp), generator=gen, device=dev,
                         dtype=torch.int32)
    pparams = sh.place(params, pcell.jitted.in_specs[0], mesh)
    sh.reset_collectives()
    got, p_ms = host_ms(lambda: pcell.jitted(pparams, {"tokens": toks}).tensor())
    pcounts = sh.collective_counts()
    with torch.no_grad():
        want = (tf.forward_hidden(params, single_cfg, toks)[:, -1]
                @ params["lm_head"].to(torch.bfloat16))
    perr = close_rel("16b prefill", got, want, SHARD_BF16_REL)
    log(f"  prefill cell ({Bp} x {Sp}, moe_impl {pcell.cfg.moe_impl}, capacity factor 8) == "
        f"the single-device forward's last-position logits: max err {perr:.2e} of max|want| "
        f"(tol {SHARD_BF16_REL}); {p_ms:.0f} ms (host clock, synced); "
        f"{collective_line(pcounts)}")
    del pparams, got, want

    Bd, L, steps = SHARD_DECODE
    with shape_cut("decode_32k", Bd, L):
        dcell = build_cell(LM_ARCH, "decode_32k", mesh, depth_periods=TRAIN_LAYERS,
                           moe_impl="auto", overrides=over)
    dcfg = dataclasses.replace(dcell.cfg, dispatch_spec=None)
    if dataclasses.replace(single_cfg, dispatch_spec=None) != dcfg:
        raise AssertionError("16b: the decode cell's config is not the prefill's")
    dparams = sh.place(params, dcell.jitted.in_specs[0], mesh)
    cache = tf.init_cache(dcfg, Bd, L, torch.bfloat16, device=dev)
    pcache = sh.place(tf.init_cache(dcfg, Bd, L, torch.bfloat16, device=dev),
                      dcell.jitted.in_specs[1], mesh)
    dtoks = torch.randint(0, dcfg.vocab_size, (steps, Bd), generator=gen, device=dev,
                          dtype=torch.int32)
    sh.reset_collectives()
    derr, d_ms = 0.0, []
    for t in range(steps):
        (pl, pcache), ms_t = host_ms(lambda: dcell.jitted(dparams, pcache, dtoks[t]))
        d_ms.append(ms_t)
        with torch.no_grad():
            wl, cache = tf.decode_step(params, dcfg, cache, dtoks[t])
        derr = max(derr, close_rel(f"16b decode step {t}", pl.tensor(), wl, SHARD_BF16_REL))
    dcounts = sh.collective_counts()
    log(f"  decode cell (batch {Bd}, max-len {L}, moe_impl {dcell.cfg.moe_impl} under "
        f"dispatch_spec {dcell.cfg.dispatch_spec!r}) x {steps} steps == the single-device "
        f"decode_step: max err {derr:.2e} of max|want|; median {median(d_ms):.1f} ms a step "
        f"(host clock, synced); a step: {collective_line(dcounts, steps)}")


def close_rel(label, got, want, rel) -> float:
    """``got`` within ``rel`` of max|want|, both finite; returns the ratio."""
    got, want = got.float(), want.float()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{label}: non-finite values")
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if err > rel:
        raise AssertionError(f"{label}: off by {err:.3e} of max|want| > {rel}")
    return err


def phase_shard_dryrun():
    """The dry run of deepseek-moe-16b train_4k on a 16 x 16 mesh of meta
    positions, and its roofline row under the H100's constants."""
    import tempfile

    from repro_torch.launch import dryrun, roofline

    with tempfile.TemporaryDirectory(prefix="flix-dryrun-") as tmp:
        r, ms = host_ms(lambda: dryrun.run_cell(LM_ARCH, "train_4k", False, Path(tmp)))
        rec = r["recon"]
        for key in ("flops", "collective_bytes"):
            if rec["formula"][key] != rec[key]:
                raise AssertionError(f"16c: depth reconstruction of {key} "
                                     f"{rec['formula'][key]} != direct {rec[key]}")
        row = roofline.analyze_cell(Path(tmp) / f"{LM_ARCH}__train_4k__single.json")
    mem = r["memory"]
    log(f"phase 16c: python -m repro_torch.launch.dryrun --arch {LM_ARCH} --shape train_4k "
        f"--mesh single: {r['devices']} meta positions, {rec['n_periods']} layers; FLOPs "
        f"{r['cost']['flops_program']:.4e} in all, {r['cost']['flops']:.4e} a chip (the "
        f"depth-1/2 reconstruction equal); collectives {collective_line(r['collectives'])}; "
        f"a position holds {mem['argument_size_in_bytes'] / 2**30:.3f} GiB of arguments, "
        f"{mem['output_size_in_bytes'] / 2**30:.3f} GiB of outputs; {ms / 1e3:.1f} s")
    for line in roofline.render_table([row]).splitlines():
        log(f"  | {line}")
    log(f"  (roofline constants: {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{roofline.HBM_BW / 1e12:.2f} TB/s, link {roofline.LINK_BW / 1e9:.0f} GB/s)")


def no_kernel_launched(label, run) -> None:
    """Run one part of phase 15 or 16 between a reset and a read of the
    launch counts: the training and sharded paths run no kernel of ours
    (the reference trainer and its sharding reach no Pallas kernel)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    run()
    launched = {k: LAUNCHES[k] for k in KERNELS if LAUNCHES[k]}
    if launched:
        raise AssertionError(f"{label}: the training path launched {launched}")
    log(f"  {label} launched none of the FliX kernels, as designed")
    free_card()


def merge(measured: dict, new: dict) -> None:
    """Add one phase's kernel measurements to ``measured``.  A kernel that an
    earlier phase measured (the fence rows: phases 4 and 5) keeps that
    phase's times and adds this phase's launches and worst error."""
    for k, m in new.items():
        if k in measured:
            old = measured[k]
            m = dict(old, launches=old["launches"] + m["launches"],
                     err=max(old["err"], m["err"]))
        measured[k] = m


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"phase 1: card {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"  nvidia-smi: {smi}")

    t0 = time.perf_counter()
    path, nvcc_log = _build.build()
    _build.load_library()
    log(f"phase 2: built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    check = KernelCheck()
    phases = [
        ("3", lambda: phase_kernels(dev, check)),
        ("3d", lambda: phase_kernel_ops(dev, check)),
        ("3g", lambda: phase_walk(dev, check)),
        ("3f", lambda: phase_gemm(dev, check)),
        ("3i", lambda: phase_tiered_small(dev)),
        ("3j", lambda: phase_shard_small(dev)),
        ("3k", lambda: phase_warps(dev)),
        ("4", lambda: merge(measured, phase_main(dev))),
        ("4b", lambda: serve_launches.append(phase_autotune(dev))),
        ("5", lambda: merge(measured, phase_fig9(dev, check))),
        ("6", lambda: serve_launches.append(phase_serve(dev))),
        ("7", lambda: merge(measured, phase_range(dev, check))),
        ("8", lambda: merge(measured, phase_moe(dev, check))),
        ("9", lambda: serve_launches.append(phase_durable(dev, smi))),
        ("10", lambda: serve_launches.append(phase_gateway(dev, smi))),
        ("11a", lambda: serve_launches.append(phase_tiered(dev, smi))),
        ("11b", lambda: serve_launches.append(phase_tiered_durable(dev, smi))),
        ("12a", lambda: serve_launches.append(phase_shard(dev, smi))),
        ("12b", lambda: serve_launches.append(phase_shard_durable(dev, smi))),
        ("13", lambda: serve_launches.append(phase_baselines(dev, smi))),
        ("14a", lambda: phase_lm_exact(dev)),
        ("14b", lambda: serve_launches.append(phase_lm_serve(dev, smi))),
        ("14c", lambda: serve_launches.append(phase_lm_paths(dev))),
        ("15a", lambda: no_kernel_launched("15a", lambda: (phase_train_exact(dev),
                                                           phase_train_timed(dev, smi)))),
        ("15b", lambda: no_kernel_launched("15b", lambda: phase_train_driver(dev))),
        ("15c", lambda: no_kernel_launched("15c", lambda: phase_train_example(dev))),
        ("16a", lambda: no_kernel_launched("16a", lambda: phase_shard_lm_exact(dev))),
        ("16b", lambda: no_kernel_launched("16b", lambda: phase_shard_lm_timed(dev, smi))),
        ("16c", lambda: no_kernel_launched("16c", phase_shard_dryrun)),
    ]
    measured, serve_launches = {}, []
    for label, run in phases:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        log(f"phase {label} took {time.perf_counter() - t0:.1f} s")
    for launches in serve_launches:
        for k, c in launches.items():
            measured[k]["launches"] += c

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        m = measured[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": CSRC + source,
            "replaces": replaces,
            "launches": m["launches"],
            "max_abs_err": max(m["err"], check.err[kname]),
            "ms": m["ms"],
            # where ms is queued device time, the kernel's time as a call too
            **({"call_ms": m["call_ms"]} if "call_ms" in m else {}),
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m.get("bound_by", "bytes"),
            "library_ms": m.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    # the run drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
