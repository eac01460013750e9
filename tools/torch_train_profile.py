#!/usr/bin/env python3
"""Where one train step of the port goes on one CUDA card, at chip_smoke.py
phase 15a's timed sizes (deepseek-moe-16b at full width, depth 2, float32
parameters, bfloat16 compute, batch 8 x 512, remat, loss_chunk 512, the
data pipeline's stream):

    python3 tools/torch_train_profile.py [--steps 4] [--rows 15]

It builds the state as phase 15a does, runs two warm steps, then prints:

  * the median of ``--steps`` steps (CUDA events) beside the step's bound
    (``chip_smoke.train_step_flops`` at 989 TFLOP/s, or AdamW's 28 bytes a
    parameter at 3.35 TB/s), and the parts by CUDA events recorded around
    the gradient clip and ``adamw_update`` inside each step (the rest is
    the forward and backward passes);
  * ``--steps`` steps under ``torch.profiler``: the ops by self device
    time (the top ``--rows``), their sums a step by kind (AdamW, the clip,
    dtype copies (the weights' casts and their gradients' casts back),
    dense products, the LM head and loss, the MoE capacity windows,
    attention, routing and embedding gathers and scatters, softmax and
    logsumexp, the rest), the device time over the host time (the card's
    busy share) and the ops issued a step.

It needs a card and exits non-zero without one.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parent.parent

ap = argparse.ArgumentParser(prog="torch_train_profile")
ap.add_argument("--steps", type=int, default=4)
ap.add_argument("--rows", type=int, default=15)
args = ap.parse_args()

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_train_profile: no CUDA device available")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.data import DataState, make_batch_iterator  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

dev = torch.device("cuda")
cfg = cs.dataclasses.replace(model.get_config(cs.LM_ARCH), num_layers=cs.TRAIN_LAYERS)
B, S = cs.TRAIN_BATCH
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 17)
state = tstep.train_state_init(gen, cfg)
n = model.param_count(state.params)
E_v = cfg.num_experts * cfg.moe_split
flops = cs.train_step_flops(cfg, B, S)
bound = max(flops / cs.BF16_FLOPS, cs.adamw_bytes(n) / cs.HBM_BYTES_PER_S) * 1e3
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
print(f"{cs.LM_ARCH} depth {cfg.num_layers}: {n:,} float32 parameters, bfloat16 compute, "
      f"batch {B} x {S}; {smi}; torch {torch.__version__}", flush=True)

parts: dict[str, list] = {"clip": [], "adamw": []}


def timed(name, fn):
    """``fn`` with CUDA events recorded around each call, under a profiler
    label of ``name``."""
    def wrapper(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.profiler.record_function(name):
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
        parts[name].append(ev)
        return out
    return wrapper


tstep.clip_by_global_norm_ = timed("clip", tstep.clip_by_global_norm_)
tstep.adamw_update = timed("adamw", tstep.adamw_update)
step_fn = tstep.make_train_step(cfg, remat=True, loss_chunk=512)
it = make_batch_iterator(cfg.vocab_size, S, B, state=DataState(seed=cs.SEED), device=dev)


def run(k):
    global state
    evs = []
    for _ in range(k):
        _, batch = next(it)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, _ = step_fn(state, batch)
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


run(2)  # warm
for v in parts.values():
    v.clear()
ms = run(args.steps)
med = median(ms)
split = {k: median(a.elapsed_time(b) for a, b in v) for k, v in parts.items()}
print(f"train step: {med:.3f} ms (CUDA events, median of {args.steps}; "
      f"{min(ms):.3f}-{max(ms):.3f}), bound {bound:.3f} ms ({med / bound:.2f}x); "
      f"{B * S / med * 1e3:,.0f} tok/s", flush=True)
print(f"  of it: forward + backward {med - split['clip'] - split['adamw']:.3f} ms, "
      f"clip {split['clip']:.3f} ms, adamw_update {split['adamw']:.3f} ms (bound "
      f"{cs.adamw_bytes(n) / cs.HBM_BYTES_PER_S * 1e3:.3f} ms)", flush=True)


def kind(e, region) -> str:
    name = e.name
    if region:
        return {"adamw": "AdamW", "clip": "clip (global norm, scale)"}[region]
    if name in ("aten::copy_", "aten::_to_copy"):
        return "dtype copies (weight casts, their gradients)"
    if name in ("aten::mm", "aten::addmm"):
        if any(cfg.vocab_size in s for s in e.input_shapes if s):
            return "LM head and loss products"
        return "dense products"
    if name in ("aten::bmm", "aten::baddbmm"):
        shapes = [s for s in e.input_shapes if s]
        if shapes and shapes[0] and shapes[0][0] == E_v:
            return "MoE capacity windows"
        return "attention products"
    if any(k in name for k in ("index", "sort", "gather", "scatter", "embedding", "searchsorted")):
        return "gathers, scatters, sorts (routing, embedding)"
    if any(k in name for k in ("softmax", "logsumexp")):
        return "softmax, logsumexp"
    return "rest (elementwise, reductions)"


def region_of(e):
    p = e.cpu_parent
    while p is not None:
        if p.name in ("adamw", "clip"):
            return p.name
        p = p.cpu_parent
    return None


acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
    t0 = time.perf_counter()
    run(args.steps)
    host = (time.perf_counter() - t0) * 1e3 / args.steps

print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=args.rows),
      flush=True)
kinds, issued = {}, 0
for e in prof.events():
    if not e.name.startswith("aten::"):
        continue
    parent = e.cpu_parent
    if parent is None or not parent.name.startswith("aten::"):
        issued += 1
    dev_us = getattr(e, "self_device_time_total", 0)
    if dev_us:
        k = kind(e, region_of(e))
        kinds[k] = kinds.get(k, 0.0) + dev_us / 1e3 / args.steps
total = sum(kinds.values())
print(f"a step under the profiler: {host:.3f} ms on the host clock (synced); device time "
      f"{total:.3f} ms ({total / host:.1%} busy); {issued / args.steps:,.0f} aten ops "
      f"issued a step", flush=True)
for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]):
    print(f"  {k}: {v:.3f} ms a step ({v / total:.1%})", flush=True)
