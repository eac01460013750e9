#!/usr/bin/env python3
"""Where one decode step of the port's LM server goes on one CUDA card, at
chip_smoke.py phase 14b's sizes (deepseek-moe-16b, 16 sequences, max-len
128):

    python3 tools/torch_lm_profile.py [--steps 4] [--rows 12]

It draws the model as ``repro_torch.launch.serve`` does (float32
parameters from seed 0, a float32 cache, the config's bfloat16 compute),
decodes two warm steps, then prints:

  * the median of ``--steps`` decode steps (CUDA events) beside the bound
    of the float32 parameter bytes read once at 3.35 TB/s;
  * the per-layer weight cast alone (``transformer._cast`` of every layer,
    as each step runs it), beside its own bound (4 bytes read and 2 written
    a parameter);
  * ``--steps`` decode steps under ``torch.profiler``: the ops by self
    device time (the top ``--rows``), their sums a step by kind (the cast's
    copies, the batched products of the MoE windows and attention, the
    dense products, the rest), and the device time over the host time (the
    card's busy share).

It needs a card and exits non-zero without one.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
ARCH, BATCH, MAX_LEN = "deepseek-moe-16b", 16, 128  # phase 14b's

ap = argparse.ArgumentParser(prog="torch_lm_profile")
ap.add_argument("--steps", type=int, default=4)
ap.add_argument("--rows", type=int, default=12)
args = ap.parse_args()

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_lm_profile: no CUDA device available")
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.models import model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

dev = torch.device("cuda")


def median_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, by CUDA events."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return median(out)


def kind(op: str) -> str:
    if op in ("aten::copy_", "aten::_to_copy"):
        return "copies (the weight cast, dtype moves)"
    if op in ("aten::bmm", "aten::baddbmm"):
        return "batched products (MoE windows, attention)"
    if op in ("aten::mm", "aten::addmm"):
        return "dense products"
    return "rest"


cfg = model.get_config(ARCH)
compute = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
gen = torch.Generator(device=dev)
gen.manual_seed(0)
params = tf.init_params(gen, cfg)
cache = tf.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32, device=dev)
token = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen, device=dev,
                      dtype=torch.int32)
n_params = model.param_count(params)
n_layer = sum(v.numel() for v in params["layers"].values())
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
print(f"{ARCH}: {n_params:,} float32 parameters, {n_layer:,} in the stacked layers; "
      f"batch {BATCH}, max-len {MAX_LEN}; {smi}; torch {torch.__version__}", flush=True)


def step():
    global cache, token
    logits, cache = tf.decode_step(params, cfg, cache, token)
    token = torch.argmax(logits, dim=-1).to(torch.int32)


def cast_all():
    for i in range(cfg.num_layers):
        tf._cast(tf._layer(params["layers"], i), compute)


with torch.no_grad():
    step()
    step()  # warm
    dec = median_ms(step, args.steps)
    cast = median_ms(cast_all, 3)
    bound = n_params * 4 / HBM_BYTES_PER_S * 1e3
    cast_bound = n_layer * 6 / HBM_BYTES_PER_S * 1e3
    print(f"decode step: {dec:.3f} ms (median of {args.steps}), bound {bound:.3f} ms "
          f"({dec / bound:.2f}x)", flush=True)
    print(f"every layer's cast to {str(compute).split('.')[-1]} alone: {cast:.3f} ms "
          f"(median of 3), bound {cast_bound:.3f} ms ({cast / cast_bound:.2f}x)", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / args.steps

events = prof.key_averages()
print(events.table(sort_by="self_device_time_total", row_limit=args.rows), flush=True)
kinds = {}
for e in events:
    if e.key.startswith("aten::"):
        ms = e.self_device_time_total / 1e3 / args.steps
        kinds[kind(e.key)] = kinds.get(kind(e.key), 0.0) + ms
total = sum(kinds.values())
print(f"a step under the profiler: {host:.3f} ms on the host clock (synced); device time "
      f"{total:.3f} ms ({total / host:.1%} busy)", flush=True)
for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
    print(f"  {k}: {ms:.3f} ms a step ({ms / total:.1%})", flush=True)
