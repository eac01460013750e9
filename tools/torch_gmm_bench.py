#!/usr/bin/env python3
"""Time the port's grouped GEMM on one CUDA card, at chip_smoke.py's phase-8
shapes and on dense shapes, with the package under a given ``src`` directory
(default: this checkout's), so that two trees can be compared in one run:

    python3 tools/torch_gmm_bench.py [--src DIR] [--tag NAME] [--dense]

For each of the 8 main-path GEMMs (runs A, B, C and skew of phase 8, up and
down) it checks the kernel against ``grouped_matmul_reference`` and prints
the kernel's time by CUDA events, ``torch._grouped_mm``'s for bf16 x bf16,
and the bound.  ``--dense`` adds one expert holding every row (a dense
GEMM) against ``torch.matmul`` (cuBLAS, bf16 output) and
``torch._grouped_mm``.  It needs a card and exits non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_gmm_bench", ("--dense", {"action": "store_true"}))

import torch  # noqa: E402
from repro_torch.kernels import grouped_matmul as tg  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402

build(args, tg)
torch.backends.cuda.matmul.allow_tf32 = False
variant = getattr(tg, "kernel_variant", lambda a, w: "-")
gen = torch.Generator(device="cuda")
gen.manual_seed(cs.SEED + 8)
for label, arch, tokens, skew in cs.MOE_RUNS:
    cfg = cs.moe_config(arch)
    E, k = cfg.num_experts, cfg.top_k
    T = tokens or SHAPES["decode_32k"]["global_batch"]
    torch.cuda.empty_cache()
    x, logits, w_up, w_down = cs.moe_inputs(cfg, T, skew, gen)
    plan = md.make_plan(logits, k, E)
    xs, offs = md.dispatch(x, plan, k), plan.group_offsets
    h = torch.nn.functional.silu(tg.grouped_matmul(xs, w_up, offs))
    for name, a, w in (("up", xs, w_up), ("down", h, w_down)):
        cs.close_err(tg.grouped_matmul_reference(a, w, offs), tg.grouped_matmul(a, w, offs),
                     f"{args.tag} {label} {name}")
        ms = cs.timed_ms(lambda: tg.grouped_matmul(a, w, offs))
        lib = cs.grouped_mm_ms(a, w, offs)[0]
        bound = cs.gemm_bound(a, w, offs)[0]
        print(f"{args.tag:>8} {label:>4} {name:>4} {variant(a, w):>5}: kernel {ms:.4f} ms, "
              f"library {'-' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms "
              f"({ms / bound:.2f}x)", flush=True)
    del x, logits, w_up, w_down, xs, h, plan
for T, D, F in ((8192, 6144, 16384), (24576, 2048, 1408)) if args.dense else ():
    x = torch.randn(T, D, device="cuda").bfloat16()
    w = (torch.randn(1, D, F, device="cuda") * 0.02).bfloat16()
    o = torch.tensor([0, T], dtype=torch.int32, device="cuda")
    flop = 2 * T * D * F
    ms = cs.timed_ms(lambda: tg.grouped_matmul(x, w, o))
    mm = cs.timed_ms(lambda: x @ w[0])
    gm = cs.grouped_mm_ms(x, w, o)[0]
    print(f"{args.tag:>8} dense {T}x{D}x{F}: kernel {ms:.4f} ms ({flop / ms / 1e9:.0f} "
          f"TFLOP/s), torch.matmul {mm:.4f} ms ({flop / mm / 1e9:.0f}), torch._grouped_mm "
          f"{gm:.4f} ms ({flop / gm / 1e9:.0f})", flush=True)
    del x, w
