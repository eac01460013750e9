"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles every (architecture × input-shape) cell
on 256 or 512 fake host devices and records XLA's ``memory_analysis()``,
``cost_analysis()`` and the collectives parsed from the compiled SPMD
module; it never runs on a chip.  The port has no compiler to ask, so it
*runs* the cell's step (``launch/steps.py``'s ``build_cell``) on the
``"meta"`` device — shapes and dtypes, nothing allocated — over a
production mesh whose 256 or 512 positions are all ``"meta"``, and records:

  * ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
    the whole program (``flops_program``: every matmul, einsum and
    attention product the single controller runs, recompute included),
    and per chip as that over the mesh size;
  * ``collectives``: the single controller's copies by kind
    (``repro_torch.sharding``'s counters: gathers, re-placements, the MoE
    all-to-all), count and bytes over the whole program;
    ``collective_bytes_total`` their sum; the ``recon`` entries per chip,
    as the roofline reads them;
  * ``memory``: the bytes a mesh position holds of the placed arguments,
    outputs and donated outputs (the largest over positions), from the
    placed blocks.

No counterpart, recorded as null: ``temp_size_in_bytes`` (XLA's scratch
for the compiled program), ``generated_code_size_in_bytes`` (its machine
code), ``cost.bytes_accessed`` (XLA's HBM traffic estimate) and
``cost.transcendentals``.  There is no HLO, so the reference's
``collective_bytes(hlo_text)`` / ``_shape_bytes`` have no counterpart
either.  Torch counts every layer, so ``recon`` is the full-depth count
itself; the depth-1 and depth-2 runs stay, and ``recon.formula`` holds the
reference's reconstruction from them (equal to the direct count).

Results land in ``experiments/dryrun_torch/*.json`` (git-ignored).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
NULL_MEMORY = ("temp_size_in_bytes", "generated_code_size_in_bytes")


def _analyze(cell) -> dict:
    """Run ``cell`` once on its (meta) mesh, counting FLOPs and collectives."""
    sharding.reset_collectives()
    with FlopCounterMode(display=False) as fc:
        cell.jitted(*cell.abstract_args)
    flops = float(fc.get_total_flops())
    n = cell.jitted.mesh.size
    colls = sharding.collective_counts()
    mem = dict(cell.jitted.last_memory)
    mem.update({k: None for k in NULL_MEMORY})
    return {
        "memory": mem,
        "cost": {
            "flops": flops / n,
            "flops_program": flops,
            "bytes_accessed": None,
            "transcendentals": None,
        },
        "collectives": colls,
        "collective_bytes_total": sum(v["bytes"] for v in colls.values()),
    }


def _per_chip_collectives(a: dict, n: int) -> float:
    return a["collective_bytes_total"] / n


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: Path,
    *,
    suffix: str = "",
    mesh=None,
    **cell_kwargs,
) -> dict:
    """Run the production program, then depth-1 and depth-2 programs, on a
    mesh of meta positions (the production mesh unless ``mesh`` is given),
    and write the cell's JSON."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, layer_period

    mesh_name = ("multi" if multi_pod else "single") + suffix
    t0 = time.time()
    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    n = mesh.size
    with mesh:
        cell = build_cell(arch, shape_name, mesh, **cell_kwargs)
        prod = _analyze(cell)
        t_run = time.time() - t0
        direct = {
            "flops": prod["cost"]["flops"],
            "bytes_accessed": None,
            "collective_bytes": _per_chip_collectives(prod, n),
        }
        kind = cell.meta["kind"]
        if kind in ("train", "prefill"):
            d1 = build_cell(arch, shape_name, mesh, depth_periods=1, **cell_kwargs)
            a1 = _analyze(d1)
            d2 = build_cell(arch, shape_name, mesh, depth_periods=2, **cell_kwargs)
            a2 = _analyze(d2)
            period = layer_period(cell.cfg)
            n_periods = cell.cfg.num_layers // period

            def formula(f):
                return f(a1) + (n_periods - 1) * (f(a2) - f(a1))

            recon = {
                "n_periods": n_periods,
                "period": period,
                **direct,
                "formula": {
                    "flops": formula(lambda a: a["cost"]["flops"]),
                    "collective_bytes": formula(lambda a: _per_chip_collectives(a, n)),
                },
                "depth1": a1,
                "depth2": a2,
            }
        else:
            # decode runs every layer once: the count is the program's
            recon = direct

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "devices": n,
        "meta": cell.meta,
        **prod,
        "recon": recon,
        "run_s": round(t_run, 2),
        "ok": True,
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--suffix", default="", help="variant tag for §Perf runs")
    ap.add_argument("--strategy", default="tp_sp", choices=["tp_sp", "fsdp"])
    ap.add_argument("--no-moe-token-shard", action="store_true")
    ap.add_argument("--moe-impl", default="gather", choices=["gather", "a2a", "auto"])
    ap.add_argument(
        "--override",
        action="append",
        default=[],
        help="cfg field override key=int (repeatable)",
    )
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    cell_kwargs = dict(
        strategy=args.strategy,
        moe_token_shard=not args.no_moe_token_shard,
        moe_impl=args.moe_impl,
    )
    if args.override:
        cell_kwargs["overrides"] = {
            kv.split("=")[0]: int(kv.split("=")[1]) for kv in args.override
        }

    from repro_torch.models.config import cells_for
    from repro_torch.models.model import list_archs

    if args.all:
        cells = [(a, s) for a in list_archs() for s in cells_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch, shape in cells:
        for m in meshes:
            path = out_dir / f"{arch}__{shape}__{m}{args.suffix}.json"
            if args.skip_existing and path.exists():
                print(f"skip {arch} {shape} {m}", flush=True)
                continue
            try:
                r = run_cell(arch, shape, m == "multi", out_dir, suffix=args.suffix,
                             **cell_kwargs)
                print(
                    f"OK  {arch:18s} {shape:12s} {m:6s} "
                    f"flops={r['cost']['flops']:.3e} "
                    f"coll={r['recon']['collective_bytes']:.3e}B "
                    f"args={r['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                    f"run={r['run_s']}s",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — record, continue sweep
                failures.append((arch, shape, m, repr(e)))
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": m,
                                            "ok": False, "error": traceback.format_exc()},
                                           indent=2))
                print(f"FAIL {arch} {shape} {m}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures", file=sys.stderr)
        sys.exit(1)
    print("\nall cells ran")


if __name__ == "__main__":
    main()
