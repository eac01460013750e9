"""Roofline analysis (port of ``repro/launch/roofline.py``).

Reads the port's dry-run JSONs (``experiments/dryrun_torch``) and derives,
per (arch × shape) on a mesh:

    compute term    = FLOPs_per_chip / peak_FLOPs              [s]
    memory term     = bytes_per_chip / HBM_bw                  [s]
    collective term = collective_bytes_per_chip / link_bw      [s]

Conventions:
  * the dry run's FLOPs are ``torch.utils.flop_counter``'s count of the
    whole program over the mesh size; its collective bytes are the single
    controller's copies by kind over the mesh size (``launch/dryrun.py``);
  * the dry run has no counterpart of XLA's ``bytes accessed`` or temp
    size: those fields are null, and so are the memory term and
    ``temp_gib``; the dominant term is the larger of the others;
  * MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill/decode), N analytic from
    the *unpadded* published config (N_active for MoE) — the ratio against
    the counted FLOPs exposes padding, remat, and dispatch waste.

Hardware: one NVIDIA H100 SXM5 80GB (HBM3), the card ``chip_smoke.py``
runs on (its power limit, 700 W, is printed beside every measurement):
989 TFLOP/s dense bf16 tensor-core peak and 3.35 TB/s HBM3, from NVIDIA's
H100 data sheet; ``LINK_BW`` is NVLink 4's 900 GB/s a card (18 links of 50
GB/s, both directions together), the bandwidth a card of an all-to-all
NVLink host has toward its peers, as the reference's 50 GB/s is one ICI
link's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.model import get_config

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 900e9

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def analytic_params(cfg: ModelConfig, *, active: bool = False) -> int:
    """Parameter count from the published (unpadded) config."""
    D = cfg.d_model
    n = cfg.vocab_size * D  # embed
    if not cfg.tie_embeddings:
        n += D * cfg.vocab_size  # lm head
    dh = cfg.resolved_head_dim

    def dense_attn():
        a = D * cfg.num_heads * dh * 2 + D * cfg.num_kv_heads * dh * 2
        if cfg.qkv_bias:
            a += cfg.num_heads * dh + 2 * cfg.num_kv_heads * dh
        return a

    def dense_mlp(f):
        return 3 * D * f

    if cfg.family in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = 2 * D * di + 2 * D * N + D * H + cfg.conv_kernel * (di + 2 * N)
        per += di * D + di + 3 * H
        n += cfg.num_layers * per
        if cfg.family == "hybrid":
            n += dense_attn() + dense_mlp(cfg.d_ff)
        return n

    per = dense_attn()
    if cfg.family == "moe":
        e_used = (cfg.top_k if active else cfg.num_experts)
        per += D * cfg.num_experts                      # router
        per += e_used * 3 * D * cfg.moe_d_ff            # routed experts
        per += cfg.num_shared_experts * 3 * D * cfg.moe_d_ff
    else:
        per += dense_mlp(cfg.d_ff)
    n += cfg.num_layers * per
    return n


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    n = analytic_params(cfg, active=(cfg.family == "moe"))
    if sh["kind"] == "train":
        return 6.0 * n * B * S
    if sh["kind"] == "prefill":
        return 2.0 * n * B * S
    return 2.0 * n * B  # decode: one token per sequence


def analyze_cell(path: Path) -> dict | None:
    r = json.loads(Path(path).read_text())
    if not r.get("ok"):
        return {"arch": r["arch"], "shape": r["shape"], "ok": False}
    rec = r["recon"]
    chips = r["devices"]
    flops_pd = rec["flops"]
    bytes_pd = rec["bytes_accessed"]
    coll_pd = rec["collective_bytes"]
    t_c = flops_pd / PEAK_FLOPS
    t_m = None if bytes_pd is None else bytes_pd / HBM_BW
    t_n = coll_pd / LINK_BW
    terms = [("compute", t_c), ("memory", t_m), ("collective", t_n)]
    known = [(k, t) for k, t in terms if t is not None]
    dominant = max(known, key=lambda kv: kv[1])[0]
    t_max = max(t for _, t in known)
    mf = model_flops(r["arch"], r["shape"])
    hlo_total = flops_pd * chips
    temp = r["memory"]["temp_size_in_bytes"]
    return {
        "arch": r["arch"],
        "shape": r["shape"],
        "mesh": r["mesh"],
        "chips": chips,
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_n,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": mf / hlo_total if hlo_total else 0.0,
        "roofline_fraction": mf / PEAK_FLOPS / chips / t_max if t_max > 0 else 0.0,
        "temp_gib": None if temp is None else temp / 2**30,
        "ok": True,
    }


def _cell(x, fmt: str) -> str:
    return "n/a" if x is None else format(x, fmt)


def render_table(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful FLOP ratio | roofline frac | temp GiB |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAILED |||||||")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{_cell(r['memory_s'], '.4f')} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {_cell(r['temp_gib'], '.1f')} |"
        )
    return hdr + "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DRYRUN_DIR))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(Path(args.dir).glob(f"*__{args.mesh}.json")):
        row = analyze_cell(path)
        if row:
            rows.append(row)
    print(render_table(rows))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
