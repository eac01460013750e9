"""Shared cell-building logic for the dry run and roofline tools (port of
``repro/launch/steps.py``).

``build_cell(arch, shape, mesh)`` returns the step function wrapped for the
mesh plus the abstract inputs for one (architecture × input-shape × mesh)
combination — train_step for ``train_*`` shapes, prefill scoring for
``prefill_*``, serve_step (one-token decode against the cache) for
``decode_*`` / ``long_*``.

``abstract_args`` are tensors on the meta device (the port's
``jax.eval_shape``: shapes and dtypes, nothing allocated).  ``jitted`` is
``repro_torch.sharding.Jitted``: called with real tensors of those shapes,
or with trees already placed on the mesh, it gathers them onto the mesh's
first device, runs the step there and places the outputs by their specs,
writing a donated argument (the train state, the decode cache) in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import sharding as sh
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.frontends import prefix_spec
from repro_torch.optim import AdamWState
from repro_torch.sharding import P
from repro_torch.train import TrainState, make_train_step, train_state_init


class Cell(NamedTuple):
    jitted: Any            # sharding.Jitted: the step, specs applied
    abstract_args: tuple   # meta tensors of the arguments' shapes and dtypes
    cfg: ModelConfig       # tp-padded config
    meta: dict


def layer_period(cfg: ModelConfig) -> int:
    """Layers per repeating pattern period (for depth-reconstruction)."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.attention == "local_global":
        return cfg.local_global_ratio + 1
    return 1


def fsdp_param_specs(params, mesh):
    """ZeRO-3-style specs: every param shards its largest trailing dim over
    *all* (data, model) devices; weights are all-gathered per layer at use.
    Wins when per-layer weight bytes < per-layer activation-collective bytes
    (EXPERIMENTS.md §Perf iteration 3)."""
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])

    def spec_for(keys, leaf):
        dims = leaf.shape
        for d in reversed(range(len(dims))):
            if dims[d] % n == 0 and dims[d] >= n:
                return P(*([None] * d), axes, *([None] * (len(dims) - d - 1)))
        return P()  # small params (norms, biases) stay replicated

    return sh.map_with_keys(spec_for, params)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    loss_chunk: int = 512,
    depth_periods: int | None = None,  # None = production depth (scan);
                                       # k = k pattern periods, unrolled
    seq_shard_acts: bool = True,
    strategy: str = "tp_sp",           # "tp_sp" (TP+Megatron-SP) | "fsdp"
    moe_token_shard: bool = True,      # shard MoE dispatch over the data axis
    moe_impl: str = "gather",          # "gather" | "a2a" | "auto"
    overrides: dict | None = None,     # cfg field overrides (perf sweeps)
) -> Cell:
    cfg = model_lib.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    tp = mesh.shape["model"] if strategy == "tp_sp" else 1
    cfg = cfg.padded(mesh.shape["model"]) if strategy == "tp_sp" else cfg.padded(1)
    shp = SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]
    kind = shp["kind"]
    daxes = sh.data_axes(mesh)

    layer_loop = "scan"
    if depth_periods is not None:
        period = layer_period(cfg)
        cfg = dataclasses.replace(cfg, num_layers=depth_periods * period)
        layer_loop = "unroll"

    if strategy == "fsdp":
        all_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
        act_spec = P(all_axes, None, None)
        batch_axes = all_axes
    else:
        act_spec = P(daxes, "model", None) if seq_shard_acts else None
        batch_axes = daxes
        if moe_impl == "auto":
            # a2a needs the token count to tile the full mesh (train/prefill)
            tokens = B * S
            moe_impl = (
                "a2a"
                if kind in ("train", "prefill") and tokens % mesh.devices.size == 0
                else "gather"
            )
        if cfg.family == "moe" and moe_impl == "a2a":
            cfg = dataclasses.replace(cfg, moe_impl="a2a", moe_mesh=mesh)
        elif cfg.family == "moe" and moe_token_shard:
            cfg = dataclasses.replace(cfg, dispatch_spec=P("model", daxes, None))

    if kind == "train":
        state_abs = train_state_init(0, cfg, device="meta")
        if strategy == "fsdp":
            pspecs = fsdp_param_specs(state_abs.params, mesh)
        else:
            pspecs = sh.param_specs(cfg, state_abs.params, tp)
        state_specs = TrainState(
            params=pspecs, opt=AdamWState(step=P(), m=pspecs, v=pspecs)
        )
        text = S - (cfg.frontend_len if cfg.frontend else 0)
        batch_abs = {"tokens": _meta((B, text)), "targets": _meta((B, text))}
        if cfg.frontend:
            batch_abs["prefix_embeds"] = prefix_spec(cfg, B)
        batch_specs = {
            k: P(batch_axes, *([None] * (v.ndim - 1))) for k, v in batch_abs.items()
        }
        step = make_train_step(
            cfg, loss_chunk=loss_chunk, layer_loop=layer_loop, act_spec=act_spec
        )
        jitted = sh.Jitted(step, mesh, (state_specs, batch_specs),
                           out_specs=(state_specs, P()), donate_argnums=(0,))
        return Cell(jitted, (state_abs, batch_abs), cfg, dict(kind=kind, B=B, S=S))

    # inference paths use bf16 params
    params_abs = transformer.init_params(0, cfg, torch.bfloat16, device="meta")
    pspecs = sh.param_specs(cfg, params_abs, tp)

    if kind == "prefill":
        text = S - (cfg.frontend_len if cfg.frontend else 0)
        batch_abs = {"tokens": _meta((B, text))}
        if cfg.frontend:
            batch_abs["prefix_embeds"] = prefix_spec(cfg, B)
        batch_specs = sh.input_specs_sharding(mesh, batch_abs)

        def prefill_step(params, batch):
            with torch.no_grad():
                h = transformer.forward_hidden(
                    params,
                    cfg,
                    batch["tokens"],
                    batch.get("prefix_embeds"),
                    layer_loop=layer_loop,
                    act_spec=act_spec,
                )
                head = (
                    params["embed"].T if cfg.tie_embeddings else params["lm_head"]
                ).to(h.dtype)
                return h[:, -1] @ head  # last-position scoring logits [B, V]

        jitted = sh.Jitted(prefill_step, mesh, (pspecs, batch_specs))
        return Cell(jitted, (params_abs, batch_abs), cfg, dict(kind=kind, B=B, S=S))

    # decode
    cache_abs = transformer.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    cache_specs = sh.cache_specs(cfg, cache_abs, mesh, B)
    token_abs = _meta((B,))
    dsize = 1
    for a in daxes:
        dsize *= int(mesh.shape[a])
    token_spec = P(daxes) if (B >= dsize and B % dsize == 0) else P()

    def serve_step(params, cache, token):
        with torch.no_grad():
            return transformer.decode_step(params, cfg, cache, token)

    jitted = sh.Jitted(serve_step, mesh, (pspecs, cache_specs, token_spec),
                       out_specs=(P(), cache_specs), donate_argnums=(1,))
    return Cell(
        jitted, (params_abs, cache_abs, token_abs), cfg, dict(kind=kind, B=B, S=S)
    )
