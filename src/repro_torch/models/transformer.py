"""Generic decoder covering all 10 assigned architectures (port of
``repro/models/transformer.py``).

One parameter/forward scheme spans the families:

  * dense / vlm / audio — pre-norm GQA attention + SwiGLU MLP blocks,
    full / SWA / local:global masking, optional QKV bias, optional
    bidirectional prefix (the VLM/audio stub embeddings).
  * moe  — same attention; the FFN is the flipped-dispatch MoE layer.
  * ssm  — Mamba-2 (SSD) blocks, attention-free.
  * hybrid — Mamba-2 stack with one *shared* attention block applied every
    ``attn_every`` layers (Zamba-2 scheme: same weights at every point).

The API is the reference's, functional, on a dict of tensors in its pytree
layout: ``params["layers"][name]`` is stacked ``[L, ...]`` as
``jax.vmap(layer_init)`` stacks it.  The reference's scan and its unrolled
loop are the same Python loop over layers here; ``remat`` runs each layer's
step (and, for the hybrid family, each group's step) under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.  Decode
keeps per-layer caches ragged (ring buffers for SWA/local layers, full for
global) and writes them in place.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.core.state import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, attention, rms_norm, rope_angles
from repro_torch.models.moe_a2a import moe_ffn_a2a
from repro_torch.sharding import P

Params = dict[str, Any]
_BIG = 1 << 30  # "infinite" attention window
_FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class _Init:
    """Draws ``N(0, 0.02)`` tensors from one generator, in place, so that a
    stacked ``[L, ...]`` weight costs no transient copy."""

    def __init__(self, gen: torch.Generator | None, device, dtype, lead: tuple = ()):
        self.gen, self.device, self.dtype, self.lead = gen, device, dtype, tuple(lead)

    def normal(self, shape, dtype=None, scale: float = 1.0):
        t = torch.empty(self.lead + tuple(shape), dtype=dtype or self.dtype, device=self.device)
        t.normal_(0.0, 0.02, generator=self.gen)
        return t.mul_(scale) if scale != 1.0 else t

    def fill(self, shape, value: float, dtype=None):
        return torch.full(self.lead + tuple(shape), value, dtype=dtype or self.dtype,
                          device=self.device)


def _dense_layer_init(init: _Init, cfg: ModelConfig, scale_out: float) -> Params:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh, f = cfg.resolved_head_dim, cfg.d_ff
    p = {
        "attn_norm": init.fill((d,), 1.0),
        "wq": init.normal((d, hq * dh)),
        "wk": init.normal((d, hkv * dh)),
        "wv": init.normal((d, hkv * dh)),
        "wo": init.normal((hq * dh, d), scale=scale_out),
        "mlp_norm": init.fill((d,), 1.0),
    }
    if cfg.qkv_bias:
        p["bq"] = init.fill((hq * dh,), 0.0)
        p["bk"] = init.fill((hkv * dh,), 0.0)
        p["bv"] = init.fill((hkv * dh,), 0.0)
    if cfg.family == "moe":
        e = cfg.num_experts * cfg.moe_split  # virtual experts
        mf = cfg.moe_d_ff // cfg.moe_split
        p["router"] = init.normal((d, cfg.num_experts), dtype=torch.float32)
        p["w_gate"] = init.normal((e, d, mf))
        p["w_up"] = init.normal((e, d, mf))
        p["w_down"] = init.normal((e, mf, d), scale=scale_out)
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * mf
            p["shared_gate"] = init.normal((d, fs))
            p["shared_up"] = init.normal((d, fs))
            p["shared_down"] = init.normal((fs, d), scale=scale_out)
    else:
        p["w_gate"] = init.normal((d, f))
        p["w_up"] = init.normal((d, f))
        p["w_down"] = init.normal((f, d), scale=scale_out)
    return p


def _ssm_layer_init(init: _Init, cfg: ModelConfig, scale_out: float) -> Params:
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.conv_kernel
    f32 = torch.float32
    return {
        "norm": init.fill((d,), 1.0),
        "in_z": init.normal((d, di)),
        "in_x": init.normal((d, di)),
        "in_B": init.normal((d, n)),
        "in_C": init.normal((d, n)),
        "in_dt": init.normal((d, h)),
        "conv_x": init.normal((k, di)),
        "conv_B": init.normal((k, n)),
        "conv_C": init.normal((k, n)),
        "dt_bias": init.fill((h,), 0.0, dtype=f32),
        "A_log": init.fill((h,), 0.0, dtype=f32),  # A = -exp(0) = -1
        "D_skip": init.fill((h,), 1.0, dtype=f32),
        "norm_w": init.fill((di,), 1.0),
        "out_proj": init.normal((di, d), scale=scale_out),
    }


def init_params(rng, cfg: ModelConfig, param_dtype=torch.float32, *, device=None) -> Params:
    """Random parameters in the reference's layout and distribution
    (``N(0, 0.02)``, output projections scaled by ``1/sqrt(2L)``), drawn from
    ``rng``: a ``torch.Generator`` (on its device) or an int seed (on the card
    unless ``device`` names another; ``"meta"`` allocates nothing).  The
    values are not the reference's; ``model.params_from_numpy`` carries
    those."""
    if isinstance(rng, torch.Generator):
        gen, dev = rng, rng.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"generator on {dev}, device {device}")
    else:
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev)
        if gen is not None:
            gen.manual_seed(int(rng))
    scale_out = 1.0 / math.sqrt(2 * cfg.num_layers)
    top = _Init(gen, dev, param_dtype)
    params: Params = {
        "embed": top.normal((cfg.vocab_size, cfg.d_model)),
        "final_norm": top.fill((cfg.d_model,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = top.normal((cfg.d_model, cfg.vocab_size))
    stacked = _Init(gen, dev, param_dtype, lead=(cfg.num_layers,))
    layer_init = _ssm_layer_init if cfg.family in ("ssm", "hybrid") else _dense_layer_init
    params["layers"] = layer_init(stacked, cfg, scale_out)
    if cfg.family == "hybrid":
        # the shared transformer block (Zamba-2): one set of weights
        params["shared_attn"] = _dense_layer_init(top, cfg, scale_out)
    return params


def layer_is_global(cfg: ModelConfig):
    """Per-layer global-attention flags (host-side numpy)."""
    idx = np.arange(cfg.num_layers)
    if cfg.attention == "full":
        return np.ones(cfg.num_layers, bool)
    if cfg.attention == "swa":
        return np.zeros(cfg.num_layers, bool)
    r = cfg.local_global_ratio  # r local layers, then 1 global
    return (idx + 1) % (r + 1) == 0


def _compute_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _cast(p: dict, compute) -> dict:
    """Float weights in the compute dtype; the rest as they are."""
    return {k: v.to(compute) if v.dtype in _FLOATS else v for k, v in p.items()}


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _qkv(h, lp, cfg: ModelConfig):
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def _attn_block(x, lp, cfg: ModelConfig, positions, is_global, prefix_len, q_chunk):
    B, S, D = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q = q.reshape(B, S, hq, dh)
    k = k.reshape(B, S, hkv, dh)
    v = v.reshape(B, S, hkv, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attention(
        q, k, v, positions, positions, is_global,
        window=cfg.window, q_chunk=q_chunk, prefix_len=prefix_len,
    )
    return x + out.reshape(B, S, hq * dh) @ lp["wo"]


def _ffn_block(x, lp, cfg: ModelConfig):
    B, S, D = x.shape
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        if cfg.moe_impl == "a2a" and cfg.moe_mesh is not None:
            y = moe_ffn_a2a(h.reshape(B * S, D), lp, cfg, cfg.moe_mesh).reshape(B, S, D)
        else:
            y = moe_lib.moe_ffn(h.reshape(B * S, D), lp, cfg).reshape(B, S, D)
    else:
        y = (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return x + y


def _dense_layer(x, lp, cfg, positions, is_global, prefix_len, q_chunk):
    x = _attn_block(x, lp, cfg, positions, is_global, prefix_len, q_chunk)
    return _ffn_block(x, lp, cfg)


def _ssm_layer(x, lp, cfg):
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    y, _ = ssm_lib.mamba2_forward_split(h, lp, cfg)
    return x + y


def check_act_spec(act_spec) -> None:
    """``act_spec`` is None or a ``PartitionSpec``; the mesh it names is
    checked where it constrains (``sharding.constrain``)."""
    if act_spec is not None and not isinstance(act_spec, P):
        raise TypeError(f"act_spec must be a PartitionSpec or None, got {act_spec!r}")


def _unstack(layers: dict, n: int) -> list[dict]:
    """Per-layer views of the stacked ``[L, ...]`` weights.  One ``unbind``
    a weight, so that autograd stacks their gradients once (indexing layer
    by layer would add a zero-filled ``[L, ...]`` gradient per layer)."""
    cols = {k: v.unbind(0) for k, v in layers.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def forward_hidden(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S_text]
    prefix_embeds: torch.Tensor | None = None,  # [B, P, D] stub frontend output
    *,
    remat: bool = False,
    q_chunk: int = 512,
    layer_loop: str = "scan",
    act_spec=None,
) -> torch.Tensor:
    """Full-sequence forward → post-final-norm hidden [B, S_total, D].

    ``layer_loop`` ("scan" or "unroll") is the reference's option; both
    loops are one Python loop here.  ``remat`` recomputes each layer step
    in the backward pass instead of saving its activations
    (``torch.utils.checkpoint``); the cast of the layer's weights to the
    compute dtype is inside the step, so those copies are recomputed too.
    ``act_spec``: the reference's Megatron-SP constraint on the residual
    stream, after the embedding and after every layer (group) step.  The
    port computes the stream whole (``repro_torch.sharding``), so the
    constraint is a check against the current mesh and the identity.
    """
    check_act_spec(act_spec)
    if act_spec is None:
        def constrain(h):
            return h
    else:
        def constrain(h):
            return sharding.constrain(h, act_spec, "act_spec")
    compute = _compute_dtype(cfg)
    x = params["embed"][tokens.long()].to(compute)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(compute), x], dim=1)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)
    glob = layer_is_global(cfg)
    x = constrain(x)

    def run(fn, *args):
        if not remat:
            return fn(*args)
        # the steps draw no random numbers: no RNG state to stash
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    layers = _unstack(params["layers"], cfg.num_layers)
    if cfg.family in ("ssm", "hybrid"):
        def ssm_step(h, lp):
            return constrain(_ssm_layer(h, _cast(lp, compute), cfg))

        if cfg.family == "ssm":
            for lp in layers:
                x = run(ssm_step, x, lp)
        else:
            g = cfg.attn_every

            def group_step(h, group, shared):
                for lp in group:
                    h = run(ssm_step, h, lp)
                return constrain(_dense_layer(h, _cast(shared, compute), cfg, positions, True,
                                              prefix_len, q_chunk))

            n_groups = cfg.num_layers // g
            for i in range(n_groups):
                x = run(group_step, x, layers[i * g:(i + 1) * g], params["shared_attn"])
            for lp in layers[n_groups * g:]:  # a tail shorter than a group, as decode
                x = run(ssm_step, x, lp)
    else:
        def step(h, lp, is_global):
            return constrain(_dense_layer(h, _cast(lp, compute), cfg, positions, is_global,
                                          prefix_len, q_chunk))

        for i, lp in enumerate(layers):
            x = run(step, x, lp, bool(glob[i]))

    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(params: Params, cfg: ModelConfig, compute):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(compute)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    prefix_embeds: torch.Tensor | None = None,
    *,
    remat: bool = False,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Full-sequence forward → logits [B, S_total, vocab]."""
    x = forward_hidden(params, cfg, tokens, prefix_embeds, remat=remat, q_chunk=q_chunk)
    return x @ _head(params, cfg, _compute_dtype(cfg))


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, layer_idx: int, max_len: int, glob) -> int:
    if cfg.attention == "full" or bool(glob[layer_idx]):
        return max_len
    return min(cfg.window, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None):
    """Ragged per-layer cache (ring buffers for local/SWA layers), on the
    card unless ``device`` names another."""
    dev = resolve_device(device)
    glob = layer_is_global(cfg)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv(w):
        return {"k": zeros(batch, w, hkv, dh), "v": zeros(batch, w, hkv, dh)}

    layers = []
    for i in range(cfg.num_layers):
        if cfg.family in ("ssm", "hybrid"):
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            layers.append({
                "conv": zeros(batch, cfg.conv_kernel - 1, conv_dim),
                "ssm": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                             dt=torch.float32),
            })
        else:
            layers.append(kv(_cache_len(cfg, i, max_len, glob)))
    cache = {"layers": layers, "pos": zeros(dt=torch.int32)}
    if cfg.family == "hybrid":
        cache["shared_kv"] = [kv(max_len) for _ in range(cfg.num_layers // cfg.attn_every)]
    return cache


def _decode_attn(x, lp, cfg: ModelConfig, kv, pos, is_global: bool):
    """One-token attention against a (ring or linear) KV cache, written in
    place at the ring slot of ``pos``."""
    B, _, D = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    W = kv["k"].shape[1]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q = q.reshape(B, 1, hq, dh)
    k = k.reshape(B, 1, hkv, dh)
    v = v.reshape(B, 1, hkv, dh)
    cos, sin = rope_angles(pos[None], dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = torch.remainder(pos, W)
    at = slot.long().reshape(1)
    kv["k"].index_copy_(1, at, k.to(kv["k"].dtype))
    kv["v"].index_copy_(1, at, v.to(kv["v"].dtype))
    # true token position held by each ring slot (negative: never written)
    j = torch.arange(W, device=x.device)
    k_positions = pos - torch.remainder(slot - j, W)
    out = attention(
        q, kv["k"], kv["v"],
        q_positions=pos[None],
        k_positions=k_positions,
        is_global=is_global,
        window=cfg.window if not is_global else _BIG,
        q_chunk=1,
    )
    x = x + out.reshape(B, 1, hq * dh) @ lp["wo"]
    return x, kv


def decode_step(params: Params, cfg: ModelConfig, cache, token: torch.Tensor):
    """serve_step: one new token against the cache. Returns (logits, cache).

    The KV caches are written in place (the returned cache holds the same
    tensors, and a new ``pos``); SSM states are new tensors.  No host sync:
    ``pos`` stays on the device.
    """
    compute = _compute_dtype(cfg)
    pos = cache["pos"]
    x = params["embed"][token.long()][:, None].to(compute)  # [B, 1, D]
    glob = layer_is_global(cfg)

    new_layers = []
    new_cache = {"layers": new_layers, "pos": pos + 1}
    if cfg.family in ("ssm", "hybrid"):
        new_shared = []
        shared = _cast(params["shared_attn"], compute) if cfg.family == "hybrid" else None
        for i in range(cfg.num_layers):
            lp = _cast(_layer(params["layers"], i), compute)
            st = cache["layers"][i]
            h = rms_norm(x[:, 0], lp["norm"], cfg.norm_eps)
            y, conv2, ssm2 = ssm_lib.mamba2_decode_split(h, lp, cfg, st["conv"], st["ssm"])
            x = x + y[:, None]
            new_layers.append({"conv": conv2, "ssm": ssm2})
            if shared is not None and (i + 1) % cfg.attn_every == 0:
                gidx = (i + 1) // cfg.attn_every - 1
                x, kv2 = _decode_attn(x, shared, cfg, cache["shared_kv"][gidx], pos,
                                      is_global=True)
                x = _ffn_block(x, shared, cfg)
                new_shared.append(kv2)
        if shared is not None:
            new_cache["shared_kv"] = new_shared
    else:
        for i in range(cfg.num_layers):
            lp = _cast(_layer(params["layers"], i), compute)
            x, kv2 = _decode_attn(x, lp, cfg, cache["layers"][i], pos,
                                  is_global=bool(glob[i]))
            x = _ffn_block(x, lp, cfg)
            new_layers.append(kv2)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0] @ _head(params, cfg, compute)
    return logits, new_cache
