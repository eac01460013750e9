"""Shared transformer layers: norms, RoPE, GQA attention, gated MLP (port of
``repro/models/layers.py``).

Attention supports full / sliding-window / per-layer local:global causal
masking, GQA/MQA head grouping, optional QKV bias, and a blockwise
(q-chunked) softmax so the score matrix never materializes at [S, S]
(peak transient = [B, H, q_chunk, S]).  It is plain torch, as the
reference's is plain jnp: einsums, the mask, softmax in float32, masked
scores at ``-1e30``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables for the given positions: [..., head_dim//2]."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, Dh]; cos/sin: [..., S, Dh//2] (broadcast over H)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _mask(
    q_pos: torch.Tensor,  # [Sq]
    k_pos: torch.Tensor,  # [Sk]
    window: int,
    is_global,  # a Python bool or a 0-d bool tensor
    prefix_len: int = 0,
) -> torch.Tensor:
    """Causal (+windowed when local) mask; bidirectional within the prefix."""
    i = q_pos[:, None]
    j = k_pos[None, :]
    causal = (j <= i) & (j >= 0)  # j < 0 marks unwritten ring-cache slots
    if prefix_len:
        causal = causal | ((i < prefix_len) & (j < prefix_len) & (j >= 0))
    local = causal & (j > i - window)
    if isinstance(is_global, torch.Tensor):
        return torch.where(is_global, causal, local)
    return causal if is_global else local


def attention(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,  # [B, Sk, Hkv, Dh]
    q_positions: torch.Tensor,  # [Sq]
    k_positions: torch.Tensor,  # [Sk]
    is_global,  # a Python bool (decode) or a 0-d bool tensor (layer loop)
    *,
    window: int,
    q_chunk: int = 512,
    prefix_len: int = 0,
) -> torch.Tensor:
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = Dh**-0.5
    kq = k.float()
    vq = v.float()

    q_chunk = min(q_chunk, Sq)
    n_chunks = max(Sq // q_chunk, 1)

    def one_chunk(c):
        qp = q_positions[c * q_chunk : (c + 1) * q_chunk]
        qc = q[:, c * q_chunk : (c + 1) * q_chunk]
        qc = qc.reshape(B, q_chunk, Hkv, G, Dh).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qc, kq) * scale
        m = _mask(qp, k_positions, window, is_global, prefix_len)
        scores = torch.where(m[None, None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vq)
        return out.reshape(B, q_chunk, Hq, Dh)

    # the reference maps over Sq // q_chunk whole chunks
    out = torch.cat([one_chunk(c) for c in range(n_chunks)], dim=1)
    return out.to(q.dtype)


def gated_mlp(x, w_gate, w_up, w_down):
    """SwiGLU: down( silu(x @ gate) * (x @ up) )."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def softmax_cross_entropy_sharded(
    logits: torch.Tensor,  # [B, S, V]
    targets: torch.Tensor,  # [B, S]
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - tgt
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
