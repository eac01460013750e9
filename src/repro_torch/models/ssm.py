"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060 (port of
``repro/models/ssm.py``).

Training uses the chunked SSD algorithm: quadratic attention-like compute
inside length-``Q`` chunks, linear recurrent state passing between chunks.
The reference passes states between chunks by an associative scan; here a
loop over the chunks carries the state, the same recurrence in float32.
Decode is the O(1) recurrent update.  Single B/C group (n_groups=1),
per-head scalar decay A — the published mamba2-1.3b layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def causal_conv1d(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None):
    """Depthwise causal conv: u [B, S, C], w [K, C] → [B, S, C]."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    S = u.shape[1]
    y = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for k in range(K):  # K is 4: unrolled shifts, as the reference
        y = y + pad[:, k : k + S].float() * w[k].float()
    if bias is not None:
        y = y + bias
    return y.to(u.dtype)


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus, > 0)
    A: torch.Tensor,  # [H]        (negative)
    Bm: torch.Tensor,  # [B, S, N]
    Cm: torch.Tensor,  # [B, S, N]
    *,
    chunk: int,
    init_state: torch.Tensor | None = None,  # [B, H, P, N]
):
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    assert nc * Q == S, (S, Q)

    xc = x.reshape(B_, nc, Q, H, P).float()
    dtc = dt.reshape(B_, nc, Q, H).float()
    Bc = Bm.reshape(B_, nc, Q, N).float()
    Cc = Cm.reshape(B_, nc, Q, N).float()

    a = dtc * A.float()  # [B, nc, Q, H] log-decay
    cum = torch.cumsum(a, dim=2)

    # intra-chunk (the "attention-like" quadratic term)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,t,s,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dec = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    scores = cb[..., None] * dec * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xc)

    # chunk-final states
    last = cum[:, :, -1:, :]  # [B,nc,1,H]
    sdec = torch.exp(last - cum) * dtc  # [B,nc,Q,H]
    S_c = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, sdec, xc)

    # inter-chunk recurrence: the state entering chunk c, chunk by chunk
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B,nc,H]
    state = (
        torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
        if init_state is None
        else init_state.float()
    )
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    s_enter = torch.stack(entering, dim=1)  # [B,nc,H,P,N]

    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, s_enter) * torch.exp(cum)[..., None]
    out = (y + y_inter).reshape(B_, S, H, P)
    return out.to(x.dtype), state


def ssd_decode_step(
    state: torch.Tensor,  # [B, H, P, N]
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, N]
    Cm: torch.Tensor,  # [B, N]
):
    decay = torch.exp(dt.float() * A.float())  # [B, H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt.float(), x.float(), Bm.float())
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def mamba2_forward_split(x: torch.Tensor, p: dict, cfg, init=None):
    """Mamba-2 block with *separated* projections (TP-shardable layout).

    Params: in_z/in_x [D, d_inner], in_B/in_C [D, N], in_dt [D, H],
    conv_x [K, d_inner], conv_B/conv_C [K, N], dt_bias/A_log/D_skip [H],
    norm_w [d_inner], out_proj [d_inner, D].
    x: [B, S, D] → ([B, S, D], final_state [B, H, P, N]).
    """
    B_, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    z = x @ p["in_z"]
    xs = causal_conv1d(F.silu(x @ p["in_x"]), p["conv_x"])
    Bm = causal_conv1d(F.silu(x @ p["in_B"]), p["conv_B"])
    Cm = causal_conv1d(F.silu(x @ p["in_C"]), p["conv_C"])
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    y, final_state = ssd_chunked(
        xs.reshape(B_, S, H, P), dt, A, Bm, Cm, chunk=cfg.ssm_chunk, init_state=init
    )
    y = y + xs.reshape(B_, S, H, P) * p["D_skip"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B_, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], final_state


def mamba2_decode_split(x: torch.Tensor, p: dict, cfg, conv_state, ssm_state):
    """One-token decode for the split layout. x: [B, D].

    conv_state: [B, K-1, d_inner + 2N] (x ++ B ++ C channels).
    Returns (y [B, D], new_conv_state, new_ssm_state).
    """
    B_, D = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner

    z = x @ p["in_z"]
    u = torch.cat(
        [F.silu(x @ p["in_x"]), F.silu(x @ p["in_B"]), F.silu(x @ p["in_C"])], dim=-1
    )
    window = torch.cat([conv_state, u[:, None]], dim=1)  # [B, K, C]
    w_full = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), w_full.float()).to(x.dtype)
    new_conv_state = window[:, 1:]

    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, new_ssm_state = ssd_decode_step(ssm_state, xs.reshape(B_, H, P), dt, A, Bm, Cm)
    y = y + xs.reshape(B_, H, P) * p["D_skip"].to(xs.dtype)[None, :, None]
    y = y.reshape(B_, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv_state, new_ssm_state


def mamba2_forward(x: torch.Tensor, p: dict, cfg, init=None):
    """Full-sequence Mamba-2 block. x: [B, S, D] → ([B, S, D], final_state)."""
    B_, S, D = x.shape
    d_inner = cfg.d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.tensor_split(zxbcdt, [d_inner, 2 * d_inner + 2 * N], dim=-1)
    xbc = causal_conv1d(F.silu(xbc), p["conv_w"], p.get("conv_b"))
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    y, final_state = ssd_chunked(
        xs.reshape(B_, S, H, P), dt, A, Bm, Cm, chunk=cfg.ssm_chunk, init_state=init
    )
    y = y + xs.reshape(B_, S, H, P) * p["D_skip"][None, None, :, None]
    y = y.reshape(B_, S, d_inner)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], final_state


def mamba2_decode(x: torch.Tensor, p: dict, cfg, conv_state, ssm_state):
    """One-token decode. x: [B, D]; conv_state: [B, K-1, conv_dim]."""
    B_, D = x.shape
    d_inner = cfg.d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.tensor_split(zxbcdt, [d_inner, 2 * d_inner + 2 * N], dim=-1)
    xbc = F.silu(xbc)
    window = torch.cat([conv_state, xbc[:, None]], dim=1)  # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    if p.get("conv_b") is not None:
        conv_out = conv_out + p["conv_b"]
    conv_out = conv_out.to(x.dtype)
    new_conv_state = window[:, 1:]

    xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, new_ssm_state = ssd_decode_step(ssm_state, xs.reshape(B_, H, P), dt, A, Bm, Cm)
    y = y + xs.reshape(B_, H, P) * p["D_skip"][None, :, None]
    y = y.reshape(B_, d_inner)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv_state, new_ssm_state
