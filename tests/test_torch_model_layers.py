"""The port's decoder layers (``repro_torch.models.layers``, ``ssm``, ``moe``)
against the JAX package on the CPU, on the same numpy inputs drawn from a
seed:

  * ``layers``: RMSNorm, RoPE, attention under every mask (full, local,
    global by flag tensor, a bidirectional prefix, negative ring positions,
    several q-chunks), the gated MLP, the cross entropy;
  * ``ssm``: ``causal_conv1d``, ``ssd_chunked`` with and without
    ``init_state`` (and against its own recurrence), both decode forms and
    both block forms;
  * ``moe``: ``moe_ffn`` at the default capacity factor 1.25 with drops, at
    8.0, with ``moe_split=2``, with tied gates, and its dense oracle.

Whole models: ``tests/test_torch_models.py``, which imports the helpers
below.  Tolerance: float32 on both
sides, summed in different orders, ``F32`` (``rtol=atol=1e-4``); the
port's MoE layer against its own dense oracle at the reference's
``rtol=2e-3, atol=2e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jl  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)


def T(x):
    """A numpy array or a pytree of them as the port's CPU tensors."""
    return tmodel.params_from_numpy(jax.tree.map(np.asarray, x), device="cpu")


def N(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, tol):
    np.testing.assert_allclose(N(got), np.asarray(want, dtype=np.float32), **tol)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norm_rope_mlp_and_loss():
    rng = np.random.default_rng(0)
    x, w = f32(rng, 2, 5, 32), f32(rng, 32)
    close(tl.rms_norm(T(x), T(w)), jl.rms_norm(x, w), F32)
    pos = np.arange(7, dtype=np.int32) * 3
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    cos_t, sin_t = tl.rope_angles(T(pos), 16, 10_000.0)
    close(cos_t, cos_j, F32)
    close(sin_t, sin_j, F32)
    q = f32(rng, 2, 7, 4, 16)
    close(tl.apply_rope(T(q), cos_t, sin_t), jl.apply_rope(q, cos_j, sin_j), F32)
    wg, wu, wd = f32(rng, 32, 48, scale=0.1), f32(rng, 32, 48, scale=0.1), f32(rng, 48, 32)
    close(tl.gated_mlp(T(x), T(wg), T(wu), T(wd)), jl.gated_mlp(x, wg, wu, wd), F32)
    logits, tgt = f32(rng, 2, 5, 11), rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    close(tl.softmax_cross_entropy_sharded(T(logits), T(tgt)),
          jl.softmax_cross_entropy_sharded(logits, tgt), F32)
    close(tl.softmax_cross_entropy_sharded(T(logits), T(tgt), T(mask)),
          jl.softmax_cross_entropy_sharded(logits, tgt, mask), F32)


RING = np.array([8, 9, 10, 11, -4, -3, -2, -1, 4, 5, 6, 7], dtype=np.int32)


@pytest.mark.parametrize(
    "case",
    [
        dict(name="full", glob=True, window=4),
        dict(name="local", glob=False, window=4),
        dict(name="global flag tensor", glob=np.bool_(True), window=4),
        dict(name="local flag tensor", glob=np.bool_(False), window=5),
        dict(name="prefix", glob=True, window=4, prefix_len=6),
        dict(name="prefix local", glob=False, window=3, prefix_len=6),
        dict(name="q chunks", glob=False, window=6, q_chunk=4),
        dict(name="ring", glob=False, window=8, ring=True),
    ],
    ids=lambda c: c["name"],
)
def test_attention_masks(case):
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, Dh = 2, 12, 4, 2, 8
    ring = case.get("ring", False)
    Sq = 1 if ring else S
    q, k, v = f32(rng, B, Sq, Hq, Dh), f32(rng, B, S, Hkv, Dh), f32(rng, B, S, Hkv, Dh)
    qp = np.array([11], np.int32) if ring else np.arange(S, dtype=np.int32)
    kp = RING if ring else np.arange(S, dtype=np.int32)
    kw = dict(window=case["window"], q_chunk=case.get("q_chunk", 512),
              prefix_len=case.get("prefix_len", 0))
    glob = case["glob"]
    want = jl.attention(q, k, v, qp, kp, jnp.asarray(glob), **kw)
    tglob = torch.tensor(bool(glob)) if isinstance(glob, np.bool_) else glob
    got = tl.attention(T(q), T(k), T(v), T(qp), T(kp), tglob, **kw)
    assert got.shape == (B, Sq, Hq, Dh) and got.dtype == torch.float32
    close(got, want, F32)


def test_mask_negative_positions_and_floor_modulo():
    """Unwritten ring slots carry negative positions and are masked; the
    ring's positions come from a floor modulo (jnp's ``%``)."""
    W, pos = 8, 5
    slot = pos % W
    j = np.arange(W)
    want = pos - ((slot - j) % W)
    got = torch.tensor(pos) - torch.remainder(torch.tensor(slot) - torch.arange(W), W)
    assert got.tolist() == want.tolist() and (want < 0).any()
    m = tl._mask(torch.tensor([pos]), got, 4, False)
    jm = jl._mask(jnp.array([pos]), jnp.asarray(want), 4, jnp.array(False))
    assert m.numpy().tolist() == np.asarray(jm).tolist()


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, B=2, S=32, H=2, P=4, Nn=8):
    x = f32(rng, B, S, H, P)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.1).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,))) - 0.1).astype(np.float32)
    return x, dt, A, f32(rng, B, S, Nn), f32(rng, B, S, Nn)


def test_causal_conv1d():
    rng = np.random.default_rng(2)
    u, w, b = f32(rng, 2, 9, 6), f32(rng, 4, 6), f32(rng, 6)
    close(tssm.causal_conv1d(T(u), T(w)), jssm.causal_conv1d(u, w), F32)
    close(tssm.causal_conv1d(T(u), T(w), T(b)), jssm.causal_conv1d(u, w, b), F32)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked(with_init):
    rng = np.random.default_rng(3)
    x, dt, A, Bm, Cm = _ssd_inputs(rng)
    init = f32(rng, 2, 2, 4, 8) if with_init else None
    want, want_st = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8, init_state=init)
    got, got_st = tssm.ssd_chunked(*T((x, dt, A, Bm, Cm)), chunk=8,
                                   init_state=None if init is None else T(init))
    close(got, want, F32)
    close(got_st, want_st, F32)
    # the reference's own check: chunked == the recurrence of the decode step
    st = T(init) if with_init else torch.zeros(2, 2, 4, 8)
    ys = []
    for t in range(x.shape[1]):
        y, st = tssm.ssd_decode_step(st, *T((x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])))
        ys.append(y)
    close(torch.stack(ys, dim=1), N(got), dict(rtol=1e-4, atol=1e-5))
    close(st, N(got_st), dict(rtol=1e-4, atol=1e-5))


def _ssm_cfg():
    return jmodel.get_config("mamba2-1.3b").reduced(dtype="float32")


def test_mamba2_split_forward_and_decode():
    cfg = _ssm_cfg()
    jp = jtf.init_params(jax.random.PRNGKey(5), cfg)
    lp = jax.tree.map(lambda a: a[0], jp["layers"])
    rng = np.random.default_rng(4)
    x = f32(rng, 2, 16, cfg.d_model)
    init = f32(rng, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, scale=0.1)
    want, want_st = jssm.mamba2_forward_split(x, lp, cfg, init=init)
    got, got_st = tssm.mamba2_forward_split(T(x), T(lp), cfg, init=T(init))
    close(got, want, F32)
    close(got_st, want_st, F32)
    conv = f32(rng, 2, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.ssm_state)
    want = jssm.mamba2_decode_split(x[:, 0], lp, cfg, conv, init)
    got = tssm.mamba2_decode_split(T(x[:, 0]), T(lp), cfg, T(conv), T(init))
    for g, w in zip(got, want):
        close(g, w, F32)


def test_mamba2_fused_projection_forward_and_decode():
    """The reference's fused-``in_proj`` layout (with a conv bias)."""
    cfg = _ssm_cfg()
    rng = np.random.default_rng(5)
    D, di, Nn, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * Nn
    p = {
        "in_proj": f32(rng, D, 2 * di + 2 * Nn + H, scale=0.1),
        "conv_w": f32(rng, cfg.conv_kernel, conv_dim, scale=0.3),
        "conv_b": f32(rng, conv_dim, scale=0.1),
        "dt_bias": f32(rng, H, scale=0.1),
        "A_log": f32(rng, H, scale=0.1),
        "D_skip": f32(rng, H),
        "norm_w": 1 + f32(rng, di, scale=0.1),
        "out_proj": f32(rng, di, D, scale=0.1),
    }
    x = f32(rng, 2, 16, D)
    want, want_st = jssm.mamba2_forward(x, p, cfg)
    got, got_st = tssm.mamba2_forward(T(x), T(p), cfg)
    close(got, want, F32)
    close(got_st, want_st, F32)
    conv = f32(rng, 2, cfg.conv_kernel - 1, conv_dim)
    st = f32(rng, 2, H, cfg.ssm_head_dim, Nn, scale=0.1)
    want = jssm.mamba2_decode(x[:, 0], p, cfg, conv, st)
    got = tssm.mamba2_decode(T(x[:, 0]), T(p), cfg, T(conv), T(st))
    for g, w in zip(got, want):
        close(g, w, F32)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------


def _moe_params(rng, cfg, tied=False):
    D, E, Fv = cfg.d_model, cfg.num_experts * cfg.moe_split, cfg.moe_d_ff // cfg.moe_split
    Fs = cfg.num_shared_experts * Fv
    return {
        "router": np.zeros((D, cfg.num_experts), np.float32) if tied
        else f32(rng, D, cfg.num_experts, scale=0.1),
        "w_gate": f32(rng, E, D, Fv, scale=0.05),
        "w_up": f32(rng, E, D, Fv, scale=0.05),
        "w_down": f32(rng, E, Fv, D, scale=0.05),
        "shared_gate": f32(rng, D, Fs, scale=0.05),
        "shared_up": f32(rng, D, Fs, scale=0.05),
        "shared_down": f32(rng, Fs, D, scale=0.05),
    }


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("factor 1.25, drops", dict()),
        ("factor 8", dict(moe_capacity_factor=8.0)),
        ("split 2", dict(moe_split=2)),
        ("split 2, drops, no shared", dict(moe_split=2, num_shared_experts=0)),
        ("tied gates", dict(moe_capacity_factor=8.0)),
    ],
)
def test_moe_ffn(name, overrides):
    jcfg = jmodel.get_config("deepseek-moe-16b").reduced(dtype="float32", **overrides)
    tcfg = tmodel.get_config("deepseek-moe-16b").reduced(dtype="float32", **overrides)
    rng = np.random.default_rng(6)
    p = _moe_params(rng, jcfg, tied=name == "tied gates")
    x = f32(rng, 64, jcfg.d_model)
    if "drops" in name:  # skew the router towards expert 0
        x += 0.5
        p["router"][:, 0] += 0.05
    want = jmoe.moe_ffn(x, p, jcfg)
    got = tmoe.moe_ffn(T(x), T(p), tcfg)
    close(got, want, F32)
    if "drops" in name:  # an expert got more slots than its window holds
        k_v = jcfg.top_k * jcfg.moe_split
        C = tmoe.capacity(64, jcfg.top_k, jcfg.num_experts, jcfg.moe_capacity_factor)
        logits = x @ p["router"]
        experts = np.argsort(-logits, axis=-1, kind="stable")[:, : jcfg.top_k]
        per = np.bincount(experts.reshape(-1), minlength=jcfg.num_experts)
        assert per.max() > C, (per, C, k_v)
    if jcfg.moe_split == 1:
        close(tmoe.moe_ffn_dense_oracle(T(x), T(p), tcfg),
              jmoe.moe_ffn_dense_oracle(x, p, jcfg), F32)


def test_moe_matches_dense_oracle_at_generous_capacity():
    """The reference's check on the port alone: factor 8 drops nothing."""
    cfg = tmodel.get_config("deepseek-moe-16b").reduced(dtype="float32",
                                                        moe_capacity_factor=8.0)
    rng = np.random.default_rng(7)
    p = T(_moe_params(rng, cfg))
    x = T(f32(rng, 64, cfg.d_model))
    close(tmoe.moe_ffn(x, p, cfg), N(tmoe.moe_ffn_dense_oracle(x, p, cfg)),
          dict(rtol=2e-3, atol=2e-4))
