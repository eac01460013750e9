"""The port's decoder (``repro_torch.models``) against the JAX package on the
CPU, on the same numpy inputs drawn from a seed, with the reference's
parameters carried across by ``params_from_numpy``:

  * ``forward`` of all 10 registry architectures, ``decode_step`` step for
    step (teacher-forced tokens) for gemma3, deepseek-moe, mamba2, zamba2,
    the SWA ring wrap and ``padded(4)``; the local:global cache sizes; the
    parameter layout at full width on the meta device; one bfloat16 case.

Tolerances.  float32 on both sides, summed in different orders: ``F32``
(``rtol=atol=1e-4``) for the layers and the blocks, ``MODEL`` (``rtol=atol=
2e-4``) through a whole reduced model, tighter than the reference's own
decode-vs-forward check (``2e-3``, ``tests/test_models.py``), which is also
held here.  The bfloat16 case rounds each layer's output to 8 bits on both
sides: ``BF16`` (``atol=3e-2``, ``rtol=3e-2``) on logits of magnitude ~1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.frontends import prefix_spec, synthetic_prefix  # noqa: E402
from test_torch_model_layers import N, T, close, f32  # noqa: E402

MODEL = dict(rtol=2e-4, atol=2e-4)
REF_DECODE = dict(rtol=2e-3, atol=2e-3)  # the reference's decode-vs-forward check
BF16 = dict(rtol=3e-2, atol=3e-2)

ARCHS = [
    "qwen2.5-32b", "starcoder2-15b", "h2o-danube-3-4b", "gemma3-12b",
    "deepseek-moe-16b", "mixtral-8x22b", "zamba2-2.7b", "paligemma-3b",
    "mamba2-1.3b", "musicgen-medium",
]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _configs(arch, **overrides):
    return (jmodel.get_config(arch).reduced(**overrides),
            tmodel.get_config(arch).reduced(**overrides))


def _setup(arch, seed, **overrides):
    overrides.setdefault("dtype", "float32")
    jcfg, tcfg = _configs(arch, **overrides)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, T(jp)


def test_registry_and_configs_match():
    assert tmodel.list_archs() == jmodel.list_archs() == sorted(ARCHS)
    for arch in ARCHS:
        assert dataclasses.asdict(tmodel.get_config(arch)) == dataclasses.asdict(
            jmodel.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_at_full_width(arch):
    """``abstract_params`` (meta tensors) has the reference's tree, shapes and
    dtypes at the published widths, and ``param_count`` its count."""
    jabs = jmodel.abstract_params(jmodel.get_config(arch))
    tabs = tmodel.abstract_params(tmodel.get_config(arch))
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(jabs)}
    tflat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(prefix + f"['{k}']", v)
            else:
                tflat[prefix + f"['{k}']"] = v

    walk("", tabs)
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == jflat[k].dtype.name, k
    assert tmodel.param_count(tabs) == jmodel.param_count(jabs)


def test_input_specs_and_prefix_spec():
    for arch in ("paligemma-3b", "gemma3-12b", "zamba2-2.7b"):
        jcfg, tcfg = jmodel.get_config(arch), tmodel.get_config(arch)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            js, ts = jmodel.input_specs(jcfg, shape), tmodel.input_specs(tcfg, shape)
            assert sorted(js) == sorted(ts)
            for k in js:
                assert tuple(ts[k].shape) == js[k].shape and ts[k].device.type == "meta"
                assert str(ts[k].dtype).split(".")[-1] == js[k].dtype.name
    assert prefix_spec(tmodel.get_config("qwen2.5-32b"), 2) is None


def _check_abstract_cache(jc, tc):
    if isinstance(jc, dict):
        assert sorted(jc) == sorted(tc)
        for k in jc:
            _check_abstract_cache(jc[k], tc[k])
    elif isinstance(jc, list):
        assert len(jc) == len(tc)
        for a, b in zip(jc, tc):
            _check_abstract_cache(a, b)
    else:
        assert tuple(tc.shape) == jc.shape and tc.device.type == "meta"


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-2.7b", "mamba2-1.3b"])
def test_abstract_cache_layout(arch):
    jc = jmodel.abstract_cache(jmodel.get_config(arch), "long_500k")
    tc = tmodel.abstract_cache(tmodel.get_config(arch), "long_500k")
    _check_abstract_cache(jc, tc)


def _tokens(cfg, seed, B=2, S=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch, 0)
    B, S = 2, 32
    text = S - (jcfg.frontend_len if jcfg.frontend else 0)
    tokens = _tokens(jcfg, 1, B, text)
    prefix = None
    if jcfg.frontend:  # one numpy prefix for both
        prefix = f32(np.random.default_rng(2), B, jcfg.frontend_len, jcfg.d_model, scale=0.02)
    want = jtf.forward(jp, jcfg, tokens, prefix)
    got = ttf.forward(tp, tcfg, T(tokens), None if prefix is None else T(prefix))
    assert got.shape == (B, S if jcfg.frontend else text, jcfg.vocab_size)
    close(got, want, MODEL)
    hid = ttf.forward_hidden(tp, tcfg, T(tokens), None if prefix is None else T(prefix),
                             layer_loop="unroll", q_chunk=8)
    close(hid @ tp["lm_head"] if "lm_head" in tp else hid @ tp["embed"].T, want, MODEL)


def _decode_both(jcfg, tcfg, jp, tp, tokens, max_len):
    """Teacher-forced decode through both packages, step for step; returns
    the port's logits by step."""
    B, S = tokens.shape
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(p, jcfg, c, t))
    jcache = jtf.init_cache(jcfg, B, max_len=max_len, dtype=jnp.float32)
    tcache = ttf.init_cache(tcfg, B, max_len, dtype=torch.float32, device="cpu")
    out = []
    for t in range(S):
        want, jcache = jstep(jp, jcache, tokens[:, t])
        got, tcache = ttf.decode_step(tp, tcfg, tcache, T(tokens[:, t]))
        close(got, want, MODEL)
        out.append(got)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    return torch.stack(out, dim=1)


@pytest.mark.parametrize(
    "arch,overrides,S",
    [
        ("gemma3-12b", dict(moe_capacity_factor=8.0), 16),
        ("deepseek-moe-16b", dict(moe_capacity_factor=8.0), 16),
        ("mamba2-1.3b", dict(moe_capacity_factor=8.0), 16),
        ("zamba2-2.7b", dict(moe_capacity_factor=8.0), 16),
        ("h2o-danube-3-4b", dict(window=8), 24),  # the SWA ring wraps
    ],
)
def test_decode_matches_reference(arch, overrides, S):
    jcfg, tcfg, jp, tp = _setup(arch, 1, **overrides)
    tokens = _tokens(jcfg, 3, 2, S)
    got = _decode_both(jcfg, tcfg, jp, tp, tokens, max_len=S)
    # the reference's own check, on the port alone: decode == forward
    close(got, N(ttf.forward(tp, tcfg, T(tokens))), REF_DECODE)


def test_swa_ring_is_a_ring():
    cfg = tmodel.get_config("h2o-danube-3-4b").reduced(dtype="float32", window=8)
    cache = ttf.init_cache(cfg, 2, max_len=24, dtype=torch.float32, device="cpu")
    assert cache["layers"][0]["k"].shape[1] == 8


def test_padded_config_forward_and_decode():
    jbase, tbase = _configs("qwen2.5-32b", dtype="float32")
    jcfg, tcfg = jbase.padded(4), tbase.padded(4)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.num_heads % 4 == 0 and tcfg.num_kv_heads % 4 == 0
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tp = T(jp)
    tokens = _tokens(jcfg, 4, 2, 16)
    want = jtf.forward(jp, jcfg, tokens)
    got = ttf.forward(tp, tcfg, T(tokens))
    assert got.shape == (2, 16, tcfg.vocab_size)
    close(got, want, MODEL)
    _decode_both(jcfg, tcfg, jp, tp, tokens[:, :6], max_len=8)


def test_local_global_cache_sizes():
    cfg = tmodel.get_config("gemma3-12b").reduced(dtype="float32", num_layers=6, window=8)
    cache = ttf.init_cache(cfg, batch=2, max_len=64, dtype=torch.float32, device="cpu")
    assert [c["k"].shape[1] for c in cache["layers"]] == [8, 8, 8, 8, 8, 64]
    jcache = jtf.init_cache(jmodel.get_config("gemma3-12b").reduced(
        dtype="float32", num_layers=6, window=8), batch=2, max_len=64, dtype=jnp.float32)
    assert [c["k"].shape for c in jcache["layers"]] == [
        tuple(c["k"].shape) for c in cache["layers"]]
    assert ttf.layer_is_global(cfg).tolist() == jtf.layer_is_global(cfg).tolist()


def test_bfloat16_compute():
    """Compute in bfloat16 (the configs' default), float32 parameters cast
    per layer on both sides, a float32 cache."""
    jcfg, tcfg, jp, tp = _setup("qwen2.5-32b", 5, dtype="bfloat16")
    tokens = _tokens(jcfg, 6, 2, 8)
    want = jtf.forward(jp, jcfg, tokens)
    got = ttf.forward(tp, tcfg, T(tokens))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, dtype=np.float32), BF16)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(p, jcfg, c, t))
    jcache = jtf.init_cache(jcfg, 2, max_len=8, dtype=jnp.float32)
    tcache = ttf.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(4):
        want, jcache = jstep(jp, jcache, tokens[:, t])
        got, tcache = ttf.decode_step(tp, tcfg, tcache, T(tokens[:, t]))
        close(got, np.asarray(want, dtype=np.float32), BF16)


def test_params_from_numpy_bfloat16_bit_exact_and_module():
    cfg = jmodel.get_config("zamba2-2.7b").reduced(dtype="float32")
    jp = jtf.init_params(jax.random.PRNGKey(9), cfg, param_dtype=jnp.bfloat16)
    tp = T(jp)
    w = np.asarray(jp["layers"]["in_x"])
    assert tp["layers"]["in_x"].dtype == torch.bfloat16
    assert tp["layers"]["in_x"].view(torch.int16).numpy().tobytes() == w.view(np.int16).tobytes()
    assert tp["layers"]["dt_bias"].dtype == torch.float32  # kept float32, as the reference
    tcfg = tmodel.get_config("zamba2-2.7b").reduced(dtype="float32")
    lm = tmodel.DecoderLM(tcfg, tp)
    names = dict(lm.named_parameters())
    assert "layers.in_x" in names and "shared_attn.wq" in names
    assert len(names) == len(jax.tree.leaves(jp))
    tokens = T(_tokens(cfg, 7, 2, 8))
    assert torch.equal(lm(tokens), ttf.forward(tp, tcfg, tokens))
    cache = lm.init_cache(2, 8, dtype=torch.float32)
    logits, cache = lm.decode_step(cache, tokens[:, 0])
    assert logits.shape == (2, tcfg.vocab_size)


def test_port_init_and_synthetic_prefix():
    """The port's own draws: the reference's layout, finite, seeded."""
    cfg = tmodel.get_config("musicgen-medium").reduced(dtype="float32")
    a = tmodel.init_params(0, cfg, device="cpu")
    b = tmodel.init_params(0, cfg, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert a["layers"]["wq"].shape == (cfg.num_layers, cfg.d_model, cfg.num_heads * 16)
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    g = torch.Generator().manual_seed(1)
    pre = synthetic_prefix(g, cfg, 2)
    assert pre.dtype == torch.bfloat16 and pre.shape == (2, cfg.frontend_len, cfg.d_model)
    assert synthetic_prefix(g, tmodel.get_config("qwen2.5-32b").reduced(), 2) is None
    logits = ttf.forward(a, cfg, torch.zeros(2, 8, dtype=torch.int32), pre)
    assert logits.shape == (2, 8 + cfg.frontend_len, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
