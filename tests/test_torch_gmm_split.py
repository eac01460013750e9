"""The exact three-piece bf16 split of a float32 operand
(``repro_torch.kernels.grouped_matmul.split_bf16x3``), on the CPU.

The wgmma variant of ``grouped_matmul`` (``csrc/grouped_matmul_sm90.cu``)
takes a float32 ``x`` to the tensor cores as ``hi + mid + lo``, three bf16
pieces, each multiplied by the bf16 weights exactly in float32.  Here:

  * the pieces sum back to ``x`` bit for bit in every exponent band from
    2^-100 to 2^127, and within 2^-126 below it;
  * inf and NaN ride in ``hi`` with ``mid = lo = 0``, and ``hi`` stays finite
    up to FLT_MAX;
  * the three pieces' products summed in float32 match
    ``grouped_matmul_pallas`` in interpret mode on f32 x bf16 inputs within
    ``rtol=1e-4, atol=1e-4 * max|want|``, the card's tolerance (both sides
    sum exact float32 products in float32, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.grouped_matmul import grouped_matmul_pallas  # noqa: E402
from repro_torch.kernels import grouped_matmul as tg  # noqa: E402
from repro_torch.kernels import moe_dispatch as tmd  # noqa: E402

FLT_MAX = float(np.finfo(np.float32).max)
PER_BAND = 20_000


def _band(rng, lo_exp, hi_exp):
    """PER_BAND float32 values of random sign and mantissa in each exponent
    band 2^e, lo_exp <= e < hi_exp."""
    exps = np.repeat(np.arange(lo_exp, hi_exp), PER_BAND)
    mant = rng.integers(0, 1 << 23, exps.size, dtype=np.int64)
    sign = rng.integers(0, 2, exps.size, dtype=np.int64) << 31
    bits = sign | ((exps + 127) << 23) | mant
    return torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(torch.float32)


def _sum(pieces):
    hi, mid, lo = (p.float() for p in pieces)
    return (hi + mid) + lo


@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -40), (-40, 20), (20, 80), (80, 128)])
def test_split_reconstructs_bit_for_bit(lo_exp, hi_exp):
    x = _band(np.random.default_rng(lo_exp + 200), lo_exp, hi_exp)
    hi, mid, lo = tg.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    got = _sum((hi, mid, lo))
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))
    # hi and mid are truncations: the bf16 pieces hold exactly x's leading bits
    assert torch.equal(hi.float().view(torch.int32), x.view(torch.int32) & -(1 << 16))
    assert bool(torch.isfinite(hi.float()).all())


def test_split_error_below_two_to_the_minus_100():
    """Normal values from 2^-126 and subnormals: the residual falls into
    bf16's subnormal range; the error stays under 2^-126."""
    rng = np.random.default_rng(5)
    normal = _band(rng, -126, -100)
    sub = torch.from_numpy(
        rng.integers(1, 1 << 23, 100_000).astype(np.int32)
    ).view(torch.float32)
    x = torch.cat([normal, sub, -sub])
    err = (_sum(tg.split_bf16x3(x)).double() - x.double()).abs()
    assert float(err.max()) < 2.0**-126


def test_split_special_values():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), FLT_MAX, -FLT_MAX,
                      3.3e38, 1e30, 1e-30, 0.0, -0.0])
    hi, mid, lo = tg.split_bf16x3(x)
    h = hi.float()
    assert h[0] == float("inf") and h[1] == -float("inf") and torch.isnan(h[2])
    assert torch.equal(mid[:3].float(), torch.zeros(3)) and torch.equal(lo[:3].float(),
                                                                        torch.zeros(3))
    assert bool(torch.isfinite(h[3:]).all())  # truncation keeps FLT_MAX finite
    assert torch.equal(_sum((hi, mid, lo))[3:], x[3:])
    with pytest.raises(TypeError):
        tg.split_bf16x3(x.double())


@pytest.mark.parametrize(
    "T,D,F,offs",
    [
        (256, 128, 256, [0, 60, 60, 200, 256]),  # an empty group
        (256, 72, 128, [0, 100, 256]),  # a K tail: D % 64 != 0
        (128, 64, 64, [10, 40, 90, 100]),  # rows outside every group
    ],
)
def test_three_piece_product_matches_pallas(T, D, F, offs):
    rng = np.random.default_rng(T + D + F)
    E = len(offs) - 1
    x = jnp.asarray(rng.normal(size=(T, D)) * np.exp2(rng.integers(-20, 20, (T, 1))),
                    dtype=jnp.float32)
    w = jnp.asarray(rng.normal(size=(E, D, F)) * 0.1, dtype=jnp.bfloat16)
    o = jnp.asarray(np.array(offs, np.int32))
    want = np.asarray(grouped_matmul_pallas(x, w, o, block_t=64, block_f=64, interpret=True))
    p = tmd.params_from_numpy({"x": np.asarray(x), "w": np.asarray(w), "offs": np.asarray(o)},
                              device="cpu")
    got = sum(tg.grouped_matmul_reference(piece, p["w"], p["offs"])
              for piece in tg.split_bf16x3(p["x"]))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)
    outside = np.r_[0 : offs[0], offs[-1] : T]
    assert np.all(got.numpy()[outside] == 0)
