"""repro_torch.core against repro.core: grids, codes, scales, quantizers
and RTN packing are bit-exact on the sweeps of test_core_formats.py and
test_core_quantize.py; LoRC is compared on the reconstructed correction
A·B (SVD signs differ between implementations) to 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import lorc as JL
from repro.core import quantize as JQ
from repro.core import scales as JS
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import pack_linear as j_pack_linear
from repro.kernels import common as JC
from repro_torch.core import formats as TF
from repro_torch.core import lorc as TL
from repro_torch.core import quantize as TQ
from repro_torch.core import scales as TS
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.core.ptq import effective_group, pack_linear as t_pack_linear
from repro_torch.kernels import common as TC
from repro_torch.models.layers import PackedLinear

from test_torch_bridge import t, to_np

FLOAT_FMTS = ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1", "fp4_e3m0"]


def _sweep(name, seed=0):
    """test_core_formats' random sweep plus the grid, its midpoints (ties),
    saturating values and zeros of both signs."""
    fmt = JF.FORMATS[name]
    rng = np.random.default_rng(seed)
    grid = JF.value_grid(name)
    mids = (grid[1:] + grid[:-1]) / 2
    return np.concatenate([
        rng.normal(size=4096).astype(np.float32) * fmt.max_value * 0.4,
        rng.normal(size=1024).astype(np.float32) * fmt.min_subnormal * 4,
        grid, mids, [1e9, -1e9, fmt.max_value * 1.5, 0.0, -0.0, 1e-30]]).astype(np.float32)


def _eq(a_t, a_j, msg=""):
    np.testing.assert_array_equal(to_np(a_t), np.asarray(a_j), err_msg=msg)


@pytest.mark.parametrize("name", FLOAT_FMTS)
def test_quantize_to_grid_bit_exact(name):
    x = _sweep(name)
    _eq(TF.quantize_to_grid(t(x), TF.FORMATS[name]), JF.quantize_to_grid(jnp.asarray(x), JF.FORMATS[name]))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    qb = TF.quantize_to_grid(t(np.asarray(xb)), TF.FORMATS[name])
    assert qb.dtype == torch.bfloat16
    _eq(qb, JF.quantize_to_grid(xb, JF.FORMATS[name]).astype(jnp.float32))


@pytest.mark.parametrize("name", FLOAT_FMTS)
def test_encode_decode_bit_exact(name):
    tf, jf = TF.FORMATS[name], JF.FORMATS[name]
    grid = JF.value_grid(name)
    np.testing.assert_array_equal(TF.value_grid(name), grid)
    q = np.asarray(JF.quantize_to_grid(jnp.asarray(_sweep(name, 1)), jf))
    for vals in (grid, q):
        _eq(TF.fp_encode(t(vals), tf), JF.fp_encode(jnp.asarray(vals), jf))
    codes = np.arange(2 ** jf.bits, dtype=np.uint8)
    _eq(TF.fp_decode(t(codes), tf), JF.fp_decode(jnp.asarray(codes), jf))


def test_pow2i_and_nibbles():
    k = np.arange(-140, 140, dtype=np.int32)
    _eq(TF.pow2i(t(k)), JF.pow2i(jnp.asarray(k)))
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, size=(8, 64), dtype=np.uint8)
    packed = TF.pack_nibbles(t(codes))
    _eq(packed, JF.pack_nibbles(jnp.asarray(codes)))
    _eq(TF.unpack_nibbles(packed), codes)


def test_kernel_decoders_bit_exact():
    codes = np.arange(16, dtype=np.uint8)
    _eq(TC.decode_e2m1(t(codes)), JC.decode_e2m1(jnp.asarray(codes)))
    _eq(TC.decode_e3m0(t(codes)), JC.decode_e3m0(jnp.asarray(codes)))
    c8 = np.arange(256, dtype=np.uint8)[:, None].repeat(5, 1)
    shifts = np.array([0, 1, 7, 20, 31], np.int32)[None]  # M2 shifts lie in [0, 31]
    fmt = JF.FORMATS["fp8_e4m3"]
    _eq(TC.decode_fp8(t(c8), TF.FORMATS["fp8_e4m3"], t(shifts)),
        JC.decode_fp8(jnp.asarray(c8), fmt, jnp.asarray(shifts)))
    x = np.concatenate([_sweep("fp8_e4m3", 2), np.zeros(5, np.float32)]).reshape(-1, 8)
    qv, sc = TC.quantize_rows(t(x), TF.FORMATS["fp8_e4m3"])
    jq, js = JC.quantize_rows(jnp.asarray(x), fmt)
    _eq(qv, jq)
    _eq(sc, js)


def _scale_sweep(seed):
    rng = np.random.default_rng(seed)
    s = np.abs(rng.normal(size=(32, 16))).astype(np.float32) + 0.01
    s[0] = [2.0**-7, 2.0**-3, 1.0, 32.0] * 4  # pow-2 lattice: idempotent
    s[1, :4] = [1.0, 1e-12, 1e-30, 0.5]  # pathological ratios: clipped shifts
    return s


@pytest.mark.parametrize("rounding", ["ceil", "floor"])
@pytest.mark.parametrize("max_shift", [4, 31])
def test_scales_bit_exact(rounding, max_shift):
    s = _scale_sweep(7)
    _eq(TS.constrain_scales_m1(t(s)), JS.constrain_scales_m1(jnp.asarray(s)))
    for axis in (-1, 0):
        tm = TS.constrain_scales_m2(t(s), group_axis=axis, max_shift=max_shift, rounding=rounding)
        jm = JS.constrain_scales_m2(jnp.asarray(s), group_axis=axis, max_shift=max_shift,
                                    rounding=rounding)
        for a, b in zip(tm, jm):
            _eq(a, b)
    for mode in ("none", "m1", "m2"):
        _eq(TS.apply_scale_constraint(t(s), mode), JS.apply_scale_constraint(jnp.asarray(s), mode))


@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp4_e3m0", "int4", "int8", "fp8_e4m3", "int4_asym"])
@pytest.mark.parametrize("group", [32, 128])
def test_quantize_weight_bit_exact(fmt, group):
    rng = np.random.default_rng(group)
    w = rng.normal(size=(32, 256)).astype(np.float32) * 0.02
    w[np.arange(32), rng.integers(0, 256, 32)] += 1.5  # outliers
    tq = TQ.quantize_weight(t(w), fmt, group)
    jq = JQ.quantize_weight(jnp.asarray(w), fmt, group)
    _eq(tq.values, jq.values)
    _eq(tq.scale, jq.scale)
    if jq.zero_point is not None:
        _eq(tq.zero_point, jq.zero_point)
    _eq(tq.dequantize(), jq.dequantize())
    scale = np.asarray(JS.constrain_scales_m2(jq.scale).scales)
    _eq(TQ.quantize_weight(t(w), fmt, group, scale=t(scale)).values,
        JQ.quantize_weight(jnp.asarray(w), fmt, group, scale=jnp.asarray(scale)).values)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "int8"])
def test_activation_quant_bit_exact(fmt):
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(4, 7, 64)).astype(np.float32)) ** 3
    x[..., 0] += 100.0
    x[0, 0] = 0.0  # an all-zero token: scale floors at 1e-12
    tq, ts = TQ.quantize_act_tokenwise(t(x), fmt)
    jq, js = JQ.quantize_act_tokenwise(jnp.asarray(x), fmt)
    _eq(tq, jq)
    _eq(ts, js)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    fb = TQ.fake_quantize_act(t(np.asarray(xb)), fmt)
    assert fb.dtype == torch.bfloat16
    _eq(fb, JQ.fake_quantize_act(xb, fmt).astype(jnp.float32))
    assert TQ.fake_quantize_act(t(x), "none") is not None


def test_lorc_correction_matches():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(96, 128)).astype(np.float32) * 0.02
    wq = np.asarray(JQ.fake_quantize_weight(jnp.asarray(w), "fp4_e2m1", 64))
    for rank in (4, 8):
        tf = TL.lorc_compensate(t(w), t(wq), rank)
        jf = JL.lorc_compensate(jnp.asarray(w), jnp.asarray(wq), rank)
        np.testing.assert_allclose(to_np(tf.a @ tf.b), np.asarray(jf.a @ jf.b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("w_fmt", ["fp4_e2m1", "fp4_e3m0"])
@pytest.mark.parametrize("scale_mode,lorc_rank", [("none", 0), ("m1", 0), ("m2", 8)])
@pytest.mark.parametrize("shape,group", [((64, 256), 256), ((128, 192), 64), ((96, 100), 256)])
def test_pack_linear_bit_exact(w_fmt, scale_mode, lorc_rank, shape, group):
    rng = np.random.default_rng(shape[1] + group)
    w = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 0.05).astype(jnp.bfloat16)
    kw = dict(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=group, scale_mode=scale_mode,
              lorc_rank=lorc_rank)
    jp = j_pack_linear(w, JPolicy(**kw))
    tp = t_pack_linear(t(np.asarray(w)), TPolicy(**kw))
    assert tp.group_size == jp.group_size == effective_group(shape[1], group)
    for field in ("codes", "scale", "s_max", "shifts"):
        a, b = getattr(tp, field), getattr(jp, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert to_np(a).dtype == np.asarray(b).dtype, field
            _eq(a, b, field)
    for field in PackedLinear._FIELDS:  # row-major, as the CUDA kernel takes them
        assert getattr(tp, field) is None or getattr(tp, field).is_contiguous(), field
    if lorc_rank:
        corr_t = to_np(tp.lorc_a.float() @ tp.lorc_b.float())
        corr_j = np.asarray(jp.lorc_a.astype(jnp.float32) @ jp.lorc_b.astype(jnp.float32))
        # the factors are rounded to bf16 after the SVD: compare at bf16's
        # resolution of the factor magnitudes
        tol = 2.0**-7 * float(np.abs(corr_j).max())
        np.testing.assert_allclose(corr_t, corr_j, atol=tol, rtol=0)
