"""The port's plain kernel versions against repro's, and the dispatch.

* W4A8 GEMM: the port's plain ``w4a8_matmul`` is within 1e-4 of
  ``repro.kernels.ref.w4a8_matmul_ref`` (the same bf16 operands and
  products; only the f32 summation order differs) and within 2e-2 of
  ``w4a8_fused_matmul_pallas(interpret=True)`` — the tolerance of
  tests/test_w4a8_fused.py, because the Pallas kernel applies M2 as 2^-k
  per group and s_max after the K loop, where the plain version rounds
  q * s_max * 2^-k to bf16.
* Paged decode attention: the plain version is within 2e-5 of
  ``paged_decode_attn_ref`` and of the interpret-mode Pallas kernel, the
  tolerance of tests/test_kv_cache.py.
* On CPU tensors ``kernels.ops`` takes the plain versions; the CUDA
  wrappers refuse CPU tensors, and the build refuses to run without nvcc.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import pack_linear as j_pack_linear
from repro.kernels import ref as jref
from repro.kernels.decode_attn import paged_decode_attn_pallas
from repro.kernels.w4a8_fused import w4a8_fused_matmul_pallas
from repro.runtime import kv_cache as jkvc
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda
from repro_torch.models.layers import PackedLinear

from test_torch_bridge import t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)


def _packed(rng, n, k, group, w_fmt, scale_mode, lorc_rank):
    w = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32) * 0.05)
    return j_pack_linear(w, JPolicy(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=group,
                                    scale_mode=scale_mode, lorc_rank=lorc_rank))


def _port(jp) -> PackedLinear:
    opt = lambda a: None if a is None else t(np.asarray(a))
    return PackedLinear(codes=t(np.asarray(jp.codes)), scale=t(np.asarray(jp.scale)),
                        s_max=opt(jp.s_max), shifts=opt(jp.shifts), lorc_a=opt(jp.lorc_a),
                        lorc_b=opt(jp.lorc_b), w_fmt=jp.w_fmt, a_fmt=jp.a_fmt,
                        group_size=jp.group_size)


@pytest.mark.parametrize("scale_mode", ["none", "m2"])
@pytest.mark.parametrize("lorc_rank", [0, 8])
@pytest.mark.parametrize("mnk,group", [((5, 128, 256), 128), ((16, 96, 512), 256),
                                       ((3, 256, 384), 128)])
def test_w4a8_plain_matches_reference(scale_mode, lorc_rank, mnk, group):
    m, n, k = mnk
    rng = np.random.default_rng(m * n + k + lorc_rank)
    jp = _packed(rng, n, k, group, "fp4_e2m1", scale_mode, lorc_rank)
    w = _port(jp)
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(jnp.bfloat16)
    y = ops.w4a8_matmul(t(np.asarray(x)), w)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    # f32 in, f32 out: the comparison with the reference is not hidden by
    # the final bf16 rounding
    y32 = to_np(tref.w4a8_matmul_ref(t(np.asarray(x.astype(jnp.float32))), w.codes, w.scale,
                                     w.lorc_a, w.lorc_b, a_fmt="fp8_e4m3", group_size=w.group_size))
    y_ref = np.asarray(jref.w4a8_matmul_ref(x.astype(jnp.float32), jp.codes, jp.scale, jp.lorc_a,
                                            jp.lorc_b, a_fmt="fp8_e4m3", group_size=jp.group_size))
    np.testing.assert_allclose(y32, y_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(y), np.asarray(y_ref.astype(jnp.bfloat16).astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    y_pal = np.asarray(w4a8_fused_matmul_pallas(
        x, jp.codes, jp.scale, jp.s_max, jp.shifts, jp.lorc_a, jp.lorc_b, w_fmt=jp.w_fmt,
        a_fmt="fp8_e4m3", group_size=jp.group_size, bm=8, bn=32, interpret=True))
    np.testing.assert_allclose(y32, y_pal, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("w_fmt", ["fp4_e3m0"])
def test_w4a8_plain_e3m0_and_no_act_quant(w_fmt):
    rng = np.random.default_rng(3)
    jp = _packed(rng, 64, 256, 64, w_fmt, "m2", 4)
    w = _port(jp)
    x = rng.normal(size=(7, 256)).astype(np.float32)
    for a_fmt in ("fp8_e4m3", None):
        y = to_np(tref.w4a8_matmul_ref(t(x), w.codes, w.scale, w.lorc_a, w.lorc_b,
                                       w_fmt=w_fmt, a_fmt=a_fmt, group_size=64))
        y_ref = np.asarray(jref.w4a8_matmul_ref(jnp.asarray(x), jp.codes, jp.scale, jp.lorc_a,
                                                jp.lorc_b, w_fmt=w_fmt, a_fmt=a_fmt,
                                                group_size=64))
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)
    _eq_deq = tref.dequant_packed_ref(w.codes, w.scale, w_fmt, 64)
    np.testing.assert_array_equal(
        to_np(_eq_deq), np.asarray(jref.dequant_packed_ref(jp.codes, jp.scale, w_fmt, 64)
                                   .astype(jnp.float32)))


@pytest.mark.parametrize("w_fmt", ["fp4_e2m1", "fp4_e3m0"])
def test_w4a8_plain_e5m2_activations(w_fmt):
    """The 2-D GEMM with activations quantized onto FP8 E5M2 (a variant the
    card now runs): the port's plain version against repro's oracle."""
    rng = np.random.default_rng(5)
    jp = _packed(rng, 64, 256, 64, w_fmt, "m2", 4)
    w = _port(jp)
    x = (rng.normal(size=(9, 256)) * 7.0).astype(np.float32)
    y = to_np(tref.w4a8_matmul_ref(t(x), w.codes, w.scale, w.lorc_a, w.lorc_b, w_fmt=w_fmt,
                                   a_fmt="fp8_e5m2", group_size=64))
    y_ref = np.asarray(jref.w4a8_matmul_ref(jnp.asarray(x), jp.codes, jp.scale, jp.lorc_a,
                                            jp.lorc_b, w_fmt=w_fmt, a_fmt="fp8_e5m2",
                                            group_size=64))
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


def _pool(rng, kv, hd, page, pp, lens, fmt):
    """A random 1-layer pool (every E4M3 code is a finite grid value) and a
    page table whose entries past each row's pages point at the null page."""
    b = len(lens)
    p1 = b * pp + 1
    if fmt:
        layer = {n: rng.integers(0, 256, size=(p1, page, kv, hd), dtype=np.uint8)
                 for n in ("k", "v")}
        for n in ("k", "v"):
            layer[n + "_smax"] = rng.uniform(0.5, 2.0, size=(p1,)).astype(np.float32) / 64
            layer[n + "_shift"] = rng.integers(0, 4, size=(p1, kv), dtype=np.int32)
    else:
        layer = {n: np.asarray(jnp.asarray(rng.normal(size=(p1, page, kv, hd))
                                           .astype(np.float32)).astype(jnp.bfloat16))
                 for n in ("k", "v")}
    pt = np.full((b, pp), p1 - 1, np.int32)
    for r in range(b):
        npg = jkvc.pages_needed(int(lens[r]), page)
        pt[r, :npg] = rng.permutation(np.arange(r * pp, (r + 1) * pp))[:npg]
    return layer, pt


@pytest.mark.parametrize("fmt", ["fp8_e4m3", None])
@pytest.mark.parametrize("kv,g,hd,page,pp,window", [
    (2, 2, 16, 8, 3, 0), (1, 4, 32, 16, 2, 0), (4, 1, 8, 4, 4, 0), (2, 3, 64, 32, 2, 0),
    (2, 2, 16, 8, 3, 5), (4, 1, 8, 4, 4, 6)])
def test_paged_decode_plain_matches_reference(fmt, kv, g, hd, page, pp, window):
    rng = np.random.default_rng(kv * 100 + g * 10 + hd + window)
    lens = np.array([page * pp - 3, max(1, page // 2), 1], np.int32)  # ragged
    layer, pt = _pool(rng, kv, hd, page, pp, lens, fmt)
    q = rng.normal(size=(3, kv * g, hd)).astype(np.float32)
    tl = {k: t(v) for k, v in layer.items()}
    o = to_np(ops.paged_decode_attn(t(q), tl, t(pt), t(lens), window=window))
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    if fmt:
        sc = (jl["k_smax"], jl["k_shift"], jl["v_smax"], jl["v_shift"])
    else:
        sc = (jnp.zeros((1,), jnp.float32), jnp.zeros((1, 1), jnp.int32)) * 2
    o_ref = np.asarray(jref.paged_decode_attn_ref(jnp.asarray(q), jl["k"], jl["v"], *sc,
                                                  jnp.asarray(pt), jnp.asarray(lens), fmt=fmt,
                                                  window=window))
    np.testing.assert_allclose(o, o_ref, rtol=2e-5, atol=2e-5)
    o_pal = np.asarray(paged_decode_attn_pallas(
        jnp.asarray(q), jl["k"], jl["v"], *sc, jnp.asarray(pt), jnp.asarray(lens),
        fmt=fmt, window=window, interpret=True))
    np.testing.assert_allclose(o, o_pal, rtol=2e-5, atol=2e-5)


def test_paged_decode_plain_masks_stale_nan():
    """A NaN in a masked position of a live page must not reach the output
    (the masks are selects, not 0/1 multiplies, before and after the exp)."""
    rng = np.random.default_rng(0)
    layer, pt = _pool(rng, 2, 16, 8, 2, np.array([5, 9], np.int32), None)
    tl = {k: t(v) for k, v in layer.items()}
    for name in ("k", "v"):  # row 0 holds 5 tokens: position 6 is stale
        tl[name][pt[0, 0], 6] = float("nan")
    q = t(rng.normal(size=(2, 4, 16)).astype(np.float32))
    o = ops.paged_decode_attn(q, tl, t(pt), t(np.array([5, 9], np.int32)))
    assert torch.isfinite(o[0]).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        w4a8_fused_matmul_cuda(x, torch.zeros((8, 32), dtype=torch.uint8),
                               torch.ones((8, 1)), group_size=64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attn_cuda(torch.zeros((1, 2, 8)), torch.zeros((2, 4, 2, 8), dtype=torch.bfloat16),
                               torch.zeros((2, 4, 2, 8), dtype=torch.bfloat16), None, None, None,
                               None, torch.zeros((1, 1), dtype=torch.int32),
                               torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="without frozen"):
        paged_decode_attn_cuda(None, None, None, None, None, None, None, None, None,
                               k_fz=torch.zeros(1))


@pytest.mark.parametrize("w_fmt,a_fmt,err,match", [
    ("fp4_e3m0", "fp8_e4m3", ValueError, "CUDA"),   # E3M0 weights: built, so only
    ("fp4_e2m1", None, ValueError, "CUDA"),         # the CPU tensors are refused;
    ("fp4_e2m1", "fp8_e5m2", ValueError, "CUDA"),   # activations as they are, E5M2
    ("fp8_e4m3", "fp8_e4m3", NotImplementedError, "fp4_e2m1"),  # not an FP4 weight
])
def test_w4a8_cuda_wrapper_refuses_variants_it_does_not_build(w_fmt, a_fmt, err, match):
    """The kernel builds every W4A8 variant repro serves (E2M1 and E3M0
    weights; FP8 E4M3, E5M2 or unquantized activations): those pass the
    variant check and stop at the CPU tensors; any other weight format
    raises before a launch (the plain version takes it)."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(err, match=match):
        w4a8_fused_matmul_cuda(x, torch.zeros((8, 32), dtype=torch.uint8), torch.ones((8, 1)),
                               w_fmt=w_fmt, a_fmt=a_fmt, group_size=64)
    assert w4a8_fused_matmul_cuda.launches == 0


def test_build_refuses_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
