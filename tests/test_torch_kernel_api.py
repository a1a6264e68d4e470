"""The kernel API's three entry points that no served path reaches, against
repro: token-wise FP8 activation quantization, the split W4A8 GEMM and
flash attention. The same numpy inputs go through repro's interpret-mode
Pallas kernels and oracles and through the port's ``kernels.ops`` on CPU
tensors (the plain versions of ``kernels.ref``).

* act_quant: values and scales bit-identical to ``act_quant_pallas`` and
  to repro's ``act_quant_ref`` (the same f32 arithmetic: an f32 reciprocal
  multiplied, a true division, RNE onto the grid).
* The split GEMM: within 1e-5 of the largest |y| of
  ``w4a8_matmul_pallas`` (the same bf16 weights and products; the Pallas
  kernel sums K in groups, the plain version in one f32 matmul), and within
  repro's own 2e-2 of the f32 product with the dequantized weights.
* Flash attention: within 3e-2 (bf16) and 1e-4 (f32) of
  ``flash_attention_pallas``, the tolerances of tests/test_kernels.py, and
  within 1e-6 of repro's oracle in f32 (the same softmax; only the f32
  summation order differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import pack_linear as j_pack_linear
from repro.kernels import ref as jref
from repro.kernels.act_quant import act_quant_pallas
from repro.kernels.flash_attn import flash_attention_pallas
from repro.kernels.flash_attn import flash_attention_ref as j_flash_ref
from repro.kernels.w4a8_matmul import w4a8_matmul_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from test_torch_bridge import t, to_np
from test_torch_kernels import _port
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", [(8, 128), (3, 384), (5, 96)])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_act_quant_bit_identical(shape, fmt, dtype):
    rng = np.random.default_rng(sum(shape) + len(fmt))
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 13.0).astype(dtype)
    qk, sk = act_quant_pallas(x, fmt, interpret=True)
    qr, sr = jref.act_quant_ref(x, fmt)
    qt, st = ops.act_quant(t(x), fmt)
    assert qt.dtype == st.dtype == torch.float32 and st.shape == (*shape[:-1], 1)
    for q, s in ((qk, sk), (qr, sr)):
        np.testing.assert_array_equal(_bits(q), _bits(to_np(qt)))
        np.testing.assert_array_equal(_bits(s), _bits(to_np(st)))


def test_act_quant_outlier_row():
    """tests/test_kernels.py's outlier row: the outlier lands on the grid's
    top value, 480 for this E4M3 (not OCP's 448); a zero row on zeros."""
    x = np.stack([np.r_[np.full(127, 0.01), [100.0]], np.zeros(128)]).astype(np.float32)
    qk, sk = act_quant_pallas(jnp.asarray(x), "fp8_e4m3", interpret=True)
    qt, st = ops.act_quant(t(x), "fp8_e4m3")
    np.testing.assert_array_equal(_bits(qk), _bits(to_np(qt)))
    np.testing.assert_array_equal(_bits(sk), _bits(to_np(st)))
    assert float(qt[0, -1]) == 480.0 and not bool(qt[1].any())
    assert float(st[1, 0]) == np.float32(1e-12)


@pytest.mark.parametrize("w_fmt", ["fp4_e2m1", "fp4_e3m0"])
@pytest.mark.parametrize("scale_mode", ["m2", "none"])
@pytest.mark.parametrize("group", [128, 256])
def test_split_matmul_matches_pallas(w_fmt, scale_mode, group):
    m, n, k = 6, 96, 512
    rng = np.random.default_rng(len(w_fmt) + group + len(scale_mode))
    jp = j_pack_linear(jnp.asarray(rng.normal(size=(n, k)).astype(np.float32) * 0.05),
                       JPolicy(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=group,
                               scale_mode=scale_mode))
    assert (jp.shifts is not None) == (scale_mode == "m2")
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(jnp.bfloat16)
    qv, sc = jref.act_quant_ref(x, "fp8_e4m3")
    xq = (qv * sc).astype(jnp.bfloat16)
    y_pl = np.asarray(w4a8_matmul_pallas(xq, jp.codes, jp.scale, s_max=jp.s_max,
                                         shifts=jp.shifts, w_fmt=w_fmt, group_size=group,
                                         interpret=True))
    y = ops.w4a8_matmul_split(t(xq), _port(jp))
    assert y.dtype == torch.float32 and y.shape == (m, n)
    err = np.abs(to_np(y) - y_pl).max() / np.abs(y_pl).max()
    assert err <= 1e-5, err
    # repro's own bound, against the f32 product with the dequantized weights
    w_deq = np.asarray(jref.dequant_packed_ref(jp.codes, jp.scale, w_fmt, group), np.float32)
    np.testing.assert_allclose(to_np(y), np.asarray(xq, np.float32) @ w_deq.T, rtol=2e-2,
                               atol=2e-2)


def test_split_pipeline_matches_fused_plain():
    """The split pipeline through ops (act_quant, the bf16 cast, the split
    GEMM, LoRC by two bf16 matmuls) agrees with the fused GEMM's plain
    version to the W4A8 tolerance of tests/test_w4a8_fused.py."""
    rng = np.random.default_rng(3)
    m, n, k = 5, 128, 512
    jp = j_pack_linear(jnp.asarray(rng.normal(size=(n, k)).astype(np.float32) * 0.05),
                       JPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256,
                               scale_mode="m2", lorc_rank=8))
    w = _port(jp)
    x = t(jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(jnp.bfloat16))
    qv, sc = ops.act_quant(x, w.a_fmt)
    xq = (qv * sc).to(torch.bfloat16)
    lorc = torch.matmul(torch.matmul(xq, w.lorc_b.t()), w.lorc_a.t())
    y = ops.w4a8_matmul_split(xq, w) + lorc
    np.testing.assert_allclose(to_np(y), to_np(ops.w4a8_matmul(x, w)), rtol=2e-2, atol=2e-2)


def _qkv(rng, b, s, tk, h, hd, dv, dtype):
    mk = lambda *shape: jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
    return mk(b, s, h, hd), mk(b, tk, h, hd), mk(b, tk, h, dv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 3e-2), (jnp.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(1, 128, 2, 64, 64), (2, 96, 3, 32, 16)])
def test_flash_attention_matches_pallas(causal, dtype, tol, shape):
    b, s, h, hd, dv = shape
    rng = np.random.default_rng(b * s + h + hd)
    q, k, v = _qkv(rng, b, s, s, h, hd, dv, dtype)
    out = flash_attention_pallas(q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
    o = ops.flash_attention(t(q), t(k), t(v), causal=causal)
    assert o.dtype == t(v).dtype and o.shape == (b, s, h, dv)
    np.testing.assert_allclose(to_np(o), np.asarray(out, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,tk", [(64, 64), (40, 72), (72, 40)])
def test_flash_attention_plain_matches_oracle_f32(causal, s, tk):
    """T != S: the causal mask k_pos > q_pos has no offset, in both."""
    rng = np.random.default_rng(s + tk)
    q, k, v = _qkv(rng, 2, s, tk, 2, 48, 24, jnp.float32)
    o = tref.flash_attention_ref(t(q), t(k), t(v), causal)
    np.testing.assert_allclose(to_np(o), np.asarray(j_flash_ref(q, k, v, causal)), rtol=1e-6,
                               atol=1e-6)


def flash_tiles(b, s, h, hd, bf16):
    """(query rows, keys) of the kernel's tiles (``csrc/flash_attn.cu``'s
    ``Cfg``): 128 query rows where that grid still has a block for each of
    the 132 SMs, with 64-key tiles at hd 96 (two slabs a warp) and 128
    otherwise; 64 rows by 128 keys below; the f32 path 64 by 64."""
    if not bf16:
        return 64, 64
    bq = 128 if b * h * -(-s // 128) >= 132 else 64
    return bq, 64 if bq == 128 and -(-hd // 32) == 3 else 128


def flash_emulation(q, k, v, causal, bq=None, bkv=None):
    """``csrc/flash_attn.cu``'s dataflow in torch: q tiles of ``bq`` rows in
    the kernel's launch order (longest first when causal), each walking the
    KV tiles of ``bkv`` keys up to its last row (both by default the
    kernel's own, ``flash_tiles``), keys past T zero (their
    score -inf: out of the max and the sum); f32 scores, on the bf16 path
    the exact products summed then scaled (f32: q scaled first); the mask
    compared only on a tile that straddles the diagonal or holds keys past T
    (elsewhere it must mask nothing); the online (m, l, acc) with p cast to
    v's dtype before P . V, out = acc / max(l, 1e-30) in v's dtype. Returns
    (out, the keys each q tile walks, in launch order)."""
    b, s, h, hd = q.shape
    t_len, dv = k.shape[1], v.shape[-1]
    mma = q.dtype == torch.bfloat16
    tiles = flash_tiles(b, s, h, hd, mma)
    bq, bkv = bq or tiles[0], bkv or tiles[1]
    scale = torch.tensor(1.0 / float(hd) ** 0.5, dtype=torch.float32)
    nq = -(-s // bq)
    out, walked = torch.empty((b, s, h, dv), dtype=v.dtype), []
    for y in range(nq):
        q0 = (nq - 1 - y if causal else y) * bq
        qf = q[:, q0:q0 + bq].float().transpose(1, 2)  # (B, H, R, hd)
        qf = qf if mma else qf * scale
        rows = q0 + torch.arange(qf.shape[2])[:, None]
        kv_end = min(t_len, s, q0 + bq) if causal else t_len
        m = torch.full(qf.shape[:3], -1e30)
        l = torch.zeros(qf.shape[:3])
        acc = torch.zeros(qf.shape[:3] + (dv,))
        walked.append(kv_end)
        for k0 in range(0, kv_end, bkv):
            pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, k0 + bkv - min(t_len, k0 + bkv)))
            kt, vt = pad(k[:, k0:k0 + bkv]).transpose(1, 2), pad(v[:, k0:k0 + bkv]).transpose(1, 2)
            sc = torch.einsum("bhrd,bhkd->bhrk", qf, kt.float())
            sc = sc * scale if mma else sc
            keys = k0 + torch.arange(bkv)[None]
            masked = (keys > rows) if causal else torch.zeros_like(keys > rows)
            if (causal and k0 + bkv - 1 > q0) or k0 + bkv > t_len:
                sc = torch.where(keys >= t_len, -torch.inf, torch.where(masked, -1e30, sc))
            else:
                assert not masked.any() and not (keys >= t_len).any()
            mn = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - mn)
            p = torch.exp(sc - mn[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhrk,bhkd->bhrd",
                                                       p.to(v.dtype).float(), vt.float())
            m = mn
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2).to(v.dtype)
        out[:, q0:q0 + bq] = o[:, :max(0, min(bq, s - q0))]
    return out, walked


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, 3e-2), (jnp.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(1, 128, 2, 64, 64), (2, 96, 3, 32, 16)])
def test_flash_emulation_matches_pallas(causal, dtype, tol, shape):
    """The CUDA kernel's register dataflow (``flash_emulation``) against
    repro's Pallas kernel in interpret mode, at the CPU shapes above."""
    b, s, h, hd, dv = shape
    rng = np.random.default_rng(b * s + h + hd)
    q, k, v = _qkv(rng, b, s, s, h, hd, dv, dtype)
    want = flash_attention_pallas(q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
    got, walked = flash_emulation(t(q), t(k), t(v), causal)
    assert got.dtype == t(v).dtype and got.shape == (b, s, h, dv)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
    assert walked == sorted(walked, reverse=True)  # the longest q tiles first
    if causal:
        assert walked[0] > walked[-1]


@pytest.mark.parametrize("s,tk", [(100, 100), (40, 72), (72, 40)])
def test_flash_emulation_ragged_f32(s, tk):
    """Ragged S and T != S, tiles of 32 so several straddle the edges:
    within 1e-6 of the plain version in f32."""
    rng = np.random.default_rng(s * tk)
    q, k, v = _qkv(rng, 2, s, tk, 2, 20, 12, jnp.float32)
    for causal in (True, False):
        got, _ = flash_emulation(t(q), t(k), t(v), causal, bq=32, bkv=32)
        want = tref.flash_attention_ref(t(q), t(k), t(v), causal)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hd,dv", [(64, 64), (96, 64), (128, 128)])
def test_flash_emulation_wide_tiles(hd, dv):
    """The kernel's 128-row tiles (at 132 blocks: B = 2, H = 33, S = 256,
    trimmed to the rows the check reads) against the plain version: causal
    bf16 within FLASH_TOL's 3e-2."""
    b, s, h = 2, 256, 33
    assert flash_tiles(b, s, h, hd, True)[0] == 128
    rng = np.random.default_rng(hd + dv)
    q, k, v = (t(x) for x in _qkv(rng, b, s, s, h, hd, dv, jnp.bfloat16))
    got, walked = flash_emulation(q, k, v, True)
    assert walked == sorted(walked, reverse=True)
    want = tref.flash_attention_ref(q, k, v, True)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=3e-2, atol=3e-2)
