"""The host-side contract of the W4A8 GEMM kernel (``csrc/w4a8_gemm.cuh``).

* Zero rows: where it quantizes its activations (the 2-D GEMM, the MoE
  expert slabs), the kernel multiplies only the rows whose absmax is not 0
  and writes 0 for the others. That rests on such a row coming out exactly
  0: it does in the port's plain versions and in repro's interpret-mode
  Pallas kernels, 2-D and batched, with and without LoRC, under M2 and plain
  group scales, while a NaN row beside it stays NaN.
* The launch plan (``kernels.w4a8_fused.gemm_plan``): at every GEMM shape
  ``chip_smoke.py`` serves or times (opt-125m, MiniCPM3-4B, OLMoE-1B-7B,
  the kernel API's), the ranks of a cluster cover each K chunk exactly
  once, each rank at least one; at a decode step's M = 4 every weight of
  1 MB or more puts at least 132 blocks in flight. Its shared memory
  (``smem_bytes``, the kernel's layout) fits the card's at every such
  shape, where ``fitted_plan`` is the plan itself; at nemotron-4-340b's
  K = 73728 one rank's scale table outgrows it, and ``fitted_plan`` splits
  K further.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import _pack_batched, pack_linear as j_pack_linear
from repro.kernels import ref as jref
from repro.kernels.w4a8_fused import w4a8_fused_batched_pallas, w4a8_fused_matmul_pallas
from repro_torch.kernels import ref as tref
from repro_torch.kernels.w4a8_fused import (BK, MAX_KS, MAX_SMEM, SMS, chunk_ranges, fitted_plan,
                                            gemm_plan, smem_bytes)

from test_torch_bridge import t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _served_shapes():
    """(M, K, N, E) of every W4A8 GEMM launch chip_smoke.py drives or times."""
    cs = _chip_smoke()
    shapes = {(m, k, n, 1) for m in (4, 64, 256)
              for k, n in ((768, 768), (768, 3072), (3072, 768))}           # opt-125m
    shapes |= {(m, k, n, 1) for k, n in cs.MINICPM3_GEMMS for m in (4, 260)}  # MiniCPM3
    shapes |= {(4, 256, 64, 40), (4, 64, 256, 40)}                        # wv_b, wk_b
    shapes |= {(m, 2048, 2048, 1) for m in (4, 260)}                       # OLMoE attention
    shapes |= {(m, k, n, 64) for _, k, n in cs.OLMOE_EXPERTS for m in (4, 70, 260)}
    shapes |= {(m, k, n, 1) for m, k, n in cs.SPLIT_GEMMS}                 # the kernel API
    shapes |= {(m, k, n, 1) for _, m, k, n, _ in cs.MICROBENCH}
    return sorted(shapes)


@pytest.mark.parametrize("shape", _served_shapes(), ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_each_chunk_once(shape):
    m, k, n, e = shape
    bn, ks = gemm_plan(m, n, k, e)
    assert bn in (32, 64, 128) and 1 <= ks <= MAX_KS
    ranges = chunk_ranges(k, ks)
    chunks = [c for r in ranges for c in r]
    assert chunks == list(range(-(-k // BK))) and all(len(r) > 0 for r in ranges)
    blocks = -(-n // bn) * ks * -(-m // 64) * e
    if m == 4 and n * k * e // 2 >= 1 << 20:
        assert blocks >= SMS, (shape, bn, ks, blocks)


@pytest.mark.parametrize("r", [0, 8])
def test_fitted_plan_is_the_plan_where_it_fits(r):
    """At every served shape (groups of 256; the batched MLA shapes also
    transposed) the plan's shared memory fits, so fitted_plan keeps it."""
    for m, k, n, e in _served_shapes():
        for transpose in ((False, True) if e > 1 else (False,)):
            kk, nn = (n, k) if transpose else (k, n)
            bn, ks = gemm_plan(m, nn, kk, e)
            assert smem_bytes(m, bn, ks, kk, 256, r, transpose, nn) <= MAX_SMEM, (m, k, n, e)
            assert fitted_plan(m, nn, kk, 256, r, transpose, e) == (bn, ks)


# nemotron-4-340b's GEMMs (d_model 18432, 96 heads of 192 over 8 KV heads,
# d_ff 73728): q / o, k / v, up, down
NEMOTRON_GEMMS = ((18432, 18432), (18432, 1536), (18432, 73728), (73728, 18432))


@pytest.mark.parametrize("m", [4, 64, 256])
@pytest.mark.parametrize("k,n", NEMOTRON_GEMMS)
def test_fitted_plan_fits_nemotron(m, k, n):
    """The down projection's K = 73728 on one rank needs a 147 KB scale
    table: with a wgmma tile (M > 32) the launch outgrows MAX_SMEM, which
    the kernel refuses (CUDA error 1 on the card); the fitted plan splits K
    over more ranks, each chunk still covered once."""
    bn, ks = fitted_plan(m, n, k, 256, 8)
    assert smem_bytes(m, bn, ks, k, 256, 8) <= MAX_SMEM
    ranges = chunk_ranges(k, ks)
    assert [c for rg in ranges for c in rg] == list(range(-(-k // BK)))
    assert all(len(rg) > 0 for rg in ranges) and bn in (32, 64, 128) and ks <= MAX_KS
    plain = gemm_plan(m, n, k)
    if (m, k) == (256, 73728):
        assert smem_bytes(m, *plain, k, 256, 8) > MAX_SMEM and (bn, ks) != plain
    if k != 73728:
        assert (bn, ks) == plain


def _x(rng, e, m, k, zero_rows, nan_row=None):
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    x[:, zero_rows] = 0.0
    if nan_row is not None:
        x[:, nan_row, 3] = np.nan
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("scale_mode", ["m2", "none"])
@pytest.mark.parametrize("lorc_rank", [0, 8])
def test_zero_rows_come_out_exactly_zero(scale_mode, lorc_rank):
    """Rows 0 and 5 are zero, row 2 holds a NaN: the zero rows are exact 0
    in every output column, the NaN row NaN throughout, in the plain
    versions (2-D and batched) and in repro's Pallas kernels."""
    rng = np.random.default_rng(11 + lorc_rank)
    e, m, n, k, group, zero = 3, 7, 64, 256, 128, [0, 5]
    kw = dict(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=group,
              scale_mode=scale_mode, lorc_rank=lorc_rank)
    w = jnp.asarray(rng.normal(size=(e, n, k)).astype(np.float32) * 0.05)
    pw = _pack_batched(w, JPolicy(**kw))
    p2 = j_pack_linear(w[0], JPolicy(**kw))
    x = _x(rng, e, m, k, zero, nan_row=2)
    opt = lambda a: None if a is None else t(np.asarray(a))
    outs = {
        "plain batched": to_np(tref.w4a8_batched_matmul_ref(
            t(np.asarray(x)), t(np.asarray(pw.codes)), t(np.asarray(pw.scale)),
            opt(pw.lorc_a), opt(pw.lorc_b), a_fmt="fp8_e4m3", group_size=group)),
        "pallas batched": np.asarray(w4a8_fused_batched_pallas(
            x, pw.codes, pw.scale, pw.s_max, pw.shifts, pw.lorc_a, pw.lorc_b,
            a_fmt="fp8_e4m3", group_size=group, interpret=True)),
        "plain 2-D": to_np(tref.w4a8_matmul_ref(
            t(np.asarray(x[0])), t(np.asarray(p2.codes)), t(np.asarray(p2.scale)),
            opt(p2.lorc_a), opt(p2.lorc_b), a_fmt="fp8_e4m3", group_size=group).float())[None],
        "pallas 2-D": np.asarray(w4a8_fused_matmul_pallas(
            x[0], p2.codes, p2.scale, p2.s_max, p2.shifts, p2.lorc_a, p2.lorc_b,
            a_fmt="fp8_e4m3", group_size=group, bm=8, bn=32, interpret=True)
            .astype(jnp.float32))[None],
    }
    live = [i for i in range(m) if i not in zero and i != 2]
    for name, y in outs.items():
        assert y.shape[1:] == (m, n), name
        zeros = y[:, zero]
        assert np.all(zeros == 0) and not np.any(np.signbit(zeros)), name
        assert np.all(np.isnan(y[:, 2])), name
        assert np.all(np.isfinite(y[:, live])) and np.all(np.abs(y[:, live]).sum(-1) > 0), name


def test_zero_slab_and_one_live_row():
    """A slab with no live row comes out 0; one whose only live row is its
    last, or whose only nonzero element is 1e-30 (scale floored at 1e-12,
    quantized to zeros), matches repro's oracle."""
    rng = np.random.default_rng(12)
    e, m, n, k, group = 3, 5, 64, 128, 128
    pw = _pack_batched(jnp.asarray(rng.normal(size=(e, n, k)).astype(np.float32) * 0.05),
                       JPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=group,
                               scale_mode="m2", lorc_rank=8))
    x = np.zeros((e, m, k), np.float32)
    x[1, m - 1] = rng.normal(size=k)
    x[2, 1, 17] = 1e-30
    x = jnp.asarray(x).astype(jnp.bfloat16)
    y = to_np(tref.w4a8_batched_matmul_ref(
        t(np.asarray(x)), t(np.asarray(pw.codes)), t(np.asarray(pw.scale)),
        t(np.asarray(pw.lorc_a)), t(np.asarray(pw.lorc_b)), a_fmt="fp8_e4m3", group_size=group))
    y_ref = np.asarray(jref.w4a8_batched_matmul_ref(x, pw.codes, pw.scale, pw.lorc_a, pw.lorc_b,
                                                    a_fmt="fp8_e4m3", group_size=group))
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)
    assert np.all(y[0] == 0) and np.all(y[1, :m - 1] == 0) and np.all(y[2] == 0)
    assert np.abs(y[1, m - 1]).sum() > 0
