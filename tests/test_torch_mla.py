"""The MLA serving path of the port (MiniCPM3's family) against repro, on the
same numpy inputs:

* rope, the batched W4A8 plain version (both orientations, M2 and LoRC on
  and off, FP8 or unquantized activations) and ``packed_head_view``;
* the plain MLA latent decode attention (bf16 pages, FP8 pages, the FP4
  frozen region) against repro's oracle and its interpret-mode Pallas
  kernel, at the reference suites' shapes, within their 2e-5;
* the latent pool: leaves byte-identical after the same appends, prefill
  chunks and transcodes;
* the MiniCPM3 configs.

Logits and served streams are in ``test_torch_mla_serve.py``. ``MLA_CFG`` is a tiny MLA whose every projection is quantizable (the SMOKE
config's latent widths are below the 64 that ``is_quantizable`` needs, so
only its MLP packs), so the packed cases run the batched W4A8 path for
``wk_b`` (transposed) and ``wv_b``.
"""
import dataclasses

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import _pack_batched, quantize_tree
from repro.kernels import ref as jref
from repro.kernels.decode_attn import paged_mla_decode_attn_pallas
from repro.kernels.w4a8_fused import w4a8_fused_batched_pallas
from repro.models import layers as jlayers
from repro.models.config import ArchConfig, MLASpec
from repro.models.params import ParamDef as JParamDef
from repro.runtime import kv_cache as jkvc
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models.bridge import from_numpy
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import POLICY, flatten_jax, port_cfg, t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

ATTN_TOL = 2e-5  # the kernel == oracle tolerance of tests/test_kv_cache.py

MLA_CFG = ArchConfig(
    name="mla-tiny", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=96, attn_kind="mla", norm_kind="rmsnorm", act_kind="silu",
    mlp_gated=True, attn_chunk=64,
    mla=MLASpec(q_lora_rank=64, kv_lora_rank=64, qk_nope_dim=16, qk_rope_dim=16,
                v_head_dim=16))


@functools.lru_cache(maxsize=None)
def _model(jcfg, packed, key=0):
    """Random weights from ``key`` (packed by repro's ``quantize_tree``),
    in both packages; cached."""
    return bridge(jcfg, jmodels.init_params(jcfg, jax.random.PRNGKey(key)), packed)


def bridge(jcfg, params, packed):
    """(jcfg, params, port cfg, port params) of a repro params tree. The
    pack runs as one compiled program: ~3 s for MLA_CFG against ~29 s of
    eager ops, the same codes and scales (only the LoRC factors' last bits
    differ: the SVD's)."""
    if packed:
        defs = jmodels.build_def(jcfg)
        params = jax.jit(lambda p: quantize_tree(p, defs, POLICY))(params)
    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(params), tcfg, "cpu",
                         policy=TPolicy(**vars(POLICY)) if packed else None)
    return jcfg, params, tcfg, tparams


# -- layers ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    """Split halves, theta 10000: f32 within 1e-6 (cos/sin/pow may differ
    by an ulp between XLA's CPU and torch), bf16 identical but for the
    rare element that such an ulp tips over a rounding boundary."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 7, 3, 32)).astype(np.float32)).astype(dtype)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(x, jnp.asarray(pos), 10000.0)).astype(np.float32)
    got = to_np(tlayers.apply_rope(t(np.asarray(x)), t(pos), 10000.0))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        assert np.mean(got != want) < 1e-2
        np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("a_fmt", [None, "fp8_e4m3"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("scale_mode,lorc_rank", [("none", 0), ("m2", 8)])
def test_batched_plain_matches_reference(scale_mode, lorc_rank, transpose, a_fmt):
    """The shapes of tests/test_w4a8_fused.py::test_batched_fused_matches_oracle:
    the port's plain version within 1e-4 of repro's oracle (the same bf16
    products, another f32 summation order) and, for the unquantized
    activations the MLA path runs, within that suite's 2e-2 of the
    interpret-mode Pallas kernel (which folds the scales otherwise)."""
    e, n, k, m, group = 4, 128, 256, 24, 128
    rng = np.random.default_rng(e * n + lorc_rank)
    w = jnp.asarray(rng.normal(size=(e, n, k)).astype(np.float32) * 0.05)
    pw = _pack_batched(w, JPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=group,
                                  scale_mode=scale_mode, lorc_rank=lorc_rank))
    x = jnp.asarray(rng.normal(size=(e, m, n if transpose else k)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    opt = lambda a: None if a is None else t(np.asarray(a))
    tw = tlayers.PackedLinear(codes=t(np.asarray(pw.codes)), scale=t(np.asarray(pw.scale)),
                              s_max=opt(pw.s_max), shifts=opt(pw.shifts),
                              lorc_a=opt(pw.lorc_a), lorc_b=opt(pw.lorc_b),
                              a_fmt="fp8_e4m3", group_size=group)
    y = to_np(ops.w4a8_matmul_batched(t(np.asarray(x)), tw, transpose_w=transpose,
                                      quantize_acts=a_fmt is not None))
    y_ref = np.asarray(jref.w4a8_batched_matmul_ref(
        x, pw.codes, pw.scale, pw.lorc_a, pw.lorc_b, a_fmt=a_fmt, group_size=group,
        transpose_w=transpose))
    assert y.shape == y_ref.shape == (e, m, k if transpose else n)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)
    if a_fmt is None:
        y_pal = np.asarray(w4a8_fused_batched_pallas(
            x, pw.codes, pw.scale, pw.s_max, pw.shifts, pw.lorc_a, pw.lorc_b, a_fmt=a_fmt,
            group_size=group, transpose_w=transpose, interpret=True))
        np.testing.assert_allclose(y, y_pal, rtol=2e-2, atol=2e-2)


def test_packed_head_view_round_trip():
    """tests/test_w4a8_fused.py::test_packed_head_view_roundtrip, and the
    view is a view: codes share storage, lorc_b is a stride-0 broadcast."""
    rng = np.random.default_rng(11)
    w = jnp.asarray(rng.normal(size=(128, 64)).astype(np.float32) * 0.05)
    jp = quantize_tree({"w": w}, {"w": JParamDef((128, 64), ("heads", "lora"))},
                       JPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=64,
                               scale_mode="m2", lorc_rank=4))["w"]
    tp = tlayers.PackedLinear(**{f: t(np.asarray(getattr(jp, f)))
                                 for f in tlayers.PackedLinear._FIELDS})
    jv, tv = jlayers.packed_head_view(jp, 4), tlayers.packed_head_view(tp, 4)
    assert tv.codes.shape == (4, 32, 32) and tv.scale.shape == (4, 32, 1)
    assert tv.lorc_a.shape == (4, 32, 4) and tv.lorc_b.shape == (4, 4, 64)
    assert tv.lorc_b.stride(0) == 0 and tv.codes.data_ptr() == tp.codes.data_ptr()
    for f in tlayers.PackedLinear._FIELDS:
        np.testing.assert_array_equal(to_np(getattr(tv, f)), np.asarray(getattr(jv, f)).astype(
            np.float32 if getattr(tv, f).dtype == torch.bfloat16 else np.asarray(getattr(jv, f)).dtype),
            err_msg=f)


# -- latent decode attention --------------------------------------------------------
def _latent_pool(rng, b, r, dr, page, pp, lens, fmt, frozen):
    """A one-layer latent pool written by prefill chunks; with ``frozen``
    all but the last of each row's pages transcoded into the FP4 region
    (tests/test_fp4_cache.py:268). Built by the port's pool functions,
    which ``test_mla_pool_leaves_byte_identical`` holds byte-identical to
    repro's. Returns ({name: ndarray}, page table)."""
    kw = dict(frozen_fmt="fp4_e2m1", n_frozen=b * pp) if frozen else {}
    pool = tkvc.init_mla_pool(1, b * pp, page, r, dr, fmt, **kw, device="cpu")
    layer = {k: v[0] for k, v in pool.items()}
    pt = np.full((b, pp), b * pp, np.int32)
    base, fidx = b * pp + 1, 0
    for row in range(b):
        npg = tkvc.pages_needed(int(lens[row]), page)
        ids = np.arange(row * pp, row * pp + npg, dtype=np.int32)
        pt[row, :npg] = ids
        vals = {"ckv": rng.normal(size=(1, npg * page, r)).astype(np.float32),
                "krope": rng.normal(size=(1, npg * page, dr)).astype(np.float32)}
        tkvc.append_prefill_chunk(layer, {k: t(v) for k, v in vals.items()},
                                  tkvc.PagedState(t(pt[row:row + 1, :npg]),
                                                  t(np.array([0], np.int32)),
                                                  t(np.array([lens[row]], np.int32))))
        if frozen:
            for i in range(min(pp - 1, npg)):
                tkvc.transcode_page(pool, int(ids[i]), fidx)
                pt[row, i] = base + fidx
                fidx += 1
    return {k: np.asarray(to_np(v[0])) if v.dtype != torch.bfloat16 else
            np.asarray(v[0].view(torch.uint16).numpy()).view(ml_dtypes.bfloat16)
            for k, v in pool.items()}, pt


@pytest.mark.parametrize("pages", ["bf16", "fp8", "fp8+fp4frozen"])
@pytest.mark.parametrize("h,r,dr,page,pp", [
    (4, 16, 8, 8, 3), (8, 32, 16, 16, 2), (3, 16, 8, 4, 4), (16, 64, 32, 8, 2)])
def test_mla_decode_plain_matches_reference(h, r, dr, page, pp, pages):
    """The shapes of tests/test_kv_cache.py:289 and test_fp4_cache.py:268:
    the port's plain version against repro's oracle and its interpret-mode
    Pallas kernel, within their 2e-5."""
    rng = np.random.default_rng(hash((h, r, dr, page)) % 2**31)
    b, fmt, frozen = 2, None if pages == "bf16" else "fp8_e4m3", pages.endswith("frozen")
    lens = np.array([page * pp - 3, max(1, page // 2)], np.int32)
    layer, pt = _latent_pool(rng, b, r, dr, page, pp, lens, fmt, frozen)
    ql = rng.normal(size=(b, h, r)).astype(np.float32)
    qr = rng.normal(size=(b, h, dr)).astype(np.float32)
    scale = 1.0 / float(r + dr) ** 0.5
    got = to_np(ops.paged_mla_decode_attn(t(ql), t(qr), {k: t(v) for k, v in layer.items()},
                                          t(pt), t(lens), scale))
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    sc = ((jl["ckv_smax"], jl["ckv_shift"], jl["krope_smax"], jl["krope_shift"]) if fmt
          else (jnp.zeros((1,)), jnp.zeros((1, 1), jnp.int32)) * 2)
    fz = {k + s: jl.get(k + s) for k in ("ckv", "krope") for s in ("_fz", "_fz_smax", "_fz_shift")}
    args = (jnp.asarray(ql), jnp.asarray(qr), jl["ckv"], jl["krope"], *sc, jnp.asarray(pt),
            jnp.asarray(lens))
    kw = dict(fmt=fmt, frozen="fp4_e2m1" if frozen else None)
    oracle = jax.jit(functools.partial(jref.paged_mla_decode_attn_ref, scale=scale, **kw))
    want = np.asarray(oracle(*args, **fz))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    if frozen and h != 16:  # the TPU kernel's dataflow, in interpret mode
        pal = np.asarray(paged_mla_decode_attn_pallas(*args, scale, **kw, **fz, bq=8,
                                                      interpret=True))
        np.testing.assert_allclose(got, pal, rtol=ATTN_TOL, atol=ATTN_TOL)


# -- the latent pool ---------------------------------------------------------------
def _assert_pools_equal(tpool, jpool):
    assert set(tpool) == set(jpool)
    for name, jleaf in jpool.items():
        a, b = to_np(tpool[name]), np.asarray(jleaf)
        b = b.astype(np.float32) if tpool[name].dtype == torch.bfloat16 else b
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), np.ascontiguousarray(b).view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("pages", ["bf16", "fp8", "fp8+fp4frozen"])
def test_mla_pool_leaves_byte_identical(pages):
    """The same prefill chunks (one bucketed), decode appends (an idle row
    on the null page) and transcodes give byte-identical latent pools, the
    same gathers, page bytes and bytes per token."""
    fmt, frozen = None if pages == "bf16" else "fp8_e4m3", pages.endswith("frozen")
    rng = np.random.default_rng(5)
    r, dr, page, n_pages = 16, 8, 8, 8
    kw = dict(frozen_fmt="fp4_e2m1", n_frozen=3) if frozen else {}
    jpool = jkvc.init_mla_pool(2, n_pages, page, r, dr, fmt, **kw)
    tpool = tkvc.init_mla_pool(2, n_pages, page, r, dr, fmt, **kw, device="cpu")
    _assert_pools_equal(tpool, jpool)
    lat = lambda b, s: {"ckv": rng.normal(size=(b, s, r)).astype(np.float32) * 3,
                        "krope": rng.normal(size=(b, s, dr)).astype(np.float32)}
    null = n_pages

    def both(fn_t, fn_j, vals, pt, lengths, chunk_len=None):
        nonlocal jpool
        cl = None if chunk_len is None else np.array([chunk_len], np.int32)
        sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray(lengths),
                             None if cl is None else jnp.asarray(cl))
        st = tkvc.PagedState(t(pt), t(lengths), None if cl is None else t(cl))
        for i in range(2):
            layer = {k: v[i] for k, v in jpool.items()}
            layer = jax.jit(fn_j)(layer, {k: jnp.asarray(v) for k, v in vals.items()}, sj)
            jpool = {k: jpool[k].at[i].set(layer[k]) for k in jpool}
            fn_t({k: v[i] for k, v in tpool.items()}, {k: t(v) for k, v in vals.items()}, st)

    both(tkvc.append_prefill_chunk, jkvc.append_prefill_chunk, lat(1, 16),
         np.array([[0, 1]], np.int32), np.array([0], np.int32), 13)
    both(tkvc.append_prefill_chunk, jkvc.append_prefill_chunk, lat(1, 16),
         np.array([[2, 3]], np.int32), np.array([0], np.int32))
    pt = np.array([[0, 1, null], [null] * 3, [2, 3, 4]], np.int32)
    for lengths in (np.array([13, 0, 16], np.int32), np.array([14, 0, 17], np.int32)):
        both(tkvc.append_paged, jkvc.append_paged, lat(3, 1), pt, lengths)
    if frozen:
        for src, fidx in ((0, 0), (2, 1), (3, 2)):
            jpool = jkvc.transcode_page(jpool, src, fidx)
            tkvc.transcode_page(tpool, src, fidx)
    _assert_pools_equal(tpool, jpool)
    pt = np.array([[0, 1, null], [2 if not frozen else null + 2, 3, 4]], np.int32)
    sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray(np.array([14, 18], np.int32)))
    st = tkvc.PagedState(t(pt), t(np.array([14, 18], np.int32)))
    layer_j, layer_t = ({k: v[1] for k, v in p.items()} for p in (jpool, tpool))
    for name in ("ckv", "krope"):
        np.testing.assert_array_equal(to_np(tkvc.gather_pages(layer_t, name, st)),
                                      np.asarray(jkvc.gather_pages(layer_j, name, sj)))
    assert tkvc.n_frozen_pages(tpool) == jkvc.n_frozen_pages(jpool)
    assert tkvc.n_frozen_pages(layer_t) == jkvc.n_frozen_pages(layer_j)
    assert tkvc.pool_bytes_per_token(tpool) == jkvc.pool_bytes_per_token(jpool)
    for fz in (False, True):
        assert tkvc.page_bytes(tpool, frozen=fz) == jkvc.page_bytes(jpool, frozen=fz)


def test_smoke_config_copies_reference():
    from repro.configs import get_config, get_smoke
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs import get_smoke as tget_smoke

    for name in ("minicpm3-4b", "opt-125m", "deepseek-v3-671b"):
        assert dataclasses.asdict(tget_config(name)) == dataclasses.asdict(get_config(name))
        assert dataclasses.asdict(tget_smoke(name)) == dataclasses.asdict(get_smoke(name))
