"""The port's paged KV pool against repro's: after the same sequence of
streaming-prefill chunks and decode appends — bucketed chunks with pad
tails, an idle row redirected to the null page, a page boundary crossing
into a recycled page that holds a previous owner's non-finite bytes — every
pool leaf (codes, bf16 values, s_max, shifts) is byte-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import kv_cache as jkvc
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import t, to_np

PAGE, KV, HD, N_PAGES = 8, 2, 16, 6


def _both(fn_t, fn_j, pool_t, pool_j, vals, pt, lengths, chunk_len=None):
    st = tkvc.PagedState(t(pt), t(lengths), None if chunk_len is None else t(chunk_len))
    sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray(lengths),
                         None if chunk_len is None else jnp.asarray(chunk_len))
    fn_t(pool_t, {k: t(v) for k, v in vals.items()}, st)
    return fn_j(pool_j, {k: jnp.asarray(v) for k, v in vals.items()}, sj)


def _kv(rng, *shape):
    return {n: (rng.normal(size=shape) * 3).astype(np.float32) for n in ("k", "v")}


@pytest.mark.parametrize("fmt", ["fp8_e4m3", None])
def test_pool_leaves_byte_identical(fmt):
    rng = np.random.default_rng(0)
    pool_t = {k: v[0] for k, v in tkvc.init_gqa_pool(1, N_PAGES, PAGE, KV, HD, fmt).items()}
    pool_j = {k: v[0] for k, v in jkvc.init_gqa_pool(1, N_PAGES, PAGE, KV, HD, fmt).items()}
    null = N_PAGES
    # a previous owner left non-finite bytes in page 3 (what a failed
    # prefill writes): NaN values for bf16 pages, a NaN s_max for FP8
    if fmt:
        pool_t["k_smax"][3] = float("nan")
        pool_j["k_smax"] = pool_j["k_smax"].at[3].set(jnp.nan)
    else:
        pool_t["k"][3] = float("nan")
        pool_j["k"] = pool_j["k"].at[3].set(jnp.nan)

    # row A: an 11-token chunk bucketed to 16 (pad tail zeroed) into pages 0, 1
    pool_j = _both(tkvc.append_prefill_chunk, jkvc.append_prefill_chunk, pool_t, pool_j,
                   _kv(rng, 1, 16, KV, HD), np.array([[0, 1]], np.int32),
                   np.array([0], np.int32), np.array([11], np.int32))
    # row B: 16 tokens into pages 4, 5, then a 5-token chunk bucketed to 8
    # at start 16 into page 2, with a null-padded table of width 4
    pool_j = _both(tkvc.append_prefill_chunk, jkvc.append_prefill_chunk, pool_t, pool_j,
                   _kv(rng, 1, 16, KV, HD), np.array([[4, 5]], np.int32),
                   np.array([0], np.int32), np.array([16], np.int32))
    pool_j = _both(tkvc.append_prefill_chunk, jkvc.append_prefill_chunk, pool_t, pool_j,
                   _kv(rng, 1, 8, KV, HD), np.array([[4, 5, 2, null]], np.int32),
                   np.array([16], np.int32), np.array([5], np.int32))
    # decode: row A appends at 11 (page 1, offset 3); an idle row hits the
    # null page; row C crosses a boundary into the recycled page 3
    pt = np.array([[0, 1, null], [null] * 3, [4, 5, 3]], np.int32)
    for lengths in (np.array([11, 0, 16], np.int32), np.array([12, 0, 17], np.int32)):
        pool_j = _both(tkvc.append_paged, jkvc.append_paged, pool_t, pool_j,
                       _kv(rng, 3, 1, KV, HD), pt, lengths)

    assert set(pool_t) == set(pool_j)
    for name in pool_j:
        a, b = to_np(pool_t[name]), np.asarray(pool_j[name])
        if pool_t[name].dtype == torch.bfloat16:
            b = b.astype(np.float32)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), np.ascontiguousarray(b).view(np.uint8),
                                      err_msg=name)
    assert bool(torch.isfinite(to_torch_f32(pool_t, 3, fmt)).all())


def to_torch_f32(pool, pid, fmt):
    if fmt:
        return tkvc.dequantize_pages(pool["k"][pid], pool["k_smax"][pid], pool["k_shift"][pid])
    return pool["k"][pid, :2].float()  # positions 0, 1 were rewritten by the appends


def test_quantize_pages_bit_exact_and_round_trip():
    rng = np.random.default_rng(1)
    vals = (rng.normal(size=(3, PAGE, KV, HD)) * rng.uniform(1e-3, 1e3, size=(3, 1, KV, 1))
            ).astype(np.float32)
    vals[1, :, 1] = 0.0  # an all-zero head: its scale floors at 1e-12
    ct, st, sht = tkvc.quantize_pages(t(vals))
    cj, sj, shj = jkvc.quantize_pages(jnp.asarray(vals))
    for a, b in ((ct, cj), (st, sj), (sht, shj)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    back = to_np(tkvc.dequantize_pages(ct, st, sht))
    np.testing.assert_array_equal(back, np.asarray(jkvc.dequantize_pages(cj, sj, shj)))
    np.testing.assert_allclose(back, vals, rtol=0.07, atol=1e-30 + 0.07 * np.abs(vals).max())


def test_gather_and_pages_needed():
    rng = np.random.default_rng(2)
    pool = {k: v[0] for k, v in jkvc.init_gqa_pool(1, N_PAGES, PAGE, KV, HD, "fp8_e4m3").items()}
    pool = jkvc.append_prefill_chunk(pool, {k: jnp.asarray(v) for k, v in
                                            _kv(rng, 1, 16, KV, HD).items()},
                                     jkvc.PagedState(jnp.asarray([[2, 4]]), jnp.asarray([0])))
    tp = {k: t(np.asarray(v)) for k, v in pool.items()}
    pt = np.array([[2, 4, N_PAGES]], np.int32)
    st = tkvc.PagedState(t(pt), t(np.array([16], np.int32)))
    sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray([16]))
    np.testing.assert_array_equal(to_np(tkvc.gather_pages(tp, "v", st)),
                                  np.asarray(jkvc.gather_pages(pool, "v", sj)))
    hist_t, n_t = tkvc.gather_history(tp, st, 8)
    hist_j, n_j = jkvc.gather_history(pool, sj, 8)
    assert n_t == n_j == 3 * PAGE
    np.testing.assert_array_equal(to_np(hist_t["k"]), np.asarray(hist_j["k"]))
    assert tkvc.gather_history(tp, st, 24) == ({}, 0)
    for n in (0, 1, 8, 9, 64):
        assert tkvc.pages_needed(n, PAGE) == jkvc.pages_needed(n, PAGE)
    with pytest.raises(ValueError):
        tkvc.CachePolicy(active_fmt="fp4_e2m1")
