"""Mixed-precision KV pages in the port against repro: the FP4 frozen region,
the freeze-time transcode, the two-region gather, the prefix index, the
frozen plain decode attention, and the guards that keep every write off
frozen pages.

Pool leaves, transcoded codes and scales, gathers and the prefix index
must be identical to repro's (bit for bit where they are data); the
frozen decode attention holds the tolerance of ``tests/test_kv_cache.py``
(1e-5) against repro's oracle and its interpret-mode Pallas kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.common import PAGE_FORMAT_NAMES
from repro.kernels.decode_attn import paged_decode_attn_pallas
from repro.runtime import kv_cache as jkvc
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

MIXED = dict(fmt="fp8_e4m3", frozen_fmt="fp4_e2m1")
# repro's gathers and oracle, jitted: one compile instead of one per op
_jgather = jax.jit(jkvc.gather_pages, static_argnums=1)
_jattn = jax.jit(jref.paged_decode_attn_ref, static_argnames=("fmt", "frozen", "window"))


def _mixed_pools(rng, n_layers, n_pages, page, kv, hd, n_frozen, transcode, both=True):
    """The same FP8 pool in both packages (random codes written through
    repro), then ``transcode`` = [(src page, frozen row), ...] applied by
    each package to its own copy; with ``both=False`` only the port
    transcodes and repro gets a copy of the result."""
    jpool = jkvc.init_gqa_pool(n_layers, n_pages, page, kv, hd, **MIXED, n_frozen=n_frozen)
    for n in ("k", "v"):
        vals = (rng.normal(size=(n_layers, n_pages + 1, page, kv, hd))
                * rng.uniform(0.01, 10, size=(n_layers, n_pages + 1, 1, kv, 1))).astype(np.float32)
        codes, smax, shift = jkvc.quantize_pages(jnp.asarray(vals))
        jpool = {**jpool, n: codes, n + "_smax": smax, n + "_shift": shift}
    tpool = {k: t(np.asarray(v)) for k, v in jpool.items()}
    for src, fidx in transcode:
        # eager, as repro's Server calls it (a jax.jit of it, page ids
        # traced, writes other codes on odd head dims from its second call)
        if both:
            jpool = jkvc.transcode_page(jpool, src, fidx)
        tkvc.transcode_page(tpool, src, fidx)
    if not both:
        jpool = {k: jnp.asarray(to_np(v)) for k, v in tpool.items()}
    return tpool, jpool


def _assert_same_leaves(tpool, jpool):
    assert set(tpool) == set(jpool)
    for name, leaf in jpool.items():
        a, b = to_np(tpool[name]), np.asarray(leaf)
        if tpool[name].dtype == torch.bfloat16:
            b = b.astype(np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("hd", [16, 9])
@pytest.mark.parametrize("fmt,frozen_fmt,n_frozen", [
    ("fp8_e4m3", "fp4_e2m1", 3), ("fp8_e4m3", None, 0), (None, None, 0), ("fp4_e2m1", None, 0)])
def test_init_gqa_pool_leaves_match(hd, fmt, frozen_fmt, n_frozen):
    """Leaf names, shapes and dtypes (the frozen region half-width, with
    n_frozen + 1 rows; the packed store's zero-size marker)."""
    tpool = tkvc.init_gqa_pool(2, 5, 8, 3, hd, fmt, frozen_fmt=frozen_fmt, n_frozen=n_frozen,
                               device="cpu")
    jpool = jkvc.init_gqa_pool(2, 5, 8, 3, hd, fmt, frozen_fmt=frozen_fmt, n_frozen=n_frozen)
    _assert_same_leaves(tpool, jpool)
    assert tkvc.n_frozen_pages(tpool) == jkvc.n_frozen_pages(jpool) == n_frozen
    layer = {k: v[0] for k, v in tpool.items()}
    assert tkvc.n_frozen_pages(layer) == n_frozen
    assert tkvc.pool_format(layer).name == jkvc.pool_format(
        {k: v[0] for k, v in jpool.items()}).name == fmt
    assert (tkvc.frozen_format(tpool) is None) == (jkvc.frozen_format(jpool) is None)


@pytest.mark.parametrize("hd", [16, 9])
def test_transcode_page_bit_identical(hd):
    """Codes, ``*_fz_smax`` and ``*_fz_shift`` of every layer, an odd head
    dim padding one zero nibble; the FP8 source pages are untouched."""
    rng = np.random.default_rng(hd)
    tpool, jpool = _mixed_pools(rng, 2, 6, 8, 2, hd, 4, [(0, 0), (3, 2), (3, 1)])
    _assert_same_leaves(tpool, jpool)
    assert tpool["k_fz"].shape[-1] == (hd + 1) // 2


@pytest.mark.parametrize("hd", [16, 9])
def test_gather_pages_two_regions_bit_identical(hd):
    """Tables mixing frozen ids, active ids, the null page and an id past
    the frozen region (clamped onto the dummy row, as in repro), over the
    same pool bytes."""
    rng = np.random.default_rng(10 + hd)
    tpool, jpool = _mixed_pools(rng, 1, 6, 8, 2, hd, 3, [(0, 0), (2, 1), (4, 2)], both=False)
    base = 7
    pt = np.array([[base, base + 1, 3], [5, base + 2, 6], [base + 5, 1, 0]], np.int32)
    st = tkvc.PagedState(t(pt), t(np.array([20, 17, 9], np.int32)))
    sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray([20, 17, 9]))
    tl = {k: v[0] for k, v in tpool.items()}
    jl = {k: v[0] for k, v in jpool.items()}
    for name in ("k", "v"):
        np.testing.assert_array_equal(to_np(tkvc.gather_pages(tl, name, st)),
                                      np.asarray(_jgather(jl, name, sj)))
    hist_t, n_t = tkvc.gather_history(tl, st, 8)
    assert n_t == 3 * 8 and set(hist_t) == {"k", "v"}
    np.testing.assert_array_equal(to_np(hist_t["v"]), np.asarray(_jgather(jl, "v", sj)))


def test_page_bytes_and_residency_accounting():
    tpool = tkvc.init_gqa_pool(4, 32, 8, 2, 64, **MIXED, n_frozen=16, device="cpu")
    jpool = jkvc.init_gqa_pool(4, 32, 8, 2, 64, **MIXED, n_frozen=16)
    for frozen in (False, True):
        assert tkvc.page_bytes(tpool, frozen=frozen) == jkvc.page_bytes(jpool, frozen=frozen)
    assert tkvc.page_bytes(tpool, frozen=True) / tkvc.page_bytes(tpool) <= 0.55
    plain = tkvc.init_gqa_pool(4, 32, 8, 2, 64, "fp8_e4m3", device="cpu")
    assert tkvc.pool_bytes_per_token(tpool) == tkvc.pool_bytes_per_token(plain) == \
        jkvc.pool_bytes_per_token(jpool)
    assert tkvc.page_bytes(plain, frozen=True) == 0.0


def test_prefix_cache_random_sequence_identical():
    """One seeded random sequence of insert, walk, park, unpark, reclaim and
    assert_unfrozen calls: identical returns and raises in both packages."""
    rng = np.random.default_rng(0)
    page = 4
    caches = (tkvc.PrefixCache(page), jkvc.PrefixCache(page))
    prefixes = [rng.integers(0, 3, size=4 * page).tolist() for _ in range(3)]
    next_pid = 0
    for _ in range(400):
        op = rng.choice(["insert", "walk", "park", "unpark", "reclaim", "assert"])
        toks = prefixes[rng.integers(3)][:page * int(rng.integers(1, 5))] + \
            rng.integers(0, 3, size=int(rng.integers(0, 6))).tolist()
        if op == "insert":
            n = int(rng.integers(1, len(toks) // page + 1))
            pids = list(range(next_pid, next_pid + n))
            if rng.random() < 0.2:  # a pid registered before: repro raises
                pids[0] = int(rng.integers(0, next_pid + 1))
            next_pid += n
            calls = [lambda c: c.insert(toks, pids)] * 2
        elif op == "walk":
            mp = None if rng.random() < 0.5 else int(rng.integers(0, 4))
            calls = [lambda c: c.walk(toks, max_pages=mp)] * 2
        elif op in ("park", "unpark"):
            pid = int(rng.integers(0, next_pid + 1))
            calls = [lambda c: getattr(c, op)(pid)] * 2
        elif op == "reclaim":
            calls = [lambda c: c.reclaim()] * 2
        else:
            ids = rng.integers(0, next_pid + 3, size=3).tolist()
            base = None if rng.random() < 0.5 else int(rng.integers(1, next_pid + 3))
            calls = [lambda c: c.assert_unfrozen(ids, frozen_base=base)] * 2
        got = []
        for c, call in zip(caches, calls):
            try:
                got.append(("ok", call(c)))
            except AssertionError as e:
                got.append(("raise", str(e)))
        assert got[0] == got[1], (op, got)
        tc, jc = caches
        assert (len(tc), tc.n_reusable, tc.reusable_ids(), tc.reclaims) == \
            (len(jc), jc.n_reusable, jc.reusable_ids(), jc.reclaims)


# the four shapes of tests/test_fp4_cache.py::TestFP4DecodeParity
SHAPES = [(2, 2, 16, 8, 3), (1, 4, 32, 16, 2), (4, 1, 8, 4, 4), (2, 3, 64, 32, 2)]


def _frozen_layer(rng, kv, hd, page, pp, lens, freeze):
    """A 1-layer mixed pool as ``tests/test_fp4_cache.py`` builds it: FP8
    pages, the first ``freeze`` pages of each row transcoded into the
    frozen region and the table rewritten to frozen ids. Built by the port
    (its transcode is held bit-identical to repro's above) and handed to
    repro as arrays."""
    b, n_pages = len(lens), len(lens) * pp
    pool = tkvc.init_gqa_pool(1, n_pages, page, kv, hd, **MIXED, n_frozen=n_pages, device="cpu")
    for n in ("k", "v"):
        vals = torch.from_numpy(rng.normal(size=(1, n_pages + 1, page, kv, hd)).astype(np.float32))
        pool[n], pool[n + "_smax"], pool[n + "_shift"] = tkvc.quantize_pages(vals)
    pt = np.zeros((b, pp), np.int32)
    fidx = 0
    for r in range(b):
        npg = tkvc.pages_needed(int(lens[r]), page)
        pt[r, :npg] = np.arange(r * pp, r * pp + npg)
        for i in range(min(freeze, npg)):
            tkvc.transcode_page(pool, int(pt[r, i]), fidx)
            pt[r, i] = n_pages + 1 + fidx
            fidx += 1
    return {k: jnp.asarray(to_np(v[0])) for k, v in pool.items()}, pt


@pytest.mark.parametrize("kv,g,hd,page,pp", SHAPES)
def test_frozen_oracle_matches_reference(kv, g, hd, page, pp):
    rng = np.random.default_rng(kv * 100 + g * 10 + hd)
    lens = np.array([page * pp - 3, max(1, page // 2)], np.int32)
    jl, pt = _frozen_layer(rng, kv, hd, page, pp, lens, freeze=pp - 1)
    assert (pt >= 2 * pp + 1).any()  # frozen ids in play
    q = rng.normal(size=(2, kv * g, hd)).astype(np.float32)
    fz = {n + s: jl[n + s] for n in ("k", "v") for s in ("_fz", "_fz_smax", "_fz_shift")}
    args = (jl["k"], jl["v"], jl["k_smax"], jl["k_shift"], jl["v_smax"], jl["v_shift"],
            jnp.asarray(pt), jnp.asarray(lens))
    o_ref = np.asarray(_jattn(jnp.asarray(q), *args, fmt="fp8_e4m3",
                                                  frozen="fp4_e2m1", **fz))
    tl = {k: t(np.asarray(v)) for k, v in jl.items()}
    o = to_np(ops.paged_decode_attn(t(q), tl, t(pt), t(lens)))
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-5)
    if (kv, g, hd, page, pp) == SHAPES[0]:
        o_pal = np.asarray(paged_decode_attn_pallas(
            jnp.asarray(q), *args, fmt="fp8_e4m3", frozen="fp4_e2m1", interpret=True, **fz))
        np.testing.assert_allclose(o, o_pal, rtol=1e-5, atol=1e-5)


def test_frozen_oracle_clamps_and_windows_like_reference():
    """Ids past the frozen region read its dummy row, and a sliding window
    masks as in repro: the plain version keeps the reference's clamps."""
    rng = np.random.default_rng(5)
    jl, pt = _frozen_layer(rng, 2, 16, 8, 3, np.array([21, 9], np.int32), freeze=2)
    pt[1, 2] = 40  # far past the region: clamps onto the dummy row
    lens = np.array([21, 24], np.int32)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    fz = {n + s: jl[n + s] for n in ("k", "v") for s in ("_fz", "_fz_smax", "_fz_shift")}
    o_ref = np.asarray(_jattn(
        jnp.asarray(q), jl["k"], jl["v"], jl["k_smax"], jl["k_shift"], jl["v_smax"],
        jl["v_shift"], jnp.asarray(pt), jnp.asarray(lens), fmt="fp8_e4m3", window=11,
        frozen="fp4_e2m1", **fz))
    tl = {k: t(np.asarray(v)) for k, v in jl.items()}
    o = to_np(tref.paged_decode_attn_ref(
        t(q), tl["k"], tl["v"], tl["k_smax"], tl["k_shift"], tl["v_smax"], tl["v_shift"],
        t(pt), t(lens), fmt="fp8_e4m3", window=11, frozen="fp4_e2m1",
        **{k: tl[k] for k in fz}))
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-5)


# -- guards -------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs,err,match", [
    (dict(active_fmt="fp4_e2m1"), ValueError, "writable"),
    (dict(active_fmt=None, frozen_fmt="fp8_e4m3"), ValueError, "transcode"),
    (dict(cross_fmt="fp4_e2m1"), ValueError, "cross_fmt"),
    (dict(active_fmt="fp8_e4m3", frozen_fmt="fp3_e1m1"), ValueError, PAGE_FORMAT_NAMES[0]),
    (dict(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1", frozen_pages=0), ValueError,
     "frozen_pages"),
])
def test_cache_policy_validation_mirrors_reference(kwargs, err, match):
    for mod in (tkvc, jkvc):
        with pytest.raises(err, match=match):
            mod.CachePolicy(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(active_fmt="fp8_e4m3"), dict(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1"),
    dict(active_fmt="fp8_e4m3", frozen_fmt="fp8_e4m3")])
def test_cache_policy_classes_mirror_reference(kwargs):
    tp, jp = tkvc.CachePolicy(**kwargs), jkvc.CachePolicy(**kwargs)
    assert tp.mixed == jp.mixed
    for cls in ("active", "frozen", "cross"):
        assert getattr(tp, cls).name == getattr(jp, cls).name


def test_append_into_packed_store_raises():
    pool = tkvc.init_gqa_pool(1, 4, 8, 2, 16, "fp4_e2m1", device="cpu")
    layer = {k: v[0] for k, v in pool.items()}
    state = tkvc.PagedState(t(np.array([[0, 1]], np.int32)), t(np.array([3], np.int32)))
    new = {"k": torch.ones((1, 1, 2, 16)), "v": torch.ones((1, 1, 2, 16))}
    with pytest.raises(AssertionError, match="packed FP4"):
        tkvc.append_paged(layer, new, state)
    with pytest.raises(ValueError, match="fp4_e2m1"):
        tkvc.init_gqa_pool(1, 4, 8, 2, 16, None, frozen_fmt="fp4_e2m1", n_frozen=2,
                            device="cpu")
    with pytest.raises(ValueError, match="n_frozen"):
        tkvc.init_gqa_pool(1, 4, 8, 2, 16, **MIXED, n_frozen=0, device="cpu")


def test_assert_unfrozen_rejects_frozen_region_ids():
    c = tkvc.PrefixCache(page_size=8)
    c.insert([1] * 8, [3])
    c.assert_unfrozen([0, 1, 2])
    with pytest.raises(AssertionError, match="shared-frozen"):
        c.assert_unfrozen([3])
    with pytest.raises(AssertionError, match="frozen FP4"):
        c.assert_unfrozen([17], frozen_base=17)
    c.assert_unfrozen([16], frozen_base=17)


def test_frozen_cuda_wrapper_checks_before_launch():
    """The frozen variant's wrapper refuses CPU tensors and frozen operands
    without the frozen format, before any build or launch."""
    rng = np.random.default_rng(6)
    jl, pt = _frozen_layer(rng, 2, 16, 8, 3, np.array([21, 9], np.int32), freeze=2)
    tl = {k: t(np.asarray(v)) for k, v in jl.items()}
    fz = {n + s: tl[n + s] for n in ("k", "v") for s in ("_fz", "_fz_smax", "_fz_shift")}
    args = (torch.zeros((2, 4, 16), dtype=torch.bfloat16), tl["k"], tl["v"], tl["k_smax"],
            tl["k_shift"], tl["v_smax"], tl["v_shift"], t(pt), t(np.array([21, 9], np.int32)))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attn_cuda(*args, fmt="fp8_e4m3", frozen="fp4_e2m1", **fz)
    with pytest.raises(ValueError, match="without frozen"):
        paged_decode_attn_cuda(*args, fmt="fp8_e4m3", **fz)
    with pytest.raises(NotImplementedError, match="behind"):
        paged_decode_attn_cuda(*args, fmt=None, frozen="fp4_e2m1", **fz)
