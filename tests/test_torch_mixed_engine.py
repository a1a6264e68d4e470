"""The reference Server's default path in the port: the mixed prefill+decode
engine, the prefix cache, and FP8 pages with a packed-FP4 frozen region.

A random-init tiny LM (varied greedy streams), packed to W4A8 by repro's
``quantize_tree`` and bridged, is served by both packages on the same
shared-prefix workload. The reference runs its ``ref`` kernels with its
step compiled under strict bf16 rounding (``StrictReference``, see
``test_torch_serve.py``). Everything the engines decide must agree: the
prefix and prefill counters, the chunk shapes, and the final refcounts and
free lists. The token streams agree up to ties: ``compare_streams``
accepts a stream's first divergence only where the reference's own top-2
logit gap is below ``GAP_TOL``, and compares nothing of that stream after
it.

This module also holds the stream comparison the MLA suite
(``test_torch_mla.py``) uses.
"""
import dataclasses
import functools
import gc
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as jmodels
from repro.core.ptq import quantize_tree
from repro.runtime import sampling as jsmp
from repro.runtime import serve as jserve
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import api
from repro_torch.models.bridge import from_numpy
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import serve as tserve

from conftest import tiny_lm_cfg
from test_torch_bridge import POLICY, flatten_jax, port_cfg

STATS = ("prefix_hit_pages", "prefix_hit_tokens", "prefix_reclaims", "fp4_frozen_pages",
         "prefill_tokens", "steps")
MIXED = dict(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1", frozen_pages=4)
TAILS = (3, 6)  # prompt tails: chunks of 4 and 8 tokens after a 3-page prefix hit
_COMPILED = {}
# XLA's options for the reference's steps: bf16 rounded after every op, and
# LLVM's passes off. Without fast-math LLVM may not reorder a float
# operation, so the passes change no value (the reference's gaps were
# equal bit for bit with them on) and only take time: a third of each
# step's compile.
STRICT_OPTIONS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}

# A greedy token counts as tied when the reference's top-2 logit gap is
# below GAP_TOL times the row's largest |logit|. Both packages compute the
# same function; only the f32 summation order of a dot differs (XLA's CPU
# dot against torch's). One f32 ulp can tip a bf16 rounding and, through
# it, an FP8 one: one element moves by one E4M3 step (at most 2^-3 of it).
# That alone does not bound the logits: a tipped page code in a shared
# prefix page moves every later logit of every stream that reads it. So
# the tolerance comes from the ties these tests meet: under key 1 the
# FP8 cases diverge where the reference's gap is 1.9e-4, 4.7e-4, 7.0e-3,
# 1.61e-2 and 2.71e-2 of the largest |logit|; keys 0, 2 and 3 and the MLA
# suites meet none. 2^-4 is 2.3x the largest of them.
GAP_TOL = 2.0 ** -4
# Ties each key's served cases may meet: those measured above, no more.
MAX_TIES = {0: 0, 1: 3, 2: 0, 3: 0}


@pytest.fixture(scope="module", autouse=True)
def release_compiled():
    """The repo's ``conftest.release_compiled``, and the reference steps that
    ``StrictReference`` compiled; ``test_torch_mla_serve`` imports it."""
    yield
    _COMPILED.clear()
    jax.clear_caches()
    gc.collect()


def _step_and_gap(params, caches, tokens, cache_index, poison, samp, cfg, a_fmt):
    """``repro.runtime.serve._decode_step``, returning also each row's
    top-2 logit gap as a share of its largest |logit|."""
    logits, caches = jmodels.decode_step(params, cfg, tokens, caches, cache_index,
                                         a_fmt=a_fmt)
    logits = jnp.where(poison[:, None], jnp.float32(jnp.nan), logits)
    top2 = jax.lax.top_k(logits, 2)[0]
    gap = (top2[:, 0] - top2[:, 1]) / jnp.max(jnp.abs(logits), axis=-1)
    return (jsmp.sample_tokens(logits, *samp), jnp.all(jnp.isfinite(logits), axis=-1),
            caches, gap)


class StrictReference:
    """Installs on a reference ``Server`` its engine step compiled with
    excess precision off (see ``test_torch_serve._strict_decode``), one
    program per input shape and pool layout, shared by every reference
    server in the test process, and records the relative top-2 logit gap of the
    row behind every token the server emits: ``gaps[(rid, index)]``. Those
    are the reference's logits over the stream up to that token, so where
    the port's stream first differs, they tell a tie from a fault."""

    def __init__(self, jsrv, jcfg, a_fmt):
        self.gaps = {}
        self._last = None
        step = jax.jit(functools.partial(_step_and_gap, cfg=jcfg, a_fmt=a_fmt))

        def decode(params, pools, *args):
            leaves = jax.tree_util.tree_leaves((pools, args))
            key = (jcfg, a_fmt, str(jax.tree_util.tree_structure((pools, args))),
                   tuple((jnp.shape(a), str(jnp.result_type(a))) for a in leaves))
            if key not in _COMPILED:
                _COMPILED[key] = step.lower(params, pools, *args).compile(
                    compiler_options=STRICT_OPTIONS)
            nxt, ok, pools, gap = _COMPILED[key](params, pools, *args)
            self._last = np.asarray(gap)
            return nxt, ok, pools

        emit = jsrv._emit_token

        def emit_token(req, token):
            self.gaps[(req.rid, len(req.out))] = float(self._last[self._row(jsrv, req)])
            emit(req, token)

        jsrv._decode = decode
        jsrv._emit_token = emit_token

    def _row(self, jsrv, req) -> int:
        """The logits row of ``req``'s token in the last program: a
        one-row prefill program, a mixed step's chunk row (a fresh stream's
        first token) or its slot's decode row."""
        if len(self._last) == 1:
            return 0
        if len(self._last) == jsrv.slots + 1 and not req.out:
            return jsrv.slots
        return next(s for s, r in enumerate(jsrv.active) if r is req)


def compare_streams(got, want, gaps):
    """``got`` (the port's) and ``want`` (the reference's): {rid: (tokens,
    status)}. Token by token; a stream's first difference must sit where
    the reference's top-2 gap (``gaps`` from ``StrictReference``) is below
    ``GAP_TOL``, and nothing of that stream after it is compared. Returns
    [(rid, index, gap)] of the accepted ties."""
    assert set(got) == set(want)
    ties = []
    for rid in sorted(want):
        (toks, status), (ref, ref_status) = got[rid], want[rid]
        assert status == ref_status, (rid, status, ref_status)
        assert len(toks) == len(ref), (rid, toks, ref)
        for i, (a, b) in enumerate(zip(toks, ref)):
            if a != b:
                gap = gaps[(rid, i)]
                assert gap < GAP_TOL, (f"request {rid}: token {i} is {a}, the reference's {b} "
                                       f"leads by {gap:.3g} of the largest |logit| >= {GAP_TOL}")
                ties.append((rid, i, gap))
                break
    return ties


@functools.lru_cache(maxsize=None)
def _packed(key: int, traced: bool = False):
    """Random weights from ``key``, packed by repro's ``quantize_tree`` and
    bridged. ``traced`` packs through one compiled program, ~2 s against
    the ~14 s that compiling its ~270 eager ops takes; only the LoRC
    factors' last bits differ from the eager pack (the SVD's)."""
    jcfg = tiny_lm_cfg()
    defs = jmodels.build_def(jcfg)
    pack = lambda p: quantize_tree(p, defs, POLICY)
    packed = (jax.jit(pack) if traced else pack)(
        jmodels.init_params(jcfg, jax.random.PRNGKey(key)))
    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(packed), tcfg, "cpu", policy=TPolicy(**vars(POLICY)))
    return jcfg, packed, tcfg, tparams


@pytest.fixture(scope="module")
def tiny_packed():
    """Random weights from key 2, the key of the tests below that need only
    one model."""
    return _packed(2)


def _waves(vocab, prefixes, n_per_wave=(4, 3), max_new=6, seed=0):
    """Waves of requests: each prompt is one of ``prefixes`` plus a tail of
    its own. The second wave is submitted after the first drains."""
    rng = np.random.default_rng(seed)
    waves, rid = [], 0
    for w, n in enumerate(n_per_wave):
        wave = []
        for i in range(n):
            tail = rng.integers(1, vocab, size=TAILS[(i + w) % 2]).tolist()
            wave.append((rid, prefixes[(i + w) % len(prefixes)] + tail, max_new))
            rid += 1
        waves.append(wave)
    return waves


def _serve(mod, srv, waves):
    out = {}
    for wave in waves:
        for rid, prompt, max_new in wave:
            srv.submit(mod.Request(rid=rid, prompt=list(prompt), max_new=max_new))
        out.update({r.rid: (list(r.tokens), r.status) for r in srv.run_until_drained()})
    return out


def serve_both(model, engine, cache, waves, slots=3, max_seq=64):
    """``waves`` through the reference ``Server`` (strictly compiled, its
    ``ref`` kernels) and the port's on the CPU, with the prefix cache on.
    The streams must agree up to ties (``compare_streams``) and every
    counter, chunk shape, refcount and free list must be equal. Returns
    (the port's streams, the port's server, the accepted ties)."""
    jcfg, packed, tcfg, tparams = model
    common = dict(slots=slots, max_seq=max_seq, page_size=8, a_fmt="fp8_e4m3",
                  prefix_cache=True)
    jsrv = jserve.Server(packed, jcfg, jserve.ServerConfig(
        **common, kernel_backend="ref", cache=jserve.CachePolicy(**cache),
        scheduler=jserve.SchedulerConfig(engine=engine, prefill_chunk_pages=2)))
    strict = StrictReference(jsrv, jcfg, common["a_fmt"])
    want = _serve(jserve, jsrv, waves)
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **common, cache=tserve.CachePolicy(**cache),
        scheduler=tserve.SchedulerConfig(engine=engine, prefill_chunk_pages=2)),
        device="cpu")
    assert tsrv.engine == jsrv.engine == engine
    got = _serve(tserve, tsrv, waves)
    ties = compare_streams(got, want, strict.gaps)
    assert all(status == "ok" for _, status in got.values())
    assert {k: tsrv.stats[k] for k in STATS} == {k: jsrv.stats[k] for k in STATS}
    assert tsrv.prefill_traces == jsrv.prefill_traces
    np.testing.assert_array_equal(tsrv.page_refs, jsrv.page_refs)
    assert tsrv.free_pages == jsrv.free_pages
    assert tsrv.free_frozen == jsrv.free_frozen
    assert tsrv.reusable_pages == jsrv.reusable_pages
    assert tsrv.prefix_hit_rate() == jsrv.prefix_hit_rate()
    assert tsrv.cache_residency() == pytest.approx(jsrv.cache_residency())
    return got, tsrv, ties


@pytest.mark.parametrize("engine,cache", [
    ("mixed", dict(active_fmt=None)),
    ("mixed", dict(active_fmt="fp8_e4m3")),
    ("mixed", MIXED),
    ("alternating", MIXED),
], ids=["mixed-bf16", "mixed-fp8", "mixed-fp8-fp4frozen", "alternating-fp8-fp4frozen"])
@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_shared_prefix_streams_identical_to_jax_server(key, engine, cache):
    """Two waves over one 3-page system prompt: the first wave's first
    request registers it, its siblings adopt it at their stream start (the
    mixed engine) or at admission (alternating), the second wave hits it at
    admission after it parked. Random weights from each of four keys."""
    model = _packed(key)
    jcfg = model[0]
    prefix = np.random.default_rng(7).integers(1, jcfg.vocab_size, size=24).tolist()
    got, srv, ties = serve_both(model, engine, cache, _waves(jcfg.vocab_size, [prefix]))
    # streams vary: key 0's greedy streams nearly collapse (3 distinct
    # streams over 3 tokens), every other key's hold more than 3 tokens
    assert len({tuple(toks) for toks, _ in got.values()}) >= 3
    assert len({t for toks, _ in got.values() for t in toks}) >= (3 if key == 0 else 4)
    assert len(ties) <= MAX_TIES[key], ties
    assert srv.stats["prefix_hit_pages"] >= 3 * 5
    if cache.get("frozen_fmt"):
        assert srv.stats["fp4_frozen_pages"] >= 3
        res = srv.cache_residency()
        assert res["n_frozen_live"] >= 3
        assert res["frozen_bytes_per_token"] / res["active_bytes_per_token"] <= 0.55


def test_frozen_region_rotates_by_reclaim(tiny_packed):
    """Two system prompts of 3 pages each in three waves through a 4-page
    frozen region: registering the next wave's prompt reclaims the parked
    pages of the other."""
    jcfg = tiny_packed[0]
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(1, jcfg.vocab_size, size=24).tolist() for _ in range(2)]
    waves = [[(3 * w + i, prefixes[w % 2] + rng.integers(1, jcfg.vocab_size, n).tolist(), 5)
              for i, n in enumerate(TAILS)] for w in range(3)]
    _, srv, ties = serve_both(tiny_packed, "mixed", MIXED, waves)
    assert not ties
    assert srv.stats["prefix_reclaims"] >= 1
    assert srv.stats["fp4_frozen_pages"] >= 6


def test_homogeneous_pool_reclaims_parked_pages(tiny_packed):
    """A one-slot pool of 4 FP8 pages: the first prompt's two full pages
    park when it retires, and the next prompt, which needs all 4 pages,
    gets two of them by reclaiming the parked ones (active pages are
    reclaimed only in a homogeneous pool)."""
    jcfg = tiny_packed[0]
    rng = np.random.default_rng(13)
    waves = [[(0, rng.integers(1, jcfg.vocab_size, 17).tolist(), 4)],
             [(1, rng.integers(1, jcfg.vocab_size, 25).tolist(), 4)]]
    _, srv, ties = serve_both(tiny_packed, "mixed", dict(active_fmt="fp8_e4m3"), waves,
                              slots=1, max_seq=32)
    assert not ties
    assert srv.stats["prefix_reclaims"] == 2
    assert srv.stats["prefix_hit_pages"] == 0


def test_engines_agree_where_the_reference_order_differs():
    """Under key 1 two or three of the seven streams tie with the reference
    at one token (``compare_streams``: one attention score one f32 ulp
    apart, which FP8 quantization turns into other codes in a shared
    prefix page; ROADMAP queue 3). The port's two engines still serve
    identical streams over FP8 pages with the FP4 frozen region: the mixed
    step computes each row exactly as the alternating engine's programs."""
    _, _, tcfg, tparams = _packed(1)
    prefix = np.random.default_rng(7).integers(1, tcfg.vocab_size, size=24).tolist()
    waves = _waves(tcfg.vocab_size, [prefix])
    out = {}
    for engine in ("mixed", "alternating"):
        srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
            slots=3, max_seq=64, page_size=8, cache=tserve.CachePolicy(**MIXED),
            scheduler=tserve.SchedulerConfig(engine=engine, prefill_chunk_pages=2)),
            device="cpu")
        out[engine] = _serve(tserve, srv, waves)
        assert srv.stats["fp4_frozen_pages"] >= 3
    assert out["mixed"] == out["alternating"]
    assert len({t for toks, _ in out["mixed"].values() for t in toks}) > 3


def test_mixed_step_logits_match_reference(tiny_packed):
    """One fused step through ``api.decode_step`` against repro's, compiled
    with excess precision off as in ``test_torch_forward.py``: two decoding
    rows (one reading frozen FP4 pages), a mid-prefill row riding with
    lengths 0, and a 5-token chunk whose history holds a frozen page. All
    (slots + 1) logits rows agree to 1e-5."""
    import jax.numpy as jnp

    from repro.runtime import kv_cache as jkvc
    from test_torch_bridge import t, to_np

    jcfg, packed, tcfg, tparams = tiny_packed
    page, kv, hd, n_layers = 8, jcfg.n_kv_heads, jcfg.resolved_head_dim, jcfg.n_layers
    rng = np.random.default_rng(3)
    jpool = jkvc.init_gqa_pool(n_layers, 8, page, kv, hd, "fp8_e4m3",
                               frozen_fmt="fp4_e2m1", n_frozen=4)
    for n in ("k", "v"):
        vals = rng.normal(size=(n_layers, 9, page, kv, hd)).astype(np.float32)
        codes, smax, shift = jkvc.quantize_pages(jnp.asarray(vals))
        jpool = {**jpool, n: codes, n + "_smax": smax, n + "_shift": shift}
    for src, fidx in ((0, 0), (1, 1), (4, 2)):
        jpool = jkvc.transcode_page(jpool, src, fidx)
    base = 9  # P + 1
    table = np.array([[base, base + 1, 2], [3, 8, 8], [5, 8, 8]], np.int32)
    lengths = np.array([19, 6, 0], np.int32)
    pre_table = np.array([[base + 2, 6, 7, 8]], np.int32)
    tokens = np.zeros((1, 3 + 8), np.int32)
    tokens[0, :2] = [4, 9]
    tokens[0, 3:8] = rng.integers(1, jcfg.vocab_size, 5)
    pre = (pre_table, np.array([8], np.int32), np.array([5], np.int32))
    jstate = jkvc.PagedState(jnp.asarray(table), jnp.asarray(lengths),
                             prefill=jkvc.PagedState(*map(jnp.asarray, pre)))
    fn = jax.jit(lambda p, tk, c, st: jmodels.decode_step(p, jcfg, tk, c, st, a_fmt="fp8_e4m3"))
    args = (packed, jnp.asarray(tokens), [{"kv": jpool}], jstate)
    jlog, _ = fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    tstate = tkvc.PagedState(t(table), t(lengths), prefill=tkvc.PagedState(*map(t, pre)))
    tpools = [{k: t(np.asarray(v)) for k, v in jpool.items()}]
    tlog = api.decode_step(tparams, tcfg, t(tokens), tpools, tstate, a_fmt="fp8_e4m3")
    assert tlog.shape == (4, jcfg.vocab_size)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-5, rtol=0)
    # the pools were written alike: the decode appends, then the chunk
    for name in ("k", "v", "k_smax", "k_shift", "k_fz", "k_fz_shift"):
        np.testing.assert_array_equal(to_np(tpools[0][name]), np.asarray(_[0]["kv"][name]))


def test_server_config_defaults_match_reference():
    t_cfg, j_cfg = tserve.ServerConfig(), jserve.ServerConfig()
    assert t_cfg.scheduler.engine == j_cfg.scheduler.engine == "mixed"
    assert t_cfg.prefix_cache is j_cfg.prefix_cache is True
    assert (t_cfg.slots, t_cfg.max_seq, t_cfg.page_size, t_cfg.a_fmt) == \
        (j_cfg.slots, j_cfg.max_seq, j_cfg.page_size, j_cfg.a_fmt)
    assert t_cfg.scheduler.prefill_chunk_pages == j_cfg.scheduler.prefill_chunk_pages
    assert t_cfg.scheduler.headroom_pages == j_cfg.scheduler.headroom_pages
    # the preemption, fault and audit knobs, and the request fields they read
    for name in ("policy", "low_watermark", "resume_watermark", "steal_cooldown",
                 "spill_budget_bytes"):
        assert getattr(t_cfg.scheduler, name) == getattr(j_cfg.scheduler, name), name
    for name in ("pool_pages", "strict", "audit_every"):
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    t_req, j_req = tserve.Request(rid=0, prompt=[1]), jserve.Request(rid=0, prompt=[1])
    for name in ("max_new", "priority", "deadline_step", "status", "error", "preemptions",
                 "evictions", "resume_ctx", "since", "seq"):
        assert getattr(t_req, name) == getattr(j_req, name), name
    assert set(f.name for f in dataclasses.fields(tserve.RequestResult)) <= \
        set(f.name for f in dataclasses.fields(jserve.RequestResult))


def test_no_refusal_names_engine_robustness():
    """Preemption, quarantine and audit are ported: no module of the port
    still refuses in the name of ROADMAP queue 1, item 8."""
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    named = [str(p.relative_to(src)) for p in sorted(src.rglob("*.py"))
             if re.search(r"item\s+8\b", p.read_text())]
    assert named == []


def test_mixed_precision_policy_needs_the_prefix_cache(tiny_packed):
    _, _, tcfg, tparams = tiny_packed
    with pytest.raises(ValueError, match="prefix cache"):
        tserve.Server(tparams, tcfg, tserve.ServerConfig(
            slots=2, max_seq=64, page_size=8, prefix_cache=False,
            cache=tserve.CachePolicy(**MIXED)), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tserve.Server(tparams, tcfg, tserve.ServerConfig(
            scheduler=tserve.SchedulerConfig(engine="fused")), device="cpu")
