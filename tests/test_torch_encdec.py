"""Whisper-style enc-dec in the port against the reference on the CPU:
the encoder, the write-once cross pages, the paged cross-attention, the
cache-free forward, and the ``Server`` (admission charge, frames checks,
per-frames prefix roots, cross pages through steal, spill and resume, the
engine fallback, the front-end) in lockstep with the reference's.

Whisper's smoke config with random weights from seeds, packed to W4A8 by
repro's ``quantize_tree`` where served: random-init streams vary (ROADMAP
queue 3, F3), so equal streams say something. The reference's steps run
strictly compiled (``StrictReference``), and so does its encoder
(``strict_encoder``); the streams agree up to ties (``compare_streams``)."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as jencdec
import repro_torch.models.encdec as tencdec
from repro import models as jmodels
from repro.configs import get_smoke as j_get_smoke
from repro.models import attention as jattn
from repro.runtime import kv_cache as jkvc
from repro.runtime import serve as jserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import layer_view
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.frontend import AsyncServer

from test_torch_bridge import port_cfg, t, to_np
from test_torch_configs import PrefixRoundings, assert_hidden_matches
from test_torch_configs import model as configs_model
from test_torch_mixed_engine import (STRICT_OPTIONS, StrictReference, _COMPILED,  # noqa: F401
                                     release_compiled)
from test_torch_scheduler import (assert_same_outcome, assert_same_pool, lockstep,  # noqa: F401
                                  one_thread)

FP8 = dict(active_fmt="fp8_e4m3")
MIXED = dict(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1", frozen_pages=16)
PAGE = 8
JCFG = j_get_smoke("whisper-tiny")  # encoder_seq 32: 4 cross pages of 8


def model(packed: bool, jcfg=JCFG):
    """Whisper's smoke config (or ``jcfg``), random weights from
    PRNGKey(0), packed by repro's ``quantize_tree`` when ``packed``
    (``test_torch_configs.model``)."""
    return configs_model("whisper-tiny", packed, jcfg)


def frames(seed: int, cfg=JCFG) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


@pytest.fixture
def roundings(monkeypatch):
    yield PrefixRoundings(monkeypatch)
    jax.clear_caches()


# -- the model -------------------------------------------------------------------------
@pytest.mark.parametrize("packed,a_fmt", [(False, None), (True, "fp8_e4m3")])
def test_encode_matches_reference(roundings, packed, a_fmt):
    """Above ``attn_chunk`` (48 frames, chunks of 32): the encoder's
    non-causal query-chunked attention. The final ``enc_ln`` rounds apart
    from the reference's: one bf16 ulp, or 2^-16 of the row's largest."""
    jcfg = dataclasses.replace(JCFG, encoder_seq=48)
    _, jparams, tcfg, tparams = model(packed, jcfg)
    fr = np.stack([frames(3, jcfg), frames(4, jcfg)])
    fn = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f, a_fmt=a_fmt))
    compiled = fn.lower(jparams, jnp.asarray(fr)).compile(compiler_options=STRICT_OPTIONS)
    want, got = roundings.forward(lambda: compiled(jparams, jnp.asarray(fr)),
                                  lambda: tencdec.encode(tparams, tcfg, t(fr), a_fmt=a_fmt),
                                  fr.shape[0] * fr.shape[1], jcfg.encoder_layers)
    assert got.shape == (2, 48, jcfg.d_model) and got.dtype == torch.bfloat16
    roundings._bf16(got, t(np.asarray(want)))


@pytest.mark.parametrize("packed,fmt", [(False, "fp8_e4m3"), (True, "fp8_e4m3"), (True, None)])
def test_encode_cross_pages_bit_identical(monkeypatch, packed, fmt):
    """Given the reference's encoder output (both packages' ``encode``
    return it), every decoder layer's cross codes, s_max and shifts equal
    the reference's bit for bit, on the request's pages only."""
    jcfg, jparams, tcfg, tparams = model(packed)
    fr = frames(5)[None]
    enc = np.asarray(jencdec.encode(jparams, jcfg, jnp.asarray(fr)))
    monkeypatch.setattr(jencdec, "encode", lambda *a, **k: jnp.asarray(enc))
    monkeypatch.setattr(tencdec, "encode", lambda *a, **k: t(enc))
    n_pages, cpp = 12, 4
    table = np.array([[7, 2, 9, 4]], np.int32)
    hd, kv = jcfg.resolved_head_dim, jcfg.n_kv_heads
    jpool = jkvc.init_cross_pool(jcfg.n_layers, n_pages, PAGE, kv, hd, jkvc.page_format(fmt))
    jout = jencdec.encode_cross_pages(jparams, jcfg, jnp.asarray(fr), [{"cross": jpool}],
                                      jnp.asarray(table))[0]["cross"]
    tpool = tkvc.init_cross_pool(jcfg.n_layers, n_pages, PAGE, kv, hd, fmt, device="cpu")
    tout = tapi.encode_cross_pages(tparams, tcfg, t(fr), tpool, t(table))
    assert tout is tpool and set(tout) == set(jout)
    for name in tout:
        np.testing.assert_array_equal(to_np(tout[name]), np.asarray(jout[name]).astype(
            to_np(tout[name]).dtype), err_msg=name)
    untouched = [p for p in range(n_pages + 1) if p not in table[0]]
    assert not to_np(tout["k"][:, untouched]).any()
    assert cpp == tkvc.pages_needed(jcfg.encoder_seq, PAGE)


def _cross_pools(fmt, seed=6, n_pages=10):
    """One layer's cross pool in both packages holding random K/V for two
    requests (encoder lengths 32 and 20), written by each package's
    ``write_cross_pages``; the codes must be equal bit for bit."""
    rng = np.random.default_rng(seed)
    kv, hd = JCFG.n_kv_heads, JCFG.resolved_head_dim
    tables = np.array([[3, 0, 8, 5], [1, 6, 2, n_pages]], np.int32)
    jpool = {k: v[0] for k, v in jkvc.init_cross_pool(1, n_pages, PAGE, kv, hd,
                                                      jkvc.page_format(fmt)).items()}
    tpool = {k: v[0] for k, v in tkvc.init_cross_pool(1, n_pages, PAGE, kv, hd, fmt,
                                                      device="cpu").items()}
    for row, n in enumerate((32, 20)):
        vals = {k: rng.normal(size=(1, n, kv, hd)).astype(np.float32) for k in ("k", "v")}
        jpool = jax.jit(jkvc.write_cross_pages)(
            jpool, {k: jnp.asarray(v) for k, v in vals.items()}, jnp.asarray(tables[row:row + 1]))
        tkvc.write_cross_pages(tpool, {k: t(v) for k, v in vals.items()},
                               t(tables[row:row + 1]))
    for name in tpool:
        np.testing.assert_array_equal(to_np(tpool[name]), np.asarray(jpool[name]).astype(
            to_np(tpool[name]).dtype), err_msg=name)
    return jpool, tpool, tables, np.array([32, 20], np.int32)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", None])
@pytest.mark.parametrize("branch", ["decode", "prefill"])
def test_paged_cross_attention_matches_reference(branch, fmt):
    """Decode (two rows, through ``ops.paged_decode_attn`` at ``kv_lens =
    enc_lengths``) and a batch-1 prefill chunk of 8 (the gathered pages
    under the encoder-length mask), on layer 0's dense cross weights: the
    outputs within 2^-7 of each row's largest magnitude (the bf16 roundings
    of q, the attention and the output projection, summed in another order)."""
    jcfg, jparams, tcfg, tparams = model(False)
    dec = dataclasses.replace(jcfg, pos_embedding="learned_applied")
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"])["mixer"]["cross"]
    tp = layer_view(tparams["decoder"], 0)["mixer"]["cross"]
    jpool, tpool, tables, enc_len = _cross_pools(fmt)
    rows = slice(0, 2) if branch == "decode" else slice(1, 2)
    s = 1 if branch == "decode" else 8
    x = np.random.default_rng(7).normal(size=(rows.stop - rows.start, s, jcfg.d_model))
    x = jnp.asarray(x, jnp.bfloat16)
    chunk = None if branch == "decode" else np.array([s], np.int32)
    lengths = np.zeros(rows.stop - rows.start, np.int32)
    jst = jkvc.PagedState(jnp.asarray(tables[rows]), jnp.asarray(lengths),
                          None if chunk is None else jnp.asarray(chunk),
                          jnp.asarray(tables[rows]), jnp.asarray(enc_len[rows]))
    tst = tkvc.PagedState(t(tables[rows]), t(lengths), None if chunk is None else t(chunk),
                          cross_table=t(tables[rows]), enc_lengths=t(enc_len[rows]))
    pos = np.zeros((x.shape[0], s), np.int32)
    fn = jax.jit(lambda p_, x_, pos_, pool_, st_: jattn.paged_cross_attention(
        p_, x_, dec, pos_, pool_, st_, a_fmt=None))
    want = np.asarray(fn(jp, x, jnp.asarray(pos), jpool, jst)).astype(np.float32)
    got = tattn.paged_cross_attention(tp, t(x), tcfg, t(pos), tpool, tst)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    row = np.abs(want).max(-1, keepdims=True)
    assert np.all(np.abs(to_np(got) - want) <= 2.0 ** -7 * row)


@pytest.mark.parametrize("packed,a_fmt", [(False, None), (True, "fp8_e4m3")])
def test_forward_hidden_matches_reference(roundings, packed, a_fmt):
    jcfg, jparams, tcfg, tparams = model(packed)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32),
             "frames": np.stack([frames(1), frames(2)])}
    assert_hidden_matches(roundings, jcfg, jparams, tcfg, tparams, batch, a_fmt,
                          jparams["embed"])


# -- serving ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def strict_encoder(monkeypatch):
    """The reference's admission step compiled with ``STRICT_OPTIONS`` (one
    program per shape, kept in ``_COMPILED``), as ``StrictReference``
    compiles its engine step."""
    step = jax.jit(jmodels.encode_cross_pages, static_argnames=("cfg", "a_fmt"))

    def encode(params, frames_, caches, cross_table, cfg, a_fmt):
        key = ("encode", cfg, a_fmt, str(jax.tree_util.tree_structure(caches)),
               tuple(jnp.shape(a) for a in jax.tree_util.tree_leaves((frames_, caches))))
        if key not in _COMPILED:
            _COMPILED[key] = step.lower(params, cfg, frames_, caches, cross_table,
                                        a_fmt=a_fmt).compile(compiler_options=STRICT_OPTIONS)
        return _COMPILED[key](params, frames_, caches, cross_table)

    monkeypatch.setattr(jserve, "_encode_cross_jit", encode)


# self pages + two requests' cross pages (4 each at pages of 8): below the
# worst case of 2 slots (24), so the served tests' traffic queues or steals
SERVE_POOL = 5 + 2 * 4


def servers(packed=True, cache=MIXED, slots=2, max_seq=64, pool_pages=SERVE_POOL,
            engine="alternating", **knobs):
    """(the reference's Server, its StrictReference, the port's) on one
    configuration: the reference's defaults at pages of 8 (FP8 activations,
    the prefix cache, FP8 pages with FP4 frozen pages) on SERVE_POOL pages.
    The served tests share it and prompts of 9-16 tokens (one chunk shape),
    and so the reference's compiled programs."""
    jcfg, jparams, tcfg, tparams = model(packed)
    common = dict(slots=slots, max_seq=max_seq, page_size=PAGE, a_fmt="fp8_e4m3",
                  prefix_cache=True, pool_pages=pool_pages)
    sched = dict(engine=engine, prefill_chunk_pages=2, **knobs)
    jsrv = jserve.Server(jparams, jcfg, jserve.ServerConfig(
        **common, kernel_backend="ref", cache=jserve.CachePolicy(**cache),
        scheduler=jserve.SchedulerConfig(**sched)))
    strict = StrictReference(jsrv, jcfg, common["a_fmt"])
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **common, cache=tserve.CachePolicy(**cache), scheduler=tserve.SchedulerConfig(**sched)),
        device="cpu")
    return jsrv, strict, tsrv


def submit_both(jsrv, tsrv, reqs):
    """(rid, prompt, max_new, frames) to both servers."""
    for rid, prompt, max_new, fr in reqs:
        jsrv.submit(jserve.Request(rid=rid, prompt=list(prompt), max_new=max_new, frames=fr))
        tsrv.submit(tserve.Request(rid=rid, prompt=list(prompt), max_new=max_new, frames=fr))


def drain_lockstep(jsrv, tsrv):
    """``test_torch_scheduler.lockstep`` (audits and pool ownership equal
    after every step), the cross tables and encoder lengths equal too."""
    def same_cross(tsrv, jsrv):
        assert tsrv.slot_cross == jsrv.slot_cross
        np.testing.assert_array_equal(tsrv.enc_lengths, jsrv.enc_lengths)
    lockstep(jsrv, tsrv, on_step=same_cross)


def streams_after(jsrv, strict, tsrv):
    """``test_torch_scheduler.assert_same_outcome`` with no tie accepted;
    returns the port's streams."""
    assert not assert_same_outcome(tsrv, jsrv, strict)
    return {r.rid: list(r.out) for r in tsrv.finished}


def test_streams_match_jax_server_over_frame_sets():
    """Three requests under two frame sets, on FP8 pages with FP4 frozen
    pages: rids 0 and 2 share frames and a prompt (rid 2 maps rid 0's
    page under the frames' root), rid 1 has that prompt under other
    frames. Streams, counters and pools as the reference's."""
    jsrv, strict, tsrv = servers()
    assert tsrv.engine == jsrv.engine == "alternating"
    prompt = np.random.default_rng(10).integers(1, JCFG.vocab_size, size=16).tolist()
    fa, fb = frames(11), frames(12)
    submit_both(jsrv, tsrv, [(0, prompt, 6, fa), (1, prompt, 6, fb), (2, prompt, 6, fa)])
    drain_lockstep(jsrv, tsrv)
    got = streams_after(jsrv, strict, tsrv)
    assert got[0] == got[2] != got[1]
    assert tsrv.stats["prefix_hit_pages"] == 1 and tsrv.stats["fp4_frozen_pages"] == 4
    assert len({tok for toks in got.values() for tok in toks}) > 1  # not F3's one token


def test_admission_charges_encoder_pages():
    """Admission charges pages(prompt) + headroom + pages(encoder_seq); a
    pool that holds the prompt but not the cross pages refuses at submit."""
    jsrv, _, tsrv = servers()
    cpp = tkvc.pages_needed(JCFG.encoder_seq, PAGE)
    assert tsrv._cross_pp == jsrv._cross_pp == cpp == 4
    full = servers(pool_pages=None)  # fully backed: the cross pages of every slot too
    assert full[2]._n_pages == full[0]._n_pages == 2 * (64 // PAGE + cpp)
    submit_both(jsrv, tsrv, [(0, list(range(1, 12)), 8, frames(1))])
    jsrv.step(), tsrv.step()
    assert len(tsrv.slot_cross[0]) == cpp and len(tsrv.slot_pages[0]) == 2 + 1
    assert tsrv.cross_table.tolist() == jsrv.cross_table.tolist()
    assert_same_pool(tsrv, jsrv)
    for mod in (jserve, tserve):
        cfg = JCFG if mod is jserve else port_cfg(JCFG)
        params = model(False)[1 if mod is jserve else 3]
        kw = dict(kernel_backend="ref") if mod is jserve else {}
        srv = mod.Server(params, cfg, mod.ServerConfig(slots=1, max_seq=64, page_size=PAGE,
                                                       pool_pages=cpp, a_fmt=None, **kw),
                         **({} if mod is jserve else {"device": "cpu"}))
        with pytest.raises(ValueError, match="pages"):
            srv.submit(mod.Request(rid=0, prompt=[1, 2, 3], max_new=4, frames=frames(1)))


@pytest.mark.parametrize("bad", ["missing", "short"])
def test_frames_checks_fail_fast(bad):
    """A request without frames, or with frames of another length, is
    refused at submit, as the reference refuses it; the prefix cache stays
    on for enc-dec (its chains hang off per-frames roots)."""
    _, jparams, tcfg, tparams = model(False)
    fr = None if bad == "missing" else frames(1)[:-1]
    for mod, params, cfg, kw in ((jserve, jparams, JCFG, dict(kernel_backend="ref")),
                                 (tserve, tparams, tcfg, {})):
        srv = mod.Server(params, cfg, mod.ServerConfig(slots=1, max_seq=32, page_size=PAGE,
                                                       a_fmt=None, **kw),
                         **({} if mod is jserve else {"device": "cpu"}))
        assert srv._prefix is not None
        with pytest.raises(ValueError, match="frames"):
            srv.submit(mod.Request(rid=0, prompt=[1, 2, 3], max_new=4, frames=fr))


def test_prefix_parity_and_collision_safety():
    """The same prompt under frames A twice, then under frames B: the
    repeat maps A's page ((16 - 1) // 8 = 1) and decodes A's cold-run
    stream; under B nothing is hit and the stream is B's cold run. The
    frames digests differ, so the roots never alias."""
    prompt = np.random.default_rng(9).integers(1, JCFG.vocab_size, size=16).tolist()
    fa, fb = frames(21), frames(22)
    assert tserve.Request(0, [1], frames=fa).frames_digest() != \
        tserve.Request(1, [1], frames=fb).frames_digest()
    assert tserve.Request(0, [1], frames=fa).frames_digest() == \
        jserve.Request(0, [1], frames=fa).frames_digest()

    def cold(fr):
        _, _, srv = servers()
        srv.submit(tserve.Request(rid=0, prompt=list(prompt), max_new=6, frames=fr))
        return list(srv.run_until_drained()[0].tokens)

    jsrv, strict, tsrv = servers()
    for rid, fr in ((0, fa), (1, fa), (2, fb)):
        submit_both(jsrv, tsrv, [(rid, prompt, 6, fr)])
        drain_lockstep(jsrv, tsrv)
    got = streams_after(jsrv, strict, tsrv)
    assert got[0] == got[1] == cold(fa) and got[2] == cold(fb)
    assert tsrv.stats["prefix_hit_pages"] == 1
    roots = tsrv._prefix._roots
    assert len(roots) == 2 and len(set(roots.values())) == 2


def _steal_requests():
    """Prompts of 12 and 14 charge 2 + 1 pages and 4 cross pages each at
    admission; their growth to 28 and 30 tokens wants a page more than
    SERVE_POOL leaves: one steal, one resume from the spilled bytes."""
    rng = np.random.default_rng(4)
    return [(i, rng.integers(1, JCFG.vocab_size, size=n).tolist(), 16, frames(30 + i))
            for i, n in enumerate((12, 14))]


def test_cross_pages_survive_steal_and_resume():
    """The victim's cross pages are spilled with its private pages and
    restored into other pages on resume. In lockstep with the reference
    (audits equal after every step), and each stream equals its solo run."""
    reqs = _steal_requests()
    jsrv, strict, tsrv = servers()
    submit_both(jsrv, tsrv, reqs)
    drain_lockstep(jsrv, tsrv)
    got = streams_after(jsrv, strict, tsrv)
    assert tsrv.stats["preemptions"] == 1 and tsrv.stats["resumes"] == 1
    for rid, prompt, max_new, fr in reqs:
        _, _, solo = servers(pool_pages=None)
        solo.submit(tserve.Request(rid=rid, prompt=list(prompt), max_new=max_new, frames=fr))
        assert list(solo.run_until_drained()[0].tokens) == got[rid], rid


def test_spill_restores_cross_bytes_with_audit_clean():
    """The victim's spill holds its cross pages' bytes (codes and scales of
    every layer) after its self pages' part; the resumed slot's new cross
    pages hold them again, bit for bit; ``audit()`` is clean after every
    step (``audit_every=1``)."""
    _, _, tsrv = servers()
    tsrv.audit_every = 1
    spilled = {}
    preempt, resume = tsrv._preempt, tsrv._resume

    def spy_preempt(slot):
        ids = tsrv._ids(tsrv.slot_cross[slot])
        spilled[tsrv.active[slot].rid] = {k: v[:, ids].clone()
                                          for k, v in tsrv.cross_pool.items()}
        preempt(slot)
        assert len(tsrv.preempted[-1].payload) == 2  # self pages, then cross pages

    def spy_resume(slot, spill, shared, need):
        resume(slot, spill, shared, need)
        ids = tsrv._ids(tsrv.slot_cross[slot])
        for k, v in spilled.pop(spill.req.rid).items():
            assert torch.equal(tsrv.cross_pool[k][:, ids], v), k

    tsrv._preempt, tsrv._resume = spy_preempt, spy_resume
    for rid, prompt, max_new, fr in _steal_requests():
        tsrv.submit(tserve.Request(rid=rid, prompt=prompt, max_new=max_new, frames=fr))
    res = tsrv.run_until_drained()
    assert all(r.ok for r in res) and tsrv.stats["resumes"] == 1 and not spilled
    assert tsrv.audit()["violations"] == 0
    assert all(not ids for ids in tsrv.slot_cross)


def test_mixed_engine_falls_back_to_alternating():
    _, jparams, tcfg, tparams = model(False)
    jsrv = jserve.Server(jparams, JCFG, jserve.ServerConfig(
        slots=2, max_seq=32, page_size=4, a_fmt=None,
        scheduler=jserve.SchedulerConfig(engine="mixed")))
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        slots=2, max_seq=32, page_size=4, a_fmt=None,
        scheduler=tserve.SchedulerConfig(engine="mixed")), device="cpu")
    assert tsrv.engine == jsrv.engine == "alternating"


def test_async_generate_with_frames():
    """``AsyncServer.generate(frames=...)`` streams what the synchronous
    server decodes for the same request."""
    _, _, tsrv = servers()
    _, _, sync = servers()
    prompt, fr = [5, 9, 2, 7, 1], frames(40)
    sync.submit(tserve.Request(rid=0, prompt=prompt, max_new=4, frames=fr))
    want = list(sync.run_until_drained()[0].tokens)

    async def run():
        front = AsyncServer(tsrv)
        toks = [ev.token async for ev in front.generate(prompt, max_new=4, frames=fr)
                if not ev.finished]
        with pytest.raises(ValueError, match="frames"):
            async for _ in front.generate(prompt, max_new=4):
                pass
        await front.close()
        return toks

    assert asyncio.run(run()) == want


def test_fp4_cross_pages_refused_naming_f9():
    """F9: the reference's decode reads packed FP4 cross pages at the
    packed width and fails at its first step; the port refuses the policy
    when the Server is built. The reference's failure is pinned, so the
    day it changes shows here."""
    _, jparams, tcfg, tparams = model(False)
    cache = dict(active_fmt="fp8_e4m3", cross_fmt="fp4_e2m1")
    with pytest.raises(NotImplementedError, match="F9"):
        tserve.Server(tparams, tcfg, tserve.ServerConfig(
            slots=1, max_seq=32, page_size=PAGE, cache=tserve.CachePolicy(**cache)),
            device="cpu")
    jsrv = jserve.Server(jparams, JCFG, jserve.ServerConfig(
        slots=1, max_seq=32, page_size=PAGE, kernel_backend="ref",
        cache=jserve.CachePolicy(**cache)))
    jsrv.submit(jserve.Request(rid=0, prompt=[1, 2, 3], max_new=3, frames=frames(1)))
    with pytest.raises(TypeError, match="reshape"):
        jsrv.run_until_drained()
