"""The port's preempting scheduler against repro's: page steal, host spill
and resume, the spill budget, the wait line, victim choice, the reserve
policy and the spill checksum (the MLA latent pool's spill is served in
``test_torch_faults.py``, with a corrupted spill and a NaN row).

Served cases run the reference ``Server`` (strictly compiled, its ``ref``
kernels: ``StrictReference``) and the port's on the CPU with the same pool
size, knobs and requests, stepped in lockstep on a pool too small for the
traffic: after every step both audits must return the same summary and the
refcounts, free lists and parked pages must be equal; at the end every
counter and each result's preemptions and evictions. The streams agree up
to ties (``compare_streams``). Random-init models only: ``trained_tiny``'s
streams are token 0 everywhere (ROADMAP queue 3, F3).
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import kv_cache as jkvc
from repro.runtime import serve as jserve
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import serve as tserve

from test_torch_bridge import one_thread, t, to_np  # noqa: F401  (autouse: torch on one thread)
from test_torch_mixed_engine import (MIXED, StrictReference, _packed, compare_streams,
                                     release_compiled)

FP8 = dict(active_fmt="fp8_e4m3")
# serve_both's sizes (test_torch_mixed_engine): 3 slots, max_seq 64, pages of 8
COMMON = dict(slots=3, max_seq=64, page_size=8, a_fmt="fp8_e4m3", prefix_cache=True)
MAX_STEPS = 400


def requests(vocab, n=6, tail=4, max_new=20, seed=5, priority=lambda rid: int(rid % 3 == 0)):
    """``n`` requests on one 2-page prefix, each with a ``tail``-token
    suffix of its own: (rid, prompt, max_new, priority). A tuple
    ``max_new`` is cycled over the rids."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=16).tolist()
    max_new = max_new if isinstance(max_new, tuple) else (max_new,)
    return [(rid, prefix + rng.integers(1, vocab, size=tail).tolist(),
             max_new[rid % len(max_new)], priority(rid)) for rid in range(n)]


def submit(mod, srv, reqs):
    out = []
    for rid, prompt, max_new, priority in reqs:
        out.append(mod.Request(rid=rid, prompt=list(prompt), max_new=max_new, priority=priority))
        srv.submit(out[-1])
    return out


def servers(model, engine, cache, pool_pages, sched=(), faults=(None, None), **config):
    """(the reference's Server with its StrictReference, the port's) on one
    configuration; ``faults`` is (the reference's plan, the port's)."""
    jcfg, jparams, tcfg, tparams = model
    common = {**COMMON, **config, "pool_pages": pool_pages}
    knobs = dict(engine=engine, prefill_chunk_pages=2, **dict(sched))
    jsrv = jserve.Server(jparams, jcfg, jserve.ServerConfig(
        **common, kernel_backend="ref", cache=jserve.CachePolicy(**cache),
        scheduler=jserve.SchedulerConfig(**knobs)), faults=faults[0])
    strict = StrictReference(jsrv, jcfg, common["a_fmt"])
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **common, cache=tserve.CachePolicy(**cache), scheduler=tserve.SchedulerConfig(**knobs)),
        device="cpu", faults=faults[1])
    return jsrv, strict, tsrv


def assert_same_pool(tsrv, jsrv):
    np.testing.assert_array_equal(tsrv.page_refs, jsrv.page_refs)
    assert (tsrv.free_pages, tsrv.free_frozen, tsrv.reusable_pages) == \
        (jsrv.free_pages, jsrv.free_frozen, jsrv.reusable_pages)
    assert tsrv.slot_pages == jsrv.slot_pages
    assert [r and r.rid for r in tsrv.active] == [r and r.rid for r in jsrv.active]


def lockstep(jsrv, tsrv, on_step=None, steps=None):
    """Step both servers until both are drained, or ``steps`` times: after
    every step they must agree on progress, on the audit's summary and on
    the pool's ownership."""
    for _ in range(steps or MAX_STEPS):
        went = tsrv.step()
        assert jsrv.step() == went
        assert tsrv.audit() == jsrv.audit()
        assert_same_pool(tsrv, jsrv)
        if on_step is not None:
            on_step(tsrv, jsrv)
        if not went and not tsrv.queue and not tsrv.preempted:
            break
        assert went or tsrv._alloc_faulted, "starved"
    else:
        if steps:
            return
        raise AssertionError("no drain")
    assert not jsrv.queue and not jsrv.preempted


def staggered_waves(vocab, seed=11):
    """Three waves of 6 requests, each wave on a 2-page prefix of its own,
    20 new tokens, alternate rids at priority 1: (rid, prompt, max_new,
    priority) lists."""
    rng = np.random.default_rng(seed)
    return [[(6 * w + i, requests(vocab, n=1, seed=5 + w)[0][1][:16]
              + rng.integers(1, vocab, 4).tolist(), 20, i % 2) for i in range(6)]
            for w in range(3)]


def serve_staggered(jsrv, tsrv, waves, gap=8, on_step=None):
    """Submits each wave to both servers ``gap`` steps after the one
    before, stepping them in lockstep, then drains both. On a pool of 7
    pages whose frozen region holds two prefixes the third wave reclaims
    pages of a prefix that spilled requests still name, so some resumes
    re-walk their prefix and some fall back to a re-prefill."""
    for w, wave in enumerate(waves):
        submit(jserve, jsrv, wave)
        submit(tserve, tsrv, wave)
        lockstep(jsrv, tsrv, on_step, steps=gap if w < len(waves) - 1 else None)


def assert_same_outcome(tsrv, jsrv, strict):
    """Every counter and each request's status, preemptions and evictions
    equal; the streams by ``compare_streams``. Returns the accepted ties."""
    assert tsrv.stats == {k: jsrv.stats[k] for k in tsrv.stats}
    assert {r.rid: (r.status, r.preemptions, r.evictions) for r in tsrv.finished} == \
        {r.rid: (r.status, r.preemptions, r.evictions) for r in jsrv.finished}
    streams = lambda srv: {r.rid: (list(r.out), r.status) for r in srv.finished}
    return compare_streams(streams(tsrv), streams(jsrv), strict.gaps)


@pytest.fixture(scope="module")
def tiny_packed():
    return _packed(2, traced=True)


# (engine, cache, pool pages, scheduler knobs, new tokens): on these pools
# the token budget steals, resumes from bytes and evicts a spill over its
# budget (bf16 pages are twice FP8's bytes); reserve-on-admit serves the
# same pool without a steal, and its worst cases of 3 and 4 pages meet a
# free count equal to the worst case, so an admission off by a page shows
TIGHT = {"mixed-fp8": ("mixed", FP8, 9, dict(spill_budget_bytes=3000), 20),
         "mixed-fp8-reserve": ("mixed", FP8, 9, dict(policy="reserve"), (20, 12)),
         "mixed-fp8-fp4frozen": ("mixed", MIXED, 7, dict(spill_budget_bytes=3000), 20),
         "alternating-bf16": ("alternating", dict(active_fmt=None), 7,
                              dict(spill_budget_bytes=10000), 20)}


@pytest.mark.parametrize("case", list(TIGHT))
def test_tight_pool_matches_jax_server(tiny_packed, case):
    engine, cache, pool, knobs, max_new = TIGHT[case]
    jsrv, strict, tsrv = servers(tiny_packed, engine, cache, pool,
                                 dict(steal_cooldown=1, **knobs))
    reqs = requests(tiny_packed[0].vocab_size, max_new=max_new)
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv)
    ties = assert_same_outcome(tsrv, jsrv, strict)
    assert not ties, ties
    st = tsrv.stats
    if knobs.get("policy") == "reserve":
        assert st["preemptions"] == st["pages_stolen"] == st["resumes"] == 0, st
    else:
        assert st["preemptions"] >= 2 and st["resumes"] >= 1 and st["spill_evictions"] >= 1, st
    assert all(r.status == "ok" and len(r.out) == r.max_new for r in tsrv.finished)
    assert tsrv._spill_bytes == 0 and (tsrv.page_refs == 0).all()
    assert len({t for r in tsrv.finished for t in r.out}) > 3  # the streams vary
    if cache.get("frozen_fmt"):
        assert st["fp4_frozen_pages"] >= 2


def test_evicted_spill_keeps_global_wait_order(tiny_packed):
    """repro's ``test_evicted_spill_keeps_global_wait_order`` in both
    packages: A is spilled a step before B, the budget evicts A (the
    oldest) into the queue, and readmission still takes A first: one wait
    line over spills and fresh requests."""
    jsrv, strict, tsrv = servers(tiny_packed, "mixed", FP8, 9)
    reqs = requests(tiny_packed[0].vocab_size, n=2, max_new=10, priority=lambda rid: 0)
    for mod, srv in ((jserve, jsrv), (tserve, tsrv)):
        a, b = submit(mod, srv, reqs)
        for _ in range(3):  # both stream their prompts and start decoding
            srv.step()
        srv._preempt(srv.active.index(a))
        srv._step_no += 1  # a step passes without readmitting A
        srv._preempt(srv.active.index(b))
        assert a.since < b.since
        srv.spill_budget_bytes = max(sp.nbytes for sp in srv.preempted)
        srv._enforce_spill_budget()
        assert a.evictions == 1 and a in srv.queue
        assert [sp.req for sp in srv.preempted] == [b]
        assert srv._admit_one(0) and srv.active[0] is a
    assert tsrv.preempted[0].nbytes == jsrv.preempted[0].nbytes
    assert_same_pool(tsrv, jsrv)
    lockstep(jsrv, tsrv)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    assert tsrv.stats["spill_evictions"] == 1 and tsrv.stats["resumes"] == 1


def _victim_state(mod, rng, slots=4):
    """A server object holding only what ``_pick_victim`` and ``_slack``
    read: a random occupancy, priorities, deadlines, arrivals and
    admission steps."""
    srv = types.SimpleNamespace(slots=slots, steal_cooldown=int(rng.integers(0, 4)),
                                _step_no=int(rng.integers(5, 40)))
    srv.active = [None if rng.random() < 0.25 else mod.Request(
        rid=s, prompt=[1], max_new=int(rng.integers(4, 30)), priority=int(rng.integers(0, 3)),
        deadline_step=None if rng.random() < 0.4 else int(rng.integers(0, 80)),
        out=[0] * int(rng.integers(0, 4))) for s in range(slots)]
    srv._slot_seq = rng.permutation(slots).tolist()
    srv._slot_since = rng.integers(0, srv._step_no + 1, size=slots).tolist()
    srv._slack = types.MethodType(mod.Server._slack, srv)
    return srv


def test_pick_victim_matches_reference():
    """Priority, then deadline slack (a lost deadline stops shielding),
    then age, with the steal cooldown, on synthetic states: no model."""
    rng = np.random.default_rng(0)
    picks = set()
    for _ in range(300):
        state = rng.bit_generator.state
        jstate = _victim_state(jserve, rng)
        rng.bit_generator.state = state
        tstate = _victim_state(tserve, rng)
        for s, r in enumerate(tstate.active):
            if r is not None:
                assert tserve.Server._slack(tstate, r) == \
                    jserve.Server._slack(jstate, jstate.active[s])
        pick = tserve.Server._pick_victim(tstate)
        assert pick == jserve.Server._pick_victim(jstate)
        picks.add(pick)
    assert picks >= {0, 1, 2, 3}


def _port_server(tcfg, tparams, **kw):
    sched = kw.pop("scheduler", {})
    return tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **{**COMMON, "a_fmt": None, "page_size": 4, "max_seq": 32, **kw},
        scheduler=tserve.SchedulerConfig(**{"prefill_chunk_pages": 2, **sched})), device="cpu")


@pytest.mark.parametrize("engine", ["mixed", "alternating"])
def test_admit_steal_resume_fuzz(tiny_packed, engine):
    """repro's seeded fuzz over staggered arrivals on a tight pool, in the
    port alone: the audit is clean after every step, every request
    finishes in full, and the drained pool is whole. Stolen prefixes are
    reclaimed meanwhile, so most resumes fall back to a re-prefill (the
    lockstep cases hold that path against repro's:
    ``test_steal_resume_streams_equal_ample_pool`` and
    ``test_torch_faults.test_alternating_frozen_waves_with_faults_match_reference``)."""
    _, _, tcfg, tparams = tiny_packed
    rng = np.random.default_rng(7)
    srv = _port_server(tcfg, tparams, pool_pages=8, cache=tserve.CachePolicy(**FP8),
                       scheduler=dict(steal_cooldown=1, prefill_chunk_pages=4, engine=engine))
    reqs = [tserve.Request(rid=i, prompt=rng.integers(1, 64, rng.choice([3, 5, 9])).tolist(),
                           max_new=int(rng.choice([2, 6, 14])), priority=int(rng.choice([0, 1])))
            for i in range(12)]
    pending = list(reqs)
    for _ in range(4):
        srv.submit(pending.pop(0))
    for step in range(600):
        went = srv.step()
        assert srv.audit()["violations"] == 0
        if pending and step % 3 == 0:
            srv.submit(pending.pop(0))
        if not went and not pending and not srv.queue and not srv.preempted:
            break
    assert len(srv.finished) == len(reqs)
    assert all(len(r.out) == r.max_new and r.status == "ok" for r in reqs)
    assert sorted(srv.free_pages + srv.reusable_pages) == list(range(srv._n_pages))
    assert (srv.page_refs == 0).all()
    assert srv.stats["preemptions"] >= 2
    assert srv.stats["preemptions"] == srv.stats["resumes"] + srv.stats["resume_fallbacks"]


def test_reserve_policy_never_steals(tiny_packed):
    """Reserve-on-admit holds every request's worst case from admission: on
    a pool where the token budget steals, it never does, and it serves
    the streams of a fully backed pool; the token budget decodes more rows
    a step. (A stolen request whose prefix was reclaimed re-prefills its
    generated tokens into FP8 pages at one scale instead of growing them
    token by token, so its stream may leave the fully backed one: repro's
    does the same, ``test_tight_pool_matches_jax_server``.)"""
    _, _, tcfg, tparams = tiny_packed
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, tcfg.vocab_size, size=int(m)).tolist()
               for m in rng.integers(3, 8, size=8)]
    outs, stats = {}, {}
    for policy, pool in (("reserve", 12), ("token_budget", 12), ("token_budget", None)):
        srv = _port_server(tcfg, tparams, slots=4, max_seq=48, pool_pages=pool,
                           cache=tserve.CachePolicy(**FP8), scheduler=dict(policy=policy))
        for i, p in enumerate(prompts):
            srv.submit(tserve.Request(rid=i, prompt=list(p), max_new=24 if i % 4 == 0 else 4))
        done = srv.run_until_drained()
        assert len(done) == len(prompts) and all(r.ok for r in done)
        outs[policy, pool] = {r.rid: r.tokens for r in done}
        stats[policy, pool] = dict(srv.stats)
    assert stats["reserve", 12]["preemptions"] == stats["reserve", 12]["pages_stolen"] == 0
    assert stats["token_budget", 12]["preemptions"] >= 1
    assert outs["reserve", 12] == outs["token_budget", None]
    util = {k: st["slot_steps"] / (st["steps"] * 4) for k, st in stats.items()}
    assert util["token_budget", 12] > util["reserve", 12]


def _payload_pools(kind, rng):
    """The same pool in both packages, every leaf random bytes of its dtype
    (bf16 values, FP8 codes with f32 and int32 scales, MLA latent pages),
    and three pages to spill."""
    layers, pages, page = 2, 6, 8
    if kind == "mla":
        jpool = jkvc.init_mla_pool(layers, pages, page, 24, 8, "fp8_e4m3")
    else:
        fmt = None if kind == "bf16" else "fp8_e4m3"
        jpool = jkvc.init_gqa_pool(layers, pages, page, 2, 16, fmt)
    for name, leaf in jpool.items():
        if leaf.dtype == jnp.bfloat16:
            vals = jnp.asarray(rng.normal(size=leaf.shape), jnp.bfloat16)
        elif leaf.dtype == jnp.uint8:
            vals = rng.integers(0, 256, leaf.shape, dtype=np.uint8)
        elif leaf.dtype == jnp.int32:
            vals = rng.integers(-9, 9, leaf.shape).astype(np.int32)
        else:
            vals = rng.random(leaf.shape).astype(np.float32)
        jpool = {**jpool, name: jnp.asarray(vals)}
    return {k: t(np.asarray(v)) for k, v in jpool.items()}, jpool, [4, 1, 3]


@pytest.mark.parametrize("kind", ["bf16", "fp8", "mla"])
def test_payload_checksum_matches_reference(kind):
    """The port's spill of the same pages holds the reference's bytes under
    the reference's CRC, and any single flipped byte moves the CRC."""
    rng = np.random.default_rng(3)
    tpool, jpool, pids = _payload_pools(kind, rng)
    payload = [tkvc.spill_pages(tpool, torch.tensor(pids))]
    jpayload = [{name: np.asarray(leaf[:, np.asarray(pids)]) for name, leaf in jpool.items()
                 if "_fz" not in name and leaf.size}]
    assert sorted(payload[0]) == sorted(jpayload[0])
    for name, arr in payload[0].items():
        assert arr.tobytes() == np.ascontiguousarray(jpayload[0][name]).tobytes()
    crc = tkvc.payload_checksum(payload)
    assert crc == jkvc.payload_checksum(jpayload)
    for name in sorted(payload[0]):
        flat = payload[0][name].view(np.uint8).reshape(-1)
        for i in rng.choice(flat.size, size=min(flat.size, 64), replace=False):
            for bit in (0x01, 0x80, 0xFF):
                flat[i] ^= bit
                assert tkvc.payload_checksum(payload) != crc
                flat[i] ^= bit
    assert tkvc.payload_checksum(payload) == crc
    tkvc.restore_pages(tpool, payload[0], torch.tensor([0, 2, 5]))
    for name, leaf in jpool.items():
        np.testing.assert_array_equal(to_np(tpool[name][:, [0, 2, 5]]),
                                      np.asarray(leaf[:, np.asarray(pids)]).astype(np.float32)
                                      if leaf.dtype == jnp.bfloat16 else
                                      np.asarray(leaf[:, np.asarray(pids)]))


@pytest.mark.parametrize("cache", [FP8, MIXED], ids=["fp8", "fp8-fp4frozen"])
def test_resume_restores_spilled_bytes(tiny_packed, cache):
    """After every resume the restored pages hold exactly the bytes that
    were spilled (a copy taken at preemption), behind the re-walked shared
    prefix, in pages the pool handed out anew."""
    _, _, tcfg, tparams = tiny_packed
    srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **COMMON, pool_pages=9 if cache is FP8 else 7, cache=tserve.CachePolicy(**cache),
        scheduler=tserve.SchedulerConfig(prefill_chunk_pages=2, steal_cooldown=1)),
        device="cpu")
    kept, checked = {}, []
    preempt, resume = srv._preempt, srv._resume

    def spy_preempt(slot):
        rid = srv.active[slot].rid
        preempt(slot)
        kept[rid] = [{k: a.copy() for k, a in part.items()} for part in srv.preempted[-1].payload]

    def spy_resume(slot, spill, shared_pids, need):
        resume(slot, spill, shared_pids, need)
        npg = tkvc.pages_needed(spill.ctx_len, srv.page_size)
        ids = torch.tensor(srv.slot_pages[slot][spill.shared_pages:npg])
        back = [tkvc.spill_pages(pool, ids) for pool in srv.pools]
        assert tkvc.payload_checksum(back) == spill.crc
        for part, want in zip(back, kept[spill.req.rid]):
            assert {k: a.tobytes() for k, a in part.items()} == \
                {k: a.tobytes() for k, a in want.items()}
        assert srv.slot_pages[slot][:spill.shared_pages] == shared_pids
        checked.append(spill.req.rid)

    srv._preempt, srv._resume = spy_preempt, spy_resume
    reqs = submit(tserve, srv, requests(tcfg.vocab_size))
    srv.run_until_drained()
    assert len(checked) >= 2 and all(r.status == "ok" for r in srv.finished)
    assert len(srv.finished) == len(reqs)


def test_steal_resume_streams_equal_ample_pool(tiny_packed):
    """repro's ``test_steal_resume_token_identity_mixed`` and
    ``test_fuzz_policy_transitions_steal_happy`` (``tests/test_fp4_cache.py``):
    FP8 pages with the FP4 frozen region on a pool that steals, stepped in
    lockstep with repro's Server. Three waves, each on a prefix of its own,
    arrive 8 steps apart while pages are stolen: the frozen region holds
    two prefixes, so the third wave reclaims the first one's pages, and
    spilled requests resume from bytes or fall back to a re-prefill. The
    first wave's streams equal those of the same wave on an ample pool."""
    waves = staggered_waves(tiny_packed[0].vocab_size)
    jsrv, strict, tsrv = servers(tiny_packed, "mixed", MIXED, 7, dict(steal_cooldown=1))
    serve_staggered(jsrv, tsrv, waves)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert all(r.status == "ok" and len(r.out) == r.max_new for r in tsrv.finished)
    assert st["fp4_frozen_pages"] >= 6 and st["prefix_reclaims"] >= 1, st
    assert st["preemptions"] >= 3 and st["resumes"] >= 1 and st["resume_fallbacks"] >= 1, st
    ample = tserve.Server(tsrv.params, tsrv.cfg, dataclasses.replace(tsrv.config, pool_pages=None),
                          device="cpu")
    submit(tserve, ample, waves[0])
    ample.run_until_drained()
    assert ample.stats["preemptions"] == 0
    first = {rid for rid, *_ in waves[0]}
    assert {r.rid: r.out for r in ample.finished} == \
        {r.rid: r.out for r in tsrv.finished if r.rid in first}
