"""Per-request fault isolation in the port's ``Server`` against repro's:
``FaultPlan`` injection, NaN quarantine in decode and in prefill (over GQA
and MLA latent pages), spill integrity, transient allocator faults,
``audit()`` and the strict and non-strict ends of a drain.

Served cases run both packages on the same tight pool, knobs, requests and
fault plan, stepped in lockstep (``test_torch_scheduler.lockstep``: equal
audits, refcounts and free lists after every step); the streams of the
requests no fault failed agree up to ties (``compare_streams``).
"""
import numpy as np
import pytest
import torch

from repro.runtime import faults as jfaults
from repro.runtime import serve as jserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import serve as tserve

from test_torch_mixed_engine import MIXED, _packed, release_compiled
from test_torch_scheduler import (FP8, _port_server, assert_same_outcome, assert_same_pool,
                                  lockstep, one_thread, requests, serve_staggered,
                                  servers, staggered_waves, submit)

POOL = 9  # every served case here shares one pool layout, so one set of compiled steps


@pytest.fixture(scope="module")
def tiny_packed():
    return _packed(2, traced=True)


def plans(**schedule):
    """The same schedule as (the reference's FaultPlan, the port's)."""
    return jfaults.FaultPlan(**schedule), tfaults.FaultPlan(**schedule)


@pytest.mark.parametrize("seed", [0, 1, 7, 23])
def test_fault_plan_seeded_matches_reference(seed):
    """Schedules, hooks and records equal to repro's: poisoned rows,
    blanked ticks, and the bytes a corrupted or dropped spill becomes."""
    jplan, tplan = (mod.FaultPlan.seeded(seed, slots=3, max_step=40, n_nan=3, n_corrupt=2,
                                         n_drop=1, n_alloc=2) for mod in (jfaults, tfaults))
    fields = ("seed", "nan_logits", "corrupt_spills", "drop_spills", "alloc_fail_ticks")
    assert {f: getattr(tplan, f) for f in fields} == {f: getattr(jplan, f) for f in fields}
    for step in range(45):
        np.testing.assert_array_equal(tplan.poison_rows(step, 3), jplan.poison_rows(step, 3))
        assert tplan.alloc_blocked(step) == jplan.alloc_blocked(step)
    rng = np.random.default_rng(seed)
    for rid in range(5):
        payload = [{"k": rng.integers(0, 256, (2, 3, 8, 2, 4), dtype=np.uint8),
                    "k_smax": rng.random((2, 3)).astype(np.float32),
                    "k_shift": rng.integers(-8, 8, (2, 3, 2)).astype(np.int32)}]
        copy = [{k: a.copy() for k, a in part.items()} for part in payload]
        got, want = tplan.spill_payload(rid, payload), jplan.spill_payload(rid, copy)
        assert [{k: a.tobytes() for k, a in p.items()} for p in got] == \
            [{k: a.tobytes() for k, a in p.items()} for p in want]
    for rec in ("corrupted_rids", "dropped_rids", "blocked_ticks"):
        assert getattr(tplan, rec) == getattr(jplan, rec), rec
    assert tplan.corrupted_rids == [0, 1] and tplan.dropped_rids == [2]
    assert len(tplan.blocked_ticks) == 2


def watch_scrubs(tsrv):
    """Records the private pages each quarantine scrubs; the returned
    ``on_step`` for ``lockstep`` checks, right after the failing step,
    that every active-class leaf holds zeros there."""
    scrubbed = []
    scrub = tsrv._scrub_slot

    def spy(slot, include_null=False):
        scrubbed.append(list(tsrv.slot_pages[slot][tsrv.slot_shared[slot]:]))
        scrub(slot, include_null)

    def on_step(tsrv, jsrv):
        if scrubbed and scrubbed[-1] is not None:
            ids = scrubbed[-1]
            for pool in tsrv.pools:
                for name, leaf in pool.items():
                    if "_fz" not in name and leaf.numel():
                        assert not leaf[:, ids].any(), name
            scrubbed.append(None)

    tsrv._scrub_slot = spy
    return scrubbed, on_step


def test_decode_nan_and_alloc_faults_match_reference(tiny_packed):
    """A NaN poisoned into one decoding row fails that request alone (the
    same rid as repro's, its private pages zeroed), and two blanked
    allocator ticks are absorbed, on a pool that steals: every other
    request ends ok, its stream by ``compare_streams``."""
    jplan, tplan = plans(nan_logits=((9, 1),), alloc_fail_ticks=(3, 4))
    jsrv, strict, tsrv = servers(tiny_packed, "mixed", FP8, POOL, dict(steal_cooldown=1),
                                 faults=(jplan, tplan))
    reqs = requests(tiny_packed[0].vocab_size)
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    scrubbed, pages_zero = watch_scrubs(tsrv)
    lockstep(jsrv, tsrv, pages_zero)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    assert tplan.nan_hits == jplan.nan_hits and len(tplan.nan_hits) == 1
    assert tplan.blocked_ticks == jplan.blocked_ticks == [3, 4]
    (_, slot, rid), = tplan.nan_hits
    failed = {r.rid for r in tsrv.finished if r.status == "failed"}
    assert failed == {rid} and tsrv.stats["failed"] == 1
    assert "non-finite logits at decode step 9" in next(r.error for r in tsrv.finished
                                                       if r.rid == rid)
    assert scrubbed[0] and scrubbed[-1] is None
    assert tsrv.stats["preemptions"] >= 1
    assert all(r.status == "ok" and len(r.out) == r.max_new
               for r in tsrv.finished if r.rid != rid)
    assert sorted(tsrv.free_pages + tsrv.reusable_pages) == list(range(tsrv._n_pages))


def test_mla_latent_spill_and_quarantine_match_reference():
    """MLA latent pages (dense random weights, FP8 pages) on a pool that
    steals: each spill carries c_kv, the rope key and their scales with no
    head axis, the second spill's flipped byte fails its CRC and its
    request re-prefills, a NaN row fails its request alone with its latent
    pages zeroed, and everything matches repro's."""
    from test_torch_mla import MLA_CFG, _model

    jplan, tplan = plans(nan_logits=((32, 1),), corrupt_spills=(1,))
    jsrv, strict, tsrv = servers(_model(MLA_CFG, False, 2), "mixed", FP8, 7,
                                 dict(steal_cooldown=1), faults=(jplan, tplan))
    reqs = requests(MLA_CFG.vocab_size, n=4, max_new=16, priority=lambda rid: 0)
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    scrubbed, pages_zero = watch_scrubs(tsrv)
    spills = []

    def on_step(tsrv, jsrv):
        pages_zero(tsrv, jsrv)
        for tsp, jsp in zip(tsrv.preempted, jsrv.preempted):
            (part,), (jpart,) = tsp.payload, jsp.payload
            assert sorted(part) == ["ckv", "ckv_shift", "ckv_smax", "krope", "krope_shift",
                                    "krope_smax"]
            assert {k: (a.shape, a.dtype) for k, a in part.items()} == \
                {k: (a.shape, a.dtype) for k, a in jpart.items()}
            assert part["ckv"].ndim == 4  # (layers, pages, page, r): no head axis
            spills.append(tsp.nbytes)

    lockstep(jsrv, tsrv, on_step)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert st["preemptions"] >= 2 and st["resumes"] >= 1 and spills
    assert st["spill_integrity_failures"] == 1 and tplan.corrupted_rids == jplan.corrupted_rids
    assert tplan.nan_hits == jplan.nan_hits and len(tplan.nan_hits) == 1
    assert {r.rid for r in tsrv.finished if r.status == "failed"} == {tplan.nan_hits[0][2]}
    assert scrubbed[0] and scrubbed[-1] is None


def test_nonfinite_prefill_fails_only_its_request(tiny_packed):
    """repro's ``test_prefill_nonfinite_fails_request_not_process``: one
    learned position poisoned to NaN, so only a context reaching it goes
    non-finite, through the real forward. That request fails with no
    token and no registered page; the null page its padded chunk wrote is
    zeroed, so a later request decodes clean."""
    jcfg, jparams, tcfg, tparams = tiny_packed
    jbad = dict(jparams)
    pos = np.array(jbad["pos_embed"])
    pos[5] = np.nan
    jbad["pos_embed"] = pos
    tbad = dict(tparams)
    tbad["pos_embed"] = tparams["pos_embed"].clone()
    tbad["pos_embed"][5] = float("nan")
    jsrv, strict, tsrv = servers((jcfg, jbad, tcfg, tbad), "mixed", FP8, POOL)
    reqs = [(0, [13, 14, 15], 2, 0), (1, [3, 4, 5, 6, 8, 9, 10, 11, 12], 4, 0)]
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv)
    for pool in tsrv.pools:
        for name, leaf in pool.items():
            if "_fz" not in name and leaf.numel():
                assert torch.isfinite(leaf.float()).all() and not leaf[:, tsrv._null_page].any()
    submit(jserve, jsrv, [(2, [16, 17, 18], 2, 0)])
    submit(tserve, tsrv, [(2, [16, 17, 18], 2, 0)])
    lockstep(jsrv, tsrv)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    bad = next(r for r in tsrv.finished if r.rid == 1)
    assert bad.status == "failed" and "prefill" in bad.error and bad.out == []
    assert [r.status for r in tsrv.finished if r.rid != 1] == ["ok", "ok"]
    assert len(tsrv._prefix) == 0  # nothing of the failed prompt was registered


@pytest.mark.parametrize("mode", ["corrupt", "drop"])
def test_tampered_spill_reprefills(tiny_packed, mode):
    """A spill with one byte flipped, or zeroed, fails its CRC at resume:
    the request re-prefills its tail and still finishes, as in repro."""
    jplan, tplan = plans(**{f"{mode}_spills": (0,)})
    jsrv, strict, tsrv = servers(tiny_packed, "mixed", FP8, POOL, dict(steal_cooldown=1),
                                 faults=(jplan, tplan))
    reqs = requests(tiny_packed[0].vocab_size)
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert st["spill_integrity_failures"] == 1 and st["spill_evictions"] >= 1
    assert st["resumes"] >= 1  # the untampered spill resumes from its bytes
    tampered = tplan.corrupted_rids if mode == "corrupt" else tplan.dropped_rids
    assert tampered == (jplan.corrupted_rids if mode == "corrupt" else jplan.dropped_rids)
    assert len(tampered) == 1
    assert all(r.status == "ok" and len(r.out) == r.max_new for r in tsrv.finished)


def test_alternating_frozen_waves_with_faults_match_reference(tiny_packed):
    """The alternating engine over FP8 pages and the FP4 frozen region, on
    a pool that steals while staggered waves reclaim frozen prefixes
    (``test_torch_scheduler.serve_staggered``), with a NaN row, a blanked
    allocator tick and the first spill's bytes flipped: stepped in
    lockstep with repro's Server, only the poisoned request fails, its
    private pages zeroed, the flipped spill fails its CRC and re-prefills,
    and everything else matches."""
    jplan, tplan = plans(nan_logits=((40, 1),), alloc_fail_ticks=(20,), corrupt_spills=(0,))
    jsrv, strict, tsrv = servers(tiny_packed, "alternating", MIXED, 7, dict(steal_cooldown=1),
                                 faults=(jplan, tplan))
    scrubbed, pages_zero = watch_scrubs(tsrv)
    serve_staggered(jsrv, tsrv, staggered_waves(tiny_packed[0].vocab_size), on_step=pages_zero)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert st["fp4_frozen_pages"] >= 6 and st["prefix_reclaims"] >= 1, st
    assert st["preemptions"] >= 3 and st["resumes"] >= 1 and st["resume_fallbacks"] >= 1, st
    assert st["spill_integrity_failures"] == 1 and tplan.corrupted_rids == jplan.corrupted_rids
    assert tplan.nan_hits == jplan.nan_hits and len(tplan.nan_hits) == 1
    assert tplan.blocked_ticks == jplan.blocked_ticks == [20]
    assert {r.rid for r in tsrv.finished if r.status == "failed"} == {tplan.nan_hits[0][2]}
    assert scrubbed[0] and scrubbed[-1] is None
    assert len(tsrv.finished) == 18 and tsrv._spill_bytes == 0 and (tsrv.page_refs == 0).all()


def test_blocked_idle_tick_is_not_starvation(tiny_packed):
    """A tick whose allocator is blanked admits nothing; with nothing
    running that is not starvation, and the next tick proceeds."""
    _, _, tcfg, tparams = tiny_packed
    plan = tfaults.FaultPlan(alloc_fail_ticks=(1,))
    srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        slots=2, max_seq=32, page_size=4, a_fmt=None, cache=tserve.CachePolicy(**FP8)),
        device="cpu", faults=plan)
    r = tserve.Request(rid=0, prompt=[3, 4, 5], max_new=4)
    srv.submit(r)
    srv.run_until_drained()
    assert r.status == "ok" and len(r.out) == 4
    assert plan.blocked_ticks == [1]


def test_audit_matches_reference(tiny_packed):
    """On the same served state the clean summaries are equal, and each
    seeded corruption raises ``PoolCorruptionError`` with repro's own
    violation strings: a refcount off by one, a mapped page also on the
    free list, a page freed twice, a page leaked."""
    jsrv, _, tsrv = servers(tiny_packed, "mixed", FP8, POOL)
    reqs = requests(tiny_packed[0].vocab_size, n=2)
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    for _ in range(3):
        assert tsrv.step() and jsrv.step()
    summary = tsrv.audit()
    assert summary == jsrv.audit()
    assert summary["active"] == 2 and summary["pages_mapped"] == 6
    pid, free = tsrv.slot_pages[0][-1], tsrv.free_pages[0]

    def corrupt(srv, kind, undo=False):
        step = -1 if undo else 1
        if kind == "refcount":
            srv.page_refs[pid] += step
        elif kind == "mapped and free":
            srv.free_pages.pop() if undo else srv.free_pages.append(pid)
        elif kind == "double free":
            srv.free_pages.pop() if undo else srv.free_pages.append(free)
        elif undo:  # leak
            srv.free_pages.insert(0, free)
        else:
            srv.free_pages.remove(free)

    for kind, says in (("refcount", "refcount"), ("mapped and free", "both mapped and free"),
                       ("double free", "double-freed"), ("leak", "leaked")):
        errs = []
        for srv, exc in ((tsrv, tfaults.PoolCorruptionError),
                         (jsrv, jfaults.PoolCorruptionError)):
            corrupt(srv, kind)
            with pytest.raises(exc) as ei:
                srv.audit()
            corrupt(srv, kind, undo=True)
            errs.append(ei.value)
        assert errs[0].violations == errs[1].violations
        assert any(says in v for v in errs[0].violations), errs[0].violations
        assert str(errs[0]) == str(errs[1])
        assert {k: errs[0].dump[k] for k in errs[0].dump} == \
            {k: errs[1].dump[k] for k in errs[0].dump}
    assert_same_pool(tsrv, jsrv)
    assert tsrv.audit() == jsrv.audit()


def test_audit_every_runs_inside_step(tiny_packed):
    _, _, tcfg, tparams = tiny_packed
    srv = _port_server(tcfg, tparams, slots=2, audit_every=1, cache=tserve.CachePolicy(**FP8))
    srv.submit(tserve.Request(rid=0, prompt=[3, 4, 5, 6, 7], max_new=8))
    srv.step()
    srv.page_refs[srv.slot_pages[0][0]] += 1
    with pytest.raises(tserve.PoolCorruptionError, match="refcount"):
        srv.step()


def _starve(tiny_packed, strict):
    """A finishes while B sits spilled against a pool that never recovers
    (repro's ``TestStrictness._starve``)."""
    _, _, tcfg, tparams = tiny_packed
    rng = np.random.default_rng(5)
    srv = _port_server(tcfg, tparams, slots=2, pool_pages=8, strict=strict, prefix_cache=False,
                       cache=tserve.CachePolicy(**FP8))
    a = tserve.Request(rid=0, prompt=rng.integers(1, 64, 3).tolist(), max_new=6)
    b = tserve.Request(rid=1, prompt=rng.integers(1, 64, 9).tolist(), max_new=6)
    srv.submit(a)
    srv.submit(b)
    srv.step()
    srv._preempt(srv.active.index(b))
    srv.free_pages.clear()
    return srv, a, b


def test_strict_starvation_raises_with_partial_results(tiny_packed):
    srv, a, b = _starve(tiny_packed, strict=True)
    with pytest.raises(tserve.ServingError, match="starved") as ei:
        srv.run_until_drained()
    assert isinstance(ei.value, RuntimeError)
    assert [r.rid for r in ei.value.finished] == [a.rid] and ei.value.finished[0].ok
    assert len(a.out) == 6
    (diag,) = ei.value.pending
    assert diag["rid"] == b.rid and diag["state"] == "spilled" and diag["pages_needed"] > 0


def test_non_strict_fails_pending_one_by_one(tiny_packed):
    srv, a, b = _starve(tiny_packed, strict=False)
    done = srv.run_until_drained()
    assert {r.rid for r in done} == {a.rid, b.rid}
    assert a.status == "ok" and len(a.out) == 6
    assert b.status == "failed" and "starved" in b.error
    assert srv.stats["failed"] == 1 and not srv.preempted and srv._spill_bytes == 0


def test_max_steps_attaches_diagnostics(tiny_packed):
    _, _, tcfg, tparams = tiny_packed
    srv = _port_server(tcfg, tparams, slots=2, cache=tserve.CachePolicy(**FP8))
    r = tserve.Request(rid=0, prompt=[3, 4, 5], max_new=20)
    srv.submit(r)
    with pytest.raises(tserve.ServingError, match="max_steps") as ei:
        srv.run_until_drained(max_steps=3)
    (diag,) = ei.value.pending
    assert diag["rid"] == 0 and diag["state"] == "active" and diag["out_tokens"] == len(r.out) > 0


def test_truncated_and_failed_stay_distinct(tiny_packed):
    _, _, tcfg, tparams = tiny_packed
    srv = _port_server(tcfg, tparams, slots=1, max_seq=16, cache=tserve.CachePolicy())
    r = tserve.Request(rid=0, prompt=[5, 6, 7, 8, 9], max_new=50)
    srv.submit(r)
    (res,) = srv.run_until_drained()
    assert res.truncated and res.status == "truncated" and res.error is None
    assert len(res.tokens) == (16 - 1) - 5 + 1
    assert srv.stats["truncated"] == 1 and srv.stats["failed"] == 0
