"""The recurrent families served by the port's ``Server`` over state slabs,
in lockstep with repro's: xlstm-125m (slabs only) and zamba2-1.2b (a Mamba2
slab pool and pages for its shared attention block) at their SMOKE
configs, random weights packed to W4A8 by repro's ``quantize_tree``.

Served cases run the reference ``Server`` (strictly compiled, its ``ref``
kernels: ``StrictReference``) and the port's on the CPU with the same
pools, knobs and requests, stepped in lockstep
(``test_torch_scheduler.lockstep``: equal audits, refcounts and free lists
after every step, and here equal slab ownership); the streams agree up to
ties (``compare_streams``). On a slab-starved pool the port's streams are
bit-identical to its fully backed run: slab state is restored exactly. The
ports of repro's slab tests (``test_scheduler.py::TestStateSlabs``,
``test_faults.py::test_failed_recurrent_request_frees_slab``) keep their
names. Prompts take two lengths, 5 and 9 tokens (chunks of 5, and 8 + 1:
a one-token chunk takes the recurrent step), so few reference programs
compile."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.runtime import faults as jfaults
from repro.runtime import kv_cache as jkvc
from repro.runtime import serve as jserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import serve as tserve

from test_torch_bridge import t
from test_torch_mixed_engine import MIXED, release_compiled  # noqa: F401
from test_torch_recurrent import NAMES, model
from test_torch_scheduler import (FP8, assert_same_outcome, lockstep, one_thread,  # noqa: F401
                                  servers, submit)

# every lockstep case shares one pool layout: 3 slots, 2 slabs, pages of 4
# (Zamba2: 24 of them, fully backed), chunks of 8 tokens
SLAB = dict(max_seq=32, page_size=4, pool_slabs=2)
LENGTHS = (5, 9)


def traffic(vocab, n, seed, max_new=(2, 5, 8), priority=lambda rid: rid % 3):
    """``n`` requests (rid, prompt, max_new, priority) over the two prompt
    lengths."""
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(1, vocab, LENGTHS[rid % 2]).tolist(),
             max_new[rid % len(max_new)], priority(rid)) for rid in range(n)]


def pair(name, sched=(), faults=(None, None), **config):
    """(reference Server, its StrictReference, the port's Server) of
    ``name`` on the shared slab layout, the mixed engine asked for."""
    return servers(model(name, True), "mixed", FP8, None, dict(sched), faults,
                   **{**SLAB, **config})


def same_slabs(tsrv, jsrv):
    assert tsrv.slot_slab == jsrv.slot_slab and tsrv.free_slabs == jsrv.free_slabs
    np.testing.assert_array_equal(tsrv.slab_table, jsrv.slab_table)


def solo(name, reqs, **config):
    """The port alone, fully backed (one slab a slot), on the lockstep
    cases' FP8 pages: {rid: tokens}."""
    _, _, tcfg, tparams = model(name, True)
    srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        slots=3, a_fmt="fp8_e4m3", cache=tserve.CachePolicy(**FP8),
        **{**SLAB, "pool_slabs": None, **config},
        scheduler=tserve.SchedulerConfig(prefill_chunk_pages=2)), device="cpu")
    submit(tserve, srv, reqs)
    return {r.rid: r.tokens for r in srv.run_until_drained()}


def unit_bytes(payload):
    """A spill payload as [(leaf name, dtype, shape, bytes)] a unit."""
    return [[(k, str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes())
             for k, a in sorted(part.items())] for part in payload]


@pytest.mark.parametrize("name", NAMES)
def test_slab_fuzz_steal_resume_bit_identity(name):
    """repro's seeded fuzz on a slab-starved pool (3 slots, 2 slabs,
    priorities 0-2, a request submitted every other step) in both packages
    at once: equal audits, pools and slab tables after every step, the
    mixed engine resolved to alternating in both, every counter equal, the
    streams up to ties; at least one steal and one resume. Every spill's
    payload has the reference's units, leaf names, dtypes and shapes, and
    the port's checksum of the reference's bytes is the reference's CRC.
    Then each of the port's streams equals its fully backed run bit for
    bit: the restored slab state is exact."""
    jsrv, strict, tsrv = pair(name, dict(steal_cooldown=1))
    assert tsrv.engine == jsrv.engine == "alternating"
    assert tsrv._prefix is None and jsrv._prefix is None
    spills = {"j": [], "t": []}
    for key, srv in (("j", jsrv), ("t", tsrv)):
        preempt = srv._preempt

        def spy(slot, srv=srv, preempt=preempt, key=key):
            preempt(slot)
            spills[key].append(srv.preempted[-1])
        srv._preempt = spy
    reqs = traffic(model(name, True)[0].vocab_size, 7, seed=13)
    pending = list(reqs)
    for step in range(300):
        if pending and step % 2 == 0:
            submit(jserve, jsrv, [pending[0]])
            submit(tserve, tsrv, [pending.pop(0)])
        went = tsrv.step()
        assert jsrv.step() == went
        assert tsrv.audit() == jsrv.audit()
        same_slabs(tsrv, jsrv)
        if not went and not pending and not tsrv.queue and not tsrv.preempted:
            break
    ties = assert_same_outcome(tsrv, jsrv, strict)
    assert len(ties) <= 1, ties
    st = tsrv.stats
    assert st["preemptions"] >= 1 and st["resumes"] >= 1, st
    assert sorted(tsrv.free_slabs) == list(range(tsrv._n_slabs))
    assert [sp.req.rid for sp in spills["t"]] == [sp.req.rid for sp in spills["j"]]
    for tsp, jsp in zip(spills["t"], spills["j"]):
        meta = lambda sp: [[row[:3] for row in part] for part in unit_bytes(sp.payload)]
        assert meta(tsp) == meta(jsp)
        assert tkvc.payload_checksum(jsp.payload) == jsp.crc == jkvc.payload_checksum(jsp.payload)
    full = solo(name, reqs)
    assert {r.rid: r.tokens for r in (q.result() for q in tsrv.finished)} == full


@pytest.mark.parametrize("name", NAMES)
def test_spill_payload_matches_reference_byte_for_byte(name):
    """Two requests a few steps in; the reference's pools are copied into
    the port's, and both steal rid 0: the port's spill is the reference's
    byte for byte, unit by unit (the hybrid's Mamba2 slab then its shared
    attention pages; xLSTM's mLSTM then sLSTM slabs), under the same CRC.
    Both then drain in lockstep, the resume restoring those bytes."""
    jsrv, strict, tsrv = pair(name)
    reqs = traffic(model(name, True)[0].vocab_size, 2, seed=3, max_new=(6,))
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv, steps=3)
    for (tpool, kind), (path, jkind) in zip(tsrv._units, jsrv._units):
        assert kind == jkind
        for leaf_name, leaf in tpool.items():
            leaf.copy_(t(np.asarray(jsrv._unit(path)[leaf_name])).to(leaf.dtype))
    for srv in (tsrv, jsrv):
        srv._preempt(srv.active.index(next(r for r in srv.active if r and r.rid == 0)))
    tsp, jsp = tsrv.preempted[0], jsrv.preempted[0]
    assert unit_bytes(tsp.payload) == unit_bytes(jsp.payload)
    assert tsp.crc == jsp.crc and tsp.nbytes == jsp.nbytes
    lockstep(jsrv, tsrv)
    assert tsrv.stats["resumes"] == 1
    assert not assert_same_outcome(tsrv, jsrv, strict)


def test_priority_slab_steal_under_zero_budget_loses_nothing():
    """repro's regression in both packages: with both slabs taken by
    priority-0 requests, a priority-1 arrival steals one mid-admission, and
    the zero spill budget evicts the victim into the queue at the next
    step's start; everything finishes, the victim re-prefilled, every
    stream equal to the port's uncontended run."""
    name = "xlstm-125m"
    jsrv, strict, tsrv = pair(name, dict(spill_budget_bytes=0, steal_cooldown=0))
    vocab = model(name, True)[0].vocab_size
    reqs = traffic(vocab, 3, seed=1, max_new=(8, 8, 4), priority=lambda rid: int(rid == 2))
    submit(jserve, jsrv, reqs[:2])
    submit(tserve, tsrv, reqs[:2])
    lockstep(jsrv, tsrv, steps=1)
    submit(jserve, jsrv, reqs[2:])
    submit(tserve, tsrv, reqs[2:])
    lockstep(jsrv, tsrv, on_step=same_slabs)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert st["preemptions"] >= 1 and st["spill_evictions"] >= 1
    assert all(r.done and r.status == "ok" for r in tsrv.finished) and len(tsrv.finished) == 3
    assert {r.rid: r.result().tokens for r in tsrv.finished} == solo(name, reqs)


def test_reserve_scheduler_never_slab_steals():
    """repro's regression in both packages: under reserve-on-admit a
    priority-1 arrival waits for a slab to retire, it does not steal."""
    name = "xlstm-125m"
    jsrv, strict, tsrv = pair(name, dict(policy="reserve", steal_cooldown=0))
    reqs = traffic(model(name, True)[0].vocab_size, 3, seed=5, max_new=(6, 6, 4),
                   priority=lambda rid: int(rid == 2))
    submit(jserve, jsrv, reqs[:2])
    submit(tserve, tsrv, reqs[:2])
    lockstep(jsrv, tsrv, steps=1)
    submit(jserve, jsrv, reqs[2:])
    submit(tserve, tsrv, reqs[2:])
    lockstep(jsrv, tsrv, on_step=same_slabs)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    assert tsrv.stats["preemptions"] == 0 and len(tsrv.finished) == 3


def test_xlstm_stream_matches_full_prefill():
    """A 13-token prompt streamed in chunks of 8 and 5 carries the (c, n, m)
    and conv state across them: its first token is the argmax of the port's
    cache-free forward over the whole prompt (the reference compares with
    its one-shot prefill), and the reference's served token."""
    from repro_torch.models import api, transformer

    name = "xlstm-125m"
    _, _, tcfg, tparams = model(name, True)
    prompt = np.random.default_rng(2).integers(1, tcfg.vocab_size, 13).tolist()
    jsrv, strict, tsrv = pair(name)
    reqs = [(0, prompt, 1, 0)]
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv)
    assert tsrv.prefill_traces == jsrv.prefill_traces == {(8, 1), (5, 1)}
    hidden = api.forward_hidden(tparams, tcfg, {"tokens": torch.tensor([prompt])},
                                a_fmt="fp8_e4m3")[0]
    logits = transformer.lm_logits(tparams, tcfg, hidden[:, -1])
    assert tsrv.finished[0].out[0] == jsrv.finished[0].out[0] == int(logits.argmax())


def test_failed_recurrent_request_frees_slab():
    """repro's slab accounting for a quarantined recurrent request, in both
    packages: a NaN logits row at decode step 2 fails rid 0 alone; its slab
    is scrubbed to zeros and freed, the other request finishes ok with the
    stream of its uncontended run, and every slab is free at the end."""
    name = "xlstm-125m"
    plan = dict(nan_logits=((2, 0),))
    jsrv, strict, tsrv = pair(name, faults=(jfaults.FaultPlan(**plan),
                                            tfaults.FaultPlan(**plan)))
    reqs = traffic(model(name, True)[0].vocab_size, 2, seed=3, max_new=(8, 6))
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    scrubbed = []
    scrub = tsrv._scrub_slot

    def spy(slot, include_null=False):
        sid = tsrv.slot_slab[slot]
        scrub(slot, include_null)
        scrubbed.append([bool((leaf[:, sid] == 0).all()) for pool in tsrv._unit_pools("slab")
                         for leaf in pool.values()])
    tsrv._scrub_slot = spy
    lockstep(jsrv, tsrv, on_step=same_slabs)
    status = {r.rid: r.status for r in tsrv.finished}
    assert status == {0: "failed", 1: "ok"} and tsrv.faults.nan_hits[0][2] == 0
    assert scrubbed == [[True] * 8]
    assert sorted(tsrv.free_slabs) == list(range(tsrv._n_slabs))
    assert tsrv.audit()["violations"] == 0
    ties = assert_same_outcome(tsrv, jsrv, strict)
    assert not ties
    assert tsrv.finished[1].out == list(solo(name, reqs[1:])[1])


@pytest.mark.parametrize("name", NAMES)
def test_recycled_slab_is_reset_to_the_pristine_state(name):
    """One slot, one slab: rid 0 runs and retires, leaving its state in the
    slab; rid 1's admission resets the slab to the pristine state (mLSTM's
    m at -1e30, sLSTM's n at 1, Mamba2's zeros), and rid 1's logits (every
    program's) and stream equal its run on a fresh server bit for bit.
    Admitted without the reset, rid 1's first logits differ: the check can
    see a leftover state (Zamba2's random Mamba2 layers forget it within a
    few tokens, so its stream need not change)."""
    _, _, tcfg, tparams = model(name, True)
    reqs = traffic(tcfg.vocab_size, 2, seed=7, max_new=(6,))

    def serve(reset, reqs):
        srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
            slots=1, a_fmt="fp8_e4m3", cache=tserve.CachePolicy(**FP8),
            **{**SLAB, "pool_slabs": 1},
            scheduler=tserve.SchedulerConfig(prefill_chunk_pages=2)), device="cpu")
        alloc, run = srv._alloc_slab, srv._run
        seen, logits = [], {}

        def spy(slot, reset_slab=True):
            leftover = [leaf[:, 0].clone() for pool in srv._unit_pools("slab")
                        for leaf in pool.values()]
            sid = alloc(slot, reset_slab and reset)
            now = [leaf[:, sid].clone() for pool in srv._unit_pools("slab")
                   for leaf in pool.values()]
            init = [v[:, 0] for ui in sorted(srv._slab_init)
                    for v in srv._slab_init[ui].values()]
            seen.append((leftover, now, init))
            return sid

        def record(tokens, state, pmask=None):
            out = run(tokens, state, pmask)
            logits.setdefault(srv.active[0].rid, []).append(out.clone())
            return out
        srv._alloc_slab, srv._run = spy, record
        submit(tserve, srv, reqs)
        return {r.rid: r.tokens for r in srv.run_until_drained()}, seen, logits

    fresh, _, fresh_logits = serve(True, reqs[1:])
    out, seen, logits = serve(True, reqs)
    assert out[1] == fresh[1]
    assert all(torch.equal(a, b) for a, b in zip(logits[1], fresh_logits[1]))
    leftover, now, init = seen[1]
    assert all(torch.equal(a, b) for a, b in zip(now, init))
    assert not all(torch.equal(a, b) for a, b in zip(leftover, init))
    if name == "xlstm-125m":
        assert float(init[2].max()) == float(np.float32(-1e30))  # mLSTM's m
        assert bool((init[5] == 1).all())  # sLSTM's n
    _, _, faulty = serve(False, reqs)
    assert not torch.equal(faulty[1][0], fresh_logits[1][0])


def test_audit_counts_slabs_and_catches_their_violations():
    """``audit()`` counts owned and free slabs as the reference's does, and
    raises on a slab owned twice, a slab leaked from the free list, and a
    slab table that does not mirror ownership."""
    name = "zamba2-1.2b"
    jsrv, strict, tsrv = pair(name)
    reqs = traffic(model(name, True)[0].vocab_size, 2, seed=9, max_new=(4,))
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv, steps=2)
    summary = tsrv.audit()
    assert summary == jsrv.audit()
    assert (summary["slabs_owned"], summary["slabs_free"]) == (2, 0)
    assert summary["pages_mapped"] == 7  # 5 and 9 tokens' pages and a headroom page each
    snapshot = (list(tsrv.slot_slab), list(tsrv.free_slabs), tsrv.slab_table.copy())
    for corrupt, match in ((lambda s: s.slot_slab.__setitem__(1, s.slot_slab[0]), "double-owned"),
                           (lambda s: s.free_slabs.append(0), "leaked"),
                           (lambda s: s.slab_table.__setitem__(0, s._n_slabs), "slab table")):
        corrupt(tsrv)
        with pytest.raises(tserve.PoolCorruptionError, match=match):
            tsrv.audit()
        tsrv.slot_slab, tsrv.free_slabs, tsrv.slab_table = (
            list(snapshot[0]), list(snapshot[1]), snapshot[2].copy())
    assert tsrv.audit() == summary


def test_refusals_match_the_reference():
    """What repro refuses for the recurrent families, the port refuses: a
    mixed-precision policy (FP4 frozen pages live only under a prefix cache,
    which recurrent state cannot use)."""
    for name in NAMES:
        jcfg, jparams, tcfg, tparams = model(name, True)
        with pytest.raises(ValueError, match="prefix cache"):
            jserve.Server(jparams, jcfg, jserve.ServerConfig(
                slots=2, cache=jserve.CachePolicy(**MIXED), **SLAB))
        with pytest.raises(ValueError, match="prefix cache"):
            tserve.Server(tparams, tcfg, tserve.ServerConfig(
                slots=2, cache=tserve.CachePolicy(**MIXED), **SLAB), device="cpu")


def test_server_config_carries_pool_slabs():
    fields = lambda cls: {f.name: f.default for f in dataclasses.fields(cls)}
    assert fields(tserve.ServerConfig)["pool_slabs"] == fields(jserve.ServerConfig)["pool_slabs"]
