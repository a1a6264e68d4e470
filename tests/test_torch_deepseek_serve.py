"""Served streams of DeepSeek-V3 in the port against the JAX ``Server``
(``compare_streams``), on ``test_torch_deepseek.DS_CFG`` packed: MLA latent
pages in two segments (a dense and an MoE layer, a latent pool each), every
projection through the W4A8 plain version, the experts through the batched
one with FP8 activations, routed per token. The MTP block rides in the
params and no served step reads it.

* The reference's default path: the mixed engine, the prefix cache, FP8
  pages with an FP4 frozen region, two waves on one 2-page prefix.
* A page-starved pool on the token budget: steals, spills and resumes,
  each spill's parts in the reference's unit order (segment 0's latent
  pool, then segment 1's) under the same CRC, audits equal after every
  step (``test_torch_scheduler.lockstep``).

Both runs share one pool layout and two prompt lengths, so the reference
compiles few programs."""
import numpy as np
import pytest

from repro.runtime import serve as jserve
from repro_torch.runtime import serve as tserve

from test_torch_deepseek import DS_CFG, model
from test_torch_mixed_engine import MIXED, STATS, release_compiled  # noqa: F401
from test_torch_scheduler import (assert_same_outcome, lockstep, one_thread,  # noqa: F401
                                  servers, submit)

POOL = 12  # active pages: both runs share one pool layout, so one set of compiled steps


def _ds():
    """Random weights from seed 1, packed: varied greedy streams."""
    return model(DS_CFG, True, seed=1)


def _requests(rng, prefix, rids, max_new, priority=lambda rid: 0):
    """(rid, prompt, max_new, priority): ``prefix`` plus a tail of 5 or 7
    tokens (prompts of two lengths, whose tail chunks share one bucket)."""
    return [(rid, prefix + rng.integers(1, DS_CFG.vocab_size, size=(5, 7)[rid % 2]).tolist(),
             max_new, priority(rid)) for rid in rids]


def test_streams_match_jax_server():
    """Two waves of 3 on one 2-page prefix, 6 new tokens each: the first
    registers and freezes the prefix, the rest hit it, nothing is stolen.
    Both servers stepped in lockstep (audits and pools equal after every
    step); streams, counters and the cache residency equal, no tie."""
    jsrv, strict, tsrv = servers(_ds(), "mixed", MIXED, POOL)
    assert tsrv.engine == jsrv.engine == "mixed"
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, DS_CFG.vocab_size, size=16).tolist()
    for w in range(2):
        wave = _requests(rng, prefix, range(3 * w, 3 * w + 3), 6)
        submit(jserve, jsrv, wave)
        submit(tserve, tsrv, wave)
        lockstep(jsrv, tsrv)
    assert not assert_same_outcome(tsrv, jsrv, strict)
    st = tsrv.stats
    assert st["preemptions"] == 0 and {k: st[k] for k in STATS} == {k: jsrv.stats[k] for k in STATS}
    assert tsrv.prefill_traces == jsrv.prefill_traces
    assert tsrv.cache_residency() == pytest.approx(jsrv.cache_residency())
    assert len(tsrv.pools) == 2 and [p["ckv"].shape[0] for p in tsrv.pools] == [1, 1]
    assert st["prefix_hit_pages"] >= 2 * 4 and st["fp4_frozen_pages"] >= 2
    assert len({tok for r in tsrv.finished for tok in r.out}) > 3  # streams vary


def test_starved_pool_steals_spills_and_resumes_as_reference():
    """6 requests at once (the 2-page prefix, tails of 5 and 7 tokens, 30
    new tokens; rids 0 and 3 at priority 1) on the same pool: the port and
    the reference steal, spill and resume alike, every spill's CRC, byte
    count and parts (a latent pool a segment, in segment order) equal to
    the reference's, the audits and pools equal after every step, and the
    streams equal up to ties (``compare_streams``)."""
    jsrv, strict, tsrv = servers(_ds(), "mixed", MIXED, POOL, dict(steal_cooldown=1))
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, DS_CFG.vocab_size, size=16).tolist()
    reqs = _requests(rng, prefix, range(6), 30, priority=lambda rid: int(rid % 3 == 0))
    submit(jserve, jsrv, reqs)
    submit(tserve, tsrv, reqs)
    crcs = []

    def on_step(tsrv, jsrv):
        for tsp, jsp in zip(tsrv.preempted, jsrv.preempted):
            assert (tsp.req.rid, tsp.crc, tsp.nbytes) == (jsp.req.rid, jsp.crc, jsp.nbytes)
            assert len(tsp.payload) == len(jsp.payload) == 2  # a latent pool a segment
            for part, jpart in zip(tsp.payload, jsp.payload):
                assert {k: (a.shape, a.dtype) for k, a in part.items()} == \
                    {k: (a.shape, a.dtype) for k, a in jpart.items()}
            crcs.append(tsp.crc)

    lockstep(jsrv, tsrv, on_step)
    ties = assert_same_outcome(tsrv, jsrv, strict)
    assert len(ties) <= 1, ties
    st = tsrv.stats
    assert st["preemptions"] >= 1 and st["resumes"] >= 1 and crcs, st
    assert all(r.status == "ok" and len(r.out) == r.max_new for r in tsrv.finished)
    assert tsrv._spill_bytes == 0 and (tsrv.page_refs == 0).all()
