"""The port's asyncio front-end and the rest of its ``Server`` API, on the CPU.

``AsyncServer`` and ``serve_http`` over the port's ``Server`` (the cases of
``tests/test_frontend.py``): per-request streams equal the synchronous
engine's, late submissions join the running batch, terminal events carry
the outcome, and the stdlib endpoint speaks the OpenAI-completions shape
on loopback. Then against repro's ``Server`` (strictly compiled,
``StrictReference``) on the same traffic, on both engines, with a prefill
token budget of 64 (not the default): the ``TokenEvent`` stream (order,
indices, tokens, terminal statuses ok / truncated / failed), the chunk
shapes, ``utilization``, ``engine_utilization`` and the bytes-per-token
readers, and ``RequestResult.ttft`` / ``itl``.
"""
import asyncio
import json

import numpy as np
import pytest

from repro.runtime import faults as jfaults
from repro.runtime import serve as jserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.frontend import AsyncServer, serve_http

from test_torch_mixed_engine import StrictReference, _packed, compare_streams, release_compiled
from test_torch_sampling import _step_and_sampled_gap
from test_torch_scheduler import FP8, one_thread


@pytest.fixture(scope="module")
def model():
    return _packed(2, traced=True)


def _mk(model, **over):
    tcfg, tparams = model[2:]
    base = dict(slots=3, max_seq=64, page_size=8, a_fmt="fp8_e4m3")
    return tserve.Server(tparams, tcfg, tserve.ServerConfig(**{**base, **over}), device="cpu")


def _sync_reference(model, specs):
    srv = _mk(model)
    for rid, (prompt, max_new, sp) in enumerate(specs):
        srv.submit(tserve.Request(rid=rid, prompt=list(prompt), max_new=max_new, sampling=sp))
    return {r.rid: r.tokens for r in srv.run_until_drained()}


async def _collect(front, rid, prompt, max_new, sp):
    toks, events = [], []
    async for ev in front.generate(list(prompt), max_new=max_new, sampling=sp, rid=rid):
        events.append(ev)
        if not ev.finished:
            toks.append(ev.token)
    return tuple(toks), events


def _specs(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, 5).tolist(), 6, tserve.SamplingParams()),
            (rng.integers(1, vocab, 9).tolist(), 4,
             tserve.SamplingParams(temperature=0.8, top_k=12, seed=3)),
            (rng.integers(1, vocab, 3).tolist(), 5,
             tserve.SamplingParams(temperature=1.1, top_p=0.9, seed=9))]


class TestAsyncServer:
    def test_concurrent_streams_match_sync_engine(self, model):
        """Three concurrent generates (greedy and two sampled) stream the
        tokens of the synchronous run, each token an event in index order
        and the terminal event last."""
        specs = _specs(model[2].vocab_size)
        want = _sync_reference(model, specs)

        async def main():
            front = AsyncServer(_mk(model))
            try:
                return await asyncio.gather(*[_collect(front, rid, p, m, sp)
                                              for rid, (p, m, sp) in enumerate(specs)])
            finally:
                await front.close()

        for rid, (toks, events) in enumerate(asyncio.run(main())):
            assert toks == want[rid], rid
            assert all(isinstance(e, tserve.TokenEvent) for e in events)
            assert [e.index for e in events[:-1]] == list(range(len(toks)))
            term = events[-1]
            assert term.finished and term.token is None and term.status == "ok"
            assert [e.t for e in events] == sorted(e.t for e in events)

    def test_late_submission_joins_running_batch(self, model):
        specs = _specs(model[2].vocab_size)[:2]
        want = _sync_reference(model, specs)

        async def main():
            front = AsyncServer(_mk(model))
            try:
                first = asyncio.ensure_future(_collect(front, 0, *specs[0]))
                for _ in range(8):  # the pump takes a few steps first
                    await asyncio.sleep(0)
                assert front.server.stats["steps"] > 0
                second = asyncio.ensure_future(_collect(front, 1, *specs[1]))
                return await asyncio.gather(first, second)
            finally:
                await front.close()

        (toks0, _), (toks1, _) = asyncio.run(main())
        assert toks0 == want[0] and toks1 == want[1]

    def test_result_available_after_stream(self, model):
        async def main():
            front = AsyncServer(_mk(model))
            try:
                toks, _ = await _collect(front, 0, [1, 2, 3], 4, tserve.SamplingParams())
                return toks, front.result(0)
            finally:
                await front.close()

        toks, res = asyncio.run(main())
        assert res is not None and res.tokens == toks and res.ok
        assert res.ttft is not None and res.ttft > 0 and len(res.itl) == 3
        assert all(g >= 0 for g in res.itl)

    def test_submit_validation_raises_before_streaming(self, model):
        async def main():
            front = AsyncServer(_mk(model))
            try:
                gen = front.generate([1, 2], max_new=2,
                                     sampling=tserve.SamplingParams(top_p=0.0))
                with pytest.raises(ValueError, match="top_p"):
                    await gen.__anext__()
                assert not front.server.queue
            finally:
                await front.close()

        asyncio.run(main())


class TestHTTPEndpoint:
    async def _post(self, port, body):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        data = json.dumps(body).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw.decode()

    async def _serve(self, engine, *posts):
        front = AsyncServer(engine)
        srv = await serve_http(front, port=0)
        port = srv.sockets[0].getsockname()[1]
        try:
            return await asyncio.gather(*[self._post(port, body) for body in posts])
        finally:
            srv.close()
            await srv.wait_closed()
            await front.close()

    def test_sse_streams_two_concurrent_prefix_sharing_requests(self, model):
        """Two concurrent SSE requests on one prefix stream token chunks from
        one engine, and the second prompt hits the first's pages."""
        rng = np.random.default_rng(5)
        shared = rng.integers(1, model[2].vocab_size, 16).tolist()
        engine = _mk(model, slots=2)
        raws = asyncio.run(self._serve(
            engine, {"prompt": shared + [3, 4], "max_tokens": 5, "stream": True},
            {"prompt": shared + [9], "max_tokens": 5, "temperature": 0.7, "seed": 4,
             "stream": True}))
        for raw in raws:
            assert "text/event-stream" in raw
            chunks = [json.loads(ln[6:]) for ln in raw.splitlines() if ln.startswith("data: {")]
            toks = [c["choices"][0]["token"] for c in chunks
                    if c["choices"][0].get("token") is not None]
            assert len(toks) == 5
            assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
            assert raw.rstrip().endswith("data: [DONE]")
        assert engine.stats["prefix_hit_tokens"] > 0

    def test_non_stream_matches_sync_tokens(self, model):
        prompt = [1, 2, 3, 4]
        sp = tserve.SamplingParams(temperature=0.9, seed=2)
        want = _sync_reference(model, [(prompt, 5, sp)])[0]
        (raw,) = asyncio.run(self._serve(_mk(model), {
            "prompt": prompt, "max_tokens": 5, "temperature": 0.9, "seed": 2}))
        assert raw.startswith("HTTP/1.1 200")
        body = json.loads(raw.split("\r\n\r\n", 1)[1])
        assert tuple(body["choices"][0]["tokens"]) == want
        assert body["choices"][0]["finish_reason"] == "stop"
        assert body["usage"]["completion_tokens"] == 5

    def test_bad_request_is_400(self, model):
        bad_prompt, bad_param = asyncio.run(self._serve(
            _mk(model), {"prompt": "text"}, {"prompt": [1, 2], "top_p": 0.0}))
        assert bad_prompt.startswith("HTTP/1.1 400") and "token ids" in bad_prompt
        assert bad_param.startswith("HTTP/1.1 400") and "top_p" in bad_param


# -- the rest of Server's API against repro's ------------------------------------------
BUDGET = 64  # tokens: 8 pages of 8, where the default is 4 pages
SERVED = dict(slots=3, max_seq=128, page_size=8, a_fmt="fp8_e4m3", prefix_cache=True)
# (max_new, sampling) of six requests, each a 16-token shared prefix and a
# 54-token tail of its own: prompts of 70 stream in a 64-token chunk and a
# short one (a few chunk shapes only); rid 3 reaches the max_seq bound
# (truncated) and a NaN row fails another
TRAFFIC = ((8, {}), (6, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)),
           (10, dict(temperature=1.0, seed=2 ** 32 - 1)), (60, {}),
           (8, dict(temperature=0.7, top_p=0.5, seed=2 ** 31)), (12, {}))
NAN_AT = ((14, 2),)  # (decode step, slot)


@pytest.fixture(scope="module", params=["mixed", "alternating"])
def served(request, model):
    """TRAFFIC through repro's ``Server`` and the port's with the prefill
    token budget at 64 and a NaN row injected, events collected:
    (engine, reference server, its events, its gaps, port server, its
    events, the port's fault plan)."""
    engine = request.param
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(8)
    prefix = rng.integers(1, jcfg.vocab_size, 16).tolist()
    reqs = [(rid, prefix + rng.integers(1, jcfg.vocab_size, 54).tolist(), m, sp)
            for rid, (m, sp) in enumerate(TRAFFIC)]
    jsrv = jserve.Server(jparams, jcfg, jserve.ServerConfig(
        **SERVED, kernel_backend="ref", cache=jserve.CachePolicy(**FP8),
        scheduler=jserve.SchedulerConfig(engine=engine, prefill_token_budget=BUDGET)),
        faults=jfaults.FaultPlan(nan_logits=NAN_AT))
    strict = StrictReference(jsrv, jcfg, "fp8_e4m3", _step_and_sampled_gap)
    plan = tfaults.FaultPlan(nan_logits=NAN_AT)
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **SERVED, cache=tserve.CachePolicy(**FP8),
        scheduler=tserve.SchedulerConfig(engine=engine, prefill_token_budget=BUDGET)),
        device="cpu", faults=plan)
    events = []
    for mod, srv in ((jserve, jsrv), (tserve, tsrv)):
        srv.collect_events = True
        for rid, prompt, max_new, sp in reqs:
            srv.submit(mod.Request(rid=rid, prompt=list(prompt), max_new=max_new,
                                   sampling=mod.SamplingParams(**sp)))
        srv.run_until_drained()
        events.append(srv.pop_events())
        assert srv.pop_events() == []
    return engine, jsrv, events[0], strict.gaps, tsrv, events[1], plan


def test_streams_and_events_match_jax_pop_events(served):
    """Equal streams (``compare_streams``: no tie here), then equal event
    streams: every emitted token an event, in emission order, with its
    index, and every retirement a terminal event with its status."""
    engine, jsrv, jev, gaps, tsrv, tev, plan = served
    streams = lambda srv: {r.rid: (list(r.out), r.status) for r in srv.finished}
    assert not compare_streams(streams(tsrv), streams(jsrv), gaps)
    key = lambda e: (e.rid, e.token, e.index, e.finished, e.status)
    assert [key(e) for e in tev] == [key(e) for e in jev]
    statuses = {e.rid: e.status for e in tev if e.finished}
    assert sorted(statuses.values()) == ["failed", "ok", "ok", "ok", "ok", "truncated"], statuses
    assert len(plan.nan_hits) == 1
    for r in tsrv.finished:
        mine = [e for e in tev if e.rid == r.rid]
        assert [e.token for e in mine[:-1]] == r.out and mine[-1].index == len(r.out)
        assert [e.t for e in mine[:-1]] == r.token_times


def test_prefill_token_budget_matches_jax(served):
    """A budget of 64 tokens streams the long prompts in 64-token chunks on
    both engines, as repro does; every counter equal."""
    engine, jsrv, _, _, tsrv, _, _ = served
    assert tsrv.prefill_token_budget == jsrv.prefill_token_budget == BUDGET
    assert tsrv.prefill_traces == jsrv.prefill_traces
    assert max(p for p, _ in tsrv.prefill_traces) == BUDGET
    assert tsrv.stats == {k: jsrv.stats[k] for k in tsrv.stats}
    assert tsrv.engine == jsrv.engine == engine


@pytest.mark.parametrize("budget,chunk_pages,want", [
    (None, 4, 32), (None, 2, 16), (64, 4, 64), (70, 4, 64), (3, 4, 8), (8, 1, 8)])
def test_prefill_token_budget_rounds_as_jax(model, budget, chunk_pages, want):
    jcfg, jparams, tcfg, tparams = model
    sched = dict(prefill_token_budget=budget, prefill_chunk_pages=chunk_pages)
    jsrv = jserve.Server(jparams, jcfg, jserve.ServerConfig(
        slots=1, max_seq=64, page_size=8, scheduler=jserve.SchedulerConfig(**sched)))
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        slots=1, max_seq=64, page_size=8, scheduler=tserve.SchedulerConfig(**sched)),
        device="cpu")
    assert tsrv.prefill_token_budget == jsrv.prefill_token_budget == want


def test_utilization_and_bytes_per_token_match_jax(served):
    engine, jsrv, _, _, tsrv, _, _ = served
    assert 0 < tsrv.utilization() == jsrv.utilization() <= 1
    assert 0 < tsrv.engine_utilization() == jsrv.engine_utilization() <= 1
    assert tsrv.kv_bytes_per_token() == pytest.approx(jsrv.kv_bytes_per_token(), rel=1e-12)
    assert tsrv.kv_bf16_bytes_per_token() == jsrv.kv_bf16_bytes_per_token()
    assert tsrv.kv_bytes_per_token() < tsrv.kv_bf16_bytes_per_token()


def test_result_latency_fields(served):
    """``ttft`` is submit to the first token, ``itl`` the gaps after it; a
    request failed before its first token has neither."""
    tsrv = served[4]
    for r in tsrv.finished:
        res = r.result()
        if not res.tokens:
            assert res.ttft is None and res.itl == ()
            continue
        assert res.ttft == res.token_times[0] - res.submitted_at > 0
        assert len(res.itl) == len(res.tokens) - 1 and all(g >= 0 for g in res.itl)
