"""Asyncio streaming front-end over the port's serving engine (port of
``repro.runtime.frontend``).

``AsyncServer`` turns the synchronous step loop of ``runtime.serve.Server``
into one token stream a request: ``generate(...)`` submits into the running
scheduler and yields a ``TokenEvent`` per emitted token as the engine
steps. A request submitted mid-flight joins the next step's batch, and
requests sharing a prompt prefix share its pages through the prefix cache.

Concurrency: one cooperative pump, no threads, no locks. A single asyncio
task calls ``Server.step()`` (which blocks the loop for one step), drains
``Server.pop_events()`` into per-request queues and yields to the loop, so
waiting generators and new ``generate()`` calls interleave between steps.
The pump runs only while the engine has work; the next ``generate()``
starts it again. Everything engine-side happens on that one task.

Starvation mirrors ``run_until_drained``: a step that makes no progress
while work waits raises ``ServingError`` into every open stream under
``strict=True`` (tokens already streamed stay streamed), or fails exactly
the requests that cannot be admitted under ``strict=False`` (their streams
end with a ``status="failed"`` terminal event).

``serve_http`` exposes the streams as an OpenAI-style ``POST
/v1/completions`` endpoint speaking SSE (``stream: true``) or one JSON
body, on the standard library alone (``asyncio.start_server`` and manual
HTTP parsing). Prompts are token-id lists (there is no tokenizer);
``choices[0].text`` carries the space-joined token ids.
"""
from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Dict, List, Optional

from repro_torch.runtime.faults import ServingError
from repro_torch.runtime.serve import Request, RequestResult, SamplingParams, Server, TokenEvent

__all__ = ["AsyncServer", "serve_http"]

# terminal sentinel pushed into a stream's queue on an engine-wide failure
_ABORT = object()


class AsyncServer:
    """Async streaming facade over a synchronous ``Server``. Nothing else may
    step the wrapped engine while the front-end owns it: it switches
    ``collect_events`` on and drains the events from its pump."""

    def __init__(self, server: Server):
        self.server = server
        server.collect_events = True
        self._queues: Dict[int, asyncio.Queue] = {}
        self._results: Dict[int, RequestResult] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._next_rid = 0

    async def generate(self, prompt: List[int], max_new: int = 16,
                       sampling: SamplingParams = SamplingParams(),
                       rid: Optional[int] = None, priority: int = 0, frames=None
                       ) -> AsyncIterator[TokenEvent]:
        """Submit one request and stream its TokenEvents as they are emitted:
        one a token, then the terminal event (``finished``; its ``status`` is
        the request's outcome, and ``result(rid)`` returns the frozen
        ``RequestResult`` after it). ``frames`` is an enc-dec request's
        encoder input (``Request.frames``). Submission raises
        ``Server.submit``'s ValueErrors. A failed request ends its stream
        with a ``status="failed"`` terminal event; a strict starvation
        raises ``ServingError`` into every open stream."""
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid=rid, prompt=list(prompt), max_new=max_new, sampling=sampling,
                      priority=priority, frames=frames)
        self.server.submit(req)  # validates; raises before any stream state
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q  # no await between submit and registration,
        self._ensure_pump()    # so the pump cannot emit for rid before it
        try:
            while True:
                ev = await q.get()
                if ev is _ABORT:
                    raise self._abort_error
                yield ev
                if ev.finished:
                    self._results[rid] = req.result()
                    return
        finally:
            self._queues.pop(rid, None)

    def result(self, rid: int) -> Optional[RequestResult]:
        """The frozen result of a finished stream (None if not done)."""
        return self._results.get(rid)

    async def close(self):
        """Cancel the pump (open streams see ServingError)."""
        if self._pump_task is not None and not self._pump_task.done():
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
        self._pump_task = None

    def _ensure_pump(self):
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(self._pump())

    def _has_work(self) -> bool:
        sv = self.server
        return bool(sv.queue or sv.preempted or any(r is not None for r in sv.active))

    def _dispatch(self):
        for ev in self.server.pop_events():
            q = self._queues.get(ev.rid)
            if q is not None:
                q.put_nowait(ev)

    def _abort_streams(self, err: ServingError):
        self._abort_error = err
        for q in self._queues.values():
            q.put_nowait(_ABORT)

    async def _pump(self):
        """Step the engine while it has work, one step a loop pass, fanning
        the events out to the per-request queues: submissions between steps
        join the next batch."""
        sv = self.server
        try:
            while self._has_work():
                progressed = sv.step()
                self._dispatch()
                if not progressed and (sv.queue or sv.preempted):
                    if sv._alloc_faulted:
                        await asyncio.sleep(0)
                        continue  # an injected, transient exhaustion
                    msg = ("serving starved: waiting work cannot be (re)admitted and no active "
                           "work remains (see run_until_drained)")
                    if not sv.strict:
                        sv._fail_pending(msg)  # emits the terminal events
                        self._dispatch()
                        continue
                    raise ServingError(msg, pending=sv._pending_diagnostics())
                await asyncio.sleep(0)
        except ServingError as e:
            self._abort_streams(e)


# -- OpenAI-style SSE endpoint -------------------------------------------------------
def _http_error(status: int, msg: str) -> bytes:
    body = json.dumps({"error": {"message": msg}}).encode()
    return (f"HTTP/1.1 {status} {'Bad Request' if status == 400 else 'Error'}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body


def _finish_reason(status: Optional[str]) -> str:
    # OpenAI's words: "stop" a natural end, "length" the token budget
    return {"ok": "stop", "truncated": "length"}.get(status or "", "error")


async def _read_request(reader: asyncio.StreamReader):
    """One HTTP/1.1 request: start line, headers, sized body."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    method, path, _ = lines[0].split(" ", 2)
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0"))
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


async def _handle(front: AsyncServer, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter):
    try:
        try:
            method, path, _, body = await _read_request(reader)
        except (asyncio.IncompleteReadError, ValueError):
            return
        if method != "POST" or path.split("?")[0] != "/v1/completions":
            writer.write(_http_error(404, f"no route {method} {path}"))
            return
        try:
            payload = json.loads(body or b"{}")
            prompt = payload["prompt"]
            if not isinstance(prompt, list) or not all(isinstance(t, int) for t in prompt):
                raise ValueError("prompt must be a list of token ids (no tokenizer here)")
            sampling = SamplingParams(temperature=float(payload.get("temperature", 0.0)),
                                      top_k=int(payload.get("top_k", 0)),
                                      top_p=float(payload.get("top_p", 1.0)),
                                      seed=int(payload.get("seed", 0))).validate()
            max_new = int(payload.get("max_tokens", 16))
            stream = bool(payload.get("stream", False))
            # generate()'s submit-time ValueError surfaces only at its first
            # iteration, past this except: validate() above keeps bad params a 400
            gen = front.generate(prompt, max_new=max_new, sampling=sampling)
        except (KeyError, TypeError, ValueError) as e:
            writer.write(_http_error(400, str(e)))
            return

        if stream:
            # SSE: a chunk a token, the stream ended by [DONE] and the close
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
            await writer.drain()
            try:
                async for ev in gen:
                    if ev.finished:
                        choice = {"index": 0, "text": "",
                                  "finish_reason": _finish_reason(ev.status)}
                    else:
                        choice = {"index": 0, "text": f"{ev.token} ", "token": ev.token,
                                  "index_in_stream": ev.index, "finish_reason": None}
                    chunk = {"object": "text_completion.chunk", "choices": [choice]}
                    writer.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                    await writer.drain()
                writer.write(b"data: [DONE]\n\n")
            except ServingError as e:
                writer.write(b"data: " + json.dumps({"error": {"message": str(e)}}).encode()
                             + b"\n\n")
        else:
            toks: List[int] = []
            status = "failed"
            try:
                async for ev in gen:
                    if ev.finished:
                        status = ev.status or "failed"
                    elif ev.token is not None:
                        toks.append(ev.token)
            except ServingError as e:
                writer.write(_http_error(500, str(e)))
                return
            out = json.dumps({
                "object": "text_completion",
                "choices": [{"index": 0, "text": " ".join(str(t) for t in toks), "tokens": toks,
                             "finish_reason": _finish_reason(status)}],
                "usage": {"prompt_tokens": len(prompt), "completion_tokens": len(toks)}}).encode()
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                         + f"Content-Length: {len(out)}\r\n".encode()
                         + b"Connection: close\r\n\r\n" + out)
        await writer.drain()
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def serve_http(front: AsyncServer, host: str = "127.0.0.1",
                     port: int = 8000) -> asyncio.AbstractServer:
    """Start the ``/v1/completions`` endpoint and return the asyncio server
    (the caller closes it: ``srv.close(); await srv.wait_closed()``).
    Concurrent requests batch in the shared engine."""
    return await asyncio.start_server(lambda r, w: _handle(front, r, w), host, port)
