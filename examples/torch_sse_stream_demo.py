"""SSE streaming demo on the PyTorch port: two concurrent clients sharing a
prompt prefix (the twin of ``examples/sse_stream_demo.py``).

    python examples/torch_sse_stream_demo.py              # on the card
    python examples/torch_sse_stream_demo.py --device cpu --sampled

Boots a pocket-size W4A8-packed engine behind the asyncio front-end
(untrained weights: this demo is about the transport, not the tokens; pass
``--trained`` for the cached benchmark checkpoint), exposes the
OpenAI-style ``POST /v1/completions`` endpoint on a port the OS picks
(``--port 0``, the default), then plays client against its own server:
two requests whose prompts share a 24-token system prefix are POSTed
concurrently with ``stream: true`` and their SSE token chunks are printed
as they interleave. Both prompts hash to the same scale-frozen prefix
pages, so the second request maps them from the prefix cache; the demo
prints the engine's ``prefix_hit_tokens`` to prove it.

``--sampled`` sends per-request ``temperature/top_k/top_p/seed`` so the
two streams draw from the seeded sampler instead of greedy argmax.
"""
import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch_common  # noqa: F401  (puts the port's src/ on the path)

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ptq import pack_params
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.frontend import AsyncServer, serve_http
from repro_torch.runtime.serve import (CachePolicy, SchedulerConfig, Server,
                                       ServerConfig)


async def stream_completion(host, port, name, payload):
    """POST /v1/completions with stream:true, print chunks as they land,
    return the token list. Pure stdlib: reads SSE lines off the socket."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    t_post = time.perf_counter()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: demo\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    toks, finish, ttft = [], None, None
    while True:
        line = (await reader.readline()).decode().rstrip("\r\n")
        if line == "data: [DONE]":
            break
        if not line.startswith("data: "):
            continue  # headers / keep-alive blanks
        choice = json.loads(line[6:])["choices"][0]
        if choice["finish_reason"] is not None:
            finish = choice["finish_reason"]
        elif choice.get("token") is not None:
            if ttft is None:
                ttft = time.perf_counter() - t_post
            toks.append(choice["token"])
            print(f"  [{name}] token #{choice['index_in_stream']}: {choice['token']}")
    writer.close()
    await writer.wait_closed()
    ttft_ms = f"{ttft * 1e3:.1f} ms" if ttft is not None else "n/a"
    print(f"  [{name}] done ({finish}), time-to-first-token {ttft_ms}: {toks}")
    return toks


def _build_engine(trained, device):
    """A W4A8-packed engine: pocket config + random init by default
    (seconds to boot), or the cached opt-mini benchmark checkpoint."""
    if trained:
        from torch_common import BENCH_CFG as cfg
        from torch_common import trained_params
        params = trained_params(device=device)
    else:
        cfg = ArchConfig(
            name="sse-demo", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            attn_kind="gqa", norm_kind="layernorm", act_kind="relu",
            mlp_gated=False, use_bias=True, pos_embedding="learned",
            tie_embeddings=True, max_position=256, attn_chunk=128)
        params = api.init_params(cfg, 0, device)
    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", scale_mode="m2", lorc_rank=8)
    packed = pack_params(params, cfg, policy, device=device)
    # mixed-precision cache policy: FP8 active pages, and the shared system
    # prefix both clients ride is transcoded to packed FP4 when it freezes
    cache = CachePolicy(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1")
    return cfg, Server(packed, cfg,
                       ServerConfig(slots=2, max_seq=96, page_size=8, cache=cache,
                                    scheduler=SchedulerConfig()),
                       device=device)


async def run_demo(args):
    cfg, engine = _build_engine(args.trained, resolve_device(args.device))
    front = AsyncServer(engine)
    srv = await serve_http(front, host=args.host, port=args.port)
    port = srv.sockets[0].getsockname()[1]
    print(f"serving /v1/completions on {args.host}:{port}")

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, size=24).tolist()
    prompts = {"alice": shared + [7, 7, 3], "bob": shared + [40]}
    print(f"two clients share a {len(shared)}-token prompt prefix; "
          f"tails {prompts['alice'][-3:]} vs {prompts['bob'][-1:]}")

    def payload(name, seed):
        p = {"prompt": prompts[name], "max_tokens": args.max_new, "stream": True}
        if args.sampled:
            p.update(temperature=0.8, top_k=20, top_p=0.95, seed=seed)
        return p

    try:
        streams = await asyncio.gather(
            stream_completion(args.host, port, "alice", payload("alice", 1)),
            stream_completion(args.host, port, "bob", payload("bob", 2)))
    finally:
        srv.close()
        await srv.wait_closed()
        await front.close()

    hits = engine.stats["prefix_hit_tokens"]
    print(f"prefix cache served {hits} of the second prompt's tokens from "
          f"shared pages ({engine.prefix_hit_rate():.1%} hit rate) — "
          f"concurrent requests batched in one engine, one prefill "
          f"of the shared prefix")
    assert hits > 0, "expected the shared prefix to hit the page cache"
    return streams, hits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = a free port the OS picks")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--sampled", action="store_true",
                    help="seeded sampling instead of greedy")
    ap.add_argument("--trained", action="store_true",
                    help="serve the cached opt-mini benchmark checkpoint instead of "
                         "untrained pocket weights (trains BENCH_TRAIN_STEPS steps on first use)")
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card when not given (raises without one)")
    args = ap.parse_args(argv)
    return asyncio.run(run_demo(args))


if __name__ == "__main__":
    main()
