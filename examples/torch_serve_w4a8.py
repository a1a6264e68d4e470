"""Batched W4A8 serving on the PyTorch port with the packed deployment
checkpoint (the twin of ``examples/serve_w4a8.py``).

    python examples/torch_serve_w4a8.py                  # on the card
    python examples/torch_serve_w4a8.py --device cpu --requests 4 --slots 2

Loads (or trains) the benchmark model, packs it to the W4A8 deployment form
(FP4-E2M1 nibbles + M2 pow-2 scales + LoRC factors), then serves a stream of
batched requests through the continuous-batching engine. On the card every
packed matmul runs the fused W4A8 kernel and every decode step's attention
the paged decode kernel; on the CPU their plain versions run.

``--families`` serves the whisper-tiny enc-dec config (write-once
cross-attention pages) and the minicpm3 MLA config (latent decode kernel)
through the same paged FP8 engine, asserting each request's greedy tokens
are identical to the contiguous-cache decode path (``api.prefill`` and
``api.decode_step`` at a scalar index).

The other flags are the reference's: ``--shared-prefix N``,
``--no-prefix-cache``, ``--frozen-kv-fmt fp4_e2m1``, ``--temperature`` /
``--top-k`` / ``--top-p`` / ``--seed``, ``--inject-faults SEED``,
``--audit-every N``, ``--scheduler``, ``--engine``, ``--pool-pages``. The
reference's ``--backend`` has no counterpart: the port picks the kernel or
its plain version by the tensors' device (``--device``). ``--mesh N`` with
N > 1 raises: multi-device serving is ROADMAP queue 1, item 14.
"""
import argparse
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch
from torch_common import BENCH_CFG, CACHE, trained_params

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ptq import pack_params
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import tree_items
from repro_torch.runtime.serve import (CachePolicy, FaultPlan, Request, SamplingParams,
                                       SchedulerConfig, Server, ServerConfig)

FAMILY_TRAIN_STEPS = 150  # the reference's steps for each --families smoke config


def _train_smoke(cfg, tag, device, steps=None, with_frames=False):
    """Briefly train a smoke config (cached in .bench_cache) so greedy
    logit gaps are decisive and FP8-vs-contiguous token identity is
    meaningful."""
    from repro_torch.checkpoint.manager import latest_step, restore, save
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.optimizer import AdamWConfig, adamw_init

    steps = FAMILY_TRAIN_STEPS if steps is None else steps
    ckpt = os.path.join(CACHE, f"torch_{tag}_{steps}")
    init = api.init_params(cfg, 0, device)
    if latest_step(ckpt) is not None:
        return restore(ckpt, init)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=8, seed=7)
    oc = AdamWConfig(lr=6e-3, warmup=20, total_steps=steps)
    state = TrainState(params=init, opt=adamw_init(init, oc))
    step_fn = make_train_step(cfg, oc)
    data = SyntheticLM(dc)
    frng = np.random.default_rng(11)
    for step in range(steps):
        b = {k: v.to(device) for k, v in data.batch(step).items()}
        if with_frames:
            b["frames"] = torch.as_tensor(frng.normal(
                size=(dc.global_batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(device)
        state, _ = step_fn(state, b)
    save(ckpt, steps, state.params)
    return state.params


def _greedy_legacy(params, cfg, prompt, max_new, max_seq, frames=None):
    """Greedy decode of one request over the contiguous caches."""
    dev = params["embed"].device
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32, device=dev)}
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames[None]).to(dev)
    logits, caches = api.prefill(params, cfg, batch, max_seq)
    out = [int(logits[0].argmax())]
    idx = len(prompt)
    while len(out) < max_new:
        logits = api.decode_step(params, cfg, torch.tensor([[out[-1]]], dtype=torch.int32,
                                                           device=dev), caches, idx)
        out.append(int(logits[0].argmax()))
        idx += 1
    return out


def serve_families(device):
    """Whisper-tiny (enc-dec cross pages) and minicpm3 (MLA latent decode)
    through the paged FP8 engine, token-identical to the contiguous
    decode."""
    from repro_torch.configs import get_smoke

    rng = np.random.default_rng(0)
    for arch, tag in (("whisper-tiny", "whisper_smoke"), ("minicpm3-4b", "mla_smoke")):
        cfg = get_smoke(arch)
        encdec = cfg.encoder_layers > 0
        params = _train_smoke(cfg, tag, device, with_frames=encdec)
        srv = Server(params, cfg,
                     ServerConfig(slots=3, max_seq=64, cache=CachePolicy(active_fmt="fp8_e4m3"),
                                  page_size=8, a_fmt=None),
                     device=device)
        reqs = []
        for rid in range(3):
            prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(3, 10)).tolist()
            frames = (rng.normal(size=(cfg.encoder_seq, cfg.d_model)).astype(np.float32)
                      if encdec else None)
            r = Request(rid=rid, prompt=prompt, max_new=6, frames=frames)
            reqs.append(r)
            srv.submit(r)
        srv.run_until_drained()
        for r in reqs:
            ref = _greedy_legacy(params, cfg, r.prompt, 6, 64, r.frames)
            assert r.out == ref, (arch, r.rid, r.out, ref)
        extra = (f", cross pages for {cfg.encoder_seq} encoder frames"
                 if encdec else ", latent decode kernel path")
        print(f"{arch}: {len(reqs)} requests through the paged FP8 engine"
              f"{extra}; greedy tokens identical to the contiguous decode")
        for r in reqs[:2]:
            print(f"  req {r.rid}: {r.prompt} -> {r.out}")


def _nbytes(tree):
    """Bytes of a params tree, every tensor field of a PackedLinear counted."""
    total = 0
    for _, leaf in tree_items(tree, is_leaf=lambda x: isinstance(x, PackedLinear)):
        fields = ([getattr(leaf, f) for f in PackedLinear._FIELDS]
                  if isinstance(leaf, PackedLinear) else [leaf])
        total += sum(f.numel() * f.element_size() for f in fields if f is not None)
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card when not given (raises without one)")
    ap.add_argument("--kv-fmt", default="fp8_e4m3", choices=["fp8_e4m3", "bf16"],
                    help="active KV page payload: packed FP8 codes with "
                         "per-(page, head) M2 scales, or bf16 (fallback)")
    ap.add_argument("--frozen-kv-fmt", default="none", choices=["none", "fp4_e2m1"],
                    help="frozen (prefix-cache-registered) page payload: 'fp4_e2m1' "
                         "transcodes each shared page FP8 -> packed FP4 exactly once at the "
                         "freeze point (needs --shared-prefix and FP8 --kv-fmt)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--scheduler", default="token_budget", choices=["reserve", "token_budget"])
    ap.add_argument("--engine", default="mixed", choices=["mixed", "alternating"])
    ap.add_argument("--prefill-token-budget", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tail", type=int, default=0)
    ap.add_argument("--pool-pages", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--families", action="store_true",
                    help="also serve the whisper-tiny enc-dec and minicpm3 MLA smoke configs "
                         "through the paged FP8 engine (asserts token identity vs the "
                         "contiguous decode)")
    ap.add_argument("--inject-faults", type=int, default=0, metavar="SEED")
    ap.add_argument("--audit-every", type=int, default=0, metavar="N")
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="1 only: multi-device serving is ROADMAP queue 1, item 14")
    args = ap.parse_args(argv)
    if args.mesh > 1:
        ap.error(f"--mesh {args.mesh}: multi-device serving is not ported yet "
                 "(ROADMAP queue 1, item 14)")
    dev = resolve_device(args.device)

    if args.families:
        serve_families(dev)
        return None

    params = trained_params(device=dev)
    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", scale_mode="m2", lorc_rank=8)
    packed = pack_params(params, BENCH_CFG, policy, device=dev)

    # deployment footprint
    dense_bytes, packed_bytes = _nbytes(params), _nbytes(packed)
    print(f"checkpoint: {dense_bytes/2**20:.1f} MiB dense -> "
          f"{packed_bytes/2**20:.1f} MiB packed W4A8 "
          f"({dense_bytes/packed_bytes:.2f}x smaller)")

    rng = np.random.default_rng(0)
    kv_fmt = None if args.kv_fmt == "bf16" else args.kv_fmt
    frozen_fmt = None if args.frozen_kv_fmt == "none" else args.frozen_kv_fmt
    if frozen_fmt and not args.shared_prefix:
        ap.error("--frozen-kv-fmt needs --shared-prefix: frozen FP4 pages "
                 "only ever hold prefix-cache-registered pages")
    cache = CachePolicy(active_fmt=kv_fmt, frozen_fmt=frozen_fmt)
    page_size = 16 if args.shared_prefix else 32
    plan = None
    if args.inject_faults:
        n_tail = (args.requests + 2) // 3 if args.max_new_tail else 0
        total = n_tail * args.max_new_tail + (args.requests - n_tail) * args.max_new
        span = max(4, total // max(1, args.slots) // 2)
        plan = FaultPlan.seeded(args.inject_faults, slots=args.slots, max_step=span)
        print(f"fault schedule (seed {args.inject_faults}): "
              f"NaN rows at {plan.nan_logits}, corrupt spill ordinals "
              f"{plan.corrupt_spills}, allocator blanked on ticks "
              f"{plan.alloc_fail_ticks}")
    server = Server(packed, BENCH_CFG,
                    ServerConfig(slots=args.slots, max_seq=96, cache=cache,
                                 page_size=page_size,
                                 pool_pages=args.pool_pages or None,
                                 prefix_cache=not args.no_prefix_cache,
                                 strict=False, audit_every=args.audit_every,
                                 scheduler=SchedulerConfig(
                                     policy=args.scheduler, engine=args.engine,
                                     prefill_token_budget=args.prefill_token_budget or None)),
                    device=dev, faults=plan)
    frozen_note = f" + frozen {args.frozen_kv_fmt}" if frozen_fmt else ""
    print(f"kv cache: paged {args.kv_fmt}{frozen_note}, "
          f"{server.kv_bytes_per_token():.0f} B/token "
          f"(bf16 baseline {server.kv_bf16_bytes_per_token():.0f} B/token); "
          f"scheduler={args.scheduler}; device={dev}")
    shared = (rng.integers(1, BENCH_CFG.vocab_size, size=args.shared_prefix).tolist()
              if args.shared_prefix else [])
    if args.temperature > 0:
        print(f"sampling: temperature={args.temperature}, "
              f"top_k={args.top_k}, top_p={args.top_p}, "
              f"seed base {args.seed} (+rid per request)")
    reqs = []
    for rid in range(args.requests):
        prompt = shared + rng.integers(1, BENCH_CFG.vocab_size,
                                       size=rng.integers(3, 10)).tolist()
        max_new = args.max_new
        if args.max_new_tail and rid % 3 == 0:
            max_new = args.max_new_tail
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed + rid)
        r = Request(rid=rid, prompt=prompt, max_new=max_new, sampling=sp)
        reqs.append(r)
        server.submit(r)

    t0 = time.time()
    steps = 0
    while True:
        went = server.step()
        steps += 1
        if steps > 2000:
            break
        if not went:
            if server.queue or server.preempted:
                continue  # deferred admission (e.g. injected alloc stall)
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    by_status = Counter(r.status for r in reqs)
    status = ", ".join(f"{n} {s}" for s, n in sorted(by_status.items()))
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.1f}s "
          f"({steps} engine steps, device={dev}; {status})")
    st = server.stats
    n_steps = max(st["steps"], 1)
    print(f"engine={server.engine}: {st['prefill_tokens']} prefill + "
          f"{st['decoded_tokens']} decode tokens across {st['programs']} "
          f"programs; per-step mix "
          f"{st['prefill_tokens'] / n_steps:.1f} prefill / "
          f"{st['decoded_tokens'] / n_steps:.1f} decode tokens, "
          f"engine utilization {server.engine_utilization():.3f}")
    print(f"slot utilization {server.utilization():.3f}, "
          f"{st['preemptions']} preemptions / {st['resumes']} resumes "
          f"({st['pages_stolen']} pages stolen), {st['truncated']} truncated at max_seq")
    print(f"prefix cache: {st['prefix_hit_tokens']} prompt tokens "
          f"served from shared pages ({server.prefix_hit_rate():.1%} hit "
          f"rate, {st['prefix_hit_pages']} page hits, {st['prefix_reclaims']} reclaims)")
    if plan is not None:
        hit_rids = sorted(rid for (_, _, rid) in plan.nan_hits)
        failed = sorted(r.rid for r in reqs if r.status == "failed")
        print(f"fault injection landed: NaN rows hit requests {hit_rids}, "
              f"spills tampered for rids "
              f"{sorted(plan.corrupted_rids + plan.dropped_rids)} "
              f"({st['spill_integrity_failures']} caught by CRC), "
              f"allocator blanked on ticks {plan.blocked_ticks}")
        assert failed == hit_rids, (failed, hit_rids)
        for r in reqs:
            if r.status == "failed":
                print(f"  req {r.rid} quarantined: {r.error}")
    summary = server.audit()  # raises PoolCorruptionError if anything broke
    print(f"pool audit clean at drain: {summary['pages_mapped']} mapped / "
          f"{summary['pages_free']} free / {summary['pages_parked']} parked "
          f"pages, {summary['slabs_free']} slabs free")
    resid = server.cache_residency()
    print(f"page residency: {resid['n_active_live']} live "
          f"{args.kv_fmt} pages ({resid['active_bytes_per_token']:.0f} "
          f"B/token) + {resid['n_frozen_live']} live frozen pages "
          f"({resid['frozen_bytes_per_token']:.0f} B/token)")
    if frozen_fmt:
        ratio = resid["frozen_bytes_per_token"] / resid["active_bytes_per_token"]
        print(f"  {st['fp4_frozen_pages']} pages transcoded "
              f"FP8 -> packed FP4 at freeze; frozen/active page density {ratio:.2f}x")
    for r in reqs[:3]:
        tag = " [truncated]" if r.truncated else ""
        print(f"  req {r.rid}: {r.prompt} -> {r.out}{tag}")
    return reqs


if __name__ == "__main__":
    main()
