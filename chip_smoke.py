#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py    # every phase, one card; takes no arguments

Phases, in order; any failure exits non-zero and nothing is caught:

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- nvcc builds every kernel of ``csrc/`` (one process per source,
              in parallel) into ``build/kernels/``;
3. kernels -- each CUDA kernel against its plain PyTorch version on the
              card, at the shapes of the opt-125m serving path, with its
              time, the plain version's, one PyTorch library call's, and its
              bound (the larger of bytes / 3.35 TB/s and operations / peak);
              then every other variant the wrappers accept (no M2, no
              LoRC, a sliding window), checked but not timed; the
              frozen-region variant of decode attention (FP8 pages with
              half of each row's full pages in the packed FP4 region)
              timed the same way, and checked at an odd head width and
              with a window;
4. serve   -- opt-125m at full width, random weights from a seed, packed to
              W4A8 (FP4 E2M1 weights, M2 scales, LoRC rank 8, FP8 E4M3
              activations), served greedily over FP8 pages; every request
              must end ok and every decode step must have launched both
              kernels (72 GEMMs and 12 attention launches);
5. cpu     -- the same packed model, moved to the CPU, through the plain
              versions: one prefill chunk and 4 decode steps for 2
              requests, logits compared with the card's; a witness (the
              plain versions on the card) and two injected faults show
              what the comparison can and cannot tell apart;
6. prefix -- the reference Server's default path: the mixed prefill+decode
              engine, the prefix cache and FP8 pages with a packed-FP4
              frozen region, at opt-125m's full width; 8 requests in two
              waves share a 512-token system prompt. Every request must
              end ok, the prompt's pages must freeze into FP4 and be hit,
              every step must have launched the GEMM and the frozen
              attention variant, and at one step the frozen kernel is held
              against its plain version on the live pool (and an injected
              fault must read far above the tolerance).

The last two lines are the card line and ``{"ok": true, "device": ...}``.
The script imports nothing of jax and nothing of the JAX package.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 off the tensor cores
W4A8_TOL = 2e-2  # rtol = atol: M2 applied per group + s_max after the K loop vs folded into bf16 weights
ATTN_TOL = 1e-4  # rtol = atol: f32 sums in another order
# phase 5 (see phase_cpu): free-running logits, as a share of the reference's
# largest |logit|; a teacher-forced block's output, as a share of the
# reference block's update (Frobenius norms). The card's routes must read at
# most these; each injected fault must read more than BLOCK_RTOL. On an H100
# the sound routes read 0.055 at most and the faults 0.115 at least: see
# PERF.md.
LOGIT_RTOL = 0.1
BLOCK_RTOL = 0.08
SEED = 0
DEV = "cuda"


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- timing ---------------------------------------------------------------------
class Timer:
    """Device time of ``fn`` by CUDA events, averaged over ``iters`` runs,
    each after a write of 64 MiB that evicts the 50 MB L2 cache: the serving
    path finds its weights and pages cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, iters=20):
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes, flops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phases -----------------------------------------------------------------------
def phase_device():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = out.strip().splitlines()[0].strip()
    log(f"[1 device] {card}")
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"[2 build] {len(build.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"({' '.join(build.FLAGS)})")
    for name, out in build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")


def _w4a8_check(torch, m, k, n, gen, scale_mode="m2", lorc_rank=8):
    """A packed (n, k) weight and an (m, k) input; the kernel's output
    held against its plain version. Returns (packed, x, kernel, plain, err)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_linear
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda

    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256,
                         scale_mode=scale_mode, lorc_rank=lorc_rank)
    w = (torch.randn((n, k), generator=gen, device=DEV) / math.sqrt(k)).to(torch.bfloat16)
    p = pack_linear(w, policy)
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    args = (x, p.codes, p.scale, p.s_max, p.shifts, p.lorc_a, p.lorc_b)
    kw = dict(w_fmt=p.w_fmt, a_fmt=p.a_fmt, group_size=p.group_size)
    kernel = lambda: w4a8_fused_matmul_cuda(*args, **kw)
    plain = lambda: ref.w4a8_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, **kw)
    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((y_k.float() - y_p.float()).abs().max())
    what = f"w4a8_fused M={m} {k}->{n} scale_mode={scale_mode} lorc_rank={lorc_rank}"
    if not torch.allclose(y_k.float(), y_p.float(), rtol=W4A8_TOL, atol=W4A8_TOL):
        fail(f"{what} disagrees with its plain version: max |err| {err}")
    return p, x, kernel, plain, err


def _w4a8_case(torch, timer, m, k, n, gen):
    from repro_torch.kernels import ref

    p, x, kernel, plain, err = _w4a8_check(torch, m, k, n, gen)
    w_deq = ref.dequant_packed_ref(p.codes, p.scale, p.w_fmt, p.group_size)
    library = lambda: torch.matmul(x, w_deq.t())
    g, r = k // p.group_size, p.lorc_a.shape[1]
    nbytes = m * k * 2 + n * k // 2 + n * g + n * 4 + (n * r + r * k) * 2 + m * n * 2
    flops = 2 * m * n * k + 2 * m * r * (k + n)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain), library_ms=timer.ms(library),
               bound_ms=b_ms, bound_by=by, max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    w4a8_fused M={m:3d} {k:4d}->{n:4d}: kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  library(bf16 matmul) {row['library_ms']:.4f} ms  bound "
        f"{b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)"
        f"  max|err| {err:.3g}")
    return row


def _attn_check(torch, fmt, gen, window=0):
    """A random pool at the decode shapes of opt-125m and the kernel's
    output held against its plain version. Returns the operands, the two
    callables and the error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
    from repro_torch.runtime import kv_cache as kvc

    b, kv, hd, page = 4, 12, 64, 64
    lens = [2048, 1337, 300, 1]  # ragged contexts, up to 2048 tokens
    pp = 2048 // page
    n_pages = b * pp
    shape = (n_pages + 1, page, kv, hd)
    layer = {}
    for name in ("k", "v"):
        vals = torch.randn(shape, generator=gen, device=DEV)
        if fmt:
            codes, smax, shift = kvc.quantize_pages(vals)
            layer.update({name: codes, name + "_smax": smax, name + "_shift": shift})
        else:
            layer[name] = vals.to(torch.bfloat16)
    table = torch.full((b, pp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED))
    for row, n in enumerate(lens):
        npg = kvc.pages_needed(n, page)
        table[row, :npg] = perm[row * pp: row * pp + npg].to(torch.int32)
    table = table.to(DEV)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = torch.randn((b, kv, hd), generator=gen, device=DEV).to(torch.bfloat16)
    sc = ((layer["k_smax"], layer["k_shift"], layer["v_smax"], layer["v_shift"]) if fmt
          else (None,) * 4)
    kernel = lambda: paged_decode_attn_cuda(q, layer["k"], layer["v"], *sc, table, kv_lens,
                                            fmt=fmt, window=window)
    plain = lambda: ref.paged_decode_attn_ref(q, layer["k"], layer["v"], *sc, table, kv_lens,
                                              fmt=fmt, window=window)
    o_k, o_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not torch.allclose(o_k, o_p, rtol=ATTN_TOL, atol=ATTN_TOL):
        fail(f"paged_decode_attn ({fmt or 'bf16'} pages, window {window}) disagrees with its "
             f"plain version: max |err| {err}")
    return layer, table, kv_lens, lens, q, o_k, kernel, plain, err


def _attn_case(torch, timer, fmt, gen):
    from repro_torch.runtime import kv_cache as kvc

    b, kv, hd, page = 4, 12, 64, 64
    pp = 2048 // page
    layer, table, kv_lens, lens, q, o_k, kernel, plain, err = _attn_check(torch, fmt, gen)
    # the library yardstick: SDPA over the gathered, dequantized pages
    st = kvc.PagedState(table, kv_lens)
    kf, vf = (kvc.gather_pages(layer, n, st).to(torch.bfloat16).transpose(1, 2) for n in "kv")
    mask = (torch.arange(pp * page, device=DEV)[None, :] < kv_lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q[:, :, None], kf, vf, attn_mask=mask)
    esize = 1 if fmt else 2
    pages_read = sum(kvc.pages_needed(n, page) for n in lens)
    nbytes = (q.numel() * 2 + sum(lens) * kv * 2 * hd * esize + b * 4 + o_k.numel() * 4
              + pages_read * 4 + (pages_read * 2 * (4 + kv * 4) if fmt else 0))
    flops = sum(lens) * kv * 2 * 2 * hd  # scores and the weighted V sum, f32 FMAs
    b_ms, by = bound(nbytes, flops, "f32")
    row = dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain), library_ms=timer.ms(library),
               bound_ms=b_ms, bound_by=by, max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    paged_decode_attn {fmt or 'bf16'} pages B={b} H=KV={kv} hd={hd} page={page} ctx={lens}: "
        f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(SDPA) "
        f"{row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)  max|err| {err:.3g}")
    return row


def _frozen_layer(torch, gen, hd):
    """A random mixed-precision pool layer at the decode shapes of opt-125m
    (B=4, KV=12, page 64, contexts 2048/1337/300/1) and its table: the
    first half of each row's full pages sit in the packed FP4 frozen
    region (ids >= P+1), the rest are FP8 pages. Returns (layer, table,
    kv_lens, lens, frozen pages per row)."""
    from repro_torch.runtime import kv_cache as kvc

    b, kv, page = 4, 12, 64
    lens = [2048, 1337, 300, 1]
    pp = 2048 // page
    n_pages = b * pp
    layer = {}
    for name in ("k", "v"):
        for suffix, fmt in (("", "fp8_e4m3"), ("_fz", "fp4_e2m1")):
            vals = torch.randn((n_pages + 1, page, kv, hd), generator=gen, device=DEV)
            codes, smax, shift = kvc.quantize_pages(vals, fmt)
            layer.update({name + suffix: codes, name + suffix + "_smax": smax,
                          name + suffix + "_shift": shift})
    table = torch.full((b, pp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED))
    fperm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 1))
    n_frozen = []
    for row, n in enumerate(lens):
        npg, nfr = kvc.pages_needed(n, page), (n // page) // 2
        table[row, :npg] = perm[row * pp: row * pp + npg].to(torch.int32)
        table[row, :nfr] = n_pages + 1 + fperm[row * pp: row * pp + nfr].to(torch.int32)
        n_frozen.append(nfr)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
    return layer, table.to(DEV), kv_lens, lens, n_frozen


def _frozen_calls(layer, table, kv_lens, q, window=0):
    """The frozen variant and its plain version on one mixed pool layer."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda

    args = (q, layer["k"], layer["v"], layer["k_smax"], layer["k_shift"], layer["v_smax"],
            layer["v_shift"], table, kv_lens)
    fz = {n + s: layer[n + s] for n in ("k", "v") for s in ("_fz", "_fz_smax", "_fz_shift")}
    kw = dict(fmt="fp8_e4m3", window=window, frozen="fp4_e2m1")
    return (lambda: paged_decode_attn_cuda(*args, **kw, **fz),
            lambda: ref.paged_decode_attn_ref(*args, **kw, **fz))


def _attn_frozen_check(torch, gen, hd=64, window=0):
    layer, table, kv_lens, lens, n_frozen = _frozen_layer(torch, gen, hd)
    q = torch.randn((4, 12, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kernel, plain = _frozen_calls(layer, table, kv_lens, q, window)
    o_k, o_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not torch.allclose(o_k, o_p, rtol=ATTN_TOL, atol=ATTN_TOL):
        fail(f"paged_decode_attn frozen variant (hd {hd}, window {window}) disagrees with its "
             f"plain version: max |err| {err}")
    return layer, table, kv_lens, lens, n_frozen, q, o_k, kernel, plain, err


def _attn_frozen_case(torch, timer, gen):
    from repro_torch.runtime import kv_cache as kvc

    b, kv, hd, page = 4, 12, 64, 64
    layer, table, kv_lens, lens, n_frozen, q, o_k, kernel, plain, err = _attn_frozen_check(
        torch, gen)
    st = kvc.PagedState(table, kv_lens)
    kf, vf = (kvc.gather_pages(layer, n, st).to(torch.bfloat16).transpose(1, 2) for n in "kv")
    mask = (torch.arange(table.shape[1] * page, device=DEV)[None, :]
            < kv_lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q[:, :, None], kf, vf, attn_mask=mask)
    fz_tok = sum(f * page for f in n_frozen)
    fp8_tok = sum(lens) - fz_tok
    pages_read = sum(kvc.pages_needed(n, page) for n in lens)
    nbytes = (q.numel() * 2 + fp8_tok * kv * 2 * hd + fz_tok * kv * 2 * ((hd + 1) // 2)
              + b * 4 + o_k.numel() * 4 + pages_read * 4 + pages_read * 2 * (4 + kv * 4))
    flops = sum(lens) * kv * 2 * 2 * hd
    b_ms, by = bound(nbytes, flops, "f32")
    row = dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain), library_ms=timer.ms(library),
               bound_ms=b_ms, bound_by=by, max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    paged_decode_attn frozen variant, fp8 pages + {sum(n_frozen)} fp4 frozen pages "
        f"B={b} H=KV={kv} hd={hd} page={page} ctx={lens}: kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  library(SDPA) {row['library_ms']:.4f} ms  bound "
        f"{b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)  max|err| {err:.3g}")
    return row


def phase_kernels(torch):
    log(f"[3 kernels] each CUDA kernel against its plain version on the card "
        f"(W4A8 tolerance {W4A8_TOL}, attention {ATTN_TOL}; times cold-L2, CUDA events)")
    timer = Timer(torch)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    gemm = {}
    for m in (4, 64, 256):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            gemm[(m, k, n)] = _w4a8_case(torch, timer, m, k, n, gen)
    attn = {fmt: _attn_case(torch, timer, fmt, gen) for fmt in ("fp8_e4m3", None)}
    frozen = _attn_frozen_case(torch, timer, gen)
    # every other variant the wrappers accept, held against the plain versions
    for mode, rank in (("none", 0), ("none", 8), ("m2", 0)):
        err = _w4a8_check(torch, 37, 3072, 768, gen, scale_mode=mode, lorc_rank=rank)[-1]
        log(f"    w4a8_fused M= 37 3072-> 768 scale_mode={mode} lorc_rank={rank}: "
            f"max|err| {err:.3g}")
    for fmt in ("fp8_e4m3", None):
        err = _attn_check(torch, fmt, gen, window=300)[-1]
        log(f"    paged_decode_attn {fmt or 'bf16'} pages, window 300: max|err| {err:.3g}")
    for hd, window in ((9, 0), (64, 300)):
        err = _attn_frozen_check(torch, gen, hd=hd, window=window)[-1]
        frozen["max_abs_err"] = max(frozen["max_abs_err"], err)
        log(f"    paged_decode_attn frozen variant, hd {hd}, window {window}: max|err| {err:.3g}")
    return gemm, attn, frozen


def _opt_125m():
    from repro_torch.configs.opt_125m import CONFIG
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_params
    from repro_torch.models import api

    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256, scale_mode="m2",
                         lorc_rank=8)
    t0 = time.perf_counter()
    packed = pack_params(api.init_params(CONFIG, seed=SEED), CONFIG, policy)
    return CONFIG, packed, time.perf_counter() - t0


def phase_serve(torch, cfg, packed):
    import numpy as np

    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda
    from repro_torch.runtime import serve

    config = serve.ServerConfig(slots=4, max_seq=640, page_size=64, a_fmt="fp8_e4m3",
                                cache=serve.CachePolicy(active_fmt="fp8_e4m3"), prefix_cache=False,
                                scheduler=serve.SchedulerConfig(engine="alternating"))
    srv = serve.Server(packed, cfg, config)
    rng = np.random.default_rng(SEED)
    prompt_lens = (32, 512, 77, 256, 140, 400, 64, 300)
    for i, n in enumerate(prompt_lens):
        srv.submit(serve.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, n).tolist(),
                                 max_new=32))
    w4a8_fused_matmul_cuda.launches = 0
    paged_decode_attn_cuda.launches = 0
    decode_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        prefilled = srv.stats["prefill_tokens"]
        s0 = time.perf_counter()
        if not srv.step():
            if srv.queue:
                fail("serving starved")
            break
        torch.cuda.synchronize()
        if srv.stats["prefill_tokens"] == prefilled:  # a step with no admission
            decode_ms.append((time.perf_counter() - s0) * 1e3)
    wall = time.perf_counter() - t0
    launches = {"w4a8_fused": w4a8_fused_matmul_cuda.launches,
                "paged_decode_attn": paged_decode_attn_cuda.launches}
    results = [r.result() for r in srv.finished]
    if len(results) != len(prompt_lens) or not all(r.ok for r in results):
        fail(f"not every request ended ok: {[(r.rid, r.status) for r in results]}")
    n_tok = sum(len(r.tokens) for r in results)
    steps, programs = srv.stats["steps"], srv.stats["programs"]
    n_layers = cfg.n_layers
    want = {"w4a8_fused": 6 * n_layers * programs, "paged_decode_attn": n_layers * steps}
    if launches != want or min(launches.values()) <= 0:
        fail(f"kernel launches {launches}, want {want} ({programs} programs, {steps} decode steps)")
    busy = _profile_decode(torch, srv, rng, cfg.vocab_size)
    log(f"[4 serve] opt-125m W4A8 (fp4_e2m1 + M2 + LoRC r8, fp8_e4m3 acts), fp8 pages, "
        f"{config.slots} slots: {len(results)} requests ok, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tokens/s; {steps} decode steps, median decode step "
        f"{statistics.median(decode_ms):.2f} ms over {len(decode_ms)} steps; {programs - steps} "
        f"prefill chunks; launches {launches}")
    log(busy)
    return launches


def _profile_decode(torch, srv, rng, vocab, n_steps=3):
    """Device busy share of decode steps: 4 fresh requests are admitted
    and prefilled by one step, then ``n_steps`` pure decode steps run
    under torch.profiler. Returns the line to print."""
    from repro_torch.runtime import serve

    for i in range(srv.slots):
        srv.submit(serve.Request(rid=1000 + i, prompt=rng.integers(2, vocab, 300).tolist(),
                                 max_new=n_steps + 2))
    srv.step()
    return _profiled(torch, srv, n_steps, "4 rows, 300-token contexts")


def _profiled(torch, srv, n_steps, what):
    """``n_steps`` steps of ``srv`` under torch.profiler, then a drain.
    Returns the line to print: wall and device-busy time per step, the
    busy share, launches and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    srv.run_until_drained()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    if busy_ms <= 0:
        return f"    profiled decode step: {wall_ms:.2f} ms wall; device time not measured (no CUDA events)"
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    launches = sum(e.count for e in kernels) / n_steps
    return (f"    profiled decode step ({what}): {wall_ms:.2f} ms wall, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), {launches:.0f} device launches; "
            f"top: " + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / n_steps:.2f} ms" for e in top))


def _routes(torch, packed):
    """name -> (params, device, attributes of ``ops`` replaced for the run)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map

    is_packed = lambda x: isinstance(x, PackedLinear)
    to_cpu = lambda t: t.apply(lambda x: x.cpu()) if is_packed(t) else t.cpu()
    no_lorc = lambda t: dataclasses.replace(t, lorc_a=None, lorc_b=None) if is_packed(t) else t
    attn = ops.paged_decode_attn
    plain = {"_route": lambda t: "cpu"}  # ops' route for CPU tensors: the plain versions
    short_kv = lambda q, layer, pt, lens, window=0: attn(q, layer, pt, lens - 1, window=window)
    return {
        "card": (packed, DEV, {}),
        "card_plain": (packed, DEV, plain),
        "cpu": (tree_map(to_cpu, packed, is_leaf=is_packed), "cpu", {}),
        "no_lorc": (tree_map(no_lorc, packed, is_leaf=is_packed), DEV, plain),
        "short_kv": (packed, DEV, {**plain, "paged_decode_attn": short_kv}),
    }


def _compare(torch, cfg, routes, forced):
    """Two requests (one prefill chunk, then 4 decode steps) along every
    route, each with a pool of its own, all fed the card's greedy tokens.
    With ``forced``, every block of every route takes the card's input to
    that block, so a difference cannot compound across layers. Returns the
    readings {route: (logit share, block share)} and (agreeing greedy
    tokens, decisive ones, tokens)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import kv_cache as kvc

    page, n_dec, pp = 64, 4, 4
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (100, 37)]
    pools = {name: [kvc.init_gqa_pool(cfg.n_layers, 2 * pp, page, cfg.n_kv_heads,
                                      cfg.resolved_head_dim, "fp8_e4m3", device=d)]
             for name, (_, d, _) in routes.items()}
    table = np.arange(2 * pp, dtype=np.int32).reshape(2, pp)
    t = lambda a, d: torch.as_tensor(np.asarray(a, np.int32)).to(d)
    block_apply = tf.block_apply
    reading = {name: [0.0, 0.0] for name in routes}
    agree = [0, 0, 0]

    def run(name, tokens, pt, lengths, chunk_len, lead):
        params, d, patch = routes[name]
        trace = []  # (input, output) of every block, in order

        def block(p, x, *args):
            if forced and lead is not None:
                x = lead[len(trace)][0].to(d)
            y = block_apply(p, x, *args)
            trace.append((x, y))
            return y

        saved = {k: getattr(ops, k) for k in patch}
        for k, v in patch.items():
            setattr(ops, k, v)
        tf.block_apply = block
        st = kvc.PagedState(t(pt, d), t(lengths, d), None if chunk_len is None else t([chunk_len], d))
        logits = api.decode_step(params, cfg, t(tokens, d), pools[name], st, a_fmt="fp8_e4m3")
        tf.block_apply = block_apply
        for k, v in saved.items():
            setattr(ops, k, v)
        return logits.float().cpu(), trace

    def step(tokens, pt, lengths, chunk_len=None):
        out = {"card": run("card", tokens, pt, lengths, chunk_len, None)}
        for name in routes:
            if name != "card":
                out[name] = run(name, tokens, pt, lengths, chunk_len, out["card"][1])
        for name, (o, _) in out.items():
            if not bool(torch.isfinite(o).all()):
                fail(f"non-finite logits on route {name}")
        ref, ref_blocks = out["cpu"]
        scale = float(ref.abs().max())
        f64 = lambda v: v.double().cpu()
        for name, (o, blocks) in out.items():
            r = reading[name]
            r[0] = max(r[0], float((o - ref).abs().max()) / scale)
            for (_, y), (x0, y0) in zip(blocks if forced else (), ref_blocks):
                r[1] = max(r[1], float((f64(y) - f64(y0)).norm() / (f64(y0) - f64(x0)).norm()))
        top2 = out["card"][0].topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_RTOL * scale
        same = out["card"][0].argmax(-1) == ref.argmax(-1)
        if bool((decisive & ~same).any()):
            fail("greedy tokens differ where the top-2 gap exceeds the tolerance")
        agree[0] += int(same.sum())
        agree[1] += int(decisive.sum())
        agree[2] += len(same)
        return out["card"][0].argmax(-1).tolist()

    nxt = []
    for row, prompt in enumerate(prompts):  # one prefill chunk each, bucketed to 128
        padded = 1 << (len(prompt) - 1).bit_length()
        toks = [prompt + [0] * (padded - len(prompt))]
        nxt += step(toks, table[row:row + 1, :2], [0], len(prompt))
    lengths = np.array([len(p) for p in prompts], np.int32)
    for _ in range(n_dec):
        nxt = step(np.array(nxt, np.int32)[:, None], table, lengths)
        lengths += 1
    return reading, agree


def phase_cpu(torch, cfg, packed):
    """The packed model along five routes, against the CPU:

    * ``card``       -- the CUDA kernels, as served in phase 4;
    * ``card_plain`` -- the plain versions on the card's tensors (``ops``
      routed as for CPU tensors): the witness that separates the kernels
      from the rest of the card path (FP8 fake-quant, page appends, norms);
    * ``cpu``        -- the plain versions on the CPU: the reference;
    * two injected faults, on the card through the plain versions, to show
      what a faulty card path reads: ``no_lorc`` drops the LoRC correction
      from every linear, ``short_kv`` hides the newest token from decode
      attention (``kv_lens`` one short).

    Two passes. Free-running, each route feeds its blocks its own hidden
    states; the reading is the largest |logit difference| as a share of
    the reference's largest |logit|. Every token-wise FP8 quantization
    turns a one-ulp bf16 difference into a whole FP8 step on the elements
    it tips over a rounding boundary, and 12 layers of random weights
    amplify that, so even the plain versions read a few percent here:
    the pass bounds the whole path by LOGIT_RTOL and checks the greedy
    tokens wherever the top-2 gap exceeds it. Teacher-forced, every block
    takes the card's input to it, so nothing compounds across layers; the
    reading is the largest difference of a block's output as a share of
    the reference block's update (Frobenius norms). The kernels (which
    apply M2 as the TPU kernel does, 2^-k per group and s_max after the K
    loop, where the plain version rounds the scaled weight to bf16 once)
    and the plain versions on the card must read at most BLOCK_RTOL, each
    fault more."""
    routes = _routes(torch, packed)
    free, agree = _compare(torch, cfg, routes, forced=False)
    forced, _ = _compare(torch, cfg, routes, forced=True)
    show = lambda rd, i: ", ".join(f"{n} {rd[n][i]:.4g}" for n in routes if n != "cpu")
    log(f"[5 cpu] 2 requests (1 prefill chunk + 4 decode steps) against the CPU plain path")
    log(f"    free-running, largest |logit err| / largest |logit| (tolerance {LOGIT_RTOL}): "
        f"{show(free, 0)}; greedy tokens agree {agree[0]}/{agree[2]}, all {agree[1]} "
        f"decisive ones")
    log(f"    teacher-forced blocks, largest |block output err| / |block update| "
        f"(tolerance {BLOCK_RTOL}): {show(forced, 1)}")
    for name in ("card", "card_plain"):
        if free[name][0] > LOGIT_RTOL:
            fail(f"free-running logits of route {name} differ from the CPU plain path by "
                 f"{free[name][0]:.4g} of the largest |logit| > {LOGIT_RTOL}")
        if forced[name][1] > BLOCK_RTOL:
            fail(f"the blocks of route {name} differ from the CPU plain path by "
                 f"{forced[name][1]:.4g} of their update > {BLOCK_RTOL}")
    for name in ("no_lorc", "short_kv"):
        if forced[name][1] <= BLOCK_RTOL:
            fail(f"injected fault {name} reads {forced[name][1]:.4g} <= {BLOCK_RTOL}: the "
                 f"comparison cannot tell it from a sound card path")
    return free, forced


def _counts():
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda as attn
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda as gemm

    return {"w4a8_fused": gemm.launches, "paged_decode_attn": attn.launches,
            "paged_decode_attn_frozen": attn.frozen_launches}


def _set_counts(counts):
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda as attn
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda as gemm

    gemm.launches = counts["w4a8_fused"]
    attn.launches = counts["paged_decode_attn"]
    attn.frozen_launches = counts["paged_decode_attn_frozen"]


def _live_pool_check(torch, srv, gen):
    """Every layer of the live pool, at a step where every active row is
    decoding over a table that holds frozen ids: the frozen variant and
    its plain version on the same q must agree to ATTN_TOL, and the same
    call with ``k_fz_shift + 1`` (every frozen K halved) must read at least
    10x above it. q is scaled to the layer's K so the scores are O(1).
    Returns (largest error, smallest fault reading). Its launches are not
    the main path's: the counts are restored."""
    from repro_torch.runtime import kv_cache as kvc

    saved = _counts()
    rows = [s for s, r in enumerate(srv.active) if r is not None]
    table = torch.as_tensor(srv.page_table[rows]).to(DEV)
    kv_lens = torch.as_tensor(srv.lengths[rows]).to(DEV)
    err, fault = 0.0, math.inf
    for pool in srv.pools:
        for i in range(pool["k"].shape[0]):
            layer = {name: leaf[i] for name, leaf in pool.items()}
            k_rms = float(kvc.gather_pages(layer, "k", kvc.PagedState(table, kv_lens))
                          .pow(2).mean().sqrt())
            q = (torch.randn((len(rows), srv.cfg.n_heads, srv.cfg.resolved_head_dim),
                             generator=gen, device=DEV) * (2.0 / max(k_rms, 1e-6))
                 ).to(torch.bfloat16)
            kernel, plain = _frozen_calls(layer, table, kv_lens, q)
            o_p = plain()
            err = max(err, float((kernel() - o_p).abs().max()))
            layer["k_fz_shift"] = layer["k_fz_shift"] + 1
            kernel, _ = _frozen_calls(layer, table, kv_lens, q)
            fault = min(fault, float((kernel() - o_p).abs().max()))
    torch.cuda.synchronize()
    _set_counts(saved)
    if err > ATTN_TOL:
        fail(f"live pool: the frozen variant differs from its plain version by {err:.3g} > "
             f"{ATTN_TOL}")
    if fault < 10 * ATTN_TOL:
        fail(f"live pool: the injected fault (k_fz_shift + 1) reads {fault:.3g} < 10 x {ATTN_TOL}")
    return err, fault


def phase_prefix(torch, cfg, packed, card):
    """The reference Server's default path at full width: the mixed engine,
    the prefix cache and FP8 pages with an FP4 frozen region."""
    import numpy as np

    from repro_torch.runtime import serve

    config = serve.ServerConfig(
        slots=4, max_seq=1024, page_size=64, a_fmt="fp8_e4m3",
        cache=serve.CachePolicy(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1"), prefix_cache=True)
    srv = serve.Server(packed, cfg, config)
    if srv.engine != "mixed":
        fail(f"the default engine is {srv.engine!r}, not the mixed engine")
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    system = rng.integers(2, cfg.vocab_size, 512).tolist()  # 8 pages of 64
    tails = rng.integers(16, 201, size=8)
    waves = [[serve.Request(rid=4 * w + i, max_new=32, prompt=system + rng.integers(
        2, cfg.vocab_size, int(tails[4 * w + i])).tolist()) for i in range(4)] for w in range(2)]
    _set_counts(dict.fromkeys(_counts(), 0))
    step_ms = {"decode": [], "mixed": []}
    live, t_live = None, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:  # the second wave is submitted after the first drains
        for r in wave:
            srv.submit(r)
        while True:
            prefilled = srv.stats["prefill_tokens"]
            s0 = time.perf_counter()
            if not srv.step():
                if srv.queue:
                    fail("serving starved")
                break
            torch.cuda.synchronize()
            step_ms["decode" if srv.stats["prefill_tokens"] == prefilled else "mixed"].append(
                (time.perf_counter() - s0) * 1e3)
            active = [s for s, r in enumerate(srv.active) if r is not None]
            if (live is None and len(active) == srv.slots and srv._pick_prefill_slot() is None
                    and all((srv.page_table[s] >= srv._frozen_base).any() for s in active)):
                c0 = time.perf_counter()
                live = _live_pool_check(torch, srv, gen)
                t_live = time.perf_counter() - c0
    wall = time.perf_counter() - t0 - t_live
    launches = _counts()
    results = [r.result() for r in srv.finished]
    if len(results) != 8 or not all(r.ok for r in results):
        fail(f"not every request ended ok: {[(r.rid, r.status) for r in results]}")
    if live is None:
        fail("no decode step had every row decoding over frozen pages: live check not run")
    st = srv.stats
    steps, programs, n_layers = st["steps"], st["programs"], cfg.n_layers
    # the mixed engine runs one program per step (decode rows plus at most
    # one prefill chunk): 6 GEMMs a layer each, and one decode attention a
    # layer each, always the frozen variant over a pool with a frozen region
    want = {"w4a8_fused": 6 * n_layers * programs, "paged_decode_attn": 0,
            "paged_decode_attn_frozen": n_layers * steps}
    if launches != want or programs != steps or launches["paged_decode_attn_frozen"] <= 0:
        fail(f"kernel launches {launches}, want {want} ({programs} programs, {steps} steps)")
    if st["fp4_frozen_pages"] < 8 or st["prefix_hit_pages"] <= 0:
        fail(f"the system prompt did not freeze and hit: {st}")
    res = srv.cache_residency()
    ratio = res["frozen_bytes_per_token"] / res["active_bytes_per_token"]
    n_tok = sum(len(r.tokens) for r in results)
    log(f"[6 prefix] opt-125m W4A8, mixed engine, prefix cache, fp8 pages + fp4_e2m1 frozen "
        f"pages, {config.slots} slots, 8 requests (512-token system prompt + 16-200 token "
        f"tails, 32 new tokens) in 2 waves, on {card}:")
    log(f"    {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s; {steps} steps: "
        f"median pure decode step {statistics.median(step_ms['decode']):.2f} ms over "
        f"{len(step_ms['decode'])}, median mixed step {statistics.median(step_ms['mixed']):.2f} "
        f"ms over {len(step_ms['mixed'])}")
    log(f"    prefix_hit_pages {st['prefix_hit_pages']}, prefix_hit_tokens "
        f"{st['prefix_hit_tokens']}, fp4_frozen_pages {st['fp4_frozen_pages']}, prefix_reclaims "
        f"{st['prefix_reclaims']}, prefill_tokens {st['prefill_tokens']}, prefix hit rate "
        f"{srv.prefix_hit_rate():.4f}; frozen/active bytes "
        f"per token {res['frozen_bytes_per_token']:.1f}/{res['active_bytes_per_token']:.1f} = "
        f"{ratio:.4f}")
    log(f"    launches {launches} (want {want})")
    log(f"    live pool, {n_layers} layers: frozen variant vs plain max|err| {live[0]:.3g} "
        f"(tolerance {ATTN_TOL}); injected fault k_fz_shift + 1 reads {live[1]:.3g} "
        f"(>= {10 * ATTN_TOL} required)")
    for i in range(srv.slots):  # busy share: 4 hits on the system prompt, all decoding
        srv.submit(serve.Request(rid=100 + i, max_new=8, prompt=system + rng.integers(
            2, cfg.vocab_size, 100).tolist()))
    for _ in range(4 * srv.slots):
        if srv._pick_prefill_slot() is None and all(r is not None for r in srv.active):
            break
        srv.step()
    else:
        fail("the profiled requests never all reached decode")
    log(_profiled(torch, srv, 3, "4 rows over 9 frozen + 1 fp8 pages"))
    return launches, live


def main():
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run this script from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32, as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    gemm, attn, frozen = phase_kernels(torch)
    cfg, packed, t_pack = _opt_125m()
    log(f"    opt-125m init + W4A8 pack on the card: {t_pack:.1f} s")
    launches = phase_serve(torch, cfg, packed)
    phase_cpu(torch, cfg, packed)
    launches_6, live = phase_prefix(torch, cfg, packed, card)

    # one decode step of opt-125m at 4 slots: per layer q, k, v, o (768->768),
    # up (768->3072) and down (3072->768) at M=4, and one attention launch
    per_layer = [(4, 768, 768)] * 4 + [(4, 768, 3072), (4, 3072, 768)]

    def step_sum(key):
        return 12 * sum(gemm[s][key] for s in per_layer)

    t_bytes = 12 * sum(gemm[s]["bytes"] for s in per_layer) / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * sum(gemm[s]["flops"] for s in per_layer) / PEAK_FLOPS["bf16"] * 1e3
    a = attn["fp8_e4m3"]
    kernels = [
        {"name": "w4a8_fused", "route": "cuda", "source": "src/repro_torch/csrc/w4a8_fused.cu",
         "replaces": "src/repro/kernels/w4a8_fused.py:169", "launches": launches["w4a8_fused"],
         "max_abs_err": max(r["max_abs_err"] for r in gemm.values()),
         "ms": step_sum("ms"), "plain_ms": step_sum("plain_ms"),
         "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": step_sum("library_ms"),
         "per": "one opt-125m decode step: 72 launches at M=4"},
        {"name": "paged_decode_attn", "route": "cuda", "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:131",
         "launches": launches["paged_decode_attn"],
         "max_abs_err": max(r["max_abs_err"] for r in attn.values()),
         "ms": 12 * a["ms"], "plain_ms": 12 * a["plain_ms"], "bound_ms": 12 * a["bound_ms"],
         "bound_by": a["bound_by"], "library_ms": 12 * a["library_ms"],
         "per": "12 launches (one per layer), fp8 pages, B=4, contexts 2048/1337/300/1"},
        {"name": "paged_decode_attn_frozen", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:131 (frozen)",
         "launches": launches_6["paged_decode_attn_frozen"],
         "max_abs_err": max(frozen["max_abs_err"], live[0]),
         "ms": 12 * frozen["ms"], "plain_ms": 12 * frozen["plain_ms"],
         "bound_ms": 12 * frozen["bound_ms"], "bound_by": frozen["bound_by"],
         "library_ms": 12 * frozen["library_ms"],
         "per": "12 launches (one per layer), fp8 pages with half of each row's full pages "
                "in the fp4 frozen region, B=4, contexts 2048/1337/300/1; launches from phase 6"},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
