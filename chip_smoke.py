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
              every kernel and its library call also by device time from
              CUDA graphs (event pairs around a short call read the host's
              enqueue time), with the bound's share of it; then every other
              variant the wrappers accept (no M2, no LoRC, E3M0 weights,
              activations on E5M2 or taken as they are, a sliding window),
              checked but not timed; every W4A8 and decode-attention check
              launches twice and the two outputs must be bit-identical; the
              frozen-region variant of decode attention (FP8 pages with half
              of each row's full pages in the packed FP4 region) timed the
              same way, and checked at an odd head width and with a window;
              both decode-attention variants also at the split plan's edges
              (a row at kv_len 0, rows ending on a split boundary, a window
              starting on one), with NaN planted outside the valid tokens
              (stale page tails, the null page, the frozen dummy row), and
              at g = 4 query heads a KV head (H 32, KV 8, hd 128);
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
              fault must read far above the tolerance);
7. mla     -- MiniCPM3-4B (MLA, 62 layers) at full width, random weights
              initialized and packed on the card, on phase 6's server and
              traffic: every request ok, every route's launches equal to
              their invariant (7 x 62 GEMMs, 62 of each batched GEMM
              orientation and 62 frozen latent-decode launches a step, no
              GQA attention), the live latent-pool check with an injected
              fault, and a profiled decode step;
8. mla cpu -- MiniCPM3 at full width cut to 2 layers against the CPU plain
              path, free-running, teacher-forced at each attention block
              and at each batched-GEMM and latent-decode call, with two
              injected faults (wk_b's LoRC dropped in the batched kernel,
              the latent decode one token short);
9. moe     -- OLMoE-1B-7B (64 experts top-8, 16 layers) at full width,
              random weights initialized and packed on the card, on phase
              6's server and traffic: every request ok, every route's
              launches equal to their invariant (4 x 16 GEMMs, 3 x 16
              batched expert GEMMs with FP8 activations and 16 frozen GQA
              decode launches at hd 128 a step), the live-pool check with an
              injected fault, and a profiled decode step;
10. moe cpu -- phase 9's model cut to 2 layers against the CPU plain path,
              free-running and teacher-forced at each MoE layer and each
              expert GEMM call, with the router's experts compared and two
              injected faults (wd's LoRC dropped, one expert of wu reading
              its neighbour's weights);
11. kernel api -- the kernels no served path reaches, through the kernel
              API's entry points: the split W4A8 pipeline (ops.act_quant,
              the bf16 cast, ops.w4a8_matmul_split, LoRC by two bf16
              matmuls) at opt-125m's and OLMoE's GEMM shapes and causal
              flash attention at opt-125m's, OLMoE's and MiniCPM3's
              materialized-MLA prefill shapes, with the launch counts read
              around that run; then each of the three kernels against its
              plain version (act_quant bit-identical, the split GEMM within
              1e-4 of max|y|, flash attention within 3e-2 bf16 / 1e-4 f32
              and each query row within 2^-7 / 1e-5 of its norm), timed with
              its bound and one PyTorch call, also by device time from CUDA
              graphs, without launch overhead; act_quant beside the launch
              floor (a one-element fill_ timed the same way), its bound's
              share printed raw and above the floor, and checked
              bit-identical on every path of its launch plan (block, and
              clusters of 2 to 8 blocks, odd sizes included; 4-element and
              one-element accesses; scalar heads and tails; NaN and Inf rows;
              E5M2); the others' variants checked,
              injected faults (the split GEMM without its s_max finalize;
              the causal mask one key short; one KV tile past key 1024
              staged twice), and the split
              pipeline against the fused kernel on the same packed weights,
              timed at every GEMM shape and the kernel microbench's m256,
              decode64 and lorc16 (names w4a8_split_<tag> / w4a8_fused_<tag>,
              with the ratio split / fused; the ratio is reported, not gated);
12. pressure -- opt-125m on phase 6's server and 8 requests, all submitted
              at once (two at priority 1, one with a deadline), on 16 active
              pages (6 frozen pages, no headroom page), a spill budget of 8
              pages and a fault plan (a NaN decode row, the second spill's
              bytes flipped, two blanked allocator ticks), audited every
              step: at least 2 preemptions, a resume from bytes, a spill
              eviction and exactly 1 integrity failure; only the poisoned
              request fails; every restored page equals its spill byte for
              byte; the launches equal phase 6's invariants; every stream no
              fault hit equals a fully backed, fault-free run's, up to one
              tie (top-2 gap under 2^-4 of the largest |logit|); the median
              spill and restore time a page are printed, not gated.

Phase 3 also checks and times MiniCPM3's kernels (the GEMM at its 7
shapes, the batched and transposed GEMM at E=40, and the latent decode
kernel over bf16, FP8 and FP8 + FP4 frozen pages) and OLMoE's (the GEMM at
2048 -> 2048, the batched GEMM with FP8 activations over 64 expert slabs
at M=4 and M=260, each as served (routed: each token's row nonzero in 8
of the 64 slabs) and dense, and both GQA decode variants at KV=16, hd
128), and holds the quantized paths' zero-row edge cases against the plain
version: a slab whose only nonzero row is its last, a row whose one
nonzero element is 1e-30, and a row with a NaN, which must come out NaN in
every column.

The last two lines are the card line and ``{"ok": true, "device": ...}``.
The script imports nothing of jax and nothing of the JAX package.
"""
import json
import math
import re
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
# phase 8, MiniCPM3 (2 layers, full widths; see phase_mla_cpu and PERF.md).
# Free-running logits and teacher-forced attention blocks: gross bounds on
# the sound routes, set from an H100's readings with a margin (the kernels
# read 0.103 and 0.0326, the plain versions on the card 0.084 and 0.0035).
# The kernel calls fed the card's operands: the sound kernels compute the
# plain versions' products in another f32 order (phase 3: wk_b's within
# 5e-7), an injected fault moves a share of the output (wk_b's LoRC term,
# the newest token's attention weight); MLA_OP_RTOL was set between the two
# before the first reading. wv_b applies M2 after its K loop, the plain
# version rounds each scaled weight to bf16 (at most 2^-9 of it).
MLA_LOGIT_RTOL = 0.15
MLA_BLOCK_RTOL = 0.06
MLA_OP_RTOL = 1e-4
MLA_WVB_RTOL = 1e-2
# phase 10, OLMoE-1B-7B (2 layers, full widths; see phase_moe_cpu and
# PERF.md). Every expert GEMM call fed the card's operands: the kernel
# applies M2 after its K loop where the plain version rounds each scaled
# weight to bf16 (about 1e-3 of the output on random weights, CPU), and
# wd's LoRC term is about 2.6e-2 of the output; MOE_OP_RTOL was set from
# those before the first reading on the card, a decade above the one and
# under the other. MOE_TIE: a router probability gap below which the
# card and the CPU may pick another expert (one f32 ulp of a 2048-term
# dot moves a probability by ~1e-7). MOE_LOGIT_RTOL: a gross bound only,
# raised from 0.15 after two readings on an H100: over 2 layers of random
# weights and FP8 quantization the sound routes read 0.12 and 0.17 of the
# largest |logit| (the plain versions on the card 0.10 and 0.11), as much
# as both injected faults (0.19-0.20), so free-running logits tell no
# subtle fault from sound arithmetic; 0.3 still fails a broken path.
MOE_OP_RTOL = 1.5e-2
MOE_TIE = 1e-5
MOE_LOGIT_RTOL = 0.3
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


def _timed(torch, timer, kernel, plain, library):
    """A phase 3 kernel's times: event pairs around each call (``ms``,
    ``plain_ms``, ``library_ms``) and the device time of the kernel and of
    its library call from CUDA graphs (``device_ms``, ``library_device_ms``:
    see ``_device_ms``), which leaves out the host's enqueue time that an
    event pair reads around a short call."""
    return dict(ms=timer.ms(kernel), device_ms=_device_ms(torch, timer, kernel),
                plain_ms=timer.ms(plain), library_ms=timer.ms(library),
                library_device_ms=_device_ms(torch, timer, library))


def _dev(row):
    """The device-time part of a phase 3 log line."""
    return (f"device {row['device_ms']:.4f} ms (library {row['library_device_ms']:.4f} ms, "
            f"bound share {row['bound_ms'] / row['device_ms']:.3f})")


# -- phases -----------------------------------------------------------------------
def phase_device():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = out.strip().splitlines()[0].strip()
    log(f"[1 device] {card}")
    return card


PTXAS = {}  # source -> [{"fn", "registers", "spill_stores", "spill_loads"}], from phase 2


def _ptxas_table(out, nvcc):
    """Each kernel instantiation's registers and spill bytes from nvcc's
    -Xptxas=-v output, its name demangled by the toolkit's cu++filt."""
    rows, fn, spill = [], None, (0, 0)
    for line in out.splitlines():
        if (m := re.search(r"Compiling entry function '([^']+)'", line)):
            fn, spill = m.group(1), (0, 0)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    names = [r[0] for r in rows]
    filt = Path(nvcc).with_name("cu++filt")
    if names and filt.exists():
        got = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(got) == len(names):  # "void <unnamed>::k<(int)8, ...>(<unnamed>::Args)" -> "k<8, ...>"
            names = [re.sub(r"\((int|bool)\)|<unnamed>::|\(anonymous namespace\)::|^void ", "",
                            n).rsplit("(", 1)[0] for n in got]
    return [{"fn": n, "registers": r[1], "spill_stores": r[2], "spill_loads": r[3]}
            for n, r in zip(names, rows)]


def _ptxas_summary(rows):
    """A source's instantiations in brief, for the kernels line; None when
    no build log of the source was read."""
    if not rows:
        return None
    return {"instantiations": len(rows),
            "registers": [min((r["registers"] for r in rows), default=0),
                          max((r["registers"] for r in rows), default=0)],
            "spill_bytes_max": max((r["spill_stores"] + r["spill_loads"] for r in rows),
                                   default=0)}


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    done = build.build_all()
    log(f"[2 build] {len(build.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"({' '.join(build.FLAGS)}); each source ready after: "
        + ", ".join(f"{n} {sec:.1f} s" for n, sec in done.items()))
    for name, out in build.build_logs.items():  # registers and spills of every instantiation
        PTXAS[name] = _ptxas_table(out, build.nvcc_path())
        for r in PTXAS[name]:
            log(f"    {name}: {r['fn']}: {r['registers']} registers, spill stores "
                f"{r['spill_stores']} B, loads {r['spill_loads']} B")


def _packed(torch, k, n, gen, w_fmt="fp4_e2m1", scale_mode="m2", lorc_rank=8, group_size=256):
    """A random (n, k) weight from ``gen``, scaled by 1/sqrt(k), packed by the
    port's ``pack_linear`` (RTN, FP8 E4M3 activations)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_linear

    policy = QuantPolicy(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=group_size,
                         scale_mode=scale_mode, lorc_rank=lorc_rank)
    w = (torch.randn((n, k), generator=gen, device=DEV) / math.sqrt(k)).to(torch.bfloat16)
    return pack_linear(w, policy)


def _same_bits(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _deterministic(torch, kernel, y, what):
    """A second launch on the same inputs must write the same bits: the
    kernel sums in a fixed order (no atomics)."""
    y2 = kernel()
    torch.cuda.synchronize()
    if not _same_bits(torch, y, y2):
        fail(f"{what}: two launches on the same inputs differ (max |diff| "
             f"{float((y.float() - y2.float()).abs().max())})")


def _w4a8_check(torch, m, k, n, gen, scale_mode="m2", lorc_rank=8, w_fmt="fp4_e2m1",
                a_fmt="fp8_e4m3"):
    """A packed (n, k) weight and an (m, k) input; the kernel's output
    held against its plain version. Returns (packed, x, kernel, plain, err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda

    p = _packed(torch, k, n, gen, w_fmt, scale_mode=scale_mode, lorc_rank=lorc_rank)
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    args = (x, p.codes, p.scale, p.s_max, p.shifts, p.lorc_a, p.lorc_b)
    kw = dict(w_fmt=p.w_fmt, a_fmt=a_fmt, group_size=p.group_size)
    kernel = lambda: w4a8_fused_matmul_cuda(*args, **kw)
    plain = lambda: ref.w4a8_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, **kw)
    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((y_k.float() - y_p.float()).abs().max())
    what = (f"w4a8_fused M={m} {k}->{n} {w_fmt} a_fmt={a_fmt} scale_mode={scale_mode} "
            f"lorc_rank={lorc_rank}")
    _deterministic(torch, kernel, y_k, what)
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
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    w4a8_fused M={m:3d} {k:4d}->{n:4d}: kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  library(bf16 matmul) {row['library_ms']:.4f} ms  bound "
        f"{b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)"
        f"  max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


ATTN_LENS = [2048, 1337, 300, 1]  # ragged contexts, up to 2048 tokens (32 pages of 64)


def _stale_nan(layer, table, lens, page, fmt, frozen=False, names=("k", "v")):
    """NaN where no valid token lies: in bf16 pages the tail of each row's
    last page past its length, and the whole null page (id P); FP8 and FP4
    codes all decode finite, so there the null page's s_max is NaN, and with
    the frozen region also the dummy row's, with every second row's unused
    table entries pointed at the dummy id. The outputs must stay finite.
    ``names``: the layer's stores (K and V; MLA's "ckv" and "krope")."""
    n_null = layer[names[0]].shape[0] - 1
    nan = float("nan")
    for name in names:
        if fmt:
            layer[name + "_smax"][n_null] = nan
        else:
            layer[name][n_null] = nan
            for row, n in enumerate(lens):
                if n % page:
                    layer[name][int(table[row, (n - 1) // page]), n % page:] = nan
        if frozen:
            layer[name + "_fz_smax"][-1] = nan
    if frozen:
        dummy = n_null + layer[names[0] + "_fz"].shape[0]  # P + 1 + nfz
        for row, n in enumerate(lens):
            if row % 2:
                table[row, -(-n // page):] = dummy


def _attn_held(torch, o_k, o_p, kernel, what, nan):
    """The kernel's output against its plain version, bit-identical on a
    second launch, finite where NaN was planted outside the valid tokens."""
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    _deterministic(torch, kernel, o_k, what)
    if nan and not bool(torch.isfinite(o_k).all()):
        fail(f"{what}: a NaN planted outside the valid tokens reached the output")
    if not torch.allclose(o_k, o_p, rtol=ATTN_TOL, atol=ATTN_TOL):
        fail(f"{what} disagrees with its plain version: max |err| {err}")
    return err


def _attn_check(torch, fmt, gen, window=0, kv=12, hd=64, h=None, lens=None, nan=False):
    """A random pool at the decode shapes of opt-125m (``kv`` heads of width
    ``hd``; OLMoE-1B-7B: 16 of 128; ``h`` query heads, ``kv`` by default)
    and the kernel's output held against its plain version (and launched
    twice, bit-identical). ``nan``: see ``_stale_nan``. Returns the
    operands, the two callables and the error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
    from repro_torch.runtime import kv_cache as kvc

    b, page = 4, 64
    lens = lens or ATTN_LENS
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
    if nan:
        _stale_nan(layer, table, lens, page, fmt)
    table = table.to(DEV)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = torch.randn((b, h or kv, hd), generator=gen, device=DEV).to(torch.bfloat16)
    sc = ((layer["k_smax"], layer["k_shift"], layer["v_smax"], layer["v_shift"]) if fmt
          else (None,) * 4)
    kernel = lambda: paged_decode_attn_cuda(q, layer["k"], layer["v"], *sc, table, kv_lens,
                                            fmt=fmt, window=window)
    plain = lambda: ref.paged_decode_attn_ref(q, layer["k"], layer["v"], *sc, table, kv_lens,
                                              fmt=fmt, window=window)
    o_k, o_p = kernel(), plain()
    what = (f"paged_decode_attn ({fmt or 'bf16'} pages, H {h or kv}, KV {kv}, hd {hd}, "
            f"window {window}, lens {lens}{', NaN planted' if nan else ''})")
    err = _attn_held(torch, o_k, o_p, kernel, what, nan)
    return layer, table, kv_lens, lens, q, o_k, kernel, plain, err


def _attn_case(torch, timer, fmt, gen, kv=12, hd=64):
    from repro_torch.runtime import kv_cache as kvc

    b, page = 4, 64
    pp = 2048 // page
    layer, table, kv_lens, lens, q, o_k, kernel, plain, err = _attn_check(torch, fmt, gen,
                                                                         kv=kv, hd=hd)
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
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    paged_decode_attn {fmt or 'bf16'} pages B={b} H=KV={kv} hd={hd} page={page} ctx={lens}: "
        f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(SDPA) "
        f"{row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)  max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


def _frozen_layer(torch, gen, hd, kv=12, lens=None, nan=False):
    """A random mixed-precision pool layer at the decode shapes of opt-125m
    (B=4, KV=12, page 64, contexts ``ATTN_LENS``; OLMoE: KV=16, hd 128)
    and its table: the first half of each row's full pages sit in the
    packed FP4 frozen region (ids >= P+1), the rest are FP8 pages. ``nan``:
    see ``_stale_nan``. Returns (layer, table, kv_lens, lens, frozen pages
    per row)."""
    from repro_torch.runtime import kv_cache as kvc

    b, page = 4, 64
    lens = lens or ATTN_LENS
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
    if nan:
        _stale_nan(layer, table, lens, page, "fp8_e4m3", frozen=True)
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


def _attn_frozen_check(torch, gen, hd=64, window=0, kv=12, h=None, lens=None, nan=False):
    layer, table, kv_lens, lens, n_frozen = _frozen_layer(torch, gen, hd, kv, lens, nan)
    q = torch.randn((4, h or kv, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kernel, plain = _frozen_calls(layer, table, kv_lens, q, window)
    o_k, o_p = kernel(), plain()
    what = (f"paged_decode_attn frozen variant (H {h or kv}, KV {kv}, hd {hd}, window {window}, "
            f"lens {lens}{', NaN planted' if nan else ''})")
    err = _attn_held(torch, o_k, o_p, kernel, what, nan)
    return layer, table, kv_lens, lens, n_frozen, q, o_k, kernel, plain, err


def _attn_edge_checks(torch, gen, kv, hd):
    """Rows 2 and 2b where the split plan has edges, at KV heads of width
    hd: a row at kv_len 0 (must return 0), rows ending exactly on a split
    boundary and one token past it, a window starting exactly on one; NaN
    planted outside the valid tokens. Returns the largest error of each
    row."""
    from repro_torch.kernels.decode_attn import decode_attn_plan

    span = decode_attn_plan(4, kv, kv, hd, 64, 2048 // 64).pps * 64
    lens = [2 * span, 0, span, span + 1]
    worst = [0.0, 0.0]
    for window in (0, span):
        for i, check in enumerate((lambda: _attn_check(torch, "fp8_e4m3", gen, window, kv, hd,
                                                       lens=lens),
                                   lambda: _attn_check(torch, None, gen, window, kv, hd,
                                                       lens=lens),
                                   lambda: _attn_frozen_check(torch, gen, hd, window, kv,
                                                              lens=lens))):
            *_, o_k, _, _, err = check()
            if bool(o_k[1].ne(0).any()):
                fail(f"paged_decode_attn check {i} (window {window}): the kv_len 0 row is not 0")
            worst[i // 2] = max(worst[i // 2], err)
    for fmt in ("fp8_e4m3", None):
        worst[0] = max(worst[0], _attn_check(torch, fmt, gen, 0, kv, hd, nan=True)[-1])
    worst[1] = max(worst[1], _attn_frozen_check(torch, gen, hd, 0, kv, nan=True)[-1])
    log(f"    paged_decode_attn KV={kv} hd={hd}, split span {span} tokens: kv_len 0, lens on "
        f"and past a split boundary, a window from one, NaN outside the valid tokens: max|err| "
        f"{worst[0]:.3g} (fp8, bf16 pages), {worst[1]:.3g} (frozen variant)")
    return worst


def _attn_frozen_case(torch, timer, gen, kv=12, hd=64):
    from repro_torch.runtime import kv_cache as kvc

    b, page = 4, 64
    layer, table, kv_lens, lens, n_frozen, q, o_k, kernel, plain, err = _attn_frozen_check(
        torch, gen, hd=hd, kv=kv)
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
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    paged_decode_attn frozen variant, fp8 pages + {sum(n_frozen)} fp4 frozen pages "
        f"B={b} H=KV={kv} hd={hd} page={page} ctx={lens}: kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  library(SDPA) {row['library_ms']:.4f} ms  bound "
        f"{b_ms * 1e3:.2f} us ({by}; {nbytes} B / 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)  max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


def _batched_check(torch, transpose, m, gen, scale_mode="m2", lorc_rank=8, w_fmt="fp4_e2m1"):
    """MiniCPM3's absorbed head projections: a packed (40 * 64, 256) weight
    viewed per head (``packed_head_view``), wk_b transposed (x (40, M, 64)
    -> (40, M, 256)) or wv_b normal (x (40, M, 256) -> (40, M, 64)), bf16
    activations unquantized; the kernel held against its plain version.
    Returns (view, x, kernel, plain, err)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_linear
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda
    from repro_torch.models.layers import packed_head_view

    heads, n, r = 40, 64, 256
    policy = QuantPolicy(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=256,
                         scale_mode=scale_mode, lorc_rank=lorc_rank)
    w = (torch.randn((heads * n, r), generator=gen, device=DEV) / math.sqrt(r)).to(torch.bfloat16)
    v = packed_head_view(pack_linear(w, policy), heads)
    x = torch.randn((heads, m, n if transpose else r), generator=gen, device=DEV).to(torch.bfloat16)
    kw = dict(w_fmt=w_fmt, group_size=v.group_size, transpose_w=transpose)
    kernel = lambda: w4a8_fused_batched_cuda(x, v.codes, v.scale, v.s_max, v.shifts, v.lorc_a,
                                             v.lorc_b, **kw)
    plain = lambda: ref.w4a8_batched_matmul_ref(x, v.codes, v.scale, v.lorc_a, v.lorc_b,
                                                a_fmt=None, **kw)
    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    what = (f"w4a8_fused batched {'transposed (wk_b)' if transpose else 'normal (wv_b)'} E=40 "
            f"M={m} {w_fmt} scale_mode={scale_mode} lorc_rank={lorc_rank}")
    _deterministic(torch, kernel, y_k, what)
    if not torch.allclose(y_k, y_p, rtol=W4A8_TOL, atol=W4A8_TOL):
        fail(f"{what} disagrees with its plain version: max |err| {err}")
    return v, x, kernel, plain, err


def _batched_case(torch, timer, transpose, gen):
    """The served variant (M2, LoRC 8) at a decode step's M=4, timed."""
    from repro_torch.kernels import ref

    v, x, kernel, plain, err = _batched_check(torch, transpose, 4, gen)
    w_deq = ref.dequant_packed_ref(v.codes, v.scale, v.w_fmt, v.group_size)  # (40, 64, 256)
    library = (lambda: torch.matmul(x, w_deq)) if transpose else \
        (lambda: torch.matmul(x, w_deq.transpose(1, 2)))
    e, n, in_f, m, r = 40, 64, 256, 4, v.lorc_a.shape[-1]
    d, n_out = (n, in_f) if transpose else (in_f, n)
    nbytes = (e * m * d * 2 + e * n * in_f // 2 + e * n * (in_f // v.group_size) + e * n * 4
              + e * n * r * 2 + r * in_f * 2 + e * m * n_out * 4)  # lorc_b: one factor for all heads
    flops = 2 * e * m * n * in_f + 2 * e * m * r * (n + in_f)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    name = "transposed (wk_b, 64->256)" if transpose else "normal (wv_b, 256->64)"
    log(f"    w4a8_fused batched {name} E=40 M=4: kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  library(bf16 matmul per head) {row['library_ms']:.4f} ms  "
        f"bound {b_ms * 1e3:.3f} us ({by}; {nbytes} B)  max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


OLMOE_EXPERTS = (("wu", 2048, 1024), ("wd", 1024, 2048))  # (weight, In, N); wg is wu's shape


def _moe_weights(torch, k, n, gen, scale_mode="m2", lorc_rank=8, w_fmt="fp4_e2m1"):
    """64 random (n, k) expert weights, packed by the port's ``_pack_batched``."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import _pack_batched

    policy = QuantPolicy(w_fmt=w_fmt, a_fmt="fp8_e4m3", group_size=256,
                         scale_mode=scale_mode, lorc_rank=lorc_rank)
    w = (torch.randn((64, n, k), generator=gen, device=DEV) / math.sqrt(k)).to(torch.bfloat16)
    return _pack_batched(w, policy)


def _moe_check(torch, p, m, gen, routed=False):
    """Row 1d at OLMoE-1B-7B's expert stacks: ``p`` 64 packed (n, k) expert
    weights (wu and wg 2048 -> 1024, wd 1024 -> 2048) and x (64, m, k) raw
    N(0,1) bf16 activations, quantized to FP8 in-kernel; with ``routed``
    they are as served: each of the m tokens' rows is nonzero in 8 of the
    64 slabs (its top-8 experts) and zero in the rest. The kernel held
    against its plain version. Returns (x, nonzero rows, kernel, plain,
    err, what)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda

    e, n, k, top_k = p.codes.shape[0], p.codes.shape[1], 2 * p.codes.shape[2], 8
    x = torch.randn((e, m, k), generator=gen, device=DEV).to(torch.bfloat16)
    if routed:  # token j's experts: the top 8 of random scores
        pick = torch.rand((m, e), generator=gen, device=DEV).topk(top_k, dim=-1).indices
        keep = torch.zeros((m, e), dtype=torch.bool, device=DEV).scatter_(1, pick, True)
        x = torch.where(keep.t()[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=DEV)).contiguous()
    rows = m * top_k if routed else m * e
    kw = dict(w_fmt=p.w_fmt, a_fmt="fp8_e4m3", group_size=p.group_size)
    kernel = lambda: w4a8_fused_batched_cuda(x, p.codes, p.scale, p.s_max, p.shifts, p.lorc_a,
                                             p.lorc_b, **kw)
    plain = lambda: ref.w4a8_batched_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, **kw)
    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    what = (f"w4a8_fused batched fp8 (row 1d) E={e} M={m} {k}->{n} {p.w_fmt}"
            f"{' routed (8 of 64 slabs per token)' if routed else ''} scale_mode="
            f"{'m2' if p.shifts is not None else 'none'} lorc_rank="
            f"{0 if p.lorc_a is None else p.lorc_a.shape[-1]}")
    _deterministic(torch, kernel, y_k, what)
    if not torch.allclose(y_k, y_p, rtol=W4A8_TOL, atol=W4A8_TOL):
        fail(f"{what} disagrees with its plain version: max |err| {err}")
    if routed and bool((y_k.abs().sum(-1) > 0).sum() != rows):
        fail(f"{what}: the zero rows do not come out zero")
    return x, rows, kernel, plain, err, what


def _hold_with_nan(torch, y_k, y_p, what):
    """``y_k`` within W4A8_TOL of ``y_p``, NaN where and only where it is NaN."""
    if not (torch.equal(y_k.isnan(), y_p.isnan())
            and torch.allclose(y_k.float(), y_p.float(), rtol=W4A8_TOL, atol=W4A8_TOL,
                               equal_nan=True)):
        fail(f"{what} disagrees with its plain version: max |err| "
             f"{float((y_k.float() - y_p.float()).nan_to_num().abs().max())}, NaN at "
             f"{int(y_k.isnan().sum())} entries, plain {int(y_p.isnan().sum())}")


def _compaction_checks(torch, gen, p):
    """The quantized paths' zero rows at their edges, rows 1d (the expert
    stack ``p``) and 1 (its first expert), each against its plain version at
    W4A8_TOL: in one slab only the last row is nonzero (M = 70: two row
    tiles of 64, the second ragged); in another one row's one nonzero
    element is 1e-30 (its scale is the 1e-12 floor, so it quantizes to zero,
    but it is no zero row); in a third one row holds a NaN beside two
    ordinary rows, and that row must come out NaN in every column."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda, w4a8_fused_matmul_cuda

    e, n, k, m = p.codes.shape[0], p.codes.shape[1], 2 * p.codes.shape[2], 70
    x = torch.zeros((e, m, k), dtype=torch.bfloat16, device=DEV)
    x[0, m - 1] = torch.randn(k, generator=gen, device=DEV).to(torch.bfloat16)
    x[1, 3, 17] = 1e-30
    x[2, :3] = torch.randn((3, k), generator=gen, device=DEV).to(torch.bfloat16)
    x[2, 5, 100] = float("nan")
    kw = dict(w_fmt=p.w_fmt, a_fmt="fp8_e4m3", group_size=p.group_size)
    y_k = w4a8_fused_batched_cuda(x, p.codes, p.scale, p.s_max, p.shifts, p.lorc_a, p.lorc_b, **kw)
    y_p = ref.w4a8_batched_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, **kw)
    torch.cuda.synchronize()
    what = f"w4a8_fused batched fp8 (row 1d) E={e} M={m} {k}->{n}, zero-row edge cases"
    _hold_with_nan(torch, y_k, y_p, what)
    if not (bool(y_k[2, 5].isnan().all()) and bool(y_k[0, m - 1].ne(0).any())
            and not bool(y_k[0, :m - 1].any())):
        fail(f"{what}: the NaN row is not NaN throughout, or the last row's slab is wrong")
    log(f"    {what}: max|err| {float((y_k - y_p).nan_to_num().abs().max()):.3g}, the NaN row NaN")
    s = lambda t: None if t is None else t[0].contiguous()
    for xs, case in ((x[0], "only the last row nonzero"), (x[1], "one element of 1e-30"),
                     (x[2], "a NaN row beside ordinary rows")):
        args = (xs, p.codes[0], p.scale[0], s(p.s_max), s(p.shifts), s(p.lorc_a), s(p.lorc_b))
        y_k = w4a8_fused_matmul_cuda(*args, **kw)
        y_p = ref.w4a8_matmul_ref(xs, p.codes[0], p.scale[0], s(p.lorc_a), s(p.lorc_b), **kw)
        torch.cuda.synchronize()
        _hold_with_nan(torch, y_k, y_p, f"w4a8_fused M={m} {k}->{n}, {case}")
    log(f"    w4a8_fused M={m} {k}->{n}: the three edge cases held against the plain version")


def _moe_case(torch, timer, p, m, gen, routed):
    """Row 1d with M2 and LoRC 8, timed. The bound counts the operations
    this input needs: the nonzero rows' products (the zero rows' are 0)."""
    from repro_torch.kernels import ref

    x, rows, kernel, plain, err, what = _moe_check(torch, p, m, gen, routed)
    w_deq = ref.dequant_packed_ref(p.codes, p.scale, p.w_fmt, p.group_size)  # (64, n, k)
    library = lambda: torch.bmm(x, w_deq.transpose(1, 2))
    (e, n, k), g, r = w_deq.shape, p.scale.shape[-1], p.lorc_a.shape[-1]
    nbytes = (e * m * k * 2 + e * n * k // 2 + e * n * g + e * n * 4 + (e * n * r + e * r * k) * 2
              + e * m * n * 4)
    flops = 2 * rows * n * k + 2 * rows * r * (k + n)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    {what}: kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(bf16 "
        f"bmm) {row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {nbytes} B, "
        f"{flops} FLOP)  max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


def _mla_layer(torch, gen, b, r, dr, page, lens, fmt, frozen, nan=False):
    """A random latent pool layer (ckv (P+1, page, r), krope (P+1, page,
    dr)) and its table: ``fmt`` pages, and with ``frozen`` the first half of
    each row's full pages in the packed FP4 region. ``nan``: see
    ``_stale_nan``. Returns (layer, table, kv_lens, frozen pages per row)."""
    from repro_torch.runtime import kv_cache as kvc

    pp = -(-max(lens) // page)
    n_pages = b * pp
    layer = {}
    for name, d in (("ckv", r), ("krope", dr)):
        for suffix, f in (("", fmt),) + ((("_fz", "fp4_e2m1"),) if frozen else ()):
            vals = torch.randn((n_pages + 1, page, 1, d), generator=gen, device=DEV)
            if f:
                codes, smax, shift = kvc.quantize_pages(vals, f)
                layer.update({name + suffix: codes[..., 0, :].contiguous(),
                              name + suffix + "_smax": smax, name + suffix + "_shift": shift})
            else:
                layer[name] = vals[..., 0, :].to(torch.bfloat16)
    table = torch.full((b, pp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED))
    fperm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 1))
    n_frozen = []
    for row, n in enumerate(lens):
        npg, nfr = kvc.pages_needed(n, page), (n // page) // 2 if frozen else 0
        table[row, :npg] = perm[row * pp: row * pp + npg].to(torch.int32)
        table[row, :nfr] = n_pages + 1 + fperm[row * pp: row * pp + nfr].to(torch.int32)
        n_frozen.append(nfr)
    if nan:
        _stale_nan(layer, table, lens, page, fmt, frozen, names=("ckv", "krope"))
    return layer, table.to(DEV), torch.tensor(lens, dtype=torch.int32, device=DEV), n_frozen


def _mla_calls(layer, table, kv_lens, q_lat, q_rope, scale):
    """The MLA latent decode kernel and its plain version on one pool layer
    (the variant follows the layer: bf16, FP8, FP8 + the frozen region)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attn import paged_mla_decode_attn_cuda

    fmt, frozen = ops._layer_formats(layer, "ckv")
    sc = ((layer["ckv_smax"], layer["ckv_shift"], layer["krope_smax"], layer["krope_shift"])
          if fmt else (None,) * 4)
    fz = ops._fz_operands(layer, ("ckv", "krope")) if frozen else {}
    args = (q_lat, q_rope, layer["ckv"], layer["krope"], *sc, table, kv_lens, scale)
    kw = dict(fmt=fmt, frozen=frozen, **fz)
    return (lambda: paged_mla_decode_attn_cuda(*args, **kw),
            lambda: ref.paged_mla_decode_attn_ref(*args, **kw))


MLA_SHAPE = dict(b=4, h=40, r=256, dr=32, page=64, lens=[2048, 1337, 300, 1])


def _mla_check(torch, gen, fmt, frozen, b, h, r, dr, page, lens, nan=False):
    """A random latent pool (``_mla_layer``) and the MLA decode kernel's
    output held against its plain version within ATTN_TOL, launched twice
    (bit-identical) and finite where NaN was planted (``nan``)."""
    layer, table, kv_lens, n_frozen = _mla_layer(torch, gen, b, r, dr, page, lens, fmt, frozen,
                                                 nan)
    q_lat = torch.randn((b, h, r), generator=gen, device=DEV).to(torch.bfloat16)
    q_rope = torch.randn((b, h, dr), generator=gen, device=DEV).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(96)  # MiniCPM3: 1 / sqrt(qk_nope + qk_rope)
    kernel, plain = _mla_calls(layer, table, kv_lens, q_lat, q_rope, scale)
    o_k, o_p = kernel(), plain()
    what = (f"paged_mla_decode_attn {fmt or 'bf16'} pages{' + fp4 frozen' if frozen else ''} "
            f"B={b} H={h} r={r} dr={dr} page={page}")
    err = _attn_held(torch, o_k, o_p, kernel, f"{what} lens {lens}"
                     f"{', NaN planted' if nan else ''}", nan)
    return layer, table, kv_lens, n_frozen, q_lat, q_rope, scale, kernel, plain, err, what


MLA_PAGES = (16, 48, 128)  # a split over 4 pages, over page edges off its own, half a page


def _mla_edge_checks(torch, gen):
    """Row 3 where the split plan has edges, at MLA_SHAPE's widths, over each
    page variant: a row at kv_len 0 (must return 0) and one at 1, rows
    ending exactly on a split boundary and one token past it; NaN planted
    outside the valid tokens (stale page tails, the null page, the frozen
    dummy row). Then at each page size of MLA_PAGES, where a split's 64
    tokens are not one page (frozen and FP8 pages mixed in one split at 16),
    with NaN planted. Every check launches twice, bit-identical. Then the injected
    fault: the combine dropping each row's last split, read as the kernel
    over the tokens before that split's first (as such a combine would sum
    them) against the plain version on all of them; it must read above
    ATTN_TOL. Returns ({variant: largest error}, the fault's reading)."""
    from repro_torch.kernels.decode_attn import mla_decode_plan

    h, r, dr, page = (MLA_SHAPE[k] for k in ("h", "r", "dr", "page"))
    span = mla_decode_plan(4, h, r, dr, page, 32).span
    worst = {}
    for fmt, fz in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False)):
        errs = []
        for lens in ([2 * span, 0, span, span + 1], [1, 0, 3 * span, 2 * span - 1]):
            *_, kernel, _, err, what = _mla_check(torch, gen, fmt, fz, 4, h, r, dr, page, lens)
            if bool(kernel()[1].ne(0).any()):
                fail(f"{what} lens {lens}: the kv_len 0 row is not 0")
            errs.append(err)
        errs.append(_mla_check(torch, gen, fmt, fz, 4, h, r, dr, page, MLA_SHAPE["lens"],
                               nan=True)[-2])
        for pg in MLA_PAGES:
            lens = [701, 2 * pg + 1, 3 * span, 0]
            *_, kernel, _, err, what = _mla_check(torch, gen, fmt, fz, 4, h, r, dr, pg, lens,
                                                  nan=True)
            if bool(kernel()[3].ne(0).any()):
                fail(f"{what} lens {lens}: the kv_len 0 row is not 0")
            errs.append(err)
        worst[(fmt, fz)] = max(errs)
    layer, table, kv_lens, _, q_lat, q_rope, scale, _, plain, _, _ = _mla_check(
        torch, gen, "fp8_e4m3", True, 4, h, r, dr, page, MLA_SHAPE["lens"])
    short = ((kv_lens - 1).clamp_min(0) // span) * span  # each row's last split's first token
    dropped = _mla_calls(layer, table, short.to(torch.int32), q_lat, q_rope, scale)[0]
    fault = float((dropped() - plain()).abs().max())
    if not fault > ATTN_TOL:
        fail(f"injected fault (the MLA combine without each row's last split) reads {fault:.3g} "
             f"<= {ATTN_TOL}: the check cannot tell it from a sound kernel")
    log(f"    paged_mla_decode_attn H={h} r={r} dr={dr}, split span {span} tokens: kv_len 0 and 1, "
        f"lens on and past a split boundary, NaN outside the valid tokens, pages of {page} and "
        f"{', '.join(map(str, MLA_PAGES))}, each launched twice (bit-identical): max|err| "
        + ", ".join(
            f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''} {e:.3g}" for (fmt, fz), e in worst.items())
        + f"; injected fault, the combine without each row's last split: max|err| {fault:.3g} "
        f"(> {ATTN_TOL} required)")
    return worst, fault


def _mla_case(torch, timer, gen, fmt, frozen):
    from repro_torch.runtime import kv_cache as kvc

    b, h, r, dr, page, lens = (MLA_SHAPE[k] for k in ("b", "h", "r", "dr", "page", "lens"))
    layer, table, kv_lens, n_frozen, q_lat, q_rope, scale, kernel, plain, err, what = \
        _mla_check(torch, gen, fmt, frozen, b, h, r, dr, page, lens)
    # the library yardstick: SDPA over the gathered, dequantized latents,
    # k = concat(ckv, krope) and v = ckv, one KV head broadcast to the H heads
    st = kvc.PagedState(table, kv_lens)
    ckv, kr = (kvc.gather_pages(layer, n, st).to(torch.bfloat16) for n in ("ckv", "krope"))
    k = torch.cat([ckv, kr], -1)[:, None].expand(b, h, -1, r + dr).contiguous()
    v = ckv[:, None].expand(b, h, -1, r).contiguous()
    q = torch.cat([q_lat, q_rope], -1)[:, :, None]
    mask = (torch.arange(table.shape[1] * page, device=DEV)[None, :] < kv_lens[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)
    library()
    fz_tok = sum(f * page for f in n_frozen)
    act_tok = sum(lens) - fz_tok
    esize = 1 if fmt else 2
    pages_read = sum(kvc.pages_needed(n, page) for n in lens)
    nbytes = (b * h * (r + dr) * 2 + act_tok * (r + dr) * esize
              + fz_tok * ((r + 1) // 2 + (dr + 1) // 2) + b * 4 + pages_read * 4
              + (pages_read * 2 * (4 + 4) if fmt else 0) + b * h * r * 4)
    # scores and the weighted latent sum, exact bf16 products on the tensor cores
    flops = sum(lens) * h * (2 * (r + dr) + 2 * r)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    {what} ctx={lens}{f' ({sum(n_frozen)} frozen pages)' if frozen else ''}: kernel "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(SDPA) "
        f"{row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {nbytes} B)  "
        f"max|err| {err:.3g}  "
        f"{_dev(row)}")
    return row


MINICPM3_GEMMS = ((2560, 768), (768, 3840), (2560, 288), (2560, 2560), (2560, 6400),
                  (2560, 6400), (6400, 2560))  # (K, N): wq_a wq_b wkv_a wo gate up down


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
    # the variants repro serves beside the default: E3M0 weights (PRESETS
    # ["w4a8_e3m0_fp"]), activations on E5M2 or taken as they are; at a
    # decode step's few rows and at 260 (the wgmma path)
    for w_fmt, a_fmt, mode in (("fp4_e3m0", "fp8_e4m3", "m2"), ("fp4_e2m1", "fp8_e5m2", "m2"),
                               ("fp4_e2m1", None, "m2"), ("fp4_e3m0", None, "none")):
        for m in (5, 260):
            err = _w4a8_check(torch, m, 2560, 768, gen, mode, 8, w_fmt, a_fmt)[-1]
            log(f"    w4a8_fused M={m:3d} 2560-> 768 {w_fmt} a_fmt={a_fmt} scale_mode={mode} "
                f"lorc_rank=8: max|err| {err:.3g}")
    for fmt in ("fp8_e4m3", None):
        err = _attn_check(torch, fmt, gen, window=300)[-1]
        log(f"    paged_decode_attn {fmt or 'bf16'} pages, window 300: max|err| {err:.3g}")
    for hd, window in ((9, 0), (64, 300)):
        err = _attn_frozen_check(torch, gen, hd=hd, window=window)[-1]
        frozen["max_abs_err"] = max(frozen["max_abs_err"], err)
        log(f"    paged_decode_attn frozen variant, hd {hd}, window {window}: max|err| {err:.3g}")
    err2, err2b = _attn_edge_checks(torch, gen, 12, 64)
    attn["fp8_e4m3"]["max_abs_err"] = max(attn["fp8_e4m3"]["max_abs_err"], err2)
    frozen["max_abs_err"] = max(frozen["max_abs_err"], err2b)
    # slice 3: MiniCPM3-4B's shapes (row 1 at a decode step; rows 1b, 1c, 3)
    for k, n in sorted(set(MINICPM3_GEMMS)):
        gemm[(4, k, n)] = _w4a8_case(torch, timer, 4, k, n, gen)
    batched = {tr: _batched_case(torch, timer, tr, gen) for tr in (False, True)}
    for tr in (False, True):
        for m, mode, rank in ((260, "m2", 8), (4, "none", 0), (260, "none", 8), (4, "m2", 0)):
            err = _batched_check(torch, tr, m, gen, mode, rank)[-1]
            batched[tr]["max_abs_err"] = max(batched[tr]["max_abs_err"], err)
            log(f"    w4a8_fused batched {'transposed' if tr else 'normal'} E=40 M={m} "
                f"scale_mode={mode} lorc_rank={rank}: max|err| {err:.3g}")
        for m in (4, 260):  # E3M0 weights
            err = _batched_check(torch, tr, m, gen, w_fmt="fp4_e3m0")[-1]
            batched[tr]["max_abs_err"] = max(batched[tr]["max_abs_err"], err)
            log(f"    w4a8_fused batched {'transposed' if tr else 'normal'} E=40 M={m} fp4_e3m0 "
                f"scale_mode=m2 lorc_rank=8: max|err| {err:.3g}")
    mla = {(fmt, fz): _mla_case(torch, timer, gen, fmt, fz)
           for fmt, fz in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False))}
    # tests/test_fp4_cache.py:268-272; odd widths; r past 512 (P . V in two column passes)
    for h, r, dr, page in ((3, 16, 8, 4), (3, 9, 5, 4), (20, 600, 40, 32)):
        for fmt, fz in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False)):
            *_, err, what = _mla_check(torch, gen, fmt, fz, 2, h, r, dr, page, [4 * page - 3, 2])
            mla[(fmt, fz)]["max_abs_err"] = max(mla[(fmt, fz)]["max_abs_err"], err)
            log(f"    {what}: max|err| {err:.3g}")
    edge, mla_fault = _mla_edge_checks(torch, gen)
    for key, err in edge.items():
        mla[key]["max_abs_err"] = max(mla[key]["max_abs_err"], err)
    mla[("fp8_e4m3", True)]["fault_combine_drops_last_split"] = mla_fault
    gemm[(4, 2048, 2048)] = _w4a8_case(torch, timer, 4, 2048, 2048, gen)  # OLMoE's q, k, v, o
    moe, olmoe_attn = _olmoe_kernels(torch, timer, gen)
    return gemm, attn, frozen, batched, mla, moe, olmoe_attn


def _olmoe_kernels(torch, timer, gen):
    """Slice 4: OLMoE-1B-7B's shapes. Row 1d (E=64, wu 2048->1024 and wd
    1024->2048) as served (M=4, each token's row nonzero in 8 of the 64
    slabs) and on raw activations at M=4 and 260, timed; the other M2 and
    LoRC variants checked at an M that is no multiple of the block rows.
    Rows 2 and 2b at KV=H=16, hd 128, timed; row 2 over bf16 pages and row
    2b with a window, the split plan's edges (``_attn_edge_checks``) and
    GQA at g = 4 (H 32, KV 8), checked."""
    moe = {}
    for name, k, n in OLMOE_EXPERTS:
        p = _moe_weights(torch, k, n, gen)
        moe[(name, "routed")] = _moe_case(torch, timer, p, 4, gen, routed=True)
        moe[(name, "routed260")] = _moe_case(torch, timer, p, 260, gen, routed=True)
        for m in (4, 260):
            moe[(name, m)] = _moe_case(torch, timer, p, m, gen, routed=False)
    _compaction_checks(torch, gen, p)
    for mode, rank, w_fmt in (("none", 0, "fp4_e2m1"), ("m2", 0, "fp4_e2m1"),
                              ("none", 8, "fp4_e2m1"), ("m2", 8, "fp4_e3m0")):
        p = _moe_weights(torch, 1024, 2048, gen, mode, rank, w_fmt)
        for routed in (False, True):
            *_, err, what = _moe_check(torch, p, 37, gen, routed)
            log(f"    {what}: max|err| {err:.3g}")
    attn = {"fp8_e4m3": _attn_case(torch, timer, "fp8_e4m3", gen, kv=16, hd=128),
            "frozen": _attn_frozen_case(torch, timer, gen, kv=16, hd=128)}
    err = _attn_check(torch, None, gen, kv=16, hd=128)[-1]
    attn["fp8_e4m3"]["max_abs_err"] = max(attn["fp8_e4m3"]["max_abs_err"], err)
    log(f"    paged_decode_attn bf16 pages KV=16 hd=128: max|err| {err:.3g}")
    err = _attn_frozen_check(torch, gen, hd=128, window=300, kv=16)[-1]
    attn["frozen"]["max_abs_err"] = max(attn["frozen"]["max_abs_err"], err)
    log(f"    paged_decode_attn frozen variant KV=16 hd=128, window 300: max|err| {err:.3g}")
    err2, err2b = _attn_edge_checks(torch, gen, 16, 128)
    # GQA at g = 4 (H 32 over KV 8, hd 128): four query heads a block share
    # each decoded element; no served model has g > 1
    for window in (0, 300):
        err2 = max(err2, _attn_check(torch, "fp8_e4m3", gen, window, 8, 128, h=32)[-1])
        err2b = max(err2b, _attn_frozen_check(torch, gen, 128, window, 8, h=32)[-1])
    log(f"    paged_decode_attn H=32 KV=8 hd=128 (g 4), windows 0 and 300: max|err| {err2:.3g} "
        f"(fp8 pages), {err2b:.3g} (frozen variant)")
    attn["fp8_e4m3"]["max_abs_err"] = max(attn["fp8_e4m3"]["max_abs_err"], err2)
    attn["frozen"]["max_abs_err"] = max(attn["frozen"]["max_abs_err"], err2b)
    return moe, attn


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
    _set_counts(dict.fromkeys(_counts(), 0))
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
    launches = _counts()
    results = [r.result() for r in srv.finished]
    if len(results) != len(prompt_lens) or not all(r.ok for r in results):
        fail(f"not every request ended ok: {[(r.rid, r.status) for r in results]}")
    n_tok = sum(len(r.tokens) for r in results)
    steps, programs = srv.stats["steps"], srv.stats["programs"]
    n_layers = cfg.n_layers
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": 6 * n_layers * programs,
            "paged_decode_attn": n_layers * steps}
    if launches != want or min(launches["w4a8_fused"], launches["paged_decode_attn"]) <= 0:
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
    # the split kernels of rows 2, 2b (GQA) or 3 (MLA) and their shared combine
    attn_ms = sum(dev_us(e) for e in kernels
                  if any(k in e.key for k in ("gqa_decode_", "mla_decode_", "split_combine_"))
                  ) / 1e3 / n_steps
    return (f"    profiled decode step ({what}): {wall_ms:.2f} ms wall, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), {launches:.0f} device launches; "
            f"decode attention (GQA or MLA latent, split + combine) {attn_ms:.3f} ms; "
            f"top: " + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / n_steps:.2f} ms" for e in top))


def _routes(torch, packed, family="dense"):
    """name -> (params, device, attributes of ``ops`` replaced for the run).
    The faults: ``no_lorc`` drops the LoRC correction (dense: from every
    linear, through the plain versions; MLA: from ``wk_b`` only, MoE: from
    ``wd`` only, through the batched kernel); ``short_kv`` reads decode
    attention one token short (the plain version; MLA: the MLA decode
    kernel); MoE has ``expert_swap`` instead: expert 0 of every ``wu``
    stack reads expert 1's weights (through the kernel)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map

    is_packed = lambda x: isinstance(x, PackedLinear)
    to_cpu = lambda t: t.apply(lambda x: x.cpu()) if is_packed(t) else t.cpu()
    drop = lambda t: dataclasses.replace(t, lorc_a=None, lorc_b=None) if is_packed(t) else t

    def swap(t):  # (L, E, ...) fields: expert 0 gets expert 1's slice
        t = t.clone()
        t[:, 0] = t[:, 1]
        return t

    def in_segments(part, name, fn):
        return {**packed, "segments": [
            {**seg, part: {**seg[part], **{k: {**v, name: fn(v[name])} for k, v in seg[part].items()
                                             if isinstance(v, dict) and name in v}}}
            for seg in packed["segments"]]}

    routes = {"card": (packed, DEV, {}),
              "card_plain": (packed, DEV, {"_route": lambda t: "cpu"}),  # the plain versions
              "cpu": (tree_map(to_cpu, packed, is_leaf=is_packed), "cpu", {})}
    if family == "moe":  # its faults run through the kernels themselves
        routes["no_lorc"] = (in_segments("ffn", "wd", drop), DEV, {})
        routes["expert_swap"] = (in_segments("ffn", "wu", lambda t: t.apply(swap)), DEV, {})
        return routes
    if family == "mla":
        attn = ops.paged_mla_decode_attn
        short = {"paged_mla_decode_attn": lambda ql, qr, layer, pt, lens, scale:
                 attn(ql, qr, layer, pt, lens - 1, scale)}
        routes["no_lorc"] = (in_segments("mixer", "wk_b", drop), DEV, {})
        routes["short_kv"] = (packed, DEV, short)
        return routes
    attn = ops.paged_decode_attn
    short = {"paged_decode_attn": lambda q, layer, pt, lens, window=0:
             attn(q, layer, pt, lens - 1, window=window)}
    plain = routes["card_plain"][2]
    routes["no_lorc"] = (tree_map(drop, packed, is_leaf=is_packed), DEV, plain)
    routes["short_kv"] = (packed, DEV, {**plain, **short})
    return routes


def _pools(cfg, n_pages, page, device):
    """One FP8 pool per segment: latent pages for MLA, K/V pages for GQA."""
    from repro_torch.models.transformer import segments_for
    from repro_torch.runtime import kv_cache as kvc

    if cfg.attn_kind == "mla":
        return [kvc.init_mla_pool(seg.count, n_pages, page, cfg.mla.kv_lora_rank,
                                  cfg.mla.qk_rope_dim, "fp8_e4m3", device=device)
                for seg in segments_for(cfg)]
    return [kvc.init_gqa_pool(seg.count, n_pages, page, cfg.n_kv_heads, cfg.resolved_head_dim,
                              "fp8_e4m3", device=device) for seg in segments_for(cfg)]


def _compare(torch, cfg, routes, forced, site="block", logit_rtol=LOGIT_RTOL, n_dec=4,
             seed=SEED):
    """Two requests (one prefill chunk, then ``n_dec`` decode steps; prompts
    from ``seed``) along every
    route, each with a pool of its own, all fed the card's greedy tokens.
    With ``forced``, every site of every route takes the card's input to
    that site, so a difference cannot compound. ``site`` "block" forces and
    reads whole blocks (the reading: the output's error over the reference
    block's update); "mixer" the MLA attention blocks (their output is the
    update); "ops" the MLA path's kernel calls -- ``w4a8_matmul_batched``
    (read apart as ``wk_b``, transposed, and ``wv_b``) and
    ``paged_mla_decode_attn`` (``attn``) -- each fed the card's operands
    (its activation; for the attention also the card's pool, table and
    lengths), the route's own weights (the reading: the output's error over
    the reference output); "moe_ops" the MoE path's (``moe_hooks``: the
    MoE layers, read as ``moe``, and their expert GEMMs, read as ``wu``,
    ``wg`` and ``wd``, fed the card's operands; the router's choices
    compared, ``routing``). Frobenius norms. Returns the readings {route:
    {"logits": share of the largest |logit|, site key: largest share}} and
    (agreeing greedy tokens, decisive ones, tokens)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import kv_cache as kvc

    page, pp = 64, 4
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (100, 37)]
    pools = {name: _pools(cfg, 2 * pp, page, d) for name, (_, d, _) in routes.items()}
    table = np.arange(2 * pp, dtype=np.int32).reshape(2, pp)
    t = lambda a, d: torch.as_tensor(np.asarray(a, np.int32)).to(d)
    reading = {name: {"logits": 0.0} for name in routes}
    agree = [0, 0, 0]

    def hooks(d, lead, trace):
        """{module, attribute: wrapper} that forces and records each site."""
        def fed(i, own):
            return own if not forced or lead is None else \
                tuple(_to_device(a, d) for a in lead[i][1])

        if site == "moe_ops":
            return moe_hooks(fed, trace)
        if site != "ops":
            hooked = "mla_attention" if site == "mixer" else "block_apply"
            fn = getattr(tf, hooked)

            def block(p, x, *args, **kw):
                (x,) = fed(len(trace), (x,))
                y = fn(p, x, *args, **kw)
                trace.append(("block", (x,), y[0] if site == "mixer" else y))
                return y
            return {(tf, hooked): block}
        gemm, attn = ops.w4a8_matmul_batched, ops.paged_mla_decode_attn

        def batched(x, w, transpose_w=False, quantize_acts=True):
            (x,) = fed(len(trace), (x,))
            y = gemm(x, w, transpose_w=transpose_w, quantize_acts=quantize_acts)
            trace.append(("wk_b" if transpose_w else "wv_b", (x,), y))
            return y

        def latent(q_lat, q_rope, layer, page_table, kv_lens, scale):
            args = fed(len(trace), (q_lat, q_rope, layer, page_table, kv_lens))
            y = attn(*args, scale)
            trace.append(("attn", args, y))
            return y
        return {(ops, "w4a8_matmul_batched"): batched, (ops, "paged_mla_decode_attn"): latent}

    def moe_hooks(fed, trace):
        """The MoE path's sites: ``moe_layer`` (fed the card's input, so
        each route's router sees the same hidden states; read as the
        layer's output), the router's ``top_k`` (recorded: the experts each
        token picks) and every batched expert GEMM (fed the card's operand,
        read apart as ``wu``, ``wg`` and ``wd`` in their call order)."""
        from repro_torch.models import moe

        layer_fn, top_k, gemm = tf.moe_layer, moe.top_k, ops.w4a8_matmul_batched
        n_gemm = [0]

        def moe_layer(p, x, *args, **kw):
            (x,) = fed(len(trace), (x,))
            entry = ["moe", (x,), None]
            trace.append(entry)
            y = layer_fn(p, x, *args, **kw)
            entry[2] = y[0]
            return y

        def router(probs, k):
            out = top_k(probs, k)
            trace.append(["router", (probs,), out])
            return out

        def batched(x, w, transpose_w=False, quantize_acts=True):
            (x,) = fed(len(trace), (x,))
            y = gemm(x, w, transpose_w=transpose_w, quantize_acts=quantize_acts)
            trace.append([("wu", "wg", "wd")[n_gemm[0] % 3], (x,), y])
            n_gemm[0] += 1
            return y
        return {(tf, "moe_layer"): moe_layer, (moe, "top_k"): router,
                (ops, "w4a8_matmul_batched"): batched}

    def routing(r, got, want, probs):
        """Tokens whose set of experts differs from the reference's: their
        count, and the largest of the reference's gaps between its last
        picked and first unpicked probability among them."""
        k = want[1].shape[-1]
        idx, idx0 = got[1].cpu().sort(-1).values, want[1].cpu().sort(-1).values
        flip = (idx != idx0).any(-1)
        top = probs.cpu().sort(-1, descending=True).values
        gap = (top[..., k - 1] - top[..., k])[flip]
        r["router_flips"] = r.get("router_flips", 0) + int(flip.sum())
        r["router_gap"] = max([r.get("router_gap", 0.0)] + gap.tolist())
        r["router_tokens"] = r.get("router_tokens", 0) + flip.numel()

    def run(name, tokens, pt, lengths, chunk_len, lead):
        params, d, patch = routes[name]
        trace = []  # (site key, inputs, output) of every site, in order
        saved = {(ops, k): getattr(ops, k) for k in patch}
        for k, v in patch.items():
            setattr(ops, k, v)
        wrapped = hooks(d, lead, trace)  # around the route's own ops
        for key in wrapped:
            saved.setdefault(key, getattr(*key))
        for (mod, attr), v in wrapped.items():
            setattr(mod, attr, v)
        st = kvc.PagedState(t(pt, d), t(lengths, d), None if chunk_len is None else t([chunk_len], d))
        logits = api.decode_step(params, cfg, t(tokens, d), pools[name], st, a_fmt="fp8_e4m3")
        for (mod, attr), v in saved.items():
            setattr(mod, attr, v)
        return logits.float().cpu(), trace

    def step(tokens, pt, lengths, chunk_len=None):
        out = {"card": run("card", tokens, pt, lengths, chunk_len, None)}
        for name in routes:
            if name != "card":
                out[name] = run(name, tokens, pt, lengths, chunk_len, out["card"][1])
        for name, (o, _) in out.items():
            if not bool(torch.isfinite(o).all()):
                fail(f"non-finite logits on route {name}")
        ref, ref_sites = out["cpu"]
        scale = float(ref.abs().max())
        f64 = lambda v: v.double().cpu()
        for name, (o, sites) in out.items():
            r = reading[name]
            r["logits"] = max(r["logits"], float((o - ref).abs().max()) / scale)
            for (key, _, y), (_, (x0, *_), y0) in zip(sites if forced else (), ref_sites):
                if key == "router":
                    routing(r, y, y0, x0)
                    continue
                base = f64(y0) - f64(x0) if site == "block" else f64(y0)
                r[key] = max(r.get(key, 0.0), float((f64(y) - f64(y0)).norm() / base.norm()))
        top2 = out["card"][0].topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > logit_rtol * scale
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


def _to_device(a, d):
    """A tensor, or a dict of tensors (a pool layer), on device ``d``."""
    return {k: v.to(d) for k, v in a.items()} if isinstance(a, dict) else a.to(d)


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
    show = lambda rd, key: ", ".join(f"{n} {rd[n][key]:.4g}" for n in routes if n != "cpu")
    log(f"[5 cpu] 2 requests (1 prefill chunk + 4 decode steps) against the CPU plain path")
    log(f"    free-running, largest |logit err| / largest |logit| (tolerance {LOGIT_RTOL}): "
        f"{show(free, 'logits')}; greedy tokens agree {agree[0]}/{agree[2]}, all {agree[1]} "
        f"decisive ones")
    log(f"    teacher-forced blocks, largest |block output err| / |block update| "
        f"(tolerance {BLOCK_RTOL}): {show(forced, 'block')}")
    for name in ("card", "card_plain"):
        if free[name]["logits"] > LOGIT_RTOL:
            fail(f"free-running logits of route {name} differ from the CPU plain path by "
                 f"{free[name]['logits']:.4g} of the largest |logit| > {LOGIT_RTOL}")
        if forced[name]["block"] > BLOCK_RTOL:
            fail(f"the blocks of route {name} differ from the CPU plain path by "
                 f"{forced[name]['block']:.4g} of their update > {BLOCK_RTOL}")
    for name in ("no_lorc", "short_kv"):
        if forced[name]["block"] <= BLOCK_RTOL:
            fail(f"injected fault {name} reads {forced[name]['block']:.4g} <= {BLOCK_RTOL}: "
                 f"the comparison cannot tell it from a sound card path")
    return free, forced


def _counters():
    """(name, wrapper, attribute) of every launch counter of the port."""
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda as attn
    from repro_torch.kernels.decode_attn import paged_mla_decode_attn_cuda as mla
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda as batched
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda as gemm

    from repro_torch.kernels.act_quant import act_quant_cuda
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.kernels.w4a8_matmul import w4a8_matmul_cuda

    return (("w4a8_fused", gemm, "launches"), ("w4a8_fused_batched", batched, "launches"),
            ("w4a8_fused_batched_fp8", batched, "quant_launches"),
            ("w4a8_fused_transposed", batched, "transposed_launches"),
            ("paged_decode_attn", attn, "launches"),
            ("paged_decode_attn_frozen", attn, "frozen_launches"),
            ("paged_mla_decode_attn", mla, "launches"),
            ("paged_mla_decode_attn_frozen", mla, "frozen_launches"),
            ("act_quant", act_quant_cuda, "launches"),
            ("w4a8_matmul_split", w4a8_matmul_cuda, "launches"),
            ("flash_attention", flash_attention_cuda, "launches"))


def _counts():
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def _set_counts(counts):
    for name, fn, attr in _counters():
        setattr(fn, attr, counts[name])


def _live_pool_check(torch, srv, gen):
    """Every layer of the live pool, at a step where every active row is
    decoding over a table that holds frozen ids: the frozen variant and
    its plain version on the same q must agree to ATTN_TOL (a second
    launch bit-identical), and the same
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
            o_p, o_k = plain(), kernel()
            _deterministic(torch, kernel, o_k, "live pool: the frozen variant")
            err = max(err, float((o_k - o_p).abs().max()))
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


def _default_server(torch, cfg, packed, faults=None, frozen_pages=64, **knobs):
    """The reference Server's default path: mixed engine, prefix cache,
    FP8 pages with an FP4 frozen region of 64 pages, 4 slots; ``knobs``
    (pool_pages, audit_every, scheduler), ``frozen_pages`` and ``faults``
    for phase 12."""
    from repro_torch.runtime import serve

    config = serve.ServerConfig(
        slots=4, max_seq=1024, page_size=64, a_fmt="fp8_e4m3",
        cache=serve.CachePolicy(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1",
                                frozen_pages=frozen_pages),
        prefix_cache=True, **knobs)
    srv = serve.Server(packed, cfg, config, faults=faults)
    if srv.engine != "mixed":
        fail(f"the default engine is {srv.engine!r}, not the mixed engine")
    return srv


def _drive_waves(torch, srv, cfg, live_check):
    """8 requests in two waves of 4 (the second submitted after the first
    drains), each a shared 512-token system prompt plus a 16-200 token tail
    from the seed, 32 new tokens, every launch counter set to 0 first. At
    the first step where every slot decodes over a table holding frozen
    ids, ``live_check(srv)`` runs once (its time is not served time).
    Returns (wall s, {"decode": [ms], "mixed": [ms]}, live, results,
    launches, the system prompt, the rng)."""
    import numpy as np

    from repro_torch.runtime import serve

    rng = np.random.default_rng(SEED + 2)
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
                live = live_check(srv)
                t_live = time.perf_counter() - c0
    wall = time.perf_counter() - t0 - t_live
    launches = _counts()
    results = [r.result() for r in srv.finished]
    if len(results) != 8 or not all(r.ok for r in results):
        fail(f"not every request ended ok: {[(r.rid, r.status) for r in results]}")
    if live is None:
        fail("no decode step had every row decoding over frozen pages: live check not run")
    st = srv.stats
    if st["programs"] != st["steps"]:
        fail(f"{st['programs']} programs in {st['steps']} steps: the mixed engine runs one a step")
    if st["fp4_frozen_pages"] < 8 or st["prefix_hit_pages"] <= 0:
        fail(f"the system prompt did not freeze and hit: {st}")
    return wall, step_ms, live, results, launches, system, rng


def _report_waves(srv, wall, step_ms, results, launches, want):
    st = srv.stats
    res = srv.cache_residency()
    ratio = res["frozen_bytes_per_token"] / res["active_bytes_per_token"]
    n_tok = sum(len(r.tokens) for r in results)
    log(f"    {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s; {st['steps']} steps: "
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


def _profile_hits(torch, srv, cfg, system, rng):
    """Busy share: 4 requests hit the system prompt and all decode."""
    from repro_torch.runtime import serve

    for i in range(srv.slots):
        srv.submit(serve.Request(rid=100 + i, max_new=8, prompt=system + rng.integers(
            2, cfg.vocab_size, 100).tolist()))
    for _ in range(4 * srv.slots):
        if srv._pick_prefill_slot() is None and all(r is not None for r in srv.active):
            break
        srv.step()
    else:
        fail("the profiled requests never all reached decode")
    log(_profiled(torch, srv, 3, "4 rows over 9 frozen + 1 fp8 pages"))


def phase_prefix(torch, cfg, packed, card):
    """The reference Server's default path at full width: the mixed engine,
    the prefix cache and FP8 pages with an FP4 frozen region."""
    srv = _default_server(torch, cfg, packed)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    wall, step_ms, live, results, launches, system, rng = _drive_waves(
        torch, srv, cfg, lambda srv: _live_pool_check(torch, srv, gen))
    steps, n_layers = srv.stats["steps"], cfg.n_layers
    # the mixed engine runs one program per step (decode rows plus at most
    # one prefill chunk): 6 GEMMs a layer each, and one decode attention a
    # layer each, always the frozen variant over a pool with a frozen region
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": 6 * n_layers * steps,
            "paged_decode_attn_frozen": n_layers * steps}
    if launches != want or launches["paged_decode_attn_frozen"] <= 0:
        fail(f"kernel launches {launches}, want {want} ({steps} steps)")
    log(f"[6 prefix] opt-125m W4A8, mixed engine, prefix cache, fp8 pages + fp4_e2m1 frozen "
        f"pages, {srv.slots} slots, 8 requests (512-token system prompt + 16-200 token "
        f"tails, 32 new tokens) in 2 waves, on {card}:")
    _report_waves(srv, wall, step_ms, results, launches, want)
    log(f"    live pool, {n_layers} layers: frozen variant vs plain max|err| {live[0]:.3g} "
        f"(tolerance {ATTN_TOL}); injected fault k_fz_shift + 1 reads {live[1]:.3g} "
        f"(>= {10 * ATTN_TOL} required)")
    _profile_hits(torch, srv, cfg, system, rng)
    return launches, live


def _random_packed(torch, name, n_layers=None, seed=SEED):
    """A config of the port at its published widths (``n_layers`` cuts the
    depth), random weights from ``seed``, initialized on the card and
    packed there by the port's ``pack_params``. Returns (cfg, packed,
    seconds)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_params
    from repro_torch.models import api

    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256, scale_mode="m2",
                         lorc_rank=8)
    t0 = time.perf_counter()
    packed = pack_params(api.init_params(cfg, seed=seed), cfg, policy)
    torch.cuda.synchronize()
    return cfg, packed, time.perf_counter() - t0


def _live_mla_check(torch, srv, gen):
    """Every layer of the live latent pool, at a step where every active
    row decodes over a table that holds frozen ids: the frozen MLA kernel
    and its plain version on the same queries must agree to ATTN_TOL, and
    the same call with ``ckv_fz_shift + 1`` (every frozen latent halved)
    must read at least 10x above it. The queries are scaled to the layer's
    latents so the scores are O(1). Returns (largest error, smallest fault
    reading); the counts are restored."""
    from repro_torch.runtime import kv_cache as kvc

    saved = _counts()
    cfg = srv.cfg
    rows = [s for s, r in enumerate(srv.active) if r is not None]
    table = torch.as_tensor(srv.page_table[rows]).to(DEV)
    kv_lens = torch.as_tensor(srv.lengths[rows]).to(DEV)
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
    err, fault = 0.0, math.inf
    for pool in srv.pools:
        for i in range(pool["ckv"].shape[0]):
            layer = {name: leaf[i] for name, leaf in pool.items()}
            st = kvc.PagedState(table, kv_lens)
            q = []
            for name, d in (("ckv", cfg.mla.kv_lora_rank), ("krope", cfg.mla.qk_rope_dim)):
                rms = float(kvc.gather_pages(layer, name, st).pow(2).mean().sqrt())
                q.append((torch.randn((len(rows), cfg.n_heads, d), generator=gen, device=DEV)
                          * (2.0 / max(rms, 1e-6))).to(torch.bfloat16))
            kernel, plain = _mla_calls(layer, table, kv_lens, *q, scale)
            o_p = plain()
            err = max(err, float((kernel() - o_p).abs().max()))
            layer["ckv_fz_shift"] = layer["ckv_fz_shift"] + 1
            kernel, _ = _mla_calls(layer, table, kv_lens, *q, scale)
            fault = min(fault, float((kernel() - o_p).abs().max()))
    torch.cuda.synchronize()
    _set_counts(saved)
    if err > ATTN_TOL:
        fail(f"live latent pool: the frozen MLA kernel differs from its plain version by "
             f"{err:.3g} > {ATTN_TOL}")
    if fault < 10 * ATTN_TOL:
        fail(f"live latent pool: the injected fault (ckv_fz_shift + 1) reads {fault:.3g} < "
             f"10 x {ATTN_TOL}")
    return err, fault


def phase_mla(torch, card):
    """MiniCPM3-4B (MLA) at full width on the reference Server's default
    path, served by the GEMM (7 linears a layer), the batched and
    transposed GEMM (wv_b, wk_b) and the frozen MLA decode kernel."""
    cfg, packed, t_pack = _random_packed(torch, "minicpm3-4b")
    log(f"[7 mla] MiniCPM3-4B ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, kv_lora {cfg.mla.kv_lora_rank}, q_lora "
        f"{cfg.mla.q_lora_rank}): random init + W4A8 pack on the card {t_pack:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
    srv = _default_server(torch, cfg, packed)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    wall, step_ms, live, results, launches, system, rng = _drive_waves(
        torch, srv, cfg, lambda srv: _live_mla_check(torch, srv, gen))
    steps, n_layers = srv.stats["steps"], cfg.n_layers
    # one program a step: per layer 7 GEMMs (wq_a, wq_b, wkv_a, wo, gate,
    # up, down), wv_b's batched and wk_b's transposed GEMM once each over
    # the whole fused row, and one latent decode launch, always the frozen
    # variant over a pool with a frozen region; no GQA attention
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": 7 * n_layers * steps,
            "w4a8_fused_batched": n_layers * steps, "w4a8_fused_transposed": n_layers * steps,
            "paged_mla_decode_attn_frozen": n_layers * steps}
    if launches != want or min(launches[k] for k in want if want[k]) <= 0:
        fail(f"kernel launches {launches}, want {want} ({steps} steps)")
    log(f"    mixed engine, prefix cache, fp8 latent pages + fp4_e2m1 frozen pages, {srv.slots} "
        f"slots, 8 requests (512-token system prompt + 16-200 token tails, 32 new tokens) in "
        f"2 waves, on {card}:")
    _report_waves(srv, wall, step_ms, results, launches, want)
    log(f"    live latent pool, {n_layers} layers: frozen MLA kernel vs plain max|err| "
        f"{live[0]:.3g} (tolerance {ATTN_TOL}); injected fault ckv_fz_shift + 1 reads "
        f"{live[1]:.3g} (>= {10 * ATTN_TOL} required)")
    _profile_hits(torch, srv, cfg, system, rng)
    return launches, live


def phase_mla_cpu(torch):
    """MiniCPM3 at full width, depth cut to 2 layers, along five routes
    against the CPU plain path (see phase_cpu): the kernels, the plain
    versions on the card, the CPU, and two faults through the kernels --
    ``no_lorc`` drops wk_b's LoRC correction in the batched kernel,
    ``short_kv`` reads the MLA decode one token short. Three passes:

    * free-running logits, a gross check of the whole path: the sound
      routes must stay within MLA_LOGIT_RTOL; no fault has to exceed it;
    * teacher-forced attention blocks (the whole-block reading of phase 5
      dilutes a wk_b fault in the MLP's update): the sound routes within
      MLA_BLOCK_RTOL, ``short_kv`` above it; the kernels' M2 arithmetic,
      amplified by the next FP8 quantization, reads nearly as much as the
      wk_b LoRC fault here, so this pass does not hold ``no_lorc``;
    * teacher-forced kernel calls, each fed the card's operands: the
      transposed GEMM (``wk_b``) and the latent decode (``attn``) compute
      the plain versions' products in another f32 order, so the sound
      routes must read at most MLA_OP_RTOL there and each fault more on
      the call it breaks (``no_lorc`` on wk_b, ``short_kv`` on attn); the
      normal GEMM (``wv_b``) applies M2 after its K loop where the plain
      version rounds each scaled weight to bf16 (at most 2^-9 of it), and
      must read at most MLA_WVB_RTOL."""
    cfg, packed, _ = _random_packed(torch, "minicpm3-4b", n_layers=2)
    routes = _routes(torch, packed, "mla")
    free, agree = _compare(torch, cfg, routes, forced=False, logit_rtol=MLA_LOGIT_RTOL)
    forced, _ = _compare(torch, cfg, routes, forced=True, site="mixer",
                         logit_rtol=MLA_LOGIT_RTOL)
    op, _ = _compare(torch, cfg, routes, forced=True, site="ops", logit_rtol=MLA_LOGIT_RTOL)
    show = lambda rd, key: ", ".join(f"{n} {rd[n][key]:.4g}" for n in routes if n != "cpu")
    log(f"[8 mla cpu] MiniCPM3 at full width, 2 layers: 2 requests (1 prefill chunk + 4 "
        f"decode steps) against the CPU plain path")
    log(f"    free-running, largest |logit err| / largest |logit| (tolerance {MLA_LOGIT_RTOL}): "
        f"{show(free, 'logits')}; greedy tokens agree {agree[0]}/{agree[2]}, all {agree[1]} "
        f"decisive ones")
    log(f"    teacher-forced attention blocks, largest |output err| / |output| "
        f"(tolerance {MLA_BLOCK_RTOL}): {show(forced, 'block')}")
    for key, tol in (("wk_b", MLA_OP_RTOL), ("attn", MLA_OP_RTOL), ("wv_b", MLA_WVB_RTOL)):
        log(f"    teacher-forced kernel calls, {key}, largest |output err| / |output| "
            f"(tolerance {tol}): {show(op, key)}")
    for name in ("card", "card_plain"):
        if free[name]["logits"] > MLA_LOGIT_RTOL:
            fail(f"free-running logits of route {name} differ from the CPU plain path by "
                 f"{free[name]['logits']:.4g} of the largest |logit| > {MLA_LOGIT_RTOL}")
        if forced[name]["block"] > MLA_BLOCK_RTOL:
            fail(f"the attention blocks of route {name} differ from the CPU plain path by "
                 f"{forced[name]['block']:.4g} of their output > {MLA_BLOCK_RTOL}")
        for key, tol in (("wk_b", MLA_OP_RTOL), ("attn", MLA_OP_RTOL), ("wv_b", MLA_WVB_RTOL)):
            if op[name][key] > tol:
                fail(f"the {key} calls of route {name} differ from the CPU plain path by "
                     f"{op[name][key]:.4g} of their output > {tol}")
    for name, rd, key, tol in (("short_kv", forced, "block", MLA_BLOCK_RTOL),
                               ("no_lorc", op, "wk_b", MLA_OP_RTOL),
                               ("short_kv", op, "attn", MLA_OP_RTOL)):
        if rd[name][key] <= tol:
            fail(f"injected fault {name} reads {rd[name][key]:.4g} <= {tol} on {key}: the "
                 f"comparison cannot tell it from a sound card path")
    return free, forced, op


def _lorc_routes(torch, n=8):
    """LoRC's rank-8 factors of ``n`` OLMoE expert slices (wu's 1024 x 2048
    quantization errors), by the port's f64 Gram route and by
    ``torch.linalg.svd`` with cuSOLVER's default driver and with gesvd:
    each one's time a slice and its correction's distance from gesvd's.
    Returns the line to print."""
    from repro_torch.core.lorc import _truncated_svd_factors
    from repro_torch.core.quantize import quantize_weight
    from repro_torch.core.scales import apply_scale_constraint

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    w = (torch.randn((n, 1024, 2048), generator=gen, device=DEV) / math.sqrt(2048)
         ).to(torch.bfloat16).float()
    qt0 = quantize_weight(w, "fp4_e2m1", 256)
    err = w - quantize_weight(w, "fp4_e2m1", 256,
                              scale=apply_scale_constraint(qt0.scale, "m2")).dequantize()

    def svd(driver):
        u, s, vt = torch.linalg.svd(err, full_matrices=False, driver=driver)
        sq = s[..., :8].sqrt()
        return u[..., :8] * sq[..., None, :], sq[..., :, None] * vt[..., :8, :]

    out = {}
    for name, fn in (("gesvd", lambda: svd("gesvd")), ("svd default", lambda: svd(None)),
                     ("f64 gram (the port)", lambda: _truncated_svd_factors(err, 8))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, b = fn()
        torch.cuda.synchronize()
        out[name] = ((time.perf_counter() - t0) * 1e3 / n, a @ b)
    ref = out["gesvd"][1]
    return ("    LoRC rank 8 on 1024 x 2048 expert errors, ms a slice and |AB - AB(gesvd)| / "
            "|AB(gesvd)|: " + "; ".join(f"{k} {ms:.1f} ms, {float((ab - ref).norm() / ref.norm()):.3g}"
                                        for k, (ms, ab) in out.items()))


def phase_moe(torch, card):
    """OLMoE-1B-7B (64 experts top-8) at full width on the reference
    Server's default path, served by the GEMM (q, k, v, o), the batched
    W4A8 kernel with FP8 activations (every expert GEMM: wu, wg, wd) and
    the frozen GQA decode kernel at hd 128. Returns (cfg, packed, launches,
    live)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, packed, t_pack = _random_packed(torch, "olmoe-1b-7b")
    m = cfg.moe
    log(f"[9 moe] OLMoE-1B-7B ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.resolved_head_dim}, {m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff}, vocab "
        f"{cfg.vocab_size}): random init + W4A8 pack on the card {t_pack:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
    log(_lorc_routes(torch))
    srv = _default_server(torch, cfg, packed)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    wall, step_ms, live, results, launches, system, rng = _drive_waves(
        torch, srv, cfg, lambda srv: _live_pool_check(torch, srv, gen))
    steps, n_layers = srv.stats["steps"], cfg.n_layers
    # one program a step: per layer 4 GEMMs (q, k, v, o), 3 batched expert
    # GEMMs with FP8 activations over the whole fused row (wu, wg, wd; serving
    # routes per token, so each slab has a row for every token), and one
    # decode attention launch, always the frozen variant over a pool with a
    # frozen region; no MLA kernel, no unquantized batched GEMM
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": 4 * n_layers * steps,
            "w4a8_fused_batched_fp8": 3 * n_layers * steps,
            "paged_decode_attn_frozen": n_layers * steps}
    if launches != want or min(launches[k] for k in want if want[k]) <= 0:
        fail(f"kernel launches {launches}, want {want} ({steps} steps)")
    log(f"    mixed engine, prefix cache, fp8 pages + fp4_e2m1 frozen pages, {srv.slots} slots, "
        f"8 requests (512-token system prompt + 16-200 token tails, 32 new tokens) in 2 waves, "
        f"on {card}:")
    _report_waves(srv, wall, step_ms, results, launches, want)
    log(f"    live pool, {n_layers} layers, KV {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}: frozen "
        f"variant vs plain max|err| {live[0]:.3g} (tolerance {ATTN_TOL}); injected fault "
        f"k_fz_shift + 1 reads {live[1]:.3g} (>= {10 * ATTN_TOL} required)")
    _profile_hits(torch, srv, cfg, system, rng)
    return cfg, packed, launches, live


def phase_moe_cpu(torch, cfg, packed):
    """OLMoE at full width cut to 2 layers along five routes against the CPU
    plain path (see phase_cpu): the kernels, the plain versions on the
    card, the CPU, and two faults through the kernels -- ``no_lorc`` drops
    wd's LoRC correction, ``expert_swap`` makes expert 0 of wu read expert
    1's weights. Two seeds: phase 9's weights (its first 2 layers) with
    prompts from SEED, and 2 layers packed anew from SEED + 1 with prompts
    from it. Each is read teacher-forced at each MoE layer and each expert
    GEMM call, fed the card's operands: every wu, wg and wd call of the
    sound routes within MOE_OP_RTOL of the CPU's output, ``no_lorc`` above
    it on wd and ``expert_swap`` on wu (the MoE layer's reading shows what
    its last call and the combine add; the forcing hides wu's fault
    there); the router, fed the card's hidden states, picks the CPU's
    experts for every token but where the CPU's gap between its 8th and
    9th probability is below MOE_TIE. The first seed is also read
    free-running, a gross check of the whole path: the sound routes within
    MOE_LOGIT_RTOL, which no fault has to exceed."""
    import dataclasses

    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map

    n = 2
    cfg = dataclasses.replace(cfg, n_layers=n)
    cut = lambda t: t.apply(lambda a: a[:n]) if isinstance(t, PackedLinear) else t[:n]
    packed = {**packed, "segments": [tree_map(cut, seg, is_leaf=lambda x: isinstance(x, PackedLinear))
                                     for seg in packed["segments"]]}
    # 2 decode steps, not 4: the CPU's plain expert GEMMs (a dequantized f32
    # copy of 64 experts a call) take most of this phase
    kw = dict(logit_rtol=MOE_LOGIT_RTOL, n_dec=2)
    routes = _routes(torch, packed, "moe")
    show = lambda rd, key, f=".4g": ", ".join(f"{n} {rd[n][key]:{f}}" for n in routes if n != "cpu")
    free, agree = _compare(torch, cfg, routes, forced=False, **kw)
    log(f"[10 moe cpu] OLMoE at full width, 2 layers: 2 requests (1 prefill chunk + 2 decode "
        f"steps) against the CPU plain path, on two seeds")
    log(f"    free-running (seed {SEED}), largest |logit err| / largest |logit| (gross bound "
        f"{MOE_LOGIT_RTOL}): {show(free, 'logits')}; greedy tokens agree {agree[0]}/{agree[2]}, "
        f"all {agree[1]} decisive ones")
    for name in ("card", "card_plain"):
        if free[name]["logits"] > MOE_LOGIT_RTOL:
            fail(f"free-running logits of route {name} differ from the CPU plain path by "
                 f"{free[name]['logits']:.4g} of the largest |logit| > {MOE_LOGIT_RTOL}")
    ops = {}
    for seed in (SEED, SEED + 1):
        if seed != SEED:
            _, packed, _ = _random_packed(torch, "olmoe-1b-7b", n_layers=n, seed=seed)
            routes = _routes(torch, packed, "moe")
        op, _ = _compare(torch, cfg, routes, forced=True, site="moe_ops", seed=seed, **kw)
        ops[seed] = op
        for key in ("wu", "wg", "wd"):
            log(f"    seed {seed}: teacher-forced expert GEMM calls (row 1d), {key}, largest |output "
                f"err| / |output| (bound {MOE_OP_RTOL}): {show(op, key)}")
        log(f"    seed {seed}: teacher-forced MoE layers, largest |output err| / |output|: "
            f"{show(op, 'moe')}")
        log(f"    seed {seed}: router, fed the card's hidden states: tokens whose experts differ "
            f"from the CPU's {show(op, 'router_flips', 'd')} of {op['card']['router_tokens']} per "
            f"route; largest CPU probability gap among them {show(op, 'router_gap', '.3g')} (tie "
            f"below {MOE_TIE})")
        for name in ("card", "card_plain"):
            for key in ("wu", "wg", "wd"):
                if op[name][key] > MOE_OP_RTOL:
                    fail(f"seed {seed}: the {key} calls of route {name} differ from the CPU plain "
                         f"path by {op[name][key]:.4g} of their output > {MOE_OP_RTOL}")
            if op[name]["router_gap"] >= MOE_TIE:
                fail(f"seed {seed}: route {name} picks other experts than the CPU where the CPU's "
                     f"probability gap is {op[name]['router_gap']:.3g} >= {MOE_TIE}")
        for name, key in (("no_lorc", "wd"), ("expert_swap", "wu")):
            if op[name][key] <= MOE_OP_RTOL:
                fail(f"seed {seed}: injected fault {name} reads {op[name][key]:.4g} <= "
                     f"{MOE_OP_RTOL} on {key}: the comparison cannot tell it from a sound card path")
    return free, ops


# -- phase 11: the kernel API ------------------------------------------------------
# token-wise FP8 activation quantization: (rows, features) as opt-125m (768),
# OLMoE-1B-7B (2048) and MiniCPM3-4B's d_ff (6400) feed a GEMM, at a decode
# step's 4 rows and a 256-token prefill chunk; MiniCPM3's d_ff at a
# 2048-token prefill, and 16 rows of the widest feature dim repro documents
# (73728, src/repro/kernels/act_quant.py:14)
ACT_QUANT_SHAPES = ((4, 768), (256, 768), (4, 2048), (256, 2048), (256, 6400), (2048, 6400),
                    (16, 73728))
# the split GEMM at opt-125m's 768->768, 768->3072, 3072->768 and OLMoE's
# 2048->2048, at M = 4 and 256: (M, K, N)
SPLIT_GEMMS = tuple((m, k, n) for m in (4, 256)
                    for k, n in ((768, 768), (768, 3072), (3072, 768), (2048, 2048)))
# the kernel microbench's shapes (benchmarks/run.py): (tag, M, K, N, LoRC rank)
MICROBENCH = (("m256", 256, 1024, 1024, 0), ("decode64", 64, 1024, 1024, 0),
              ("lorc16", 64, 1024, 512, 16))
# causal bf16 prefill attention, B = 1: (tag, H, hd, dv, S = T); MiniCPM3's
# MLA materialized (qk 96 = 64 nope + 32 rope, v 64)
FLASH_SHAPES = (("opt125m_s512", 12, 64, 64, 512), ("opt125m_s2048", 12, 64, 64, 2048),
                ("olmoe_s2048", 16, 128, 128, 2048), ("minicpm3_mla_s2048", 40, 96, 64, 2048))
SPLIT_RTOL = 1e-4  # of the largest |y|: the split GEMM and its plain version differ in f32 sum order
FLASH_TOL = {"bf16": 3e-2, "f32": 1e-4}  # rtol = atol, tests/test_kernels.py:190 and :205
# each query row, ||o_kernel - o_plain|| / ||o_plain|| over its dv outputs. At
# S = T = 2048 a late row's outputs are ~0.04 (scores of std 1 over ~i/e
# effective keys), so FLASH_TOL alone is as large as the values there; a row
# is held to one bf16 ulp (2^-7) of its own size instead, f32 rows to 1e-5
FLASH_ROW_RTOL = {"bf16": 2.0 ** -7, "f32": 1e-5}


def _split_pipeline(torch, x, p):
    """The split three-pass W4A8 path through the kernel API, as the kernel
    microbench runs it (benchmarks/run.py:92-99): act_quant, the quantized
    activations through device memory as bf16, the split GEMM, then LoRC by
    two bf16 matmuls. Returns f32."""
    from repro_torch.kernels import ops

    qv, sc = ops.act_quant(x, p.a_fmt)
    xq = (qv * sc).to(torch.bfloat16)
    y = ops.w4a8_matmul_split(xq, p)
    if p.lorc_a is not None:
        y = y + torch.matmul(torch.matmul(xq, p.lorc_b.t()), p.lorc_a.t())
    return y


def _device_ms(torch, timer, fn, n=30, rounds=3):
    """Device time of one call of ``fn`` after an L2 flush, without the
    host's launch time that an event pair around one short call reads: one
    CUDA graph replays ``n`` (flush, ``fn``) pairs, another ``n`` flushes
    alone, the two are timed in turn ``rounds`` times, and the median
    difference is split over the ``n`` calls. (A torch.profiler trace
    loses this kernel's records once earlier phases have traced.)"""
    flush = timer.flush.zero_
    pairs = _graphed(torch, lambda: [f() for _ in range(n) for f in (flush, fn)])
    flushes = _graphed(torch, lambda: [flush() for _ in range(n)])

    def replay_ms(graph):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    diffs = [replay_ms(pairs) - replay_ms(flushes) for _ in range(rounds)]
    return statistics.median(diffs) / n


def _bits_equal(torch, a, b):
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _act_quant_plan_of(x):
    """The launch plan the wrapper gives ``x``, or None where the checkout's
    wrapper plans nothing (an earlier commit's, timed by kernel_compare.py)."""
    from repro_torch.kernels import act_quant

    return act_quant.plan_of(x) if hasattr(act_quant, "plan_of") else None


def _bits_equal_nan(torch, a, b):
    """Bit-identical where not NaN, NaN at the same places (a NaN's payload
    is the platform's)."""
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and _bits_equal(torch, a.masked_fill(na, 0), b.masked_fill(nb, 0))


def _act_quant_check(torch, x, fmt, what, nan=False):
    """The kernel against its plain version on ``x``, values and scales
    bit-identical (NaN where and only where the plain version has NaN, when
    ``nan``). Returns (values, scales, the plan or None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.act_quant import act_quant_cuda

    (qk, sk), (qp, sp) = act_quant_cuda(x, fmt), ref.act_quant_ref(x, fmt)
    torch.cuda.synchronize()
    same = (lambda a, b: _bits_equal_nan(torch, a, b)) if nan else \
        (lambda a, b: _bits_equal(torch, a, b))
    if not (same(qk, qp) and same(sk, sp)):
        fail(f"act_quant {what} {fmt} is not bit-identical to its plain version: max |err| "
             f"{float((qk - qp).nan_to_num().abs().max())} (values), "
             f"{float((sk - sp).nan_to_num().abs().max())} (scales), NaN in "
             f"{int(qk.isnan().sum())} values, plain {int(qp.isnan().sum())}")
    return qk, sk, _act_quant_plan_of(x)


def _plan_text(plan):
    if plan is None:
        return "no plan"
    access = f"{plan.vec}-element accesses" if plan.vec > 1 else "1-element accesses"
    return (f"{plan.path} path, {access}, {plan.blocks} blocks of {plan.threads}, "
            f"{plan.per_thread} vector(s) a thread"
            + (f", clusters of {plan.cluster}" if plan.cluster > 1 else ""))


def _launch_floor(torch, timer):
    """The device time of a one-element ``fill_``, timed as _device_ms
    times a kernel: what any launch costs the device."""
    one = torch.empty(1, device=DEV)
    return _device_ms(torch, timer, lambda: one.fill_(1.0))


def _act_quant_case(torch, timer, gen, m, d, floor_ms):
    """act_quant at one timed (rows, d), bf16 -> fp8_e4m3: checked
    bit-identical, timed beside its plain version and the nearest library
    route, with its bound's share of the device time, raw and above the
    launch floor ``floor_ms``. Returns its row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.act_quant import act_quant_cuda

    x = (torch.randn((m, d), generator=gen, device=DEV) * 13.0).to(torch.bfloat16)
    plan = _act_quant_check(torch, x, "fp8_e4m3", f"({m}, {d}) bf16")[2]

    def library():  # the nearest PyTorch route: OCP E4M3 (448), not this grid (480)
        s = x.abs().amax(-1, keepdim=True).float() * (1.0 / 448.0)
        return (x / s).to(torch.float8_e4m3fn), s

    nbytes = m * d * 2 + m * d * 4 + m * 4
    b_ms, by = bound(nbytes, 0, "f32")
    kernel = lambda: act_quant_cuda(x, "fp8_e4m3")
    row = dict(**_timed(torch, timer, kernel, lambda: ref.act_quant_ref(x, "fp8_e4m3"), library),
               graph_ms=timer.ms(_graphed(torch, kernel)), bound_ms=b_ms, bound_by=by,
               max_abs_err=0.0, bytes=nbytes, flops=0, kind="f32", floor_ms=floor_ms,
               path=plan.path if plan else None)
    dev = row["device_ms"]
    above = dev - floor_ms
    row["share_above_floor"] = b_ms / above if above > 0 else None
    log(f"    act_quant ({m:4d}, {d:5d}) bf16 -> fp8_e4m3 [{_plan_text(plan)}]: device "
        f"{dev * 1e3:.3f} us, bound {b_ms * 1e3:.3f} us ({by}; {nbytes} B), share "
        f"{b_ms / dev:.3f} raw, "
        + (f"{row['share_above_floor']:.3f}" if above > 0 else "n/a")
        + f" above the floor ({floor_ms * 1e3:.3f} us); event pairs {row['ms']:.4f} ms (from a "
        f"CUDA graph {row['graph_ms']:.4f} ms); plain {row['plain_ms']:.4f} ms; library (amax + "
        f"cast to float8_e4m3fn; nearest, not the same function) device "
        f"{row['library_device_ms'] * 1e3:.3f} us, event pairs {row['library_ms']:.4f} ms; "
        "bit-identical")
    return row


def _act_quant_cases(torch, timer, gen):
    """The launch floor; act_quant timed at ACT_QUANT_SHAPES; then checked,
    not timed, on every path of its plan: block and cluster, each with
    4-element and with 1-element accesses (a misaligned contiguous view),
    clusters of 2, 3, 5, 7 and 8 blocks, scalar heads and tails (d = 100,
    127, 2052, 2101, 4101, 6401), f32 and bf16, E4M3 and E5M2, NaN and Inf
    rows, an outlier row and zero rows."""
    floor_ms = _launch_floor(torch, timer)
    log(f"    launch floor: a one-element fill_, device time from CUDA graphs, "
        f"{floor_ms * 1e3:.3f} us")
    rows = {(m, d): _act_quant_case(torch, timer, gen, m, d, floor_ms)
            for m, d in ACT_QUANT_SHAPES}
    rnd = lambda m, d, dtype=torch.float32: (
        torch.randn((m, d), generator=gen, device=DEV) * 13.0).to(dtype)

    def off(m, d, dtype):  # contiguous, one element past 16-byte alignment
        return rnd(1 + m * d, 1, dtype).view(-1)[1:].view(m, d)

    def with_nan_inf(x):  # a NaN in row 0, an Inf in row 1, a -Inf in row 2
        x = x.clone()
        x[0, x.shape[1] // 3], x[1, 0], x[2, -1] = float("nan"), float("inf"), float("-inf")
        return x

    bf16 = torch.bfloat16
    cases = [((256, 768), rnd(256, 768), "fp8_e4m3", False),
             ((256, 768), rnd(256, 768, bf16), "fp8_e5m2", False),
             ((3, 100), rnd(3, 100), "fp8_e5m2", False),
             ((301, 100), rnd(301, 100, bf16), "fp8_e4m3", False),
             ((301, 127), rnd(301, 127), "fp8_e4m3", False),
             ((7, 2101), rnd(7, 2101), "fp8_e4m3", False),
             ((4, 4101), rnd(4, 4101), "fp8_e4m3", False),
             ((8192, 2052), rnd(8192, 2052, bf16), "fp8_e4m3", False),
             ((16, 73728), rnd(16, 73728, bf16), "fp8_e4m3", False),
             ((16, 73728), rnd(16, 73728), "fp8_e4m3", False),
             ((16, 73728), rnd(16, 73728, bf16), "fp8_e5m2", False),
             ((300, 30), off(300, 30, bf16), "fp8_e4m3", False),
             ((5, 100), off(5, 100, bf16), "fp8_e4m3", False),
             ((256, 768), off(256, 768, bf16), "fp8_e4m3", False),
             ((16, 73728), off(16, 73728, torch.float32), "fp8_e4m3", False),
             ((8, 768), with_nan_inf(rnd(8, 768, bf16)), "fp8_e4m3", True),
             ((256, 6400), with_nan_inf(rnd(256, 6400, bf16)), "fp8_e4m3", True),
             ((16, 73728), with_nan_inf(rnd(16, 73728)), "fp8_e5m2", True),
             # clusters of odd and middling sizes: 4 decode rows of MiniCPM3-4B's
             # d_ff (3 blocks), of 10240 (5) and of Llama-3-8B's d_ff 14336 (7)
             ((4, 6400), rnd(4, 6400, bf16), "fp8_e4m3", False),
             ((4, 6401), rnd(4, 6401, bf16), "fp8_e4m3", False),
             ((4, 1600), off(4, 1600, bf16), "fp8_e4m3", False),
             ((4, 10240), with_nan_inf(rnd(4, 10240, bf16)), "fp8_e4m3", True),
             ((4, 14336), rnd(4, 14336), "fp8_e5m2", False)]
    paths, clusters = set(), set()
    for (m, d), x, fmt, nan in cases:
        kind = "bf16" if x.dtype == bf16 else "f32"
        aligned = x.data_ptr() % 16 == 0
        what = f"({m}, {d}) {kind}{'' if aligned else ', 1 element past 16-byte alignment'}" + (
            ", NaN and Inf rows" if nan else "")
        qk, sk, plan = _act_quant_check(torch, x, fmt, what, nan)
        if nan and not (bool(qk[0].isnan().all()) and bool(sk[0].isnan().all())
                        and bool(qk[1].isnan().any()) and bool(qk[2].isnan().any())):
            fail(f"act_quant {what}: the NaN row is not NaN throughout, or an Inf is not NaN")
        paths.add((plan.path, plan.vec > 1))
        clusters.add(plan.cluster)
        log(f"    act_quant {what} -> {fmt} [{_plan_text(plan)}]: bit-identical")
    want = {(p, v) for p in ("block", "cluster") for v in (True, False)}
    if not want <= paths:
        fail(f"act_quant: the checks took the plan's paths {sorted(paths)}, not all of "
             f"{sorted(want)}")
    if not {3, 5, 7, 8} <= clusters:
        fail(f"act_quant: the checks launched clusters of {sorted(clusters)} blocks, not all of "
             "3, 5, 7 and 8")
    out = torch.cat([torch.full((1, 127), 0.01, device=DEV), torch.full((1, 1), 100.0, device=DEV)], 1)
    zero = torch.zeros((2, 128), device=DEV)
    qk = _act_quant_check(torch, torch.cat([out, zero]), "fp8_e4m3", "outlier and zero rows")[0]
    if float(qk[0, -1]) != 480.0 or bool(qk[1:].any()):
        fail(f"act_quant: the outlier reads {float(qk[0, -1])}, not the grid's top 480, or a "
             "zero row is not zero")
    log("    act_quant an outlier row (-> 480) and two zero rows (-> 0): bit-identical")
    return rows


def _split_check(torch, p, x_q, what):
    """The split GEMM against its plain version; returns (kernel, plain, rel err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_matmul import w4a8_matmul_cuda

    kw = dict(w_fmt=p.w_fmt, group_size=p.group_size)
    kernel = lambda: w4a8_matmul_cuda(x_q, p.codes, p.scale, p.s_max, p.shifts, **kw)
    plain = lambda: ref.w4a8_split_matmul_ref(x_q, p.codes, p.scale, p.s_max, p.shifts, **kw)
    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max()) / float(y_p.abs().max())
    if not err <= SPLIT_RTOL:
        fail(f"w4a8_matmul_split {what} disagrees with its plain version: max |err| {err:.3g} of "
             f"the largest |y| > {SPLIT_RTOL}")
    return kernel, plain, err


def _quantized(torch, m, k, gen):
    from repro_torch.kernels import ref

    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    qv, sc = ref.act_quant_ref(x, "fp8_e4m3")
    return x, (qv * sc).to(torch.bfloat16)


def _split_cases(torch, timer, gen, weights):
    """The split GEMM timed at SPLIT_GEMMS on ``weights`` (by (K, N): RTN,
    fp4_e2m1, M2, g 256, LoRC 8), its other variants checked, and the
    injected fault. Returns (rows, fault reading)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_matmul import w4a8_matmul_cuda

    rows = {}
    for m, k, n in SPLIT_GEMMS:
        p = weights[(k, n)]
        _, x_q = _quantized(torch, m, k, gen)
        kernel, plain, err = _split_check(torch, p, x_q, f"M={m} {k}->{n}")
        w_deq = ref.dequant_packed_ref(p.codes, p.scale, p.w_fmt, p.group_size)
        g = k // p.group_size
        nbytes = m * k * 2 + n * k // 2 + n * g + n * 4 + m * n * 4
        flops = 2 * m * n * k
        b_ms, by = bound(nbytes, flops, "bf16")
        row = dict(**_timed(torch, timer, kernel, plain, lambda: torch.matmul(x_q, w_deq.t())),
                   graph_ms=timer.ms(_graphed(torch, kernel)), bound_ms=b_ms, bound_by=by, max_abs_err=err, bytes=nbytes, flops=flops, kind="bf16")
        rows[(m, k, n)] = row
        log(f"    w4a8_matmul_split M={m:3d} {k:4d}->{n:4d} (fp4_e2m1, M2, g 256): kernel "
            f"{row['ms']:.4f} ms (from a CUDA graph {row['graph_ms']:.4f} ms; device time "
            f"{row['device_ms']:.5f} ms, library {row['library_device_ms']:.5f} ms)  plain "
            f"{row['plain_ms']:.4f} ms  library(bf16 matmul) "
            f"{row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {nbytes} B, {flops} "
            f"FLOP)  max|err| {err:.3g} of max|y|")
    # checked, not timed: E3M0, no M2, g 128, M and N off the tiles
    for w_fmt, mode, gs, m, n in (("fp4_e3m0", "m2", 256, 4, 768), ("fp4_e3m0", "none", 128, 260, 768),
                                  ("fp4_e2m1", "none", 256, 260, 768), ("fp4_e2m1", "m2", 128, 37, 100),
                                  ("fp4_e2m1", "none", 128, 4, 100)):
        p = _packed(torch, 768, n, gen, w_fmt, mode, 0, gs)
        _, x_q = _quantized(torch, m, 768, gen)
        err = _split_check(torch, p, x_q, f"{w_fmt} {mode} g {gs} M={m} 768->{n}")[-1]
        rows[(4, 768, 768)]["max_abs_err"] = max(rows[(4, 768, 768)]["max_abs_err"], err)
        log(f"    w4a8_matmul_split M={m:3d}  768->{n:4d} ({w_fmt}, scale_mode {mode}, g {gs}): "
            f"max|err| {err:.3g} of max|y|")
    # the injected fault: the split GEMM without its s_max finalize (s_max = 1)
    p = weights[(768, 3072)]
    _, x_q = _quantized(torch, 4, 768, gen)
    y_f = w4a8_matmul_cuda(x_q, p.codes, p.scale, torch.ones_like(p.s_max), p.shifts,
                           w_fmt=p.w_fmt, group_size=p.group_size)
    y_p = ref.w4a8_split_matmul_ref(x_q, p.codes, p.scale, p.s_max, p.shifts,
                                    w_fmt=p.w_fmt, group_size=p.group_size)
    fault = float((y_f - y_p).abs().max()) / float(y_p.abs().max())
    if fault <= SPLIT_RTOL:
        fail(f"injected fault (no s_max finalize) reads {fault:.3g} <= {SPLIT_RTOL}: the check "
             "cannot tell it from a sound kernel")
    log(f"    injected fault, split GEMM without its s_max finalize: {fault:.3g} of max|y| "
        f"(> {SPLIT_RTOL} required)")
    return rows, fault


def _graphed(torch, fn):
    """``fn``'s launches captured in a CUDA graph (after a warm-up on a side
    stream); returns its replay, which enqueues them all at once, so the
    host's time between launches leaves the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _split_vs_fused(torch, timer, gen, weights):
    """The split pipeline (act_quant kernel, bf16 cast, split GEMM kernel,
    LoRC by torch.matmul) against the fused kernel on the same packed
    weights and raw activations, timed as called (eager: the host's time
    between the split path's seven launches counts) and replayed from a
    CUDA graph (device time only); they must agree to W4A8_TOL. Returns
    {tag: row}."""
    from repro_torch.kernels import ops

    cases = [(f"m{m}_{k}x{n}", m, k, n, weights[(k, n)]) for m, k, n in SPLIT_GEMMS]
    cases += [(tag, m, k, n, _packed(torch, k, n, gen, lorc_rank=r)) for tag, m, k, n, r in MICROBENCH]
    rows = {}
    for tag, m, k, n, p in cases:
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        split = lambda: _split_pipeline(torch, x, p)
        fused = lambda: ops.w4a8_matmul(x, p)
        y_s, y_f = split(), fused().float()
        torch.cuda.synchronize()
        err = float((y_s - y_f).abs().max())
        if not torch.allclose(y_s, y_f, rtol=W4A8_TOL, atol=W4A8_TOL):
            fail(f"split vs fused {tag} (M={m} {k}->{n}) disagree: max |err| {err}")
        s_ms, f_ms = timer.ms(split), timer.ms(fused)
        sg_ms, fg_ms = timer.ms(_graphed(torch, split)), timer.ms(_graphed(torch, fused))
        r = 0 if p.lorc_a is None else p.lorc_a.shape[-1]
        rows[tag] = dict(m=m, k=k, n=n, lorc_rank=r, split_ms=s_ms, fused_ms=f_ms,
                         ratio=s_ms / f_ms, split_graph_ms=sg_ms, fused_graph_ms=fg_ms,
                         ratio_graph=sg_ms / fg_ms, max_abs_err=err)
        log(f"    w4a8_split_{tag} {s_ms:.4f} ms  w4a8_fused_{tag} {f_ms:.4f} ms  split/fused "
            f"{s_ms / f_ms:.3f};  CUDA graph: split {sg_ms:.4f} ms  fused {fg_ms:.4f} ms  "
            f"split/fused {sg_ms / fg_ms:.3f}  (M={m} {k}->{n}, LoRC {r}; max|err| {err:.3g})")
    return rows


def _flash_inputs(torch, gen, b, s, t, h, hd, dv, dtype):
    q = torch.randn((b, s, h, hd), generator=gen, device=DEV).to(dtype)
    k = torch.randn((b, t, h, hd), generator=gen, device=DEV).to(dtype)
    v = torch.randn((b, t, h, dv), generator=gen, device=DEV).to(dtype)
    return q, k, v


def _row_err(o_k, o_p):
    """The largest relative error of one query row: ||o_k - o_p|| / ||o_p||
    over its dv outputs (f32 tensors (B, S, H, dv))."""
    return float(((o_k - o_p).norm(dim=-1) / o_p.norm(dim=-1).clamp_min(1e-30)).max())


def _flash_check(torch, q, k, v, causal, what):
    """Flash attention against its plain version, elementwise (FLASH_TOL)
    and by query row (FLASH_ROW_RTOL); returns (kernel, plain, max |err|,
    largest row error)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    kernel = lambda: flash_attention_cuda(q, k, v, causal)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal)
    o_k, o_p = kernel().float(), plain().float()
    torch.cuda.synchronize()
    err, row = float((o_k - o_p).abs().max()), _row_err(o_k, o_p)
    tol, row_tol = FLASH_TOL[kind], FLASH_ROW_RTOL[kind]
    if not torch.allclose(o_k, o_p, rtol=tol, atol=tol):
        fail(f"flash_attention {what} disagrees with its plain version: max |err| {err} > {tol}")
    if not row <= row_tol:
        fail(f"flash_attention {what} disagrees with its plain version: a query row is off by "
             f"{row:.3g} of its norm > {row_tol:.3g}")
    return kernel, plain, err, row


def _flash_case(torch, timer, gen, tag, h, hd, dv, s):
    """Causal bf16 flash attention at one timed shape (B = 1, S = T = s),
    held against its plain version and timed beside SDPA. Returns its row."""
    q, k, v = _flash_inputs(torch, gen, 1, s, s, h, hd, dv, torch.bfloat16)
    kernel, plain, err, row_err = _flash_check(torch, q, k, v, True, f"{tag} causal bf16")
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))  # SDPA's (B, H, S, d)
    pairs = s * (s + 1) // 2  # the causal half: (q, k) pairs with k_pos <= q_pos
    flops = 2 * pairs * (hd + dv) * h
    nbytes = 2 * s * h * (2 * hd + 2 * dv)
    b_ms, by = bound(nbytes, flops, "bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(**_timed(torch, timer, kernel, plain, lambda: sdpa(qt, kt, vt, is_causal=True)),
               bound_ms=b_ms, bound_by=by, max_abs_err=err, max_row_rel_err=row_err,
               bytes=nbytes, flops=flops, kind="bf16")
    log(f"    flash_attention {tag} (B=1 H={h} hd={hd} dv={dv} S=T={s}, causal bf16): kernel "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(SDPA) "
        f"{row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {flops} FLOP, "
        f"{nbytes} B)  max|err| {err:.3g}, worst row {row_err:.3g} of its norm  {_dev(row)}")
    return row


def _flash_cases(torch, timer, gen):
    """Causal bf16 flash attention timed at FLASH_SHAPES; non-causal, f32,
    ragged S and T != S checked; the injected fault. Returns (rows, fault)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention_cuda

    rows = {tag: _flash_case(torch, timer, gen, tag, h, hd, dv, s)
            for tag, h, hd, dv, s in FLASH_SHAPES}
    # checked, not timed
    for b, s, t, h, hd, dv, causal, dtype in ((1, 512, 512, 12, 64, 64, False, torch.bfloat16),
                                              (2, 300, 300, 3, 96, 64, True, torch.bfloat16),
                                              (1, 130, 257, 2, 128, 128, True, torch.bfloat16),
                                              (1, 257, 130, 2, 40, 24, True, torch.bfloat16),
                                              (1, 100, 100, 2, 20, 12, True, torch.bfloat16),
                                              (2, 77, 77, 2, 64, 32, True, torch.float32),
                                              (1, 100, 150, 3, 48, 80, False, torch.float32),
                                              # 128-row tiles (B H ceil(S / 128) >= 132) with
                                              # ragged S, T != S and narrow or unaligned widths
                                              (1, 300, 257, 48, 96, 64, True, torch.bfloat16),
                                              (1, 333, 400, 48, 128, 128, False, torch.bfloat16),
                                              (2, 257, 200, 24, 64, 64, True, torch.bfloat16),
                                              (1, 300, 300, 48, 20, 12, True, torch.bfloat16)):
        what = (f"B={b} S={s} T={t} H={h} hd={hd} dv={dv} {'causal' if causal else 'non-causal'} "
                f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
        err, row_err = _flash_check(torch, *_flash_inputs(torch, gen, b, s, t, h, hd, dv, dtype),
                                    causal, what)[2:]
        if dtype == torch.bfloat16:
            _worst(rows["opt125m_s512"], err, row_err)
        log(f"    flash_attention {what}: max|err| {err:.3g}, worst row {row_err:.3g} of its norm")
    # k and v one element past 16-byte alignment (contiguous views): staged one
    # element at a time
    q, k, v = _flash_inputs(torch, gen, 1, 100, 100, 2, 64, 64, torch.bfloat16)
    off = lambda a: torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    k, v = off(k), off(v)
    err, row_err = _flash_check(torch, q, k, v, True, "k and v 2 bytes off alignment")[2:]
    _worst(rows["opt125m_s512"], err, row_err)
    log(f"    flash_attention B=1 S=T=100 H=2 hd=dv=64 causal bf16, k and v 2 bytes off "
        f"alignment: max|err| {err:.3g}, worst row {row_err:.3g} of its norm")
    # the injected fault: the causal mask one key short. Query row i + 1 run as
    # row i masks keys past i, where its own mask ends at i + 1.
    q, k, v = _flash_inputs(torch, gen, 1, 512, 512, 12, 64, 64, torch.bfloat16)
    o_f = flash_attention_cuda(q[:, 1:].contiguous(), k, v, True).float()
    o_p = ref.flash_attention_ref(q, k, v, True)[:, 1:].float()
    fault = float((o_f - o_p).abs().max())
    if torch.allclose(o_f, o_p, rtol=FLASH_TOL["bf16"], atol=FLASH_TOL["bf16"]):
        fail(f"injected fault (causal mask one key short) reads {fault:.3g}: within "
             f"{FLASH_TOL['bf16']}, the check cannot tell it from a sound kernel")
    log(f"    injected fault, flash attention with the causal mask one key short: max|err| "
        f"{fault:.3g} (> {FLASH_TOL['bf16']} required)")
    # the injected fault of one late tile: the kernel fed k and v whose keys
    # [1088, 1152) repeat keys [1024, 1088), as a kernel that staged one KV
    # tile twice past k0 = 1024 would read them, held against the plain
    # version on the true inputs. Only rows past key 1088 see it, where the
    # outputs are small: the row check must catch it
    q, k, v = _flash_inputs(torch, gen, 1, 2048, 2048, 12, 64, 64, torch.bfloat16)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1088:1152], v2[:, 1088:1152] = k[:, 1024:1088], v[:, 1024:1088]
    o_f = flash_attention_cuda(q, k2, v2, True).float()
    o_p = ref.flash_attention_ref(q, k, v, True).float()
    tile_fault = _row_err(o_f, o_p)
    within = torch.allclose(o_f, o_p, rtol=FLASH_TOL["bf16"], atol=FLASH_TOL["bf16"])
    if not tile_fault > FLASH_ROW_RTOL["bf16"]:
        fail(f"injected fault (a KV tile past key 1024 staged twice) reads {tile_fault:.3g} of a "
             f"row's norm <= {FLASH_ROW_RTOL['bf16']:.3g}: the check cannot tell it from a "
             "sound kernel")
    log(f"    injected fault, flash attention with keys 1088-1151 a copy of 1024-1087 (S=T=2048, "
        f"H=12, hd=64): worst row {tile_fault:.3g} of its norm (> {FLASH_ROW_RTOL['bf16']:.3g} "
        f"required); max|err| {float((o_f - o_p).abs().max()):.3g}, "
        f"{'within' if within else 'outside'} the elementwise {FLASH_TOL['bf16']}")
    return rows, (fault, tile_fault)


def _worst(row, err, row_err):
    """Fold a checked, untimed case's readings into a timed shape's row."""
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["max_row_rel_err"] = max(row["max_row_rel_err"], row_err)


def phase_kernel_api(torch):
    """Rows 4-6 through the kernel API (``ops.act_quant``,
    ``ops.w4a8_matmul_split``, ``ops.flash_attention``), which no served
    path reaches: first the path itself (the split W4A8 pipeline at every
    GEMM shape and causal flash attention at every attention shape), with
    the launch counts read around it; then each kernel against its plain
    version, timed, its other variants checked, two injected faults, and
    the split pipeline against the fused kernel."""
    from repro_torch.kernels import ops

    log(f"[11 kernel api] act_quant, the split W4A8 GEMM and flash attention on the card "
        f"(act_quant bit-identical; split GEMM {SPLIT_RTOL} of max|y|; flash attention "
        f"{FLASH_TOL['bf16']} bf16 / {FLASH_TOL['f32']} f32, each query row "
        f"{FLASH_ROW_RTOL['bf16']:.3g} / {FLASH_ROW_RTOL['f32']:.3g} of its norm; times cold-L2, "
        "CUDA events)")
    timer = Timer(torch)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    weights = {(k, n): _packed(torch, k, n, gen) for k, n in sorted({(k, n) for _, k, n in SPLIT_GEMMS})}
    gemms = [(torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16), weights[(k, n)])
             for m, k, n in SPLIT_GEMMS]
    attns = [_flash_inputs(torch, gen, 1, s, s, h, hd, dv, torch.bfloat16)
             for _, h, hd, dv, s in FLASH_SHAPES]
    _set_counts(dict.fromkeys(_counts(), 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [_split_pipeline(torch, x, p) for x, p in gemms]
    outs += [ops.flash_attention(q, k, v, causal=True) for q, k, v in attns]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {**dict.fromkeys(launches, 0), "act_quant": len(gemms),
            "w4a8_matmul_split": len(gemms), "flash_attention": len(attns)}
    if launches != want:
        fail(f"kernel api launches {launches}, want {want}")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        fail("the kernel api path wrote non-finite values")
    launches = {k: v for k, v in launches.items() if v}
    log(f"    path: the split pipeline at {len(gemms)} GEMM shapes and causal flash attention at "
        f"{len(attns)} shapes through ops, {wall * 1e3:.1f} ms wall (first calls); launches "
        f"{launches}; outputs finite")
    act = _act_quant_cases(torch, timer, gen)
    split, split_fault = _split_cases(torch, timer, gen, weights)
    versus = _split_vs_fused(torch, timer, gen, weights)
    flash, flash_faults = _flash_cases(torch, timer, gen)
    return launches, act, split, versus, (split_fault, *flash_faults), flash


# -- phase 12: pressure ------------------------------------------------------------
# Phase 6's server and 8 requests cannot steal as they are: the system prompt
# leaves the active pool once frozen into the FP4 region, a row then holds 1-4
# private pages, its 32 new tokens cross at most one page boundary, which the
# admission's headroom page covers, and the pool cannot shrink below 12 pages
# (a 744-token request's worst case). So phase 12 changes three knobs: 16
# active pages, no headroom page (a row crossing a page boundary allocates
# while decoding) and a frozen region of 6 pages, smaller than the 8-page
# system prompt, so each row holds its last 2 system pages privately too.
# Then growth steals with no fault's help: twice (ticks 33 and 48) in a
# fault-free rehearsal on the CPU with a stub model (the scheduling does not
# read the logits).
PRESSURE_POOL = 16
PRESSURE_FROZEN = 6
# one FP8 page of opt-125m over 12 layers: 1,179,648 bytes of codes and 1,248
# of scales. The budget holds 8 pages: one stolen row's 3-5 pages fit, the
# first two spills (5 + 4 pages) do not, and spills past it are evicted
# oldest first
PRESSURE_SPILL_BUDGET = 8 * 1_180_896
PRESSURE_DEADLINE = 80  # rid 2's deadline_step: meetable, so it shields rid 2
# a NaN on a decoding row (step 46, slot 1), the second spill's bytes flipped,
# and two blanked allocator ticks (engine ticks, counting every step() call):
# tick 50 is a growth tick, so it steals two rows more
PRESSURE_FAULTS = dict(nan_logits=((46, 1),), corrupt_spills=(1,), alloc_fail_ticks=(16, 50))
GAP_TOL = 2.0 ** -4  # tests/test_torch_mixed_engine.py's compare_streams rule


def _pressure_traffic(cfg):
    """Phase 6's 8 requests (the same draws), all submitted at once: rids 0
    and 1 at priority 1, rid 2 with a deadline, the rest at priority 0."""
    import numpy as np

    from repro_torch.runtime import serve

    rng = np.random.default_rng(SEED + 2)
    system = rng.integers(2, cfg.vocab_size, 512).tolist()
    tails = rng.integers(16, 201, size=8)
    return [serve.Request(rid=i, max_new=32, prompt=system + rng.integers(
        2, cfg.vocab_size, int(tails[i])).tolist(), priority=1 if i < 2 else 0,
        deadline_step=PRESSURE_DEADLINE if i == 2 else None) for i in range(8)]


def _record_gaps(torch, srv):
    """Wraps ``srv``'s program and token emission: the top-2 logit gap, as a
    share of the row's largest |logit|, of the row behind each token it
    emits, ``gaps[(rid, index)]`` (the rule ``compare_streams`` reads)."""
    gaps, last = {}, {}
    run, emit = srv._run, srv._emit_token

    def run_(tokens, state, pmask=None):
        logits = run(tokens, state, pmask)
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        last["gap"] = ((top2[:, 0] - top2[:, 1]) / logits.abs().amax(-1)).cpu().tolist()
        return logits

    def emit_(req, token):
        g = last["gap"]
        row = (0 if len(g) == 1 else srv.slots if len(g) == srv.slots + 1 and not req.out
               else next(s for s, r in enumerate(srv.active) if r is req))
        gaps[(req.rid, len(req.out))] = g[row]
        emit(req, token)

    srv._run, srv._emit_token = run_, emit_
    return gaps


def _watch_spills(torch, srv):
    """Wraps ``srv``'s preemption and resume: each spill's engine tick and
    its time and each restore's time per page (device synchronized around
    them), a copy of every payload as it went to the host, and after each
    resume the restored pages read back and held against that copy byte
    for byte."""
    from repro_torch.runtime import kv_cache as kvc

    seen = {"spill_ms": [], "restore_ms": [], "spill_bytes": 0, "restored": 0, "ticks": []}
    kept = {}
    preempt, resume = srv._preempt, srv._resume

    def preempt_(slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preempt(slot)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        seen["ticks"].append(srv._tick)
        sp = srv.preempted[-1]
        npg = kvc.pages_needed(sp.ctx_len, srv.page_size) - sp.shared_pages
        seen["spill_ms"].append(dt * 1e3 / max(npg, 1))
        seen["spill_bytes"] += sp.nbytes
        kept[sp.req.rid] = [{k: a.copy() for k, a in part.items()} for part in sp.payload]

    def resume_(slot, spill, shared_pids, need):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resume(slot, spill, shared_pids, need)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        npg = kvc.pages_needed(spill.ctx_len, srv.page_size) - spill.shared_pages
        seen["restore_ms"].append(dt * 1e3 / max(npg, 1))
        ids = torch.as_tensor(srv.slot_pages[slot][spill.shared_pages:spill.shared_pages + npg],
                              device=srv.device)
        back = [kvc.spill_pages(pool, ids) for pool in srv.pools]
        for part, want in zip(back, kept.pop(spill.req.rid)):
            if {k: a.tobytes() for k, a in part.items()} != {k: a.tobytes() for k, a in want.items()}:
                fail(f"pressure: request {spill.req.rid}'s restored pages differ from its spill")
        seen["restored"] += 1

    srv._preempt, srv._resume = preempt_, resume_
    return seen


def _drain_audited(torch, srv, reqs):
    """Submit every request, then step to the drain, auditing once after
    every step: ``audit_every=1`` audits each step that ran a program, and
    this each step that did not (or every step without it). Returns the
    wall seconds, instrumentation included."""
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        went = srv.step()
        if not (went and srv.audit_every == 1):
            srv.audit()
        if not went and not srv.queue and not srv.preempted:
            break
        if not went and not srv._alloc_faulted:
            fail(f"pressure: serving starved ({len(srv.queue)} queued, "
                 f"{len(srv.preempted)} spilled)")
    else:
        fail("pressure: no drain in 2000 steps")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _first_differences(got, want, gaps_got, gaps_want, skip):
    """Per request that no fault hit: the index of its first token that
    differs from the fully backed run, with both runs' gaps there."""
    out = []
    for rid in sorted(want):
        if rid in skip:
            continue
        a, b = got[rid], want[rid]
        if len(a) != len(b):
            fail(f"pressure: request {rid} emitted {len(a)} tokens, the fully backed run {len(b)}")
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            out.append((rid, i, gaps_got[(rid, i)], gaps_want[(rid, i)]))
    return out


def phase_pressure(torch, cfg, packed, card):
    """Phase 6's server and 8 requests, all at once with priorities and a
    deadline, on a 16-page active pool with a spill budget and a fault plan,
    audited at every step; against a fully backed, fault-free run of the
    same requests on the same server config."""
    from repro_torch.runtime import serve

    knobs = dict(frozen_pages=PRESSURE_FROZEN, scheduler=serve.SchedulerConfig(
        headroom_pages=0, steal_cooldown=2, spill_budget_bytes=PRESSURE_SPILL_BUDGET))
    full = _default_server(torch, cfg, packed, **knobs)
    want_gaps = _record_gaps(torch, full)
    _drain_audited(torch, full, _pressure_traffic(cfg))
    want = {r.rid: list(r.out) for r in full.finished}
    if full.stats["preemptions"] or not all(r.status == "ok" for r in full.finished):
        fail(f"pressure: the fully backed run stole or failed: {full.stats}")
    del full
    plan = serve.FaultPlan(**PRESSURE_FAULTS)
    srv = _default_server(torch, cfg, packed, pool_pages=PRESSURE_POOL, audit_every=1,
                          faults=plan, **knobs)
    gaps = _record_gaps(torch, srv)
    seen = _watch_spills(torch, srv)
    reqs = _pressure_traffic(cfg)
    _set_counts(dict.fromkeys(_counts(), 0))
    wall = _drain_audited(torch, srv, reqs)
    launches = _counts()
    st, n_layers = srv.stats, cfg.n_layers
    want_launches = {**dict.fromkeys(launches, 0), "w4a8_fused": 6 * n_layers * st["programs"],
                     "paged_decode_attn_frozen": n_layers * st["steps"]}
    if launches != want_launches or st["programs"] != st["steps"]:
        fail(f"pressure: kernel launches {launches}, want {want_launches} ({st['programs']} "
             f"programs, {st['steps']} steps)")
    if not (st["preemptions"] >= 2 and st["resumes"] >= 1 and st["spill_evictions"] >= 1
            and st["spill_integrity_failures"] == 1 and seen["restored"] == st["resumes"]):
        fail(f"pressure: want >= 2 preemptions, >= 1 resume, >= 1 spill eviction and exactly "
             f"1 integrity failure: {st}")
    unforced = [t for t in seen["ticks"] if t not in PRESSURE_FAULTS["alloc_fail_ticks"]]
    if not unforced:
        fail(f"pressure: every preemption fell on a blanked allocator tick {seen['ticks']}: "
             f"the pool never ran dry by itself")
    if len(plan.nan_hits) != 1 or plan.blocked_ticks != list(PRESSURE_FAULTS["alloc_fail_ticks"]):
        fail(f"pressure: the fault plan did not land: nan_hits {plan.nan_hits}, blocked ticks "
             f"{plan.blocked_ticks}")
    poisoned = plan.nan_hits[0][2]
    status = {r.rid: r.status for r in srv.finished}
    if len(status) != 8 or {rid for rid, s in status.items() if s != "ok"} != {poisoned} \
            or status[poisoned] != "failed":
        fail(f"pressure: want only request {poisoned} failed: {status}")
    got = {r.rid: list(r.out) for r in srv.finished if r.status == "ok"}
    diffs = _first_differences(got, want, gaps, want_gaps, {poisoned, *plan.corrupted_rids})
    log(f"[12 pressure] opt-125m W4A8, phase 6's server and 8 requests at once (rids 0-1 "
        f"priority 1, rid 2 deadline step {PRESSURE_DEADLINE}) on {PRESSURE_POOL} active pages, "
        f"{PRESSURE_FROZEN} frozen pages, no headroom page, spill budget "
        f"{PRESSURE_SPILL_BUDGET} B, steal cooldown 2, audited every step, faults "
        f"{PRESSURE_FAULTS}, on {card}:")
    log(f"    {st['steps']} steps, {wall:.2f} s wall with the phase's own instrumentation "
        f"(not a throughput baseline); preemptions {st['preemptions']} at ticks {seen['ticks']} "
        f"({len(unforced)} on no blanked tick; {st['pages_stolen']} pages stolen), resumes {st['resumes']}, spill evictions "
        f"{st['spill_evictions']} (integrity failures {st['spill_integrity_failures']}, resume "
        f"fallbacks {st['resume_fallbacks']}), failed {st['failed']} (rid {poisoned}); "
        f"{seen['spill_bytes']} bytes spilled; median spill "
        f"{statistics.median(seen['spill_ms']):.3f} ms a page over {len(seen['spill_ms'])}, "
        f"median restore {statistics.median(seen['restore_ms']):.3f} ms a page over "
        f"{len(seen['restore_ms'])}; restored bytes equal the spills; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for rid, i, g_got, g_want in diffs:
        log(f"    request {rid}: token {i} differs from the fully backed run; top-2 gap "
            f"{g_got:.3g} here, {g_want:.3g} there (of the largest |logit|)")
    if len(diffs) > 1 or any(g >= GAP_TOL for _, _, _, g in diffs):
        fail(f"pressure: streams differ from the fully backed run beyond one tie under "
             f"{GAP_TOL}: {diffs}")
    log(f"    streams of the {len(got) - len(plan.corrupted_rids)} requests no fault hit equal "
        f"the fully backed run's, {len(diffs)} tie(s) under {GAP_TOL}")
    return launches


def step_sum(rows, n_layers, key):
    """One decode step's sum of a kernel's per-launch rows."""
    if key == "bound_ms":  # the bound of the whole step's bytes and operations
        t_b = n_layers * sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        t_o = n_layers * sum(r["flops"] for r in rows) / PEAK_FLOPS[rows[0]["kind"]] * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
    return n_layers * sum(r[key] for r in rows)


def entry(rows, n_layers, **kw):
    """A ``kernels`` line entry: ``rows`` summed over ``n_layers`` layers."""
    b_ms, by = step_sum(rows, n_layers, "bound_ms")
    dev = step_sum(rows, n_layers, "device_ms")
    return {**kw, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": step_sum(rows, n_layers, "ms"), "plain_ms": step_sum(rows, n_layers, "plain_ms"),
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": step_sum(rows, n_layers, "library_ms"),
            "device_ms": dev, "bound_share": b_ms / dev,
            "library_device_ms": step_sum(rows, n_layers, "library_device_ms")}


def _api_entries(launches, act, split, versus, faults, flash):
    """The ``kernels`` line entries of phase 11's three kernels: each one's
    times summed over one launch at each of its timed shapes, and those
    shapes' own numbers under ``per_shape``."""
    path = ("no served path: the kernel API's entry points (ops.act_quant -> "
            "ops.w4a8_matmul_split -> LoRC matmuls, ops.flash_attention), launches from phase 11")
    shapes = lambda rows: {" ".join(map(str, key)) if isinstance(key, tuple) else key:
                           {f: r[f] for f in ("ms", "graph_ms", "device_ms", "plain_ms",
                                              "library_ms", "library_device_ms", "bound_ms",
                                              "max_abs_err", "max_row_rel_err", "path",
                                              "floor_ms", "share_above_floor") if f in r}
                           for key, r in rows.items()}
    return [
        {**entry(list(act.values()), 1, name="act_quant", route="cuda",
                 source="src/repro_torch/csrc/act_quant.cu",
                 replaces="src/repro/kernels/act_quant.py:41", launches=launches["act_quant"],
                 per="the sum of one launch at each (rows, d) of " + str(ACT_QUANT_SHAPES)
                     + ", bf16 -> fp8_e4m3; bit-identical to the plain version; library: amax + "
                       "cast to float8_e4m3fn (448 grid), nearest, not the same function; "
                       "device_ms and library_device_ms: the call's own time after an L2 flush, "
                       "from CUDA graphs of 30 calls less their flushes; per_shape floor_ms: a "
                       "one-element fill_ timed the same way"),
         "path": path, "per_shape": shapes(act)},
        {**entry(list(split.values()), 1, name="w4a8_matmul_split", route="cuda",
                 source="src/repro_torch/csrc/w4a8_matmul.cu",
                 replaces="src/repro/kernels/w4a8_matmul.py:79",
                 launches=launches["w4a8_matmul_split"],
                 per="the sum of one launch at each (M, K, N) of " + str(SPLIT_GEMMS)
                     + ", fp4_e2m1, M2, g 256; max_abs_err as a share of max|y|"),
         "path": path, "per_shape": shapes(split), "fault_no_smax": faults[0],
         "split_vs_fused": versus},
        {**entry(list(flash.values()), 1, name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attn.cu",
                 replaces="src/repro/kernels/flash_attn.py:93",
                 launches=launches["flash_attention"],
                 per="the sum of one causal bf16 launch at each (tag, H, hd, dv, S=T) of "
                     + str(FLASH_SHAPES) + ", B=1; bound counts the causal half"),
         "path": path, "per_shape": shapes(flash),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in flash.values()),
         "fault_mask_one_key_short": faults[1], "fault_tile_staged_twice_row_rel": faults[2]},
    ]


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
    lap = lambda n: log(f"    (phase {n} done, {time.perf_counter() - t_start:.1f} s in)")
    card = phase_device()
    phase_build()
    lap(2)
    gemm, attn, frozen, batched, mla, moe, olmoe_attn = phase_kernels(torch)
    lap(3)
    cfg, packed, t_pack = _opt_125m()
    log(f"    opt-125m init + W4A8 pack on the card: {t_pack:.1f} s")
    launches = phase_serve(torch, cfg, packed)
    lap(4)
    phase_cpu(torch, cfg, packed)
    lap(5)
    launches_6, live = phase_prefix(torch, cfg, packed, card)
    lap(6)
    launches_7, live_7 = phase_mla(torch, card)
    lap(7)
    phase_mla_cpu(torch)
    lap(8)
    olmoe, packed_9, launches_9, live_9 = phase_moe(torch, card)
    lap(9)
    phase_moe_cpu(torch, olmoe, packed_9)
    lap(10)
    del packed_9
    api_launches, act, split, versus, faults, flash = phase_kernel_api(torch)
    lap(11)
    launches_12 = phase_pressure(torch, cfg, packed, card)
    lap(12)
    del packed

    for r in gemm.values():
        r["kind"] = "bf16"
    for r in (*attn.values(), frozen, *olmoe_attn.values()):
        r["kind"] = "f32"
    for r in (*batched.values(), *moe.values(), *mla.values()):  # MLA: exact bf16 products
        r["kind"] = "bf16"
    # one decode step at 4 slots. opt-125m: per layer q, k, v, o (768->768),
    # up (768->3072) and down (3072->768) at M=4, and one attention launch.
    # MiniCPM3: per layer the 7 GEMMs of MINICPM3_GEMMS at M=4, wv_b and wk_b
    # once each, and one latent decode launch (the frozen variant, as served).
    # OLMoE: per layer q, k, v, o (2048->2048) at M=4, wu, wg and wd over
    # the 64 expert slabs of 4 rows (each token's row nonzero in 8), and one
    # attention launch at KV=16, hd 128
    opt_layer = [gemm[s] for s in [(4, 768, 768)] * 4 + [(4, 768, 3072), (4, 3072, 768)]]
    cpm_layer = [gemm[(4, k, n)] for k, n in MINICPM3_GEMMS]
    olmoe_layer = [gemm[(4, 2048, 2048)]] * 4
    moe_layer = [moe[("wu", "routed")]] * 2 + [moe[("wd", "routed")]]
    a = attn["fp8_e4m3"]
    per_olmoe_attn = lambda r, what: {**entry([r], 16), "per": what}
    kernels = [
        {**entry(opt_layer, 12, name="w4a8_fused", route="cuda",
                 source="src/repro_torch/csrc/w4a8_fused.cu",
                 replaces="src/repro/kernels/w4a8_fused.py:169",
                 launches=launches["w4a8_fused"],
                 per="one opt-125m decode step: 72 launches at M=4; launches from phase 4"),
         "max_abs_err": max(r["max_abs_err"] for r in gemm.values()),
         "minicpm3": {**{k: v for k, v in entry(cpm_layer, 62).items()},
                      "launches": launches_7["w4a8_fused"],
                      "per": "one MiniCPM3-4B decode step: 434 launches at M=4; launches "
                             "from phase 7"},
         "olmoe": {**entry(olmoe_layer, 16), "launches": launches_9["w4a8_fused"],
                   "per": "one OLMoE-1B-7B decode step: 64 launches at M=4, 2048->2048; "
                          "launches from phase 9"},
         "pressure": {"launches": launches_12["w4a8_fused"],
                      "per": "phase 12: phase 6's traffic on a 16-page pool, stolen and resumed"}},
        {"name": "paged_decode_attn", "route": "cuda", "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:131",
         "launches": launches["paged_decode_attn"],
         **entry([a], 12), "max_abs_err": max(r["max_abs_err"] for r in attn.values()),
         "per": "12 launches (one per layer), fp8 pages, B=4, contexts 2048/1337/300/1",
         "olmoe": per_olmoe_attn(olmoe_attn["fp8_e4m3"],
                                 "16 launches (one per layer), fp8 pages, KV=H=16, hd 128, B=4, "
                                 "contexts 2048/1337/300/1; phase 9 serves the frozen variant")},
        {"name": "paged_decode_attn_frozen", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:131 (frozen)",
         "launches": launches_6["paged_decode_attn_frozen"],
         **entry([frozen], 12), "max_abs_err": max(frozen["max_abs_err"], live[0]),
         "per": "12 launches (one per layer), fp8 pages with half of each row's full pages "
                "in the fp4 frozen region, B=4, contexts 2048/1337/300/1; launches from phase 6",
         "olmoe": {**per_olmoe_attn(olmoe_attn["frozen"],
                                    "16 launches (one per layer), KV=H=16, hd 128, otherwise as "
                                    "above; launches from phase 9"),
                   "launches": launches_9["paged_decode_attn_frozen"]},
         "pressure": {"launches": launches_12["paged_decode_attn_frozen"],
                      "per": "phase 12: phase 6's traffic on a 16-page pool, stolen and resumed"}},
        entry([batched[False]], 62, name="w4a8_fused_batched", route="cuda",
              source="src/repro_torch/csrc/w4a8_fused.cu",
              replaces="src/repro/kernels/w4a8_fused.py:169 (batched, a_fmt=None)",
              launches=launches_7["w4a8_fused_batched"],
              per="one MiniCPM3-4B decode step: 62 launches of wv_b (E=40, M=4, 256->64); "
                  "launches from phase 7"),
        entry([batched[True]], 62, name="w4a8_fused_transposed", route="cuda",
              source="src/repro_torch/csrc/w4a8_fused.cu",
              replaces="src/repro/kernels/w4a8_fused.py:169 (transpose_w=True, a_fmt=None)",
              launches=launches_7["w4a8_fused_transposed"],
              per="one MiniCPM3-4B decode step: 62 launches of wk_b (E=40, M=4, 64->256); "
                  "launches from phase 7"),
        {**entry(moe_layer, 16, name="w4a8_fused_batched_fp8", route="cuda",
                 source="src/repro_torch/csrc/w4a8_fused.cu",
                 replaces="src/repro/kernels/w4a8_fused.py:169 (batched, a_fmt='fp8_e4m3')",
                 launches=launches_9["w4a8_fused_batched_fp8"],
                 per="one OLMoE-1B-7B decode step: 48 launches (wu, wg 2048->1024, wd "
                     "1024->2048) over E=64 slabs of M=4 rows, each token's row nonzero in 8 "
                     "slabs; launches from phase 9"),
         "max_abs_err": max(r["max_abs_err"] for r in moe.values()),
         "per_launch_ms": {f"{w} {m}": r["ms"] for (w, m), r in moe.items()},
         "per_launch_device_ms": {f"{w} {m}": r["device_ms"] for (w, m), r in moe.items()},
         "per_launch_library_device_ms": {f"{w} {m}": r["library_device_ms"]
                                          for (w, m), r in moe.items()}},
        {**entry([mla[("fp8_e4m3", True)]], 62, name="paged_mla_decode_attn", route="cuda",
                 source="src/repro_torch/csrc/mla_decode_attn.cu",
                 replaces="src/repro/kernels/decode_attn.py:287",
                 launches=launches_7["paged_mla_decode_attn"]
                 + launches_7["paged_mla_decode_attn_frozen"],
                 per="one MiniCPM3-4B decode step: 62 launches of the frozen variant, B=4, "
                     "H=40, r=256, dr=32, page 64, contexts 2048/1337/300/1 with half of each "
                     "row's full pages frozen; launches (all variants) from phase 7"),
         "max_abs_err": max(max(r["max_abs_err"] for r in mla.values()), live_7[0]),
         "variants_ms": {f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''}": r["ms"]
                         for (fmt, fz), r in mla.items()},
         "variants_device_ms": {f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''}":
                                r["device_ms"] for (fmt, fz), r in mla.items()},
         "fault_combine_drops_last_split": mla[("fp8_e4m3", True)]["fault_combine_drops_last_split"]},
    ]
    kernels += _api_entries(api_launches, act, split, versus, faults, flash)
    for k in kernels:  # its source's registers and spills, from phase 2's build log
        k["ptxas"] = _ptxas_summary(PTXAS.get(Path(k["source"]).stem))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
