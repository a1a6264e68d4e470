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
              at g = 4 query heads a KV head (H 32, KV 8, hd 128); whisper-
              tiny's shapes checked: the GEMM at K = 384 (groups of 192)
              at M = 4 and 1500, and decode attention over its cross plan
              (kv_len 1500 in a 24-page table, H = KV = 6);
4. serve   -- opt-125m at full width, random weights from a seed, packed to
              W4A8 (FP4 E2M1 weights, M2 scales, LoRC rank 8, FP8 E4M3
              activations), served greedily over FP8 pages; every request
              must end ok and every decode step must have launched both
              kernels (72 GEMMs and 12 attention launches);
5. cpu     -- the same packed model through the plain versions on the
              card (phase 20's time paid for its CPU route):
              one prefill chunk and 1 decode step for 2 requests, logits
              and teacher-forced blocks compared with the kernels'; two
              injected faults show what the comparison can and cannot
              tell apart;
6. prefix -- the reference Server's default path: the mixed prefill+decode
              engine, the prefix cache and FP8 pages with a packed-FP4
              frozen region, at opt-125m's full width; 8 requests in two
              waves share a 512-token system prompt. Every request must
              end ok, the prompt's pages must freeze into FP4 and be hit,
              every step must have launched the GEMM and the frozen
              attention variant, and at one step the frozen kernel is held
              against its plain version on the live pool (and an injected
              fault must read far above the tolerance);
7. mla     -- MiniCPM3-4B (MLA) at full width, depth cut to 31 of its 62
              layers, random weights initialized and packed on the card,
              on phase 6's server and traffic: every request ok, every
              route's launches equal to their invariant (7 x 31 GEMMs, 31
              of each batched GEMM orientation and 31 frozen latent-decode
              launches a step, no GQA attention), the live latent-pool
              check with an injected fault, and a profiled decode step;
8. mla cpu -- MiniCPM3 at full width cut to 2 layers against the CPU plain
              path (2 requests: a prefill chunk and 1 decode step),
              free-running, teacher-forced at each attention block and at
              each batched-GEMM and latent-decode call, with two injected
              faults (wk_b's LoRC dropped in the batched kernel, the latent
              decode one token short); then over contiguous caches (2
              prompts of 64 tokens + 2 scalar-index steps, card against the
              CPU, 9 row-1 launches a layer at the prefill and 7 row-1 +
              1 row-1b + 1 row-1c a step; every row-1b and row-1c call
              held on its own operands against the plain version, wk_b
              without its LoRC factors CONTIG_FAULT x the bound), each prompt
              spliced into FP8 latent pages and one paged step through
              row 3;
9. moe     -- OLMoE-1B-7B (64 experts top-8, 16 layers) at full width,
              random weights initialized and packed on the card, on phase
              6's server and traffic: every request ok, every route's
              launches equal to their invariant (4 x 16 GEMMs, 3 x 16
              batched expert GEMMs with FP8 activations and 16 frozen GQA
              decode launches at hd 128 a step), the live-pool check with an
              injected fault, and a profiled decode step;
10. moe cpu -- phase 9's model cut to 2 layers against the plain versions
              on the card (2 requests: a prefill chunk and 1 decode step),
              teacher-forced at each MoE layer and each expert GEMM call
              (and free-running, a gross check), with the router's
              experts compared and two
              injected faults (wd's LoRC dropped, one expert of wu reading
              its neighbour's weights), on phase 9's seed alone; then
              over contiguous caches (2 prompts of 64 tokens + 1
              scalar-index step: the grouped capacity dispatch, 4 row-1
              and 3 row-1d launches a layer a program) against the plain
              versions on the card, every row-1d call held on its own
              operands within MOE_OP_RTOL of the plain version, expert 0
              reading expert 1's weights CONTIG_FAULT x above it;
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
              spill and restore time a page are printed, not gated;
13. sampling -- opt-125m on phase 6's server and traffic with 4 of the 8
              requests sampled (top-k / top-p / temperature mixes, seeds 0,
              2^31, 2^32 - 1, 12345): every request ok, phase 6's launch
              invariants, the greedy streams equal to phase 6's up to one
              tie; the sampler teacher-forced on one of its decode steps'
              logits (B = 4, V = 50272) under 4 mixes x 5 (seed, count), the
              threefry bits and Gumbel noise bit-identical and the tokens
              identical on the card and on the CPU, JAX's known answers on
              the card, and the sampler's time a call; a sampled request
              solo (1 slot) and rids 4-7 at 16 new tokens on phase 12's
              16-page pool (rid 7, sampled, stolen and resumed) against the
              batched and a fully backed run, up to one tie (a sampled row's margin: the
              top-2 gap of its masked, scaled logits plus its Gumbel noise);
              then the front-end: 4 concurrent ``AsyncServer.generate``
              streams (2 sampled), each equal to its ``RequestResult``, and
              one SSE request to ``serve_http`` on 127.0.0.1; the median
              TTFT and ITL are printed, not gated. At most 60 s;
14. ptq -- the paper's PTQ pipeline on opt-125m at full width, random
              weights from a seed on the card: the calibration stream (4 x
              8 x 2048 tokens, a quarter of the paper's), GPTQ over all 12
              layers (FP4 E2M1, group 256, M2, LoRC 8, damp 0.01), timed in
              total and per layer; each weight's Hessian-weighted error
              tr(dW H dW^T) before LoRC against RTN's under the same M2
              constraint on the same Hessian (every layer's sum at or below
              RTN's, the model's below it); layer 0's wq and down again on
              the CPU (M2 s_max bit-identical, shifts and codes equal on at
              least 99.9 %); those two packed (``pack_linear(w, policy,
              qt=qt)``) through row 1's kernel at M = 4 and 256, within
              W4A8_TOL of its plain version and of the GPTQ dense result,
              with a doubled group scale read 10x above it; perplexity of
              W16, RTN and GPTQ W4A8 on 2 held-out batches, printed, not
              gated. At most 60 s;
15. dense -- olmo-1b, minitron-8b, llava-next-34b (text-only) and
              nemotron-4-340b (d_model 18432, d_ff 73728, 96 heads of 192
              over 8 KV heads, the untied 256000-row head) at their
              published widths (full vocabularies) cut to 2 layers, random
              weights from the seed packed on the card, each on phase 6's
              server: 2 requests (one prefill chunk, 4 decode steps) ok,
              every route's launches equal to their invariant (7 or 6 GEMMs
              a layer and one frozen decode launch a layer a step); at one
              decode step every block teacher-forced against the plain
              versions on the card within BLOCK_RTOL; layer 0's wd through
              row 1 at M = 4 within W4A8_TOL of its plain version, and with
              the group contributing most to its output scaled by 2 at least
              10 tolerances off (nemotron-4-340b: wd's K = 73728 leaves one
              group too small a share of a row, so that fault is read and
              layer 0's up carries it). At most DENSE_BUDGET_S;
16. encdec -- whisper-tiny at its published config (4 + 4 layers, d_model
              384, encoder_seq 1500, vocab 51865), random weights from the
              seed packed on the card, on phase 6's server, which falls back
              to the alternating engine: 8 requests over 4 frame sets
              (3 task tokens + 0-200 tokens of previous text, 32 new
              tokens; rids 0 and 1 share frames and a 128-token prompt, rid 2
              has it under other frames): every request ok, 24 cross pages
              charged at each admission, whose encoder launches 24 GEMMs
              and 8 cross K/V GEMMs at M = 1500; rid 1 maps rid 0's page
              under its frames' root, rid 2 shares none and its stream
              equals its cold run up to one tie; every decode step launches
              32 GEMMs, 4 self-attention (frozen variant) and 4 cross
              launches; row 2 on the live cross pool against its plain
              version, with the encoder length one short read 10x above it;
              a profiled decode step; then 2 requests against the CPU plain
              path (a prefill chunk and 2 decode steps) teacher-forced at
              each decoder block and its cross-attention, one cross page's
              s_max doubled and the encoder's last layer skipped each read
              above BLOCK_RTOL there. The encoder's time at admission, the
              decode step and tokens/s are printed, not gated. At most 60 s;
17. recurrent -- xlstm-125m (12 layers, d_model 768) and zamba2-1.2b (38
              layers, d_model 2048) at full width, random weights from the
              seed packed on the card, each on a server asking for the mixed
              engine, which resolves to the alternating one over state slabs
              (no prefix cache), audited every step: 4 greedy requests (16
              new tokens) ok, fully backed, with every program's launches
              equal to the invariant (xLSTM 42 GEMMs, Zamba2 118 GEMMs, and
              7 decode attention launches a decode step); then the same
              traffic on 2 slabs for 4 slots, where a priority-1 request
              steals a slab and its victim resumes from the spill: the
              streams bit-identical to the fully backed ones; tokens/s
              printed, not gated. Then each cut to 2 layers against the CPU
              plain path (2 requests: an exact prefill chunk and 2 decode
              steps), teacher-forced per block within BLOCK_RTOL, with a
              recycled slab not reset and the conv tail shifted by one token
              each read at least 2 x BLOCK_RTOL. At most 75 s;
18. deepseek -- DeepSeek-V3 at its published widths (d_model 7168, 128
              heads, MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v
              128, 256 experts top-8 of d_ff 2048 + 1 shared, dense d_ff
              18432, vocab 129280), cut to 4 of its 61 layers (the 3 dense
              layers and the first MoE layer) plus the MTP block, random
              weights from the seed initialized and packed on the card leaf
              by leaf, on phase 6's server and traffic: every request ok,
              a step's launches equal to the invariant (28 GEMMs, 4 + 4
              per-head GEMMs, 3 expert GEMMs with FP8 activations, 4 frozen
              latent decode launches; none for the MTP block), the live
              latent pool's check with its injected fault, a profiled
              decode step; then against the plain versions on the card: the
              served blocks teacher-forced (a prefill chunk and a decode
              step), the cache-free dense, MoE and MTP blocks, one expert's
              group scale doubled at least 10 tolerances off, and
              ``loss_fn(mtp_weight=0.3)`` on 2 x 1024 tokens (nll, aux and
              mtp within DS_LOSS_RTOL; 46 GEMMs and 6 expert GEMMs), with
              four planted faults read beside it (dense layer 0's down with
              its scales doubled must read above DS_LOSS_RTOL). Pack
              time, peak memory, tokens/s, the step medians and the losses
              printed. At most 240 s;
19. train -- training (``launch.steps.make_train_step``: ``loss_fn`` under
              autograd with remat, then AdamW): one step of every SMOKE
              config on the card against the same step on the CPU, from
              params drawn on the CPU, the gradients within GRAD_TOL of each
              leaf's largest and block 0's residual detached at least
              GRAD_FAULT x GRAD_TOL; opt-125m at full width (12 layers,
              d_model 768, vocab 50272, tied head, dense bf16, AdamW f32
              moments) one step at B 2 x S 128 the same way, then 200 steps
              of ``runtime.train.train_loop`` over SyntheticLM (seq 512,
              batch 8, lr 6e-4, warmup 20: examples/train_and_quantize.py's
              paper preset cut from 300 steps) with checkpoints at steps 100
              and 200, each restored bit-identical to what was saved, the
              last logged nll below the first, and a run resumed from step
              100 whose first loss is within RESUME_RTOL of the
              uninterrupted run's; the step's median time, tokens/s, peak
              memory and a profiled step's busy share printed; then the
              trained model packed to W4A8 and served phase 4's traffic
              (every request ok, rows 1 and 2 launched as the invariant
              says), its perplexity in bf16 and W4A8 on 4 held-out batches
              and the greedy streams' distinct tokens printed. At most
              TRAIN_BUDGET_S;
20. contiguous -- (run after phase 13, on phase 4's packed tree) the
              contiguous-cache path: 4 prompts of 512 tokens through
              ``api.prefill`` into caches of 1024, 64 greedy steps of
              ``api.decode_step`` at a scalar index, every program 72
              row-1 launches and no attention launch, tokens/s and the
              median step printed, not gated; its prefill (M = 2048 a
              call) and first step run again, every row-1 call held on its
              own operands within W4A8_TOL of the plain version, with its
              top group scale doubled above it in every call and
              CONTIG_FAULT x in one; the prompts prefilled again
              with activations unquantized, spliced
              (``kv_cache.splice_prefill``) into bf16 and FP8 pages, 8
              paged steps through row 2 on the same tokens within
              CONTIG_RTOL of the contiguous logits, the same steps one
              position short at least CONTIG_FAULT x that bound;
              the paged bf16 Server's streams of the same prompts equal to
              the contiguous ones up to a tie each. At most
              CONTIG_BUDGET_S.

Phase 3 also checks and times DeepSeek-V3's shapes on weights drawn as
stored (row 1 at its 9 (K, N), N = 576 and K = 14336 among them, timed at
M = 4 and checked at 128; rows 1b / 1c at 128 heads of 128 x 512; row 1d
over 256 experts, routed at M = 4 and as 80-row capacity slabs, checked
and not timed; row 3 at
r 512, dr 64, H 128 over the three page variants, with NaN planted), the
recurrent families' shapes (row 1 at
xLSTM's and Zamba2's 10 (K, N), among them N = 8384, timed at M = 4 and
checked at a prefill chunk's M = 128; row 2 at H = KV = 32, hd 64) and
MiniCPM3's kernels (the GEMM at its 7
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
import contextlib
import dataclasses
import itertools
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


def _synthetic_packed(torch, lead, n, k, gen, lorc_rank=8, group_size=256):
    """A packed (*lead, n, k) FP4 E2M1 weight drawn as it is stored: random
    codes, random group scales (~0.5 / sqrt(k), a random weight's) under
    the M2 constraint, and rank-``lorc_rank`` LoRC factors. The kernels'
    shapes at DeepSeek-V3's widths, without packing billions of random
    weights first (LoRC's eigendecomposition of a 7168-wide Gram matrix
    takes seconds a slice)."""
    from repro_torch.core.ptq import effective_group
    from repro_torch.core.scales import apply_scale_constraint, constrain_scales_m2
    from repro_torch.models.layers import PackedLinear

    lead, group_size = tuple(lead), effective_group(k, group_size)
    codes = torch.randint(0, 256, lead + (n, k // 2), generator=gen, device=DEV,
                          dtype=torch.uint8)
    raw = (torch.rand(lead + (n, k // group_size), generator=gen, device=DEV) + 0.25) \
        * (0.5 / math.sqrt(k))
    scale = apply_scale_constraint(raw, "m2")
    m2 = constrain_scales_m2(scale)
    lorc = lambda shape, sd: (torch.randn(shape, generator=gen, device=DEV) * sd).to(torch.bfloat16)
    return PackedLinear(codes=codes, scale=scale.float(), s_max=m2.s_max,
                        shifts=m2.shifts.to(torch.int8),
                        lorc_a=lorc(lead + (n, lorc_rank), 0.05),
                        lorc_b=lorc(lead + (lorc_rank, k), 0.05 / math.sqrt(k)),
                        w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=group_size)


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
                a_fmt="fp8_e4m3", p=None):
    """A packed (n, k) weight (``p``, or one packed from random weights)
    and an (m, k) input; the kernel's output held against its plain
    version. Returns (packed, x, kernel, plain, err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_matmul_cuda

    if p is None:
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


def _w4a8_case(torch, timer, m, k, n, gen, p=None):
    from repro_torch.kernels import ref

    p, x, kernel, plain, err = _w4a8_check(torch, m, k, n, gen, p=p)
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


def _attn_check(torch, fmt, gen, window=0, kv=12, hd=64, h=None, lens=None, nan=False, pp=None):
    """A random pool at the decode shapes of opt-125m (``kv`` heads of width
    ``hd``; OLMoE-1B-7B: 16 of 128; ``h`` query heads, ``kv`` by default;
    ``pp`` pages a row's table, 32 by default)
    and the kernel's output held against its plain version (and launched
    twice, bit-identical). ``nan``: see ``_stale_nan``. Returns the
    operands, the two callables and the error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
    from repro_torch.runtime import kv_cache as kvc

    b, page = 4, 64
    lens = lens or ATTN_LENS
    pp = pp or 2048 // page
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


def _batched_check(torch, transpose, m, gen, scale_mode="m2", lorc_rank=8, w_fmt="fp4_e2m1",
                   heads=40, n=64, r=256):
    """The absorbed head projections (MiniCPM3's widths by default): a
    packed (heads * n, r) weight viewed per head (``packed_head_view``),
    wk_b transposed (x (heads, M, n) -> (heads, M, r)) or wv_b normal (x
    (heads, M, r) -> (heads, M, n)), bf16 activations unquantized; the
    kernel held against its plain version. Returns (view, x, kernel, plain,
    err)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.ptq import pack_linear
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda
    from repro_torch.models.layers import packed_head_view

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
    what = (f"w4a8_fused batched {'transposed (wk_b)' if transpose else 'normal (wv_b)'} "
            f"E={heads} M={m} {n}x{r} {w_fmt} scale_mode={scale_mode} lorc_rank={lorc_rank}")
    _deterministic(torch, kernel, y_k, what)
    if not torch.allclose(y_k, y_p, rtol=W4A8_TOL, atol=W4A8_TOL):
        fail(f"{what} disagrees with its plain version: max |err| {err}")
    return v, x, kernel, plain, err


def _batched_case(torch, timer, transpose, gen, heads=40, n=64, r=256):
    """The served variant (M2, LoRC 8) at a decode step's M=4, timed."""
    from repro_torch.kernels import ref

    v, x, kernel, plain, err = _batched_check(torch, transpose, 4, gen, heads=heads, n=n, r=r)
    w_deq = ref.dequant_packed_ref(v.codes, v.scale, v.w_fmt, v.group_size)  # (heads, n, r)
    library = (lambda: torch.matmul(x, w_deq)) if transpose else \
        (lambda: torch.matmul(x, w_deq.transpose(1, 2)))
    e, in_f, m, r = heads, r, 4, v.lorc_a.shape[-1]
    d, n_out = (n, in_f) if transpose else (in_f, n)
    nbytes = (e * m * d * 2 + e * n * in_f // 2 + e * n * (in_f // v.group_size) + e * n * 4
              + e * n * r * 2 + r * in_f * 2 + e * m * n_out * 4)  # lorc_b: one factor for all heads
    flops = 2 * e * m * n * in_f + 2 * e * m * r * (n + in_f)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    name = f"transposed (wk_b, {n}->{in_f})" if transpose else f"normal (wv_b, {in_f}->{n})"
    log(f"    w4a8_fused batched {name} E={e} M=4: kernel {row['ms']:.4f} ms  plain "
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
    """Row 1d at an expert stack: ``p`` E packed (n, k) expert weights
    (OLMoE-1B-7B's 64: wu and wg 2048 -> 1024, wd 1024 -> 2048; DeepSeek-V3's
    256: 7168 -> 2048 and 2048 -> 7168) and x (E, m, k) raw N(0,1) bf16
    activations, quantized to FP8 in-kernel; with ``routed`` they are as
    served: each of the m tokens' rows is nonzero in 8 of the E slabs (its
    top-8 experts) and zero in the rest. The kernel held
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
            f"{f' routed (8 of {e} slabs per token)' if routed else ''} scale_mode="
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
    w_deq = ref.dequant_packed_ref(p.codes, p.scale, p.w_fmt, p.group_size)  # library's (E, n, k)
    library = lambda: torch.bmm(x, w_deq.transpose(1, 2))
    (e, n, k), g, r = w_deq.shape, p.scale.shape[-1], p.lorc_a.shape[-1]
    # an expert whose slab holds no nonzero row needs none of its weights
    live = int((x.abs().amax((1, 2)) > 0).sum())
    nbytes = (e * m * k * 2 + live * (n * k // 2 + n * g + n * 4 + (n * r + r * k) * 2)
              + e * m * n * 4)
    flops = 2 * rows * n * k + 2 * rows * r * (k + n)
    b_ms, by = bound(nbytes, flops, "bf16")
    row = dict(**_timed(torch, timer, kernel, plain, library), bound_ms=b_ms, bound_by=by,
               max_abs_err=err, bytes=nbytes, flops=flops)
    log(f"    {what}: kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library(bf16 "
        f"bmm) {row['library_ms']:.4f} ms  bound {b_ms * 1e3:.2f} us ({by}; {live} of {e} "
        f"experts' weights, {nbytes} B, "
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


def _mla_check(torch, gen, fmt, frozen, b, h, r, dr, page, lens, nan=False,
               scale=1.0 / math.sqrt(96)):
    """A random latent pool (``_mla_layer``) and the MLA decode kernel's
    output held against its plain version within ATTN_TOL, launched twice
    (bit-identical) and finite where NaN was planted (``nan``)."""
    layer, table, kv_lens, n_frozen = _mla_layer(torch, gen, b, r, dr, page, lens, fmt, frozen,
                                                 nan)
    q_lat = torch.randn((b, h, r), generator=gen, device=DEV).to(torch.bfloat16)
    q_rope = torch.randn((b, h, dr), generator=gen, device=DEV).to(torch.bfloat16)
    # 1 / sqrt(qk_nope + qk_rope): MiniCPM3's by default
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


def _mla_case(torch, timer, gen, fmt, frozen, shape=MLA_SHAPE, scale=1.0 / math.sqrt(96)):
    from repro_torch.runtime import kv_cache as kvc

    b, h, r, dr, page, lens = (shape[k] for k in ("b", "h", "r", "dr", "page", "lens"))
    layer, table, kv_lens, n_frozen, q_lat, q_rope, scale, kernel, plain, err, what = \
        _mla_check(torch, gen, fmt, frozen, b, h, r, dr, page, lens, scale=scale)
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
# slice 14, (K, N) of a decode step's row-1 launches. xlstm-125m, one mLSTM /
# sLSTM pair: up_proj, wq, wk, down_proj, w_gates, ffn_up, ffn_down.
# zamba2-1.2b: in_proj (N = 2 x 4096 + 2 x 64 + 64 = 8384, no multiple of 128)
# and out_proj a Mamba2 layer; q, k, v, o, up and down a shared-block invocation
XLSTM_PAIR_GEMMS = ((768, 3072), (1536, 1536), (1536, 1536), (1536, 768), (768, 3072),
                    (768, 2048), (1024, 768))
ZAMBA2_LAYER_GEMMS = ((2048, 8384), (4096, 2048))
ZAMBA2_SHARED_GEMMS = ((2048, 2048),) * 4 + ((2048, 8192), (8192, 2048))
RECURRENT_GEMMS = sorted(set(XLSTM_PAIR_GEMMS + ZAMBA2_LAYER_GEMMS + ZAMBA2_SHARED_GEMMS))
RECURRENT_CHUNK_M = 128  # a prefill chunk's rows, checked beside the decode step's 4


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
    # slice 13: whisper-tiny's shapes. Row 1 at K = 384 quantizes in groups
    # of 192 (effective_group(384, 256)); the encoder and the cross K/V run
    # it at M = 1500. Row 2 over a request's cross pages: kv_len 1500 in a
    # 24-page table (the last page holding 28 tokens), H = KV = 6, hd 64
    whisper = {"max_abs_err": 0.0}
    for m in (4, 1500):
        for k, n in ((384, 384), (384, 1536), (1536, 384)):
            p, *_, err = _w4a8_check(torch, m, k, n, gen)
            whisper["max_abs_err"] = max(whisper["max_abs_err"], err)
            log(f"    w4a8_fused M={m:4d} {k:4d}->{n:4d} group {p.group_size} (whisper-tiny): "
                f"max|err| {err:.3g}")
    gemm["whisper"] = whisper
    for fmt in ("fp8_e4m3", None):
        err = _attn_check(torch, fmt, gen, kv=6, hd=64, lens=[1500, 1500, 1500, 1499], pp=24)[-1]
        attn[fmt]["max_abs_err"] = max(attn[fmt]["max_abs_err"], err)
        log(f"    paged_decode_attn {fmt or 'bf16'} pages, whisper-tiny cross plan (B 4, H = KV = "
            f"6, hd 64, kv_len 1500 / 1499 in 24 pages): max|err| {err:.3g}")
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
    recurrent = _recurrent_kernels(torch, timer, gen, gemm)
    deepseek = _deepseek_kernels(torch, timer, gen)
    return gemm, attn, frozen, batched, mla, moe, olmoe_attn, recurrent, deepseek


# slice 15, DeepSeek-V3 at its published widths. (K, N) of row 1: wq_a, wq_b,
# wkv_a (N = 576, no multiple of 128), wo, the dense layers' gate / up and
# down, the shared expert's gate / up and down, and mtp/proj (K = 14336)
DS_MLA_GEMMS = ((7168, 1536), (1536, 24576), (7168, 576), (16384, 7168))
DS_DENSE_GEMMS = ((7168, 18432), (7168, 18432), (18432, 7168))
DS_SHARED_GEMMS = ((7168, 2048), (7168, 2048), (2048, 7168))
DS_GEMMS = sorted(set(DS_MLA_GEMMS + DS_DENSE_GEMMS + DS_SHARED_GEMMS + ((14336, 7168),)))
DS_HEADS = dict(heads=128, n=128, r=512)  # wk_b / wv_b per head: 128 heads of 128 x 512
DS_EXPERTS = (("wu", 7168, 2048), ("wd", 2048, 7168))  # (weight, In, N); wg is wu's shape
DS_CAPACITY_ROWS = 80  # a cache-free slab over 2048 tokens: 2 groups x C = 40
DS_MLA_SHAPE = dict(b=4, h=128, r=512, dr=64, page=64, lens=[2048, 1337, 300, 1])
DS_MLA_SCALE = 1.0 / math.sqrt(192)  # 1 / sqrt(qk_nope 128 + qk_rope 64)


def _deepseek_kernels(torch, timer, gen):
    """Slice 15: the five rows DeepSeek-V3 runs, at its shapes, on weights
    drawn as stored (``_synthetic_packed``). Row 1 timed at a decode step's
    M = 4 and checked at a prefill chunk's 128 rows at every (K, N) of
    DS_GEMMS; rows 1b / 1c (128 heads of 128 x 512) timed at M = 4 and
    checked at 260; row 1d at 256 experts (wu 7168 -> 2048, wd 2048 ->
    7168), checked (not timed: PERF.md keeps their times) as served (M =
    4, each token's row nonzero in 8 of the 256 slabs) and as the
    cache-free grouped dispatch gives it (80 rows a slab, all nonzero);
    row 3 at r 512, dr 64, H 128 over FP8 + FP4 frozen, FP8 and bf16
    pages, timed against SDPA, and checked with NaN planted outside the
    valid tokens. Returns
    {"gemm": {(4, K, N): row}, "batched": {bool: row}, "moe": {(weight,
    kind): row}, "mla": {(fmt, frozen): row}}."""
    gemm = {}
    for k, n in DS_GEMMS:
        p = _synthetic_packed(torch, (), n, k, gen)
        gemm[(4, k, n)] = row = _w4a8_case(torch, timer, 4, k, n, gen, p=p)
        err = _w4a8_check(torch, 128, k, n, gen, p=p)[-1]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"    w4a8_fused M=128 {k:5d}->{n:5d} (DeepSeek-V3's prefill chunk): max|err| {err:.3g}")
    batched = {tr: _batched_case(torch, timer, tr, gen, **DS_HEADS) for tr in (False, True)}
    for tr in (False, True):
        err = _batched_check(torch, tr, 260, gen, **DS_HEADS)[-1]
        batched[tr]["max_abs_err"] = max(batched[tr]["max_abs_err"], err)
        log(f"    w4a8_fused batched {'transposed' if tr else 'normal'} E={DS_HEADS['heads']} M=260 "
            f"(DeepSeek-V3's heads): max|err| {err:.3g}")
    moe = {}  # checked, not timed (PERF.md §6 keeps their times)
    for name, k, n in DS_EXPERTS:
        p = _synthetic_packed(torch, (256,), n, k, gen)
        for kind, m in (("routed", 4), ("grouped", DS_CAPACITY_ROWS)):
            *_, err, what = _moe_check(torch, p, m, gen, routed=kind == "routed")
            moe[(name, kind)] = {"max_abs_err": err}
            log(f"    {what}: max|err| {err:.3g} (checked, not timed)")
        del p
        torch.cuda.empty_cache()
    mla = {key: _mla_case(torch, timer, gen, *key, shape=DS_MLA_SHAPE, scale=DS_MLA_SCALE)
           for key in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False))}
    for (fmt, fz), row in mla.items():
        *_, err, what = _mla_check(torch, gen, fmt, fz, *(DS_MLA_SHAPE[k] for k in (
            "b", "h", "r", "dr", "page", "lens")), nan=True, scale=DS_MLA_SCALE)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"    {what}, NaN outside the valid tokens: max|err| {err:.3g}")
    return {"gemm": gemm, "batched": batched, "moe": moe, "mla": mla}


def _recurrent_kernels(torch, timer, gen, gemm):
    """Slice 14: the recurrent families' shapes. Row 1 at every (K, N) of
    RECURRENT_GEMMS, timed at a decode step's M = 4 (the shapes phase 4 or
    OLMoE already timed are reused) and checked at a prefill chunk's M =
    128, Zamba2's in_proj (N = 8384, a ragged last tile) among them; row 2
    at Zamba2's shared block (H = KV = 32, hd 64, g = 1) over FP8 pages,
    timed at the 4 ragged contexts of 2048 and checked at its served plan
    (8 pages a row of 64) and the split plan's edges. Returns {"gemm":
    {(4, K, N): row}, "attn": row}."""
    rows = {}
    for k, n in RECURRENT_GEMMS:
        row = gemm.get((4, k, n)) or _w4a8_case(torch, timer, 4, k, n, gen)
        p, *_, err = _w4a8_check(torch, RECURRENT_CHUNK_M, k, n, gen)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        rows[(4, k, n)] = row
        log(f"    w4a8_fused M={RECURRENT_CHUNK_M} {k:4d}->{n:4d} group {p.group_size} "
            f"(recurrent families' prefill chunk): max|err| {err:.3g}")
    attn = _attn_case(torch, timer, "fp8_e4m3", gen, kv=32, hd=64)
    err = _attn_check(torch, "fp8_e4m3", gen, kv=32, hd=64, lens=[300, 137, 64, 1], pp=8)[-1]
    err2, _ = _attn_edge_checks(torch, gen, 32, 64)
    attn["max_abs_err"] = max(attn["max_abs_err"], err, err2)
    log(f"    paged_decode_attn fp8 pages H = KV = 32 hd 64 (zamba2-1.2b's shared block), "
        f"served plan (8 pages of 64, lens 300/137/64/1) and split edges: max|err| "
        f"{max(err, err2):.3g}")
    return {"gemm": rows, "attn": attn}


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
    from repro_torch.core.ptq import init_packed

    t0 = time.perf_counter()
    packed = init_packed(CONFIG, _serve_policy(), seed=SEED)
    return CONFIG, packed, time.perf_counter() - t0


def phase_serve(torch, cfg, packed, tag="[4 serve] opt-125m", profile=True):
    """Phase 4's traffic (8 requests of 32-512 prompt tokens, 32 new, the
    alternating engine over FP8 pages) on ``packed``: every request ok and
    the launches equal to the invariant. Returns (launches, results)."""
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
    busy = _profile_decode(torch, srv, rng, cfg.vocab_size) if profile else None
    log(f"{tag} W4A8 (fp4_e2m1 + M2 + LoRC r8, fp8_e4m3 acts), fp8 pages, "
        f"{config.slots} slots: {len(results)} requests ok, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tokens/s; {steps} decode steps, median decode step "
        f"{statistics.median(decode_ms):.2f} ms over {len(decode_ms)} steps; {programs - steps} "
        f"prefill chunks; launches {launches}")
    if busy:
        log(busy)
    return launches, results


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


PLAIN = {"_route": lambda t: "cpu"}  # kernels.ops on the plain versions, CUDA tensors on the card


@contextlib.contextmanager
def _ops_patched(patch):
    """``kernels.ops`` with the attributes in ``patch`` (a route's third
    field, e.g. PLAIN) replaced, restored on exit."""
    from repro_torch.kernels import ops

    saved = {k: getattr(ops, k) for k in patch}
    for k, v in patch.items():
        setattr(ops, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def _in_segments(packed, part, name, fn):
    """``packed`` with ``fn`` applied to every ``segments[i][part][k][name]``
    (e.g. part "ffn", name "wd": each MoE layer's expert stack)."""
    return {**packed, "segments": [
        {**seg, part: {**seg[part], **{k: {**v, name: fn(v[name])} for k, v in seg[part].items()
                                         if isinstance(v, dict) and name in v}}}
        for seg in packed["segments"]]}


def _routes(torch, packed, family="dense", cpu=True):
    """name -> (params, device, attributes of ``ops`` replaced for the run).
    The faults: ``no_lorc`` drops the LoRC correction (dense: from every
    linear, through the plain versions; MLA: from ``wk_b`` only, MoE: from
    ``wd`` only, through the batched kernel); ``short_kv`` reads decode
    attention one token short (the plain version; MLA: the MLA decode
    kernel); MoE has ``expert_swap`` instead: expert 0 of every ``wu``
    stack reads expert 1's weights (through the kernel)."""
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

    routes = {"card": (packed, DEV, {}),
              "card_plain": (packed, DEV, PLAIN)}
    if cpu:
        routes["cpu"] = (tree_map(to_cpu, packed, is_leaf=is_packed), "cpu", {})
    if family == "moe":  # its faults run through the kernels themselves
        routes["no_lorc"] = (_in_segments(packed, "ffn", "wd", drop), DEV, {})
        routes["expert_swap"] = (_in_segments(packed, "ffn", "wu", lambda t: t.apply(swap)), DEV,
                                 {})
        return routes
    if family == "mla":
        attn = ops.paged_mla_decode_attn
        short = {"paged_mla_decode_attn": lambda ql, qr, layer, pt, lens, scale:
                 attn(ql, qr, layer, pt, lens - 1, scale)}
        routes["no_lorc"] = (_in_segments(packed, "mixer", "wk_b", drop), DEV, {})
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
             ref="cpu", frames=None, encoders=None):
    """Two requests (one prefill chunk, then ``n_dec`` decode steps; prompts
    from SEED + 1) along every
    route, each with a pool of its own, all fed the card's greedy tokens.
    ``ref`` names the reference route (the CPU plain path by default). An
    enc-dec model takes ``frames`` (a (T, d) array a request): each route
    runs its encoder once a request into cross pages of its own first
    (``encoders[route]``, when given, is (the config to encode with, a
    function applied to the written cross pool): an injected fault), and
    site "block" also forces and reads each cross-attention sub-block
    (``cross``: its output is the update).
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
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (100, 37)]
    pools = {name: _pools(cfg, 2 * pp, page, d) for name, (_, d, _) in routes.items()}
    table = np.arange(2 * pp, dtype=np.int32).reshape(2, pp)
    t = lambda a, d: torch.as_tensor(np.asarray(a, np.int32)).to(d)
    cross, cpp = {}, 0
    if frames is not None:  # each route's encoder writes its own cross pages
        cpp = kvc.pages_needed(cfg.encoder_seq, page)
        for name, (params, d, patch) in routes.items():
            enc_cfg, post = (encoders or {}).get(name, (cfg, None))
            cross[name] = kvc.init_cross_pool(cfg.n_layers, 2 * cpp, page, cfg.n_kv_heads,
                                              cfg.resolved_head_dim, "fp8_e4m3", device=d)
            with _ops_patched(patch):
                for row, fr in enumerate(frames):
                    api.encode_cross_pages(params, enc_cfg, torch.as_tensor(fr)[None].to(d),
                                           cross[name],
                                           t(np.arange(row * cpp, (row + 1) * cpp)[None], d),
                                           a_fmt="fp8_e4m3")
            if post is not None:
                post(cross[name])
    cross_table = np.arange(2 * max(cpp, 1), dtype=np.int32).reshape(2, -1)
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
            fn, cross_fn = getattr(tf, hooked), tf.paged_cross_attention

            def block(p, x, *args, **kw):
                (x,) = fed(len(trace), (x,))
                entry = ["block", (x,), None]  # before the cross site the block calls
                trace.append(entry)
                y = fn(p, x, *args, **kw)
                entry[2] = y[0]
                return y

            def cross_block(p, x, *args, **kw):
                (x,) = fed(len(trace), (x,))
                y = cross_fn(p, x, *args, **kw)
                trace.append(("cross", (x,), y))
                return y
            return {(tf, hooked): block, (tf, "paged_cross_attention"): cross_block}
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

    def run(name, tokens, pt, lengths, chunk_len, lead, rows):
        params, d, patch = routes[name]
        trace = []  # (site key, inputs, output) of every site, in order
        with _ops_patched(patch):
            wrapped = hooks(d, lead, trace)  # around the route's own ops
            saved = {key: getattr(*key) for key in wrapped}
            for (mod, attr), v in wrapped.items():
                setattr(mod, attr, v)
            st = kvc.PagedState(t(pt, d), t(lengths, d),
                                None if chunk_len is None else t([chunk_len], d),
                                cross_table=t(cross_table[rows], d) if cross else None,
                                enc_lengths=t([cfg.encoder_seq] * len(rows), d) if cross else None)
            logits = api.decode_step(params, cfg, t(tokens, d), pools[name], st, a_fmt="fp8_e4m3",
                                     cross=cross.get(name))
            for (mod, attr), v in saved.items():
                setattr(mod, attr, v)
        return logits.float().cpu(), trace

    def step(tokens, pt, lengths, rows, chunk_len=None):
        out = {"card": run("card", tokens, pt, lengths, chunk_len, None, rows)}
        for name in routes:
            if name != "card":
                out[name] = run(name, tokens, pt, lengths, chunk_len, out["card"][1], rows)
        for name, (o, _) in out.items():
            if not bool(torch.isfinite(o).all()):
                fail(f"non-finite logits on route {name}")
        ref_logits, ref_sites = out[ref]
        scale = float(ref_logits.abs().max())
        f64 = lambda v: v.double().cpu()
        for name, (o, sites) in out.items():
            r = reading[name]
            r["logits"] = max(r["logits"], float((o - ref_logits).abs().max()) / scale)
            for (key, _, y), (_, (x0, *_), y0) in zip(sites if forced else (), ref_sites):
                if key == "router":
                    routing(r, y, y0, x0)
                    continue
                base = f64(y0) - f64(x0) if site == "block" and key == "block" else f64(y0)
                r[key] = max(r.get(key, 0.0), float((f64(y) - f64(y0)).norm() / base.norm()))
        top2 = out["card"][0].topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > logit_rtol * scale
        same = out["card"][0].argmax(-1) == ref_logits.argmax(-1)
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
        nxt += step(toks, table[row:row + 1, :2], [0], [row], len(prompt))
    lengths = np.array([len(p) for p in prompts], np.int32)
    for _ in range(n_dec):
        nxt = step(np.array(nxt, np.int32)[:, None], table, lengths, [0, 1])
        lengths += 1
    return reading, agree


def _to_device(a, d):
    """A tensor, or a dict of tensors (a pool layer), on device ``d``."""
    return {k: v.to(d) for k, v in a.items()} if isinstance(a, dict) else a.to(d)


def phase_cpu(torch, cfg, packed):
    """The packed model along four routes, against the plain versions on
    the card (phase 20's time paid for its CPU route; phases 8,
    14, 16, 17 and 19 still compare the card with the CPU):

    * ``card``       -- the CUDA kernels, as served in phase 4;
    * ``card_plain`` -- the plain versions on the card's tensors (``ops``
      routed as for CPU tensors): the witness that separates the kernels
      from the rest of the card path (FP8 fake-quant, page appends, norms),
      and the reference;
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
    must read at most BLOCK_RTOL, each fault more."""
    routes = _routes(torch, packed, cpu=False)
    # 1 decode step, not 4 (since phase 18 came): every site, the decode
    # attention's included, still runs on both requests
    kw = dict(n_dec=1, ref="card_plain")
    free, agree = _compare(torch, cfg, routes, forced=False, **kw)
    forced, _ = _compare(torch, cfg, routes, forced=True, **kw)
    show = lambda rd, key: ", ".join(f"{n} {rd[n][key]:.4g}" for n in routes if n != "card_plain")
    log(f"[5 cpu] 2 requests (1 prefill chunk + 1 decode step) against the plain versions on "
        f"the card")
    log(f"    free-running, largest |logit err| / largest |logit| (tolerance {LOGIT_RTOL}): "
        f"{show(free, 'logits')}; greedy tokens agree {agree[0]}/{agree[2]}, all {agree[1]} "
        f"decisive ones")
    log(f"    teacher-forced blocks, largest |block output err| / |block update| "
        f"(tolerance {BLOCK_RTOL}): {show(forced, 'block')}")
    if free["card"]["logits"] > LOGIT_RTOL:
        fail(f"free-running logits of the card differ from the plain versions on the card by "
             f"{free['card']['logits']:.4g} of the largest |logit| > {LOGIT_RTOL}")
    if forced["card"]["block"] > BLOCK_RTOL:
        fail(f"the blocks of the card differ from the plain versions on the card by "
             f"{forced['card']['block']:.4g} of their update > {BLOCK_RTOL}")
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


def _mem(torch):
    """The card's memory as the caching allocator holds it."""
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


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


def _default_server(torch, cfg, packed, faults=None, frozen_pages=64, engine="mixed", **knobs):
    """The reference Server's default path: mixed engine, prefix cache,
    FP8 pages with an FP4 frozen region of 64 pages, 4 slots; ``knobs``
    (slots, pool_pages, audit_every, scheduler), ``frozen_pages`` and
    ``faults`` for phases 12 and 13. ``engine``: the engine the server must
    resolve to (an enc-dec model falls back to the alternating one)."""
    from repro_torch.runtime import serve

    config = serve.ServerConfig(**{
        "slots": 4, "max_seq": 1024, "page_size": 64, "a_fmt": "fp8_e4m3",
        "cache": serve.CachePolicy(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1",
                                   frozen_pages=frozen_pages),
        "prefix_cache": True, **knobs})
    srv = serve.Server(packed, cfg, config, faults=faults)
    if srv.engine != engine:
        fail(f"the default engine resolved to {srv.engine!r}, not {engine!r}")
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
    return launches, live, {r.rid: list(r.tokens) for r in results}


def _serve_policy():
    """Phase 4's serving policy: RTN, FP4 E2M1 weights in groups of 256,
    M2, LoRC 8, FP8 E4M3 activations."""
    from repro_torch.core.policy import QuantPolicy

    return QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256, scale_mode="m2",
                       lorc_rank=8)


def _random_packed(torch, name, n_layers=None):
    """A config of the port at its published widths (``n_layers`` cuts the
    depth), random weights from SEED, initialized and packed on the card
    leaf by leaf by the port's ``init_packed`` (the bits of
    ``pack_params(init_params(...))``; the dense tree of DeepSeek-V3's 4
    layers + MTP, ~53 GB in bf16, would not fit beside the packed one).
    Returns (cfg, packed, seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.core.ptq import init_packed

    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    packed = init_packed(cfg, _serve_policy(), seed=SEED)
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


MLA_SERVED_LAYERS = 31  # phase 7's depth: half of MiniCPM3-4B's 62, to pay for phases 15-16


def phase_mla(torch, card):
    """MiniCPM3-4B (MLA) at full width on the reference Server's default
    path, served by the GEMM (7 linears a layer), the batched and
    transposed GEMM (wv_b, wk_b) and the frozen MLA decode kernel."""
    cfg, packed, t_pack = _random_packed(torch, "minicpm3-4b", n_layers=MLA_SERVED_LAYERS)
    log(f"[7 mla] MiniCPM3-4B ({cfg.n_layers} of 62 layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
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
    # 1 decode step, not 4 (since phase 14 came): each pass runs 3 programs
    # a route instead of 6, and every decode-only site (wk_b, wv_b, the
    # latent attention) still runs on both requests
    kw = dict(logit_rtol=MLA_LOGIT_RTOL, n_dec=1)
    free, agree = _compare(torch, cfg, routes, forced=False, **kw)
    forced, _ = _compare(torch, cfg, routes, forced=True, site="mixer", **kw)
    op, _ = _compare(torch, cfg, routes, forced=True, site="ops", **kw)
    show = lambda rd, key: ", ".join(f"{n} {rd[n][key]:.4g}" for n in routes if n != "cpu")
    log(f"[8 mla cpu] MiniCPM3 at full width, 2 layers: 2 requests (1 prefill chunk + 1 "
        f"decode step) against the CPU plain path")
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
    return free, forced, op, _mla_contiguous(torch, cfg, routes)


MLA_CONTIG_PROMPT = 64  # tokens a row, one page: the splice fills it


def _mla_contiguous(torch, cfg, routes):
    """MLA over contiguous caches: 2 prompts of MLA_CONTIG_PROMPT
    tokens prefilled (the materialized form: 9 row-1 launches a layer),
    then 2 scalar-index decode steps (the absorbed form: 7 row-1, 1 row-1b
    (wv_b) and 1 row-1c (wk_b) launches a layer), on the card and on the
    CPU plain path fed the card's tokens: logits within MLA_LOGIT_RTOL.
    Then each prompt spliced into a latent FP8 pool and one paged step
    through row 3 on the first decode token, within MLA_LOGIT_RTOL of the
    contiguous step. Returns (the card's launches of the contiguous run,
    the paged step's)."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.runtime import kv_cache as kvc

    n, b = cfg.n_layers, 2
    prompts = np.random.default_rng(SEED + 8).integers(2, cfg.vocab_size, (b, MLA_CONTIG_PROMPT))
    _set_counts(dict.fromkeys(_counts(), 0))
    card, caches, toks, counts, _ = _contiguous_run(torch, cfg, routes["card"][0], prompts,
                                                    2 * MLA_CONTIG_PROMPT, 2)
    launches = _counts()
    _launch_check(counts, {"w4a8_fused": 9 * n},
                  {"w4a8_fused": 7 * n, "w4a8_fused_batched": n, "w4a8_fused_transposed": n},
                  "phase 8 contiguous")
    cpu, *_ = _contiguous_run(torch, cfg, routes["cpu"][0], prompts, 2 * MLA_CONTIG_PROMPT, 2,
                              tokens=[t.cpu() for t in toks])
    free = max(_share(torch, c.cpu(), p) for c, p in zip(card, cpu))
    pool = kvc.init_mla_pool(n, 2 * b, MLA_CONTIG_PROMPT, cfg.mla.kv_lora_rank,
                             cfg.mla.qk_rope_dim, "fp8_e4m3", device=DEV)
    table = torch.arange(2 * b, dtype=torch.int32, device=DEV).reshape(b, 2)
    for r in range(b):
        kvc.splice_prefill(pool, {k: v[:, r:r + 1] for k, v in caches[0]["kv"].items()},
                           [2 * r], MLA_CONTIG_PROMPT)
    _set_counts(dict.fromkeys(_counts(), 0))
    got = api.decode_step(routes["card"][0], cfg, toks[0].to(torch.int32)[:, None], [pool],
                          kvc.PagedState(table, torch.full((b,), MLA_CONTIG_PROMPT,
                                                           dtype=torch.int32, device=DEV)),
                          a_fmt="fp8_e4m3")
    paged = _counts()
    spliced = _share(torch, got, card[1])
    log(f"    contiguous caches: 2 prompts of {MLA_CONTIG_PROMPT} tokens + 2 scalar-index "
        f"steps, card against the CPU plain path, largest |logit err| / largest |logit| "
        f"{free:.4g} (bound {MLA_LOGIT_RTOL}); launches {launches} (9 row-1 a layer at the "
        f"prefill, 7 row-1 + 1 row-1b + 1 row-1c a layer a step); spliced into FP8 latent "
        f"pages, one paged step (row 3) {spliced:.4g} of the contiguous step's (bound "
        f"{MLA_LOGIT_RTOL}), launches {paged}")
    if free > MLA_LOGIT_RTOL or spliced > MLA_LOGIT_RTOL:
        fail(f"phase 8 contiguous: card {free:.4g} / spliced {spliced:.4g} > {MLA_LOGIT_RTOL}")
    if paged != {**dict.fromkeys(paged, 0), "w4a8_fused": 7 * n, "w4a8_fused_batched": n,
                 "w4a8_fused_transposed": n, "paged_mla_decode_attn": n}:
        fail(f"phase 8 spliced step: launches {paged}")
    # the card's run again, each wk_b / wv_b call of its absorbed steps held
    # on its own operands against the plain version (MLA_OP_RTOL,
    # MLA_WVB_RTOL); wk_b without its LoRC factors must read CONTIG_FAULT x
    # its bound
    drop = lambda w: dataclasses.replace(w, lorc_a=None, lorc_b=None)
    held, _ = _held_calls(
        torch, cfg, routes["card"][0], prompts, 2 * MLA_CONTIG_PROMPT, toks,
        "w4a8_matmul_batched",
        key=lambda x, w, transpose_w=False, **kw: "wk_b" if transpose_w else "wv_b",
        reading=_fro,
        fault=lambda call, x, w, transpose_w=False, **kw:
            call(x, drop(w), transpose_w=True, **kw) if transpose_w else None)
    bounds = {"wk_b": MLA_OP_RTOL, "wv_b": MLA_WVB_RTOL}
    log("    the card's run again, each absorbed step's call on its own operands against the "
        "plain version, largest ||err|| / ||output||: "
        + ", ".join(f"{k} {max(v[0]):.4g} ({len(v[0])} calls, bound {bounds[k]})"
                    for k, v in held.items())
        + f"; wk_b without its LoRC factors {max(held['wk_b'][1]):.4g} (>= {CONTIG_FAULT} x "
        f"{MLA_OP_RTOL} required)")
    if sorted(held) != ["wk_b", "wv_b"] or any(len(v[0]) != 2 * n for v in held.values()):
        fail(f"phase 8 contiguous: held calls {[(k, len(v[0])) for k, v in held.items()]}")
    for k, (sound, _) in held.items():
        if max(sound) > bounds[k]:
            fail(f"phase 8 contiguous: the {k} calls read {max(sound):.4g} > {bounds[k]}")
    if max(held["wk_b"][1]) < CONTIG_FAULT * MLA_OP_RTOL:
        fail(f"phase 8 contiguous: wk_b without LoRC reads {max(held['wk_b'][1]):.4g} < "
             f"{CONTIG_FAULT} x {MLA_OP_RTOL}: the comparison cannot tell it from a sound card "
             f"path")
    return launches, paged, held


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
    """OLMoE at full width cut to 2 layers along four routes against the
    plain versions on the card (see phase_cpu): the kernels, the plain
    versions, and two faults through the kernels -- ``no_lorc`` drops wd's
    LoRC correction, ``expert_swap`` makes expert 0 of wu read expert 1's
    weights. Phase 9's weights (its first 2 layers), prompts from SEED,
    read teacher-forced at each MoE layer and each expert GEMM call, fed
    the card's operands: every wu, wg and wd call of the kernels within
    MOE_OP_RTOL of the plain versions' output, ``no_lorc`` above it on wd
    and ``expert_swap`` on wu (the MoE layer's reading shows what its last
    call and the combine add; the forcing hides wu's fault there); the
    router, fed the card's hidden states, picks the plain route's experts
    for every token but where its gap between its 8th and 9th probability
    is below MOE_TIE. Also read free-running, a gross check of the whole
    path: the card within MOE_LOGIT_RTOL, which no fault has to exceed. (A
    second seed, 2 layers packed anew from SEED + 1, was read the same way
    until phase 14 took its time; the free-running pass ran the CPU route
    too until phase 17 took its time, the forced pass until phase 18 did.)"""
    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map

    n = 2
    cfg = dataclasses.replace(cfg, n_layers=n)
    cut = lambda t: t.apply(lambda a: a[:n]) if isinstance(t, PackedLinear) else t[:n]
    packed = {**packed, "segments": [tree_map(cut, seg, is_leaf=lambda x: isinstance(x, PackedLinear))
                                     for seg in packed["segments"]]}
    kw = dict(logit_rtol=MOE_LOGIT_RTOL, n_dec=1, ref="card_plain")
    routes = _routes(torch, packed, "moe", cpu=False)
    show = lambda rd, key, f=".4g": ", ".join(f"{n} {rd[n][key]:{f}}" for n in routes)
    free, agree = _compare(torch, cfg, routes, forced=False, **kw)
    log(f"[10 moe cpu] OLMoE at full width, 2 layers: 2 requests (1 prefill chunk + 1 decode "
        f"step) against the plain versions on the card")
    free_read = ", ".join(f"{n} {r['logits']:.4g}" for n, r in free.items() if n != "card_plain")
    log(f"    free-running (seed {SEED}) against the plain versions on the card, largest |logit "
        f"err| / largest |logit| (gross bound {MOE_LOGIT_RTOL}): {free_read}; greedy tokens "
        f"agree {agree[0]}/{agree[2]}, all {agree[1]} decisive ones")
    if free["card"]["logits"] > MOE_LOGIT_RTOL:
        fail(f"free-running logits of the card differ from the plain versions on the card by "
             f"{free['card']['logits']:.4g} of the largest |logit| > {MOE_LOGIT_RTOL}")
    op, _ = _compare(torch, cfg, routes, forced=True, site="moe_ops", **kw)
    for key in ("wu", "wg", "wd"):
        log(f"    teacher-forced expert GEMM calls (row 1d), {key}, largest |output err| / "
            f"|output| (bound {MOE_OP_RTOL}): {show(op, key)}")
    log(f"    teacher-forced MoE layers, largest |output err| / |output|: {show(op, 'moe')}")
    log(f"    router, fed the card's hidden states: tokens whose experts differ from the plain "
        f"route's {show(op, 'router_flips', 'd')} of {op['card']['router_tokens']} per route; "
        f"largest plain-route probability gap among them {show(op, 'router_gap', '.3g')} (tie "
        f"below {MOE_TIE})")
    for key in ("wu", "wg", "wd"):
        if op["card"][key] > MOE_OP_RTOL:
            fail(f"the {key} calls of the kernels differ from the plain versions on the card by "
                 f"{op['card'][key]:.4g} of their output > {MOE_OP_RTOL}")
    if op["card"]["router_gap"] >= MOE_TIE:
        fail(f"the kernels' route picks other experts than the plain versions' where its "
             f"probability gap is {op['card']['router_gap']:.3g} >= {MOE_TIE}")
    for name, key in (("no_lorc", "wd"), ("expert_swap", "wu")):
        if op[name][key] <= MOE_OP_RTOL:
            fail(f"injected fault {name} reads {op[name][key]:.4g} <= {MOE_OP_RTOL} on {key}: "
                 f"the comparison cannot tell it from a sound card path")
    return free, op, _moe_contiguous(torch, cfg, routes)


def _moe_contiguous(torch, cfg, routes):
    """MoE over contiguous caches: 2 prompts of 64 tokens prefilled,
    then 1 scalar-index decode step, each MoE layer on the grouped capacity
    dispatch (row 1d: wu, wg, wd over the capacity slabs; 4 row-1 launches
    a layer for the attention), the card against the plain versions on the
    card fed its tokens: logits within MOE_LOGIT_RTOL. Returns the card's
    launches."""
    import numpy as np

    n = cfg.n_layers
    prompts = np.random.default_rng(SEED + 10).integers(2, cfg.vocab_size, (2, 64))
    _set_counts(dict.fromkeys(_counts(), 0))
    card, _, toks, counts, _ = _contiguous_run(torch, cfg, routes["card"][0], prompts, 128, 1)
    launches = _counts()
    step = {"w4a8_fused": 4 * n, "w4a8_fused_batched_fp8": 3 * n}
    _launch_check(counts, step, step, "phase 10 contiguous")
    plain, *_ = _contiguous_run(torch, cfg, routes["card_plain"][0], prompts, 128, 1,
                                tokens=toks, patch=PLAIN)
    free = max(_share(torch, c, p) for c, p in zip(card, plain))
    log(f"    contiguous caches: 2 prompts of 64 tokens + 1 scalar-index step (grouped "
        f"capacity dispatch), card against the plain versions on the card, largest |logit err| "
        f"/ largest |logit| {free:.4g} (gross bound {MOE_LOGIT_RTOL}); launches {launches}")
    if free > MOE_LOGIT_RTOL:
        fail(f"phase 10 contiguous: {free:.4g} > {MOE_LOGIT_RTOL}")
    # the same run again, every expert GEMM call (row 1d over the capacity
    # slabs) held on its own operands against the plain version within
    # MOE_OP_RTOL; expert 0 reading expert 1's weights must read CONTIG_FAULT x
    # that in every call's kind
    order = itertools.count()
    swap = lambda t: torch.cat([t[1:2], t[1:]])
    held, _ = _held_calls(
        torch, cfg, routes["card"][0], prompts, 128, toks, "w4a8_matmul_batched",
        key=lambda *a, **kw: ("wu", "wg", "wd")[next(order) % 3], reading=_fro,
        fault=lambda call, x, w, *a, **kw: call(x, w.apply(swap), *a, **kw))
    log("    the same run, each expert GEMM call on its own operands against the plain version, "
        f"largest ||err|| / ||output|| (bound {MOE_OP_RTOL}): "
        + ", ".join(f"{k} {max(v[0]):.4g} ({len(v[0])} calls)" for k, v in held.items())
        + "; expert 0 reading expert 1's weights: "
        + ", ".join(f"{k} {max(v[1]):.4g}" for k, v in held.items())
        + f" (>= {CONTIG_FAULT} x {MOE_OP_RTOL} required)")
    for k, (sound, bad) in held.items():
        if max(sound) > MOE_OP_RTOL:
            fail(f"phase 10 contiguous: the {k} calls read {max(sound):.4g} > {MOE_OP_RTOL}")
        if max(bad) < CONTIG_FAULT * MOE_OP_RTOL:
            fail(f"phase 10 contiguous: expert 0 reading expert 1's {k} reads {max(bad):.4g} "
                 f"< {CONTIG_FAULT} x {MOE_OP_RTOL}: the comparison cannot tell it from a sound "
                 f"card path")
    if sorted(held) != ["wd", "wg", "wu"] or any(len(v[0]) != 2 * cfg.n_layers
                                                 for v in held.values()):
        fail(f"phase 10 contiguous: held calls {[(k, len(v[0])) for k, v in held.items()]}")
    return launches, held


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


def _draw_margins(torch, logits, arrs):
    """By how much each row's token won, as a share of the row's largest
    |logit| (``compare_streams``' tie rule): a greedy row's top-2 logit gap;
    a sampled row's top-2 gap of its masked, scaled logits plus its Gumbel
    noise, over the largest |scaled logit| it kept. ``arrs``: the rows'
    ``sampling.slot_arrays``."""
    from repro_torch.runtime import sampling as smp
    from repro_torch.runtime import threefry as tf

    temps, top_ks, top_ps, seeds, counts = smp.as_tuple(arrs, logits.device)
    logits = logits.float()
    top2 = torch.topk(logits, 2, dim=-1).values
    greedy = (top2[:, 0] - top2[:, 1]) / logits.abs().amax(-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    keep = smp.sampling_mask(scaled, top_ks, top_ps)
    noise = tf.gumbel(tf.fold_in(tf.seed_key(seeds), counts), logits.shape[-1:])
    z = torch.topk(noise + torch.where(keep, scaled, -torch.inf), 2, dim=-1).values
    sampled = (z[:, 0] - z[:, 1]) / torch.where(keep, scaled.abs(), 0.0).amax(-1)
    return torch.where(temps > 0, sampled, greedy)


class _Margins:
    """The winning margin (``_draw_margins``) of the row behind each token a
    server emitted, ``margins[(rid, index)]``. Each program's logits and
    sampling arrays are kept on the card and read only for the tokens asked
    for, so recording costs the step no sampler work."""

    def __init__(self, torch):
        self.torch, self.programs, self.rows = torch, [], {}

    def __getitem__(self, key):
        i, row = self.rows[key]
        return _draw_margins(self.torch, *self.programs[i])[row].item()


def _record_margins(torch, srv):
    """Wraps ``srv``'s token pick and emission to fill a ``_Margins``.
    Returns (the margins, a function that unwraps)."""
    from repro_torch.runtime import sampling as smp

    margins = _Margins(torch)
    pick, emit = srv._pick, srv._emit_token

    def pick_(logits, samp=None):
        arrs = smp.slot_arrays(len(logits)) if samp is None else samp
        margins.programs.append((logits, {k: a.copy() for k, a in arrs.items()}))
        return pick(logits, samp)

    def emit_(req, token):
        n = len(margins.programs[-1][0])
        row = (0 if n == 1 else srv.slots if n == srv.slots + 1 and not req.out
               else next(s for s, r in enumerate(srv.active) if r is req))
        margins.rows[(req.rid, len(req.out))] = (len(margins.programs) - 1, row)
        emit(req, token)

    def unwrap():
        del srv._pick, srv._emit_token
    srv._pick, srv._emit_token = pick_, emit_
    return margins, unwrap


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
    want_gaps, _ = _record_margins(torch, full)
    _drain_audited(torch, full, _pressure_traffic(cfg))
    want = {r.rid: list(r.out) for r in full.finished}
    if full.stats["preemptions"] or not all(r.status == "ok" for r in full.finished):
        fail(f"pressure: the fully backed run stole or failed: {full.stats}")
    del full
    plan = serve.FaultPlan(**PRESSURE_FAULTS)
    srv = _default_server(torch, cfg, packed, pool_pages=PRESSURE_POOL, audit_every=1,
                          faults=plan, **knobs)
    gaps, _ = _record_margins(torch, srv)
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


# -- phase 13: sampled decoding and the front-end -----------------------------------
SAMPLING_BUDGET_S = 60
# the phase-6 requests that sample (the others stay greedy), each with a seed
# of its own and one of the mixes tests/test_torch_sampling.py holds against
# repro; on the tight pool rids 3 and 7 are stolen and resumed
SAMPLED = {1: dict(temperature=0.8, top_k=50, top_p=0.9, seed=2 ** 32 - 1),
           3: dict(temperature=1.0, seed=0),
           5: dict(temperature=0.7, top_p=0.5, seed=2 ** 31),
           7: dict(temperature=0.8, top_k=50, top_p=0.9, seed=12345)}
SAMPLER_MIXES = {"greedy": {}, "t0.8_k50_p0.9": dict(temperature=0.8, top_k=50, top_p=0.9),
                 "t1.0": dict(temperature=1.0), "t0.7_p0.5": dict(temperature=0.7, top_p=0.5)}
SAMPLER_KEYS = ((0, 0), (1, 5), (12345, 17), (2 ** 31, 33), (2 ** 32 - 1, 64))  # (seed, count)
SSE_TOKENS = 8
# the reproducibility runs' traffic (fully backed and on PRESSURE_POOL pages):
# phase 6's rids 4-7, 16 new tokens each. On the tight pool rid 7 (sampled)
# is stolen and resumed from its bytes, as rids 3 and 7 were with all 8
# requests of 32 tokens, in 46 steps instead of 158 (the schedule reads no
# logits: rehearsed on the CPU with random logits)
SAMPLING_REPRO_RIDS = (4, 5, 6, 7)
SAMPLING_REPRO_NEW = 16


def _sampled_requests(cfg, pressure=False, rids=None, max_new=None):
    """Phase 6's 8 requests (the same draws), those of SAMPLED sampling; with
    ``pressure`` phase 12's priorities and deadline, else none; ``rids`` and
    ``max_new`` cut the traffic."""
    from repro_torch.runtime import serve

    reqs = [r for r in _pressure_traffic(cfg) if rids is None or r.rid in rids]
    for r in reqs:
        if not pressure:
            r.priority, r.deadline_step = 0, None
        if r.rid in SAMPLED:
            r.sampling = serve.SamplingParams(**SAMPLED[r.rid])
        r.max_new = max_new or r.max_new
    return reqs


def _drain_all(torch, srv, reqs):
    """Submit ``reqs`` and drain; returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _within_one_tie(got, want, margins, what, skip=()):
    """At most one stream of ``got`` differs from ``want``, and at its first
    difference the row's margin (``margins`` of the run that reads it) is
    under GAP_TOL. Returns [(rid, index, margin)]."""
    diffs = []
    for rid in sorted(want):
        if rid in skip:
            continue
        a, b = got[rid], want[rid]
        if len(a) != len(b):
            fail(f"{what}: request {rid} emitted {len(a)} tokens, want {len(b)}")
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            diffs.append((rid, i, margins[(rid, i)]))
    if len(diffs) > 1 or any(m >= GAP_TOL for *_, m in diffs):
        fail(f"{what}: streams differ beyond one tie under {GAP_TOL}: {diffs}")
    return diffs


def _sampler_check(torch, logits):
    """One decode step's card logits (B, V), each row under every mix of
    SAMPLER_MIXES and every (seed, count) of SAMPLER_KEYS: the random bits
    and the Gumbel noise bit-identical on the card and on the CPU, the tokens
    identical; then the known answers on the card, and the sampler's time a
    call at B rows beside the argmax's (CUDA events). Returns the readings."""
    from repro_torch.runtime import sampling as smp
    from repro_torch.runtime import serve
    from repro_torch.runtime import threefry as tf

    b, vocab = logits.shape
    rows = [(r, mix, seed, count) for mix in SAMPLER_MIXES for seed, count in SAMPLER_KEYS
            for r in range(b)]
    arrs = smp.slot_arrays(len(rows))
    for i, (_, mix, seed, count) in enumerate(rows):
        smp.fill_slot(arrs, i, serve.SamplingParams(**SAMPLER_MIXES[mix], seed=seed), count)
    x = logits[torch.as_tensor([r for r, *_ in rows], device=logits.device)]
    out = {}
    for dev in (DEV, "cpu"):
        args = smp.as_tuple(arrs, dev)
        keys = tf.fold_in(tf.seed_key(args[3]), args[4])
        out[dev] = [smp.sample_tokens(x.to(dev), *args), tf.random_bits(keys, (vocab,)),
                    tf.gumbel(keys, (vocab,)).view(torch.int32)]
        out[dev] = [a.cpu() for a in out[dev]]
    for name, a, c in zip(("tokens", "random bits", "gumbel noise"), out[DEV], out["cpu"]):
        if not torch.equal(a, c):
            fail(f"sampler: {name} on the card differ from the CPU's in "
                 f"{int((a != c).sum())} of {a.numel()}")
    sampled = torch.as_tensor(arrs["temperature"] > 0)
    if bool((out["cpu"][0][sampled] == x.argmax(-1).cpu()[sampled]).all()):
        fail("sampler: every sampled row took its argmax")
    kat = [int(v) for v in tf.threefry2x32(*(torch.tensor(w, device=DEV) for w in (
        0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)))]
    fold = tf.fold_in(tf.seed_key(21, device=DEV), 5).tolist()
    if kat != [0xC4923A9C, 0x483DF7A0] or fold != [3621222503, 3534982896]:
        fail(f"sampler: known answers on the card: threefry {kat}, fold_in(PRNGKey(21), 5) {fold}")
    step = smp.slot_arrays(b)
    for i in range(b):
        smp.fill_slot(step, i, serve.SamplingParams(**list(SAMPLER_MIXES.values())[i % 4],
                                                    seed=i), 3)
    args = smp.as_tuple(step, DEV)
    ms = {}
    for name, fn in (("sample_tokens", lambda: smp.sample_tokens(logits, *args)),
                     ("argmax", lambda: smp.greedy_tokens(logits))):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 20
    return {"rows": len(rows), "vocab": vocab, "ms": ms}


def _sse(front, prompt, body):
    """One SSE request to ``serve_http`` on 127.0.0.1, port 0: the raw
    response."""
    import asyncio
    import json

    from repro_torch.runtime.frontend import serve_http

    async def post():
        http = await serve_http(front, host="127.0.0.1", port=0)
        port = http.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            data = json.dumps({"prompt": prompt, **body}).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
            await writer.drain()
            raw = (await reader.read()).decode()
            writer.close()
            return raw
        finally:
            http.close()
            await http.wait_closed()
    return post()


def _frontend(torch, srv, cfg):
    """The first wave of phase 6's requests (rids 1 and 3 sampled) through
    ``AsyncServer.generate``, 4 at once, on ``srv`` (its system prompt frozen
    and parked from the served mix), each streamed token equal to its
    ``RequestResult``; then one SSE request, rid 1's prompt and sampling for
    SSE_TOKENS tokens. Returns (results, SSE tokens)."""
    import asyncio
    import json

    from repro_torch.runtime.frontend import AsyncServer

    reqs = _sampled_requests(cfg)[:4]

    async def main():
        front = AsyncServer(srv)

        async def stream(r):
            toks = []
            async for ev in front.generate(r.prompt, max_new=r.max_new, sampling=r.sampling,
                                           rid=100 + r.rid):
                if not ev.finished:
                    toks.append(ev.token)
            return toks
        try:
            streams = await asyncio.gather(*[stream(r) for r in reqs])
            raw = await _sse(front, reqs[1].prompt,
                             {"max_tokens": SSE_TOKENS, "stream": True, **SAMPLED[1]})
        finally:
            await front.close()
        return streams, [front.result(100 + r.rid) for r in reqs], raw

    streams, results, raw = asyncio.run(main())
    for toks, res in zip(streams, results):
        if res is None or not res.ok or list(res.tokens) != toks or len(toks) != 32:
            fail(f"front-end: request {res and res.rid} streamed {toks}, its result {res}")
    chunks = [json.loads(ln[6:]) for ln in raw.splitlines() if ln.startswith("data: {")]
    sse = [c["choices"][0]["token"] for c in chunks if c["choices"][0].get("token") is not None]
    if not raw.startswith("HTTP/1.1 200") or "text/event-stream" not in raw or \
            len(sse) != SSE_TOKENS or chunks[-1]["choices"][0]["finish_reason"] != "stop" \
            or not raw.rstrip().endswith("data: [DONE]"):
        fail(f"front-end: the SSE response is not {SSE_TOKENS} token chunks and [DONE]: "
             f"{raw[:400]}")
    return results, sse


def phase_sampling(torch, cfg, packed, card, greedy_streams):
    """Sampled decoding on phase 6's server: the served mix (half the
    requests sampled) with phase 6's launch invariants and its greedy
    streams; the sampler teacher-forced on one of its decode steps' logits,
    card against CPU; a sampled stream solo and on a tight pool (stolen and
    resumed) against the served one; then the front-end."""
    from repro_torch.runtime import serve

    t0 = time.perf_counter()
    srv = _default_server(torch, cfg, packed)
    margins, unwrap = _record_margins(torch, srv)
    step_logits = {}
    run = srv._run

    def run_(tokens, state, pmask=None):  # keeps the first step where 4 rows decode
        logits = run(tokens, state, pmask)
        if "x" not in step_logits and state.prefill is None and \
                all(r is not None for r in srv.active):
            step_logits["x"] = logits.clone()
        return logits
    srv._run = run_
    reqs = _sampled_requests(cfg)
    _set_counts(dict.fromkeys(_counts(), 0))
    waves = [reqs[:4], reqs[4:]]
    wall = sum(_drain_all(torch, srv, wave) for wave in waves)
    launches = _counts()
    del srv._run
    unwrap()
    st, n_layers = dict(srv.stats), cfg.n_layers
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": 6 * n_layers * st["steps"],
            "paged_decode_attn_frozen": n_layers * st["steps"]}
    if launches != want or st["programs"] != st["steps"]:
        fail(f"sampling: kernel launches {launches}, want {want} ({st['steps']} steps)")
    mix = {r.rid: list(r.out) for r in srv.finished}
    if len(mix) != 8 or not all(r.status == "ok" for r in srv.finished):
        fail(f"sampling: not every request ended ok: {[(r.rid, r.status) for r in srv.finished]}")
    greedy = {rid: toks for rid, toks in greedy_streams.items() if rid not in SAMPLED}
    ties_greedy = _within_one_tie(mix, greedy, margins, "sampling: greedy streams vs phase 6")
    moved = [rid for rid in SAMPLED if mix[rid] != greedy_streams[rid]]
    if len(moved) < len(SAMPLED) // 2:
        fail(f"sampling: only requests {moved} of {sorted(SAMPLED)} left their greedy streams")
    t_mix = time.perf_counter() - t0

    if "x" not in step_logits:
        fail("sampling: no decode step had all 4 rows decoding")
    sampler = _sampler_check(torch, step_logits["x"])

    t1 = time.perf_counter()
    solo = _default_server(torch, cfg, packed, slots=1)
    solo_margins, _ = _record_margins(torch, solo)
    solo_reqs = _sampled_requests(cfg)[:2]
    solo_reqs[0].max_new = 1  # rid 0 only freezes the system prompt, as it does in the mix
    _drain_all(torch, solo, solo_reqs)
    ties_solo = _within_one_tie({1: list(solo_reqs[1].out)}, {1: mix[1]}, solo_margins,
                                "sampling: rid 1 solo vs batched")

    knobs = dict(frozen_pages=PRESSURE_FROZEN, scheduler=serve.SchedulerConfig(
        headroom_pages=0, steal_cooldown=2, spill_budget_bytes=PRESSURE_SPILL_BUDGET))
    repro = dict(pressure=True, rids=SAMPLING_REPRO_RIDS, max_new=SAMPLING_REPRO_NEW)
    full = _default_server(torch, cfg, packed, **knobs)
    full_margins, _ = _record_margins(torch, full)
    _drain_all(torch, full, _sampled_requests(cfg, **repro))
    if full.stats["preemptions"]:
        fail(f"sampling: the fully backed run stole: {full.stats}")
    tight = _default_server(torch, cfg, packed, pool_pages=PRESSURE_POOL, **knobs)
    tight_margins, _ = _record_margins(torch, tight)
    _drain_all(torch, tight, _sampled_requests(cfg, **repro))
    stolen = sorted(r.rid for r in tight.finished if r.preemptions and r.rid in SAMPLED)
    # a steal not answered by an eviction was resumed from its spilled bytes
    resumed = [r.rid for r in tight.finished if r.rid in SAMPLED and r.preemptions > r.evictions]
    if not resumed or not all(r.status == "ok" for r in tight.finished):
        fail(f"sampling: no sampled request was stolen and resumed on {PRESSURE_POOL} pages "
             f"({tight.stats}, statuses {[(r.rid, r.status) for r in tight.finished]})")
    got = {r.rid: list(r.out) for r in tight.finished}
    ref = {r.rid: list(r.out) for r in full.finished}
    diffs = _first_differences(got, ref, tight_margins, full_margins, ())
    if len(diffs) > 1 or any(m >= GAP_TOL for *_, m in diffs):
        fail(f"sampling: the tight pool's streams differ from the fully backed run beyond one "
             f"tie under {GAP_TOL}: {diffs}")
    t_repro = time.perf_counter() - t1

    t2 = time.perf_counter()
    results, sse = _frontend(torch, srv, cfg)
    t_front = time.perf_counter() - t2
    ttft = [r.ttft * 1e3 for r in results]
    itl = [g * 1e3 for r in results for g in r.itl]

    log(f"[13 sampling] opt-125m W4A8 on phase 6's server, rids {sorted(SAMPLED)} of its 8 "
        f"requests sampled ({SAMPLED}), on {card}:")
    log(f"    served mix: {st['steps']} steps, {wall:.2f} s wall; every "
        f"request ok; launches {({k: v for k, v in launches.items() if v})} = phase 6's "
        f"invariants; greedy streams vs phase 6's: {len(ties_greedy)} tie(s) {ties_greedy}; "
        f"sampled streams that left their greedy ones {moved} ({t_mix:.1f} s)")
    log(f"    sampler, teacher-forced on one decode step's card logits ({sampler['rows']} rows of "
        f"{sampler['vocab']}: 4 rows x {len(SAMPLER_MIXES)} mixes x {len(SAMPLER_KEYS)} (seed, "
        f"count)): random bits and Gumbel noise bit-identical card vs CPU, tokens identical; "
        f"threefry known answer and fold_in(PRNGKey(21), 5) on the card; sample_tokens "
        f"{sampler['ms']['sample_tokens']:.3f} ms a call at B=4 (argmax "
        f"{sampler['ms']['argmax']:.3f} ms; CUDA events over 20 calls)")
    log(f"    reproducibility: rid 1 solo (slots=1) vs batched {len(ties_solo)} tie(s) "
        f"{ties_solo}; rids {list(SAMPLING_REPRO_RIDS)} ({SAMPLING_REPRO_NEW} new tokens) on "
        f"{PRESSURE_POOL} active pages ({PRESSURE_FROZEN} frozen) "
        f"preemptions {tight.stats['preemptions']}, resumes {tight.stats['resumes']}, spill "
        f"evictions {tight.stats['spill_evictions']}, sampled requests stolen {stolen}, resumed "
        f"from their bytes {resumed}; streams "
        f"vs the fully backed run {len(diffs)} tie(s) {diffs} ({t_repro:.1f} s)")
    log(f"    front-end: AsyncServer.generate x4 at once (rids 1, 3 sampled), every streamed "
        f"token equal to its RequestResult; SSE on 127.0.0.1 {len(sse)} token chunks + [DONE] "
        f"(rid 1's first {SSE_TOKENS}: {'equal' if sse == mix[1][:SSE_TOKENS] else 'differ'}); "
        f"median TTFT {statistics.median(ttft):.2f} ms, median ITL {statistics.median(itl):.2f} "
        f"ms over {len(itl)} gaps, on {card} ({t_front:.1f} s)")


# -- phase 14: post-training quantization (GPTQ) -------------------------------------
PTQ_BUDGET_S = 60
# 4 batches of 8 x 2048 tokens: 65,536, a quarter of the paper's calibration
# set (128 x 2048, QuantPolicy.calib_tokens), cut to fit the time limit
PTQ_CALIB = dict(n_batches=4, batch=8, seq=2048)
PTQ_EVAL_SEED = 1777  # the held-out batches' seed (not the calibration's)
PTQ_AGREEMENT = 0.999  # card against CPU: shifts of groups, codes of elements
PTQ_FAULT = 10.0  # the injected fault must read this many tolerances


def _ptq_policy():
    """The paper's headline W4A8 scheme (PRESETS["deploy_w4a8"] with its
    damp spelled out): FP4 E2M1 weights by GPTQ, group 256, M2, LoRC 8,
    FP8 E4M3 activations."""
    from repro_torch.core.policy import QuantPolicy

    return QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256, scale_mode="m2",
                       lorc_rank=8, method="gptq", damp=0.01)


def _hessian_err(w, w_hat, h):
    """tr(dW H dW^T), the layer-output error GPTQ minimizes, in f64."""
    dw = w.double() - w_hat.double()
    return float(((dw @ h.double()) * dw).sum())


def _excess(y, want):
    """The largest |y - want| over W4A8_TOL * (1 + |want|): at most 1 where
    ``allclose(rtol=atol=W4A8_TOL)`` holds."""
    y, want = y.float(), want.float()
    return float(((y - want).abs() / (W4A8_TOL * (1 + want.abs()))).max())


def _rtn_dense(params, policy):
    """``params`` with every Fig.-1 weight round-to-nearest under
    ``policy`` (its M2 scales and LoRC), dense in its own dtype."""
    from repro_torch.core.ptq import _FIG1_WEIGHTS, _leaf, quantize_one
    from repro_torch.models.params import tree_map

    rtn = dataclasses.replace(policy, method="rtn")
    stack = tree_map(lambda a: a.clone(), params["segments"][0])
    for keys, _ in _FIG1_WEIGHTS:
        leaf = _leaf(stack, keys)
        for li in range(leaf.shape[0]):
            leaf[li] = quantize_one(leaf[li], None, rtn)[0]
    return {**params, "segments": [stack]}


def _perplexity(params, cfg, batches, a_fmt="fp8_e4m3"):
    """exp of the mean nll over ``batches``: forward_hidden at ``a_fmt``
    activations (FP8 E4M3 by default), then chunked_xent against the tied
    head; values only (no gradient)."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.losses import chunked_xent

    nll = []
    with torch.no_grad():
        for b in batches:
            hidden = api.forward_hidden(params, cfg, b, a_fmt=a_fmt)[0]
            nll.append(float(chunked_xent(hidden, api._head_w(params, cfg),
                                          b["labels"].to(hidden.device))[0]))
    return math.exp(sum(nll) / len(nll))


def _ptq_card_vs_cpu(torch, w, hessian, qt, policy, what):
    """One weight's GPTQ again on the CPU from the card's float weight and
    Hessian: M2's s_max bit-identical, shifts and codes equal on at least
    PTQ_AGREEMENT of the groups and elements (cuSOLVER's factor against
    LAPACK's). Returns (shift rate, code rate)."""
    from repro_torch.core.gptq import HessianState
    from repro_torch.core.ptq import quantize_one
    from repro_torch.core.scales import constrain_scales_m2

    _, qc = quantize_one(w.cpu(), HessianState(hessian.h.cpu(), hessian.n.cpu()), policy)
    m2, m2c = constrain_scales_m2(qt.scale.cpu()), constrain_scales_m2(qc.scale)
    if not torch.equal(m2.s_max, m2c.s_max):
        fail(f"{what}: M2 s_max differs card against CPU in "
             f"{int((m2.s_max != m2c.s_max).sum())} rows")
    shifts = float((m2.shifts == m2c.shifts).float().mean())
    codes = float((qt.values.cpu() == qc.values).float().mean())
    if shifts < PTQ_AGREEMENT or codes < PTQ_AGREEMENT:
        fail(f"{what}: card against CPU, shifts equal on {shifts:.6f} of groups, codes on "
             f"{codes:.6f} of elements < {PTQ_AGREEMENT}")
    return shifts, codes


def _doubled_top_group(torch, p, x):
    """``p`` with the scale of the group contributing most to ``x @ W^T``
    doubled (its M2 shift one less; only groups with a shift to spare)."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers import quant_act

    m, g = x.shape[0], p.group_size
    w = ref.dequant_packed_ref(p.codes, p.scale, p.w_fmt, g).float()
    contrib = torch.einsum("mgk,ngk->mng", quant_act(x, p.a_fmt).float().reshape(m, -1, g),
                           w.reshape(w.shape[0], -1, g)).abs().amax(0)
    contrib = torch.where(p.shifts >= 1, contrib, torch.zeros_like(contrib))
    n, grp = divmod(int(contrib.argmax()), contrib.shape[1])
    scale, shifts = p.scale.clone(), p.shifts.clone()
    scale[n, grp] *= 2
    shifts[n, grp] -= 1
    return dataclasses.replace(p, scale=scale, shifts=shifts)


def _ptq_packed_check(torch, w, qt, w_hat, policy, gen, what):
    """A GPTQ result packed (``pack_linear(w, policy, qt=qt)``) through row
    1's kernel at M = 4 and 256: within W4A8_TOL of its plain version and of
    the GPTQ dense result (FP8 activations times the pipeline's weight, LoRC
    included); the group contributing most to the output, its packed scale
    doubled (a shift one less), must read PTQ_FAULT tolerances or more.
    Returns {M: (kernel vs plain, vs dense, fault vs dense)} in tolerances."""
    from repro_torch.core.ptq import pack_linear
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import quant_act

    p = pack_linear(w, policy, qt=qt)
    out = {}
    for m in (4, 256):
        x = torch.randn((m, w.shape[1]), generator=gen, device=DEV).to(torch.bfloat16)
        xq = quant_act(x, policy.a_fmt).float()
        y_k = ops.w4a8_matmul(x, p)
        y_p = ref.w4a8_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, w_fmt=p.w_fmt,
                                  a_fmt=p.a_fmt, group_size=p.group_size)
        y_d = xq @ w_hat.float().t()
        y_f = ops.w4a8_matmul(x, _doubled_top_group(torch, p, x))
        out[m] = (_excess(y_k, y_p), _excess(y_k, y_d), _excess(y_f, y_d))
        if out[m][0] > 1 or out[m][1] > 1:
            fail(f"{what} M={m}: row 1's kernel on the packed GPTQ weight reads "
                 f"{out[m][0]:.3g} / {out[m][1]:.3g} tolerances against its plain version / the "
                 f"GPTQ dense result (W4A8_TOL {W4A8_TOL})")
        if out[m][2] < PTQ_FAULT:
            fail(f"{what} M={m}: the doubled group scale reads {out[m][2]:.3g} < {PTQ_FAULT} "
                 f"tolerances: the comparison cannot tell it from the sound packing")
    return out


def phase_ptq(torch, card, cfg=None, calib=PTQ_CALIB):
    """The paper's PTQ pipeline on opt-125m at full width (random weights
    from SEED on the card): the calibration stream, GPTQ over every layer
    (captures through the quantized prefix, error-fed FP4 rounding under M2
    scales, LoRC), each weight's Hessian-weighted error against RTN's on the
    same Hessian, layer 0's wq and down again on the CPU, those two packed
    through row 1's kernel, and perplexity of W16 / RTN / GPTQ (printed)."""
    from repro_torch.core.ptq import _rtn, gptq_quantize_lm
    from repro_torch.data.pipeline import calibration_stream
    from repro_torch.models import api

    if cfg is None:
        from repro_torch.configs.opt_125m import CONFIG as cfg
    policy = _ptq_policy()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=SEED, device=DEV)
    batches = calibration_stream(cfg, **calib)
    held_out = calibration_stream(cfg, 2, calib["batch"], calib["seq"], seed=PTQ_EVAL_SEED)
    t_data = time.perf_counter() - t0
    seen, stamps = [], {}

    def observe(layer, name, w, hessian, qt):
        torch.cuda.synchronize()
        stamps[layer] = time.perf_counter()
        seen.append((layer, name, w, hessian, qt))

    torch.cuda.synchronize()
    start = time.perf_counter()
    quantized = gptq_quantize_lm(params, cfg, batches, policy, observe=observe)
    torch.cuda.synchronize()
    t_gptq = time.perf_counter() - start
    per_layer = [stamps[li] - (stamps[li - 1] if li else start) for li in range(cfg.n_layers)]
    n_tok = sum(b["tokens"].numel() for b in batches)
    log(f"[14 ptq] opt-125m at full width ({cfg.n_layers} layers, {len(seen)} weights), random "
        f"weights from seed {SEED}; calibration_stream {calib['n_batches']} x {calib['batch']} x "
        f"{calib['seq']} = {n_tok} tokens; GPTQ fp4_e2m1, group {policy.group_size}, M2, LoRC "
        f"{policy.lorc_rank}, damp {policy.damp}")
    log(f"    GPTQ over the model {t_gptq:.2f} s on {card}: per layer (captures, 6 weights, "
        f"propagation) " + ", ".join(f"{s:.2f}" for s in per_layer) + " s; data "
        f"{t_data:.2f} s (numpy)")

    # b. the Hessian-weighted error tr(dW H dW^T), GPTQ (before LoRC) against RTN
    rows, keep = [], {}
    for layer, name, w, hessian, qt in seen:
        e_g = _hessian_err(w.float(), qt.dequantize(), hessian.h)
        e_r = _hessian_err(w.float(), _rtn(w.float(), policy, qt.group_size).dequantize(),
                           hessian.h)
        rows.append((layer, name, e_g, e_r))
        if layer == 0 and name in ("mixer/attn/wq", "ffn/mlp/down"):
            keep[name] = (w, hessian, qt)
    for layer in range(cfg.n_layers):
        mine = [r for r in rows if r[0] == layer]
        g, r = sum(x[2] for x in mine), sum(x[3] for x in mine)
        log(f"    layer {layer:2d}: tr(dW H dW^T) GPTQ / RTN " + ", ".join(
            f"{n.split('/')[-1]} {e_g:.4g}/{e_r:.4g}" for _, n, e_g, e_r in mine)
            + f"; sum {g:.4g} / {r:.4g} ({g / r:.3f})")
        if not g <= r:
            fail(f"layer {layer}: GPTQ's Hessian-weighted error {g:.6g} > RTN's {r:.6g}")
    g, r = sum(x[2] for x in rows), sum(x[3] for x in rows)
    log(f"    model: GPTQ {g:.6g} / RTN {r:.6g} = {g / r:.4f}")
    if not g < r:
        fail(f"GPTQ's Hessian-weighted error over the model {g:.6g} is not below RTN's {r:.6g}")

    # c. card against CPU; d. the packed form through row 1's kernel
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 14)
    stack = quantized["segments"][0]
    dense = {"mixer/attn/wq": stack["mixer"]["attn"]["wq"][0],
             "ffn/mlp/down": stack["ffn"]["mlp"]["down"][0]}
    for name, (w, hessian, qt) in keep.items():
        what = f"layer 0 {name} ({w.shape[0]} x {w.shape[1]})"
        shifts, codes = _ptq_card_vs_cpu(torch, w, hessian, qt, policy, what)
        checks = _ptq_packed_check(torch, w, qt, dense[name], policy, gen, what)
        log(f"    {what}: card against CPU s_max bit-identical, shifts equal on {shifts:.6f} "
            f"of groups, codes on {codes:.6f} of elements; packed through row 1's kernel, in "
            f"tolerances (W4A8_TOL {W4A8_TOL}) vs plain / vs GPTQ dense / doubled-scale fault "
            "vs dense: " + "; ".join(f"M={m} {a:.3g} / {b:.3g} / {c:.3g}"
                                     for m, (a, b, c) in checks.items()))
    del seen, keep

    # e. perplexity on held-out batches, printed (random weights: not gated)
    t_ppl = time.perf_counter()
    ppl = {"W16": _perplexity(params, cfg, held_out),
           "RTN W4A8": _perplexity(_rtn_dense(params, policy), cfg, held_out),
           "GPTQ W4A8": _perplexity(quantized, cfg, held_out)}
    log(f"    perplexity, 2 held-out batches (seed {PTQ_EVAL_SEED}), FP8 E4M3 activations: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ppl.items())
        + f" ({time.perf_counter() - t_ppl:.1f} s; random weights, printed, not gated)")
    return t_gptq, per_layer, g / r, ppl


# -- phase 15: the dense and VLM GQA configs ------------------------------------------
DENSE_CONFIGS = ("olmo-1b", "minitron-8b", "llava-next-34b", "nemotron-4-340b")
# nemotron-4-340b takes most of it (54.6 s alone on an H100 80GB HBM3 at
# 700 W): its pack's LoRC eigendecompositions at width 18432 (5.4 s each,
# four a layer: wq, wo, up, down); the three others took 8.9 s
DENSE_BUDGET_S = 120
DENSE_FAULT = 10.0  # the doubled group scale must read this many W4A8_TOL excesses
# One group is 1/G of a row's sum, so the doubled-scale fault weakens as K
# grows: at nemotron-4-340b's wd (K = 73728, 288 groups) it read 12.4 and 9.2
# excesses in two calls (PERF.md), on the threshold. Above this K the wd
# check gates only its sound reading, and the fault is gated on layer 0's up.
DENSE_FAULT_MAX_K = 32768


def _gemms_a_block(cfg):
    """Row-1 launches of one GQA + MLP block: q, k, v, o and the MLP's
    up and down, with gate for a gated MLP."""
    return 4 + (3 if cfg.mlp_gated else 2)


def _group_scale_fault(torch, p, gen, what, gate_fault=True):
    """Row 1 on a packed weight at a decode step's M = 4 within W4A8_TOL of
    its plain version; the group contributing most to the output, its
    scale doubled (a shift one less), must read DENSE_FAULT excesses or
    more against the sound plain version (unless ``gate_fault`` is off:
    then it is only read). Launches not counted. Returns (sound excess,
    fault excess)."""
    from repro_torch.kernels import ops, ref

    saved = _counts()
    x = torch.randn((4, p.codes.shape[1] * 2), generator=gen, device=DEV).to(torch.bfloat16)
    y_k = ops.w4a8_matmul(x, p)
    y_p = ref.w4a8_matmul_ref(x, p.codes, p.scale, p.lorc_a, p.lorc_b, w_fmt=p.w_fmt,
                              a_fmt=p.a_fmt, group_size=p.group_size)
    y_f = ops.w4a8_matmul(x, _doubled_top_group(torch, p, x))
    torch.cuda.synchronize()
    _set_counts(saved)
    sound, fault = _excess(y_k, y_p), _excess(y_f, y_p)
    if sound > 1:
        fail(f"{what}: row 1 reads {sound:.3g} W4A8_TOL excesses against its plain version")
    if gate_fault and fault < DENSE_FAULT:
        fail(f"{what}: the doubled group scale reads {fault:.3g} < {DENSE_FAULT} excesses: the "
             "comparison cannot tell it from the sound weight")
    return sound, fault


def phase_dense(torch, card):
    """olmo-1b, minitron-8b, llava-next-34b (text-only) and nemotron-4-340b
    at their published widths, cut to 2 layers, random weights from SEED initialized and packed
    on the card, each on the reference Server's defaults: 2 requests (one
    prefill chunk, 4 decode steps) with every route's launches equal to the
    invariant; the blocks teacher-forced at one decode step against the
    plain versions on the card; one group scale of layer 0's wd doubled
    (above DENSE_FAULT_MAX_K, of layer 0's up).
    Returns {config: its serving run's launches}."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    # nemotron-4-340b peaks at ~75 of the card's 79 GiB (its pack, then the
    # plain route's 5 GiB decode of the 73728 x 18432 weight): expandable
    # segments keep the allocator's free blocks from fragmenting that
    # headroom (a run met 9.6 GiB reserved but unallocated, and ran out).
    # The setting is the process's: restored however the phase ends
    set_alloc = getattr(torch._C, "_accelerator_setAllocatorSettings", None) or \
        torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    log(f"[15 dense] on entry: {_mem(torch)}")
    set_alloc("expandable_segments:True")
    try:
        return _dense_configs(torch, card, gen)
    finally:
        torch.cuda.empty_cache()
        set_alloc("expandable_segments:False")


def _dense_configs(torch, card, gen):
    """Phase 15's configurations in turn (see phase_dense)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_view
    from repro_torch.runtime import serve

    out = {}
    for name in DENSE_CONFIGS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, packed, t_pack = _random_packed(torch, name, n_layers=2)
        srv = _default_server(torch, cfg, packed)
        rng = np.random.default_rng(SEED + 15)
        reqs = [serve.Request(rid=i, max_new=5, prompt=rng.integers(2, cfg.vocab_size, n).tolist())
                for i, n in enumerate((200, 90))]
        _set_counts(dict.fromkeys(_counts(), 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        results = srv.run_until_drained()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t1
        launches = _counts()
        st, n_layers, per = srv.stats, cfg.n_layers, _gemms_a_block(cfg)
        # the mixed engine runs one program a step (the decode rows plus at
        # most one prefill chunk): per layer the block's GEMMs, and one decode
        # attention launch, the frozen variant (the pool has a frozen region)
        want = {**dict.fromkeys(launches, 0), "w4a8_fused": per * n_layers * st["steps"],
                "paged_decode_attn_frozen": n_layers * st["steps"]}
        if len(results) != 2 or not all(r.ok for r in results):
            fail(f"{name}: not every request ended ok: {[(r.rid, r.status) for r in results]}")
        if launches != want or st["programs"] != st["steps"] or st["decoded_tokens"] != 8:
            fail(f"{name}: kernel launches {launches}, want {want} ({st['steps']} steps, "
                 f"{st['programs']} programs, {st['decoded_tokens']} decoded tokens)")
        routes = {k: v for k, v in _routes(torch, packed, cpu=False).items()
                  if k in ("card", "card_plain")}
        forced, agree = _compare(torch, cfg, routes, forced=True, n_dec=1, ref="card_plain")
        if forced["card"]["block"] > BLOCK_RTOL:
            fail(f"{name}: the blocks differ from the plain versions on the card by "
                 f"{forced['card']['block']:.4g} of their update > {BLOCK_RTOL}")
        mlp0 = layer_view(packed["segments"][0], 0)["ffn"]["mlp"]
        wd = mlp0["down"]
        wide = wd.codes.shape[1] * 2 > DENSE_FAULT_MAX_K
        sound, fault = _group_scale_fault(torch, wd, gen, f"{name} layer 0 wd",
                                          gate_fault=not wide)
        up_line = ""
        if wide:
            up = mlp0["up"]
            s_up, f_up = _group_scale_fault(torch, up, gen, f"{name} layer 0 up")
            up_line = (f"; K above {DENSE_FAULT_MAX_K}: wd's fault read only, layer 0 up "
                       f"({up.codes.shape[1] * 2} -> {up.codes.shape[0]}) {s_up:.3g} excesses, "
                       f"its doubled group {f_up:.3g} (>= {DENSE_FAULT})")
        out[name] = launches
        log(f"[15 dense] {name} ({cfg.family}; d_model {cfg.d_model}, {cfg.n_heads} heads of "
            f"{cfg.resolved_head_dim}, KV {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}; {cfg.n_layers} of {get_config(name).n_layers} layers"
            f"{', text-only' if cfg.frontend == 'vision_patches' else ''}): random init + W4A8 "
            f"pack on the card {t_pack:.1f} s, {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"peak; 2 requests ok ({st['steps']} mixed-engine steps, {t_serve:.2f} s), "
            f"launches {({k: v for k, v in launches.items() if v})} = invariant {per} x "
            f"{n_layers} x {st['steps']} GEMMs and {n_layers} x {st['steps']} frozen decode "
            f"attention; teacher-forced blocks vs the plain versions on the card "
            f"{forced['card']['block']:.4g} (<= {BLOCK_RTOL}), greedy tokens agree "
            f"{agree[0]}/{agree[2]}; layer 0 wd ({wd.codes.shape[1] * 2} -> {wd.codes.shape[0]}, "
            f"group {wd.group_size}) at M=4 {sound:.3g} W4A8_TOL excesses, one group scale "
            f"doubled {fault:.3g} ({'read' if wide else f'>= {DENSE_FAULT}'}){up_line}; "
            f"{time.perf_counter() - t0:.1f} s on {card}")
        del packed, srv, routes, wd, mlp0
    return out


# -- phase 16: Whisper enc-dec --------------------------------------------------------
ENCDEC_BUDGET_S = 60
WHISPER_FRAME_SEEDS = (160, 161, 162, 163)  # frame sets A, B, C, D


def _whisper_traffic(cfg):
    """8 requests over 4 frame sets (30 s clips, normal(1500, 384) from
    numpy seeds): each prompt 3 task tokens plus 0-200 tokens of
    previous-segment text, 32 new tokens. rids 0 and 1 share frames A and a
    128-token prompt; rid 2 has that prompt under frames B."""
    import numpy as np

    from repro_torch.runtime import serve

    rng = np.random.default_rng(SEED + 16)
    frames = [np.random.default_rng(s).normal(size=(cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) for s in WHISPER_FRAME_SEEDS]
    task = rng.integers(2, cfg.vocab_size, 3).tolist()
    shared = task + rng.integers(2, cfg.vocab_size, 125).tolist()
    prompts = [shared, shared, shared] + [
        task + rng.integers(2, cfg.vocab_size, int(n)).tolist() for n in rng.integers(0, 201, 5)]
    sets = [0, 0, 1, 2, 3, 1, 2, 3]
    return frames, [serve.Request(rid=i, prompt=p, max_new=32, frames=frames[sets[i]])
                    for i, p in enumerate(prompts)]


def _live_cross_check(torch, srv, gen):
    """Row 2 on every layer of the live cross pool, at a step where every
    slot decodes: the kernel and its plain version over the rows' cross
    tables at their encoder lengths agree to ATTN_TOL (a second launch
    bit-identical) on a random q scaled to the layer's K, and on a q along
    each row's last encoder key (its score ~6 above the rest: ~0.2 of the
    weight); on that q the same call with ``enc_lengths`` one short must
    read at least 10x above ATTN_TOL. Launches not counted. Returns
    (largest error, smallest fault reading)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import paged_decode_attn_cuda
    from repro_torch.runtime import kv_cache as kvc

    saved = _counts()
    rows = [s for s, r in enumerate(srv.active) if r is not None]
    table = torch.as_tensor(srv.cross_table[rows]).to(DEV)
    lens = torch.as_tensor(srv.enc_lengths[rows]).to(DEV)
    err, fault = 0.0, math.inf
    pool = srv.cross_pool
    for i in range(pool["k"].shape[0]):
        layer = {name: leaf[i] for name, leaf in pool.items()}
        keys = kvc.gather_pages(layer, "k", kvc.PagedState(table, lens))  # (B, T, KV, hd)
        k_rms = max(float(keys.pow(2).mean().sqrt()), 1e-6)
        hd, g = srv.cfg.resolved_head_dim, srv.cfg.n_heads // srv.cfg.n_kv_heads
        last = keys[torch.arange(len(rows), device=DEV), lens.long() - 1]  # (B, KV, hd)
        q_rand = torch.randn((len(rows), srv.cfg.n_heads, hd), generator=gen, device=DEV) * (
            2.0 / k_rms)
        q_last = last.repeat_interleave(g, dim=1) * (6.0 / (math.sqrt(hd) * k_rms ** 2))
        sc = (layer["k_smax"], layer["k_shift"], layer["v_smax"], layer["v_shift"])
        for q in (q_rand.to(torch.bfloat16), q_last.to(torch.bfloat16)):
            kernel = lambda n: paged_decode_attn_cuda(q, layer["k"], layer["v"], *sc, table, n,
                                                      fmt="fp8_e4m3")
            o_p = ref.paged_decode_attn_ref(q, layer["k"], layer["v"], *sc, table, lens,
                                            fmt="fp8_e4m3")
            o_k = kernel(lens)
            _deterministic(torch, lambda: kernel(lens), o_k, "live cross pool: row 2")
            err = max(err, float((o_k - o_p).abs().max()))
        fault = min(fault, float((kernel(lens - 1) - o_p).abs().max()))
    torch.cuda.synchronize()
    _set_counts(saved)
    if err > ATTN_TOL:
        fail(f"live cross pool: row 2 differs from its plain version by {err:.3g} > {ATTN_TOL}")
    if fault < 10 * ATTN_TOL:
        fail(f"live cross pool: the injected fault (enc_lengths - 1) reads {fault:.3g} < 10 x "
             f"{ATTN_TOL}")
    return err, fault


def _watch_admissions(torch, srv):
    """Wraps the admission step (``api.encode_cross_pages``, called by
    ``srv``) and ``srv._alloc_cross``: each admission's encoder time (the
    device synchronized around it), its row-1 launches and their M, and
    the cross pages each admission charged; and each request's pages after
    its prefill. Returns (the record, a function that unwraps)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api

    seen = {"encode_ms": [], "gemms": [], "ms": [], "cross": [], "pages": {}}
    encode, gemm, alloc, prefill = (api.encode_cross_pages, ops.w4a8_matmul, srv._alloc_cross,
                                    srv._prefill_slot)

    def encode_(*args, **kw):
        rows = []

        def gemm_(x, w):
            rows.append(x.numel() // x.shape[-1])
            return gemm(x, w)
        ops.w4a8_matmul = gemm_
        before = _counts()["w4a8_fused"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        seen["encode_ms"].append((time.perf_counter() - t0) * 1e3)
        ops.w4a8_matmul = gemm
        seen["gemms"].append(_counts()["w4a8_fused"] - before)
        seen["ms"].append(sorted(set(rows)))
        return out

    def alloc_(slot):
        ids = alloc(slot)
        seen["cross"].append(len(ids))
        return ids

    def prefill_(slot, req):
        prefill(slot, req)
        seen["pages"].setdefault(req.rid, list(srv.slot_pages[slot]))

    api.encode_cross_pages, srv._alloc_cross, srv._prefill_slot = encode_, alloc_, prefill_

    def unwrap():
        api.encode_cross_pages = encode
        del srv._alloc_cross, srv._prefill_slot
    return seen, unwrap


def phase_encdec(torch, card):
    """Whisper-tiny at its published config (nothing cut), random weights
    from SEED packed on the card, on the reference Server's defaults (which
    fall back to the alternating engine): 8 requests over 4 frame sets with
    its prefix, admission, launch, live-pool and cold-run gates; then 2
    requests against the CPU plain path, teacher-forced at each decoder
    block and its cross-attention, with two injected faults. Returns
    (launches, the live cross check's (error, fault reading))."""
    import numpy as np

    from repro_torch.runtime import serve

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, packed, t_pack = _random_packed(torch, "whisper-tiny")
    srv = _default_server(torch, cfg, packed, engine="alternating")
    cpp = srv._cross_pp
    if cpp != 24:
        fail(f"encdec: {cfg.encoder_seq} frames take {cpp} cross pages of 64, want 24")
    frames, reqs = _whisper_traffic(cfg)
    margins, unmargin = _record_margins(torch, srv)
    seen, unwatch = _watch_admissions(torch, srv)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    live, step_ms = None, []
    run = srv._run

    def run_(tokens, state, pmask=None):  # the live check at the first step all 4 rows decode
        nonlocal live
        if live is None and state.chunk_len is None and all(r is not None for r in srv.active):
            live = _live_cross_check(torch, srv, gen)
        return run(tokens, state, pmask)
    srv._run = run_
    _set_counts(dict.fromkeys(_counts(), 0))
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while True:
        programs = srv.stats["programs"]
        s0 = time.perf_counter()
        if not srv.step():
            if srv.queue:
                fail("encdec: serving starved")
            break
        torch.cuda.synchronize()
        if srv.stats["programs"] == programs + 1:  # a step that only decoded
            step_ms.append((time.perf_counter() - s0) * 1e3)
    wall = time.perf_counter() - t1
    launches = _counts()
    del srv._run
    unwatch()
    unmargin()
    results = {r.rid: r.result() for r in srv.finished}
    if len(results) != 8 or not all(r.ok for r in results.values()):
        fail(f"encdec: not every request ended ok: {[(r.rid, r.status) for r in srv.finished]}")
    if live is None:
        fail("encdec: no decode step had all 4 rows decoding: live cross check not run")
    st, n_layers, n_enc = dict(srv.stats), cfg.n_layers, cfg.encoder_layers
    admissions = len(seen["encode_ms"])
    chunks = st["programs"] - st["steps"] - admissions
    # an admission runs the encoder (q, k, v, o, up, down a layer) and the
    # decoder layers' cross K/V projections (k, v), all at M = encoder_seq;
    # a decoder program (a prefill chunk or a decode step) q, k, v, o of the
    # self-attention, q and o of the cross-attention and up and down a
    # layer; a decode step one self-attention launch a layer (the frozen
    # variant: the pool has a frozen region) and one cross launch (row 2
    # over the cross pages at kv_len = enc_lengths)
    per_enc, per_dec = 6 * n_enc + 2 * n_layers, 8 * n_layers
    want = {**dict.fromkeys(launches, 0),
            "w4a8_fused": per_enc * admissions + per_dec * (st["steps"] + chunks),
            "paged_decode_attn": n_layers * st["steps"],
            "paged_decode_attn_frozen": n_layers * st["steps"]}
    if launches != want:
        fail(f"encdec: kernel launches {launches}, want {want} ({admissions} admissions, "
             f"{chunks} prefill chunks, {st['steps']} decode steps)")
    if seen["cross"] != [cpp] * admissions or admissions != 8:
        fail(f"encdec: cross pages charged per admission {seen['cross']}, want {cpp} x 8")
    if seen["gemms"] != [per_enc] * admissions or any(m != [cfg.encoder_seq] for m in seen["ms"]):
        fail(f"encdec: an admission launched {seen['gemms']} GEMMs at M {seen['ms']}, want "
             f"{per_enc} at M = {cfg.encoder_seq}")
    pages = seen["pages"]
    if pages[1][0] != pages[0][0] or set(pages[2]) & (set(pages[0]) | set(pages[1])):
        fail(f"encdec: rid 1 must map rid 0's first page under frames A's root and rid 2 share "
             f"none (pages {pages[0]}, {pages[1]}, {pages[2]})")
    # rid 2's stream against a cold run of it alone under frames B
    cold = _default_server(torch, cfg, packed, engine="alternating")
    cold_req = serve.Request(rid=2, prompt=list(reqs[2].prompt), max_new=32, frames=frames[1])
    cold.submit(cold_req)
    cold.run_until_drained()
    ties = _within_one_tie({2: list(results[2].tokens)}, {2: list(cold_req.out)}, margins,
                           "encdec: rid 2 vs its cold run under frames B")
    # the profiled decode step: 4 fresh requests under frames C and D
    rng = np.random.default_rng(SEED + 17)
    for i in range(srv.slots):
        srv.submit(serve.Request(rid=100 + i, prompt=rng.integers(2, cfg.vocab_size, 60).tolist(),
                                 max_new=6, frames=frames[2 + i % 2]))
    srv.step()
    busy = _profiled(torch, srv, 3, "4 rows, 60-token prompts over 24 cross pages each")
    t_serve = time.perf_counter() - t0

    # against the CPU plain path, teacher-forced; two faults through the kernels
    t2 = time.perf_counter()

    def double_smax(pool):  # the first cross page of each request, K and V, every layer
        for name in ("k_smax", "v_smax"):
            pool[name][:, [0, cpp]] *= 2
    skip_last = dataclasses.replace(cfg, encoder_layers=cfg.encoder_layers - 1)
    routes = {k: v for k, v in _routes(torch, packed).items() if k in ("card", "cpu")}
    routes["smax"] = routes["skip_enc"] = (packed, DEV, {})
    encoders = {"smax": (cfg, double_smax), "skip_enc": (skip_last, None)}
    forced, agree = _compare(torch, cfg, routes, forced=True, n_dec=2,
                             frames=frames[:2], encoders=encoders)
    rd = lambda name, key: forced[name].get(key, 0.0)
    for key in ("block", "cross"):
        if rd("card", key) > BLOCK_RTOL:
            fail(f"encdec: the card's {key} outputs differ from the CPU plain path by "
                 f"{rd('card', key):.4g} of their update > {BLOCK_RTOL}")
    for name in ("smax", "skip_enc"):
        if rd(name, "cross") <= BLOCK_RTOL:
            fail(f"encdec: injected fault {name} reads {rd(name, 'cross'):.4g} <= {BLOCK_RTOL} at "
                 "the cross-attention: the comparison cannot tell it from the sound path")
    t_cpu = time.perf_counter() - t2
    n_tok = sum(len(r.tokens) for r in results.values())
    enc = seen["encode_ms"]
    log(f"[16 encdec] whisper-tiny (published config: {n_enc} + {n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"encoder_seq {cfg.encoder_seq}, vocab {cfg.vocab_size}): random init + W4A8 pack on the "
        f"card {t_pack:.1f} s; reference Server defaults -> engine {srv.engine}, {srv.slots} "
        f"slots, pages of {srv.page_size}, {cpp} cross pages a request, on {card}:")
    log(f"    8 requests over 4 frame sets ok: {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tokens/s; {st['steps']} decode steps, median {statistics.median(step_ms):.2f} "
        f"ms over {len(step_ms)}; encoder at admission {statistics.median(enc):.2f} ms median "
        f"({min(enc):.2f}-{max(enc):.2f}) over {admissions}, each {per_enc} GEMMs at M = "
        f"{cfg.encoder_seq} and {cpp} cross pages charged")
    log(f"    launches {({k: v for k, v in launches.items() if v})} = invariant: {per_enc} x "
        f"{admissions} admissions + {per_dec} x ({st['steps']} steps + {chunks} chunks) GEMMs, "
        f"{n_layers} x {st['steps']} self (frozen variant) + {n_layers} x {st['steps']} cross "
        f"decode launches; prefix_hit_pages {st['prefix_hit_pages']} (rid 1 on rid 0's under "
        f"frames A; rid 2 none), fp4_frozen_pages {st['fp4_frozen_pages']}; rid 2 vs its cold "
        f"run under frames B: {len(ties)} tie(s) {ties}")
    log(f"    live cross pool, {n_layers} layers: row 2 vs plain max|err| {live[0]:.3g} "
        f"(tolerance {ATTN_TOL}); injected fault enc_lengths - 1 reads {live[1]:.3g} "
        f"(>= {10 * ATTN_TOL} required)")
    log(busy)
    log(f"    against the CPU plain path (2 requests under frames A and B: a prefill chunk and 2 "
        f"decode steps), teacher-forced, largest |err| / |update| (tolerance {BLOCK_RTOL}): "
        f"card blocks {rd('card', 'block'):.4g}, cross-attention {rd('card', 'cross'):.4g}; "
        f"faults at the cross-attention: one cross page's s_max doubled {rd('smax', 'cross'):.4g}, "
        f"the encoder's last layer skipped {rd('skip_enc', 'cross'):.4g}; greedy tokens agree "
        f"{agree[0]}/{agree[2]} ({t_cpu:.1f} s); phase {time.perf_counter() - t0:.1f} s "
        f"(serving {t_serve:.1f} s)")
    return launches, live


# -- phase 17: the recurrent families over state slabs --------------------------------
RECURRENT_BUDGET_S = 75
RECURRENT = ("xlstm-125m", "zamba2-1.2b")
RECURRENT_PROMPTS = (200, 90, 37, 140)  # tokens; rid 2 arrives at priority 1
RECURRENT_NEW = 16
RECURRENT_SLABS = 2  # the starved pool: 2 slabs for 4 slots
# an injected fault must read this many BLOCK_RTOL or more (the CPU rehearsal
# at SMOKE widths read 0.24-0.27 for the slab not reset, whose leftover
# fades within a few tokens of a 37- or 100-token chunk, and 1.04-1.12 for
# the shifted conv tail)
RECURRENT_FAULT = 2.0


def _recurrent_per_program(cfg):
    """(row-1 GEMMs, row-2 launches) of one program of ``cfg``: xLSTM 7 a
    mLSTM / sLSTM pair and no attention; Zamba2 in_proj and out_proj a
    Mamba2 layer and q, k, v, o, up and down a shared-block invocation, whose
    paged decode launches once a decode step (a prefill chunk attends in
    plain PyTorch, as the reference's does)."""
    from repro_torch.models import api
    from repro_torch.models.hybrid import n_attn_invocations

    if not api._is_hybrid(cfg):
        return len(XLSTM_PAIR_GEMMS) * cfg.n_layers // 2, 0
    n_inv = n_attn_invocations(cfg)
    return len(ZAMBA2_LAYER_GEMMS) * cfg.n_layers + len(ZAMBA2_SHARED_GEMMS) * n_inv, n_inv


def _recurrent_server(torch, cfg, packed, pool_slabs=None):
    """The reference Server's defaults for a slab family (the mixed engine
    asked for, FP8 pages for the hybrid's shared block), 4 slots, audited
    every step; ``pool_slabs`` starves the slab pool. The engine must
    resolve to the alternating one and the prefix cache to none."""
    from repro_torch.runtime import serve

    srv = serve.Server(packed, cfg, serve.ServerConfig(
        slots=4, max_seq=512, page_size=64, a_fmt="fp8_e4m3",
        cache=serve.CachePolicy(active_fmt="fp8_e4m3"), prefix_cache=True,
        pool_slabs=pool_slabs, audit_every=1,
        scheduler=serve.SchedulerConfig(engine="mixed", steal_cooldown=1)))
    if srv.engine != "alternating" or srv._prefix is not None:
        fail(f"{cfg.name}: engine {srv.engine!r}, prefix cache {srv._prefix is not None}: a slab "
             "family serves on the alternating engine without a prefix cache")
    return srv


def _recurrent_traffic(cfg):
    """4 greedy requests: prompts of RECURRENT_PROMPTS tokens from the seed,
    RECURRENT_NEW new tokens, rid 2 at priority 1 (it steals a slab on a
    starved pool)."""
    import numpy as np

    from repro_torch.runtime import serve

    rng = np.random.default_rng(SEED + 17)
    return [serve.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, n).tolist(),
                          max_new=RECURRENT_NEW, priority=int(i == 2))
            for i, n in enumerate(RECURRENT_PROMPTS)]


def _recurrent_serve(torch, cfg, packed, pool_slabs=None):
    """The traffic on one server, every launch counter set to 0 just before
    and read just after, audited after every step. Returns (streams,
    launches, stats, wall seconds)."""
    srv = _recurrent_server(torch, cfg, packed, pool_slabs)
    reqs = _recurrent_traffic(cfg)
    _set_counts(dict.fromkeys(_counts(), 0))
    wall = _drain_audited(torch, srv, reqs)
    launches = _counts()
    results = [r.result() for r in srv.finished]
    if len(results) != len(reqs) or not all(r.ok for r in results):
        fail(f"{cfg.name}: not every request ended ok: {[(r.rid, r.status) for r in results]}")
    audit = srv.audit()
    if audit["slabs_owned"] or audit["slabs_free"] != srv._n_slabs or audit["active"]:
        fail(f"{cfg.name}: slabs not all free after the drain: {audit}")
    return {r.rid: list(r.tokens) for r in results}, launches, dict(srv.stats), wall


def _recurrent_routes(torch, cfg, packed):
    """The 2-layer model's routes for ``_recurrent_compare``: name ->
    (params, device). ``no_reset`` and ``conv_shift`` run the card's kernels
    on the card's weights; their faults are applied to their slabs."""
    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map

    is_packed = lambda x: isinstance(x, PackedLinear)
    to_cpu = lambda t: t.apply(lambda x: x.cpu()) if is_packed(t) else t.cpu()
    return {"card": (packed, DEV), "cpu": (tree_map(to_cpu, packed, is_leaf=is_packed), "cpu"),
            "no_reset": (packed, DEV), "conv_shift": (packed, DEV)}


def _recurrent_compare(torch, cfg, packed, n_dec=2):
    """The 2-layer model along ``_recurrent_routes``, each with slab pools
    (and pages) of its own: 2 requests (prompts of 100 and 37 tokens from
    SEED + 1), each prefilled as one exact chunk into its own slab, then
    ``n_dec`` decode steps of both, every route fed the card's greedy tokens.
    Teacher-forced per block: each Mamba2 block and shared attention block
    (Zamba2) or mLSTM and sLSTM block (xLSTM) of every route takes the card's
    input to it; the reading is the block's update error over the CPU
    route's update (Frobenius). The faults: ``no_reset``'s slabs hold a
    previous owner's state (a 64-token prompt each) when the requests start,
    as a recycled slab that is not reset would; ``conv_shift`` rolls every
    conv tail by one token after the prefill. Returns ({route: largest
    reading}, (agreeing greedy tokens, decisive ones, tokens))."""
    import numpy as np

    from repro_torch.models import api, hybrid
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import serve

    routes = _recurrent_routes(torch, cfg, packed)
    is_hybrid = api._is_hybrid(cfg)
    sites = ((hybrid, "mamba2_block"), (hybrid, "_shared_block")) if is_hybrid else \
        ((tf, "mlstm_block"), (tf, "slstm_block"))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (100, 37)]
    previous = [rng.integers(2, cfg.vocab_size, 64).tolist() for _ in prompts]
    config = serve.ServerConfig(slots=2, max_seq=256, page_size=64, a_fmt="fp8_e4m3",
                                cache=serve.CachePolicy(active_fmt="fp8_e4m3"),
                                prefix_cache=False,
                                scheduler=serve.SchedulerConfig(engine="alternating"))
    pools = {name: serve.Server(params, cfg, config, device=d).pools
             for name, (params, d) in routes.items()}
    table = np.arange(8, dtype=np.int32).reshape(2, 4)
    t = lambda a, d: torch.as_tensor(np.asarray(a, np.int32)).to(d)
    reading = {name: 0.0 for name in routes}
    agree = [0, 0, 0]

    def run(name, tokens, rows, lengths, chunk_len, lead):
        params, d = routes[name]
        trace = []  # (input, update) of every block call, in order

        def hook(fn, shared):
            def block(p, x, *args, **kw):
                if lead is not None:
                    x = lead[len(trace)][0].to(d)
                y = fn(p, x, *args, **kw)
                out = y if shared else y[0]
                trace.append((x, out - x if shared else out))
                return y
            return block
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
        for mod, attr, fn in saved:
            setattr(mod, attr, hook(fn, attr == "_shared_block"))
        try:
            st = kvc.PagedState(t(table[rows], d), t(lengths, d),
                                None if chunk_len is None else t([chunk_len], d),
                                slabs=t(rows, d))
            logits = api.decode_step(params, cfg, t(tokens, d), pools[name], st,
                                     a_fmt="fp8_e4m3")
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        return logits.float().cpu(), trace

    def step(tokens, rows, lengths, chunk_len=None):
        out = {"card": run("card", tokens, rows, lengths, chunk_len, None)}
        for name in routes:
            if name != "card":
                out[name] = run(name, tokens, rows, lengths, chunk_len, out["card"][1])
        for name, (o, _) in out.items():
            if not bool(torch.isfinite(o).all()):
                fail(f"{cfg.name}: non-finite logits on route {name}")
        ref_logits, ref_trace = out["cpu"]
        for name, (_, trace) in out.items():
            for (_, y), (_, y0) in zip(trace, ref_trace):
                y, y0 = y.double().cpu(), y0.double().cpu()
                reading[name] = max(reading[name], float((y - y0).norm() / y0.norm()))
        scale = float(ref_logits.abs().max())
        top2 = out["card"][0].topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_RTOL * scale
        same = out["card"][0].argmax(-1) == ref_logits.argmax(-1)
        if bool((decisive & ~same).any()):
            fail(f"{cfg.name}: greedy tokens differ where the top-2 gap exceeds the tolerance")
        agree[0] += int(same.sum())
        agree[1] += int(decisive.sum())
        agree[2] += len(same)
        return out["card"][0].argmax(-1).tolist()

    # no_reset: each slab first serves a previous owner's prompt, not reset after
    for row, prompt in enumerate(previous):
        run("no_reset", [prompt], [row], [0], len(prompt), None)
    nxt = []
    for row, prompt in enumerate(prompts):  # one exact prefill chunk each
        nxt += step([prompt], [row], [0], len(prompt))
    for unit in _slab_units(pools["conv_shift"], cfg):
        conv = unit["conv"]  # (L, slabs + 1, d_conv - 1, C): the last inputs
        conv[:, :2] = torch.roll(conv[:, :2], 1, dims=2)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for _ in range(n_dec):
        nxt = step(np.array(nxt, np.int32)[:, None], [0, 1], lengths)
        lengths += 1
    return reading, agree


def _slab_units(pools, cfg):
    """The slab pools that hold a conv tail: Zamba2's Mamba2 pool, or each
    xLSTM segment's mLSTM pool."""
    from repro_torch.models import api

    return [pools["mamba"]] if api._is_hybrid(cfg) else [seg["mlstm"] for seg in pools]


def phase_recurrent(torch, card):
    """xlstm-125m (12 layers) and zamba2-1.2b (38 layers) at full width,
    random weights from SEED initialized and packed on the card, each served
    greedily (4 requests, the alternating engine the mixed one resolves to,
    audited every step) fully backed and then on a slab-starved pool
    (RECURRENT_SLABS slabs for 4 slots), where rid 2 (priority 1) steals a
    slab and the victim resumes from its spill: every request ok, the
    launches of each run equal to its invariant (``_recurrent_per_program``
    a program; row 2 once an invocation a decode step), the starved streams
    equal to the fully backed ones bit for bit (slab state is exact f32).
    Then both cut to 2 layers against the CPU plain path, teacher-forced per
    block (``_recurrent_compare``), two injected faults reading at least
    RECURRENT_FAULT x BLOCK_RTOL. Returns {config: the fully backed run's
    launches}."""
    from repro_torch.configs import get_config

    out = {}
    for name in RECURRENT:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        cfg, packed, t_pack = _random_packed(torch, name)
        per, per_attn = _recurrent_per_program(cfg)
        streams, launches, st, wall = _recurrent_serve(torch, cfg, packed)
        want = {**dict.fromkeys(launches, 0), "w4a8_fused": per * st["programs"],
                "paged_decode_attn": per_attn * st["steps"]}
        if launches != want or min(st["steps"], launches["w4a8_fused"]) <= 0:
            fail(f"{name}: kernel launches {launches}, want {want} ({st['programs']} programs, "
                 f"{st['steps']} decode steps)")
        starved, s_launches, s_st, s_wall = _recurrent_serve(torch, cfg, packed, RECURRENT_SLABS)
        s_want = {**want, "w4a8_fused": per * s_st["programs"],
                  "paged_decode_attn": per_attn * s_st["steps"]}
        if s_launches != s_want:
            fail(f"{name}: starved pool's launches {s_launches}, want {s_want}")
        if s_st["preemptions"] < 1 or s_st["resumes"] < 1:
            fail(f"{name}: the starved pool stole {s_st['preemptions']} and resumed "
                 f"{s_st['resumes']} times, want >= 1 each")
        if starved != streams:
            diff = {rid: (starved[rid], streams[rid]) for rid in streams
                    if starved[rid] != streams[rid]}
            fail(f"{name}: starved streams differ from the fully backed ones: {diff}")
        n_tok = sum(len(v) for v in streams.values())
        log(f"[17 recurrent] {name} ({cfg.family}; d_model {cfg.d_model}, {cfg.n_layers} layers, "
            f"vocab {cfg.vocab_size}) on {card}: random init + W4A8 pack on the card "
            f"{t_pack:.1f} s; fully backed {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} "
            f"tokens/s ({st['steps']} decode steps, {st['programs'] - st['steps']} prefill "
            f"chunks), launches {({k: v for k, v in launches.items() if v})} = {per} GEMMs a "
            f"program, {per_attn} decode attention launches a decode step; starved "
            f"({RECURRENT_SLABS} slabs for 4 slots) {s_st['preemptions']} steal(s), "
            f"{s_st['resumes']} resume(s), {s_wall:.2f} s, streams bit-identical; audit clean "
            f"at every step")
        out[name] = launches
        del packed
        t1 = time.perf_counter()
        cfg2, packed2, _ = _random_packed(torch, name, n_layers=2)
        reading, agree = _recurrent_compare(torch, cfg2, packed2)
        if reading["card"] > BLOCK_RTOL:
            fail(f"{name}: the card's blocks differ from the CPU plain path by "
                 f"{reading['card']:.4g} of their update > {BLOCK_RTOL}")
        for fault in ("no_reset", "conv_shift"):
            if reading[fault] < RECURRENT_FAULT * BLOCK_RTOL:
                fail(f"{name}: injected fault {fault} reads {reading[fault]:.4g} < "
                     f"{RECURRENT_FAULT} x {BLOCK_RTOL}: the comparison cannot tell it from the "
                     "sound path")
        log(f"    2 layers of {get_config(name).n_layers} against the CPU plain path (2 requests: "
            f"a prefill chunk and 2 decode steps), teacher-forced per block, largest |err| / "
            f"|update| (tolerance {BLOCK_RTOL}): card {reading['card']:.4g}; faults: a recycled "
            f"slab not reset {reading['no_reset']:.4g}, the conv tail shifted by one token "
            f"{reading['conv_shift']:.4g} (>= {RECURRENT_FAULT * BLOCK_RTOL:.2g} required); "
            f"greedy tokens agree {agree[0]}/{agree[2]} ({time.perf_counter() - t1:.1f} s); "
            f"{name} {time.perf_counter() - t0:.1f} s")
        del packed2
    return out


# -- phase 18: DeepSeek-V3 ------------------------------------------------------------
DEEPSEEK_BUDGET_S = 240
DS_SERVED_LAYERS = 4  # of 61: the 3 dense layers and the first MoE layer (+ the MTP block)
DS_BLOCK_TOKENS = 512  # the cache-free blocks' teacher-forced input: one sequence
DS_LOSS_BATCH = (2, 1024)  # loss_fn's tokens: 2 sequences of 1024
# nll, aux and mtp through the kernels against the plain versions on the
# card, relative. A mean over 2048 tokens moves far less than the blocks
# under it (a sound pass reads ~5e-4 on the H100, aux from the tokens whose
# routing flips between the two, F1; PERF.md), and DS_LOSS_FAULT, dense
# layer 0's down with its scales doubled through the kernels, must read
# above DS_LOSS_RTOL. The other planted faults are printed beside it.
DS_LOSS_RTOL = 2e-3
DS_LOSS_FAULT = "down_scale"


def _ds_gemms(cfg, cache_free=False):
    """Row-1 launches of one DeepSeek program: per MLA layer wq_a, wq_b,
    wkv_a and wo (cache-free also wk_b and wv_b, which a served step runs
    per head through rows 1b / 1c); gate, up and down per dense layer and
    the shared expert's per MoE layer. Cache-free (the loss) adds the MTP
    block (an MLA + MoE block) and mtp/proj."""
    n_dense = cfg.moe.n_dense_layers
    n_moe = cfg.n_layers - n_dense
    mla, ffn = (6 if cache_free else 4), 3
    if not cache_free:
        return mla * cfg.n_layers + ffn * n_dense + ffn * n_moe
    return mla * (cfg.n_layers + 1) + ffn * n_dense + ffn * (n_moe + 1) + 1


def _doubled_scales(p, i):
    """PackedLinear ``p`` with every scale of its slice ``i`` (an index into
    its leading axes) doubled: the M2 row scale ``s_max`` that the kernel
    reads and the group scales of the plain version, so the slice's
    quantized product doubles (its LoRC term does not)."""
    scale, s_max = p.scale.clone(), p.s_max.clone()
    scale[i] *= 2
    s_max[i] *= 2
    return dataclasses.replace(p, scale=scale, s_max=s_max)


def _ds_blocks(torch, cfg, packed):
    """DeepSeek's cache-free blocks teacher-forced against the plain
    versions on the card, each fed the kernels' input (DS_BLOCK_TOKENS
    tokens from SEED): the 3 dense layers, the MoE layer (its grouped
    capacity dispatch) and the MTP block on its projected input; the
    reading is |output err| / |update| (Frobenius), within BLOCK_RTOL.
    Returns {block: reading}."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import linear, norm

    segs = tf.segments_for(cfg)
    rng = np.random.default_rng(SEED + 18)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, DS_BLOCK_TOKENS))).to(DEV)
    pos = torch.arange(tokens.shape[1], device=DEV)
    reading = {}

    def held(name, p, x, seg):
        y_k = tf.block_apply(p, x, cfg, seg, pos, a_fmt="fp8_e4m3")[0]
        with _ops_patched(PLAIN):
            y_p = tf.block_apply(p, x, cfg, seg, pos, a_fmt="fp8_e4m3")[0]
        err = float((y_k.double() - y_p.double()).norm() / (y_p.double() - x.double()).norm())
        reading[name] = max(reading.get(name, 0.0), err)
        return y_k

    x = packed["embed"][tokens]
    for seg, stack in zip(segs, packed["segments"]):
        for i in range(seg.count):
            x = held("dense" if seg.ffn == "mlp" else "moe", tf.layer_view(stack, i), x, seg)
    hidden = norm(packed["final_ln"], x, cfg.norm_kind, cfg.norm_eps)
    p = packed["mtp"]
    h_in = torch.cat([hidden[:, :-1], packed["embed"][tokens[:, 1:]].to(hidden.dtype)], -1)
    h_in = linear(p["proj"], torch.nn.functional.pad(h_in, (0, 0, 0, 1)))
    held("mtp", p["block"], h_in, segs[-1])
    torch.cuda.synchronize()
    for name, err in reading.items():
        if err > BLOCK_RTOL:
            fail(f"DeepSeek's cache-free {name} block differs from the plain versions on the card "
                 f"by {err:.4g} of its update > {BLOCK_RTOL}")
    return reading


def _expert_scale_fault(torch, stack, gen):
    """Row 1d on the served MoE layer's wu stack at a decode step (4 tokens,
    each routed to 8 of the 256 experts, expert 0 to all four) within
    W4A8_TOL of its plain version; expert 0's group contributing most, its
    scale doubled (a shift one less), must read DENSE_FAULT excesses or
    more against the sound plain version. Launches not counted. Returns
    (sound excess, fault excess)."""
    from repro_torch.kernels import ops

    saved = _counts()
    e, m, k = stack.codes.shape[0], 4, stack.codes.shape[2] * 2
    pick = torch.rand((m, e), generator=gen, device=DEV)
    pick[:, 0] = 2.0  # expert 0 among every token's top 8
    keep = torch.zeros((m, e), dtype=torch.bool, device=DEV).scatter_(
        1, pick.topk(8, dim=-1).indices, True)
    x = torch.randn((e, m, k), generator=gen, device=DEV).to(torch.bfloat16)
    x = torch.where(keep.t()[..., None], x, torch.zeros((), dtype=x.dtype, device=DEV))
    y_k = ops.w4a8_matmul_batched(x, stack)
    with _ops_patched(PLAIN):
        y_p = ops.w4a8_matmul_batched(x, stack)
    one = _doubled_top_group(torch, stack.apply(lambda t: t[0]), x[0])
    faulty = dataclasses.replace(stack, scale=stack.scale.clone(), shifts=stack.shifts.clone())
    faulty.scale[0], faulty.shifts[0] = one.scale, one.shifts
    y_f = ops.w4a8_matmul_batched(x, faulty)
    torch.cuda.synchronize()
    _set_counts(saved)
    sound, fault = _excess(y_k, y_p), _excess(y_f, y_p)
    if sound > 1:
        fail(f"DeepSeek wu stack: row 1d reads {sound:.3g} W4A8_TOL excesses against its plain "
             "version")
    if fault < DENSE_FAULT:
        fail(f"DeepSeek wu stack: expert 0's doubled group scale reads {fault:.3g} < "
             f"{DENSE_FAULT} excesses: the comparison cannot tell it from the sound weight")
    return sound, fault


def _ds_loss(torch, cfg, routes):
    """``loss_fn(mtp_weight=0.3)`` on DS_LOSS_BATCH tokens from SEED (labels
    the next tokens) along each route of ``routes`` (name -> (params,
    device, ``ops`` patch), as ``_routes``), every launch counter set to 0
    before each. Returns ({route: (seconds, total, metrics)}, the launches
    of route "card")."""
    import numpy as np

    from repro_torch.models import api

    b, s = DS_LOSS_BATCH
    seq = torch.as_tensor(np.random.default_rng(SEED + 19).integers(
        2, cfg.vocab_size, (b, s + 1)).astype(np.int32)).to(DEV)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    out = {}
    for name, (params, _, patch) in routes.items():
        _set_counts(dict.fromkeys(_counts(), 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ops_patched(patch), torch.no_grad():
            total, metrics = api.loss_fn(params, cfg, batch, a_fmt="fp8_e4m3", remat=False,
                                         mtp_weight=0.3)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0, float(total),
                     {k: float(v) for k, v in metrics.items()})
        if name == "card":
            launches = _counts()
    return out, launches


def phase_deepseek(torch, card, kernels):
    """DeepSeek-V3 (MLA + 256-expert MoE + MTP) at its published widths, cut
    to DS_SERVED_LAYERS of its 61 layers plus the MTP block, random weights
    from SEED initialized and packed on the card leaf by leaf
    (``_random_packed``: the dense tree would not fit beside the packed
    one), on the reference Server's default path with phase 6's traffic:
    every request ok, the launches of a step equal to the invariant (none
    for the MTP block), the live latent pool's frozen kernel held with its
    injected fault. Then, against the plain versions on the card: the
    served blocks teacher-forced (``_compare``), the cache-free dense, MoE
    and MTP blocks (``_ds_blocks``), one expert's doubled group scale, and
    ``loss_fn(mtp_weight=0.3)`` (nll, aux, mtp within DS_LOSS_RTOL, its
    launches equal to the cache-free invariant; the planted fault
    DS_LOSS_FAULT must read above DS_LOSS_RTOL). ``kernels``: phase 3's
    DeepSeek rows. Returns (serving launches, live, loss launches)."""
    from repro_torch.models.transformer import layer_view

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, packed, t_pack = _random_packed(torch, "deepseek-v3-671b", n_layers=DS_SERVED_LAYERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    m, ml = cfg.moe, cfg.mla
    log(f"[18 deepseek] DeepSeek-V3 ({cfg.n_layers} of 61 layers: {m.n_dense_layers} dense + "
        f"{cfg.n_layers - m.n_dense_layers} MoE, + the MTP block; d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, q_lora {ml.q_lora_rank}, kv_lora {ml.kv_lora_rank}, nope "
        f"{ml.qk_nope_dim}, rope {ml.qk_rope_dim}, v {ml.v_head_dim}; {m.n_experts} experts "
        f"top-{m.top_k} of d_ff {m.d_ff} + {m.n_shared_experts} shared; dense d_ff "
        f"{m.dense_d_ff}; vocab {cfg.vocab_size}): random init + W4A8 pack on the card, leaf by "
        f"leaf, {t_pack:.1f} s, {peak:.2f} GB peak, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"held")
    srv = _default_server(torch, cfg, packed)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 18)
    wall, step_ms, live, results, launches, system, rng = _drive_waves(
        torch, srv, cfg, lambda srv: _live_mla_check(torch, srv, gen))
    steps = srv.stats["steps"]
    n_moe = cfg.n_layers - m.n_dense_layers
    # one program a step: the GEMMs of _ds_gemms, wv_b's batched and wk_b's
    # transposed GEMM per layer, the 3 expert GEMMs (wu, wg, wd) of each
    # MoE layer with FP8 activations, and one frozen latent decode per
    # layer; the MTP block is never read by a served step
    want = {**dict.fromkeys(launches, 0), "w4a8_fused": _ds_gemms(cfg) * steps,
            "w4a8_fused_batched": cfg.n_layers * steps,
            "w4a8_fused_transposed": cfg.n_layers * steps,
            "w4a8_fused_batched_fp8": 3 * n_moe * steps,
            "paged_mla_decode_attn_frozen": cfg.n_layers * steps}
    if launches != want or min(launches[k] for k in want if want[k]) <= 0:
        fail(f"kernel launches {launches}, want {want} ({steps} steps)")
    log(f"    mixed engine, prefix cache, fp8 latent pages + fp4_e2m1 frozen pages, {srv.slots} "
        f"slots, 8 requests (512-token system prompt + 16-200 token tails, 32 new tokens) in "
        f"2 waves, on {card}:")
    _report_waves(srv, wall, step_ms, results, launches, want)
    log(f"    a step's launches: {_ds_gemms(cfg)} row-1 GEMMs, {cfg.n_layers} + {cfg.n_layers} "
        f"rows 1b / 1c, {3 * n_moe} row 1d, {cfg.n_layers} frozen row 3; none for the MTP block")
    log(f"    live latent pool, {cfg.n_layers} layers over 2 segments, H {cfg.n_heads}, r "
        f"{ml.kv_lora_rank}, dr {ml.qk_rope_dim}: frozen MLA kernel vs plain max|err| "
        f"{live[0]:.3g} (tolerance {ATTN_TOL}); injected fault ckv_fz_shift + 1 reads "
        f"{live[1]:.3g} (>= {10 * ATTN_TOL} required)")
    _profile_hits(torch, srv, cfg, system, rng)
    del srv
    routes = _routes(torch, packed, "moe", cpu=False)
    t1 = time.perf_counter()
    forced, agree = _compare(torch, cfg, {k: routes[k] for k in ("card", "card_plain")},
                             forced=True, n_dec=1, ref="card_plain")
    if forced["card"]["block"] > BLOCK_RTOL:
        fail(f"DeepSeek's served blocks differ from the plain versions on the card by "
             f"{forced['card']['block']:.4g} of their update > {BLOCK_RTOL}")
    blocks = _ds_blocks(torch, cfg, packed)
    wu = layer_view(packed["segments"][1], 0)["ffn"]["moe"]["wu"]
    sound, fault = _expert_scale_fault(torch, wu, gen)
    log(f"    teacher-forced against the plain versions on the card, |output err| / |update| "
        f"(tolerance {BLOCK_RTOL}): served blocks (2 requests, a prefill chunk + 1 decode step) "
        f"{forced['card']['block']:.4g}, greedy tokens agree {agree[0]}/{agree[2]}; cache-free "
        f"({DS_BLOCK_TOKENS} tokens) "
        + ", ".join(f"{k} {v:.4g}" for k, v in blocks.items())
        + f"; MoE wu stack at M=4 {sound:.3g} W4A8_TOL excesses, expert 0's group scale doubled "
        f"{fault:.3g} (>= {DENSE_FAULT}); {time.perf_counter() - t1:.1f} s")
    # the loss's planted faults, through the kernels: no_lorc and expert_swap
    # (``_routes``), dense layer 0's down and expert 0's wu (MoE layer) with
    # their scales doubled
    routes["down_scale"] = (_in_segments(packed, "ffn", "down", lambda t: _doubled_scales(t, 0)),
                            DEV, {})
    routes["expert0_scale"] = (_in_segments(packed, "ffn", "wu",
                                            lambda t: _doubled_scales(t, (0, 0))), DEV, {})
    loss, loss_launches = _ds_loss(torch, cfg, routes)
    want = {**dict.fromkeys(loss_launches, 0), "w4a8_fused": _ds_gemms(cfg, cache_free=True),
            "w4a8_fused_batched_fp8": 3 * (n_moe + 1)}
    if loss_launches != want:
        fail(f"loss_fn's kernel launches {loss_launches}, want {want}")
    (t_k, tot_k, m_k), (t_p, tot_p, m_p) = loss["card"], loss["card_plain"]
    rel = lambda m: {k: abs(m[k] - m_p[k]) / abs(m_p[k]) for k in ("nll", "aux", "mtp")}
    sound = rel(m_k)
    faults = {name: max(rel(r[2]).values()) for name, r in loss.items()
              if name not in ("card", "card_plain")}
    log(f"    loss_fn(mtp_weight=0.3) on {DS_LOSS_BATCH[0]} x {DS_LOSS_BATCH[1]} tokens: kernels "
        f"total {tot_k:.6g} (nll {m_k['nll']:.6g}, aux {m_k['aux']:.6g}, mtp {m_k['mtp']:.6g}) "
        f"in {t_k:.2f} s; plain versions on the card total {tot_p:.6g} (nll {m_p['nll']:.6g}, "
        f"aux {m_p['aux']:.6g}, mtp {m_p['mtp']:.6g}) in {t_p:.2f} s; relative differences "
        + ", ".join(f"{k} {v:.3g}" for k, v in sound.items())
        + f" (tolerance {DS_LOSS_RTOL}); launches {({k: v for k, v in loss_launches.items() if v})}"
        + "; planted faults, largest relative difference: "
        + ", ".join(f"{k} {v:.3g}" for k, v in faults.items())
        + f" ({DS_LOSS_FAULT} must exceed {DS_LOSS_RTOL})")
    for k, v in sound.items():
        if v > DS_LOSS_RTOL:
            fail(f"loss_fn's {k} through the kernels differs from the plain versions on the card "
                 f"by {v:.4g} > {DS_LOSS_RTOL}")
    if faults[DS_LOSS_FAULT] <= DS_LOSS_RTOL:
        fail(f"loss_fn's planted fault {DS_LOSS_FAULT} reads {faults[DS_LOSS_FAULT]:.4g} <= "
             f"{DS_LOSS_RTOL}: the comparison cannot tell it from the sound kernels")
    row = kernels["mla"][("fp8_e4m3", True)]
    log(f"    row 3 at r {ml.kv_lora_rank}, dr {ml.qk_rope_dim}, H {cfg.n_heads} (phase 3, one "
        f"launch, fp8 + fp4 frozen pages, contexts {DS_MLA_SHAPE['lens']}): device "
        f"{row['device_ms'] * 1e3:.2f} us against SDPA on the dequantized pages "
        f"{row['library_device_ms'] * 1e3:.2f} us ({row['device_ms'] / row['library_device_ms']:.3f}x)")
    del packed, routes
    torch.cuda.empty_cache()
    return launches, live, loss_launches


# -- phase 19: training -----------------------------------------------------------
TRAIN_BUDGET_S = 240
# card against CPU, each leaf of a step's gradients: max|g - g_cpu| <=
# GRAD_TOL * max|g_cpu|, the bound tests/test_torch_grad_*.py hold the port
# to against the reference; block 0's residual detached on the card must read
# GRAD_FAULT times it or more
GRAD_TOL = 3e-2
GRAD_FAULT = 10.0
TRAIN_STEP_RTOL = 1e-3  # a step's loss, card against CPU
TRAIN_STEPS = 200  # examples/train_and_quantize.py's paper preset, cut from 300
TRAIN_DATA = dict(seq_len=512, global_batch=8)
TRAIN_OPT = dict(lr=6e-4, warmup=20, total_steps=TRAIN_STEPS)
TRAIN_CKPT_EVERY = 100
RESUME_RTOL = 1e-3  # the resumed run's first loss against the uninterrupted run's
TRAIN_ONE_STEP = (2, 128)  # the full-width step held card against CPU
# At full width a sound step moves by several % of a leaf's largest under a
# mere change of summation order (opt-125m: 5.65 % with every linear summed
# in f64 instead of f32, on the CPU; the card reads 6.62 %; PERF.md), far
# above GRAD_TOL, which holds at SMOKE widths. So the full-width step's witness is that move, read on the
# same inputs: the card may read at most WITNESS_FACTOR times it, and the
# planted fault GRAD_FAULT times it or more.
WITNESS_FACTOR = 2.0
TRAIN_PPL_BATCHES = 4


@contextlib.contextmanager
def _block0_detached(hybrid_family):
    """The planted fault of tests/test_torch_grad_dense.py: the residual
    stream leaving block 0 (``transformer.block_apply``'s first call; a
    hybrid's ``_shared_block``'s) keeps its value but leaves the graph."""
    from repro_torch.models import hybrid, transformer

    mod, attr = (hybrid, "_shared_block") if hybrid_family else (transformer, "block_apply")
    fn, first = getattr(mod, attr), []

    def faulty(p, x, *args, **kw):  # block 0: its first call, and remat's recompute of it
        out = fn(p, x, *args, **kw)
        if not first:
            first.append(x)
        if x is not first[0]:
            return out
        return (out[0].detach(),) + tuple(out[1:]) if isinstance(out, tuple) else out.detach()

    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, fn)


def _step_grads(cfg, state, batch, fault=False):
    """One ``make_train_step`` on ``state``'s device (AdamW at TRAIN_OPT):
    (metrics as floats, the gradients that reach the update in the
    reference's leaf order, the new state)."""
    from repro_torch.launch import steps
    from repro_torch.models.api import _is_hybrid
    from repro_torch.models.params import tree_leaves
    from repro_torch.optimizer import AdamWConfig

    seen, update = {}, steps.adamw_update

    def spy(params, grads, opt, oc):
        seen["grads"] = tree_leaves(grads)
        return update(params, grads, opt, oc)

    steps.adamw_update = spy
    try:
        with _block0_detached(_is_hybrid(cfg)) if fault else contextlib.nullcontext():
            new, metrics = steps.make_train_step(cfg, AdamWConfig(**TRAIN_OPT))(state, batch)
    finally:
        steps.adamw_update = update
    return {k: float(v) for k, v in metrics.items()}, seen["grads"], new


def _leaf_paths(tree, prefix=""):
    """"/"-joined paths of ``tree``'s leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree) for p in _leaf_paths(c, f"{prefix}{i}/")]
    return [] if tree is None else [prefix[:-1]]


def _grad_readings(got, want):
    """max|g - g_ref| / max|g_ref| of every leaf."""
    out = []
    for g, w in zip(got, want):
        big = float(w.float().abs().max())
        diff = float((g.float().cpu() - w.float()).abs().max())
        out.append(diff / big if big else (0.0 if diff == 0 else math.inf))
    return out


@contextlib.contextmanager
def _f64_linears():
    """Every dense linear of the models summed in f64 (its output still
    rounded to the activation dtype): the same step in another order."""
    import torch

    from repro_torch.models import attention, layers, mla, moe, ssm, transformer, xlstm

    def linear64(w, x, bias=None):
        y = torch.matmul(x.double(), w.double().t()).to(x.dtype)
        return y if bias is None else y + bias

    mods = [m for m in (attention, layers, mla, moe, ssm, transformer, xlstm)
            if getattr(m, "linear", None) is layers.linear]
    saved = layers.linear
    for m in mods:
        m.linear = linear64
    try:
        yield
    finally:
        for m in mods:
            m.linear = saved


def _card_vs_cpu(torch, cfg, params_cpu, batch, what, witness=False):
    """One training step from ``params_cpu`` (fresh AdamW state) on the CPU
    and, moved over, on the card: the loss within TRAIN_STEP_RTOL, the
    gradients leaf by leaf within GRAD_TOL, and block 0's residual detached
    on the card GRAD_FAULT x GRAD_TOL or more. With ``witness`` the bound
    is read on these inputs instead: the CPU's step with its linears summed
    in f64 against its own (``_f64_linears``); the card then reads at most
    WITNESS_FACTOR x that, the fault GRAD_FAULT x it or more. Returns (CPU
    loss, card loss, reading, fault reading, the witness's reading or
    None)."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.models.params import tree_map
    from repro_torch.optimizer import AdamWConfig, adamw_init

    state = TrainState(params_cpu, adamw_init(params_cpu, AdamWConfig(**TRAIN_OPT)))
    card = tree_map(lambda t: t.to(DEV), state)
    m_cpu, g_cpu, _ = _step_grads(cfg, state, batch)
    m_card, g_card, _ = _step_grads(cfg, card, batch)
    _, g_fault, _ = _step_grads(cfg, card, batch, fault=True)
    readings = _grad_readings(g_card, g_cpu)
    reading, fault = max(readings), max(_grad_readings(g_fault, g_cpu))
    rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    names = _leaf_paths(params_cpu)
    top = lambda rs: ", ".join(f"{n} {r:.3g}" for r, n in sorted(zip(rs, names), reverse=True)[:3])
    line = f"    {what}: the largest leaves' readings, card against CPU {top(readings)}"
    moved, bound, floor = None, GRAD_TOL, GRAD_FAULT * GRAD_TOL
    if witness:
        with _f64_linears():
            _, g_64, _ = _step_grads(cfg, state, batch)
        moved_all = _grad_readings(g_64, g_cpu)
        moved = max(moved_all)
        bound, floor = WITNESS_FACTOR * moved, GRAD_FAULT * moved
        line += f"; the CPU's linears in f64 against f32 {top(moved_all)}"
    log(line)
    if any(g.device.type != torch.device(DEV).type for g in g_card):
        fail(f"{what}: a gradient of the card's step is not on the card")
    if reading > bound or rel > TRAIN_STEP_RTOL:
        fail(f"{what}: the card's step against the CPU's: gradients {reading:.4g} of a leaf's "
             f"largest (> {bound:.4g}?), loss {rel:.3g} relative (> {TRAIN_STEP_RTOL}?)")
    if fault < floor:
        fail(f"{what}: block 0's residual detached reads {fault:.4g} < {floor:.4g}: the "
             "comparison cannot tell it from the sound step")
    return m_cpu["loss"], m_card["loss"], reading, fault, moved


def _smoke_batch(cfg, rng, b=2, s=24):
    """tokens and labels (B, S), behind LLaVA's patches or beside Whisper's
    frames, from numpy."""
    import numpy as np
    import torch

    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.normal(size=(b, cfg.n_patches, 1024)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _timed_steps(torch, cfg, state, batch, n=5):
    """``n`` training steps on the card after 2 untimed: their median wall
    time, and one more step under torch.profiler: (median ms, busy ms, wall
    ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optimizer import AdamWConfig

    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    for _ in range(2):
        state, _ = step_fn(state, batch)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy = sum(dev_us(e) for e in kernels) / 1e3 or None  # None: the trace has no device time
    return statistics.median(times), busy, wall, sum(e.count for e in kernels)


def phase_train(torch, card):
    """Training on the card (``launch.steps.make_train_step`` ->
    ``api.loss_fn`` under autograd with remat -> AdamW; ``runtime.train``
    with checkpoints). Every family's SMOKE config: one step on the card
    against the same step on the CPU from params drawn on the CPU, with
    block 0's residual detached as the planted fault. opt-125m at full
    width: one step at TRAIN_ONE_STEP card against CPU, then TRAIN_STEPS
    steps of ``train_loop`` over SyntheticLM at the paper preset, saved at
    steps 100 and 200 (each restored bit-identical to what was saved), nll
    falling; resumed from step 100, its first loss within RESUME_RTOL of the
    uninterrupted run's. The step's median time, tokens/s, peak memory and
    a profiled step's busy share printed. Then the trained model packed to
    W4A8 and served phase 4's traffic (every request ok, the launches equal
    to the invariant), its perplexity in bf16 and W4A8 and the greedy
    streams' distinct tokens printed. Returns the serving run's launches."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import manager
    from repro_torch.configs import ARCHS, get_config, get_smoke
    from repro_torch.core.ptq import pack_params
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import TrainState
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optimizer import AdamWConfig, adamw_init
    from repro_torch.runtime import train

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 19)
    rows = []
    for arch in ARCHS:
        cfg = get_smoke(arch)
        rows.append((arch, *_card_vs_cpu(torch, cfg, api.init_params(cfg, SEED, "cpu"),
                                         _smoke_batch(cfg, rng), f"{arch} SMOKE")[:4]))
    log(f"[19 train] one training step (make_train_step: loss_fn with remat, autograd, "
        f"AdamW) on the card against the CPU, every SMOKE config, gradients leaf by leaf "
        f"(tolerance {GRAD_TOL} of a leaf's largest; block 0's residual detached must read "
        f"{GRAD_FAULT} x it): " + "; ".join(
            f"{a} loss {lc:.6g} / {lk:.6g}, grads {r:.3g}, fault {f:.3g}"
            for a, lc, lk, r, f in rows) + f" ({time.perf_counter() - t0:.1f} s)")

    # opt-125m at full width: one step card against CPU, then the loop
    t1 = time.perf_counter()
    cfg = get_config("opt-125m")
    params_cpu = api.init_params(cfg, SEED, "cpu")
    b, s = TRAIN_ONE_STEP
    one = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                 seed=SEED + 19)).batch(0)
    lc, lk, reading, fault, moved = _card_vs_cpu(torch, cfg, params_cpu, one, "opt-125m",
                                                 witness=True)
    log(f"    opt-125m at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, tied head, dense bf16, AdamW f32 moments, remat): one step at B {b} "
        f"x S {s}, loss CPU {lc:.6g} / card {lk:.6g}; gradients card against CPU {reading:.3g}, "
        f"the CPU in f64 against f32 {moved:.3g} (the card within {WITNESS_FACTOR} x it), block "
        f"0 detached {fault:.3g} (>= {GRAD_FAULT} x it) ({time.perf_counter() - t1:.1f} s)")

    oc = AdamWConfig(**TRAIN_OPT)
    dc = DataConfig(vocab_size=cfg.vocab_size, seed=SEED, **TRAIN_DATA)
    params = tree_map(lambda t: t.to(DEV), params_cpu)
    del params_cpu
    ckpt = ROOT / "build" / "phase19_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    saved = {}

    class Recording(manager.CheckpointManager):
        """The loop's manager, keeping a host copy of each tree it saves."""

        def maybe_save(self, step, tree):
            path = super().maybe_save(step, tree)
            if path:
                saved[step] = [t.detach().cpu().clone() for t in tree_leaves(tree)]
            return path

    loop = dict(ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY, log_every=10)
    train.CheckpointManager = Recording
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        final, hist = train.train_loop(cfg, dc, oc, train.TrainLoopConfig(
            steps=TRAIN_STEPS, **loop), device=DEV, state=TrainState(params, adamw_init(params, oc)))
        t_train = time.perf_counter() - t2
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        train.CheckpointManager = manager.CheckpointManager
    if sorted(saved) != [100, 200] or manager.latest_step(str(ckpt)) != TRAIN_STEPS:
        fail(f"checkpoints saved at {sorted(saved)}, newest {manager.latest_step(str(ckpt))}")
    for step, leaves in saved.items():
        back = tree_leaves(manager.restore(str(ckpt), final, step=step))
        if not all(a.device.type == torch.device(DEV).type and torch.equal(a.cpu(), b)
                   for a, b in zip(back, leaves)):
            fail(f"the checkpoint of step {step} restores other bits than were saved")
    first, last = hist[0], hist[-1]
    if not last["nll"] < first["nll"]:
        fail(f"training did not lower the nll: step {first['step']} {first['nll']:.4f}, "
             f"step {last['step']} {last['nll']:.4f}")
    shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:08d}")
    t3 = time.perf_counter()
    _, hist2 = train.train_loop(cfg, dc, oc, train.TrainLoopConfig(
        steps=TRAIN_CKPT_EVERY + 1, **loop), device=DEV)
    t_resume = time.perf_counter() - t3
    shutil.rmtree(ckpt, ignore_errors=True)
    want = next(h for h in hist if h["step"] == TRAIN_CKPT_EVERY)
    rel = abs(hist2[0]["loss"] - want["loss"]) / abs(want["loss"])
    if hist2[0]["step"] != TRAIN_CKPT_EVERY or rel > RESUME_RTOL:
        fail(f"resumed from step {TRAIN_CKPT_EVERY}: first logged step {hist2[0]['step']}, "
             f"loss {hist2[0]['loss']:.6g} against {want['loss']:.6g} ({rel:.3g} > {RESUME_RTOL}?)")
    data = SyntheticLM(dc)
    batch = {k: v.to(DEV) for k, v in data.batch(TRAIN_STEPS).items()}
    step_ms, busy_ms, wall_ms, n_launch = _timed_steps(torch, cfg, final, batch)
    tokens = TRAIN_DATA["seq_len"] * TRAIN_DATA["global_batch"]
    secs = sorted(h["sec"] for h in hist)
    log(f"    train_loop: {TRAIN_STEPS} steps over SyntheticLM (seq {TRAIN_DATA['seq_len']}, "
        f"batch {TRAIN_DATA['global_batch']}; lr {oc.lr}, warmup {oc.warmup}) in {t_train:.1f} "
        f"s on {card}: nll " + ", ".join(f"{h['step']} {h['nll']:.4f}" for h in hist[:-1:5])
        + f", {last['step']} {last['nll']:.4f}; grad_norm {first['grad_norm']:.3f} -> "
        f"{last['grad_norm']:.3f}; logged step time (host data included) median "
        f"{secs[len(secs) // 2]:.3f} s; peak memory {peak:.2f} GB; checkpoints at 100 and 200 "
        f"restored bit-identical; resumed from 100: loss {hist2[0]['loss']:.6g} against "
        f"{want['loss']:.6g} ({rel:.2g} relative, {t_resume:.1f} s)")
    log(f"    a training step (B {TRAIN_DATA['global_batch']} x S {TRAIN_DATA['seq_len']}, data on "
        f"the card): median {step_ms:.2f} ms over 5, {tokens / step_ms * 1e3:.0f} tokens/s; "
        f"profiled step {wall_ms:.2f} ms wall, device busy "
        + (f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)" if busy_ms else "not measured")
        + f", {n_launch} device launches; on {card}")

    # the trained model packed to W4A8 and served phase 4's traffic
    t4 = time.perf_counter()
    packed = pack_params(final.params, cfg, _serve_policy(), device=DEV)
    launches, results = phase_serve(torch, cfg, packed, tag="    [19 train] the trained opt-125m",
                                    profile=False)
    distinct = len({tok for r in results for tok in r.tokens})
    held = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seed=PTQ_EVAL_SEED, **TRAIN_DATA))
    batches = [held.batch(i) for i in range(TRAIN_PPL_BATCHES)]
    ppl_bf16 = _perplexity(final.params, cfg, batches, a_fmt=None)
    ppl_w4a8 = _perplexity(packed, cfg, batches)
    log(f"    the trained model: perplexity on {TRAIN_PPL_BATCHES} held-out batches (seed "
        f"{PTQ_EVAL_SEED}) bf16 {ppl_bf16:.4f}, W4A8 (RTN fp4_e2m1, M2, LoRC 8, fp8_e4m3 "
        f"activations) {ppl_w4a8:.4f} ({(ppl_w4a8 / ppl_bf16 - 1) * 100:+.2f} %); greedy streams "
        f"use {distinct} distinct tokens over {sum(len(r.tokens) for r in results)} (printed, "
        f"not gated; {time.perf_counter() - t4:.1f} s)")
    del packed, final
    torch.cuda.empty_cache()
    return launches


# -- phase 20: the contiguous caches ---------------------------------------------------
CONTIG_BUDGET_S = 45
CONTIG_ROWS, CONTIG_PROMPT, CONTIG_MAX_SEQ, CONTIG_STEPS = 4, 512, 1024, 64
CONTIG_PAGE = 64
CONTIG_SPLICE_STEPS = 8  # paged steps after each splice, on the contiguous path's tokens
CONTIG_STREAM_NEW = 32  # tokens of each request the paged bf16 Server serves
# the paged steps' logits after a splice, as a share of the contiguous
# path's largest |logit|, activations unquantized: bf16 pages at
# tests/test_kv_cache.py:360-362's bound; FP8 pages tighter than its 0.1,
# which no fault could read 10 times on this metric (two unrelated logit
# rows read ~1.4): an H100 read 0.0092 and 0.015, a CPU rehearsal at 256
# prompt tokens 0.0095 and 0.021, the faults 0.26-0.30 (PERF.md).
# The fault (steps one position short, each overwriting the previous slot)
# must read CONTIG_FAULT times the bound
CONTIG_RTOL = {"bf16": 2e-2, "fp8_e4m3": 2.5e-2}
CONTIG_FAULT = 10.0


def _contiguous_run(torch, cfg, params, prompts, max_seq, n_dec, tokens=None, patch=None,
                    timed=False, a_fmt="fp8_e4m3"):
    """``api.prefill`` of ``prompts`` (a (B, S) array) into contiguous caches
    of ``max_seq`` positions, then ``n_dec`` scalar-index decode steps fed
    ``tokens`` (a list of (B,) tensors) or, without them, each step's
    greedy tokens, with ``kernels.ops`` patched by ``patch``, activations
    quantized onto ``a_fmt`` where the model asks. Returns (the
    f32 logits of each program, the caches, the tokens fed, each program's
    launch counts, each program's ms when ``timed``)."""
    from repro_torch.models import api

    dev = params["embed"].device
    out, fed, counts, ms = [], [], [], []
    with _ops_patched(patch or {}):
        for i in range(n_dec + 1):
            before = _counts()
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32).to(dev)}
                logits, caches = api.prefill(params, cfg, batch, max_seq, a_fmt=a_fmt)
            else:
                nxt = out[-1].argmax(-1) if tokens is None else tokens[i - 1]
                fed.append(nxt)
                logits = api.decode_step(params, cfg, nxt.to(torch.int32)[:, None].to(dev),
                                         caches, prompts.shape[1] + i - 1, a_fmt=a_fmt)
            if timed:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float())
            after = _counts()
            counts.append({k: after[k] - before[k] for k in after})
    return out, caches, fed, counts, ms


def _held_calls(torch, cfg, params, prompts, max_seq, tokens, op, key, reading, fault):
    """``_contiguous_run`` of ``prompts`` and one scalar step a token row of
    ``tokens``, through the kernels, with every call of ``kernels.ops.<op>``
    also computed on its own operands by the plain version (the same
    function under PLAIN) and by a planted fault (``fault(call, x, w, *a,
    **kw)``: the faulty output, or None where it does not apply). Launches
    not counted. Returns ({``key(x, w, *a, **kw)``: [the kernel's readings,
    the fault's]}, each ``reading(got, plain)``, and the run's logits)."""
    from repro_torch.kernels import ops

    call, read, saved = getattr(ops, op), {}, _counts()

    def held(x, w, *a, **kw):
        y = call(x, w, *a, **kw)
        with _ops_patched(PLAIN):
            want = call(x, w, *a, **kw)
        bad = fault(call, x, w, *a, **kw)
        sound, faulty = read.setdefault(key(x, w, *a, **kw), ([], []))
        sound.append(reading(y, want))
        if bad is not None:
            faulty.append(reading(bad, want))
        return y

    out, *_ = _contiguous_run(torch, cfg, params, prompts, max_seq, len(tokens), tokens=tokens,
                              patch={op: held})
    _set_counts(saved)
    return read, out


def _fro(got, want):
    """||got - want|| / ||want|| (Frobenius, f64), as phase 5's readings."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def _launch_check(counts, want_pre, want_step, what):
    """Each program's launches: the prefill's ``want_pre``, every decode
    step's ``want_step`` (names not given: 0)."""
    zero = dict.fromkeys(counts[0], 0)
    for i, c in enumerate(counts):
        want = {**zero, **(want_pre if i == 0 else want_step)}
        if c != want:
            fail(f"{what}: program {i} launched {c}, want {want}")


def _share(torch, got, want):
    """max |got - want| as a share of max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _gaps(torch, logits):
    """Each row's top-2 gap over its largest |logit|."""
    top = logits.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / logits.abs().amax(-1)).tolist()


def phase_contiguous(torch, cfg, packed, card):
    """The contiguous-cache path (``api.prefill``, ``api.decode_step`` at a
    scalar index) on phase 4's packed opt-125m: CONTIG_ROWS prompts of
    CONTIG_PROMPT tokens into caches of CONTIG_MAX_SEQ, then CONTIG_STEPS
    greedy steps, each launching 72 row-1 kernels and no attention kernel
    (the cache is read by plain PyTorch, as the reference reads it in
    ``jnp``); tokens/s and the median step printed. Each row's prompt
    prefilled again with activations taken as they are (the packed weights
    on row 1's unquantized variant) and spliced (``kv_cache.splice_prefill``)
    into a bf16 and an FP8 page pool, then CONTIG_SPLICE_STEPS paged steps
    through row 2 on that path's tokens, logits within CONTIG_RTOL of its;
    the same steps one position short (each overwriting the previous slot)
    must read CONTIG_FAULT times that. Then the paged bf16
    Server serves the same prompts: each stream equals the contiguous one
    up to a tie at its first difference (top-2 gap under GAP_TOL). Returns
    (the main path's launches, the splices' paged launches by format,
    readings)."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.layers import PackedLinear
    from repro_torch.models.params import tree_map
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import serve

    t_start = time.perf_counter()
    n = cfg.n_layers
    prompts = np.random.default_rng(SEED + 20).integers(2, cfg.vocab_size,
                                                       (CONTIG_ROWS, CONTIG_PROMPT))
    _set_counts(dict.fromkeys(_counts(), 0))
    out, caches, toks, counts, ms = _contiguous_run(torch, cfg, packed, prompts, CONTIG_MAX_SEQ,
                                                    CONTIG_STEPS, timed=True)
    launches = _counts()
    _launch_check(counts, {"w4a8_fused": 6 * n}, {"w4a8_fused": 6 * n}, "phase 20 contiguous")
    if not all(bool(torch.isfinite(o).all()) for o in out):
        fail("phase 20: non-finite logits on the contiguous path")
    n_tok = CONTIG_ROWS * CONTIG_STEPS
    log(f"[20 contiguous] opt-125m, {CONTIG_ROWS} prompts of {CONTIG_PROMPT} tokens into "
        f"contiguous caches of {CONTIG_MAX_SEQ}, {CONTIG_STEPS} greedy scalar-index steps on "
        f"{card}: prefill {ms[0]:.1f} ms, median decode step {statistics.median(ms[1:]):.2f} ms, "
        f"{n_tok} tokens in {sum(ms[1:]) / 1e3:.2f} s = {n_tok / (sum(ms[1:]) / 1e3):.1f} "
        f"tokens/s (read, not gated); launches {launches} ({6 * n} row-1 a program, no "
        f"attention kernel)")

    # that run's prefill (M = 4 x 512 = 2048 rows a call) and first step
    # (M = 4) again on its tokens, every row-1 call held on its own operands
    # against the plain version: W4A8_TOL excesses (_excess, at most 1), and
    # the call with its top group's scale doubled (_doubled_top_group) must
    # read more than 1 in every call and CONTIG_FAULT in some call
    held, again = _held_calls(
        torch, cfg, packed, prompts, CONTIG_MAX_SEQ, toks[:1], "w4a8_matmul",
        key=lambda x, w: x.numel() // x.shape[-1], reading=_excess,
        fault=lambda call, x, w: call(x, _doubled_top_group(torch, w, x.reshape(-1, x.shape[-1]))))
    same = all(torch.equal(a, b) for a, b in zip(again, out))
    log(f"    the timed run's prefill and first step again, each row-1 call on its own operands "
        f"(logits equal to the timed run's: {same}): "
        + "; ".join(f"M={m}: {len(sound)} calls, kernel vs plain at most {max(sound):.3g} "
                    f"W4A8_TOL excesses (<= 1), top group scale doubled {min(bad):.3g}-"
                    f"{max(bad):.3g} (> 1 in every call, >= {CONTIG_FAULT} in one)"
                    for m, (sound, bad) in sorted(held.items(), reverse=True)))
    if sorted(held) != [CONTIG_ROWS, CONTIG_ROWS * CONTIG_PROMPT] or \
            any(len(sound) != 6 * n for sound, _ in held.values()):
        fail(f"phase 20: the held run made row-1 calls {[(m, len(v[0])) for m, v in held.items()]}")
    for m, (sound, bad) in held.items():
        if max(sound) > 1:
            fail(f"phase 20: row 1 at M={m} reads {max(sound):.3g} W4A8_TOL excesses against its "
                 f"plain version on the contiguous path's operands")
        if min(bad) <= 1 or max(bad) < CONTIG_FAULT:
            fail(f"phase 20: the doubled group scale at M={m} reads {min(bad):.3g}-{max(bad):.3g} "
                 f"excesses: the comparison cannot tell it from the sound weight")

    # the splice check runs the same packed weights with activations taken as
    # they are (row 1's unquantized variant, a_fmt None): with FP8
    # activations every one-ulp difference of the attention's rounding tips
    # FP8 codes and 12 layers amplify it to ~5 % of the largest |logit| on
    # random weights (F4), which would hide the splice's own error
    raw = tree_map(lambda t: dataclasses.replace(t, a_fmt=None) if isinstance(t, PackedLinear)
                   else t, packed, is_leaf=lambda x: isinstance(x, PackedLinear))
    ref, caches, toks, counts, _ = _contiguous_run(torch, cfg, raw, prompts, CONTIG_MAX_SEQ,
                                                   CONTIG_SPLICE_STEPS, a_fmt=None)
    _launch_check(counts, {"w4a8_fused": 6 * n}, {"w4a8_fused": 6 * n},
                  "phase 20 contiguous, activations unquantized")
    readings, splice_launches = {}, {}
    pp = CONTIG_PROMPT // CONTIG_PAGE + 1  # the prompt's pages and one for the decoded tokens
    table = torch.arange(CONTIG_ROWS * pp, dtype=torch.int32, device=DEV).reshape(CONTIG_ROWS, pp)
    lengths = lambda i: torch.full((CONTIG_ROWS,), CONTIG_PROMPT + i, dtype=torch.int32,
                                   device=DEV)
    for fmt in (None, "fp8_e4m3"):
        key = fmt or "bf16"
        pool = kvc.init_gqa_pool(n, CONTIG_ROWS * pp, CONTIG_PAGE, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, fmt, device=DEV)
        for r in range(CONTIG_ROWS):
            kvc.splice_prefill(pool, {k: v[:, r:r + 1] for k, v in caches[0]["kv"].items()},
                               table[r, :pp - 1].cpu(), CONTIG_PROMPT)
        faulty = {k: v.clone() for k, v in pool.items()}
        sound, fault = [], []
        _set_counts(dict.fromkeys(_counts(), 0))
        for i in range(CONTIG_SPLICE_STEPS):
            got = api.decode_step(raw, cfg, toks[i].to(torch.int32)[:, None], [pool],
                                  kvc.PagedState(table, lengths(i)), a_fmt=None)
            sound.append(_share(torch, got, ref[i + 1]))
        splice_launches[key] = _counts()
        for i in range(CONTIG_SPLICE_STEPS):  # each step one position short
            got = api.decode_step(raw, cfg, toks[i].to(torch.int32)[:, None], [faulty],
                                  kvc.PagedState(table, lengths(i - 1)), a_fmt=None)
            fault.append(_share(torch, got, ref[i + 1]))
        readings[key] = (max(sound), max(fault))
        want = {**dict.fromkeys(_counts(), 0), "w4a8_fused": 6 * n * CONTIG_SPLICE_STEPS,
                "paged_decode_attn": n * CONTIG_SPLICE_STEPS}
        if splice_launches[key] != want:
            fail(f"phase 20 splice ({key} pages): launches {splice_launches[key]}, want {want}")
    log(f"    splice_prefill into bf16 / fp8 pages, then {CONTIG_SPLICE_STEPS} paged steps "
        f"(row 2) on the contiguous tokens (activations unquantized on both paths): largest "
        f"|logit err| / largest |logit| "
        + ", ".join(f"{k} {v[0]:.4g} (bound {CONTIG_RTOL[k]})" for k, v in readings.items())
        + "; the steps one position short read "
        + ", ".join(f"{k} {v[1]:.4g} (>= {CONTIG_FAULT} x {CONTIG_RTOL[k]} required)"
                    for k, v in readings.items()))
    for key, (sound, fault) in readings.items():
        if sound > CONTIG_RTOL[key]:
            fail(f"phase 20: paged steps after the splice into {key} pages read {sound:.4g} > "
                 f"{CONTIG_RTOL[key]} of the contiguous path's largest |logit|")
        if fault < CONTIG_FAULT * CONTIG_RTOL[key]:
            fail(f"phase 20: the steps one position short read {fault:.4g} < {CONTIG_FAULT} x "
                 f"{CONTIG_RTOL[key]} on {key} pages: the comparison cannot tell them from "
                 f"sound steps")

    config = serve.ServerConfig(slots=CONTIG_ROWS, max_seq=CONTIG_MAX_SEQ, page_size=CONTIG_PAGE,
                                a_fmt="fp8_e4m3", cache=serve.CachePolicy())
    srv = serve.Server(packed, cfg, config)
    for r in range(CONTIG_ROWS):
        srv.submit(serve.Request(rid=r, prompt=prompts[r].tolist(), max_new=CONTIG_STREAM_NEW))
    got = {res.rid: list(res.tokens) for res in srv.run_until_drained()}
    streams = [[int(o[r].argmax()) for o in out[:CONTIG_STREAM_NEW]] for r in range(CONTIG_ROWS)]
    gaps = [_gaps(torch, o) for o in out[:CONTIG_STREAM_NEW]]
    ties = []
    for r in range(CONTIG_ROWS):
        if got.get(r) is None or len(got[r]) != CONTIG_STREAM_NEW:
            fail(f"phase 20: the paged bf16 Server's request {r} emitted {got.get(r)}")
        i = next((i for i, (a, b) in enumerate(zip(got[r], streams[r])) if a != b), None)
        if i is not None:
            if gaps[i][r] >= GAP_TOL:
                fail(f"phase 20: request {r}'s paged stream leaves the contiguous one at token "
                     f"{i}, where its top-2 gap is {gaps[i][r]:.3g} >= {GAP_TOL}")
            ties.append((r, i, gaps[i][r]))
    distinct = len({t for s in streams for t in s})
    wall = time.perf_counter() - t_start
    log(f"    paged bf16 Server (mixed engine, prefix cache), the same {CONTIG_ROWS} prompts, "
        f"{CONTIG_STREAM_NEW} tokens each: streams equal the contiguous path's but for ties "
        f"{ties} (first differences under a top-2 gap of {GAP_TOL}); {distinct} distinct "
        f"tokens; phase {wall:.1f} s")
    if wall > CONTIG_BUDGET_S:
        fail(f"phase 20 took {wall:.1f} s > {CONTIG_BUDGET_S} s")
    return launches, splice_launches, readings, held


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
    gemm, attn, frozen, batched, mla, moe, olmoe_attn, recurrent, ds = phase_kernels(torch)
    lap(3)
    cfg, packed, t_pack = _opt_125m()
    log(f"    opt-125m init + W4A8 pack on the card: {t_pack:.1f} s")
    launches, _ = phase_serve(torch, cfg, packed)
    lap(4)
    phase_cpu(torch, cfg, packed)
    lap(5)
    launches_6, live, streams_6 = phase_prefix(torch, cfg, packed, card)
    lap(6)
    launches_7, live_7 = phase_mla(torch, card)
    lap(7)
    *_, (mla_contig, mla_spliced, mla_held) = phase_mla_cpu(torch)
    lap(8)
    olmoe, packed_9, launches_9, live_9 = phase_moe(torch, card)
    lap(9)
    *_, (moe_contig, moe_held) = phase_moe_cpu(torch, olmoe, packed_9)
    lap(10)
    del packed_9
    api_launches, act, split, versus, faults, flash = phase_kernel_api(torch)
    lap(11)
    launches_12 = phase_pressure(torch, cfg, packed, card)
    lap(12)
    t13 = time.perf_counter()
    phase_sampling(torch, cfg, packed, card, streams_6)
    lap(13)
    if time.perf_counter() - t13 > SAMPLING_BUDGET_S:
        fail(f"phase 13 took {time.perf_counter() - t13:.1f} s > {SAMPLING_BUDGET_S} s")
    log(f"    (before phase 20: {_mem(torch)})")
    contig, contig_splice, contig_read, contig_held = phase_contiguous(torch, cfg, packed, card)
    lap(20)
    log(f"    (after phase 20: {_mem(torch)})")
    del packed
    t14 = time.perf_counter()
    phase_ptq(torch, card)
    lap(14)
    if time.perf_counter() - t14 > PTQ_BUDGET_S:
        fail(f"phase 14 took {time.perf_counter() - t14:.1f} s > {PTQ_BUDGET_S} s")
    t15 = time.perf_counter()
    launches_15 = phase_dense(torch, card)
    lap(15)
    if time.perf_counter() - t15 > DENSE_BUDGET_S:
        fail(f"phase 15 took {time.perf_counter() - t15:.1f} s > {DENSE_BUDGET_S} s")
    t16 = time.perf_counter()
    launches_16, live_16 = phase_encdec(torch, card)
    lap(16)
    if time.perf_counter() - t16 > ENCDEC_BUDGET_S:
        fail(f"phase 16 took {time.perf_counter() - t16:.1f} s > {ENCDEC_BUDGET_S} s")
    t17 = time.perf_counter()
    launches_17 = phase_recurrent(torch, card)
    lap(17)
    if time.perf_counter() - t17 > RECURRENT_BUDGET_S:
        fail(f"phase 17 took {time.perf_counter() - t17:.1f} s > {RECURRENT_BUDGET_S} s")
    t18 = time.perf_counter()
    launches_18, live_18, loss_18 = phase_deepseek(torch, card, ds)
    lap(18)
    if time.perf_counter() - t18 > DEEPSEEK_BUDGET_S:
        fail(f"phase 18 took {time.perf_counter() - t18:.1f} s > {DEEPSEEK_BUDGET_S} s")
    t19 = time.perf_counter()
    launches_19 = phase_train(torch, card)
    lap(19)
    if time.perf_counter() - t19 > TRAIN_BUDGET_S:
        fail(f"phase 19 took {time.perf_counter() - t19:.1f} s > {TRAIN_BUDGET_S} s")

    for r in gemm.values():
        r["kind"] = "bf16"
    for r in (*attn.values(), frozen, *olmoe_attn.values()):
        r["kind"] = "f32"
    for r in (*batched.values(), *moe.values(), *mla.values()):  # MLA: exact bf16 products
        r["kind"] = "bf16"
    for r in recurrent["gemm"].values():
        r["kind"] = "bf16"
    recurrent["attn"]["kind"] = "f32"
    for part in ("gemm", "batched", "moe", "mla"):
        for r in ds[part].values():
            r["kind"] = "bf16"
    # one DeepSeek-V3 decode step at 4 slots, 4 of 61 layers: per MLA layer
    # wq_a, wq_b, wkv_a and wo, wv_b's and wk_b's per-head GEMMs and one
    # frozen latent decode; per dense layer gate, up and down; the MoE
    # layer's shared gate, up and down and its 3 expert GEMMs over 256 slabs
    ds_step = ([ds["gemm"][(4, k, n)] for k, n in DS_MLA_GEMMS] * DS_SERVED_LAYERS
               + [ds["gemm"][(4, k, n)] for k, n in DS_DENSE_GEMMS] * 3
               + [ds["gemm"][(4, k, n)] for k, n in DS_SHARED_GEMMS])
    ds_per = (f"one DeepSeek-V3 decode step ({DS_SERVED_LAYERS} of 61 layers, B=4); launches from "
              "phase 18's serving run, loss_launches from its loss_fn pass")
    xlstm_step = [recurrent["gemm"][(4, k, n)] for k, n in XLSTM_PAIR_GEMMS] * 6
    zamba2_step = ([recurrent["gemm"][(4, k, n)] for k, n in ZAMBA2_LAYER_GEMMS] * 38
                   + [recurrent["gemm"][(4, k, n)] for k, n in ZAMBA2_SHARED_GEMMS] * 7)
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
                             f"from phase 7 ({MLA_SERVED_LAYERS} of 62 layers)"},
         "olmoe": {**entry(olmoe_layer, 16), "launches": launches_9["w4a8_fused"],
                   "per": "one OLMoE-1B-7B decode step: 64 launches at M=4, 2048->2048; "
                          "launches from phase 9"},
         "pressure": {"launches": launches_12["w4a8_fused"],
                      "per": "phase 12: phase 6's traffic on a 16-page pool, stolen and resumed"},
         "dense": {"launches": {k: v["w4a8_fused"] for k, v in launches_15.items()},
                   "per": "phase 15: 2 requests on each dense / VLM config at 2 layers"},
         "encdec": {"launches": launches_16["w4a8_fused"],
                    "per": "phase 16: whisper-tiny, 8 requests (encoder and cross K/V at "
                           "M=1500 at each admission)"},
         "recurrent": {
             "xlstm": {**entry(xlstm_step, 1), "launches": launches_17["xlstm-125m"]["w4a8_fused"],
                       "per": "one xlstm-125m decode step: 42 launches at M=4 (7 a mLSTM / "
                              "sLSTM pair); launches from phase 17, fully backed"},
             "zamba2": {**entry(zamba2_step, 1),
                        "launches": launches_17["zamba2-1.2b"]["w4a8_fused"],
                        "per": "one zamba2-1.2b decode step: 118 launches at M=4 (in_proj "
                               "2048->8384 and out_proj a Mamba2 layer, q, k, v, o, up, down a "
                               "shared-block invocation); launches from phase 17, fully backed"},
             "max_abs_err_m128": max(r["max_abs_err"] for r in recurrent["gemm"].values())},
         "train": {"launches": launches_19["w4a8_fused"],
                   "per": "phase 19: the opt-125m trained on the card, packed, phase 4's "
                          "traffic"},
         "contiguous": {"launches": contig["w4a8_fused"],
                        "mla_launches": mla_contig["w4a8_fused"],
                        "moe_launches": moe_contig["w4a8_fused"],
                        "splice_launches": {k: v["w4a8_fused"] for k, v in contig_splice.items()},
                        "held_excess": {m: max(v[0]) for m, v in contig_held.items()},
                        "held_fault_excess": {m: [min(v[1]), max(v[1])]
                                              for m, v in contig_held.items()},
                        "per": f"phase 20: opt-125m over contiguous caches, {CONTIG_ROWS} x "
                               f"{CONTIG_PROMPT}-token prefill + {CONTIG_STEPS} scalar-index "
                               "steps, 72 launches a program; mla_launches phase 8's (MiniCPM3, "
                               "2 layers, prefill + 2 steps), moe_launches phase 10's (OLMoE, 2 "
                               "layers, prefill + 1 step); splice_launches the paged steps after "
                               "each splice; held_excess: the prefill's (M=2048) and first "
                               "step's (M=4) calls again, each against its plain version on "
                               "its own operands, in W4A8_TOL excesses; held_fault_excess: the "
                               "same with the call's top group scale doubled"},
         "deepseek": {**entry(ds_step, 1), "launches": launches_18["w4a8_fused"],
                      "loss_launches": loss_18["w4a8_fused"],
                      "per": f"{ds_per}: 28 launches at M=4 (wq_a 7168->1536, wq_b 1536->24576, "
                             "wkv_a 7168->576 and wo 16384->7168 a layer; gate, up 7168->18432 and "
                             "down 18432->7168 a dense layer; the shared expert's 7168->2048, "
                             "2048->7168); mtp/proj 14336->7168 and M=128 checked",
                      "max_abs_err_all_shapes": max(r["max_abs_err"] for r in ds["gemm"].values())}},
        {"name": "paged_decode_attn", "route": "cuda", "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:131",
         "launches": launches["paged_decode_attn"],
         **entry([a], 12), "max_abs_err": max(r["max_abs_err"] for r in attn.values()),
         "per": "12 launches (one per layer), fp8 pages, B=4, contexts 2048/1337/300/1",
         "olmoe": per_olmoe_attn(olmoe_attn["fp8_e4m3"],
                                 "16 launches (one per layer), fp8 pages, KV=H=16, hd 128, B=4, "
                                 "contexts 2048/1337/300/1; phase 9 serves the frozen variant"),
         "train": {"launches": launches_19["paged_decode_attn"],
                   "per": "phase 19: the opt-125m trained on the card, packed, phase 4's "
                          "traffic"},
         "encdec": {"launches": launches_16["paged_decode_attn"], "live_max_abs_err": live_16[0],
                    "fault_enc_lengths_one_short": live_16[1],
                    "per": "phase 16: whisper-tiny's cross-attention, 4 launches a decode step "
                           "over 24 cross pages at kv_len 1500"},
         "splice": {"launches": {k: v["paged_decode_attn"] for k, v in contig_splice.items()},
                    "logit_share": {k: v[0] for k, v in contig_read.items()},
                    "fault_one_position_short": {k: v[1] for k, v in contig_read.items()},
                    "per": f"phase 20: {CONTIG_SPLICE_STEPS} paged steps after each splice_prefill "
                           "of the contiguous caches into bf16 and fp8 pages, 12 launches a step; "
                           "logit_share: the largest |logit err| over the contiguous path's "
                           "largest |logit|"},
         "recurrent": {**entry([recurrent["attn"]], 7),
                       "launches": launches_17["zamba2-1.2b"]["paged_decode_attn"],
                       "per": "zamba2-1.2b's shared block, 7 launches a decode step (one an "
                              "invocation), fp8 pages, H = KV = 32, hd 64, B=4, contexts "
                              "2048/1337/300/1; launches from phase 17, fully backed"}},
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
                      "per": "phase 12: phase 6's traffic on a 16-page pool, stolen and resumed"},
         "dense": {"launches": {k: v["paged_decode_attn_frozen"] for k, v in launches_15.items()},
                   "per": "phase 15: 2 requests on each dense / VLM config at 2 layers"},
         "encdec": {"launches": launches_16["paged_decode_attn_frozen"],
                    "per": "phase 16: whisper-tiny's decoder self-attention"}},
        {**entry([batched[False]], 62, name="w4a8_fused_batched", route="cuda",
                 source="src/repro_torch/csrc/w4a8_fused.cu",
                 replaces="src/repro/kernels/w4a8_fused.py:169 (batched, a_fmt=None)",
                 launches=launches_7["w4a8_fused_batched"],
                 per="one MiniCPM3-4B decode step: 62 launches of wv_b (E=40, M=4, 256->64); "
                     f"launches from phase 7 ({MLA_SERVED_LAYERS} of 62 layers)"),
         "deepseek": {**entry([ds["batched"][False]], DS_SERVED_LAYERS),
                      "launches": launches_18["w4a8_fused_batched"],
                      "per": f"{ds_per}: 4 launches of wv_b (E=128, M=4, 512->128)"},
         "contiguous": {"launches": mla_contig["w4a8_fused_batched"],
                        "splice_launches": mla_spliced["w4a8_fused_batched"],
                        "held_share": max(mla_held["wv_b"][0]),
                        "per": "phase 8's contiguous run: MiniCPM3 2 layers, 2 scalar-index "
                               "steps, 1 launch of wv_b a layer a step; splice_launches the "
                               "paged step after the splice; held_share: each call against its "
                               "plain version on its own operands, ||err|| / ||output||"}},
        {**entry([batched[True]], 62, name="w4a8_fused_transposed", route="cuda",
                 source="src/repro_torch/csrc/w4a8_fused.cu",
                 replaces="src/repro/kernels/w4a8_fused.py:169 (transpose_w=True, a_fmt=None)",
                 launches=launches_7["w4a8_fused_transposed"],
                 per="one MiniCPM3-4B decode step: 62 launches of wk_b (E=40, M=4, 64->256); "
                     f"launches from phase 7 ({MLA_SERVED_LAYERS} of 62 layers)"),
         "deepseek": {**entry([ds["batched"][True]], DS_SERVED_LAYERS),
                      "launches": launches_18["w4a8_fused_transposed"],
                      "per": f"{ds_per}: 4 launches of wk_b (E=128, M=4, 128->512)"},
         "contiguous": {"launches": mla_contig["w4a8_fused_transposed"],
                        "splice_launches": mla_spliced["w4a8_fused_transposed"],
                        "held_share": max(mla_held["wk_b"][0]),
                        "held_fault_no_lorc": max(mla_held["wk_b"][1]),
                        "per": "phase 8's contiguous run: MiniCPM3 2 layers, 2 scalar-index "
                               "steps, 1 launch of wk_b a layer a step; splice_launches the "
                               "paged step after the splice; held_share: each call against its "
                               "plain version on its own operands, ||err|| / ||output||; "
                               "held_fault_no_lorc: the same without wk_b's LoRC factors"}},
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
                                          for (w, m), r in moe.items()},
         "deepseek": {"launches": launches_18["w4a8_fused_batched_fp8"],
                      "loss_launches": loss_18["w4a8_fused_batched_fp8"],
                      "per": f"{ds_per}: 3 launches (wu, wg 7168->2048, wd 2048->7168) over "
                             "E=256 slabs of M=4 rows, each token's row nonzero in 8 slabs; "
                             "checked, not timed (PERF.md keeps their times)",
                      "max_abs_err": max(r["max_abs_err"] for r in ds["moe"].values())},
         "contiguous": {"launches": moe_contig["w4a8_fused_batched_fp8"],
                        "held_share": {k: max(v[0]) for k, v in moe_held.items()},
                        "held_fault_expert_swap": {k: max(v[1]) for k, v in moe_held.items()},
                        "per": "phase 10's contiguous run: OLMoE 2 layers, 2 x 64-token prefill "
                               "+ 1 scalar-index step, 3 launches a layer a program over the "
                               "grouped dispatch's capacity slabs; held_share: each call against "
                               "its plain version on its own operands, ||err|| / ||output||; "
                               "held_fault_expert_swap: the same with expert 0 reading expert "
                               "1's weights"}},
        {**entry([mla[("fp8_e4m3", True)]], 62, name="paged_mla_decode_attn", route="cuda",
                 source="src/repro_torch/csrc/mla_decode_attn.cu",
                 replaces="src/repro/kernels/decode_attn.py:287",
                 launches=launches_7["paged_mla_decode_attn"]
                 + launches_7["paged_mla_decode_attn_frozen"],
                 per="one MiniCPM3-4B decode step: 62 launches of the frozen variant, B=4, "
                     "H=40, r=256, dr=32, page 64, contexts 2048/1337/300/1 with half of each "
                     "row's full pages frozen; launches (all variants) from phase 7 "
                     f"({MLA_SERVED_LAYERS} of 62 layers)"),
         "max_abs_err": max(max(r["max_abs_err"] for r in mla.values()), live_7[0]),
         "variants_ms": {f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''}": r["ms"]
                         for (fmt, fz), r in mla.items()},
         "variants_device_ms": {f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''}":
                                r["device_ms"] for (fmt, fz), r in mla.items()},
         "fault_combine_drops_last_split": mla[("fp8_e4m3", True)]["fault_combine_drops_last_split"],
         "splice": {"launches": mla_spliced["paged_mla_decode_attn"],
                    "per": "phase 8: one paged step over FP8 latent pages after splice_prefill "
                           "of MiniCPM3's contiguous caches (2 layers)"},
         "deepseek": {**entry([ds["mla"][("fp8_e4m3", True)]], DS_SERVED_LAYERS),
                      "launches": launches_18["paged_mla_decode_attn"]
                      + launches_18["paged_mla_decode_attn_frozen"],
                      "max_abs_err": max(max(r["max_abs_err"] for r in ds["mla"].values()),
                                         live_18[0]),
                      "fault_live_ckv_fz_shift": live_18[1],
                      "variants_device_ms": {f"{fmt or 'bf16'}{' + fp4 frozen' if fz else ''}":
                                             r["device_ms"] for (fmt, fz), r in ds["mla"].items()},
                      "per": f"{ds_per}: 4 launches of the frozen variant, H=128, r=512, dr=64, "
                             "page 64, contexts 2048/1337/300/1 with half of each row's full "
                             "pages frozen (the generic path)"}},
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
