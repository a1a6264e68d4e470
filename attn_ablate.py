#!/usr/bin/env python3
"""Where the time of the attention kernels and of act_quant goes, by
ablation.

    python3 attn_ablate.py [decode_attn] [flash_attn] [mla_decode_attn] [act_quant]

(all four when none is named). Each variant is the kernel's source under
``src/repro_torch/csrc/`` with one part cut out (or one choice changed) by
a text edit, compiled with the build's own flags into
``build/ablate/<source>/<variant>/``; every variant is timed by
``chip_smoke._device_ms`` (device time from CUDA graphs, cold L2) through
the unchanged wrapper, in turns (all variants, then all again in
reverse). The cut variants compute wrong outputs: they are timed, not
checked (the kernel as it is is held against its plain version first).

``decode_attn`` (rows 2, 2b), at phase 3's timed shapes: row 2 at
opt-125m's KV 12 of hd 64 and OLMoE-1B-7B's KV 16 of hd 128, row 2b at KV
16 of hd 128, contexts 2048/1337/300/1:

- ``base``: the kernel as it is;
- ``placed_off``: every code through ``decode_code`` (no bit placement);
- ``no_pdl``: the combine launched without programmatic dependence;
- ``no_trigger``: the split kernel does not release the combine early;
- ``no_combine``: no combine launch;
- ``no_attend``: pages staged, nothing attended (merge and combine run);
- ``empty``: every split block exits at once (the launch floor);

then ``base`` again under other block budgets of ``decode_attn_plan``
(twice the plan's, and one page a split).

``flash_attn`` (row 6), at phase 11's four causal bf16 shapes:

- ``no_stage``: the ring copies no tile after the first (stale tiles);
- ``no_exp``: p is the score itself (no ex2);
- ``no_qk`` / ``no_pv``: no Q . K^T / no P . V mma.sync;
- ``narrow``: 64-row q tiles at every grid;
- ``two_stages``: a 2-stage ring at 128-row tiles;
- ``one_slab``: one 16-row slab a warp at hd 96 too (eight warps);
- ``kv64``: 64-key KV tiles everywhere.

``mla_decode_attn`` (row 3), at phase 3's MLA_SHAPE over FP8 + FP4 frozen,
FP8 and bf16 pages:

- ``placed_off``: every code through ``decode_code`` (still exact);
- ``no_decode``: no operand decode (stale operands);
- ``no_scores`` / ``no_pv``: no score / no P . V mma.sync over the latent;
- ``two_pieces``: p * post_c in two bf16 pieces, not three;
- ``no_combine``: no combine launch;
- ``empty``: every split block exits at once (the launch floor).

``act_quant`` (row 4), at phase 11's timed shapes (bf16 -> fp8_e4m3):

- ``no_div``: x * scale, not x / scale (no IEEE division);
- ``no_round``: x / scale, not rounded onto the grid;
- ``copy``: x * scale, not rounded (neither);
- ``no_absmax``: the registers' vectors left out of the absmax;
- ``plain_both``: bf16 loads and the stores without the evict-first hint;
- ``round_branch``: ``round_to_grid`` as first written (the same values:
  early returns for NaN and zero, powers of two clamped to the f32 range);
- ``absmax_tree``: a bf16 chunk's absmax one element at a time through
  ``nan_max``, not by the packed bf16 max;
- ``bf16x8``: bf16 read 8 elements (16 bytes) an access, under the same
  plan: each of a warp's two 16-byte stores of a vector then half-fills 32
  sectors 32 bytes apart, where 4-element vectors store 512 contiguous
  bytes an instruction;
- ``empty``: every block exits at once (the launch floor of its grid);

then the same bytes moved by PyTorch's bf16 -> f32 cast (``x.float()``:
x read once, 4 bytes an element written, no arithmetic; a yardstick of
the copy rate, not the same function), and ``base`` under other launch
plans of ``act_quant_plan`` (its ``per_thread`` and ``cluster``
overrides): each thread holding twice or half the vectors, each row over
twice or half the blocks (the block's threads following).

Prints one JSON line of microseconds a launch, each variant's readings in
turn order.
"""
import ctypes
import json
import subprocess
import sys

import chip_smoke as cs

CSRC = cs.SRC / "repro_torch" / "csrc"
OUT = cs.ROOT / "build" / "ablate"
ATTEND = "float (&m)[G], float (&l)[G], float (&acc)[G][DL]) {\n"  # attend()'s signature
AQ_ROUND = "round_to_grid(c.at(k) / sc, g);"  # chunk_quantize's element
AQ_GRID = """  const float a = fabsf(v);
  const int e = max(g.min_exp, min(g.max_exp, (__float_as_int(a) >> 23) - 127));
  const float inv_step = __int_as_float((127 + g.man_bits - e) << 23);
  const float step = __int_as_float((127 - g.man_bits + e) << 23);
  const float q = fminf(fmaxf(rintf(v * inv_step) * step, -g.max_value), g.max_value);
  return v != v ? v : a == 0.f ? 0.f : q;
"""  # round_to_grid's body
AQ_GRID_BRANCH = """  if (v != v) return v;
  float a = fabsf(v);
  if (a == 0.f) return 0.f;
  int e = ((__float_as_int(fmaxf(a, 1e-38f)) >> 23) & 0xff) - 127;
  e = max(g.min_exp, min(g.max_exp, e));
  float q = rintf(v * pow2i(g.man_bits - e)) * pow2i(e - g.man_bits);
  return fminf(fmaxf(q, -g.max_value), g.max_value);
"""  # the same values as first ported: early returns, clamped powers of two
AQ_FLOAT_CHUNK = "template <>\nstruct Chunk<float, 4> {\n"
AQ_BF16X8 = """template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { w = ld_stream16(p); }
  __device__ __forceinline__ float at(int i) const {
    const uint32_t u = i < 2 ? w.x : i < 4 ? w.y : i < 6 ? w.z : w.w;
    return __uint_as_float(i & 1 ? u & 0xffff0000u : u << 16);
  }
  __device__ __forceinline__ float absmax() const {
    __nv_bfloat162 h[4];
    memcpy(h, &w, 16);
    const __nv_bfloat162 m = __hmax2_nan(__hmax2_nan(__habs2(h[0]), __habs2(h[1])),
                                         __hmax2_nan(__habs2(h[2]), __habs2(h[3])));
    return nan_max(__low2float(m), __high2float(m));
  }
};

"""  # 8 bf16 a 16-byte load: a thread's two 16-byte stores 32 bytes apart
AQ_START = "  const int t = threadIdx.x, lane = t & 31, G = blockDim.x, C = a.cluster;\n"
AQ_LOAD = "  return __ldcs(reinterpret_cast<const uint2*>(p));"  # ld_stream8's body
AQ_STORE = "  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));"  # st_stream4's
CUTS = {
    "decode_attn": {
        "base": [],
        "placed_off": [("    fast = fast && (c == 0.f", "    fast = false && (c == 0.f")],
        "no_pdl": [("programmaticStreamSerializationAllowed = 1;",
                    "programmaticStreamSerializationAllowed = 0;", "split_combine.cuh")],
        "no_trigger": [('  asm volatile("griddepcontrol.launch_dependents;\\n");', "")],
        "no_combine": [("  return launch_split_combine(",
                        "  if (B > 0) return 0;\n  return launch_split_combine(")],
        "no_attend": [(ATTEND, ATTEND + "  if (ns > 0) return;\n")],
        "empty": [("  constexpr bool VEC = LT != 0;\n",
                   "  constexpr bool VEC = LT != 0;\n  if (a.H > 0) return;\n")],
    },
    "flash_attn": {
        "base": [],
        "no_stage": [("    if (j + NST - 1 < ntiles) stage_kv(j + NST - 1, (j + NST - 1) % NST);\n",
                      "")],
        "no_exp": [("        const float p = MMA ? ex2(fmaf(sm[i], sl2, -mb[r])) : "
                    "expf(sm[i] - m[ms][r]);\n", "        const float p = sm[i];\n")],
        "no_qk": [("            mma_bf16(s[ms] + 8 * np, qa[ms], bk[0], bk[1]);\n"
                   "            mma_bf16(s[ms] + 8 * np + 4, qa[ms], bk[2], bk[3]);\n", "")],
        "no_pv": [("            mma_bf16(o[ms] + 8 * np, pa[ms], bv[0], bv[1]);\n"
                   "            mma_bf16(o[ms] + 8 * np + 4, pa[ms], bv[2], bv[3]);\n", "")],
        "narrow": [("    if ((long long)B * a.H * ((a.S + 127) / 128) >= SMS) return "
                    "launch<T, HDP, DVP, 128>(a, B, s);\n", "")],
        "two_stages": [("  static constexpr int STAGES = MMA && BQ == 128 ? 3 : 2;\n",
                        "  static constexpr int STAGES = 2;\n")],
        "one_slab": [("  static constexpr int MS = MMA && BQ == 128 && HDP == 96 ? 2 : 1;\n",
                      "  static constexpr int MS = 1;\n")],
        "kv64": [("  static constexpr int BKV = MMA && MS == 1 ? 128 : 64;\n",
                  "  static constexpr int BKV = 64;\n")],
    },
    "mla_decode_attn": {
        "base": [],
        "placed_off": [("      const bool fast = 1 - st.fmt.bias - sh >= -126",
                        "      const bool fast = false && 1 - st.fmt.bias - sh >= -126")],
        "no_decode": [("    for (int i = tid; i < TILE * CH; i += THREADS) {",
                       "    for (int i = tid; i < 0 * TILE * CH; i += THREADS) {")],
        "no_scores": [("      mma_bf16(ac[0], qf, kf[0], kf[1]);\n"
                       "      mma_bf16(ac[1], qf, kf[2], kf[3]);\n", "")],
        "no_pv": [("      for (int k = 0; k < PIECES; ++k) mma_bf16(o[c], pa[k], b0, b1);\n", "")],
        "two_pieces": [("constexpr int PIECES = 3;", "constexpr int PIECES = 2;")],
        "no_combine": [("  return launch_split_combine(",
                        "  if (B > 0) return 0;\n  return launch_split_combine(")],
        "empty": [("  if (n <= 0) return;\n", "  if (n <= 0 || a.H > 0) return;\n")],
    },
    "act_quant": {
        "base": [],
        "no_div": [(AQ_ROUND, "round_to_grid(c.at(k) * sc, g);")],
        "no_round": [(AQ_ROUND, "c.at(k) / sc;")],
        "copy": [(AQ_ROUND, "c.at(k) * sc;")],
        "no_absmax": [("      if (t + i * G < p.n) mx = nan_max(c[i].absmax(), mx);\n", "      ;\n")],
        "plain_both": [(AQ_LOAD, "  return *reinterpret_cast<const uint2*>(p);", "quant_common.cuh"),
                       (AQ_STORE, "  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);",
                        "quant_common.cuh")],
        "round_branch": [(AQ_GRID, AQ_GRID_BRANCH, "quant_common.cuh")],
        "absmax_tree": [("  __device__ __forceinline__ float absmax() const { return bf16x4_absmax(w); }",
                         "  __device__ __forceinline__ float absmax() const {\n"
                         "    float m = 0.f;\n"
                         "    for (int k = 0; k < 4; ++k) m = nan_max(fabsf(at(k)), m);\n"
                         "    return m;\n  }")],
        "bf16x8": [(AQ_FLOAT_CHUNK, AQ_BF16X8 + AQ_FLOAT_CHUNK),
                   ("    st_stream4(q, o[0], o[1], o[2], o[3]);\n",
                    "    for (int k = 0; k < V; k += 4) st_stream4(q + k, o[k], o[k + 1], o[k + 2], "
                    "o[k + 3]);\n"),
                   ("  if (vec == 4) return launch_held<T, 4>(a, per_thread, blocks, threads, s);",
                    "  if (vec == 4) return launch_held<T, sizeof(T) == 2 ? 8 : 4>(a, per_thread, "
                    "blocks, threads, s);")],
        "empty": [(AQ_START, AQ_START + "  if (a.rows > 0) return;\n")],
    },
}


def _build(build, source):
    """Every variant's library of ``source``, one nvcc each, in parallel. A
    cut names the file it edits when that is a shared header: the edited
    copy sits beside the variant's source, which includes it first."""
    procs = {}
    for name, cuts in CUTS[source].items():
        out_dir = OUT / source / name
        out_dir.mkdir(parents=True, exist_ok=True)
        texts = {}
        for old, new, *where in cuts:
            fname = where[0] if where else f"{source}.cu"
            text = texts.get(fname, (CSRC / fname).read_text())
            if text.count(old) != 1:
                cs.fail(f"variant {name}: the cut {old!r} is not in {fname} exactly once")
            texts[fname] = text.replace(old, new)
        texts.setdefault(f"{source}.cu", (CSRC / f"{source}.cu").read_text())
        for fname, text in texts.items():
            (out_dir / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, f"-I{CSRC}", "-o", str(out_dir / "lib.so"),
             str(out_dir / f"{source}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{source} variant {name} does not build:\n{out}")
        if name == "base":  # each instantiation's registers and spills, by name
            for r in cs._ptxas_table(out, build.nvcc_path()):
                cs.log(f"    {source}: {r['fn']}: {r['registers']} registers, spill stores "
                       f"{r['spill_stores']} B, loads {r['spill_loads']} B")
    return {name: ctypes.CDLL(str(OUT / source / name / "lib.so")) for name in CUTS[source]}


def _cases(torch, gen, source):
    """{case: callable that checks the kernel as it is, then returns its launch}."""
    if source == "decode_attn":
        return {"row2 KV=12 hd=64": lambda: cs._attn_check(torch, "fp8_e4m3", gen, 0, 12, 64)[-3],
                "row2 KV=16 hd=128": lambda: cs._attn_check(torch, "fp8_e4m3", gen, 0, 16,
                                                            128)[-3],
                "row2b KV=16 hd=128": lambda: cs._attn_frozen_check(torch, gen, 128, 0, 16)[-3]}
    if source == "flash_attn":
        return {f"row6 {tag}": (lambda h=h, hd=hd, dv=dv, s=s, tag=tag: cs._flash_check(
            torch, *cs._flash_inputs(torch, gen, 1, s, s, h, hd, dv, torch.bfloat16), True,
            f"{tag} causal bf16")[0]) for tag, h, hd, dv, s in cs.FLASH_SHAPES}
    if source == "act_quant":
        return {f"row4 ({m}, {d})": (lambda m=m, d=d: _act_quant_launch(torch, gen, m, d))
                for m, d in cs.ACT_QUANT_SHAPES}
    shape = [cs.MLA_SHAPE[k] for k in ("b", "h", "r", "dr", "page", "lens")]
    return {f"row3 {fmt or 'bf16'}{' + fp4 frozen' if fz else ''}":
            (lambda fmt=fmt, fz=fz: cs._mla_check(torch, gen, fmt, fz, *shape)[7])
            for fmt, fz in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False))}


def _replanned(plan, per_scale, c_scale):
    """``plan`` with each thread's vectors and the row's blocks scaled (the
    threads of a block following them) where the kernel still holds the row
    in registers that way; else the plan as it is."""
    from repro_torch.kernels.act_quant import HELD, MAX_CLUSTER

    def replan(rows, d, elem_bytes, aligned):
        p = plan(rows, d, elem_bytes, aligned)
        per = int(p.per_thread * per_scale)
        c = max(1, min(MAX_CLUSTER, int(p.cluster * c_scale)))
        if per not in HELD:
            return p
        r = plan(rows, d, elem_bytes, aligned, per_thread=per, cluster=c)
        return r if r.threads * r.per_thread * r.cluster * r.vec >= d else p
    return replan


def _act_quant_launch(torch, gen, m, d):
    """act_quant on (m, d) bf16, checked bit-identical; returns its launch."""
    from repro_torch.kernels.act_quant import act_quant_cuda

    x = (torch.randn((m, d), generator=gen, device=cs.DEV) * 13.0).to(torch.bfloat16)
    cs._act_quant_check(torch, x, "fp8_e4m3", f"({m}, {d}) bf16")
    launch = lambda: act_quant_cuda(x, "fp8_e4m3")
    launch.x = x
    return launch


def main():
    sources = sys.argv[1:] or list(CUTS)
    if any(s not in CUTS for s in sources):
        cs.fail(f"unknown kernel in {sources}: choose from {list(CUTS)}")
    sys.path.insert(0, str(cs.SRC))
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the ablations need an NVIDIA GPU")
    from repro_torch.kernels import act_quant, build, decode_attn

    card = cs.phase_device()
    timer = cs.Timer(torch)
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    us = lambda fn: 1e3 * cs._device_ms(torch, timer, fn)
    result = {}
    for source in sources:
        libs = _build(build, source)
        for case, make in _cases(torch, gen, source).items():
            build._LIBS[source] = libs["base"]
            kernel = make()  # held against its plain version with the kernel as it is
            row = result[case] = {}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    build._LIBS[source] = libs[name]
                    row.setdefault(name, []).append(us(kernel))
            build._LIBS[source] = libs["base"]
            if source == "act_quant":  # the kernel as it is under other launch plans
                x = kernel.x
                row["cast to f32 (PyTorch)"] = [us(lambda: x.float()), us(lambda: x.float())]
                plan = act_quant.act_quant_plan
                for label, per, c in (("per_thread x2", 2, 1), ("per_thread /2", 0.5, 1),
                                      ("cluster x2", 1, 2), ("cluster /2", 1, 0.5)):
                    act_quant.act_quant_plan = _replanned(plan, per, c)
                    row[label] = [us(kernel), us(kernel)]
                act_quant.act_quant_plan = plan
            if source == "decode_attn":
                budget = decode_attn.BLOCK_BUDGET
                for label, b in (("budget x2", 2 * budget), ("one page a split", 1 << 30)):
                    decode_attn.BLOCK_BUDGET = b
                    row[label] = [us(kernel), us(kernel)]
                decode_attn.BLOCK_BUDGET = budget
            cs.log(f"{case}: " + ", ".join(f"{k} {min(v):.2f}" for k, v in row.items()))
        build._LIBS.pop(source, None)
    print(json.dumps({"card": card, "us_per_launch": result}), flush=True)


if __name__ == "__main__":
    main()
