#!/usr/bin/env python3
"""Where the time of the paged GQA decode-attention kernel goes, by ablation.

    python3 attn_ablate.py

Each variant is ``src/repro_torch/csrc/decode_attn.cu`` with one part cut
out by a text edit, compiled with the build's own flags into
``build/ablate/``; every variant is timed by ``chip_smoke._device_ms``
(device time from CUDA graphs, cold L2) through the unchanged wrapper, in
turns (all variants, then all again in reverse), at phase 3's timed shapes:
row 2 at opt-125m's KV 12 of hd 64 and OLMoE-1B-7B's KV 16 of hd 128, and
row 2b at KV 16 of hd 128, contexts 2048/1337/300/1. The variants:

- ``base``: the kernel as it is;
- ``placed_off``: every code through ``decode_code`` (no bit placement);
- ``no_pdl``: the combine launched without programmatic dependence;
- ``no_trigger``: the split kernel does not release the combine early;
- ``no_combine``: no combine launch;
- ``no_attend``: pages staged, nothing attended (merge and combine run);
- ``empty``: every split block exits at once (the launch floor).

The cut variants compute wrong outputs: they are timed, not checked. Then
``base`` again under other block budgets of ``decode_attn_plan`` (twice
the plan's, and one page a split). Prints one JSON line of microseconds
a launch, each variant's readings in turn order.
"""
import ctypes
import json
import subprocess
import sys

import chip_smoke as cs

CSRC = cs.SRC / "repro_torch" / "csrc" / "decode_attn.cu"
OUT = cs.ROOT / "build" / "ablate"
ATTEND = "float (&m)[G], float (&l)[G], float (&acc)[G][DL]) {\n"  # attend()'s signature
CUTS = {
    "base": [],
    "placed_off": [("    fast = fast && (c == 0.f", "    fast = false && (c == 0.f")],
    "no_pdl": [("programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;")],
    "no_trigger": [('  asm volatile("griddepcontrol.launch_dependents;\\n");', "")],
    "no_combine": [("  const cudaError_t e = cudaLaunchKernelEx(",
                    "  if (B > 0) return 0;\n  const cudaError_t e = cudaLaunchKernelEx(")],
    "no_attend": [(ATTEND, ATTEND + "  if (ns > 0) return;\n")],
    "empty": [("  constexpr bool VEC = LT != 0;\n",
               "  constexpr bool VEC = LT != 0;\n  if (a.H > 0) return;\n")],
}


def _build(build):
    """Every variant's library, one nvcc each, in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, procs = CSRC.read_text(), {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                cs.fail(f"variant {name}: the cut {old!r} is not in {CSRC.name} exactly once")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"variant {name} does not build:\n{out}")
        if name == "base":  # each instantiation's registers and spills, by name
            for line in out.splitlines():
                if "entry function" in line or "Used" in line or "spill" in line:
                    cs.log(f"    {line.strip()}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in CUTS}


def main():
    if len(sys.argv) > 1:
        cs.fail(f"takes no arguments, got {sys.argv[1:]}")
    sys.path.insert(0, str(cs.SRC))
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the ablations need an NVIDIA GPU")
    from repro_torch.kernels import build, decode_attn

    card = cs.phase_device()
    libs = _build(build)
    timer = cs.Timer(torch)
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    cases = {"row2 KV=12 hd=64": lambda: cs._attn_check(torch, "fp8_e4m3", gen, 0, 12, 64),
             "row2 KV=16 hd=128": lambda: cs._attn_check(torch, "fp8_e4m3", gen, 0, 16, 128),
             "row2b KV=16 hd=128": lambda: cs._attn_frozen_check(torch, gen, 128, 0, 16)}
    budget = decode_attn.BLOCK_BUDGET
    us = lambda fn: 1e3 * cs._device_ms(torch, timer, fn)
    result = {}
    for case, make in cases.items():
        build._LIBS["decode_attn"] = libs["base"]
        kernel = make()[-3]  # held against its plain version with the kernel as it is
        row = result[case] = {}
        for order in (list(CUTS), list(CUTS)[::-1]):
            for name in order:
                build._LIBS["decode_attn"] = libs[name]
                row.setdefault(name, []).append(us(kernel))
        build._LIBS["decode_attn"] = libs["base"]
        for label, b in (("budget x2", 2 * budget), ("one page a split", 1 << 30)):
            decode_attn.BLOCK_BUDGET = b
            row[label] = [us(kernel), us(kernel)]
        decode_attn.BLOCK_BUDGET = budget
        cs.log(f"{case}: " + ", ".join(f"{k} {min(v):.2f}" for k, v in row.items()))
    print(json.dumps({"card": card, "us_per_launch": result}), flush=True)


if __name__ == "__main__":
    main()
