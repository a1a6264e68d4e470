#!/usr/bin/env python3
"""Device times of the kernel rows of another checkout, for a before/after
comparison on one card.

    python3 kernel_compare.py <root of a checkout> [row ...]

Builds the CUDA kernels of ``<root>/src/repro_torch`` and times them with
this checkout's ``chip_smoke.py`` timing code: phase 11's act_quant row
(row 4, bf16 -> fp8_e4m3 at every shape of ``ACT_QUANT_SHAPES``, bit-identical
to its plain version, beside the launch floor measured in the same run),
its flash-attention row (row 6, causal bf16 at its four timed shapes), phase 3's MLA latent
decode row (row 3 over FP8 + FP4 frozen, FP8 and bf16 pages at MiniCPM3-4B's
shapes), its decode-attention rows (row 2 over FP8 pages and row 2b with
the FP4 frozen region, at opt-125m's KV 12 of hd 64 and OLMoE-1B-7B's KV 16
of hd 128), then its W4A8 rows (row 1 at opt-125m's, MiniCPM3-4B's and
OLMoE-1B-7B's shapes, rows 1b and 1c at E=40, row 1d at M=4 and 260, as
served and dense), each held against its plain version, with its library
call; then phase 11's split-vs-fused table. Every reading is device time
from CUDA graphs beside the event-pair time. The optional ``row``
arguments name the families to time, of ``4``, ``6``, ``3``, ``2`` (rows 2
and 2b) and ``1`` (the W4A8 rows and the split-vs-fused table); ``4`` also
times the split-vs-fused table, whose split side starts with act_quant;
with none it times them all. Run it on the checkout itself and on a copy of the parent
commit in one call.
"""
import json
import sys
from pathlib import Path

import chip_smoke as cs


FAMILIES = ("4", "6", "3", "2", "1")


def main():
    families = set(sys.argv[2:]) or set(FAMILIES)
    if len(sys.argv) < 2 or not families <= set(FAMILIES):
        cs.fail(f"usage: kernel_compare.py <root of a checkout> [row ...], rows of {FAMILIES}")
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this comparison needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"kernels of {root}")
    card = cs.phase_device()
    cs.phase_build()
    timer = cs.Timer(torch)
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    rows = {}
    if "4" in families:
        floor_ms = cs._launch_floor(torch, timer)
        cs.log(f"    launch floor (one-element fill_, device time) {floor_ms * 1e3:.3f} us")
        for m, d in cs.ACT_QUANT_SHAPES:
            rows[f"row4 ({m}, {d})"] = cs._act_quant_case(torch, timer, gen, m, d, floor_ms)
    if "6" in families:
        for tag, h, hd, dv, s in cs.FLASH_SHAPES:
            rows[f"row6 {tag}"] = cs._flash_case(torch, timer, gen, tag, h, hd, dv, s)
    if "3" in families:
        for fmt, fz in (("fp8_e4m3", True), ("fp8_e4m3", False), (None, False)):
            rows[f"row3 {fmt or 'bf16'}{' + fp4 frozen' if fz else ''}"] = cs._mla_case(
                torch, timer, gen, fmt, fz)
    if "2" in families:
        for kv, hd in ((12, 64), (16, 128)):
            rows[f"row2 KV={kv} hd={hd}"] = cs._attn_case(torch, timer, "fp8_e4m3", gen, kv, hd)
            rows[f"row2b KV={kv} hd={hd}"] = cs._attn_frozen_case(torch, timer, gen, kv, hd)
    if "1" in families:
        _w4a8_rows(torch, timer, gen, rows)
    versus = _split_vs_fused(torch, timer, gen) if families & {"1", "4"} else None
    keep = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "max_abs_err",
            "floor_ms", "share_above_floor", "path")
    print(json.dumps({"root": str(root), "card": card,
                      "rows": {k: {f: r[f] for f in keep if f in r} for k, r in rows.items()},
                      "split_vs_fused": versus}), flush=True)


def _w4a8_rows(torch, timer, gen, rows):
    """Phase 3's W4A8 rows into ``rows``."""
    shapes = [(m, k, n) for m in (4, 64, 256) for k, n in ((768, 768), (768, 3072), (3072, 768))]
    shapes += [(4, k, n) for k, n in sorted(set(cs.MINICPM3_GEMMS))] + [(4, 2048, 2048)]
    for m, k, n in shapes:
        rows[f"row1 M={m} {k}->{n}"] = cs._w4a8_case(torch, timer, m, k, n, gen)
    for tr in (False, True):
        rows[f"row1{'c' if tr else 'b'} E=40 M=4"] = cs._batched_case(torch, timer, tr, gen)
    for name, k, n in cs.OLMOE_EXPERTS:
        p = cs._moe_weights(torch, k, n, gen)
        for m, routed in ((4, True), (260, True), (4, False), (260, False)):
            rows[f"row1d {name} M={m}{' routed' if routed else ''}"] = cs._moe_case(
                torch, timer, p, m, gen, routed)


def _split_vs_fused(torch, timer, gen):
    """Phase 11's split-vs-fused table."""
    cs.log("[11 kernel api] split vs fused")
    weights = {(k, n): cs._packed(torch, k, n, gen)
               for k, n in sorted({(k, n) for _, k, n in cs.SPLIT_GEMMS})}
    return cs._split_vs_fused(torch, timer, gen, weights)


if __name__ == "__main__":
    main()
