"""Whole-model PTQ, RTN path (port of ``repro.core.ptq``).

  * ``pack_linear(w, policy)``        — one weight -> PackedLinear.
  * ``quantize_tree(params, defs, policy)`` — replace every quantizable
    leaf of a param tree by its W4A8 deployment form.
  * ``pack_params(params, cfg, policy, device)`` — the entry point: the
    tree of ``models.build_def(cfg)`` quantized on ``device``.

GPTQ (``gptq_quantize_lm``) is not ported yet (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import ParamDef, tree_map

from .formats import FORMATS, fp_encode, pack_nibbles
from .lorc import lorc_compensate
from .policy import QuantPolicy
from .quantize import fake_quantize_weight, quantize_weight
from .scales import apply_scale_constraint, constrain_scales_m2

__all__ = ["is_quantizable", "effective_group", "pack_linear", "quantize_tree",
           "pack_params"]


def is_quantizable(d: ParamDef, path: str = "") -> bool:
    """A >=2-D 'normal'-init matrix whose (out, in) dims are both >= 64,
    not an embedding / vocab-tied / conv / router / position weight."""
    if not isinstance(d, ParamDef):
        return False
    if d.init != "normal" or len(d.shape) < 2:
        return False
    if "vocab" in d.axes or "conv" in d.axes:
        return False
    if "router" in path or "pos_embed" in path:
        return False
    out_f, in_f = d.shape[-2], d.shape[-1]
    return out_f >= 64 and in_f >= 64 and in_f % 2 == 0


def effective_group(in_features: int, group: int) -> int:
    """Largest divisor of in_features that is <= group."""
    g = min(group, in_features)
    while g > 1 and in_features % g:
        g -= 1
    return max(g, 1)


def pack_linear(w: torch.Tensor, policy: QuantPolicy) -> Optional[PackedLinear]:
    """RTN-quantize and nibble-pack one (out, in) FP4 weight, or a stack
    (..., out, in) of them, each slice as on its own (non-FP4 policies
    return None: they stay dense, fake-quantized)."""
    w32 = w.to(torch.float32)
    gs = effective_group(w.shape[-1], policy.group_size)
    qt0 = quantize_weight(w32, policy.w_fmt, gs)
    scale = apply_scale_constraint(qt0.scale, policy.scale_mode)
    qt = quantize_weight(w32, policy.w_fmt, gs, scale=scale)
    lorc = None
    if policy.lorc_rank > 0:
        lorc = lorc_compensate(w32, qt.dequantize(), policy.lorc_rank,
                               quantize_factors=policy.lorc_fmt)
    if not str(policy.w_fmt).startswith("fp4"):
        return None
    codes = pack_nibbles(fp_encode(qt.values, FORMATS[policy.w_fmt]))
    s_max = shifts = None
    if policy.scale_mode == "m2":
        m2 = constrain_scales_m2(qt.scale)
        s_max, shifts = m2.s_max, m2.shifts.to(torch.int8)
    return PackedLinear(
        codes=codes, scale=qt.scale.to(torch.float32), s_max=s_max, shifts=shifts,
        lorc_a=None if lorc is None else lorc.a.to(torch.bfloat16),
        lorc_b=None if lorc is None else lorc.b.to(torch.bfloat16),
        w_fmt=policy.w_fmt, a_fmt=policy.a_fmt, group_size=qt.group_size)


def _pack_batched(w: torch.Tensor, policy: QuantPolicy, chunk: Optional[int] = None
                  ) -> PackedLinear:
    """Pack a (..., out, in) stacked weight: every slice as ``pack_linear``
    packs it on its own, ``chunk`` slices per batched call (by default as
    many as hold 2^26 weights, whose f32 and f64 working copies take a few
    GB: 32 of OLMoE's 1024 x 2048 experts, 4 of MiniCPM3's 6400 x 2560
    MLP slices), and restack."""
    lead = w.shape[:-2]
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    chunk = chunk or max(1, (1 << 26) // (flat.shape[-2] * flat.shape[-1]))
    packed = [pack_linear(flat[i:i + chunk], policy) for i in range(0, flat.shape[0], chunk)]

    def stack(field):
        vals = [getattr(p, field) for p in packed]
        if vals[0] is None:
            return None
        return torch.cat(vals).reshape(tuple(lead) + tuple(vals[0].shape[1:]))

    return PackedLinear(**{f: stack(f) for f in PackedLinear._FIELDS},
                        w_fmt=packed[0].w_fmt, a_fmt=packed[0].a_fmt,
                        group_size=packed[0].group_size)


def quantize_tree(params, defs, policy: QuantPolicy):
    """RTN-quantize every quantizable leaf of ``params`` (structure given by
    the ParamDef tree ``defs``). FP4 leaves become PackedLinear; other
    weight formats stay dense, fake-quantized."""
    def visit(path, d, p):
        if not is_quantizable(d, path):
            return p
        if str(policy.w_fmt).startswith("fp4"):
            return pack_linear(p, policy) if len(d.shape) == 2 else _pack_batched(p, policy)
        gs = effective_group(d.shape[-1], policy.group_size)
        flat = p.reshape((-1,) + tuple(p.shape[-2:])).to(torch.float32)
        q = torch.stack([fake_quantize_weight(flat[i], policy.w_fmt, gs)
                         for i in range(flat.shape[0])])
        return q.reshape(p.shape).to(p.dtype)

    return _zip_map(visit, defs, params, "")


def _zip_map(fn, defs, params, path):
    """Map ``fn(path, def, leaf)`` over the ParamDef tree and its params."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(defs, ParamDef):
        return fn(path, defs, params)
    if isinstance(defs, dict):
        return {k: _zip_map(fn, defs[k], params[k], join(k)) for k in defs}
    return [_zip_map(fn, d, p, join(i))
            for i, (d, p) in enumerate(zip(defs, params))]


def pack_params(params, cfg, policy: QuantPolicy, device=None):
    """The serving checkpoint: ``params`` moved to ``device`` (the card
    unless ``device='cpu'``) and RTN-quantized under ``policy``."""
    from repro_torch.models import api

    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), params)
    with torch.no_grad():
        return quantize_tree(params, api.build_def(cfg), policy)
