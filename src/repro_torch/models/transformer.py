"""Decoder-LM assembly, dense segments (port of ``repro.models.transformer``).

Parameters stack per segment with a leading ``(L, ...)`` dim as in the
reference; a Python loop over the layers takes the place of ``lax.scan``.
The MoE / MLA / recurrent mixers and the vision/audio front-ends come with
later slices (ROADMAP queue 1, item 12)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.runtime.kv_cache import PagedState

from .attention import attention, attn_params
from .layers import PackedLinear, ParamDef, mlp, mlp_params, norm, norm_params
from .params import tree_map

__all__ = ["SegmentSpec", "segments_for", "build_lm", "block_params", "block_apply",
           "layer_view", "lm_forward", "lm_logits"]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    mixer: str  # 'gqa' in this slice
    ffn: str  # 'mlp' in this slice
    count: int
    d_ff: int = 0


def segments_for(cfg) -> List[SegmentSpec]:
    if (cfg.ssm is not None or cfg.moe is not None or cfg.attn_kind != "gqa"
            or cfg.encoder_layers or cfg.frontend != "none" or cfg.mtp_depth):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported so far (ROADMAP queue 1, item 12)")
    return [SegmentSpec("gqa", "mlp", cfg.n_layers)]


def block_params(cfg, seg: SegmentSpec):
    return {"mixer": {"ln": norm_params(cfg), "attn": attn_params(cfg)},
            "ffn": {"ln": norm_params(cfg), "mlp": mlp_params(cfg, d_ff=seg.d_ff or cfg.d_ff)}}


def _stack_defs(tree, n: int):
    return tree_map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.dtype,
                                       d.init, d.scale),
                    tree, is_leaf=lambda x: isinstance(x, ParamDef))


def build_lm(cfg):
    """ParamDef tree: token (+ learned position) embeddings, stacked
    segments, final norm, and the LM head unless it is tied."""
    d, dt = cfg.d_model, cfg.param_dtype
    p = {"embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed")}
    if cfg.pos_embedding == "learned":
        p["pos_embed"] = ParamDef((cfg.max_position, d), (None, "embed"), dt, "embed")
    p["segments"] = [_stack_defs(block_params(cfg, seg), seg.count) for seg in segments_for(cfg)]
    p["final_ln"] = norm_params(cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed")
    return p


def layer_view(stack, i: int):
    """Layer ``i`` of a stacked segment (views, no copies)."""
    return tree_map(lambda t: t.layer(i) if isinstance(t, PackedLinear) else t[i], stack,
                    is_leaf=lambda x: isinstance(x, PackedLinear))


def block_apply(p, x, cfg, cache_layer, state: PagedState, a_fmt=None):
    """One pre-norm block: x + attn(ln(x)), then x + mlp(ln(x))."""
    nk = cfg.norm_kind
    pm, pf = p["mixer"], p["ffn"]
    h, _ = attention(pm["attn"], norm(pm["ln"], x, nk, cfg.norm_eps), cfg,
                     cache_layer, state, a_fmt=a_fmt)
    x = x + h
    return x + mlp(pf["mlp"], norm(pf["ln"], x, nk, cfg.norm_eps), cfg, a_fmt=a_fmt)


def lm_forward(params, cfg, tokens: torch.Tensor, caches, state: PagedState,
               a_fmt: Optional[str] = None):
    """tokens (B, S) at per-row positions ``state.lengths[:, None] + j``.
    ``caches``: one pool dict per segment, written in place. Returns the
    final-norm hidden states (B, S, d)."""
    x = params["embed"][tokens.long()]
    s = tokens.shape[1]
    positions = state.lengths.long()[:, None] + torch.arange(s, device=tokens.device)[None]
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][positions].to(x.dtype)
    for seg_params, pool in zip(params["segments"], caches):
        n_layers = pool["k"].shape[0]
        for i in range(n_layers):
            cache_layer = {name: leaf[i] for name, leaf in pool.items()}
            x = block_apply(layer_view(seg_params, i), x, cfg, cache_layer, state, a_fmt)
    return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)


def lm_logits(params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of bf16 hidden states against the (tied) head; the
    reference computes this product outside any kernel too."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden.float(), w.float().t())
