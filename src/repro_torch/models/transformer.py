"""Decoder-LM assembly (port of ``repro.models.transformer``): segments of
(mixer x ffn) blocks, the mixer GQA or MLA attention, the ffn a dense MLP or
an MoE layer (with DeepSeek-style leading dense layers).

Parameters stack per segment with a leading ``(L, ...)`` dim as in the
reference; a Python loop over the layers takes the place of ``lax.scan``.
Blocks run over the paged pool (serving) or, for GQA / MLP blocks, with no
cache over whole sequences (calibration, perplexity). The recurrent and
enc-dec families, the vision/audio front-ends and multi-token prediction
come with later slices (ROADMAP queue 1, item 12), the cache-free MLA and
MoE blocks with training (item 13)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.runtime.kv_cache import PagedState, pool_keys

from .attention import attention, attn_params
from .layers import PackedLinear, ParamDef, mlp, mlp_params, norm, norm_params
from .mla import mla_attention, mla_params
from .moe import moe_layer, moe_params
from .params import tree_map

__all__ = ["SegmentSpec", "segments_for", "build_lm", "block_params", "block_apply",
           "layer_view", "lm_forward", "lm_logits"]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    mixer: str  # 'gqa' | 'mla' in the port so far
    ffn: str  # 'mlp' | 'moe'
    count: int
    d_ff: int = 0  # override cfg.d_ff (deepseek dense layers)


def segments_for(cfg) -> List[SegmentSpec]:
    if (cfg.ssm is not None or cfg.attn_kind not in ("gqa", "mla") or cfg.encoder_layers
            or cfg.frontend != "none" or cfg.mtp_depth):
        raise NotImplementedError(
            f"{cfg.name}: only GQA and MLA decoders, with an MLP or MoE ffn, are ported so far "
            "(ROADMAP queue 1, item 12)")
    if cfg.moe is not None:
        segs = []
        if cfg.moe.n_dense_layers:
            segs.append(SegmentSpec(cfg.attn_kind, "mlp", cfg.moe.n_dense_layers,
                                    d_ff=cfg.moe.dense_d_ff or cfg.d_ff))
        segs.append(SegmentSpec(cfg.attn_kind, "moe", cfg.n_layers - cfg.moe.n_dense_layers))
        return segs
    return [SegmentSpec(cfg.attn_kind, "mlp", cfg.n_layers)]


def _ffn_params(cfg, kind: str, d_ff: int = 0):
    if kind == "mlp":
        return {"ln": norm_params(cfg), "mlp": mlp_params(cfg, d_ff=d_ff or cfg.d_ff)}
    if kind == "moe":
        return {"ln": norm_params(cfg), "moe": moe_params(cfg)}
    raise ValueError(kind)


def block_params(cfg, seg: SegmentSpec):
    attn = mla_params(cfg) if seg.mixer == "mla" else attn_params(cfg)
    return {"mixer": {"ln": norm_params(cfg), "attn": attn},
            "ffn": _ffn_params(cfg, seg.ffn, seg.d_ff)}


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


def _require_cache_free(cfg, seg: SegmentSpec) -> None:
    if seg.mixer != "gqa" or seg.ffn != "mlp":
        raise NotImplementedError(
            f"{cfg.name}: the cache-free forward of {seg.mixer} / {seg.ffn} blocks is not "
            "ported yet (ROADMAP queue 1, item 13)")


def block_apply(p, x, cfg, seg: SegmentSpec, positions, cache_layer=None,
                state: Optional[PagedState] = None, a_fmt=None):
    """One pre-norm block: x + mixer(ln(x)), then x + ffn(ln(x)); the mixer
    is GQA attention or MLA by ``seg.mixer``, the ffn an MLP or an MoE layer
    by ``seg.ffn``. Without ``state`` (GQA / MLP blocks only) x is a whole
    sequence at ``positions`` 0..S-1 and no cache is read or written."""
    if state is None:
        _require_cache_free(cfg, seg)
    nk = cfg.norm_kind
    pm, pf = p["mixer"], p["ffn"]
    hn = norm(pm["ln"], x, nk, cfg.norm_eps)
    if seg.mixer == "mla":
        h, _ = mla_attention(pm["attn"], hn, cfg, positions, cache_layer, state, a_fmt=a_fmt)
    else:
        h, _ = attention(pm["attn"], hn, cfg, positions, cache_layer, state, a_fmt=a_fmt)
    x = x + h
    x_ln = norm(pf["ln"], x, nk, cfg.norm_eps)
    if seg.ffn == "mlp":
        return x + mlp(pf["mlp"], x_ln, cfg, a_fmt=a_fmt)
    # Serving (paged) routes per-token: group_size=1 puts every token in its
    # own dispatch group, so capacity never drops an assignment and each
    # token's experts depend only on its own hidden state. Batch
    # composition -- which rows share the program, decode lanes vs a
    # piggybacked prefill chunk, chunk bucketing -- can then never change a
    # token's routing, which is what makes serving outputs independent of
    # batchmates and the mixed engine bit-identical to the alternating one.
    h, _ = moe_layer(pf["moe"], x_ln, cfg, a_fmt=a_fmt, group_size=1)
    return x + h


def _embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def lm_forward(params, cfg, tokens: torch.Tensor, caches=None,
               state: Optional[PagedState] = None, a_fmt: Optional[str] = None):
    """tokens (B, S) at per-row positions ``state.lengths[:, None] + j``
    (for a mixed step, the fused (1, slots + S) row of decode tokens and
    one prefill chunk). ``caches``: one pool dict per segment, written in
    place. Without ``state`` (and caches) the tokens are whole sequences at
    positions 0..S-1 (the dense family only). Returns the final-norm
    hidden states (B, S, d)."""
    x = _embed_tokens(params, tokens)
    s = tokens.shape[1]
    steps = torch.arange(s, device=tokens.device)
    if state is None:
        segs = segments_for(cfg)
        for seg in segs:
            _require_cache_free(cfg, seg)
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][:s][None].to(x.dtype)
        for seg, seg_params in zip(segs, params["segments"]):
            for i in range(seg.count):
                x = block_apply(layer_view(seg_params, i), x, cfg, seg, steps, a_fmt=a_fmt)
        return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)
    if state.prefill is not None:
        # the mixed step's fused row: each decode token at its slot's true
        # length, chunk token j at the chunk start + j
        nd = state.lengths.shape[0]
        positions = torch.cat([state.lengths.long(),
                               state.prefill.lengths.long()[0] + steps[:s - nd]])[None]
    else:
        positions = state.lengths.long()[:, None] + steps[None]
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][positions].to(x.dtype)
    for seg, seg_params, pool in zip(segments_for(cfg), params["segments"], caches):
        for i in range(pool[pool_keys(pool)[0]].shape[0]):
            cache_layer = {name: leaf[i] for name, leaf in pool.items()}
            x = block_apply(layer_view(seg_params, i), x, cfg, seg, positions, cache_layer,
                            state, a_fmt)
    return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)


def lm_logits(params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of bf16 hidden states against the (tied) head; the
    reference computes this product outside any kernel too."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden.float(), w.float().t())
