"""Decoder-LM assembly (port of ``repro.models.transformer``): segments of
(mixer x ffn) blocks, the mixer GQA or MLA attention, the ffn a dense MLP or
an MoE layer (with DeepSeek-style leading dense layers); xLSTM stacks
mLSTM / sLSTM pairs (``xlstm_pair`` mixers, no ffn) whose recurrent state
lives in slabs (``kv_cache.gather_slabs``). Zamba2's hybrid builds on the
same blocks in ``models.hybrid``. A ``cross``
segment (the enc-dec decoder, ``models.encdec``) adds a cross-attention
sub-block after the self-attention; a ``vision_patches`` front-end (LLaVA)
projects patch embeddings through ``mm_proj`` and prepends them. A config
with ``mtp_depth`` (DeepSeek-V3) carries one more block, unstacked, under
``mtp`` with its norm and input projection: only ``losses.mtp_loss``
reads it.

Parameters stack per segment with a leading ``(L, ...)`` dim as in the
reference; a Python loop over the layers takes the place of ``lax.scan``.
Blocks run over the paged pool (serving), over contiguous caches at one
synchronized index (``init_lm_cache``: the prefill and the scalar-index
decode step), or with no cache over whole sequences (calibration,
perplexity, the loss). Off the pages MoE takes the capacity-bounded
grouped dispatch, whose balance loss ``aux`` is summed over the layers as
the reference's scan carries it; without a cache MLA takes its
materialized form."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.runtime.kv_cache import PagedState, gather_slabs, scatter_slabs

from .attention import attention, attn_params, init_kv_cache, paged_cross_attention
from .layers import (PackedLinear, ParamDef, activation, embed_lookup, linear, mlp, mlp_params,
                     norm, norm_params)
from .mla import init_mla_cache, mla_attention, mla_params
from .moe import moe_layer, moe_params
from .params import tree_items, tree_map
from .xlstm import (init_mlstm_cache, init_slstm_cache, mlstm_block, mlstm_params, slstm_block,
                    slstm_params)

__all__ = ["SegmentSpec", "segments_for", "build_lm", "block_params", "block_apply",
           "layer_view", "positions_of", "rematerialized", "run_segment", "lm_forward",
           "lm_logits", "init_block_cache", "init_lm_cache", "stacked", "copy_into", "pos_rows"]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    mixer: str  # 'gqa' | 'mla' | 'xlstm_pair'
    ffn: str  # 'mlp' | 'moe' | 'none'
    count: int
    d_ff: int = 0  # override cfg.d_ff (deepseek dense layers)
    cross: bool = False  # decoder cross-attention (whisper)


def segments_for(cfg) -> List[SegmentSpec]:
    """The stacked segments of a decoder LM. No config reaches the
    reference's ``mamba2`` segment (a pure Mamba2 LM): Zamba2 is built by
    ``models.hybrid``, so the port has none."""
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        assert cfg.n_layers % 2 == 0
        return [SegmentSpec("xlstm_pair", "none", cfg.n_layers // 2)]
    if cfg.attn_kind not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: no decoder segments for attn_kind {cfg.attn_kind!r}")
    if cfg.moe is not None:
        segs = []
        if cfg.moe.n_dense_layers:
            segs.append(SegmentSpec(cfg.attn_kind, "mlp", cfg.moe.n_dense_layers,
                                    d_ff=cfg.moe.dense_d_ff or cfg.d_ff))
        segs.append(SegmentSpec(cfg.attn_kind, "moe", cfg.n_layers - cfg.moe.n_dense_layers))
        return segs
    return [SegmentSpec(cfg.attn_kind, "mlp", cfg.n_layers, cross=bool(cfg.encoder_layers))]


def _mixer_params(cfg, kind: str, cross: bool = False):
    if kind == "xlstm_pair":
        return {"ln_m": norm_params(cfg), "mlstm": mlstm_params(cfg),
                "ln_s": norm_params(cfg), "slstm": slstm_params(cfg)}
    if kind == "mla":
        return {"ln": norm_params(cfg), "attn": mla_params(cfg)}
    p = {"ln": norm_params(cfg), "attn": attn_params(cfg)}
    if cross:
        p["ln_cross"] = norm_params(cfg)
        p["cross"] = attn_params(cfg)
    return p


def _ffn_params(cfg, kind: str, d_ff: int = 0):
    if kind == "mlp":
        return {"ln": norm_params(cfg), "mlp": mlp_params(cfg, d_ff=d_ff or cfg.d_ff)}
    if kind == "moe":
        return {"ln": norm_params(cfg), "moe": moe_params(cfg)}
    if kind == "none":
        return {}
    raise ValueError(kind)


def block_params(cfg, seg: SegmentSpec):
    p = {"mixer": _mixer_params(cfg, seg.mixer, seg.cross)}
    f = _ffn_params(cfg, seg.ffn, seg.d_ff)
    if f:
        p["ffn"] = f
    return p


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
    if cfg.frontend == "vision_patches":
        # LLaVA-style 2-layer MLP projector from the (stub) vision encoder dim
        p["mm_proj"] = {"fc1": ParamDef((d, 1024), ("embed", None), dt),
                        "fc2": ParamDef((d, d), ("embed", None), dt)}
    p["segments"] = [_stack_defs(block_params(cfg, seg), seg.count) for seg in segments_for(cfg)]
    p["final_ln"] = norm_params(cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed")
    if cfg.mtp_depth:  # one block of the last segment's kind, with no layer axis
        p["mtp"] = {"block": block_params(cfg, segments_for(cfg)[-1]),
                    "ln": norm_params(cfg),
                    "proj": ParamDef((d, 2 * d), ("embed", None), dt)}
    return p


def init_block_cache(cfg, seg: SegmentSpec, batch: int, max_seq: int, enc_seq: int = 0,
                     device=None):
    """One layer's contiguous cache for a segment's block: GQA {"kv"}
    (+ ``cross_k`` / ``cross_v`` (B, enc_seq, KV, hd) for a cross block),
    MLA {"kv"} latents, xLSTM {"mlstm", "slstm"} pristine states."""
    if seg.mixer == "gqa":
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        c = {"kv": init_kv_cache(batch, max_seq, kv, hd, device=device)}
        if seg.cross:
            c["cross_k"] = torch.zeros((batch, enc_seq, kv, hd), dtype=torch.bfloat16,
                                       device=device)
            c["cross_v"] = torch.zeros_like(c["cross_k"])
        return c
    if seg.mixer == "mla":
        return {"kv": init_mla_cache(cfg, batch, max_seq, device=device)}
    if seg.mixer == "xlstm_pair":
        return {"mlstm": init_mlstm_cache(cfg, batch, device),
                "slstm": init_slstm_cache(cfg, batch, device)}
    raise ValueError(seg.mixer)


def stacked(one, n: int):
    """``one``'s leaves repeated along a new leading layer axis of ``n``, each
    layer its own storage (the reference's ``broadcast_to``; an ``expand``
    would alias every layer to one buffer under in-place writes)."""
    return tree_map(lambda t: t[None].repeat((n,) + (1,) * t.dim()), one)


def init_lm_cache(cfg, batch: int, max_seq: int, enc_seq: int = 0, device=None):
    """Contiguous caches, one per segment, each layer's stacked on a leading
    (L, ...) axis."""
    return [stacked(init_block_cache(cfg, seg, batch, max_seq, enc_seq, device), seg.count)
            for seg in segments_for(cfg)]


def copy_into(cache, new):
    """Write a block's new recurrent state (``new``: the same tree as
    ``cache``) into the cache's leaves, in place, in their dtypes."""
    for name, leaf in cache.items():
        leaf.copy_(new[name].to(leaf.dtype))
    return cache


def pos_rows(table: torch.Tensor, index: int, s: int) -> torch.Tensor:
    """Rows index .. index + s - 1 of a learned position table. Past its end
    this raises ``ValueError``, where the reference's
    ``dynamic_slice_in_dim`` clamps the index (ROADMAP queue 3, F10)."""
    if index < 0 or index + s > table.shape[0]:
        raise ValueError(f"positions {index}..{index + s - 1} run past the {table.shape[0]} "
                         "learned positions (ROADMAP queue 3, F10)")
    return table[index:index + s]


def layer_view(stack, i: int):
    """Layer ``i`` of a stacked segment (views, no copies)."""
    return tree_map(lambda t: t.layer(i) if isinstance(t, PackedLinear) else t[i], stack,
                    is_leaf=lambda x: isinstance(x, PackedLinear))


def block_apply(p, x, cfg, seg: SegmentSpec, positions, cache_layer=None,
                state=None, a_fmt=None, cross_layer=None,
                enc_out: Optional[torch.Tensor] = None):
    """One pre-norm block: x + mixer(ln(x)), then x + ffn(ln(x)); the mixer
    is GQA attention or MLA by ``seg.mixer``, the ffn an MLP or an MoE layer
    by ``seg.ffn``. An ``xlstm_pair`` block is x + mLSTM(ln_m(x)), then
    x + sLSTM(ln_s(x)), with no ffn: served, each row's state is gathered
    from its slab (``state.slabs``) in ``cache_layer``'s "mlstm" and
    "slstm" slab pools, stepped and scattered back. A ``seg.cross`` block
    adds x + cross(ln_cross(x)) after the self-attention: over the
    write-once cross pages ``cross_layer`` when serving, else against the
    K/V of ``enc_out``. An ``int`` state is the contiguous caches' index:
    ``cache_layer`` is the layer's {"kv"} (+ ``cross_k`` / ``cross_v``, which
    a step over more than one token computes from ``enc_out`` and stores,
    and a one-token step reads) or xLSTM's {"mlstm", "slstm"}, each written
    in place. Without ``state`` x is a whole sequence at ``positions``
    0..S-1 and no cache is read or written. Returns (x, aux): aux the MoE
    layer's balance loss (a 0-d f32 tensor), 0.0 for an MLP or no ffn."""
    nk = cfg.norm_kind
    pm = p["mixer"]
    paged, contiguous = isinstance(state, PagedState), isinstance(state, int)
    if seg.mixer == "xlstm_pair":
        return _xlstm_pair(pm, x, cfg, cache_layer, state, a_fmt), 0.0
    pf = p["ffn"]
    hn = norm(pm["ln"], x, nk, cfg.norm_eps)
    kv_cache = cache_layer["kv"] if contiguous else cache_layer
    if seg.mixer == "mla":
        h, _ = mla_attention(pm["attn"], hn, cfg, positions, kv_cache, state, a_fmt=a_fmt)
    else:
        h, _ = attention(pm["attn"], hn, cfg, positions, kv_cache, state, a_fmt=a_fmt)
    x = x + h
    if seg.cross:
        if paged:
            # the engine ran the encoder at admission and quantized its K/V
            # into the cross pages; decode and prefill chunks only read them
            h = paged_cross_attention(pm["cross"], norm(pm["ln_cross"], x, nk, cfg.norm_eps),
                                      cfg, positions, cross_layer, state, a_fmt=a_fmt)
        else:
            if contiguous and x.shape[1] == 1:  # the prefill computed and stored these
                cross_kv = (cache_layer["cross_k"], cache_layer["cross_v"])
            else:
                b, t = x.shape[0], enc_out.shape[1]
                kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
                ek = linear(pm["cross"]["wk"], enc_out).reshape(b, t, kv, hd)
                ev = linear(pm["cross"]["wv"], enc_out, pm["cross"].get("bv")).reshape(b, t, kv,
                                                                                      hd)
                cross_kv = (ek, ev)
                if contiguous:
                    copy_into({"k": cache_layer["cross_k"], "v": cache_layer["cross_v"]},
                              {"k": ek, "v": ev})
            h, _ = attention(pm["cross"], norm(pm["ln_cross"], x, nk, cfg.norm_eps), cfg,
                             positions, a_fmt=a_fmt, cross_kv=cross_kv)
        x = x + h
    x_ln = norm(pf["ln"], x, nk, cfg.norm_eps)
    if seg.ffn == "mlp":
        return x + mlp(pf["mlp"], x_ln, cfg, a_fmt=a_fmt), 0.0
    # Serving (paged) routes per-token: group_size=1 puts every token in its
    # own dispatch group, so capacity never drops an assignment and each
    # token's experts depend only on its own hidden state. Batch
    # composition -- which rows share the program, decode lanes vs a
    # piggybacked prefill chunk, chunk bucketing -- can then never change a
    # token's routing, which is what makes serving outputs independent of
    # batchmates and the mixed engine bit-identical to the alternating one.
    # The cache-free forward keeps the capacity-bounded grouped dispatch.
    # The contiguous caches and the cache-free forward keep the
    # capacity-bounded grouped dispatch.
    h, aux = moe_layer(pf["moe"], x_ln, cfg, a_fmt=a_fmt, group_size=1 if paged else 1024)
    return x + h, aux


def _xlstm_pair(pm, x, cfg, cache_layer, state, a_fmt):
    """x + mLSTM(ln_m(x)), then x + sLSTM(ln_s(x)); over the slab pools
    when serving (``cache_layer`` {"mlstm", "slstm"}, one layer's view), or
    over the contiguous per-row states (an ``int`` state)."""
    nk, eps = cfg.norm_kind, cfg.norm_eps
    mlc = slc = None
    paged = isinstance(state, PagedState)
    if paged:
        mlc = gather_slabs(cache_layer["mlstm"], state.slabs)
        slc = gather_slabs(cache_layer["slstm"], state.slabs)
    elif state is not None:
        mlc, slc = cache_layer["mlstm"], cache_layer["slstm"]
    h, new_m = mlstm_block(pm["mlstm"], norm(pm["ln_m"], x, nk, eps), cfg, cache=mlc,
                           a_fmt=a_fmt)
    x = x + h
    h, new_s = slstm_block(pm["slstm"], norm(pm["ln_s"], x, nk, eps), cfg, cache=slc,
                           a_fmt=a_fmt)
    if paged:
        scatter_slabs(cache_layer["mlstm"], state.slabs, new_m)
        scatter_slabs(cache_layer["slstm"], state.slabs, new_s)
    elif state is not None:
        copy_into(cache_layer["mlstm"], new_m)
        copy_into(cache_layer["slstm"], new_s)
    return x + h


def _embed_tokens(params, cfg, tokens: torch.Tensor,
                  embeds_prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, behind an optional prefix: patch embeddings
    (B, P, 1024) through ``mm_proj`` (fc1, tanh-approximate gelu, fc2), or
    audio frames already at d_model, cast."""
    x = embed_lookup(params["embed"], tokens)
    if embeds_prefix is not None:
        pe = embeds_prefix.to(x.device)
        if cfg.frontend == "vision_patches":
            pe = linear(params["mm_proj"]["fc2"],
                        activation(linear(params["mm_proj"]["fc1"], pe), "gelu"))
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    return x


def positions_of(state: PagedState, s: int, device) -> torch.Tensor:
    """(B, S) token positions of a paged step: each row from its true
    length; for a mixed step's fused (1, slots + S) row, each decode token
    at its slot's length and chunk token j at the chunk start + j."""
    steps = torch.arange(s, device=device)
    if state.prefill is not None:
        nd = state.lengths.shape[0]
        return torch.cat([state.lengths.long(),
                          state.prefill.lengths.long()[0] + steps[:s - nd]])[None]
    return state.lengths.long()[:, None] + steps[None]


def rematerialized(fn, remat: bool):
    """``fn`` itself, or (``remat``) ``fn`` under
    ``torch.utils.checkpoint``: its activations are not kept for the
    backward pass but computed again there, as ``jax.checkpoint`` around
    the reference's scan body does. Values and gradients are the same."""
    if not remat:
        return fn
    from torch.utils.checkpoint import checkpoint

    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def run_segment(seg_params, x, cfg, seg: SegmentSpec, positions, pool=None,
                state=None, a_fmt=None, cross=None, enc_out=None,
                remat: bool = False):
    """Every layer of one stacked segment over x, in order (``lax.scan``'s
    place): each layer with its slice of the segment's pool (a page pool,
    xLSTM's {"mlstm", "slstm"} slab pools, or the contiguous caches) and of
    the cross pool, when there are pools; ``remat`` recomputes each block in
    the backward pass. Returns (x, the layers' aux summed)."""
    n = seg.count if pool is None else next(tree_items(pool))[1].shape[0]
    block = rematerialized(block_apply, remat)
    aux_sum = 0.0
    for i in range(n):
        cache_layer = None if pool is None else tree_map(lambda leaf: leaf[i], pool)
        cross_layer = None if cross is None else {k: leaf[i] for k, leaf in cross.items()}
        x, aux = block(layer_view(seg_params, i), x, cfg, seg, positions, cache_layer,
                       state, a_fmt, cross_layer, enc_out)
        aux_sum = aux_sum + aux
    return x, aux_sum


def lm_forward(params, cfg, tokens: torch.Tensor, caches=None,
               state=None, a_fmt: Optional[str] = None,
               embeds_prefix: Optional[torch.Tensor] = None, remat: bool = False):
    """tokens (B, S) at per-row positions ``state.lengths[:, None] + j``
    (for a mixed step, the fused (1, slots + S) row of decode tokens and
    one prefill chunk). ``caches``: one pool dict per segment, written in
    place. An ``int`` state is the contiguous caches' index (``caches``:
    ``init_lm_cache``'s list): every row at positions index + j, behind
    ``embeds_prefix`` when given. Without ``state`` (and caches) the tokens
    are whole sequences at positions 0..S-1, behind ``embeds_prefix``
    (patches or audio frames) when given; ``remat`` recomputes each block in
    the backward pass. Returns the final-norm hidden states (B, S, d) and
    the MoE balance loss summed over every layer (0.0 without an MoE
    layer)."""
    x = _embed_tokens(params, cfg, tokens, embeds_prefix)
    s = x.shape[1]
    if state is None:
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][:s][None].to(x.dtype)
        positions, pools = torch.arange(s, device=x.device), [None] * len(params["segments"])
    elif isinstance(state, int):
        if cfg.pos_embedding == "learned":
            x = x + pos_rows(params["pos_embed"], state, s)[None].to(x.dtype)
        positions, pools = torch.arange(s, device=x.device) + state, caches
    else:
        positions, pools = positions_of(state, s, x.device), caches
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][positions].to(x.dtype)
    aux_total = 0.0
    for seg, seg_params, pool in zip(segments_for(cfg), params["segments"], pools):
        x, aux = run_segment(seg_params, x, cfg, seg, positions, pool, state, a_fmt,
                             remat=remat)
        aux_total = aux_total + aux
    return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps), aux_total


def lm_logits(params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of bf16 hidden states against the (tied) head; the
    reference computes this product outside any kernel too."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden.float(), w.float().t())
