"""Whisper-style encoder-decoder (port of ``repro.models.encdec``).

The audio conv front-end is a stub, as in the reference: requests carry
frame embeddings (B, encoder_seq, d_model), what the two-conv mel front-end
would produce. Encoder: pre-LN transformer, learned positions, not causal.
Decoder: pre-LN transformer, learned positions, causal self-attention and
then cross-attention to the encoder's output.

Serving runs the encoder once per request, at admission
(``encode_cross_pages``): every decoder layer's cross K/V is quantized into
the request's write-once cross pages, which each decode step reads through
the paged decode kernel. Off the pages, ``init_encdec_cache`` holds the
decoder's contiguous caches: self K/V a layer and the cross K/V
(``cross_k`` / ``cross_v``, (L, B, encoder_seq, KV, hd)), which the
prefill computes from the encoder's output and stores and each
scalar-index decode step reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.runtime.kv_cache import PagedState, write_cross_pages

from .attention import check_contiguous_step
from .layers import ParamDef, embed_lookup, linear, norm, norm_params
from .transformer import (SegmentSpec, _stack_defs, block_params, init_block_cache, layer_view,
                          pos_rows, positions_of, run_segment, stacked)

__all__ = ["build_encdec", "encode", "encode_cross_pages", "encdec_forward",
           "init_encdec_cache"]


def _enc_seg(cfg) -> SegmentSpec:
    return SegmentSpec("gqa", "mlp", cfg.encoder_layers)


def _dec_seg(cfg) -> SegmentSpec:
    return SegmentSpec("gqa", "mlp", cfg.n_layers, cross=True)


def build_encdec(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        "enc_pos": ParamDef((cfg.encoder_seq, d), (None, "embed"), dt, "embed"),
        "encoder": _stack_defs(block_params(cfg, _enc_seg(cfg)), cfg.encoder_layers),
        "enc_ln": norm_params(cfg),
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed"),
        "pos_embed": ParamDef((cfg.max_position, d), (None, "embed"), dt, "embed"),
        "decoder": _stack_defs(block_params(cfg, _dec_seg(cfg)), cfg.n_layers),
        "final_ln": norm_params(cfg),
        # whisper ties the output head to the token embedding
    }


def encode(params, cfg, frames: torch.Tensor, a_fmt: Optional[str] = None,
           remat: bool = False) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> the encoder's output (B, T, d):
    non-causal blocks (query-chunked above ``attn_chunk``), then ``enc_ln``;
    ``remat`` recomputes each block in the backward pass."""
    dev = params["enc_pos"].device
    frames = frames.to(dev).to(params["enc_pos"].dtype)
    t = frames.shape[1]
    x = frames + params["enc_pos"][None, :t].to(frames.dtype)
    enc_cfg = dataclasses.replace(cfg, causal=False, pos_embedding="learned_applied")
    x, _ = run_segment(params["encoder"], x, enc_cfg, _enc_seg(cfg),
                       torch.arange(t, device=dev), a_fmt=a_fmt, remat=remat)
    return norm(params["enc_ln"], x, cfg.norm_kind, cfg.norm_eps)


@torch.no_grad()
def encode_cross_pages(params, cfg, frames: torch.Tensor, cross_pool, cross_table: torch.Tensor,
                       a_fmt: Optional[str] = None):
    """The admission step: run the encoder once on ``frames`` (1, T, d) and
    write every decoder layer's cross K/V into the request's cross pages
    ``cross_table`` (1, cross_pp) of ``cross_pool`` (leaves (L, P+1, page,
    KV, hd)), in place. Returns the pool. Nothing writes those pages again
    while the request lives."""
    enc_out = encode(params, cfg, frames, a_fmt=a_fmt)
    b, t = enc_out.shape[:2]
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        pc = layer_view(params["decoder"], i)["mixer"]["cross"]
        ek = linear(pc["wk"], enc_out).reshape(b, t, kv, hd)
        ev = linear(pc["wv"], enc_out, pc.get("bv")).reshape(b, t, kv, hd)
        write_cross_pages({k: leaf[i] for k, leaf in cross_pool.items()},
                          {"k": ek, "v": ev}, cross_table)
    return cross_pool


def init_encdec_cache(cfg, batch: int, max_seq: int, device=None):
    """The decoder's contiguous caches, one tree stacked over its layers:
    {"kv": {"k", "v"} (L, B, max_seq, KV, hd), "cross_k", "cross_v" (L, B,
    encoder_seq, KV, hd)}, every layer its own storage."""
    return stacked(init_block_cache(cfg, _dec_seg(cfg), batch, max_seq, cfg.encoder_seq, device),
                   cfg.n_layers)


def encdec_forward(params, cfg, tokens: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
                   caches=None, state=None,
                   a_fmt: Optional[str] = None, cross=None, remat: bool = False) -> torch.Tensor:
    """The decoder. Serving (``state``): tokens (B, S) at per-row positions
    ``state.lengths + j``, the self pages ``caches`` (one pool, written in
    place) and the cross pages ``cross`` (read only). An ``int`` state is
    the contiguous caches' index (``caches``: ``init_encdec_cache``'s tree):
    a step over more than one token stores the cross K/V of ``enc_out``
    (the cross leaves are reallocated when its length is not the cache's),
    a one-token step reads them. Without a state: whole sequences at
    positions 0..S-1 attending to ``enc_out`` (``remat`` recomputes each
    block in the backward pass). Returns the final-norm hidden states (B,
    S, d)."""
    tokens = tokens.to(params["embed"].device)
    s = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens)
    seg_cache = None
    if isinstance(state, PagedState):
        positions = positions_of(state, s, x.device)
        x = x + params["pos_embed"][positions].to(x.dtype)
        seg_cache = None if caches is None else caches[0]
    elif isinstance(state, int):
        positions = torch.arange(s, device=x.device) + state
        x = x + pos_rows(params["pos_embed"], state, s)[None].to(x.dtype)
        seg_cache = caches
        if s > 1:
            check_contiguous_step(s, state)
            if enc_out is None:
                raise ValueError("a contiguous step over more than one token stores the cross "
                                 "K/V: it needs the encoder's output")
            if caches["cross_k"].shape[2] != enc_out.shape[1]:
                shape = caches["cross_k"].shape[:2] + (enc_out.shape[1],) + \
                    caches["cross_k"].shape[3:]
                for name in ("cross_k", "cross_v"):
                    caches[name] = caches[name].new_zeros(shape)
    else:
        positions = torch.arange(s, device=x.device)
        x = x + params["pos_embed"][:s][None].to(x.dtype)
    dec_cfg = dataclasses.replace(cfg, pos_embedding="learned_applied")
    x, _ = run_segment(params["decoder"], x, dec_cfg, _dec_seg(cfg), positions, seg_cache, state,
                       a_fmt, cross, enc_out, remat=remat)
    return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)
