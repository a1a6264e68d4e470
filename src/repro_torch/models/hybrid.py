"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2 backbone
and ONE shared attention + MLP block applied every ``ssm.attn_every``
layers. The shared block's parameters are reused at every invocation, but
each invocation has its own KV cache, since its inputs differ by depth.

A Python loop over the stacked Mamba2 layers takes ``lax.scan``'s place and
an ``if`` that of ``lax.cond``: the shared block fires before layer ``li``
when ``li % attn_every == 0``, as invocation ``li // attn_every``. Served,
the Mamba2 state lives in slabs (``caches["mamba"]``, leaves
(L, n_slabs + 1, ...), gathered per row by ``state.slabs``) and the shared
block's K/V in a GQA page pool whose layer axis is the invocation
(``caches["shared_kv"]``), read through the paged decode kernel like any
GQA layer stack. Over contiguous caches (``init_hybrid_cache``) each layer
holds its rows' Mamba2 states and each invocation a contiguous K/V cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.kv_cache import PagedState, gather_slabs, scatter_slabs

from .attention import attention, attn_params, init_kv_cache
from .layers import ParamDef, mlp, mlp_params, norm, norm_params
from .params import tree_map
from .ssm import init_mamba2_cache, mamba2_block, mamba2_params
from .transformer import (_embed_tokens, _stack_defs, copy_into, layer_view, positions_of,
                          rematerialized, stacked)

__all__ = ["build_hybrid", "hybrid_forward", "n_attn_invocations", "init_hybrid_cache"]


def n_attn_invocations(cfg) -> int:
    k = cfg.ssm.attn_every
    return 0 if not k else -(-cfg.n_layers // k)


def build_hybrid(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    p = {"embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed"),
         "mamba": _stack_defs({"ln": norm_params(cfg), "mamba": mamba2_params(cfg)},
                              cfg.n_layers),
         "final_ln": norm_params(cfg)}
    if cfg.ssm.attn_every:
        p["shared"] = {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                       "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((cfg.vocab_size, d), ("vocab", "embed"), dt, "embed")
    return p


def init_hybrid_cache(cfg, batch: int, max_seq: int, device=None):
    """Contiguous caches: {"mamba": each layer's pristine Mamba2 states
    (L, B, ...), "shared_kv": one contiguous K/V cache an invocation of the
    shared block (n_inv, B, max_seq, KV, hd)}, every layer and invocation
    its own storage."""
    c = {"mamba": stacked(init_mamba2_cache(cfg, batch, device), cfg.n_layers)}
    n_inv = n_attn_invocations(cfg)
    if n_inv:
        c["shared_kv"] = stacked(init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                                               cfg.resolved_head_dim, device=device), n_inv)
    return c


def _shared_block(p, x, cfg, positions, kv_layer, state, a_fmt):
    nk, eps = cfg.norm_kind, cfg.norm_eps
    h, _ = attention(p["attn"], norm(p["ln1"], x, nk, eps), cfg, positions, kv_layer, state,
                     a_fmt=a_fmt)
    x = x + h
    return x + mlp(p["mlp"], norm(p["ln2"], x, nk, eps), cfg, a_fmt=a_fmt)


def _cache_free_layer(p_layer, shared, x, cfg, positions, attn: bool, a_fmt):
    """One layer of the cache-free forward: the shared block first when
    ``attn``, then the Mamba2 layer (the reference's scan body)."""
    if attn:
        x = _shared_block(shared, x, cfg, positions, None, None, a_fmt)
    dh, _ = mamba2_block(p_layer["mamba"], norm(p_layer["ln"], x, cfg.norm_kind, cfg.norm_eps),
                         cfg, a_fmt=a_fmt)
    return x + dh


def hybrid_forward(params, cfg, tokens: torch.Tensor, caches=None,
                   state=None, a_fmt: Optional[str] = None,
                   remat: bool = False):
    """tokens (B, S) -> final-norm hidden states (B, S, d). Served
    (``state`` and ``caches`` = {"mamba": slab pools, "shared_kv": the
    invocation-indexed page pool}), written in place; an ``int`` state is
    the contiguous caches' index (``init_hybrid_cache``'s, written in
    place); without them the tokens are whole sequences at positions
    0..S-1 from the pristine state (no cache read or written), and
    ``remat`` recomputes each layer (with its shared block) in the backward
    pass."""
    x = _embed_tokens(params, cfg, tokens)
    s = x.shape[1]
    paged = isinstance(state, PagedState)
    if paged:
        positions = positions_of(state, s, x.device)
    else:
        positions = torch.arange(s, device=x.device) + (0 if state is None else state)
    every = cfg.ssm.attn_every
    shared = params.get("shared")
    if caches is None:
        layer = rematerialized(_cache_free_layer, remat)
        for li in range(cfg.n_layers):
            x = layer(layer_view(params["mamba"], li), shared, x, cfg, positions,
                      shared is not None and li % every == 0, a_fmt)
        return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)
    for li in range(cfg.n_layers):
        if shared is not None and li % every == 0:
            kv_i = {k: leaf[li // every] for k, leaf in caches["shared_kv"].items()}
            x = _shared_block(shared, x, cfg, positions, kv_i, state, a_fmt)
        p_layer = layer_view(params["mamba"], li)
        pool = tree_map(lambda leaf: leaf[li], caches["mamba"])
        dh, new_m = mamba2_block(p_layer["mamba"], norm(p_layer["ln"], x, cfg.norm_kind,
                                                        cfg.norm_eps), cfg,
                                 cache=gather_slabs(pool, state.slabs) if paged else pool,
                                 a_fmt=a_fmt)
        x = x + dh
        if paged:
            scatter_slabs(pool, state.slabs, new_m)
        else:
            copy_into(pool, new_m)
    return norm(params["final_ln"], x, cfg.norm_kind, cfg.norm_eps)
