"""Whole-model PTQ driver (port of ``repro.core.ptq``).

  * ``pack_linear(w, policy, qt=None)`` — one weight -> PackedLinear (RTN,
    or a pre-computed GPTQ ``QuantizedTensor`` packed as it is).
  * ``quantize_tree(params, defs, policy)`` — replace every quantizable
    leaf of a param tree by its W4A8 deployment form (RTN, no calibration).
  * ``pack_params(params, cfg, policy, device)`` — the serving entry point:
    the tree of ``models.build_def(cfg)`` RTN-quantized on ``device``.
  * ``init_packed(cfg, policy, seed, device)`` — ``pack_params`` of the
    seeded random init, drawn and packed leaf by leaf (the same bits, never
    the dense tree whole).
  * ``quantized_shape_tree(defs, policy)`` — the serving checkpoint's
    shapes and dtypes as ``meta`` tensors (no allocation).
  * ``gptq_quantize_lm(params, cfg, calib, policy)`` — the paper's
    pipeline on the dense family: layer-by-layer GPTQ over a calibration
    stream with the error propagated through the quantized prefix,
    capturing the four module inputs of Fig. 1 (q_proj, out_proj, fc1,
    fc2; + gate for gated MLPs), then LoRC.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import _DTYPES, ParamDef, tree_map

from .formats import FORMATS, fp_encode, pack_nibbles
from .gptq import HessianState, full_f32, gptq_quantize, hessian_init, hessian_update
from .lorc import lorc_compensate
from .policy import QuantPolicy
from .quantize import QuantizedTensor, fake_quantize_weight, quantize_weight
from .scales import apply_scale_constraint, constrain_scales_m2

__all__ = ["is_quantizable", "effective_group", "pack_linear", "packed_def", "quantize_leaf",
           "quantize_tree", "quantized_shape_tree", "pack_params", "init_packed",
           "quantize_one", "gptq_quantize_lm"]


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


def _rtn(w32: torch.Tensor, policy: QuantPolicy, gs: int) -> QuantizedTensor:
    """Round to nearest under ``policy``'s scale constraint: scales from
    the absmax, constrained (M1/M2), then the weights rounded at them."""
    scale = apply_scale_constraint(quantize_weight(w32, policy.w_fmt, gs).scale,
                                   policy.scale_mode)
    return quantize_weight(w32, policy.w_fmt, gs, scale=scale)


def _encode_codes(values: torch.Tensor, fmt, block: int = 1 << 26) -> torch.Tensor:
    """``pack_nibbles(fp_encode(values, fmt))`` a block of rows (about
    ``block`` values) at a time: the same codes, with the encoder's
    temporaries bounded (a 73728 x 18432 weight's whole-tensor encode holds
    ~25 GB of them)."""
    rows = values.reshape(-1, values.shape[-1])
    step = max(1, block // rows.shape[-1])
    codes = torch.cat([pack_nibbles(fp_encode(r, fmt)) for r in rows.split(step)])
    return codes.reshape(tuple(values.shape[:-1]) + (-1,))


def pack_linear(w: torch.Tensor, policy: QuantPolicy, qt: Optional[QuantizedTensor] = None,
                with_lorc: Optional[bool] = None) -> Optional[PackedLinear]:
    """Quantize and nibble-pack one (out, in) FP4 weight, or a stack
    (..., out, in) of them, each slice as on its own (non-FP4 policies
    return None: they stay dense, fake-quantized). ``qt`` may carry a GPTQ
    result, packed as it is; without it the weight is RTN-quantized.
    LoRC (rank ``policy.lorc_rank``) corrects ``w`` - ``qt``'s dequantized
    weight unless ``with_lorc`` says otherwise."""
    if not str(policy.w_fmt).startswith("fp4"):
        return None
    w32 = w.to(torch.float32)
    if qt is None:
        qt = _rtn(w32, policy, effective_group(w.shape[-1], policy.group_size))
    lorc = None
    if (policy.lorc_rank > 0) if with_lorc is None else with_lorc:
        lorc = lorc_compensate(w32, qt.dequantize(), policy.lorc_rank,
                               quantize_factors=policy.lorc_fmt)
    del w32
    codes = _encode_codes(qt.values, FORMATS[policy.w_fmt])
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


def quantize_leaf(path: str, d: ParamDef, p: torch.Tensor, policy: QuantPolicy):
    """One leaf ``p`` of a params tree (at ``path``, defined by ``d``) as
    ``quantize_tree`` leaves it: a PackedLinear when quantizable under an
    FP4 policy, fake-quantized in place of its values under another, or as
    it is."""
    if not is_quantizable(d, path):
        return p
    if str(policy.w_fmt).startswith("fp4"):
        return pack_linear(p, policy) if len(d.shape) == 2 else _pack_batched(p, policy)
    gs = effective_group(d.shape[-1], policy.group_size)
    flat = p.reshape((-1,) + tuple(p.shape[-2:])).to(torch.float32)
    q = torch.stack([fake_quantize_weight(flat[i], policy.w_fmt, gs)
                     for i in range(flat.shape[0])])
    return q.reshape(p.shape).to(p.dtype)


def quantize_tree(params, defs, policy: QuantPolicy):
    """RTN-quantize every quantizable leaf of ``params`` (structure given by
    the ParamDef tree ``defs``). FP4 leaves become PackedLinear; other
    weight formats stay dense, fake-quantized."""
    return _zip_map(lambda path, d, p: quantize_leaf(path, d, p, policy), defs, params, "")


def _zip_map(fn, defs, params, path):
    """Map ``fn(path, def, leaf)`` over the ParamDef tree and its params."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(defs, ParamDef):
        return fn(path, defs, params)
    if isinstance(defs, dict):
        return {k: _zip_map(fn, defs[k], params[k], join(k)) for k in defs}
    return [_zip_map(fn, d, p, join(i))
            for i, (d, p) in enumerate(zip(defs, params))]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def packed_def(d: ParamDef, policy: QuantPolicy) -> PackedLinear:
    """The PackedLinear ``quantize_tree`` makes of a leaf, as ``meta``
    tensors: the dry-run stand-in for a quantized checkpoint."""
    lead, (out_f, in_f) = tuple(d.shape[:-2]), tuple(d.shape[-2:])
    gs = effective_group(in_f, policy.group_size)
    m2, r = policy.scale_mode == "m2", policy.lorc_rank
    return PackedLinear(
        codes=_meta(lead + (out_f, in_f // 2), torch.uint8),
        scale=_meta(lead + (out_f, in_f // gs), torch.float32),
        s_max=_meta(lead + (out_f, 1), torch.float32) if m2 else None,
        shifts=_meta(lead + (out_f, in_f // gs), torch.int8) if m2 else None,
        lorc_a=_meta(lead + (out_f, r), torch.bfloat16) if r else None,
        lorc_b=_meta(lead + (r, in_f), torch.bfloat16) if r else None,
        w_fmt=policy.w_fmt, a_fmt=policy.a_fmt, group_size=gs)


def quantized_shape_tree(defs, policy: QuantPolicy):
    """The serving checkpoint's tree as ``meta`` tensors (shapes and
    dtypes, nothing allocated)."""
    def visit(path, d, _p):
        if is_quantizable(d, path) and str(policy.w_fmt).startswith("fp4"):
            return packed_def(d, policy)
        return _meta(d.shape, _DTYPES[d.dtype])

    return _zip_map(visit, defs, defs, "")


def pack_params(params, cfg, policy: QuantPolicy, device=None):
    """The serving checkpoint: ``params`` moved to ``device`` (the card
    unless ``device='cpu'``) and RTN-quantized under ``policy``."""
    from repro_torch.models import api

    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), params)
    with torch.no_grad():
        return quantize_tree(params, api.build_def(cfg), policy)


@torch.no_grad()
def init_packed(cfg, policy: QuantPolicy, seed: int = 0, device=None):
    """``pack_params(api.init_params(cfg, seed), cfg, policy)`` taken leaf
    by leaf: each weight is drawn from the one seeded generator in the
    tree's order (``init_params``'s stream) and quantized before the next
    is drawn, so ``device`` (the card unless ``device='cpu'``) never holds
    the dense tree beside the packed one. The same bits as the two-step
    route."""
    from repro_torch.models import api
    from repro_torch.models.params import init_leaf

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    defs = api.build_def(cfg)
    return _zip_map(lambda path, d, _: quantize_leaf(path, d, init_leaf(d, gen, device), policy),
                    defs, defs, "")


# ---------------------------------------------------------------------------
# GPTQ pipeline for the dense (gqa + mlp) LM family: the paper's procedure
# ---------------------------------------------------------------------------
_FIG1_WEIGHTS = ((("mixer", "attn", "wq"), "qkv"), (("mixer", "attn", "wk"), "qkv"),
                 (("mixer", "attn", "wv"), "qkv"), (("mixer", "attn", "wo"), "out"),
                 (("ffn", "mlp", "up"), "fc1"), (("ffn", "mlp", "down"), "fc2"))


def quantize_one(w: torch.Tensor, hessian: Optional[HessianState], policy: QuantPolicy):
    """One (out, in) weight under ``policy``: GPTQ on its input Hessian
    (``method='gptq'``) or RTN, then LoRC added to the dequantized weight.
    Returns ``(w_hat in w's dtype, the QuantizedTensor before LoRC)``."""
    return _quantize_sharing(["w"], [w], hessian, policy)["w"]


def _quantize_sharing(names, ws, hessian, policy: QuantPolicy) -> dict:
    """``quantize_one`` of weights that share an input Hessian (q, k and v;
    up and gate), by name. GPTQ sweeps their rows stacked, in one pass of
    the columns: a row's arithmetic reads no other row, so each weight's
    result is its own sweep's, with a third of the launches for q, k, v."""
    gs = effective_group(ws[0].shape[-1], policy.group_size)
    w32s = [w.to(torch.float32) for w in ws]
    if policy.method == "gptq":
        _, qt = gptq_quantize(torch.cat(w32s), hessian.h, policy.w_fmt, group_size=gs,
                              scale_mode=policy.scale_mode, damp=policy.damp,
                              block=min(128, gs))
        rows = [w.shape[0] for w in ws]
        qts = [qt._replace(values=v, scale=sc)
               for v, sc in zip(qt.values.split(rows), qt.scale.split(rows))]
    else:
        qts = [_rtn(w32, policy, gs) for w32 in w32s]
    out = {}
    for name, w, w32, qt in zip(names, ws, w32s, qts):
        w_hat = qt.dequantize()
        if policy.lorc_rank:
            fac = lorc_compensate(w32, w_hat, policy.lorc_rank, quantize_factors=policy.lorc_fmt)
            w_hat = w_hat + fac.a @ fac.b
        out[name] = (w_hat.to(w.dtype), qt)
    return out


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _capture(pm, pf, x: torch.Tensor, cfg, upd) -> None:
    """One calibration batch through a layer's float weights, handing the
    four Fig.-1 module inputs to ``upd(key, value)``. The attention is the
    full softmax whatever the sequence length, without the window (the
    reference's capture)."""
    from repro_torch.models.attention import _repeat_kv, _sdpa_full, block_mask
    from repro_torch.models.layers import activation, apply_rope, linear, norm

    b, s, _ = x.shape
    nk, hd, h_q, kv = cfg.norm_kind, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h_ln = norm(pm["ln"], x, nk, cfg.norm_eps)
    upd("qkv", h_ln)
    attn = pm["attn"]
    q = linear(attn["wq"], h_ln, attn.get("bq")).reshape(b, s, h_q, hd)
    k = linear(attn["wk"], h_ln).reshape(b, s, kv, hd)
    v = linear(attn["wv"], h_ln, attn.get("bv")).reshape(b, s, kv, hd)
    if cfg.pos_embedding == "rope":
        pos = torch.arange(s, device=x.device)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    g = h_q // kv
    mask = block_mask(s, s, 0, 0, cfg.causal, 0, device=x.device)
    o = _sdpa_full(q, _repeat_kv(k, g), _repeat_kv(v, g), mask).reshape(b, s, h_q * hd)
    upd("out", o)
    x_mid = x + linear(attn["wo"], o, attn.get("bo"))
    f_ln = norm(pf["ln"], x_mid, nk, cfg.norm_eps)
    upd("fc1", f_ln)
    mlp = pf["mlp"]
    up = linear(mlp["up"], f_ln, mlp.get("up_b"))
    if "gate" in mlp:
        hmid = activation(linear(mlp["gate"], f_ln), cfg.act_kind) * up
    else:
        hmid = activation(up, cfg.act_kind)
    upd("fc2", hmid)


@torch.no_grad()
def gptq_quantize_lm(params, cfg, calib_batches: List[dict], policy: QuantPolicy,
                     observe: Optional[Callable] = None):
    """Layer-by-layer GPTQ with error propagation (paper §3 / Appendix A)
    on the dense transformer family (GQA mixer, MLP ffn, no MoE / SSM), on
    the device of ``params``. For each layer it captures the four Fig.-1
    module inputs over ``calib_batches`` (their ``tokens``; a batch on the
    CPU is moved), quantizes the layer's weights against their Hessians and
    passes the batches through the quantized layer. Returns a new params
    tree whose quantizable weights are the dense dequantized results (+
    LoRC) in their own dtype. ``observe(layer, name, w, hessian, qt)``, when
    given, sees each weight before it is replaced: the float weight, its
    HessianState and its QuantizedTensor before LoRC."""
    from repro_torch.models import transformer as _tf

    assert cfg.attn_kind == "gqa" and cfg.moe is None and cfg.ssm is None
    seg = _tf.segments_for(cfg)[0]
    dev = params["embed"].device
    xs = []
    for batch in calib_batches:
        x = _tf._embed_tokens(params, cfg, batch["tokens"].to(dev))
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"][: x.shape[1]][None].to(x.dtype)
        xs.append(x)

    new_stack = tree_map(lambda a: a.clone(), params["segments"][0])
    wmap = _FIG1_WEIGHTS
    if "gate" in new_stack["ffn"]["mlp"]:
        wmap += ((("ffn", "mlp", "gate"), "fc1"),)
    with full_f32():
        for li in range(seg.count):
            p_layer = _tf.layer_view(new_stack, li)
            caps = {}

            def upd(key, val):
                caps[key] = hessian_update(caps.get(key) or hessian_init(val.shape[-1], dev), val)

            for x in xs:
                _capture(p_layer["mixer"], p_layer["ffn"], x, cfg, upd)
            for cap in caps:
                sharing = [keys for keys, c in wmap if c == cap]
                names = ["/".join(keys) for keys in sharing]
                ws = [_leaf(new_stack, keys)[li] for keys in sharing]
                done = _quantize_sharing(names, ws, caps[cap], policy)
                for name, keys, w_old in zip(names, sharing, ws):
                    w_new, qt = done[name]
                    if observe is not None:
                        observe(li, name, w_old.clone(), caps[cap], qt)
                    _leaf(new_stack, keys)[li] = w_new
            p_q = _tf.layer_view(new_stack, li)
            xs = [_tf.block_apply(p_q, x, cfg, seg, torch.arange(x.shape[1], device=dev))[0]
                  for x in xs]
    out = dict(params)
    out["segments"] = [new_stack]
    return out
