"""DeepSeek-V3 (MLA + MoE + multi-token prediction) in the port, and the
cache-free MLA and MoE blocks with the loss they feed, against the
reference on the CPU:

* the config and its SMOKE copy the reference; ``build_def`` and
  ``quantized_shape_tree`` equal repro's key for key, the unstacked
  ``mtp`` subtree included; the bridge carries ``mtp`` dense and packed;
  leaf-by-leaf init and packing (``ptq.init_packed``) gives
  ``pack_params(init_params(...))``'s bits;
* MLA's materialized form on both attention branches (S at most and past
  ``attn_chunk``), dense and packed, and the cache-free ``moe_layer`` with
  capacity drops and the grid pad;
* ``forward_hidden`` and its ``aux`` for the MLA, MoE and DeepSeek SMOKE
  configs, and ``loss_fn`` (nll, aux, mtp) for the packed DeepSeek, with every
  rounding of the two packages matched (``MlaForwardRoundings``): the
  logits of the hidden states agree to tests/test_torch_forward.py's 1e-5
  and the losses to ``F32_RTOL`` (1e-6: f32 sums in another order);
* ``loss_fn`` for every arch the port carries, as
  ``tests/test_arch_smoke.py::test_forward_and_loss`` runs it, with values:
  without matched roundings a bf16 element may tip one ulp in either
  package and reach the mean nll, so the values agree to ``LOSS_RTOL``.

``DS_CFG`` is DeepSeek's SMOKE widened so that every projection packs (the
SMOKE's latent and expert widths are below the 64 ``is_quantizable`` needs)
and the packed cases run the W4A8 GEMM on ``wk_b`` / ``wv_b`` and the
batched one on the experts; it keeps 1 dense and 1 MoE layer, two
segments of one layer each, so the reference's eager page transcodes share
their compiled ops across the two latent pools. The reference is
compiled with ``STRICT_OPTIONS``, one program for the cases of a family
(the MoE cases of one weight form, every arch's loss); weights come from
the port's seeded init (and ``pack_params``), handed to repro as the same
arrays. Served streams are in ``test_torch_deepseek_serve.py``."""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
import repro.models.mla as jmla
import repro_torch.models.layers as tlayers
import repro_torch.models.mla as tmla
from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.ptq import quantized_shape_tree as j_shape_tree
from repro.models import moe as jmoe
from repro.models.config import MLASpec, MoESpec
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.core.ptq import init_packed, pack_params, quantized_shape_tree
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import from_numpy
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import ParamDef, tree_items, tree_map

from test_torch_bridge import POLICY, flatten_jax, port_cfg, t, to_np
from test_torch_dense_forward import ForwardRoundings, _to_jax
from test_torch_gptq import _flatten_port, _flatten_sds, _np_dtype
from test_torch_mixed_engine import STRICT_OPTIONS
from test_torch_mla_logits import F32_RTOL
from test_torch_moe import _bf16_ulps
from test_torch_scheduler import one_thread  # noqa: F401  (autouse: torch on one thread)

NAME = "deepseek-v3-671b"
TOL = 1e-5  # logits of the hidden states, as tests/test_torch_forward.py
LOSS_RTOL = 1e-4  # loss values without matched roundings (measured: at most 1.2e-5)
SMOKE = j_get_smoke(NAME)
DS_CFG = dataclasses.replace(
    SMOKE, name="deepseek-tiny", d_model=128, n_layers=2,
    mla=MLASpec(q_lora_rank=64, kv_lora_rank=64, qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16),
    moe=MoESpec(n_experts=8, top_k=2, d_ff=64, n_shared_experts=1, shared_d_ff=64,
                capacity_factor=1.25, n_dense_layers=1, dense_d_ff=128))
TPOLICY = TPolicy(**vars(POLICY))


def _packed_to_jax(tree):
    """A port params tree in repro's types: PackedLinear for PackedLinear."""
    def leaf(x):
        if not isinstance(x, PackedLinear):
            return _to_jax(x)
        fields = {f: None if getattr(x, f) is None else _to_jax(getattr(x, f))
                  for f in PackedLinear._FIELDS}
        return jlayers.PackedLinear(**fields, w_fmt=x.w_fmt, a_fmt=x.a_fmt,
                                    group_size=x.group_size)
    return tree_map(leaf, tree, is_leaf=lambda x: isinstance(x, PackedLinear))


@functools.lru_cache(maxsize=None)
def model(jcfg, packed: bool, seed: int = 7):
    """The port's seeded init of ``jcfg`` (packed by the port's
    ``pack_params`` when ``packed``: the same leaves as repro's
    ``quantize_tree``, test_torch_moe.py) and the same tree in repro's
    types: (jcfg, repro params, port cfg, port params)."""
    tcfg = port_cfg(jcfg)
    tparams = tapi.init_params(tcfg, seed=seed, device="cpu")
    if packed:
        tparams = pack_params(tparams, tcfg, TPOLICY, device="cpu")
    return jcfg, _packed_to_jax(tparams), tcfg, tparams


class MlaForwardRoundings(ForwardRoundings):
    """``ForwardRoundings`` plus the sites that the MLA module and the loss
    call by their own names: MLA's norms (q_norm, kv_norm), rope and
    attention (the materialized form's ``_sdpa_full`` / ``_sdpa_chunked``),
    and ``layers.norm`` (``mtp_loss``'s ``mtp/ln``, imported at call
    time)."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        for mod, name, kind in ((jmla, "norm", "bf16"), (jmla, "apply_rope", "bf16"),
                                (jlayers, "norm", "bf16"), (jmla, "_sdpa_full", "attn"),
                                (jmla, "_sdpa_chunked", "attn")):
            monkeypatch.setattr(mod, name, self._reference(getattr(mod, name), kind))
        for mod, name in ((tmla, "norm"), (tmla, "apply_rope"), (tlayers, "norm")):
            monkeypatch.setattr(mod, name, self._port(getattr(mod, name), "bf16"))
        for name in ("_sdpa_full", "_sdpa_chunked"):
            monkeypatch.setattr(tmla, name, self._port_attention(getattr(tmla, name)))
        jax.clear_caches()


@pytest.fixture
def roundings(monkeypatch):
    yield MlaForwardRoundings(monkeypatch)
    jax.clear_caches()


def _strict(fn, *args):
    """``fn(*args)`` compiled with STRICT_OPTIONS, then run."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT_OPTIONS)(*args)


def _jlayer0(p):
    """Layer 0 of a repro segment's stacked subtree (sliced inside the
    compiled program: no eager op a leaf)."""
    return jax.tree_util.tree_map(lambda a: a[0], p)


def _layer0(p):
    """Layer 0 of a port segment's stacked subtree."""
    return tree_map(lambda a: a.layer(0) if isinstance(a, PackedLinear) else a[0], p,
                    is_leaf=lambda x: isinstance(x, PackedLinear))


def _bf16(rng, shape):
    return jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)


# -- config, params, bridge ----------------------------------------------------------
def test_config_copies_reference():
    assert dataclasses.asdict(t_get_config(NAME)) == dataclasses.asdict(j_get_config(NAME))
    assert dataclasses.asdict(t_get_smoke(NAME)) == dataclasses.asdict(SMOKE)
    assert "deepseek_v3_671b" in ARCHS


def _defs(tree):
    return {k: (tuple(d.shape), tuple(d.axes), d.dtype, d.init, d.scale)
            for k, d in tree_items(tree, is_leaf=lambda x: isinstance(x, ParamDef))}


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_build_def_and_quantized_shapes_equal_reference(full):
    """The ParamDef trees key for key (``mtp`` has no layer axis), and the
    serving checkpoint's shapes and dtypes: ``mtp/proj`` (d x 2d) and the
    MTP block's 3-D expert stacks packed, its router dense."""
    jcfg = j_get_config(NAME) if full else SMOKE
    tcfg = port_cfg(jcfg)
    jdefs, tdefs = jmodels.build_def(jcfg), tapi.build_def(tcfg)
    want = {k: (tuple(d.shape), tuple(d.axes), d.dtype, d.init, d.scale)
            for k, d in _flatten_sds(jdefs).items()}
    assert _defs(tdefs) == want
    assert tdefs["mtp"]["proj"].shape == (jcfg.d_model, 2 * jcfg.d_model)
    assert tdefs["mtp"]["block"]["ffn"]["moe"]["wu"].shape == \
        (jcfg.moe.n_experts, jcfg.moe.d_ff, jcfg.d_model)
    meta = _flatten_port(quantized_shape_tree(tdefs, TPOLICY))
    jshapes = {k: (tuple(v.shape), np.dtype(v.dtype))
               for k, v in _flatten_sds(j_shape_tree(jdefs, POLICY)).items()}
    assert {k: (tuple(m.shape), _np_dtype(m.dtype)) for k, m in meta.items()} == jshapes
    assert "mtp/proj/codes" in meta and "mtp/block/ffn/moe/router" in meta
    if full:
        assert tuple(meta["mtp/block/ffn/moe/wu/codes"].shape) == (256, 2048, 3584)
        assert tuple(meta["mtp/proj/codes"].shape) == (7168, 7168)


@pytest.mark.parametrize("packed", [False, True])
def test_bridge_carries_mtp(packed):
    """repro's tree crosses ``from_numpy`` whole, ``mtp`` included, bit for
    bit; packed, ``mtp/proj`` and the block's expert stacks arrive as
    PackedLinear with no layer axis and the router stays dense."""
    _, jparams, tcfg, tparams = model(DS_CFG, packed)
    flat = flatten_jax(jparams)
    got = _flatten_port(from_numpy(flat, tcfg, "cpu", policy=TPOLICY if packed else None))
    assert set(got) == set(flat) == set(_flatten_port(tparams))
    assert any(k.startswith("mtp/block/ffn/moe/") for k in got)
    for k, arr in flat.items():
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(arr).astype(to_np(got[k]).dtype),
                                      err_msg=k)
    moe = tparams["mtp"]["block"]["ffn"]["moe"]
    if packed:
        assert isinstance(tparams["mtp"]["proj"], PackedLinear)
        assert tuple(moe["wu"].codes.shape) == (8, 64, 64)  # (E, d_ff, d/2): unstacked
        assert isinstance(tparams["mtp"]["block"]["mixer"]["attn"]["wk_b"], PackedLinear)
    assert isinstance(moe["router"], torch.Tensor) and moe["router"].shape == (8, 128)


def test_leafwise_init_and_pack_equals_pack_params():
    """``ptq.init_packed`` (init and pack leaf by leaf, so the card never
    holds the dense and the packed tree at once) gives the bits of
    ``pack_params(init_params(cfg, seed))`` on the SMOKE config."""
    tcfg = port_cfg(SMOKE)
    want = _flatten_port(pack_params(tapi.init_params(tcfg, seed=3, device="cpu"), tcfg,
                                     TPOLICY, device="cpu"))
    got = _flatten_port(init_packed(tcfg, TPOLICY, seed=3, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# -- the cache-free blocks -------------------------------------------------------------
@pytest.mark.parametrize("s", [24, 40], ids=["sdpa_full", "sdpa_chunked"])
@pytest.mark.parametrize("packed", [False, True])
def test_materialized_mla_matches_reference(roundings, packed, s):
    """MLA without a cache on a whole sequence (layer 0), FP8 activations:
    k_nope and v expanded from c_kv by ``wk_b`` / ``wv_b`` (the W4A8 GEMM
    when packed), the rope key broadcast, v at its own width (16 against
    qk's 32); S = 24 takes ``_sdpa_full`` and S = 40 ``_sdpa_chunked``
    (``attn_chunk`` 32). Every rounding matched; the outputs agree to
    1e-5 of their largest."""
    jcfg, jparams, tcfg, tparams = model(DS_CFG, packed)
    tp = _layer0(tparams["segments"][0]["mixer"]["attn"])
    x = _bf16(np.random.default_rng(s + packed), (2, s, jcfg.d_model))
    roundings.monkeypatch.setattr(
        sys.modules["test_torch_mla_logits"], "MAX_TIPPED", 2 * s)
    jout, (tout, cache) = roundings.step(
        lambda: _strict(lambda p, xx: jmla.mla_attention(_jlayer0(p), xx, jcfg, jnp.arange(s),
                                                         a_fmt="fp8_e4m3")[0],
                        jparams["segments"][0]["mixer"]["attn"], x),
        lambda: tmla.mla_attention(tp, t(x), tcfg, torch.arange(s), a_fmt="fp8_e4m3"))
    assert cache is None and tout.dtype == torch.bfloat16 and tuple(tout.shape) == x.shape
    want = np.asarray(jout).astype(np.float32)
    np.testing.assert_allclose(to_np(tout), want, atol=TOL * np.abs(want).max(), rtol=0)


MOE_CASES = ((2, 24, 1024), (3, 13, 16), (2, 10, 4))


def _moe_x(packed, b, s):
    return _bf16(np.random.default_rng(b * s + packed), (b, s, DS_CFG.d_model))


@functools.lru_cache(maxsize=None)
def _reference_moe(packed: bool):
    """repro's MoE layer (layer 0 of the MoE segment) on every MOE_CASES
    input, in one strictly compiled program: {(b, s, group_size): (out,
    aux)}."""
    jcfg, jparams, _, _ = model(DS_CFG, packed)
    xs = [_moe_x(packed, b, s) for b, s, _ in MOE_CASES]
    outs = _strict(lambda p, xs: [jmoe.moe_layer(_jlayer0(p), x, jcfg, a_fmt="fp8_e4m3",
                                                 group_size=g)
                                  for x, (_, _, g) in zip(xs, MOE_CASES)],
                   jparams["segments"][1]["ffn"]["moe"], xs)
    return dict(zip(MOE_CASES, outs))


@pytest.mark.parametrize("b,s,group_size", MOE_CASES, ids=["one-group", "drops-grid-pad", "drops"])
@pytest.mark.parametrize("packed", [False, True])
def test_cache_free_moe_matches_reference(packed, b, s, group_size):
    """DeepSeek's MoE layer (8 experts top-2 plus the shared expert) with
    the grouped capacity dispatch: 48 tokens in one group (the forward's
    group_size 1024); 39 tokens in groups of 16 (2 groups of 20 with one
    pad token, capacity 6, assignments dropped); 20 tokens in groups of 4
    (capacity 1). Outputs at most one bf16 ulp apart in at most 1 % of the
    elements (the combine's f32 sum in another order can tip the cast, as
    test_torch_moe's tiers), the aux loss within F32_RTOL."""
    jcfg, _, tcfg, tparams = model(DS_CFG, packed)
    tp = _layer0(tparams["segments"][1]["ffn"]["moe"])
    x = _moe_x(packed, b, s)
    jout, jaux = _reference_moe(packed)[(b, s, group_size)]
    seen = []
    masks = tmoe._dispatch_masks

    def spy(logits, k, capacity):
        seen.append((tuple(logits.shape), capacity))
        out = masks(logits, k, capacity)
        seen.append(float(out[0].sum()))
        return out

    tmoe._dispatch_masks = spy
    try:
        tout, taux = tmoe.moe_layer(tp, t(np.asarray(x)), tcfg, a_fmt="fp8_e4m3",
                                    group_size=group_size)
    finally:
        tmoe._dispatch_masks = masks
    (shape, capacity), kept = seen
    if group_size < b * s:  # assignments dropped (pad rows route too)
        assert kept < shape[0] * shape[1] * jcfg.moe.top_k
    if (b, s) == (3, 13):
        assert shape[:2] == (2, 20) and capacity == 6  # one pad token
    ulps = _bf16_ulps(to_np(tout), np.asarray(jout).astype(np.float32))
    assert ulps.max() <= 1.0 and np.mean(ulps > 0) <= 0.01, (ulps.max(), np.mean(ulps > 0))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32_RTOL)


# -- forward_hidden, loss_fn -----------------------------------------------------------------
FORWARD_CASES = {"minicpm3-4b": (j_get_smoke("minicpm3-4b"), False, "fp8_e4m3"),
                 "olmoe-1b-7b": (j_get_smoke("olmoe-1b-7b"), False, "fp8_e4m3"),
                 "deepseek-smoke": (SMOKE, False, None)}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_hidden_and_aux_match_reference(roundings, case):
    """The cache-free forward over 2 x 40 tokens (the MLA attention past
    ``attn_chunk``, MoE in one group of 80), every rounding matched: the
    logits of the hidden states within 1e-5, ``aux`` (summed over the MoE
    layers; 0 for MiniCPM3) within F32_RTOL."""
    jcfg, packed, a_fmt = FORWARD_CASES[case]
    jcfg, jparams, tcfg, tparams = model(jcfg, packed)
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    (jh, jaux), (th, caches, taux) = roundings.forward(
        lambda: _strict(lambda p, tk: jmodels.forward_hidden(
            p, jcfg, {"tokens": tk}, a_fmt=a_fmt)[::2], jparams, jnp.asarray(tokens)),
        lambda: tapi.forward_hidden(tparams, tcfg, {"tokens": t(tokens)}, a_fmt=a_fmt),
        tokens.size, jcfg.n_layers)
    assert caches is None and th.shape == jh.shape and th.dtype == torch.bfloat16
    head = np.asarray(jparams["embed"] if jcfg.tie_embeddings else jparams["lm_head"],
                      np.float32)
    np.testing.assert_allclose(to_np(th) @ head.T, np.asarray(jh, np.float32) @ head.T,
                               atol=TOL, rtol=0)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32_RTOL)
    assert (float(taux) > 0) == (jcfg.moe is not None)


def test_deepseek_loss_fn_matches_reference(roundings):
    """``loss_fn`` of the packed DeepSeek with ``mtp_weight`` 0.3 (labels
    the next tokens, a mask over a fifth of them), every rounding matched,
    the MTP block's included: nll, aux, the token count, mtp and the total
    within F32_RTOL."""
    jcfg, jparams, tcfg, tparams = model(DS_CFG, True)
    rng = np.random.default_rng(13)
    seq = rng.integers(0, jcfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:],
             "mask": (rng.random((2, 40)) > 0.2).astype(np.float32)}
    kw = dict(a_fmt="fp8_e4m3", remat=False, mtp_weight=0.3)
    (jl, jm), (tl, tm) = roundings.forward(
        lambda: _strict(lambda p, bb: jmodels.loss_fn(p, jcfg, bb, **kw),
                        jparams, {k: jnp.asarray(v) for k, v in batch.items()}),
        lambda: tapi.loss_fn(tparams, tcfg, {k: t(v) for k, v in batch.items()}, **kw),
        seq.size, jcfg.n_layers + 1)
    assert set(tm) == set(jm) == {"nll", "aux", "tokens", "mtp"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=F32_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_RTOL)


def _loss_batch(jcfg, rng, s=24):
    """test_arch_smoke's batch: tokens and labels, behind llava's patches
    (which carry no loss) or beside whisper's frames."""
    batch = {}
    if jcfg.frontend == "vision_patches":
        batch["patches"] = rng.normal(size=(2, jcfg.n_patches, 1024)).astype(np.float32)
    if jcfg.encoder_layers:
        batch["frames"] = rng.normal(size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    return batch


LOSS_CASES = [(arch, 0.0) for arch in ARCHS] + [("deepseek_v3_671b", 0.3)]


@functools.lru_cache(maxsize=None)
def _reference_losses():
    """repro's ``loss_fn`` for every LOSS_CASES case (each arch's SMOKE
    params from seed 0 and ``_loss_batch``), in one strictly compiled
    program: {case: (total, metrics)}."""
    cfgs = {arch: j_get_smoke(arch) for arch, _ in LOSS_CASES}
    params = {arch: model(cfg, False, seed=0)[1] for arch, cfg in cfgs.items()}
    batches = {arch: {k: jnp.asarray(v) for k, v in
                      _loss_batch(cfg, np.random.default_rng(3)).items()}
               for arch, cfg in cfgs.items()}
    outs = _strict(lambda ps, bs: [jmodels.loss_fn(ps[arch], cfgs[arch], bs[arch], remat=False,
                                                   mtp_weight=w) for arch, w in LOSS_CASES],
                   params, batches)
    return dict(zip(LOSS_CASES, outs))


@pytest.mark.parametrize("arch,mtp_weight", LOSS_CASES)
def test_loss_fn_matches_reference_for_every_arch(arch, mtp_weight):
    """Every config the port carries at its SMOKE size: ``loss_fn``'s
    metrics and total against the reference's (``remat=False``; DeepSeek
    also with ``mtp_weight`` 0.3, which adds the mtp metric) within
    LOSS_RTOL, finite and positive."""
    jcfg = j_get_smoke(arch)
    _, _, tcfg, tparams = model(jcfg, False, seed=0)
    batch = _loss_batch(jcfg, np.random.default_rng(3))
    jl, jm = _reference_losses()[(arch, mtp_weight)]
    tl, tm = tapi.loss_fn(tparams, tcfg, {k: t(v) for k, v in batch.items()}, remat=False,
                          mtp_weight=mtp_weight)
    assert set(tm) == set(jm) == {"nll", "aux", "tokens"} | ({"mtp"} if mtp_weight else set())
    assert np.isfinite(float(tl)) and float(tl) > 0 and tl.shape == ()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
