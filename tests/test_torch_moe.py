"""The MoE serving path of the port (OLMoE's family) against repro, on the
same numpy inputs:

* ``moe_layer`` at the serving ``group_size=1`` and at a capacity-bounded
  group size that drops assignments, dense and packed (the batched W4A8
  plain version with FP8 activations), and with a shared expert: outputs
  within one bf16 ulp of repro's eager call (the combine is an f32 sum in
  another order, which can tip the bf16 cast), the dispatch identical,
  the combine weights and the aux loss within 1e-6;
* the row-1d plain version (``w4a8_batched_matmul_ref`` with FP8
  activations) against repro's oracle within 1e-4 and its interpret-mode
  Pallas kernel within that suite's 2e-2, at the shapes of
  ``tests/test_w4a8_fused.py::test_batched_fused_matches_oracle`` and
  with most rows zero, as served;
* rope in GQA attention: decode, prefill-chunk and mixed-step logits of a
  dense rope model against the strictly compiled repro within 1e-5, the
  roundings matched (``test_torch_moe_logits.GqaPair``);
* the top-k order on ties, and the OLMoE configs.

Logits of the MoE model are in ``test_torch_moe_logits.py``, served
streams in ``test_torch_moe_serve.py``. ``MOE_CFG`` is a tiny OLMoE whose
every projection is quantizable (OLMoE's SMOKE experts, d_ff 32, are
narrower than the 64 that ``is_quantizable`` needs, so they would stay
dense and never reach the batched W4A8 path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import _pack_batched
from repro.kernels import ref as jref
from repro.kernels.w4a8_fused import w4a8_fused_batched_pallas
from repro.models import moe as jmoe
from repro.models.config import ArchConfig, MoESpec
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import layer_view

from test_torch_bridge import t, to_np
from test_torch_mla import _model
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

MOE_CFG = ArchConfig(
    name="moe-tiny", family="moe", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab_size=96, attn_kind="gqa", norm_kind="rmsnorm", act_kind="silu",
    mlp_gated=True, attn_chunk=64,
    moe=MoESpec(n_experts=8, top_k=2, d_ff=64, capacity_factor=1.25))
SHARED_CFG = dataclasses.replace(
    MOE_CFG, name="moe-tiny-shared",
    moe=MoESpec(n_experts=8, top_k=2, d_ff=64, n_shared_experts=1, shared_d_ff=64))
ROPE_CFG = ArchConfig(
    name="gqa-rope-tiny", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=96, attn_kind="gqa", norm_kind="rmsnorm", act_kind="silu",
    mlp_gated=True, attn_chunk=64)


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (at least the smallest
    normal's)."""
    want = np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return np.abs(np.asarray(got, np.float64) - want) / ulp


# -- moe_layer -----------------------------------------------------------------------
@pytest.mark.parametrize("cfg,packed,group_size", [
    (MOE_CFG, False, 1), (MOE_CFG, True, 1), (MOE_CFG, False, 4), (MOE_CFG, True, 4),
    (SHARED_CFG, True, 1)],
    ids=["dense-g1", "packed-g1", "dense-g4", "packed-g4", "shared-packed-g1"])
def test_moe_layer_matches_reference(cfg, packed, group_size):
    """One layer's MoE on 14 tokens with FP8 activations. ``group_size``
    1 routes per token (serving); 4 makes groups of 4 tokens with a
    capacity of one token per expert, so assignments drop (and 14 tokens
    pad to 16). Outputs at most one bf16 ulp apart, in at most 1 % of the
    elements."""
    jcfg, jparams, tcfg, tparams = _model(cfg, packed)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["segments"][0]["ffn"]["moe"])
    tp = layer_view(tparams["segments"][0], 0)["ffn"]["moe"]
    rng = np.random.default_rng(group_size + 2 * packed)
    x = jnp.asarray(rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    jout, jaux = jmoe.moe_layer(jp, x, jcfg, a_fmt="fp8_e4m3", group_size=group_size)
    tout, taux = tmoe.moe_layer(tp, t(np.asarray(x)), tcfg, a_fmt="fp8_e4m3",
                                group_size=group_size)
    assert tout.dtype == torch.bfloat16 and tuple(tout.shape) == x.shape
    ulps = _bf16_ulps(to_np(tout), np.asarray(jout).astype(np.float32))
    assert ulps.max() <= 1.0 and np.mean(ulps > 0) <= 0.01, (ulps.max(), np.mean(ulps > 0))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_dispatch_masks_drop_late_as_reference(capacity):
    """Groups of 6 tokens over 4 experts, top-2, at capacities that drop
    most, some and none of the assignments: the dispatch identical
    (position in an expert follows token order, then k-slot order), the
    combine and the probabilities within 1e-6."""
    rng = np.random.default_rng(capacity)
    logits = rng.normal(size=(3, 6, 4)).astype(np.float32)
    jd, jc, jpr = jmoe._dispatch_masks(jnp.asarray(logits), 2, capacity)
    td, tc, tpr = tmoe._dispatch_masks(t(logits), 2, capacity)
    assert tuple(td.shape) == (3, 6, 4, capacity)
    np.testing.assert_array_equal(to_np(td), np.asarray(jd))
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(tpr), np.asarray(jpr), rtol=1e-6, atol=1e-7)
    if capacity == 1:
        assert float(td.sum()) < 3 * 6 * 2  # assignments dropped


def test_top_k_takes_the_lower_index_first_on_ties():
    """Equal router probabilities pick the experts ``jax.lax.top_k`` picks:
    among equal values the lower index comes first."""
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.1, 0.5, 0.25, 0.0],
                  [0.125] * 8,
                  [0.0, 0.3, 0.3, 0.1, 0.3, 0.0, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(t(x), k)
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji), err_msg=f"k={k}")
        np.testing.assert_array_equal(to_np(tv), np.asarray(jv), err_msg=f"k={k}")
    _, ti = tmoe.top_k(t(x), 3)
    assert ti.tolist() == [[1, 3, 5], [0, 1, 2], [1, 2, 4]]


# -- row 1d: the batched W4A8 with FP8 activations ----------------------------------------
@pytest.mark.parametrize("routed", [False, True], ids=["dense-rows", "routed-rows"])
@pytest.mark.parametrize("scale_mode,lorc_rank", [("none", 0), ("m2", 8)])
def test_row_1d_plain_matches_reference(scale_mode, lorc_rank, routed):
    """The shapes of tests/test_w4a8_fused.py::test_batched_fused_matches_oracle,
    normal orientation, FP8 activations quantized token-wise: the port's
    plain version within 1e-4 of repro's oracle (the same bf16 products,
    another f32 summation order) and within that suite's 2e-2 of the
    interpret-mode Pallas kernel. ``routed``: as an expert slab is served,
    each token's row nonzero in 2 of the 4 slabs, zero elsewhere (a zero
    row quantizes under the 1e-12 scale floor to zeros and comes out 0)."""
    e, n, k, m, group = 4, 128, 256, 24, 128
    rng = np.random.default_rng(e * n + lorc_rank + routed)
    w = jnp.asarray(rng.normal(size=(e, n, k)).astype(np.float32) * 0.05)
    pw = _pack_batched(w, JPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=group,
                                  scale_mode=scale_mode, lorc_rank=lorc_rank))
    xn = rng.normal(size=(e, m, k)).astype(np.float32)
    if routed:
        keep = np.zeros((e, m), bool)
        for j in range(m):
            keep[rng.choice(e, 2, replace=False), j] = True
        xn = np.where(keep[..., None], xn, 0.0).astype(np.float32)
    x = jnp.asarray(xn).astype(jnp.bfloat16)
    opt = lambda a: None if a is None else t(np.asarray(a))
    tw = tlayers.PackedLinear(codes=t(np.asarray(pw.codes)), scale=t(np.asarray(pw.scale)),
                              s_max=opt(pw.s_max), shifts=opt(pw.shifts),
                              lorc_a=opt(pw.lorc_a), lorc_b=opt(pw.lorc_b),
                              a_fmt="fp8_e4m3", group_size=group)
    y = to_np(ops.w4a8_matmul_batched(t(np.asarray(x)), tw))
    y_ref = np.asarray(jref.w4a8_batched_matmul_ref(
        x, pw.codes, pw.scale, pw.lorc_a, pw.lorc_b, a_fmt="fp8_e4m3", group_size=group))
    assert y.shape == y_ref.shape == (e, m, n)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)
    y_pal = np.asarray(w4a8_fused_batched_pallas(
        x, pw.codes, pw.scale, pw.s_max, pw.shifts, pw.lorc_a, pw.lorc_b, a_fmt="fp8_e4m3",
        group_size=group, interpret=True))
    np.testing.assert_allclose(y, y_pal, rtol=2e-2, atol=2e-2)
    if routed:
        assert np.all(y[~keep] == 0) and np.all(np.abs(y[keep]).sum(-1) > 0)


# -- packing the expert stacks ------------------------------------------------------------
def test_pack_batched_matches_reference():
    """A stacked (L, E, out, in) expert weight packed by the port's batched
    ``_pack_batched`` (one call per chunk of slices, one batched LoRC) and by
    repro's, slice by slice: codes, scales, s_max and shifts identical,
    every slice's LoRC correction A·B within bf16's resolution of its
    magnitude (tests/test_torch_core.py::test_pack_linear_bit_exact's
    tolerance)."""
    from repro_torch.core.policy import QuantPolicy as TPolicy
    from repro_torch.core.ptq import _pack_batched as t_pack_batched

    kw = dict(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=64, scale_mode="m2", lorc_rank=8)
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.normal(size=(2, 5, 64, 128)).astype(np.float32) * 0.05
                    ).astype(jnp.bfloat16)
    jp = _pack_batched(w, JPolicy(**kw))
    tp = t_pack_batched(t(np.asarray(w)), TPolicy(**kw), chunk=3)
    for field in ("codes", "scale", "s_max", "shifts"):
        np.testing.assert_array_equal(to_np(getattr(tp, field)), np.asarray(getattr(jp, field)),
                                      err_msg=field)
    corr_t = to_np(tp.lorc_a.float() @ tp.lorc_b.float())
    corr_j = np.asarray(jp.lorc_a.astype(jnp.float32) @ jp.lorc_b.astype(jnp.float32))
    tol = 2.0 ** -7 * np.abs(corr_j).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(corr_t - corr_j) <= tol)


def test_port_packs_the_leaves_repro_packs():
    """``pack_params`` on the dense tiny MoE packs exactly the leaves that
    repro's ``quantize_tree`` packs: the attention projections and the
    stacked experts (``layer(i)`` an (E, ...) batched PackedLinear), not
    the router, the norms or the embeddings; codes, scales and shifts
    identical to repro's."""
    from repro_torch.core.policy import QuantPolicy as TPolicy
    from repro_torch.core.ptq import pack_params
    from repro_torch.models.params import tree_items

    from test_torch_bridge import POLICY

    _, _, tcfg, tdense = _model(MOE_CFG, False)
    _, _, _, tpacked_ref = _model(MOE_CFG, True)
    tpacked = pack_params(tdense, tcfg, TPolicy(**vars(POLICY)), device="cpu")
    is_packed = lambda x: isinstance(x, tlayers.PackedLinear)
    got = dict(tree_items(tpacked, is_leaf=is_packed))
    want = dict(tree_items(tpacked_ref, is_leaf=is_packed))
    assert got.keys() == want.keys()
    packed = sorted(k for k, v in got.items() if is_packed(v))
    assert packed == sorted(k for k, v in want.items() if is_packed(v))
    assert "segments/0/ffn/moe/wu" in packed and "segments/0/ffn/moe/router" not in packed
    moe = layer_view(tpacked["segments"][0], 1)["ffn"]["moe"]
    assert moe["wu"].codes.shape == (8, 64, 64) and moe["router"].shape == (8, 128)
    for path in packed:
        for field in ("codes", "scale", "s_max", "shifts"):
            assert torch.equal(getattr(got[path], field), getattr(want[path], field)), \
                (path, field)


def test_lorc_of_an_exact_weight_is_zero():
    """No quantization error (and a rank above the error's): zero factors,
    never a 0/0 from the Gram route's division by the singular values."""
    from repro_torch.core.lorc import lorc_compensate

    w = torch.randn(3, 16, 8)
    f = lorc_compensate(w, w, 8)
    assert f.a.shape == (3, 16, 8) and f.b.shape == (3, 8, 8)
    assert torch.equal(f.a, torch.zeros_like(f.a)) and torch.equal(f.b, torch.zeros_like(f.b))
    w_q = w.clone()
    w_q[..., 0, 0] += 1.0  # a rank-1 error: one nonzero component, the rest zero
    f = lorc_compensate(w, w_q, 4)
    assert bool(torch.isfinite(f.a).all() and torch.isfinite(f.b).all())
    torch.testing.assert_close(f.a @ f.b, w - w_q, rtol=0, atol=1e-6)


# -- rope in GQA attention ---------------------------------------------------------------
@pytest.mark.parametrize("packed,fmt", [(False, None), (True, "fp8_e4m3")],
                         ids=["dense-bf16", "packed-fp8"])
def test_gqa_rope_logits_match_reference(roundings, packed, fmt):
    """A dense GQA decoder with rope (KV 2 of 4 heads, hd 32): two prefill
    chunks, decode steps with an idle row and a page crossing, then one
    mixed step over frozen pages; every step's logits within 1e-5 of the
    strictly compiled repro (``test_torch_moe_logits.GqaPair``)."""
    from test_torch_moe_logits import run_decode_and_prefill, run_mixed_step

    run_decode_and_prefill(roundings, ROPE_CFG, packed, fmt)
    run_mixed_step(roundings, ROPE_CFG, packed)


@pytest.fixture
def roundings(monkeypatch):
    from test_torch_mla_logits import Roundings

    yield Roundings(monkeypatch)
    jax.clear_caches()


# -- configs -----------------------------------------------------------------------
def test_olmoe_configs_copy_reference():
    from repro.configs import get_config, get_smoke
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs import get_smoke as tget_smoke
    from repro_torch.models.transformer import segments_for

    for get, tget in ((get_config, tget_config), (get_smoke, tget_smoke)):
        assert dataclasses.asdict(tget("olmoe-1b-7b")) == dataclasses.asdict(get("olmoe-1b-7b"))
    segs = segments_for(tget_config("olmoe-1b-7b"))
    assert [(s.mixer, s.ffn, s.count) for s in segs] == [("gqa", "moe", 16)]
    deepseek = dataclasses.replace(tget_config("olmoe-1b-7b"), moe=dataclasses.replace(
        tget_config("olmoe-1b-7b").moe, n_dense_layers=3, dense_d_ff=4096))
    assert [(s.ffn, s.count, s.d_ff) for s in segments_for(deepseek)] == \
        [("mlp", 3, 4096), ("moe", 13, 0)]
