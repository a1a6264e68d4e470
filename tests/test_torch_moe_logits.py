"""The MoE serving path of the port against repro: logits of the packed
tiny OLMoE (``test_torch_moe.MOE_CFG``) at every step -- two prefill
chunks, decode steps with an idle row and a page crossing, and a mixed
step over frozen FP4 pages -- within 1e-5 of repro compiled with excess
precision off.

As in ``test_torch_mla_logits.py``, ``Roundings`` matches every rounding
of a step between the packages and feeds the port the reference's: the
GQA attention's and the experts' bf16 linear outputs, the FP8 activations
(the ``quant_act`` sites and the batched W4A8's own), the page codes, the
norms, and the MoE layer's routing and combine. Its routing site asserts
that both packages send every token to the same experts: a tipped expert
choice is no one-step tip, it changes the token's whole update.
``GqaPair`` and the two step sequences also serve the GQA rope test in
``test_torch_moe.py``.
"""
import numpy as np
import pytest

from repro.runtime import kv_cache as jkvc
from repro_torch.runtime import kv_cache as tkvc  # noqa: F401

from test_torch_bridge import t
from test_torch_mla import _model
from test_torch_mla_logits import _Pair, roundings  # noqa: F401
from test_torch_moe import MOE_CFG
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)


class GqaPair(_Pair):
    """``test_torch_mla_logits._Pair`` over a GQA model and its K/V pool."""

    def __init__(self, roundings, cfg, packed, fmt, frozen=False, n_pages=8, page=8):
        self.jcfg, self.jparams, self.tcfg, self.tparams = _model(cfg, packed)
        self.roundings = roundings
        kw = dict(frozen_fmt="fp4_e2m1", n_frozen=4) if frozen else {}
        self.jpool = jkvc.init_gqa_pool(cfg.n_layers, n_pages, page, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, fmt, **kw)
        self.tpool = {k: t(np.asarray(v)) for k, v in self.jpool.items()}
        self._compiled = {}


def run_decode_and_prefill(roundings, cfg, packed, fmt):
    """Two prefill chunks (one bucketed, one over history), then decode
    steps with an idle row on the null page, one row crossing a page.
    Every step is held by ``GqaPair.step``."""
    pair = GqaPair(roundings, cfg, packed, fmt)
    rng = np.random.default_rng(4)
    v, null = cfg.vocab_size, 8
    toks = rng.integers(1, v, size=(1, 16)).astype(np.int32)
    toks[0, 13:] = 0
    pair.step(toks, (np.array([[0, 1]], np.int32), np.array([0], np.int32),
                     np.array([13], np.int32)))
    pair.step(rng.integers(1, v, size=(1, 16)).astype(np.int32),
              (np.array([[2, 3]], np.int32), np.array([0], np.int32), np.array([16], np.int32)))
    toks = rng.integers(1, v, size=(1, 8)).astype(np.int32)
    toks[0, 5:] = 0
    pair.step(toks, (np.array([[2, 3, 4, null]], np.int32), np.array([16], np.int32),
                     np.array([5], np.int32)))
    pt = np.array([[0, 1, 6, null], [null] * 4, [2, 3, 4, 5]], np.int32)
    lengths = np.array([13, 0, 21], np.int32)
    for _ in range(4):
        logits = pair.step(rng.integers(1, v, size=(3, 1)).astype(np.int32), (pt, lengths))
        assert logits.shape == (3, v)
        lengths = lengths + np.array([1, 0, 1], np.int32)


def run_mixed_step(roundings, cfg, packed):
    """One fused step: two decoding rows (one over frozen FP4 pages), a
    mid-prefill row riding with length 0, and a 5-token chunk whose history
    holds a frozen page. All (slots + 1) logits rows within 1e-5, the pools
    written alike."""
    pair = GqaPair(roundings, cfg, packed, "fp8_e4m3", frozen=True)
    rng = np.random.default_rng(3)
    v, base = cfg.vocab_size, 9
    for ids, n in (([0, 1, 2], 19), ([3], 6), ([4], 8)):  # rows 0, 1 and the chunk's row
        toks = rng.integers(1, v, size=(1, 8 * len(ids))).astype(np.int32)
        toks[0, n:] = 0
        pair.step(toks, (np.array([ids], np.int32), np.array([0], np.int32),
                         np.array([n], np.int32)))
    for src, fidx in ((0, 0), (1, 1), (4, 2)):
        pair.transcode(src, fidx)
    table = np.array([[base, base + 1, 2], [3, 8, 8], [5, 8, 8]], np.int32)
    tokens = np.zeros((1, 3 + 8), np.int32)
    tokens[0, :2] = [4, 9]
    tokens[0, 3:8] = rng.integers(1, v, 5)
    logits = pair.step(tokens, (table, np.array([19, 6, 0], np.int32)),
                       prefill=(np.array([[base + 2, 6, 7, 8]], np.int32),
                                np.array([8], np.int32), np.array([5], np.int32)))
    assert logits.shape == (4, v)


@pytest.mark.parametrize("packed,fmt", [(False, None), (True, "fp8_e4m3")],
                         ids=["dense-bf16", "packed-fp8"])
def test_moe_decode_and_prefill_logits_match_reference(roundings, packed, fmt):
    run_decode_and_prefill(roundings, MOE_CFG, packed, fmt)


@pytest.mark.parametrize("packed", [False, True])
def test_moe_mixed_step_logits_match_reference(roundings, packed):
    run_mixed_step(roundings, MOE_CFG, packed)
