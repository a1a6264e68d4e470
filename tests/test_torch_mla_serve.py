"""Served streams of the port's MLA path against the JAX ``Server``
(``compare_streams``): both engines, the prefix cache on, bf16, FP8 and
FP8 + FP4 frozen pages, on the trained ``trained_tiny_mla`` and on a
random-init model whose streams vary (the logits are in
``test_torch_mla_logits.py``, the kernels and the pool in
``test_torch_mla.py``).
"""
import numpy as np
import pytest

from test_torch_mixed_engine import release_compiled, serve_both
from test_torch_mla import MLA_CFG, _model, bridge
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)


# -- served streams ------------------------------------------------------------------
def _waves(vocab, n_per_wave=(3, 3), max_new=6, seed=0, prefix_len=16, tails=(3, 6, 9)):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=prefix_len).tolist()
    waves, rid = [], 0
    for n in n_per_wave:
        wave = []
        for i in range(n):
            wave.append((rid, prefix + rng.integers(1, vocab, size=tails[i % 3]).tolist(),
                         max_new))
            rid += 1
        waves.append(wave)
    return waves


CACHES = {"bf16": dict(active_fmt=None), "fp8": dict(active_fmt="fp8_e4m3"),
          "fp8+fp4frozen": dict(active_fmt="fp8_e4m3", frozen_fmt="fp4_e2m1", frozen_pages=4)}


@pytest.fixture(scope="module")
def random_mla():
    """Random weights from key 1, packed to W4A8: varied greedy streams."""
    return _model(MLA_CFG, packed=True, key=1)


@pytest.mark.parametrize("engine,cache", [("mixed", "fp8+fp4frozen"), ("alternating", "fp8")])
def test_random_mla_streams_match_jax_server(random_mla, engine, cache):
    """Two waves on one 2-page prefix: the first wave registers it (and
    freezes it into FP4), its siblings and the second wave hit it. With the
    trained cases below, both engines and the three page formats."""
    got, srv, ties = serve_both(random_mla, engine, CACHES[cache],
                                _waves(MLA_CFG.vocab_size), slots=3, max_seq=64)
    assert len({tok for toks, _ in got.values() for tok in toks}) > 3  # streams vary
    assert not ties
    assert srv.stats["prefix_hit_pages"] >= 2 * 4
    if cache.endswith("frozen"):
        assert srv.stats["fp4_frozen_pages"] >= 2


@pytest.mark.parametrize("engine,cache", [("mixed", "bf16"), ("alternating", "fp8+fp4frozen")])
def test_trained_mla_streams_match_jax_server(trained_tiny_mla, engine, cache):
    """The trained MiniCPM3 smoke model, served with its dense weights and
    FP8 activations (its latent widths are too narrow to pack). Its greedy
    streams may not vary; the random-init cases above do."""
    jcfg, params = trained_tiny_mla
    model = bridge(jcfg, params, packed=False)
    got, srv, ties = serve_both(model, engine, CACHES[cache], _waves(jcfg.vocab_size),
                                slots=3, max_seq=64)
    assert not ties
    assert srv.stats["prefix_hit_pages"] >= 2 * 4
