"""Served streams of the port's MoE path against the JAX ``Server``
(``compare_streams``): the packed tiny OLMoE (``test_torch_moe.MOE_CFG``,
every expert GEMM through the batched W4A8 plain version with FP8
activations) under random weights whose greedy streams vary, both engines,
the prefix cache on, bf16, FP8 and FP8 + FP4 frozen pages. The logits are
in ``test_torch_moe_logits.py``, the layer and the kernel's plain version
in ``test_torch_moe.py``.

Serving routes per token (``group_size=1``), so a token's experts do not
depend on which rows share its program: the port's two engines serve
identical streams, as ``tests/test_mixed_engine.py::TestMixedEngine::test_moe``
asserts for the reference on the unpacked SMOKE config.
"""
import numpy as np
import pytest

from repro_torch.runtime import serve as tserve

from test_torch_mixed_engine import _serve, release_compiled, serve_both  # noqa: F401
from test_torch_mla import _model
from test_torch_mla_serve import CACHES, _waves
from test_torch_moe import MOE_CFG
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture(scope="module")
def random_moe():
    """Random weights from key 1, packed to W4A8: varied greedy streams."""
    return _model(MOE_CFG, packed=True, key=1)


@pytest.mark.parametrize("engine,cache", [("mixed", "fp8+fp4frozen"), ("mixed", "bf16"),
                                          ("alternating", "fp8")])
def test_random_moe_streams_match_jax_server(random_moe, engine, cache):
    """Two waves on one 2-page prefix: the first wave registers it (and
    freezes it into FP4), its siblings and the second wave hit it. Every
    counter, chunk shape, refcount and free list equal to the reference's
    (``serve_both``), and no tie."""
    got, srv, ties = serve_both(random_moe, engine, CACHES[cache],
                                _waves(MOE_CFG.vocab_size), slots=3, max_seq=64)
    assert len({tok for toks, _ in got.values() for tok in toks}) > 3  # streams vary
    assert len({tuple(toks) for toks, _ in got.values()}) >= 3
    assert not ties
    assert srv.stats["prefix_hit_pages"] >= 2 * 4
    if cache.endswith("frozen"):
        assert srv.stats["fp4_frozen_pages"] >= 2


def test_moe_engines_serve_identical_streams(random_moe):
    """The port's mixed and alternating engines on the same requests over
    FP8 pages: per-token routing makes the fused row route each token as
    the dedicated programs do."""
    _, _, tcfg, tparams = random_moe
    rng = np.random.default_rng(29)
    waves = [[(i, rng.integers(1, tcfg.vocab_size, size=int(n)).tolist(), 6)
              for i, n in enumerate(rng.integers(3, 14, size=4))]]
    out = {}
    for engine in ("alternating", "mixed"):
        srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
            slots=2, max_seq=64, page_size=8, cache=tserve.CachePolicy(**CACHES["fp8"]),
            scheduler=tserve.SchedulerConfig(engine=engine, prefill_chunk_pages=2)),
            device="cpu")
        out[engine] = _serve(tserve, srv, waves)
    assert out["mixed"] == out["alternating"]
    assert len({tok for toks, _ in out["mixed"].values() for tok in toks}) > 3
