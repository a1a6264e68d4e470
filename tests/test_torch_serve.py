"""Served greedy token streams: the port's ``Server`` against repro's.

Both serve the same requests on W4A8-packed weights (repro's
``quantize_tree``, bridged with ``from_numpy``). Both run the alternating
engine without the prefix cache (the reference on its ``ref`` kernels);
the mixed engine and the prefix cache are held in
``test_torch_mixed_engine.py``. Six requests of ragged prompt lengths share two
slots, so admission waits for retirements, prompts stream in several
chunks, and recycled pages are reused. The streams must be identical, over
bf16 pages and over FP8 pages, on two models:

* ``trained_tiny``, served by the reference as it ships (default jit).
  Its greedy streams are all token 0 (150 steps learn the Zipfian
  unigram mode and no context), so this case holds the engine's control
  flow (admission, chunk shapes, page recycling, step counts), not the
  numerics.
* a random-init model, whose streams vary from token to token. Here the
  reference's own step function is compiled with XLA's excess precision
  off, so that it rounds to bf16 where its source does (see
  ``test_torch_forward.py``): under the default jit, last-bit differences
  reach near-tied logits through the FP8 quantizations and flip a few
  tokens of these streams.

All served cases live in this one file so that a single test worker
trains the fixture.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.ptq import quantize_tree
from repro import models as jmodels
from repro.runtime import serve as jserve
from repro.runtime.kv_cache import CachePolicy as JCachePolicy
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models.bridge import from_numpy
from repro_torch.runtime import serve as tserve

from conftest import tiny_lm_cfg
from test_torch_bridge import POLICY, flatten_jax, port_cfg
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

PROMPT_LENS = (5, 19, 3, 12, 27, 9)
MAX_NEW = 6


def _requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(rid=i, prompt=rng.integers(1, vocab, size=n).tolist(), max_new=MAX_NEW)
            for i, n in enumerate(PROMPT_LENS)]


def _drain(srv, reqs):
    for r in reqs:
        srv.submit(r)
    return {r.rid: (list(r.tokens), r.status) for r in srv.run_until_drained()}


def _strict_decode(cfg, a_fmt):
    """repro's engine step, compiled once per input shape with
    ``xla_allow_excess_precision`` off; a drop-in for ``Server._decode``."""
    compiled = {}
    step = jax.jit(functools.partial(jserve._decode_step, cfg=cfg, a_fmt=a_fmt))

    def call(params, pools, *args):
        key = str([(jnp.shape(a), jnp.result_type(a)) for a in jax.tree_util.tree_leaves(args)]
                  ) + str(jax.tree_util.tree_structure(args))
        if key not in compiled:
            compiled[key] = step.lower(params, pools, *args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](params, pools, *args)

    return call


def _serve_both(jcfg, packed, kv_fmt, strict):
    common = dict(slots=2, max_seq=64, page_size=8, a_fmt="fp8_e4m3", prefix_cache=False)
    jsrv = jserve.Server(packed, jcfg, jserve.ServerConfig(
        **common, kernel_backend="ref", cache=JCachePolicy(active_fmt=kv_fmt),
        scheduler=jserve.SchedulerConfig(engine="alternating", prefill_chunk_pages=2)))
    if strict:
        jsrv._decode = _strict_decode(jcfg, common["a_fmt"])
    want = _drain(jsrv, _requests(jserve, jcfg.vocab_size))

    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(packed), tcfg, "cpu", policy=TPolicy(**vars(POLICY)))
    tsrv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        **common, cache=tserve.CachePolicy(active_fmt=kv_fmt),
        scheduler=tserve.SchedulerConfig(engine="alternating", prefill_chunk_pages=2)),
        device="cpu")
    got = _drain(tsrv, _requests(tserve, tcfg.vocab_size))

    assert got == want
    assert all(status == "ok" and len(toks) == MAX_NEW for toks, status in got.values())
    # the port took the same chunk shapes and step count, and returned every page
    assert tsrv.prefill_traces == jsrv.prefill_traces
    assert tsrv.stats["steps"] == jsrv.stats["steps"]
    assert sorted(tsrv.free_pages) == list(range(tsrv._n_pages))
    return got


@pytest.mark.parametrize("kv_fmt", [None, "fp8_e4m3"])
def test_served_tokens_identical_to_jax_server(trained_tiny, kv_fmt):
    jcfg, params = trained_tiny
    _serve_both(jcfg, quantize_tree(params, jmodels.build_def(jcfg), POLICY), kv_fmt, strict=False)


@pytest.mark.parametrize("kv_fmt", [None, "fp8_e4m3"])
def test_served_tokens_identical_on_varied_streams(kv_fmt):
    jcfg = tiny_lm_cfg()
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    got = _serve_both(jcfg, quantize_tree(params, jmodels.build_def(jcfg), POLICY), kv_fmt,
                      strict=True)
    assert len({t for toks, _ in got.values() for t in toks}) > 3  # streams vary
