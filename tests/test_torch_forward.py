"""Whole-forward parity: the port's ``decode_step`` (streaming-prefill
chunks, then batched decode over the paged pool) gives the reference's
logits on bridged parameters, dense and ``quantize_tree``-packed, with
token-wise FP8 activations, over bf16 and FP8 pages.

The reference runs compiled with XLA's ``xla_allow_excess_precision``
off. With it on (jit's default) XLA may skip the bf16 roundings the
source writes between fused ops, and the next token-wise FP8 quantization
turns such a last-bit difference into a whole FP8 step (up to 1/8 of the
value): 2e-2 on these logits. With it off both packages round where the
source rounds, and the logits agree to 1e-5 absolute — the f32 summation
order of the tied LM head (observed: below 1e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as jmodels
from repro.core.ptq import quantize_tree
from repro.runtime import kv_cache as jkvc
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import api as tapi
from repro_torch.models.bridge import from_numpy
from repro_torch.runtime import kv_cache as tkvc

from conftest import tiny_lm_cfg
from test_torch_bridge import POLICY, flatten_jax, port_cfg, t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

TOL = 1e-5
PAGE, N_PAGES = 8, 8


class _Pair:
    """The same cache state and calls driven through both packages."""

    def __init__(self, packed, fmt):
        self.jcfg = tiny_lm_cfg()
        self.tcfg = port_cfg(self.jcfg)
        params = jmodels.init_params(self.jcfg, jax.random.PRNGKey(0))
        if packed:
            params = quantize_tree(params, jmodels.build_def(self.jcfg), POLICY)
        self.jparams = params
        self.tparams = from_numpy(flatten_jax(params), self.tcfg, "cpu",
                                  policy=TPolicy(**vars(POLICY)) if packed else None)
        c = self.jcfg
        self.jcaches = [{"kv": jkvc.init_gqa_pool(c.n_layers, N_PAGES, PAGE, c.n_kv_heads,
                                                  c.resolved_head_dim, fmt)}]
        self.tcaches = [tkvc.init_gqa_pool(c.n_layers, N_PAGES, PAGE, c.n_kv_heads,
                                           c.resolved_head_dim, fmt, device="cpu")]
        self.max_err = 0.0
        self._compiled = {}

    def _jax_step(self, tokens, state):
        """repro's decode_step, compiled once per shape with excess
        precision off (see the module docstring)."""
        key = (tokens.shape, state.page_table.shape, state.chunk_len is None)
        if key not in self._compiled:
            fn = jax.jit(lambda p, tk, c, st: jmodels.decode_step(p, self.jcfg, tk, c, st,
                                                                  a_fmt="fp8_e4m3"))
            self._compiled[key] = fn.lower(self.jparams, tokens, self.jcaches, state).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self._compiled[key](self.jparams, tokens, self.jcaches, state)

    def step(self, tokens, pt, lengths, chunk_len=None):
        cl = None if chunk_len is None else np.array([chunk_len], np.int32)
        sj = jkvc.PagedState(jnp.asarray(pt), jnp.asarray(lengths),
                             None if cl is None else jnp.asarray(cl))
        st = tkvc.PagedState(t(pt), t(lengths), None if cl is None else t(cl))
        lj, self.jcaches = self._jax_step(jnp.asarray(tokens), sj)
        lt = tapi.decode_step(self.tparams, self.tcfg, t(tokens), self.tcaches, st,
                              a_fmt="fp8_e4m3")
        lj, lt = np.asarray(lj), to_np(lt)
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        self.max_err = max(self.max_err, float(np.abs(lt - lj).max()))
        np.testing.assert_allclose(lt, lj, atol=TOL, rtol=0)
        return lj


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", None])
def test_decode_step_logits_match_reference(packed, fmt):
    pair = _Pair(packed, fmt)
    rng = np.random.default_rng(4)
    v, null = pair.jcfg.vocab_size, N_PAGES
    # row A: one 13-token chunk bucketed to 16
    toks = rng.integers(1, v, size=(1, 16)).astype(np.int32)
    toks[0, 13:] = 0
    pair.step(toks, np.array([[0, 1]], np.int32), np.array([0], np.int32), 13)
    # row B: a full 16-token chunk, then 5 tokens bucketed to 8 over history
    pair.step(rng.integers(1, v, size=(1, 16)).astype(np.int32), np.array([[2, 3]], np.int32),
              np.array([0], np.int32), 16)
    toks = rng.integers(1, v, size=(1, 8)).astype(np.int32)
    toks[0, 5:] = 0
    pair.step(toks, np.array([[2, 3, 4, null]], np.int32), np.array([16], np.int32), 5)
    # decode: rows A, an idle row (null page), B; B crosses into page 5
    pt = np.array([[0, 1, 6, null], [null] * 4, [2, 3, 4, 5]], np.int32)
    lengths = np.array([13, 0, 21], np.int32)
    for _ in range(4):
        logits = pair.step(rng.integers(1, v, size=(3, 1)).astype(np.int32), pt, lengths)
        assert logits.shape == (3, v)
        lengths = lengths + np.array([1, 0, 1], np.int32)
    assert pair.max_err < TOL
