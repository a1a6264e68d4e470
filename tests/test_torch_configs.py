"""The dense and VLM GQA configs in the port: the copied configs, the
cache-free forward (llava with and without its patch prefix), and greedy
streams served in lockstep with the reference's ``Server``.

The forwards run as ``test_torch_dense_forward.py`` runs them: the
reference compiled with ``STRICT_OPTIONS`` and the roundings of the two
packages matched (``ForwardRoundings``); the logits of the hidden states
agree to ``tests/test_torch_forward.py``'s 1e-5. The served streams agree up
to ties (``test_torch_mixed_engine.compare_streams``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtf
import repro_torch.models.transformer as ttf
from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.ptq import quantize_tree
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import api as tapi
from repro_torch.models.bridge import from_numpy

from test_torch_bridge import POLICY, flatten_jax, port_cfg, t, to_np
from test_torch_dense_forward import ForwardRoundings
from test_torch_mixed_engine import MIXED, STRICT_OPTIONS, serve_both
from test_torch_scheduler import one_thread  # noqa: F401  (autouse: torch on one thread)

TOL = 1e-5  # logits, as tests/test_torch_forward.py
# A forward with an f32 gelu (llava's patch projector: the patches' dtype)
# compiles the reference with excess precision off but LLVM's passes on:
# with them off (STRICT_OPTIONS) XLA's CPU f32 tanh gives other last bits
# than jit's default and eager (a third of the elements differ by an ulp),
# while with them on it is what the port's ``xla_tanh`` repeats. The others
# take STRICT_OPTIONS, a third less compile time.
FORWARD_OPTIONS = {"xla_allow_excess_precision": False}
NAMES = ("olmo-1b", "minitron-8b", "nemotron-4-340b", "llava-next-34b", "whisper-tiny")
DENSE = ("olmo-1b", "minitron-8b", "nemotron-4-340b", "llava-next-34b")


@pytest.mark.parametrize("name", NAMES + ("deepseek-v3-671b",))
def test_config_copies_reference(name):
    assert dataclasses.asdict(t_get_config(name)) == dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(t_get_smoke(name)) == dataclasses.asdict(j_get_smoke(name))
    assert name.replace("-", "_").replace(".", "p") in ARCHS


def test_archs_left_out_are_the_recurrent_families_and_deepseek():
    """None is left out any more: the port carries every reference arch,
    the recurrent families (tests/test_torch_recurrent.py) and DeepSeek-V3
    (tests/test_torch_deepseek.py) last."""
    from repro.configs import ARCHS as J_ARCHS

    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name in J_ARCHS:
        assert t_get_config(name).name == j_get_config(name).name


@functools.lru_cache(maxsize=None)
def model(name: str, packed: bool, jcfg=None):
    """Random weights of ``name``'s smoke config (or ``jcfg``) from
    PRNGKey(0), packed by repro's ``quantize_tree`` when ``packed`` (the
    same weights as the dense model's), bridged to the port."""
    jcfg = jcfg or j_get_smoke(name)
    if packed:  # one compiled program: seconds, against ~8 s eager
        defs = jmodels.build_def(jcfg)
        params = jax.jit(lambda p: quantize_tree(p, defs, POLICY))(model(name, False, jcfg)[1])
    else:
        params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(params), tcfg, "cpu",
                         policy=TPolicy(**vars(POLICY)) if packed else None)
    return jcfg, params, tcfg, tparams


class PrefixRoundings(ForwardRoundings):
    """``ForwardRoundings`` plus the linears the transformer module calls
    itself: the patch projector's (``mm_proj``) and the decoder's cross K/V."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        monkeypatch.setattr(jtf, "linear", self._reference(jtf.linear, "bf16"))
        monkeypatch.setattr(ttf, "linear", self._port(ttf.linear, "bf16"))
        jax.clear_caches()

    def _bf16(self, got, want):
        # the projector's outputs stay f32 (the patches' dtype) until the
        # concat rounds them: f32 sums of 1024 terms in another order, within
        # 2^-16 of the row's largest magnitude
        if got.dtype == torch.float32:
            row = want.float().abs().amax(-1, keepdim=True)
            assert bool(((got - want.float()).abs() <= 2.0 ** -16 * row).all())
            return 0
        return super()._bf16(got, want)


@pytest.fixture
def roundings(monkeypatch):
    yield PrefixRoundings(monkeypatch)
    jax.clear_caches()


def assert_hidden_matches(roundings, jcfg, jparams, tcfg, tparams, batch, a_fmt, head):
    """The reference's forward_hidden (strict) against the port's on
    ``batch`` (numpy), with the roundings matched; the logits of both
    hidden states against the head ``head`` agree to TOL."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(lambda p, b: jmodels.forward_hidden(p, jcfg, b, a_fmt=a_fmt)[0])
    options = FORWARD_OPTIONS if "patches" in batch else STRICT_OPTIONS
    compiled = fn.lower(jparams, jbatch).compile(compiler_options=options)
    n_tok = batch["tokens"].size + sum(v.shape[0] * v.shape[1] for k, v in batch.items()
                                       if k != "tokens")
    layers = jcfg.n_layers + jcfg.encoder_layers
    jh, (th, caches, aux) = roundings.forward(
        lambda: compiled(jparams, jbatch),
        lambda: tapi.forward_hidden(tparams, tcfg, {k: t(v) for k, v in batch.items()},
                                    a_fmt=a_fmt),
        n_tok, layers)
    assert caches is None and float(aux) == 0.0
    assert th.shape == jh.shape and th.dtype == torch.bfloat16
    head = np.asarray(head).astype(np.float32)
    np.testing.assert_allclose(to_np(th) @ head.T, np.asarray(jh).astype(np.float32) @ head.T,
                               atol=TOL, rtol=0)


def _head(jcfg, jparams):
    return jparams["embed"] if jcfg.tie_embeddings else jparams["lm_head"]


def _dense_cases():
    out = []
    for name in DENSE:
        for packed in (False, True):
            for a_fmt in (None, "fp8_e4m3"):
                prefixes = (False, True) if name == "llava-next-34b" else (False,)
                out += [(name, packed, a_fmt, p) for p in prefixes]
    return out


@pytest.mark.parametrize("name,packed,a_fmt,patches", _dense_cases())
def test_forward_hidden_matches_reference(roundings, name, packed, a_fmt, patches):
    jcfg, jparams, tcfg, tparams = model(name, packed)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)}
    if patches:
        batch["patches"] = rng.normal(size=(2, jcfg.n_patches, 1024)).astype(np.float32)
    assert_hidden_matches(roundings, jcfg, jparams, tcfg, tparams, batch, a_fmt,
                          _head(jcfg, jparams))


def test_llava_builds_its_projector_and_serves_text_only():
    """Both packages build ``mm_proj`` for llava; a patch prefix of P
    patches lengthens the hidden states by P."""
    _, jparams, tcfg, tparams = model("llava-next-34b", True)
    assert set(tparams["mm_proj"]) == set(jparams["mm_proj"]) == {"fc1", "fc2"}
    assert tuple(tparams["mm_proj"]["fc1"].codes.shape) == (64, 512)
    tok = torch.zeros((1, 5), dtype=torch.int32)
    h = tapi.forward_hidden(tparams, tcfg, {"tokens": tok,
                                            "patches": torch.zeros((1, 8, 1024))})[0]
    assert h.shape == (1, 13, 64)


@pytest.mark.parametrize("name,engine", [("olmo-1b", "mixed"), ("minitron-8b", "alternating"),
                                         ("llava-next-34b", "alternating")])
def test_streams_match_jax_server(name, engine):
    """The prefix cache with FP8 pages and FP4 frozen pages on random packed
    weights, on the mixed engine (the default) or the alternating one:
    three 16-token prompts on one shared page (two chunk shapes), in
    lockstep with the reference (llava text-only, as the reference serves
    it)."""
    m = model(name, True)
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, m[0].vocab_size, size=8).tolist()
    waves = [[(rid, prefix + rng.integers(1, m[0].vocab_size, size=8).tolist(), 5)
              for rid in range(3)]]
    got, tsrv, ties = serve_both(m, engine, MIXED, waves)
    assert not ties, ties
    assert tsrv.stats["prefix_hit_pages"] == 2
    assert len({tuple(toks) for toks, _ in got.values()}) > 1  # varied streams
