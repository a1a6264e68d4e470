"""The port's cache-free dense forward against the reference on the CPU:
the synthetic token streams, ``block_mask``, the query-chunked attention,
``api.forward_hidden`` and ``losses.chunked_xent``.

The reference runs compiled with ``STRICT_OPTIONS`` (excess precision off:
bf16 rounded where the source rounds; see tests/test_torch_forward.py).
Even so the two packages sum in another order (a norm's mean and
variance, a dot) and take another ``rsqrt``, so a bf16 result can tip by
one ulp; over a whole forward one such tip reaches every later token
through attention. So the forwards run with their roundings matched
(``test_torch_mla_logits.Roundings``: each norm's, linear's and FP8
quantization's result at most one step from the reference's, which the
port then takes), and the logits of the hidden states agree to
tests/test_torch_forward.py's 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import calibration_stream as j_calibration
from repro.models import attention as jattn
from repro.models.losses import chunked_xent as j_xent
from repro_torch.data.pipeline import DataConfig as TDataConfig
from repro_torch.data.pipeline import SyntheticLM as TSyntheticLM
from repro_torch.data.pipeline import calibration_stream as t_calibration
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models.params import tree_map
from repro_torch.models.losses import chunked_xent as t_xent

from conftest import tiny_lm_cfg
from test_torch_bridge import port_cfg, t, to_np
from test_torch_mixed_engine import STRICT_OPTIONS
import test_torch_mla_logits as mla_logits
from test_torch_mla_logits import Roundings
from test_torch_moe import ROPE_CFG
from test_torch_scheduler import one_thread  # noqa: F401  (autouse: torch on one thread)

TOL = 1e-5  # logits, as tests/test_torch_forward.py


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("seed", [0, 1234])
def test_synthetic_streams_identical_to_reference(seed, host):
    """Batches of two steps on one of two hosts, at opt-125m's vocabulary,
    and the calibration stream: the same tokens, as CPU int32 tensors."""
    kw = dict(vocab_size=50272, seq_len=24, global_batch=8, seed=seed, n_hosts=2,
              host_index=host)
    jsrc, tsrc = JSyntheticLM(JDataConfig(**kw)), TSyntheticLM(TDataConfig(**kw))
    assert tsrc.host_batch == jsrc.host_batch == 4
    for step in (0, 7):
        jb, tb = jsrc.batch(step), tsrc.batch(step)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32 and tb[key].device.type == "cpu"
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    jcal = j_calibration(tiny_lm_cfg(), 2, 3, 16, seed=seed + host)
    tcal = t_calibration(port_cfg(tiny_lm_cfg()), 2, 3, 16, seed=seed + host)
    for jb, tb in zip(jcal, tcal, strict=True):
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    stream = tsrc.stream(3)
    np.testing.assert_array_equal(next(stream)["tokens"].numpy(),
                                  np.asarray(jsrc.batch(3)["tokens"]))


@pytest.mark.parametrize("sq,sk,q_start,k_start,causal,window", [
    (8, 8, 0, 0, True, 0), (8, 8, 0, 0, False, 0), (5, 12, 7, 0, True, 0),
    (6, 20, 14, 2, True, 4), (9, 9, 0, 0, False, 3)])
def test_block_mask_equals_reference(sq, sk, q_start, k_start, causal, window):
    want = np.asarray(jattn.block_mask(sq, sk, q_start, k_start, causal, window))
    got = tattn.block_mask(sq, sk, q_start, k_start, causal, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_sdpa_chunked_equals_reference(causal, window):
    """Query chunks of 32 over 80 positions (the last chunk short) against
    the whole K/V: bf16 outputs identical but for the f32 sum order of the
    two products (one bf16 ulp)."""
    rng = np.random.default_rng(3)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 80, 4, 16)), jnp.bfloat16) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: jattn._sdpa_chunked(
        a, b, c, causal, window, 32, 32)).lower(q, k, v).compile(
            compiler_options=STRICT_OPTIONS)(q, k, v)).astype(np.float32)
    got = to_np(tattn._sdpa_chunked(t(q), t(k), t(v), causal, window, 32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)
    assert float((got == want).mean()) >= 0.99


class ForwardRoundings(Roundings):
    """``Roundings`` plus the cache-free attention's sites: rope's bf16
    output (f32 cos / sin, which the packages compute apart), and the
    attention's output. Its softmax weights are rounded to bf16 inside it,
    and one tipped weight moves an output element by up to one bf16 step of
    that weight times a value: more than an ulp of a small element, within
    one ulp of its row's largest (each query and head). A whole sequence
    rounds far more elements than a decode step, so a forward may tip one
    element per token and layer (``MAX_TIPPED`` counts a decode step's),
    and meets results that cancellation left small: a bf16 result may move
    one ulp of itself, or 2^-16 of its row's largest magnitude (a dot's f32
    sums in two orders differ by ~sqrt(n) 2^-24 of it)."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        for mod, name in ((jattn, "apply_rope"), (tattn, "apply_rope")):
            wrap = self._reference if mod is jattn else self._port
            monkeypatch.setattr(mod, name, wrap(getattr(mod, name), "bf16"))
        for name in ("_sdpa_full", "_sdpa_chunked"):
            monkeypatch.setattr(jattn, name, self._reference(getattr(jattn, name), "attn"))
            monkeypatch.setattr(tattn, name, self._port_attention(getattr(tattn, name)))
        self.monkeypatch = monkeypatch
        jax.clear_caches()

    def _bf16(self, got, want):
        assert got.dtype == torch.bfloat16, got.dtype
        a, b = got.double(), want.double()
        big = torch.maximum(a.abs(), b.abs())
        ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(big, min=2.0 ** -126))) - 7)
        floor = 2.0 ** -16 * torch.clamp(big.amax(-1, keepdim=True), min=2.0 ** -126)
        diff = (a - b).abs()
        assert bool((diff <= torch.maximum(ulp, floor)).all()), "a bf16 output moved too far"
        return int((diff > 0).sum())

    def _port_attention(self, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if not self.on:
                return out
            jax.effects_barrier()
            kind, want = self.queue.pop(0)
            assert kind == "attn", kind
            want = t(want).to(out.dtype)
            row = torch.clamp(want.float().abs().amax(-1, keepdim=True), min=2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(row)) - 7)
            diff = (out.float() - want.float()).abs()
            assert bool((diff <= ulp).all()), "an attention output moved over an ulp of its row"
            self.tipped += int((diff > 0).sum())
            return want
        return wrapped

    def forward(self, reference, port, tokens: int, layers: int):
        self.monkeypatch.setattr(mla_logits, "MAX_TIPPED", tokens * layers)
        return self.step(reference, port)


@pytest.fixture
def roundings(monkeypatch):
    yield ForwardRoundings(monkeypatch)
    jax.clear_caches()


def _cases():
    smoke = dataclasses.replace(j_get_smoke("opt-125m"), n_layers=2)
    return {"tiny": (tiny_lm_cfg(), 24),           # full softmax (attn_chunk 128)
            "opt125m_smoke": (smoke, 48),          # chunked above attn_chunk 32
            "rope_gated": (ROPE_CFG, 80)}          # rope, gated silu, chunked above 64


def _to_jax(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def forwards():
    """Per case: the reference's params, the port's (the port's seeded
    init, carried across as numpy), and the tokens."""
    out = {}
    for name, (jcfg, seq) in _cases().items():
        tcfg = port_cfg(jcfg)
        tparams = tapi.init_params(tcfg, seed=7, device="cpu")
        tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, seq))
        out[name] = (jcfg, tree_map(_to_jax, tparams), tcfg, tparams, tokens.astype(np.int32))
    return out


@pytest.mark.parametrize("a_fmt", [None, "fp8_e4m3"])
@pytest.mark.parametrize("case", list(_cases()))
def test_forward_hidden_matches_reference(roundings, forwards, case, a_fmt):
    jcfg, jparams, tcfg, tparams, tokens = forwards[case]
    fn = jax.jit(lambda p, tok: jmodels.forward_hidden(p, jcfg, {"tokens": tok}, a_fmt=a_fmt)[0])
    jtok = jnp.asarray(tokens)
    compiled = fn.lower(jparams, jtok).compile(compiler_options=STRICT_OPTIONS)
    jh, (th, caches, aux) = roundings.forward(
        lambda: compiled(jparams, jtok),
        lambda: tapi.forward_hidden(tparams, tcfg, {"tokens": t(tokens)}, a_fmt=a_fmt),
        tokens.size, jcfg.n_layers)
    print(f"{case} a_fmt={a_fmt}: {roundings.tipped} elements tipped by one step")
    assert caches is None and float(aux) == 0.0
    assert th.shape == jh.shape and th.dtype == torch.bfloat16
    head = np.asarray(jparams["embed"]).astype(np.float32)
    lj = np.asarray(jh).astype(np.float32) @ head.T
    lt = to_np(th) @ head.T
    np.testing.assert_allclose(lt, lj, atol=TOL, rtol=0)


@pytest.mark.parametrize("s,chunk,masked", [(40, 16, True), (40, 512, False), (48, 16, False)])
def test_chunked_xent_matches_reference(s, chunk, masked):
    """Padding (s not a multiple of chunk), one chunk, and a mask."""
    rng = np.random.default_rng(s + chunk)
    hidden = jnp.asarray(rng.normal(size=(3, s, 32)), jnp.bfloat16)
    head = jnp.asarray(rng.normal(size=(50, 32)) * 0.3, jnp.bfloat16)
    labels = rng.integers(0, 50, size=(3, s)).astype(np.int32)
    mask = (rng.random((3, s)) < 0.7).astype(np.float32) if masked else None
    jl, jn = j_xent(hidden, head, jnp.asarray(labels),
                    mask=None if mask is None else jnp.asarray(mask), chunk=chunk)
    tl, tn = t_xent(t(hidden), t(head), t(labels), mask=None if mask is None else t(mask),
                    chunk=chunk)
    assert float(tn) == float(jn) == (mask.sum() if masked else 3 * s)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
