"""The MLA serving path of the port against repro: logits (served streams
are in ``test_torch_mla_serve.py``, the kernels, the pool and the configs
in ``test_torch_mla.py``).

* decode-step, prefill-chunk and mixed-step logits against repro compiled
  with excess precision off, dense and packed, within 1e-5 at every step.
  The f32 summation order of a dot differs between the packages (XLA's
  CPU dot against torch's), and one f32 ulp can tip a bf16 rounding and,
  through it, a later FP8 one (ROADMAP queue 3). So ``Roundings`` matches
  the roundings of a step between the two packages (token-wise FP8
  activations, page codes, the bf16 outputs of the linears and norms):
  each of the port's must equal the reference's but for at most
  ``MAX_TIPPED`` elements a step, each one step of its grid apart, under
  equal scales; the port then goes on from the reference's rounding, and
  its logits and pools must match.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quantize as jquant
import repro.kernels.ref as jref
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.mla as jmla
import repro.models.moe as jmoe
import repro.models.transformer as jtf
import repro_torch.core.quantize as tquant
import repro_torch.kernels.ref as tref
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers
import repro_torch.models.mla as tmla
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttf
from repro import models as jmodels
from repro.runtime import kv_cache as jkvc
from repro_torch.core.formats import FORMATS, unpack_nibbles
from repro_torch.kernels.common import page_format
from repro_torch.models import api as tapi
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import t, to_np
from test_torch_mla import MLA_CFG, _model
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

TOL = 1e-5  # logits, against the strictly compiled reference
# Elements a step's roundings may tip, over all its sites: the steps below
# tip 0 to 4 (bf16 outputs of the linears and norms, and FP8 activations)
MAX_TIPPED = 8
# An MoE layer's f32 sites (its routing and its combine), which the two
# packages sum in another order: a few f32 ulps
F32_RTOL = 1e-6


class Roundings:
    """Every rounding of a step that the two packages may tip apart, matched
    in program order: the token-wise FP8 activation quantizations
    (``quantize_act_tokenwise``: the ``quant_act`` sites and the plain W4A8
    GEMMs), the page quantizations (``quantize_pages``: appends and
    transcodes) and the bf16 outputs of the linears (the GQA and MLA
    attention's and the MLP's; the MoE experts' ``batched_linear``) and of
    the blocks' and the final norms (a tipped linear output reaches the
    residual stream, which no quantization rounds again). An MoE layer adds
    two f32 sites: its routing (``_dispatch_masks``: the dispatch must be
    identical, i.e. both packages pick the same experts, and the combine
    weights and probabilities within ``F32_RTOL``; the router's f32 logits
    sum in another order) and its combine (the f32 sum over the experts,
    within ``F32_RTOL``, before its bf16 cast). The
    reference reports each result through an ordered debug callback from
    inside its compiled step; the port's same call, in the same order,
    checks its own result against the reference's and returns the
    reference's. A result may differ from the reference's only by one step
    of its grid (FP8, FP4 or bf16) in single elements, under equal scales:
    ``tipped`` counts those elements, and a step may tip ``MAX_TIPPED``.
    Installed with ``monkeypatch``; JAX's caches are cleared on both sides
    of the test, so no program traced without the callbacks runs here and
    none traced with them outlives it."""

    COMBINE = "gsec,gecd->gsd"  # the MoE combine's einsum

    def __init__(self, monkeypatch):
        self.queue = []  # the reference's results not yet consumed
        self.on = False
        self.tipped = 0  # elements tipped in the current step
        for mod, name, kind in ((jquant, "quantize_act_tokenwise", "act"),
                                (jref, "quantize_act_tokenwise", "act"),
                                (jkvc, "quantize_pages", "pages"), (jtf, "norm", "bf16"),
                                (jlayers, "linear", "bf16"), (jmla, "linear", "bf16"),
                                (jattn, "linear", "bf16"), (jmoe, "batched_linear", "bf16"),
                                (jmoe, "_dispatch_masks", "route")):
            monkeypatch.setattr(mod, name, self._reference(getattr(mod, name), kind))
        monkeypatch.setattr(jmoe, "jnp", _Combine(jnp, self._reference(jnp.einsum, "f32")))
        for mod, name, kind in ((tquant, "quantize_act_tokenwise", "act"),
                                (tref, "quantize_act_tokenwise", "act"),
                                (tkvc, "quantize_pages", "pages"), (ttf, "norm", "bf16"),
                                (tlayers, "linear", "bf16"), (tmla, "linear", "bf16"),
                                (tattn, "linear", "bf16"), (tmoe, "batched_linear", "bf16"),
                                (tmoe, "_dispatch_masks", "route")):
            monkeypatch.setattr(mod, name, self._port(getattr(mod, name), kind))
        monkeypatch.setattr(tmoe, "torch", _Combine(torch, self._port(torch.einsum, "f32")))
        jax.clear_caches()

    def _reference(self, fn, kind):
        def record(out):
            if self.on:
                self.queue.append((kind, jax.tree_util.tree_map(np.asarray, out)))

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(record, out, ordered=True)
            return out
        return wrapped

    def _port(self, fn, kind):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if not self.on:
                return out
            jax.effects_barrier()
            assert self.queue, f"the port rounds more often than the reference ({kind})"
            want_kind, want = self.queue.pop(0)
            assert want_kind == kind, (want_kind, kind)
            if kind == "route":
                want = tuple(t(w) for w in want)
                assert torch.equal(out[0], want[0].to(out[0].dtype)), \
                    "the packages route a token to other experts"
                for o, w in zip(out[1:], want[1:]):
                    torch.testing.assert_close(o, w, rtol=F32_RTOL, atol=F32_RTOL)
                return tuple(w.to(o.dtype) for w, o in zip(want, out))
            if kind == "f32":
                want = t(want)
                torch.testing.assert_close(out, want, rtol=F32_RTOL, atol=F32_RTOL)
                return want
            if kind == "bf16":
                want = t(want).to(out.dtype)
                assert want.shape == out.shape, (tuple(want.shape), tuple(out.shape))
                self.tipped += self._bf16(out, want)
                return want
            want = tuple(t(w).to(o.dtype) for w, o in zip(want, out))
            assert [w.shape for w in want] == [o.shape for o in out], kind
            fmt = args[1] if len(args) > 1 else kw.get("fmt", "fp8_e4m3")
            self.tipped += (self._act if kind == "act" else self._pages)(out, want, fmt)
            return want
        return wrapped

    @staticmethod
    def _one_step(a, b, man_bits, smallest):
        """Elements of a and b more than one grid step apart (a grid of
        ``man_bits`` mantissa bits, normal from ``smallest``), and the
        count of those that differ at all."""
        big = torch.maximum(a.abs(), b.abs()).double()
        step = torch.exp2(torch.floor(torch.log2(torch.clamp(big, min=smallest))) - man_bits)
        diff = (a.double() - b.double()).abs()
        return int((diff > step).sum()), int((diff > 0).sum())

    def _act(self, got, want, fmt):
        """(q on the grid, token scale): equal scales, q one grid step apart
        where it differs. Returns the elements that differ."""
        (q, s), (q0, s0) = got, want
        assert torch.equal(s, s0), "a token's scale differs: more than a tipped rounding"
        f = FORMATS[fmt]
        far, n = self._one_step(q, q0, f.man_bits, 2.0 ** (1 - f.bias))
        assert not far, f"{far} activations moved more than one {fmt} step"
        return n

    def _bf16(self, got, want):
        """A linear's or a norm's bf16 output: one ulp apart where it
        differs."""
        assert got.dtype == torch.bfloat16, got.dtype
        far, n = self._one_step(got, want, 7, 2.0 ** -126)
        assert not far, f"{far} bf16 outputs moved more than one ulp"
        return n

    @staticmethod
    def _pages(got, want, fmt):
        """(codes, s_max, shifts): equal scales, codes one grid step apart
        where they differ. Returns the codes that differ."""
        (c, smax, shift), (c0, smax0, shift0) = got, want
        assert torch.equal(smax, smax0) and torch.equal(shift, shift0), "a page's scale differs"
        pf = page_format(fmt)
        if pf.packed:
            c, c0 = unpack_nibbles(c), unpack_nibbles(c0)
        width = pf.fmt.exp_bits + pf.fmt.man_bits
        mag = lambda a: (a.long() & ((1 << width) - 1))
        sign = lambda a: (a.long() >> width) & 1
        d = (mag(c) - mag(c0)).abs()
        near_zero = torch.maximum(mag(c), mag(c0)) <= 1
        ok = (c == c0) | ((d == 1) & ((sign(c) == sign(c0)) | near_zero))
        assert bool(ok.all()), "a page code moved more than one step"
        return int((c != c0).sum())

    def step(self, reference, port):
        """Run ``reference()`` and then ``port()`` with the roundings
        matched; returns their results."""
        self.on, self.tipped = True, 0
        try:
            out = reference()
            jax.effects_barrier()
            got = port()
            jax.effects_barrier()
            assert not self.queue, f"the reference rounds {len(self.queue)} more times"
        finally:
            self.on, self.queue = False, []
        assert self.tipped <= MAX_TIPPED, self.tipped
        return out, got


class _Combine:
    """A module (``jnp`` or ``torch``) whose ``einsum`` goes through
    ``site`` for the MoE combine's equation and is itself otherwise."""

    def __init__(self, mod, site):
        self._mod, self._site = mod, site

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def einsum(self, eq, *operands, **kw):
        fn = self._site if eq == Roundings.COMBINE else self._mod.einsum
        return fn(eq, *operands, **kw)


@pytest.fixture
def roundings(monkeypatch):
    yield Roundings(monkeypatch)
    jax.clear_caches()


# -- logits --------------------------------------------------------------------------
class _Pair:
    """One MLA model, its latent pool and the same calls in both packages,
    their roundings matched (``Roundings``); the reference compiled with
    excess precision off (see tests/test_torch_forward.py)."""

    def __init__(self, roundings, packed, fmt, frozen=False, n_pages=8, page=8):
        self.jcfg, self.jparams, self.tcfg, self.tparams = _model(MLA_CFG, packed)
        self.roundings = roundings
        m = MLA_CFG.mla
        kw = dict(frozen_fmt="fp4_e2m1", n_frozen=4) if frozen else {}
        self.jpool = jkvc.init_mla_pool(MLA_CFG.n_layers, n_pages, page, m.kv_lora_rank,
                                        m.qk_rope_dim, fmt, **kw)
        self.tpool = {k: t(np.asarray(v)) for k, v in self.jpool.items()}
        self._compiled = {}

    def transcode(self, src, fidx):
        self.jpool, _ = self.roundings.step(
            lambda: jkvc.transcode_page(self.jpool, src, fidx),
            lambda: tkvc.transcode_page(self.tpool, src, fidx))
        self._check_pools()

    def step(self, tokens, state_args, prefill=None):
        mk = lambda mod, f, a: mod.PagedState(*map(f, a))
        sj = mk(jkvc, jnp.asarray, state_args)
        st = mk(tkvc, t, state_args)
        if prefill is not None:
            sj = sj._replace(prefill=mk(jkvc, jnp.asarray, prefill))
            st = st._replace(prefill=mk(tkvc, t, prefill))
        args = (self.jparams, jnp.asarray(tokens), [{"kv": self.jpool}], sj)
        key = (tokens.shape, state_args[0].shape, len(state_args), prefill is None)
        if key not in self._compiled:
            fn = jax.jit(lambda p, tk, c, s: jmodels.decode_step(p, self.jcfg, tk, c, s,
                                                                 a_fmt="fp8_e4m3"))
            self._compiled[key] = fn.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        (lj, caches), lt = self.roundings.step(
            lambda: self._compiled[key](*args),
            lambda: tapi.decode_step(self.tparams, self.tcfg, t(tokens), [self.tpool], st,
                                     a_fmt="fp8_e4m3"))
        self.jpool = caches[0]["kv"]
        lj, lt = np.asarray(lj), to_np(lt)
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        np.testing.assert_allclose(lt, lj, atol=TOL, rtol=0)
        self._check_pools()
        return lj

    def _check_pools(self):
        """Codes and scales exact, bf16 pages within an ulp; then every
        step starts from the same pool."""
        for name, jleaf in self.jpool.items():
            a, b = to_np(self.tpool[name]), np.asarray(jleaf)
            if self.tpool[name].dtype == torch.bfloat16:
                np.testing.assert_allclose(a, b.astype(np.float32), rtol=2 ** -7, atol=0,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
            self.tpool[name].copy_(t(b))


@pytest.mark.parametrize("packed,fmt", [(False, None), (True, "fp8_e4m3")],
                         ids=["dense-bf16", "packed-fp8"])
def test_decode_and_prefill_logits_match_reference(roundings, packed, fmt):
    """Two prefill chunks (one bucketed, one over history), then decode
    steps with an idle row on the null page, one row crossing a page."""
    pair = _Pair(roundings, packed, fmt)
    rng = np.random.default_rng(4)
    v, null = MLA_CFG.vocab_size, 8
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


@pytest.mark.parametrize("packed", [False, True])
def test_mixed_step_logits_match_reference(roundings, packed):
    """One fused step: two decoding rows (one over frozen FP4 pages), a
    mid-prefill row riding with length 0, and a 5-token chunk whose history
    holds a frozen page. All (slots + 1) logits rows within 1e-5, the pools
    written alike."""
    pair = _Pair(roundings, packed, "fp8_e4m3", frozen=True)
    rng = np.random.default_rng(3)
    v, base = MLA_CFG.vocab_size, 9
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
