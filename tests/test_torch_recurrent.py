"""The recurrent families' modules in the port against repro's on the CPU:
the chunked gated linear attention and its step, the causal conv, the
mLSTM and sLSTM cells, the Mamba2 / mLSTM / sLSTM blocks on packed W4A8
weights (sLSTM's ``r_gates`` packed batched at a width where it is
quantizable), the cache-free forward of both SMOKE configs, a decode over
state slabs against that forward, and the transcendental functions the
cells call, torch's against XLA's.

Inputs come from numpy seeds; the reference runs compiled with
``STRICT_OPTIONS``. The recurrences run in f32 on both sides with the same
operations; only the f32 sum order of a product and the last bits of
``exp``, ``log1p``, ``sigmoid`` and ``tanh`` differ (``test_transcendental_probe``),
so the f32 functions agree to ``F32_RTOL`` of their largest magnitude. A
block reads bf16 and FP8 roundings that such an ulp can tip: its output
agrees to ``BLOCK_RTOL`` (chip_smoke.py's bound for a block's update) in
Frobenius norm."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.ptq import quantize_tree
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txlstm
from repro_torch.models.bridge import from_numpy
from repro_torch.models.transformer import layer_view
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import POLICY, flatten_jax, port_cfg, t, to_np
from test_torch_mixed_engine import STRICT_OPTIONS
from test_torch_scheduler import one_thread  # noqa: F401  (autouse: torch on one thread)

NAMES = ("xlstm-125m", "zamba2-1.2b")
F32_RTOL = 1e-5  # f32 recurrences: sum order and transcendental last bits
BLOCK_RTOL = 0.08  # chip_smoke.py's: a block's output error over its norm
LOGIT_RTOL = 0.1  # chip_smoke.py's: free-running logits, of the largest |logit|
# XLA's forward options with LLVM's passes on: its f32 tanh is then the
# rational approximation models.layers.xla_tanh repeats bit for bit
FORWARD_OPTIONS = {"xla_allow_excess_precision": False}
# the largest relative difference between torch's and XLA's CPU results the
# probe allows: 8 f32 ulps (it measures at most 2.7e-7, tanh 4.8e-7 under
# STRICT_OPTIONS)
PROBE_RTOL = 2.0 ** -20


def jrun(fn, *args, options=STRICT_OPTIONS):
    """``fn`` compiled by XLA with ``options`` and run on ``args``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def close(got, want, rtol=F32_RTOL):
    """Elementwise within ``rtol`` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max |err| {err:.3g} > {rtol} x {scale:.3g}"


def norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_config_copies_reference(name):
    assert dataclasses.asdict(t_get_config(name)) == dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(t_get_smoke(name)) == dataclasses.asdict(j_get_smoke(name))
    assert name.replace("-", "_").replace(".", "p") in ARCHS


# -- the chunked engine and its step ---------------------------------------------
@pytest.mark.parametrize("t_len,chunk,with_s0", [(13, 8, False), (40, 16, True), (7, 32, True)],
                         ids=["pad", "chunks-s0", "one-chunk-s0"])
def test_gla_chunked(t_len, chunk, with_s0):
    """T not a multiple of the chunk (padded with decay 1), T over several
    chunks with an incoming state, and T under one chunk."""
    b, h, dk, dv = 2, 3, 8, 5
    q, k = randn(1, b, t_len, h, dk), randn(2, b, t_len, h, dk)
    v = randn(3, b, t_len, h, dv)
    log_a = -np.abs(randn(4, b, t_len, h, scale=0.3))
    s0 = randn(5, b, h, dk, dv) if with_s0 else None
    args = [jnp.asarray(a) for a in (q, k, v, log_a)]
    jy, js = jrun(lambda q, k, v, la, s: jssm.gla_chunked(q, k, v, la, s0=s, chunk=chunk),
                  *args, None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.gla_chunked(t(q), t(k), t(v), t(log_a), None if s0 is None else t(s0), chunk)
    close(to_np(ty), jy)
    close(to_np(ts), js)


def test_gla_step_continues_the_chunked_state():
    """gla_step against the reference's, and a step after a chunked prefix
    equals the chunked form over the whole sequence at its last token."""
    b, h, dk, dv, n = 2, 3, 8, 5, 12
    q, k, v = randn(1, b, n, h, dk), randn(2, b, n, h, dk), randn(3, b, n, h, dv)
    log_a = -np.abs(randn(4, b, n, h, scale=0.3))
    s = randn(5, b, h, dk, dv)
    jy, js = jrun(jssm.gla_step, *(jnp.asarray(a[:, 0]) for a in (q, k, v, log_a)),
                  jnp.asarray(s))
    ty, ts = tssm.gla_step(t(q[:, 0]), t(k[:, 0]), t(v[:, 0]), t(log_a[:, 0]), t(s))
    close(to_np(ty), jy)
    close(to_np(ts), js)
    whole, _ = tssm.gla_chunked(t(q), t(k), t(v), t(log_a), chunk=4)
    _, s_pre = tssm.gla_chunked(t(q[:, :-1]), t(k[:, :-1]), t(v[:, :-1]), t(log_a[:, :-1]),
                                chunk=4)
    last, _ = tssm.gla_step(t(q[:, -1]), t(k[:, -1]), t(v[:, -1]), t(log_a[:, -1]), s_pre)
    close(to_np(last), to_np(whole[:, -1]))


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv(tail):
    """bf16 inputs, with and without a conv tail; the new tail holds the
    last d_conv - 1 inputs (the history's too when T is shorter)."""
    for t_len in (1, 2, 9):
        x = randn(1, 2, t_len, 16).astype(jnp.bfloat16)
        w = randn(2, 4, 16, scale=0.5).astype(jnp.bfloat16)
        st = randn(3, 2, 3, 16).astype(jnp.bfloat16).astype(np.float32) if tail else None
        jy, jst = jrun(lambda x, w, s: jssm.causal_conv(x, w, s), jnp.asarray(x), jnp.asarray(w),
                       None if st is None else jnp.asarray(st))
        ty, tst = tssm.causal_conv(t(x), t(w), None if st is None else t(st))
        assert ty.dtype == torch.bfloat16 and tuple(tst.shape) == (2, 3, 16)
        np.testing.assert_array_equal(to_np(tst), np.asarray(jst).astype(np.float32))
        assert norm_err(to_np(ty), np.asarray(jy).astype(np.float32)) <= 2.0 ** -8


# -- the mLSTM and sLSTM cells ------------------------------------------------------
def _mlstm_inputs(seed, b, t_len, h, dk):
    q, k, v = (randn(seed + i, b, t_len, h, dk).astype(jnp.bfloat16) for i in range(3))
    log_f = -np.abs(randn(seed + 3, b, t_len, h, scale=0.5))
    log_i = randn(seed + 4, b, t_len, h)
    return q, k, v, log_f, log_i


def test_mlstm_chunked_matches_reference_and_carries_across_calls():
    """The chunked mLSTM (bf16 q, k, v as served, q scaled in bf16 as the
    reference's weakly typed scale rounds it) against the reference's over
    T > chunk; then 30 + 23 tokens in two calls, the second continuing the
    first's (c, n, m), against one call over all 53."""
    b, h, dk = 2, 2, 24
    q, k, v, log_f, log_i = _mlstm_inputs(10, b, 53, h, dk)
    args = [jnp.asarray(a) for a in (q, k, v, log_f, log_i)]
    jh, jst = jrun(lambda *a: jxlstm._mlstm_chunked(*a, chunk=16), *args)
    th, tst = txlstm._mlstm_chunked(*(t(a) for a in (q, k, v, log_f, log_i)), 16)
    close(to_np(th), jh)
    for got, want in zip(tst, jst):
        close(to_np(got), want)
    first = [t(a[:, :30]) for a in (q, k, v, log_f, log_i)]
    second = [t(a[:, 30:]) for a in (q, k, v, log_f, log_i)]
    h1, s1 = txlstm._mlstm_chunked(*first, 16)
    h2, s2 = txlstm._mlstm_chunked(*second, 16, s0=s1)
    close(to_np(torch.cat([h1, h2], 1)), to_np(th))
    for got, want in zip(s2, tst):
        close(to_np(got), to_np(want))


def test_mlstm_step_matches_reference():
    b, h, dk = 3, 2, 16
    q, k, v, log_f, log_i = (a[:, 0] for a in _mlstm_inputs(20, b, 1, h, dk))
    c, n = randn(30, b, h, dk, dk), randn(31, b, h, dk)
    m = np.array([[-1e30, 0.5], [2.0, -1.0], [-1e30, -1e30]], np.float32)
    args = [jnp.asarray(a) for a in (q, k, v, log_f, log_i, c, n, m)]
    jh, jst = jrun(jxlstm._mlstm_step, *args)
    th, tst = txlstm._mlstm_step(*(t(a) for a in (q, k, v, log_f, log_i, c, n, m)))
    close(to_np(th), jh)
    for got, want in zip(tst, jst):
        close(to_np(got), want)


def test_slstm_cell_matches_reference():
    """One step of the sLSTM cell from the pristine state (n = 1) and from
    a running one. tanh is XLA's (``xla_tanh``), which the strict compile
    rounds other last bits of: within F32_RTOL."""
    b, h, dh = 3, 2, 8
    d = h * dh
    r = randn(40, h, 4 * dh, dh, scale=0.5)
    for st in ((np.zeros((b, d)), np.ones((b, d)), np.zeros((b, d)), np.zeros((b, d))),
               tuple(randn(41 + i, b, d) for i in range(4))):
        st = tuple(np.asarray(a, np.float32) for a in st)
        gx = randn(45, b, 4 * d, scale=2.0)
        jst, jh = jrun(lambda g, s, r: jxlstm._slstm_cell(g, s, r, h, dh), jnp.asarray(gx),
                       tuple(jnp.asarray(a) for a in st), jnp.asarray(r))
        tst, th = txlstm._slstm_cell(t(gx), tuple(t(a) for a in st), t(r), h, dh)
        close(to_np(th), jh)
        for got, want in zip(tst, jst):
            close(to_np(got), want)


# -- blocks on packed W4A8 weights --------------------------------------------------
@functools.lru_cache(maxsize=None)
def model(name: str, packed: bool, jcfg=None):
    """Random weights of ``name``'s smoke config (or ``jcfg``) from
    PRNGKey(0), packed by repro's ``quantize_tree`` in one compiled
    program when ``packed``, bridged to the port."""
    jcfg = jcfg or j_get_smoke(name)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    if packed:
        defs = jmodels.build_def(jcfg)
        params = jax.jit(lambda p: quantize_tree(p, defs, POLICY))(params)
    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(params), tcfg, "cpu",
                         policy=TPolicy(**vars(POLICY)) if packed else None)
    return jcfg, params, tcfg, tparams


# sLSTM's r_gates (H, 4dh, dh) is quantizable when dh >= 64 (xlstm-125m:
# dh 192); SMOKE's dh is 32, so this width packs it batched
WIDE_XLSTM = dataclasses.replace(j_get_smoke("xlstm-125m"), d_model=128, n_heads=2)


def _block_case(which):
    """(reference block, port block, reference layer params, port layer
    params, jcfg, tcfg) of one block of layer 0."""
    if which == "mamba2":
        jcfg, jp, tcfg, tp = model("zamba2-1.2b", True)
        return (jssm.mamba2_block, tssm.mamba2_block,
                jax.tree.map(lambda a: a[0], jp["mamba"])["mamba"],
                layer_view(tp["mamba"], 0)["mamba"], jcfg, tcfg)
    jcfg, jp, tcfg, tp = model("xlstm-125m", True, WIDE_XLSTM if which == "slstm" else None)
    fns = {"mlstm": (jxlstm.mlstm_block, txlstm.mlstm_block),
           "slstm": (jxlstm.slstm_block, txlstm.slstm_block)}[which]
    return (*fns, jax.tree.map(lambda a: a[0], jp["segments"][0])["mixer"][which],
            layer_view(tp["segments"][0], 0)["mixer"][which], jcfg, tcfg)


@pytest.mark.parametrize("which", ["mamba2", "mlstm", "slstm"])
def test_block_on_packed_weights(which):
    """Each block on W4A8 weights with FP8 activations: a 20-token chunk
    from the pristine state with the state kept, then one decode step from
    it (the step path), each within BLOCK_RTOL of the reference's; the
    carried state within it too."""
    jblock, tblock, jp, tp, jcfg, tcfg = _block_case(which)
    d = jcfg.d_model
    x = randn(50, 2, 21, d).astype(jnp.bfloat16)
    if which == "mamba2":
        init_j, init_t = jssm.init_mamba2_cache, tssm.init_mamba2_cache
    elif which == "mlstm":
        init_j, init_t = jxlstm.init_mlstm_cache, txlstm.init_mlstm_cache
    else:
        init_j, init_t = jxlstm.init_slstm_cache, txlstm.init_slstm_cache
    jc, tc = init_j(jcfg, 2), init_t(tcfg, 2)
    for sl in (slice(0, 20), slice(20, 21)):
        jy, jc = jrun(lambda p, x, c: jblock(p, x, jcfg, cache=c, a_fmt="fp8_e4m3"), jp,
                      jnp.asarray(x[:, sl]), jc)
        ty, tc = tblock(tp, t(x[:, sl]), tcfg, cache=tc, a_fmt="fp8_e4m3")
        assert ty.dtype == torch.bfloat16
        assert norm_err(to_np(ty), np.asarray(jy).astype(np.float32)) <= BLOCK_RTOL
        for name in tc:
            want = np.asarray(jc[name]).astype(np.float32)
            assert norm_err(to_np(tc[name]), want) <= BLOCK_RTOL, name


def test_r_gates_pack_batched_and_densify_as_the_reference():
    """At dh 64 sLSTM's r_gates (L, H, 4dh, dh) is packed batched with its
    LoRC factors; ``as_dense`` (the bf16 decode plus the f32 LoRC term)
    equals the reference's bit for bit; mLSTM's wi / wf (out 2 < 64) stay
    dense."""
    jcfg, jp, tcfg, tp = model("xlstm-125m", True, WIDE_XLSTM)
    r = layer_view(tp["segments"][0], 0)["mixer"]["slstm"]["r_gates"]
    assert isinstance(r, tlayers.PackedLinear) and r.lorc_a is not None
    assert tuple(r.codes.shape) == (2, 256, 32)
    jr = jax.tree.map(lambda a: a[0], jp["segments"][0])["mixer"]["slstm"]["r_gates"]
    want = np.asarray(jax.jit(lambda w: jlayers.as_dense(w, jnp.float32))(jr))
    np.testing.assert_array_equal(to_np(tlayers.as_dense(r, torch.float32)), want)
    assert not isinstance(tp["segments"][0]["mixer"]["mlstm"]["wi"], tlayers.PackedLinear)


# -- the whole forward -------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("packed", [False, True])
def test_forward_hidden_matches_reference(name, packed):
    """The cache-free forward of both SMOKE configs (Zamba2's shared block
    over a 40-token sequence past its attn_chunk of 32), dense in bf16 or
    W4A8 with FP8 activations: free-running, the logits of the hidden
    states within LOGIT_RTOL of the largest |logit|."""
    jcfg, jp, tcfg, tp = model(name, packed)
    a_fmt = "fp8_e4m3" if packed else None
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jh = jrun(lambda p, tk: jmodels.forward_hidden(p, jcfg, {"tokens": tk}, a_fmt=a_fmt)[0], jp,
              jnp.asarray(tok))
    th, caches, aux = tapi.forward_hidden(tp, tcfg, {"tokens": t(tok)}, a_fmt=a_fmt)
    assert caches is None and float(aux) == 0.0 and th.dtype == torch.bfloat16
    w = np.asarray(jp["embed"]).astype(np.float32)
    close(to_np(th) @ w.T, np.asarray(jh).astype(np.float32) @ w.T, LOGIT_RTOL)


def _slab_pools(name, tcfg, n_slabs=1):
    """The serving caches of ``name`` with ``n_slabs`` slabs (and the null
    slab) and, for the hybrid, 4 pages of 8 an invocation."""
    rep = lambda one, lead: {k: v[None].repeat(lead, *[1] * v.dim()) for k, v in one.items()}
    if name == "zamba2-1.2b":
        n_inv = thybrid.n_attn_invocations(tcfg)
        return {"mamba": rep(tssm.init_mamba2_cache(tcfg, n_slabs + 1), tcfg.n_layers),
                "shared_kv": tkvc.init_gqa_pool(n_inv, 4, 8, tcfg.n_kv_heads,
                                                tcfg.resolved_head_dim, None, device="cpu")}
    return [{"mlstm": rep(txlstm.init_mlstm_cache(tcfg, n_slabs + 1), seg.count),
             "slstm": rep(txlstm.init_slstm_cache(tcfg, n_slabs + 1), seg.count)}
            for seg in ttf.segments_for(tcfg)]


def _hidden(name, tp, tcfg, tokens, caches, state):
    if name == "zamba2-1.2b":
        return thybrid.hybrid_forward(tp, tcfg, tokens, caches, state)
    return ttf.lm_forward(tp, tcfg, tokens, caches, state)[0]


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward_ssm(name):
    """repro's ``test_arch_smoke.py::test_decode_matches_forward_ssm`` in
    the port, over state slabs: 11 tokens prefilled as one chunk into slab
    0 (and pages 0-1 for the hybrid), then token 12 decoded, match the
    cache-free forward over all 12 at the last token (rtol = atol = 0.05,
    as there); the null slab (1) stays pristine."""
    _, _, tcfg, tp = model(name, False)
    n = 12
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, n)))
    par = tapi.forward_hidden(tp, tcfg, {"tokens": tokens})[0]
    caches = _slab_pools(name, tcfg)
    pristine = [v.clone() for _, v in ttf.tree_items(caches)]
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    slab = torch.tensor([0], dtype=torch.int32)
    st = tkvc.PagedState(table, torch.tensor([0], dtype=torch.int32),
                         chunk_len=torch.tensor([n - 1]), slabs=slab)
    _hidden(name, tp, tcfg, tokens[:, :n - 1], caches, st)
    st = tkvc.PagedState(table, torch.tensor([n - 1], dtype=torch.int32), slabs=slab)
    dec = _hidden(name, tp, tcfg, tokens[:, n - 1:], caches, st)
    np.testing.assert_allclose(to_np(dec[0, 0]), to_np(par[0, -1]), rtol=0.05, atol=0.05)
    for (path, leaf), init in zip(ttf.tree_items(caches), pristine):
        if path.startswith("shared_kv"):
            continue
        assert torch.equal(leaf[:, -1], init[:, -1]), path  # the null slab
        assert not torch.equal(leaf[:, 0], init[:, 0]), path  # slab 0 was written


def test_mlstm_pristine_state_is_not_zero():
    """The pristine slabs: mLSTM's stabilizer m at -1e30 and sLSTM's
    normalizer n at 1, as the reference initializes them."""
    _, _, tcfg, _ = model("xlstm-125m", False)
    m, s = txlstm.init_mlstm_cache(tcfg, 2), txlstm.init_slstm_cache(tcfg, 2)
    jm, js = jxlstm.init_mlstm_cache(j_get_smoke("xlstm-125m"), 2), \
        jxlstm.init_slstm_cache(j_get_smoke("xlstm-125m"), 2)
    for got, want in ((m, jm), (s, js)):
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))
    assert float(m["m"][0, 0]) == float(np.float32(-1e30)) and float(s["n"][0, 0]) == 1.0


# -- the transcendental functions ----------------------------------------------------
PROBE = {
    "exp": (jnp.exp, torch.exp),
    "log1p": (jnp.log1p, torch.log1p),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "softplus": (jax.nn.softplus, tlayers.softplus),
    "log_sigmoid": (jax.nn.log_sigmoid, tlayers.log_sigmoid),
    "tanh": (jnp.tanh, tlayers.xla_tanh),
}


@pytest.mark.parametrize("options", ["strict", "forward"])
@pytest.mark.parametrize("fn", list(PROBE))
def test_transcendental_probe(fn, options):
    """The port's f32 transcendentals (the ones the cells call) against
    XLA's CPU ones, compiled as the served reference (``strict``) and the
    forward tests (``forward``) compile them, over 800k values at scales
    1e-2 to 30: each within PROBE_RTOL (8 f32 ulps) of XLA's value. They
    differ in the last bits of 0.3 % (sigmoid) to 35 % (log1p) of the values;
    the served streams still agree up to ties (test_torch_recurrent_serve).
    XLA's tanh with LLVM's passes on is ``xla_tanh`` bit for bit."""
    jfn, tfn = PROBE[fn]
    x = np.concatenate([np.random.default_rng(0).normal(scale=s, size=200_000)
                        for s in (0.01, 1.0, 5.0, 30.0)]).astype(np.float32)
    want = np.asarray(jrun(jfn, jnp.asarray(x), options=STRICT_OPTIONS if options == "strict"
                           else FORWARD_OPTIONS))
    got = tfn(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), np.float32(1e-30))
    assert float(rel.max()) <= PROBE_RTOL, float(rel.max())
    if fn == "tanh" and options == "forward":
        np.testing.assert_array_equal(got, want)
