"""The contiguous-cache path of the port against repro on the CPU:
``api.init_cache``, ``api.prefill`` and ``api.decode_step`` at a scalar
index, ``kv_cache.splice_prefill``, and ``launch.steps.make_prefill_step`` /
``make_serve_step``.

* Prefill and 4 decode steps for a SMOKE config of every family (the dense
  opt-125m with and without a sliding window, the prompt past
  ``attn_chunk``; MLA and MoE widened so every projection packs; whisper-tiny
  with frames; llava with patches; xLSTM; Zamba2), each packed W4A8 with
  FP8 activations by the port's ``pack_params`` and handed to repro as the
  same arrays (``test_torch_deepseek.model``). The reference is compiled
  with ``STRICT_OPTIONS`` (``FORWARD_OPTIONS`` where a tanh runs in f32:
  llava's projector, xLSTM's sLSTM) and the roundings of the two packages
  are matched (``ContiguousRoundings``); the logits agree to ``TOL``
  (tests/test_torch_forward.py's 1e-5) at every step, the bf16 cache leaves
  are equal and the f32 recurrent states agree to ``F32_RTOL`` of their
  largest (the cells' ``exp`` / ``log1p`` are torch's, within an ulp of
  XLA's: test_torch_recurrent.py).
* ``splice_prefill``: codes, scales and shifts (bf16 values) bit-identical
  to repro's for GQA and latent pools, bf16, FP8 and packed FP4, behind a
  frozen region too, with a tail page and a max_seq that is not a page
  multiple.
* Every layer of every family's caches has storage of its own.
* F10: repro clamps an index past the cache (``dynamic_update_slice``,
  ``dynamic_slice_in_dim``) and overwrites its last slot; the port raises.
* F11: repro takes a step of more than one token past index 0 as a
  prefill and ignores the cache; the port raises.
* The port's paged bf16 ``Server`` against its own contiguous greedy path,
  up to ties (``compare_streams``), and the step builders against ``api``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_smoke as j_get_smoke
from repro.runtime import kv_cache as jkvc
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api as tapi
from repro_torch.models.params import tree_items
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import serve as tserve

import test_torch_mla_logits as mla_logits
from test_torch_bridge import flatten_jax, t, to_np
from test_torch_configs import FORWARD_OPTIONS, PrefixRoundings
from test_torch_deepseek import MlaForwardRoundings, model
from test_torch_mixed_engine import GAP_TOL, STRICT_OPTIONS, compare_streams
from test_torch_mla import MLA_CFG
from test_torch_moe import MOE_CFG
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

TOL = 1e-5  # logits, as tests/test_torch_forward.py
F32_RTOL = 1e-5  # f32 recurrent states: sum order and transcendental last bits
A_FMT = "fp8_e4m3"
N_DECODE = 4
OPT = j_get_smoke("opt-125m")
# name -> (config, prompt tokens, max_seq, reference compile options)
CASES = {
    "dense": (OPT, 40, 48, STRICT_OPTIONS),  # past attn_chunk 32: the chunked prefill
    "dense-window": (dataclasses.replace(OPT, window=4), 7, 16, STRICT_OPTIONS),
    "mla": (MLA_CFG, 7, 16, STRICT_OPTIONS),
    "moe": (MOE_CFG, 7, 16, STRICT_OPTIONS),
    "whisper": (j_get_smoke("whisper-tiny"), 7, 16, STRICT_OPTIONS),
    "vlm-patches": (j_get_smoke("llava-next-34b"), 7, 24, FORWARD_OPTIONS),
    "xlstm": (j_get_smoke("xlstm-125m"), 7, 16, FORWARD_OPTIONS),
    "zamba2": (j_get_smoke("zamba2-1.2b"), 7, 16, STRICT_OPTIONS),
}


class ContiguousRoundings(MlaForwardRoundings, PrefixRoundings):
    """``MlaForwardRoundings`` (norms, linears, rope, attention, FP8
    activations, MoE routing and combine) plus ``PrefixRoundings``' linears
    of the transformer module itself (the patch projector, the decoder's
    cross K/V)."""


@pytest.fixture
def roundings(monkeypatch):
    yield ContiguousRoundings(monkeypatch)
    jax.clear_caches()


def _batch(jcfg, rng, s):
    batch = {"tokens": rng.integers(1, jcfg.vocab_size, size=(2, s)).astype(np.int32)}
    if jcfg.encoder_layers:
        batch["frames"] = rng.normal(size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    if jcfg.frontend == "vision_patches":
        batch["patches"] = rng.normal(size=(2, jcfg.n_patches, 1024)).astype(np.float32)
    return batch


def _model(case):
    jcfg = CASES[case][0]
    if case == "dense-window":  # the same weights as the dense case's
        _, jparams, tcfg, tparams = model(OPT, True)
        return jcfg, jparams, dataclasses.replace(tcfg, window=jcfg.window), tparams
    return model(jcfg, True)


def _port_leaves(caches):
    return dict(tree_items(caches))


def _assert_caches_match(tc, jc):
    want, got = flatten_jax(jc), _port_leaves(tc)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(to_np(g), w.astype(np.float32), err_msg=name)
        else:
            scale = max(float(np.abs(w[np.isfinite(w)]).max(initial=0.0)), 1e-30)
            np.testing.assert_allclose(to_np(g), w, rtol=0, atol=F32_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(roundings, monkeypatch, case):
    jcfg, jparams, tcfg, tparams = _model(case)
    _, s, max_seq, options = CASES[case]
    batch = _batch(jcfg, np.random.default_rng(11), s)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    layers = jcfg.n_layers + jcfg.encoder_layers
    monkeypatch.setattr(mla_logits, "MAX_TIPPED", 2 * batch["tokens"].size * max(layers, 1))
    prefill = jax.jit(lambda p, b: jmodels.prefill(p, jcfg, b, max_seq, a_fmt=A_FMT)).lower(
        jparams, jbatch).compile(compiler_options=options)
    (jl, jc), (tl, tc) = roundings.step(
        lambda: prefill(jparams, jbatch),
        lambda: tapi.prefill(tparams, tcfg, {k: t(v) for k, v in batch.items()}, max_seq,
                             a_fmt=A_FMT))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=TOL, rtol=0)
    _assert_caches_match(tc, jc)
    index = batch["tokens"].shape[1] + (jcfg.n_patches if "patches" in batch else 0)
    tokens = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    decode = jax.jit(lambda p, tok, c, i: jmodels.decode_step(p, jcfg, tok, c, i, a_fmt=A_FMT)
                     ).lower(jparams, jnp.asarray(tokens), jc, jnp.int32(index)).compile(
        compiler_options=options)
    for _ in range(N_DECODE):
        (jl, jc), tl = roundings.step(
            lambda: decode(jparams, jnp.asarray(tokens), jc, jnp.int32(index)),
            lambda: tapi.decode_step(tparams, tcfg, t(tokens), tc, index, a_fmt=A_FMT))
        assert tl.shape == (2, jcfg.vocab_size) and bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=TOL, rtol=0)
        tokens = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        index += 1
    _assert_caches_match(tc, jc)
    print(f"{case}: {roundings.tipped} elements tipped by one step at the last step")


# -- splice_prefill -------------------------------------------------------------------
PAGE, N_PAGES, L = 8, 6, 2


def _pools(kind, fmt, frozen):
    kw = dict(frozen_fmt="fp4_e2m1", n_frozen=2) if frozen else {}
    if kind == "gqa":
        return (jkvc.init_gqa_pool(L, N_PAGES, PAGE, 2, 16, fmt, **kw),
                tkvc.init_gqa_pool(L, N_PAGES, PAGE, 2, 16, fmt, device="cpu", **kw))
    return (jkvc.init_mla_pool(L, N_PAGES, PAGE, 24, 8, fmt, **kw),
            tkvc.init_mla_pool(L, N_PAGES, PAGE, 24, 8, fmt, device="cpu", **kw))


@pytest.mark.parametrize("kind,fmt,frozen", [
    ("gqa", None, False), ("gqa", "fp8_e4m3", False), ("gqa", "fp4_e2m1", False),
    ("gqa", "fp8_e4m3", True), ("mla", None, False), ("mla", "fp8_e4m3", False),
    ("mla", "fp4_e2m1", False)])
def test_splice_prefill_bit_identical_to_reference(kind, fmt, frozen):
    """A 13-token prompt of a 21-position cache (not a page multiple) into
    pages [5, 1, 3] (the last overhangs max_seq), 2 pages a staging chunk;
    the cache holds values past the prompt (negative ones too), which the
    splice must zero before each page's amax."""
    jpool, tpool = _pools(kind, fmt, frozen)
    rng = np.random.default_rng(5)
    widths = {"k": (2, 16), "v": (2, 16)} if kind == "gqa" else {"ckv": (24,), "krope": (8,)}
    cache = {name: jnp.asarray(rng.normal(size=(L, 1, 21) + w) * 2, jnp.bfloat16)
             for name, w in widths.items()}
    names = tuple(widths)
    ids = np.array([5, 1, 3], np.int32)
    # one compiled program (the page ids static): a third of the eager ops' time
    jout = jax.jit(lambda p, c: jkvc.splice_prefill(p, c, ids, 13, chunk_pages=2))(jpool, cache)
    got = tkvc.splice_prefill(tpool, {k: t(v) for k, v in cache.items()}, ids, 13, chunk_pages=2)
    assert got is tpool and set(got) == set(jout)
    for name, w in jout.items():
        a, b = to_np(got[name]), np.asarray(w)
        b = b.astype(np.float32) if got[name].dtype == torch.bfloat16 else b
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), np.ascontiguousarray(b).view(np.uint8),
                                      err_msg=name)
    assert bool(got[names[0]][:, [5, 1, 3]].ne(0).any())  # the pages were written


# -- the caches' storage, F10, F11 ----------------------------------------------------
@pytest.mark.parametrize("name", ["opt-125m", "minicpm3-4b", "olmoe-1b-7b", "whisper-tiny",
                                  "xlstm-125m", "zamba2-1.2b", "deepseek-v3-671b"])
def test_every_layer_has_its_own_cache(name):
    """The reference stacks one layer's cache with ``broadcast_to``; an
    ``expand`` would alias every layer to one buffer under in-place writes.
    A write to layer 0 of each leaf leaves layer 1 as it was."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke(name)
    caches = tapi.init_cache(cfg, 2, 8, device="cpu")
    jcaches = jmodels.init_cache(j_get_smoke(name), 2, 8)
    leaves = _port_leaves(caches)
    assert set(leaves) == set(flatten_jax(jcaches))
    for path, leaf in leaves.items():
        want = np.asarray(flatten_jax(jcaches)[path], np.float32)
        np.testing.assert_array_equal(to_np(leaf), want, err_msg=path)
        if leaf.shape[0] < 2:
            continue
        before = leaf[1].clone()
        leaf[0].fill_(7)
        assert torch.equal(leaf[1], before), path


def test_out_of_range_index_raises_where_the_reference_clamps():
    """F10: ``dynamic_update_slice`` and ``dynamic_slice_in_dim`` clamp an
    index past the end, so repro's decode at index max_seq writes the last
    slot again (and reads the learned position of the last slot); the
    port raises ``ValueError``, before anything is written."""
    upd = jax.lax.dynamic_update_slice(jnp.zeros(4), jnp.ones(1), (6,))
    assert np.asarray(upd).tolist() == [0.0, 0.0, 0.0, 1.0]
    assert int(jax.lax.dynamic_slice_in_dim(jnp.arange(4), 6, 1)[0]) == 3
    jcfg, jparams, tcfg, tparams = model(OPT, False)
    prompt = np.arange(1, 9, dtype=np.int32)[None]
    jl, jc = jmodels.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, 8)
    tok = np.array([[3]], np.int32)
    _, jc2 = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok), jc, 8)
    k0, k1 = np.asarray(jc[0]["kv"]["k"]), np.asarray(jc2[0]["kv"]["k"])
    assert not np.array_equal(k0[:, :, 7], k1[:, :, 7])  # the last slot overwritten
    np.testing.assert_array_equal(k0[:, :, :7], k1[:, :, :7])
    _, tc = tapi.prefill(tparams, tcfg, {"tokens": t(prompt)}, 8)
    before = {p: v.clone() for p, v in _port_leaves(tc).items()}
    with pytest.raises(ValueError, match="F10"):
        tapi.decode_step(tparams, tcfg, t(tok), tc, 8)
    with pytest.raises(ValueError, match="F10"):  # a prompt longer than the cache
        tapi.prefill(tparams, tcfg, {"tokens": t(np.ones((1, 9), np.int32))}, 8)
    with pytest.raises(ValueError, match="F10"):  # past the learned positions
        tapi.decode_step(tparams, tcfg, t(tok), tapi.init_cache(tcfg, 1, 8192, device="cpu"),
                         tcfg.max_position)
    assert all(torch.equal(v, before[p]) for p, v in _port_leaves(tc).items())


@pytest.mark.parametrize("case", ["dense", "mla"])
def test_multi_token_step_past_zero_the_reference_ignores_the_cache(case):
    """F11: repro takes a contiguous step of more than one token as a
    prefill from position 0, attending within its own tokens only: the
    same 2 tokens at index 5 give the same logits after two different
    prompts, where a one-token step's logits differ."""
    jcfg, jparams, _, _ = model(CASES[case][0], False)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, jcfg.vocab_size, (2, 1, 5)).astype(np.int32)
    prefill = jax.jit(lambda p, tok: jmodels.prefill(p, jcfg, {"tokens": tok}, 16)[1])
    step = jax.jit(lambda p, tok, c: jmodels.decode_step(p, jcfg, tok, c, 5)[0])
    two, one = [], []
    for prompt in prompts:
        jc = prefill(jparams, jnp.asarray(prompt))
        two.append(np.asarray(step(jparams, jnp.asarray([[7, 9]], jnp.int32), jc)))
        one.append(np.asarray(step(jparams, jnp.asarray([[7]], jnp.int32), jc)))
    np.testing.assert_array_equal(two[0], two[1])
    assert not np.array_equal(one[0], one[1])


@pytest.mark.parametrize("case", ["dense", "mla", "whisper", "zamba2"])
def test_multi_token_step_past_zero_raises(case):
    """F11: the port refuses a contiguous step of more than one token past
    index 0 on every family that attends, before anything is written."""
    jcfg, _, tcfg, tparams = model(CASES[case][0], False)
    batch = _batch(jcfg, np.random.default_rng(3), 5)
    _, tc = tapi.prefill(tparams, tcfg, {k: t(v) for k, v in batch.items()}, 16)
    before = {p: v.clone() for p, v in _port_leaves(tc).items()}
    with pytest.raises(ValueError, match="F11"):
        tapi.decode_step(tparams, tcfg, t(np.array([[7, 9]] * 2, np.int32)), tc, 5)
    assert all(torch.equal(v, before[p]) for p, v in _port_leaves(tc).items())


# -- the paged Server against the contiguous path; the step builders ------------------
def _greedy_contiguous(params, cfg, prompt, max_new, max_seq):
    """Greedy decode of one request over the contiguous caches, and each
    token's top-2 logit gap over the row's largest |logit|."""
    logits, caches = tapi.prefill(params, cfg, {"tokens": t(np.array([prompt], np.int32))},
                                  max_seq, a_fmt=A_FMT)
    out, gaps = [], []
    for i in range(max_new):
        row = logits[0]
        top = row.topk(2).values
        gaps.append(float(top[0] - top[1]) / float(row.abs().max()))
        out.append(int(row.argmax()))
        if i + 1 < max_new:
            logits = tapi.decode_step(params, cfg, t(np.array([[out[-1]]], np.int32)), caches,
                                      len(prompt) + i, a_fmt=A_FMT)
    return out, gaps


def test_paged_bf16_server_matches_contiguous_greedy():
    """Three requests of 5, 19 and 3 prompt tokens, 6 new each, on the
    port's paged bf16 Server (the mixed engine, pages of 8) against the
    contiguous greedy path one request at a time: equal up to ties."""
    _, _, tcfg, tparams = model(OPT, True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (5, 19, 3)]
    srv = tserve.Server(tparams, tcfg, tserve.ServerConfig(
        slots=2, max_seq=32, page_size=8, a_fmt=A_FMT, cache=tserve.CachePolicy()),
        device="cpu")
    for rid, p in enumerate(prompts):
        srv.submit(tserve.Request(rid=rid, prompt=p, max_new=6))
    got = {r.rid: (list(r.tokens), r.status) for r in srv.run_until_drained()}
    want, gaps = {}, {}
    for rid, p in enumerate(prompts):
        toks, g = _greedy_contiguous(tparams, tcfg, p, 6, 32)
        want[rid] = (toks, "ok")
        gaps.update({(rid, i): x for i, x in enumerate(g)})
    ties = compare_streams(got, want, gaps)
    assert len(ties) <= 1 and all(gap < GAP_TOL for *_, gap in ties), ties
    assert len({tok for toks, _ in want.values() for tok in toks}) > 1


def test_step_builders_equal_the_api_calls():
    _, _, tcfg, tparams = model(OPT, True)
    batch = {"tokens": t(np.random.default_rng(4).integers(1, 500, (2, 6)).astype(np.int32))}
    logits, caches = make_prefill_step(tcfg, 16)(tparams, batch)
    want_logits, want = tapi.prefill(tparams, tcfg, batch, 16)
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(v, _port_leaves(want)[p]) for p, v in _port_leaves(caches).items())
    tokens = logits.argmax(-1)[:, None].to(torch.int32)
    serve_step = make_serve_step(tcfg)
    got, same = serve_step(tparams, caches, tokens, 6)
    assert same is caches
    assert torch.equal(got, tapi.decode_step(tparams, tcfg, tokens, want, 6, a_fmt="fp8_e4m3"))
    assert all(torch.equal(v, _port_leaves(want)[p]) for p, v in _port_leaves(caches).items())
    # make_serve_step's default a_fmt is FP8 (dense weights: the packed ones
    # quantize their activations whatever the step asks)
    _, _, _, dense = model(OPT, False)
    caches = tapi.prefill(dense, tcfg, batch, 16)[1]
    got = serve_step(dense, caches, tokens, 6)[0]
    caches = tapi.prefill(dense, tcfg, batch, 16)[1]
    assert torch.equal(got, tapi.decode_step(dense, tcfg, tokens, caches, 6, a_fmt="fp8_e4m3"))
    caches = tapi.prefill(dense, tcfg, batch, 16)[1]
    assert not torch.equal(got, tapi.decode_step(dense, tcfg, tokens, caches, 6))
