"""Sampled decoding in the port against repro's, on the CPU.

``runtime.threefry`` against ``jax.random`` bit for bit: the threefry hash,
``PRNGKey``, ``fold_in``, ``random_bits``, ``uniform`` and ``gumbel`` (the
last on every uniform it can draw). ``runtime.sampling`` against repro's
``sampling_mask`` and ``sample_tokens`` on the same logits, with the numpy
oracle of ``tests/test_sampling.py``. Served streams: the port's ``Server``
in lockstep with repro's strictly compiled one (``StrictReference``, here
reading a sampled row's gap), streams compared by ``compare_streams``;
a stream's independence of the batch, the slot and a steal and resume; and
an all-greedy step never entering ``sample_tokens``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.runtime import sampling as jsmp
from repro.runtime import serve as jserve
from repro_torch.runtime import sampling as tsmp
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import threefry as tf

from test_torch_mixed_engine import StrictReference, _packed, compare_streams, release_compiled
from test_torch_scheduler import FP8, assert_same_pool, lockstep, one_thread

SEEDS = (0, 1, 12345, 2 ** 31, 2 ** 32 - 1)
F32_ULP_1 = 2.0 ** -24  # the f32 spacing just below 1
# XLA's f32 softmax and cumsum are not torch's (nor is the port's f64 one):
# where a top-p cut differs from the reference's, the exclusive mass over
# the tokens between the two cuts must lie within this of top_p
TOP_P_BOUNDARY = 4 * F32_ULP_1


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- threefry against jax.random ----------------------------------------------------
def test_threefry_known_answer_and_jax_hash():
    """Random123's known answer for Threefry-2x32-20, and JAX's hash on
    random keys and counters, bit for bit."""
    y = tf.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert [int(v) for v in y] == [0xC4923A9C, 0x483DF7A0]
    from jax._src import prng

    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, 2 * 999, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    y1, y2 = tf.threefry2x32(int(k[0]), int(k[1]), t(x[:999].astype(np.int64)),
                             t(x[999:].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([y1.numpy(), y2.numpy()]), want.astype(np.int64))


def _jax_keys():
    """jax keys fold_in(PRNGKey(seed), count) over SEEDS x counts 0-64, and
    the port's, (n, 2) each."""
    seeds = np.repeat(np.asarray(SEEDS, np.uint32), 65)
    counts = np.tile(np.arange(65, dtype=np.int32), len(SEEDS))
    fold = jax.jit(jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c)))
    want = np.asarray(fold(jnp.asarray(seeds), jnp.asarray(counts))).astype(np.int64)
    got = tf.fold_in(tf.seed_key(t(seeds.astype(np.int64))), t(counts))
    return want, got


def test_seed_key_and_fold_in_bit_exact():
    assert tf.seed_key(21).tolist() == [0, 21]
    assert tf.fold_in(tf.seed_key(21), 5).tolist() == [3621222503, 3534982896]
    for s in SEEDS:
        np.testing.assert_array_equal(tf.seed_key(s).numpy(),
                                      np.asarray(jax.random.PRNGKey(jnp.uint32(s)), np.int64))
    want, got = _jax_keys()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab", [37, 50272, 73448])
def test_random_bits_and_uniform_bit_exact(vocab):
    """Bits, uniforms in [0, 1) and in another range (one fused multiply-add
    in XLA), and Gumbel noise, for keys of every seed at counts 0, 1, 7 and
    64 (0 and 64 at the wide vocabularies)."""
    want_keys, keys = _jax_keys()
    counts = (0, 1, 7, 64) if vocab < 1000 else (0, 64)
    pick = [i * 65 + c for i in range(len(SEEDS)) for c in counts]
    jk = jnp.asarray(want_keys[pick].astype(np.uint32))
    tk = keys[pick]
    shape = (vocab,)
    jax_draws = jax.jit(jax.vmap(lambda k: (
        jax.random.bits(k, shape), jax.random.uniform(k, shape),
        jax.random.uniform(k, shape, minval=-2.5, maxval=3.7), jax.random.gumbel(k, shape))))
    wants = [np.asarray(a) for a in jax_draws(jk)]
    gots = [tf.random_bits(tk, shape), tf.uniform(tk, shape), tf.uniform(tk, shape, -2.5, 3.7),
            tf.gumbel(tk, shape)]
    names = ("bits", "uniform", "uniform(-2.5, 3.7)", "gumbel")
    for name, want, got in zip(names, wants, (g.numpy() for g in gots)):
        assert got.shape == want.shape == (len(pick), vocab)
        if name == "bits":
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=name)
        else:
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)


def test_gumbel_bit_exact_on_every_uniform():
    """``gumbel`` draws -log(-log(u)) of u in {tiny} and k * 2^-23, k = 1 ..
    2^23 - 1: the port's ``xla_log`` chain equals XLA's on every fourth k
    and on the lowest and highest 2^16 (where the logs are steepest).
    ``xla_log`` also on every special value and on random normals of every
    exponent."""
    k = np.unique(np.concatenate([np.arange(0, 1 << 23, 4), np.arange(1 << 16),
                                  np.arange((1 << 23) - (1 << 16), 1 << 23)]))
    u = (k * 2.0 ** -23).astype(np.float32)
    u[0] = np.finfo(np.float32).tiny
    chain = jax.jit(lambda u: -jnp.log(-jnp.log(u)))
    want = np.asarray(chain(jnp.asarray(u)))
    got = (-tf.xla_log(-tf.xla_log(t(u)))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rng = np.random.default_rng(1)
    normals = rng.integers(0x00800000, 0x7F800000, 1 << 16).astype(np.int32).view(np.float32)
    x = np.concatenate([normals, np.float32([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-40,
                                              1.0, 2.0, 0.5])])
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = tf.xla_log(t(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


# -- masks and draws against repro -----------------------------------------------------
def _oracle_mask(scaled, top_k, top_p):
    """``tests/test_sampling.py``'s numpy mirror of the documented mask."""
    keep = np.ones_like(scaled, dtype=bool)
    for r in range(scaled.shape[0]):
        row = scaled[r]
        if top_k[r] > 0:
            kth = np.sort(row)[::-1][min(top_k[r], row.size) - 1]
            keep[r] &= row >= kth
        srt = np.sort(row)[::-1]
        probs = np.exp(srt - srt.max())
        probs /= probs.sum()
        exclusive = np.cumsum(probs) - probs
        n_keep = int((exclusive < top_p[r]).sum())
        keep[r] &= row >= srt[n_keep - 1]
    return keep


def _both_masks(scaled, top_k, top_p):
    want = np.asarray(jax.jit(jsmp.sampling_mask)(jnp.asarray(scaled), jnp.asarray(top_k),
                                                  jnp.asarray(top_p)))
    return tsmp.sampling_mask(t(scaled), t(top_k), t(top_p)).numpy(), want


def _both_draws(logits, temps, top_k, top_p, seeds, counts):
    want = np.asarray(jax.jit(jsmp.sample_tokens)(*map(jnp.asarray, (
        logits, temps, top_k, top_p, np.asarray(seeds, np.uint32), counts))))
    got = tsmp.sample_tokens(t(logits), t(temps), t(top_k), t(top_p),
                             t(np.asarray(seeds, np.int64)), t(counts)).numpy()
    return got, want


def test_mask_matches_oracle_and_repro():
    rng = np.random.default_rng(0)
    scaled = rng.normal(scale=3.0, size=(16, 37)).astype(np.float32)
    top_k = rng.integers(0, 40, size=16).astype(np.int32)
    top_p = rng.uniform(0.05, 1.0, size=16).astype(np.float32)
    top_p[3], top_k[5] = 1.0, 0
    got, want = _both_masks(scaled, top_k, top_p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_mask(scaled, top_k, top_p))


def test_mask_keeps_boundary_ties_and_the_top_token():
    scaled = np.float32([[5.0, 2.0, 2.0, 2.0, 1.0]])
    got, want = _both_masks(scaled, np.int32([2]), np.float32([1.0]))
    assert got.tolist() == want.tolist() == [[True, True, True, True, False]]
    scaled = np.random.default_rng(1).normal(size=(4, 11)).astype(np.float32)
    got, want = _both_masks(scaled, np.zeros(4, np.int32), np.full(4, 1e-6, np.float32))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all() and got[np.arange(4), scaled.argmax(-1)].all()


def test_mask_wide_seeded_case():
    """16 rows of 50272 logits: the masks equal repro's but where a top-p cut
    differs, which it may only where the reference's f32 mass is within its
    rounding of top_p (p = 1 included: repro's f32 cumsum reaches 1 before
    the tail, and its cut drops the tail's last tokens)."""
    rng = np.random.default_rng(2)
    scaled = (rng.normal(size=(16, 50272)) * rng.uniform(0.5, 4, (16, 1))).astype(np.float32)
    top_k = rng.integers(0, 100, 16).astype(np.int32)
    top_k[::3] = 0
    top_p = rng.uniform(0.05, 1.0, 16).astype(np.float32)
    top_p[::4] = 1.0
    got, want = _both_masks(scaled, top_k, top_p)
    got_p, want_p = _both_masks(scaled, np.zeros(16, np.int32), top_p)
    differ = np.nonzero((got != want).any(-1))[0]
    for r in differ:
        srt = np.sort(scaled[r].astype(np.float64))[::-1]
        p = np.exp(srt - srt[0])
        p /= p.sum()
        exclusive = np.cumsum(p) - p
        lo, hi = sorted((int(got_p[r].sum()), int(want_p[r].sum())))
        band = np.abs(exclusive[lo - 1:hi] - top_p[r]).max()
        assert band <= TOP_P_BOUNDARY, (r, lo, hi, band)
        above = scaled[r] >= srt[lo - 1]  # every token kept by both cuts agrees
        np.testing.assert_array_equal(got[r] & above, want[r] & above)
    assert len(differ) <= 2, differ


MIXES = {"greedy": (0.0, 0, 1.0), "t0.8_k50_p0.9": (0.8, 50, 0.9), "t1.0": (1.0, 0, 1.0),
         "t0.7_p0.5": (0.7, 0, 0.5)}


@pytest.mark.parametrize("rows,vocab", [(256, 8192), (16, 50272)])
def test_sample_tokens_identical_to_repro(rows, vocab):
    """Rows of the four mixes in turn, seeds of SEEDS and random ones,
    counts 0-64: the same token as repro's on every row (256 rows at a
    narrow vocabulary, 16 at opt-125m's)."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(rows, vocab)) * 4).astype(np.float32)
    mix = np.asarray(list(MIXES.values()), np.float64)[np.arange(rows) % 4]
    temps, top_k, top_p = mix[:, 0].astype(np.float32), mix[:, 1].astype(np.int32), \
        mix[:, 2].astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, rows, dtype=np.uint64)
    seeds[:len(SEEDS)] = SEEDS
    counts = rng.integers(0, 65, rows).astype(np.int32)
    got, want = _both_draws(logits, temps, top_k, top_p, seeds, counts)
    np.testing.assert_array_equal(got, want)
    assert (got[temps == 0] == logits[temps == 0].argmax(-1)).all()
    assert (got[temps > 0] != logits[temps > 0].argmax(-1)).mean() > 0.25  # the draws sample


def test_sampled_tokens_respect_mask_and_greedy_rows_are_argmax():
    rng = np.random.default_rng(2)
    logits = rng.normal(scale=2.0, size=(8, 23)).astype(np.float32)
    allowed = _oracle_mask(logits / np.float32(0.7), np.full(8, 4), np.full(8, 0.8))
    for trial in range(5):
        got, want = _both_draws(logits, np.full(8, 0.7, np.float32), np.full(8, 4, np.int32),
                                np.full(8, 0.8, np.float32), np.full(8, trial), np.arange(8))
        np.testing.assert_array_equal(got, want)
        assert allowed[np.arange(8), got].all()
    temps = np.float32([0, 0.9, 0, 1.5, 0, 0.1])
    got, want = _both_draws(logits[:6], temps, np.zeros(6, np.int32), np.ones(6, np.float32),
                            np.full(6, 7), np.zeros(6, np.int32))
    np.testing.assert_array_equal(got, want)
    assert (got[temps == 0] == logits[:6][temps == 0].argmax(-1)).all()


def test_draw_depends_on_index_not_batch_row():
    rng = np.random.default_rng(4)
    row = rng.normal(scale=2.0, size=23).astype(np.float32)
    toks = []
    for slot in range(3):
        logits = rng.normal(size=(4, 23)).astype(np.float32)
        logits[slot] = row
        got, want = _both_draws(logits, np.full(4, 0.8, np.float32), np.zeros(4, np.int32),
                                np.ones(4, np.float32), np.full(4, 11), np.full(4, 5, np.int32))
        np.testing.assert_array_equal(got, want)
        toks.append(got[slot])
    assert len(set(toks)) == 1


# -- validation ------------------------------------------------------------------------
@pytest.mark.parametrize("bad, match", [
    (dict(temperature=-0.1), "temperature"), (dict(temperature=float("nan")), "temperature"),
    (dict(top_p=0.0), "top_p"), (dict(top_p=-0.5), "top_p"), (dict(top_p=1.5), "top_p"),
    (dict(top_k=-1), "top_k")])
def test_bad_params_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        tserve.SamplingParams(**bad).validate()
    with pytest.raises(ValueError, match=match):
        jserve.SamplingParams(**bad).validate()


def test_bounds_are_inclusive_where_documented():
    tserve.SamplingParams(temperature=0.0, top_p=1.0, top_k=0).validate()
    tserve.SamplingParams(temperature=2.0, top_p=0.01, top_k=1).validate()


def test_submit_validates_with_rid(model):
    srv = _port(model, slots=1)
    with pytest.raises(ValueError, match="request 7.*top_p"):
        srv.submit(tserve.Request(rid=7, prompt=[1, 2], max_new=2,
                                  sampling=tserve.SamplingParams(top_p=0.0)))
    assert srv.queue == []


# -- served streams -----------------------------------------------------------------
SP = [dict(), dict(temperature=0.8, top_k=12, top_p=0.9, seed=21),
      dict(temperature=1.0, seed=2 ** 32 - 1), dict(temperature=0.7, top_p=0.5, seed=2 ** 31)]
COMMON = dict(slots=3, max_seq=64, page_size=8, a_fmt="fp8_e4m3", prefix_cache=True)


def _step_and_sampled_gap(params, caches, tokens, cache_index, poison, samp, cfg, a_fmt):
    """The reference's engine step, returning also each row's winning
    margin (chip_smoke.py's ``_draw_margins``): a greedy row's top-2 logit
    gap, a sampled row's top-2 gap of its masked, scaled logits plus its
    Gumbel noise, each over the row's largest |kept logit|."""
    logits, caches = jmodels.decode_step(params, cfg, tokens, caches, cache_index, a_fmt=a_fmt)
    logits = jnp.where(poison[:, None], jnp.float32(jnp.nan), logits)
    temps, top_ks, top_ps, seeds, counts = samp
    top2 = jax.lax.top_k(logits, 2)[0]
    greedy = (top2[:, 0] - top2[:, 1]) / jnp.max(jnp.abs(logits), axis=-1)
    scaled = logits / jnp.maximum(temps, 1e-6)[:, None]
    keep = jsmp.sampling_mask(scaled, top_ks, top_ps)
    noise = jax.vmap(lambda s, c: jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(s), c), logits.shape[-1:]))(seeds, counts)
    z = jax.lax.top_k(noise + jnp.where(keep, scaled, -jnp.inf), 2)[0]
    sampled = (z[:, 0] - z[:, 1]) / jnp.max(jnp.where(keep, jnp.abs(scaled), 0.0), axis=-1)
    return (jsmp.sample_tokens(logits, *samp), jnp.all(jnp.isfinite(logits), axis=-1), caches,
            jnp.where(temps > 0, sampled, greedy))


def _traffic(vocab, n=6, max_new=12, seed=5):
    """``n`` requests on one 2-page prefix with 4-token tails of their own,
    the sampling mixes of SP in turn (seeds offset by rid): (rid, prompt,
    max_new, sampling kwargs)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 16).tolist()
    return [(rid, prefix + rng.integers(1, vocab, 4).tolist(), max_new,
             {**SP[rid % 4], "seed": SP[rid % 4].get("seed", 0) + rid}) for rid in range(n)]


def _submit(mod, srv, reqs):
    for rid, prompt, max_new, sp in reqs:
        srv.submit(mod.Request(rid=rid, prompt=list(prompt), max_new=max_new,
                               sampling=mod.SamplingParams(**sp)))


def _port(model, engine="mixed", **config):
    tcfg, tparams = model[2:]
    sched = config.pop("scheduler", {})
    return tserve.Server(tparams, tcfg, tserve.ServerConfig(**{**COMMON, **config},
                         scheduler=tserve.SchedulerConfig(engine=engine, **sched)), device="cpu")


def _drain(srv, reqs, mod=tserve):
    _submit(mod, srv, reqs)
    return {r.rid: r.tokens for r in srv.run_until_drained()}


@pytest.fixture(scope="module")
def model():
    return _packed(2, traced=True)


def test_sampled_streams_match_jax_server(model):
    """Greedy and sampled requests through both servers (the mixed engine)
    in lockstep, equal audits and pools after every step, on a pool where
    requests are stolen, spilled, evicted and resumed. Streams by
    ``compare_streams``, whose gap reads a sampled row's Gumbel margin (the
    alternating engine's sampled seed token is held against repro in
    ``test_torch_frontend.py``)."""
    jcfg, jparams = model[:2]
    engine, pool, knobs = "mixed", 9, dict(steal_cooldown=1, spill_budget_bytes=3000)
    config = {**COMMON, "pool_pages": pool}
    jsrv = jserve.Server(jparams, jcfg, jserve.ServerConfig(
        **config, kernel_backend="ref", cache=jserve.CachePolicy(**FP8),
        scheduler=jserve.SchedulerConfig(engine=engine, prefill_chunk_pages=2, **knobs)))
    strict = StrictReference(jsrv, jcfg, "fp8_e4m3", _step_and_sampled_gap)
    tsrv = _port(model, engine, pool_pages=pool, cache=tserve.CachePolicy(**FP8),
                 scheduler=dict(prefill_chunk_pages=2, **knobs))
    reqs = _traffic(jcfg.vocab_size, max_new=20)
    _submit(jserve, jsrv, reqs)
    _submit(tserve, tsrv, reqs)
    lockstep(jsrv, tsrv)
    assert tsrv.stats == {k: jsrv.stats[k] for k in tsrv.stats}
    streams = lambda srv: {r.rid: (list(r.out), r.status) for r in srv.finished}
    ties = compare_streams(streams(tsrv), streams(jsrv), strict.gaps)
    assert not ties, ties
    sampled = [r for r in tsrv.finished if r.sampling.temperature > 0]
    assert all(r.status == "ok" for r in tsrv.finished) and len(sampled) == 4
    stolen = [r.rid for r in sampled if r.preemptions]
    assert stolen and tsrv.stats["resumes"] >= 1 and tsrv.stats["spill_evictions"] >= 1, \
        (stolen, tsrv.stats)
    assert_same_pool(tsrv, jsrv)


def test_seeded_stream_independent_of_batch_composition(model):
    """The same (prompt, SamplingParams) gives the same tokens solo, batched
    with other neighbours, and in another slot."""
    vocab = model[0].vocab_size
    reqs = _traffic(vocab, n=3)
    one = reqs[1]
    solo = _drain(_port(model, slots=1), [one])
    batched = _drain(_port(model), reqs)
    reordered = _drain(_port(model), reqs[::-1])
    assert solo[1] == batched[1] == reordered[1]
    assert reordered == batched
    assert len(set(solo[1])) > 2


def test_different_seeds_diverge(model):
    prompt = _traffic(model[0].vocab_size, n=1)[0][1]
    outs = _drain(_port(model), [(i, prompt, 8, dict(temperature=1.0, seed=i)) for i in range(3)])
    assert len(set(outs.values())) == 3


def test_seeded_stream_survives_preempt_spill_resume(model):
    """A pool of 6 pages of 4 tokens: both requests charge 2 prompt pages and
    a headroom page, then growth past 12 tokens steals; each stream equals
    its solo run on a fully backed pool."""
    vocab = model[0].vocab_size
    rng = np.random.default_rng(11)
    reqs = [(i, rng.integers(1, vocab, 5).tolist(), 10, sp) for i, sp in enumerate(
        [dict(temperature=0.9, top_k=16, top_p=0.9, seed=31), dict(temperature=0.7, seed=32)])]
    small = dict(slots=2, max_seq=32, page_size=4, prefix_cache=False)
    srv = _port(model, **small, pool_pages=6, scheduler=dict(steal_cooldown=0))
    spilled = []
    preempt = srv._preempt

    def preempt_(slot):
        preempt(slot)
        spilled.append(dataclasses.replace(srv.preempted[-1]))
    srv._preempt = preempt_
    contended = _drain(srv, reqs)
    assert srv.stats["preemptions"] >= 1 and srv.stats["resumes"] >= 1
    assert all(sp.rng_seed == sp.req.sampling.seed for sp in spilled)
    assert any(0 < sp.emitted for sp in spilled)
    for rid, prompt, max_new, sp in reqs:
        solo = _drain(_port(model, **{**small, "slots": 1}), [(9, prompt, max_new, sp)])
        assert contended[rid] == solo[9], rid


def test_resume_refuses_a_spill_whose_stream_position_moved(model):
    """The spill's RNG fields are checked on resume: a spill that recorded
    another emitted count than its request holds cannot resume."""
    vocab = model[0].vocab_size
    srv = _port(model, slots=1)
    _submit(tserve, srv, _traffic(vocab, n=1))
    for _ in range(4):
        srv.step()
    srv._preempt(0)
    srv.preempted[0].emitted += 1
    with pytest.raises(AssertionError, match="RNG stream"):
        srv.step()


def test_all_greedy_steps_never_sample(model, monkeypatch):
    """With every row greedy a step takes the argmax alone: no sort and no
    threefry. With sampled rows in the traffic, ``sample_tokens`` runs only
    in steps that carry one."""
    def refuse(*a, **k):
        raise AssertionError("an all-greedy step entered the sampler")

    vocab = model[0].vocab_size
    greedy = [(rid, p, m, {}) for rid, p, m, _ in _traffic(vocab)]
    monkeypatch.setattr(tsmp, "sample_tokens", refuse)
    monkeypatch.setattr(tf, "random_bits", refuse)
    for engine in ("mixed", "alternating"):
        out = _drain(_port(model, engine), greedy)
        assert len(out) == len(greedy)
    monkeypatch.undo()
    calls = []
    sample = tsmp.sample_tokens

    def counting(logits, temps, *rest):
        calls.append(bool((temps > 0).any()))
        return sample(logits, temps, *rest)
    monkeypatch.setattr(tsmp, "sample_tokens", counting)
    mixed = greedy[:3] + [(9, greedy[0][1], 3, SP[1])]
    srv = _port(model)
    _drain(srv, mixed)
    assert calls and all(calls) and len(calls) < srv.stats["programs"]


def test_results_are_frozen_and_truncation_folds_into_status(model):
    srv = _port(model, slots=1, max_seq=16, page_size=4, prefix_cache=False)
    req = tserve.Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=50,
                         sampling=tserve.SamplingParams(temperature=0.9, seed=3))
    srv.submit(req)
    (res,) = srv.run_until_drained()
    assert isinstance(res, tserve.RequestResult) and isinstance(res.tokens, tuple)
    assert req.status == "truncated" and req.truncated and res.truncated and not res.ok
    assert len(res.tokens) < 50
    with pytest.raises(dataclasses.FrozenInstanceError):
        res.status = "failed"
    with pytest.raises(AttributeError):
        req.truncated = False
