"""Training in the port against the reference, on the CPU: AdamW
(``optimizer.adamw``), the training step (``launch.steps``), gradient
compression and the straggler policy (``runtime``), checkpoints
(``checkpoint.manager``) and the loop (``runtime.train``), with the bridge
of a reference ``TrainState``. Tolerances, each stated where it is used:

* ``lr_schedule``: bit for bit at every step of the trained_tiny recipe
  (``tests/conftest.py``); the 200-step schedule of the paper preset and
  test_runtime's 40-step one within 1 f32 ulp (first differing steps 124
  and 28: XLA's f32 ``cos`` is its own approximation, the port's is
  correctly rounded), the 10000-step default within 3 ulps;
* ``adamw_update`` fed the reference's gnorm: f32 moments within 1 f32
  ulp (XLA contracts the moment updates into fused multiply-adds), bf16
  moments and params identical but for one-ulp flips in at most
  ``FLIP_SHARE`` of the elements, fp8_sim moments one E4M3 step at most;
* the global norm within ``GNORM_RTOL`` (1e-5: f32 sums of 71k squares
  in another order);
* ``make_train_step`` (``accum_steps`` 2, ``grad_compress``) against the
  reference's step compiled with ``STRICT_OPTIONS``: the metrics within
  ``STEP_RTOL`` (no rounding matched, as ``test_torch_deepseek``'s
  LOSS_RTOL; the gradient norm within 1e-3), the first moment (the
  clipped gradient's tenth) within the gradient tests' ``GRAD_TOL`` of
  each leaf's largest, plus one E4M3 step of the element when compressed;
* the trained_tiny recipe's 150 steps from the reference's initial state:
  the port's nll within ``HISTORY_RTOL`` (5e-3) of the reference's at
  every logged step;
* checkpoints bit for bit, both ways.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optimizer import adamw as ja
from repro.runtime import compress as jcomp
from repro.runtime.straggler import StragglerPolicy as JStraggler
from repro.runtime.train import TrainLoopConfig as JLoop
from repro.runtime.train import train_loop as j_train_loop
from repro_torch.checkpoint.manager import CheckpointManager, latest_step, restore, save
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models.bridge import train_state_from_numpy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optimizer import adamw as ta
from repro_torch.runtime import compress as tcomp
from repro_torch.runtime.straggler import StragglerPolicy
from repro_torch.runtime.train import TrainLoopConfig, train_loop

from conftest import tiny_lm_cfg
from test_torch_bridge import flatten_jax, port_cfg, t, to_np
from test_torch_grad_dense import GRAD_TOL
from test_torch_mixed_engine import STRICT_OPTIONS
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

FLIP_SHARE = 1e-3  # bf16 elements an update may flip by one ulp
GNORM_RTOL = 1e-5  # the global norm: f32 sums of squares in another order (1.4e-6 read)
STEP_RTOL = {"grad_norm": 1e-3}  # a step's metrics, no rounding matched: the
# norm of gradients that differ within GRAD_TOL reads up to 6e-4, the others 1e-4
# the 150-step nll history, every logged step: the reference's loop jits its
# step with XLA's default options, which keep excess precision where the port
# rounds (ROADMAP F2), so the two walks part by up to 2.0e-3 (read) and meet again
HISTORY_RTOL = 5e-3
TINY_RECIPE = dict(lr=8e-3, warmup=20, total_steps=150)  # tests/conftest.py::trained_tiny


def _jstate(jcfg, oc, seed=0):
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    return JTrainState(params=params, opt=ja.adamw_init(params, oc))


def _bridged(jstate, jcfg):
    return train_state_from_numpy(flatten_jax(jstate), port_cfg(jcfg), "cpu")


# -- the schedule, the clip and the update ---------------------------------------------
@pytest.mark.parametrize("oc,max_ulps", [(TINY_RECIPE, 0),
                                         (dict(lr=6e-4, warmup=20, total_steps=200), 1),
                                         (dict(lr=3e-3, warmup=5, total_steps=40), 1),
                                         ({}, 3)])
def test_lr_schedule_matches_reference_at_every_step(oc, max_ulps):
    jc, tc = ja.AdamWConfig(**oc), ta.AdamWConfig(**oc)
    steps = np.arange(0, jc.total_steps + 10, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: ja.lr_schedule(s, jc))(jnp.asarray(steps)))
    got = ta.lr_schedule(torch.as_tensor(steps), tc).numpy()
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= max_ulps, (np.nonzero(ulps)[0][:5], ulps.max())
    assert np.all(ulps[: jc.warmup + 1] == 0)  # the warmup is exact everywhere


def _grads(tree, rng, scale=1.0, dtype=None):
    return tree_map(lambda p: torch.from_numpy(
        (rng.normal(size=tuple(p.shape)) * scale).astype(np.float32)).to(dtype or p.dtype), tree)


def _to_jax(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(monkeypatch, max_norm):
    """The norm within GNORM_RTOL; fed the reference's norm, every clipped
    leaf bit-identical (and untouched when the norm is below the bound)."""
    params = tapi.init_params(port_cfg(tiny_lm_cfg()), seed=0, device="cpu")
    grads = _grads(params, np.random.default_rng(1), 0.05)
    jg = tree_map(_to_jax, grads)
    want, jgn = jax.jit(lambda g: ja.clip_by_global_norm(g, max_norm))(jg)
    np.testing.assert_allclose(float(ta.global_norm(grads)), float(jgn), rtol=GNORM_RTOL)
    monkeypatch.setattr(ta, "global_norm", lambda g: torch.tensor(float(jgn)))
    got, gn = ta.clip_by_global_norm(grads, max_norm)
    assert float(gn) == float(jgn)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16 and np.array_equal(to_np(a), np.asarray(b, np.float32))
    if max_norm > 1:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(grads)))


def _ulps_f32(a, b):
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("step", [0, 19, 20])  # step 1, the last warmup step, the first after
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "fp8_sim"])
def test_adamw_update_matches_reference(monkeypatch, moment_dtype, step):
    """One update of tiny_lm's params (bf16: matrices, stacked matrices and
    vectors) from random gradients and moments, both fed the reference's
    global norm (the clip active); AdamW at the trained_tiny recipe."""
    jc = ja.AdamWConfig(**TINY_RECIPE, moment_dtype=moment_dtype)
    tc = ta.AdamWConfig(**TINY_RECIPE, moment_dtype=moment_dtype)
    rng = np.random.default_rng(step)
    params = tapi.init_params(port_cfg(tiny_lm_cfg()), seed=step, device="cpu")
    grads = _grads(params, rng, 0.05)
    mdt = torch.float32 if moment_dtype == "float32" else torch.bfloat16
    zero = step == 0
    mu = _grads(params, rng, 0.0 if zero else 0.01, mdt)
    nu = tree_map(lambda m: m.square() * 0.5 + 1e-6 * (not zero), _grads(params, rng, 0.02, mdt))
    if moment_dtype == "fp8_sim":
        mu, nu = (tree_map(lambda m: ta._store(m.float(), "fp8_sim"), x) for x in (mu, nu))
    state = ta.OptState(mu, nu, torch.tensor(step, dtype=torch.int32))
    jstate = ja.OptState(tree_map(_to_jax, mu), tree_map(_to_jax, nu), jnp.int32(step))
    jp, js, jm = jax.jit(lambda p, g, s: ja.adamw_update(p, g, s, jc))(
        tree_map(_to_jax, params), tree_map(_to_jax, grads), jstate)
    monkeypatch.setattr(ta, "global_norm", lambda g: torch.tensor(float(jm["grad_norm"])))
    tp, ts, tm = ta.adamw_update(params, grads, state, tc)
    assert int(ts.step) == step + 1 and ts.step.dtype == torch.int32
    assert float(tm["lr"]) == float(jm["lr"]) and float(tm["grad_norm"]) == float(jm["grad_norm"])
    assert float(jm["grad_norm"]) > tc.clip_norm  # the clip scales every gradient
    flips = n = 0
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        d = _ulps_f32(to_np(got), np.asarray(want, np.float32)) >> 16  # bf16 ulps
        assert got.dtype == torch.bfloat16 and d.max() <= 1
        flips, n = flips + int(d.sum()), n + d.size
    for gtree, wtree in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for got, want in zip(tree_leaves(gtree), jax.tree.leaves(wtree)):
            assert got.dtype == mdt
            g, w = to_np(got), np.asarray(want, np.float32)
            if moment_dtype == "float32":
                assert _ulps_f32(g, w).max() <= 1
            elif moment_dtype == "bfloat16":
                d = _ulps_f32(g, w) >> 16
                assert d.max() <= 1
                flips, n = flips + int(d.sum()), n + d.size
            else:  # values on the E4M3 grid of their row's scale: one step apart at most
                step_of = np.abs(w) * 2.0 ** -3
                assert np.all(np.abs(g - w) <= np.maximum(step_of, 1e-30) * 1.01)
    print(f"{moment_dtype} step {step}: {flips} of {n} bf16 elements flipped by one ulp")
    assert flips <= FLIP_SHARE * n


def test_decay_applies_to_matrices_only():
    """Zero gradients and moments: the update leaves every vector as it is
    and scales every matrix by 1 - lr * weight_decay, as the reference (lr
    0.5 with no warmup, so that the decay moves bf16 values)."""
    oc = dict(lr=0.5, warmup=0, total_steps=10)
    jc, tc = ja.AdamWConfig(**oc), ta.AdamWConfig(**oc)
    params = tapi.init_params(port_cfg(tiny_lm_cfg()), seed=3, device="cpu")
    zeros = tree_map(torch.zeros_like, params)
    tp, _, tm = ta.adamw_update(params, zeros, ta.adamw_init(params, tc), tc)
    jp = tree_map(_to_jax, params)
    want, _, _ = jax.jit(lambda p: ja.adamw_update(
        p, jax.tree.map(jnp.zeros_like, p), ja.adamw_init(p, jc), jc))(jp)
    decay = ta._fma(-tm["lr"], torch.tensor(tc.weight_decay), torch.tensor(1.0))
    changed = 0
    for old, new, w in zip(tree_leaves(params), tree_leaves(tp), jax.tree.leaves(want)):
        assert np.array_equal(to_np(new), np.asarray(w, np.float32))
        if old.dim() >= 2:
            assert torch.equal(new, (old.float() * decay).to(old.dtype))
            changed += int((new != old).any())
        else:
            assert torch.equal(new, old)
    assert changed > 0


# -- the training step ------------------------------------------------------------
@pytest.fixture(scope="module")
def step_case():
    """tiny_lm (biases, learned positions, tied head) at its seeded
    reference init, AdamW at the trained_tiny recipe, a batch of 4 x 16."""
    jcfg = tiny_lm_cfg()
    oc = ja.AdamWConfig(**TINY_RECIPE)
    jstate = _jstate(jcfg, oc, seed=5)
    rng = np.random.default_rng(5)
    seq = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    return jcfg, oc, jstate, batch


@pytest.mark.parametrize("accum_steps,compress", [(2, False), (1, True), (2, True)])
def test_train_step_matches_reference(monkeypatch, step_case, accum_steps, compress):
    """``make_train_step`` with micro-batches and / or FP8 gradient
    compression, against the reference's step: the gradients reach the
    update in f32 when accumulated (bf16 otherwise), as the
    compressor's round trip when compressing; the metrics are the last
    micro-batch's; the new first moment within GRAD_TOL of each leaf's
    largest, the metrics within STEP_RTOL, lr exactly."""
    jcfg, oc, jstate, batch = step_case
    jfn = j_make_train_step(jcfg, oc, accum_steps=accum_steps,
                            grad_compress=jcomp.make_fp8_compressor() if compress else None)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = jax.jit(jfn).lower(jstate, jb).compile(compiler_options=STRICT_OPTIONS)
    jnew, jm = compiled(jstate, jb)
    tcfg = port_cfg(jcfg)
    state = _bridged(jstate, jcfg)
    seen = {}
    update = tsteps.adamw_update

    def spy(params, grads, opt, cfg):
        seen["grads"] = grads
        return update(params, grads, opt, cfg)

    monkeypatch.setattr(tsteps, "adamw_update", spy)
    if compress:
        pair = tcomp.make_fp8_compressor()
        raw = {}

        def compress_spy(g):
            raw["grads"] = g
            return pair[0](g)

        comp = (compress_spy, pair[1])
    tnew, tm = tsteps.make_train_step(tcfg, ta.AdamWConfig(**TINY_RECIPE),
                                      accum_steps=accum_steps,
                                      grad_compress=comp if compress else None)(
        state, {k: t(v) for k, v in batch.items()})
    want_dt = torch.float32 if accum_steps > 1 else torch.bfloat16
    assert all(g.dtype == want_dt for g in tree_leaves(seen["grads"]))
    if compress:
        again = tcomp.decompress_tree(tcomp.compress_tree(raw["grads"]), raw["grads"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(seen["grads"]),
                                                     tree_leaves(again)))
    assert set(tm) == set(jm)
    assert float(tm["lr"]) == float(jm["lr"])
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_RTOL.get(k, 1e-4),
                                   err_msg=k)
    half = {k: t(v[-(len(v) // accum_steps):]) for k, v in batch.items()}
    with torch.no_grad():
        last_nll = float(tapi.loss_fn(state.params, tcfg, half)[1]["nll"])
    assert float(tm["nll"]) == last_nll  # the last micro-batch's metrics
    for got, want in zip(tree_leaves(tnew.opt.mu), jax.tree.leaves(jnew.opt.mu)):
        w = np.asarray(want, np.float32)
        # compressed, an element may round to the next E4M3 value: one step
        # of its binade, at most an eighth of it
        step = np.abs(w) * 2.0 ** -3 if compress else 0.0
        assert np.all(np.abs(to_np(got) - w) <= GRAD_TOL * np.abs(w).max() + step)
    assert int(tnew.opt.step) == 1


# -- the loop ------------------------------------------------------------------
def test_loss_history_tracks_reference_train_loop():
    """trained_tiny's recipe (150 steps, lr 8e-3, warmup 20, batches of 8 x
    32 from seed 3), the port from the reference's initial TrainState:
    every logged step's nll within HISTORY_RTOL of the reference's, the
    same lr, and nll falls."""
    jcfg = tiny_lm_cfg()
    jdc = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=8, seed=3)
    oc = ja.AdamWConfig(**TINY_RECIPE)
    loop = dict(steps=150, log_every=10)
    _, want = j_train_loop(jcfg, jdc, oc, JLoop(**loop))
    state = _bridged(_jstate(jcfg, oc, seed=0), jcfg)
    _, got = train_loop(port_cfg(jcfg), DataConfig(**vars(jdc)), ta.AdamWConfig(**TINY_RECIPE),
                        TrainLoopConfig(**loop), device="cpu", state=state)
    assert [h["step"] for h in got] == [h["step"] for h in want]
    worst = 0.0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
        worst = max(worst, abs(g["nll"] - w["nll"]) / w["nll"])
    print(f"150 steps: nll {got[0]['nll']:.5f} -> {got[-1]['nll']:.5f} (reference "
          f"{want[0]['nll']:.5f} -> {want[-1]['nll']:.5f}); worst relative {worst:.3e}")
    assert worst <= HISTORY_RTOL
    assert got[-1]["nll"] < got[0]["nll"] and want[-1]["nll"] < want[0]["nll"]


def test_loss_decreases_and_resumes_bit_for_bit(tmp_path):
    """test_runtime's TestTrainLoop in the port (opt-125m's SMOKE, 30 steps,
    a checkpoint every 10): nll falls, the newest checkpoint is step 30;
    a resumed run to 35 starts at 30, and its steps equal an uninterrupted
    35-step run's bit for bit."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke("opt-125m")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=1)
    oc = ta.AdamWConfig(lr=3e-3, warmup=5, total_steps=40)
    run = lambda steps, d: train_loop(cfg, dc, oc, TrainLoopConfig(
        steps=steps, ckpt_dir=d, ckpt_every=10, log_every=5), device="cpu")
    _, hist = run(30, str(tmp_path / "a"))
    assert hist[-1]["nll"] < hist[0]["nll"], (hist[0]["nll"], hist[-1]["nll"])
    assert latest_step(str(tmp_path / "a")) == 30
    state2, hist2 = run(35, str(tmp_path / "a"))
    assert hist2[0]["step"] == 30
    state3, hist3 = run(35, None)
    tail = {h["step"]: h for h in hist3 if h["step"] >= 30}
    for h in hist2:
        assert {k: v for k, v in h.items() if k != "sec"} == \
            {k: v for k, v in tail[h["step"]].items() if k != "sec"}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state2), tree_leaves(state3)))


def test_train_loop_runs_from_its_own_init_with_accumulation_and_compression():
    """The loop's own init (``init_params(cfg, loop.seed)``), 2 micro-batches
    and FP8 compression: finite metrics, the history keys of the
    reference's loop, params moved."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke("olmo-1b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=2)
    state, hist = train_loop(cfg, dc, ta.AdamWConfig(lr=1e-3),
                             TrainLoopConfig(steps=3, log_every=1, grad_compress=True,
                                             accum_steps=2), device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert set(hist[0]) == {"nll", "aux", "tokens", "lr", "grad_norm", "loss", "step", "sec"}
    assert all(np.isfinite(h["loss"]) for h in hist)
    init = tapi.init_params(cfg, seed=0, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(init),
                                                     tree_leaves(state.params)))


# -- checkpoints ------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4).to(torch.bfloat16),
                  "d": [torch.tensor(3, dtype=torch.int32)]}}
    save(str(tmp_path), 5, tree)
    like = tree_map(torch.zeros_like, tree)
    out = restore(str(tmp_path), like)
    assert list(out) == ["a", "b"] and list(out["b"]) == ["c", "d"]
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomicity_ignores_torn_writes(tmp_path):
    save(str(tmp_path), 1, {"a": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000002.tmp0")
    os.makedirs(tmp_path / "step_00000003")  # no manifest: torn
    assert latest_step(str(tmp_path)) == 1


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, every=1)
    for s in range(1, 6):
        mgr.maybe_save(s, {"a": torch.zeros(2)})
    assert mgr.maybe_save(7, {"a": torch.zeros(2)}) is not None
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000005", "step_00000007"]
    assert CheckpointManager(str(tmp_path), every=3).maybe_save(7, {"a": torch.zeros(2)}) is None


def _train_states(moment_dtype):
    jcfg = tiny_lm_cfg()
    oc = ja.AdamWConfig(**TINY_RECIPE, moment_dtype=moment_dtype)
    jstate = _jstate(jcfg, oc, seed=4)
    rng = np.random.default_rng(4)  # moments and step that are not zero
    jstate = JTrainState(jstate.params, ja.OptState(
        *(jax.tree.map(lambda m: jnp.asarray(rng.normal(size=m.shape), m.dtype), x)
          for x in (jstate.opt.mu, jstate.opt.nu)), jnp.int32(17)))
    return jcfg, jstate


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, moment_dtype):
    """repro writes a TrainState and the port restores it bit for bit (the
    bridged state, every leaf's dtype); the port writes it back and repro
    restores the same bits. Both write the same leaves, dtypes and shapes
    in their manifests."""
    jcfg, jstate = _train_states(moment_dtype)
    jckpt.save(str(tmp_path / "j"), 17, jstate)
    want = _bridged(jstate, jcfg)
    template = tree_map(torch.zeros_like, want)
    got = restore(str(tmp_path / "j"), template)
    assert type(got).__name__ == "TrainState" and type(got.opt).__name__ == "OptState"
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save(str(tmp_path / "t"), 17, got)
    back = jckpt.restore(str(tmp_path / "t"), jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    import json

    read = lambda d: json.load(open(tmp_path / d / "step_00000017" / "manifest.json"))["leaves"]
    assert read("t") == read("j")
    assert jckpt.latest_step(str(tmp_path / "t")) == latest_step(str(tmp_path / "j")) == 17


# -- compression and stragglers -----------------------------------------------------
@pytest.mark.parametrize("scale", [1e-3, 0.37, 40.0])
def test_compression_matches_reference(scale):
    """compress_tree's codes and M1 scales, and decompress_tree's values,
    bit-identical to the reference's; the round trip within E4M3's
    relative error; the scale a power of two."""
    rng = np.random.default_rng(int(scale * 1000))
    grads = {"w": torch.from_numpy((rng.normal(size=(64, 64)) * scale).astype(np.float32)),
             "b": torch.from_numpy((rng.normal(size=(64,)) * scale).astype(np.float32)
                                   ).to(torch.bfloat16)}
    jg = tree_map(_to_jax, grads)
    got, want = tcomp.compress_tree(grads), jcomp.compress_tree(jg)
    for k in grads:
        (q, s), (jq, js) = got[k], want[k]
        assert q.dtype == torch.bfloat16 and np.array_equal(to_np(q), np.asarray(jq, np.float32))
        assert float(s) == float(js)
        assert float(np.log2(float(s))) == round(float(np.log2(float(s))))
    out = tcomp.decompress_tree(got, grads)
    jout = jcomp.decompress_tree(want, jg)
    for k in grads:
        assert out[k].dtype == grads[k].dtype
        assert np.array_equal(to_np(out[k]), np.asarray(jout[k], np.float32))
    w = grads["w"]
    assert float((w - out["w"]).norm() / w.norm()) < 0.05


def test_straggler_detection_and_reassignment():
    p = StragglerPolicy(n_hosts=4, threshold=1.5, patience=2)
    for step in range(4):
        for h in range(4):
            p.record(h, 1.0 if h != 2 else 3.0, now=100.0 + step)
        slow = p.stragglers()
    assert slow == [2] and p.reassign_shard(2) != 2


def test_straggler_dead_host_eviction():
    p = StragglerPolicy(n_hosts=3, heartbeat_timeout_s=10)
    for h in range(3):
        p.record(h, 1.0, now=100.0)
    p.record(0, 1.0, now=200.0)
    p.record(1, 1.0, now=200.0)
    assert p.dead_hosts(now=200.0) == [2]
    p.evict(2)
    assert p.live_count() == 2


def test_straggler_decisions_equal_reference_on_a_random_trace():
    rng = np.random.default_rng(9)
    ours, theirs = StragglerPolicy(n_hosts=6, patience=2), JStraggler(n_hosts=6, patience=2)
    for step in range(40):
        for h in range(6):
            if rng.random() < 0.9:
                lat = float(rng.gamma(2.0, 0.5) * (3.0 if h == step % 6 else 1.0))
                ours.record(h, lat, now=float(step))
                theirs.record(h, lat, now=float(step))
        assert ours.stragglers() == theirs.stragglers()
        assert ours.dead_hosts(now=step + 0.5) == theirs.dead_hosts(now=step + 0.5)
        for s in ours.stragglers():
            assert ours.reassign_shard(s) == theirs.reassign_shard(s)
        if step == 20:
            ours.evict(3)
            theirs.evict(3)
    assert ours.live_count() == theirs.live_count() == 5


def test_bridge_carries_a_train_state():
    """A reference TrainState with bf16 moments: params, mu, nu (in their
    dtype) and the int32 step, on the CPU."""
    jcfg, jstate = _train_states("bfloat16")
    state = _bridged(jstate, jcfg)
    assert int(state.opt.step) == 17 and state.opt.step.dtype == torch.int32
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        assert np.array_equal(to_np(a), np.asarray(b, np.float32))
        assert str(a.dtype).split(".")[-1] == np.asarray(b).dtype.name
