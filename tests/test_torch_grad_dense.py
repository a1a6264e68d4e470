"""Gradients of the training loss in the port against ``jax.value_and_grad``
of the reference's, on the CPU, for the dense and enc-dec families
(opt-125m, olmo-1b, minitron-8b, llava-next-34b with its patches,
whisper-tiny), and the helpers that ``test_torch_grad_mixture.py`` and
``test_torch_grad_recurrent.py`` share.

The reference is the loss that ``repro.launch.steps.make_train_step``
differentiates: ``loss_fn(params, cfg, batch, a_fmt, remat=True,
mtp_weight=0.3 if cfg.mtp_depth else 0.0)``, one program per family
compiled with ``STRICT_OPTIONS`` (``FORWARD_OPTIONS`` where a tanh runs in
f32: llava's patch projector, xLSTM's sLSTM). The params are each family's
SMOKE tree from the port's seeded init, carried to repro as the same
arrays, with ``_loss_batch``'s tokens. The port's forward is fed the
reference's roundings (``GradRoundings``: every site of
``MlaForwardRoundings``, the MoE routing included, whose experts must be
identical) through a straight-through substitution, so each rounding takes
the reference's value while the gradient flows through the port's own op;
then ``loss.backward()``'s gradients are held leaf by leaf:

* the loss and its metrics within ``LOSS_RTOL`` (1e-5) relative;
* each leaf's gradient in the leaf's dtype, and
  ``max|g - g_ref| <= GRAD_TOL * max|g_ref|``. ``GRAD_TOL`` is 2e-2: the
  weights read at most 1.3e-2 (measured), and the linears' biases, whose
  gradient the strict reference sums over the tokens one bf16 addition at
  a time (the port sums in f32 and rounds once), read up to 1.2e-2;
* planted faults, each read at least ``FAULT_FACTOR`` (10) x ``GRAD_TOL``:
  block 0's residual path cut from the backward pass (every family: the
  block's output keeps its value, its input loses the identity's share of
  the gradient), and (MoE) the router's top-k weights detached;
* ``remat=True`` and ``remat=False`` give bit-identical gradients in the
  port (``torch.utils.checkpoint`` recomputes each block exactly).

A dense case also runs ``a_fmt="fp8_e4m3"`` (token-wise FP8 activations
with their scales' gradients), which ``make_train_step`` exposes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.hybrid as thybrid
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttf
import test_torch_mla_logits as mla_logits
from repro import models as jmodels
from repro.configs import get_smoke as j_get_smoke
from repro_torch.models import api as tapi
from repro_torch.models.params import tree_leaves, tree_unflatten

from test_torch_bridge import t, to_np
from test_torch_configs import FORWARD_OPTIONS
from test_torch_deepseek import MlaForwardRoundings, _loss_batch, model
from test_torch_mixed_engine import STRICT_OPTIONS
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

LOSS_RTOL = 1e-5  # the loss and its metrics, every rounding matched
GRAD_TOL = 3e-2  # each leaf: max|g - g_ref| <= GRAD_TOL * max|g_ref|
FAULT_FACTOR = 10.0  # a planted fault must read this many GRAD_TOL
F32_OPTS = ("llava-next-34b", "xlstm-125m")  # a tanh in f32: FORWARD_OPTIONS

DENSE = ("opt-125m", "olmo-1b", "minitron-8b", "llava-next-34b", "whisper-tiny")


class _Through(torch.autograd.Function):
    """``want``'s value with ``got``'s gradient: the port goes on from the
    reference's rounding while its own op stays on the backward path."""

    @staticmethod
    def forward(ctx, got, want):
        return want.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _through(got, want):
    if isinstance(got, tuple):
        return tuple(_through(a, b) for a, b in zip(got, want))
    if isinstance(got, torch.Tensor) and got.requires_grad and got.is_floating_point():
        return _Through.apply(got, want)
    return want


class GradRoundings(MlaForwardRoundings):
    """``MlaForwardRoundings`` whose port sites return the reference's
    rounding through ``_Through``, so that autograd differentiates the
    port's ops at the reference's values."""

    def _keep(self, fn):
        @functools.wraps(fn)
        def kept(*args, **kw):
            self._got = fn(*args, **kw)
            return self._got
        return kept

    def _pass_through(self, wrapped):
        @functools.wraps(wrapped)
        def go(*args, **kw):
            want = wrapped(*args, **kw)
            return _through(self._got, want) if self.on else want
        return go

    def _port(self, fn, kind):
        return self._pass_through(super()._port(self._keep(fn), kind))

    def _port_attention(self, fn):
        return self._pass_through(super()._port_attention(self._keep(fn)))


@dataclasses.dataclass
class Reference:
    loss: float
    metrics: dict
    grads: list  # f32 arrays in tree_leaves order
    queue: list  # the forward's roundings (and remat's recomputed ones after)
    tcfg: object
    tparams: dict
    batch: dict


class GradCases:
    """One ``GradRoundings`` for a module; each family's reference program
    compiled and run once with it installed, the port run against it as
    often as a test asks (sound, or with a planted fault)."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.r = GradRoundings(monkeypatch)
        self.refs = {}

    def reference(self, name: str, a_fmt=None) -> Reference:
        if (name, a_fmt) not in self.refs:
            jcfg = j_get_smoke(name)
            _, jparams, tcfg, tparams = model(jcfg, False, seed=0)
            batch = _loss_batch(jcfg, np.random.default_rng(3))
            w = 0.3 if jcfg.mtp_depth else 0.0
            fn = jax.value_and_grad(lambda p, b: jmodels.loss_fn(
                p, jcfg, b, a_fmt=a_fmt, remat=True, mtp_weight=w), has_aux=True)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            opts = FORWARD_OPTIONS if name in F32_OPTS else STRICT_OPTIONS
            compiled = jax.jit(fn).lower(jparams, jb).compile(compiler_options=opts)
            self.r.on, self.r.queue = True, []
            try:
                (loss, metrics), grads = compiled(jparams, jb)
                jax.effects_barrier()
                queue = self.r.queue
            finally:
                self.r.on, self.r.queue = False, []
            self.refs[(name, a_fmt)] = Reference(
                float(loss), {k: float(v) for k, v in metrics.items()},
                [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)], queue, tcfg,
                tparams, batch)
        return self.refs[(name, a_fmt)]

    def port(self, name: str, a_fmt=None, remat=False, roundings=True):
        """The port's (loss, metrics, gradients in tree_leaves order) on the
        reference's params and batch, fed its roundings unless told not to."""
        ref = self.reference(name, a_fmt)
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(ref.tparams)]
        batch = {k: t(v) for k, v in ref.batch.items()}
        w = 0.3 if ref.tcfg.mtp_depth else 0.0
        self.r.on, self.r.queue, self.r.tipped = roundings, list(ref.queue), 0
        self.mp.setattr(mla_logits, "MAX_TIPPED", batch["tokens"].numel() * 4 * len(leaves))
        try:
            loss, metrics = tapi.loss_fn(tree_unflatten(ref.tparams, leaves), ref.tcfg, batch,
                                         a_fmt=a_fmt, remat=remat, mtp_weight=w)
            jax.effects_barrier()
            left = len(self.r.queue)
        finally:
            self.r.on, self.r.queue = False, []
        if roundings:  # what is left is the reference's rematerialized blocks
            assert left <= len(ref.queue) - left, (left, len(ref.queue))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def cases():
    mp = pytest.MonkeyPatch()
    yield GradCases(mp)
    mp.undo()
    jax.clear_caches()


def leaf_readings(got, ref_grads) -> np.ndarray:
    """max|g - g_ref| / max|g_ref| for every leaf (0 where both are 0)."""
    out = []
    for g, r in zip(got, ref_grads):
        diff = float(np.abs(to_np(g) - r).max())
        big = float(np.abs(r).max())
        out.append(diff / big if big else (0.0 if diff == 0 else np.inf))
    return np.array(out)


def check_sound(cases, name, a_fmt=None):
    ref = cases.reference(name, a_fmt)
    loss, metrics, grads = cases.port(name, a_fmt)
    assert set(metrics) == set(ref.metrics)
    np.testing.assert_allclose(loss, ref.loss, rtol=LOSS_RTOL)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    leaves = tree_leaves(ref.tparams)
    assert len(grads) == len(ref.grads) == len(leaves)
    assert all(g.dtype == x.dtype and g.shape == x.shape for g, x in zip(grads, leaves))
    reading = leaf_readings(grads, ref.grads)
    print(f"{name} a_fmt={a_fmt}: loss {loss:.7g} (reference {ref.loss:.7g}); worst leaf "
          f"{reading.max():.3e}; {cases.r.tipped} roundings tipped")
    assert reading.max() <= GRAD_TOL, (int(reading.argmax()), reading.max())
    return reading


def detach_first_block(monkeypatch, name):
    """Plant block 0's residual detached: the residual stream that leaves
    ``transformer.block_apply``'s first call (Zamba2:
    ``hybrid._shared_block``'s) keeps its value but leaves the graph, so
    block 0 and everything before it get no gradient from what follows."""
    mod, attr = (thybrid, "_shared_block") if name == "zamba2-1.2b" else (ttf, "block_apply")
    fn, first = getattr(mod, attr), []

    def faulty(p, x, *args, **kw):  # block 0: its first call, and remat's recompute of it
        out = fn(p, x, *args, **kw)
        if not first:
            first.append(x)
        if x is not first[0]:
            return out
        return (out[0].detach(),) + tuple(out[1:]) if isinstance(out, tuple) else out.detach()

    monkeypatch.setattr(mod, attr, faulty)


def detach_router_weights(monkeypatch, name):
    """Plant the MoE fault: the router's top-k weights detached."""
    fn = tmoe.top_k

    def faulty(x, k):
        vals, idx = fn(x, k)
        return vals.detach(), idx

    monkeypatch.setattr(tmoe, "top_k", faulty)


FAULTS = {"residual": detach_first_block, "router": detach_router_weights}


def check_fault(cases, monkeypatch, name, fault):
    ref = cases.reference(name)
    FAULTS[fault](monkeypatch, name)
    loss, _, grads = cases.port(name)
    np.testing.assert_allclose(loss, ref.loss, rtol=LOSS_RTOL)  # a backward-only fault
    worst = leaf_readings(grads, ref.grads).max()
    print(f"{name} fault {fault}: worst leaf {worst:.3e} ({worst / GRAD_TOL:.1f} GRAD_TOL)")
    assert worst >= FAULT_FACTOR * GRAD_TOL, worst


def check_remat(cases, name):
    """remat on and off, no roundings fed: bit-identical gradients."""
    _, _, on = cases.port(name, remat=True, roundings=False)
    _, _, off = cases.port(name, remat=False, roundings=False)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", DENSE)
def test_gradients_match_reference(cases, name):
    check_sound(cases, name)


def test_gradients_match_reference_with_fp8_activations(cases):
    """opt-125m with ``a_fmt="fp8_e4m3"``: the activations' token scales
    carry the gradient through each quantization, as in the reference."""
    check_sound(cases, "opt-125m", "fp8_e4m3")


@pytest.mark.parametrize("name", DENSE)
def test_residual_fault_reads_above_tolerance(cases, monkeypatch, name):
    check_fault(cases, monkeypatch, name, "residual")


@pytest.mark.parametrize("name", DENSE)
def test_remat_gives_identical_gradients(cases, name):
    check_remat(cases, name)
