"""Gradients of the training loss in the port against ``jax.value_and_grad``
of the reference's, on the CPU, for the recurrent families: xlstm-125m
(mLSTM's chunked form, sLSTM's cell one token at a time with XLA's f32
tanh, so the reference compiles with ``FORWARD_OPTIONS``) and zamba2-1.2b
(Mamba2's chunked scan with its softplus, the shared attention block; block
0's planted fault on the shared block's first invocation). The method and
the tolerances are ``test_torch_grad_dense.py``'s; the cells'
transcendentals are torch's (``exp``, ``log1p``), within an f32 ulp of
XLA's, and their gradient rules JAX's (``layers.softplus``,
``log_sigmoid``, ``xla_tanh``)."""
import pytest

from test_torch_grad_dense import cases, check_fault, check_remat, check_sound  # noqa: F401
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

RECURRENT = ("xlstm-125m", "zamba2-1.2b")


@pytest.mark.parametrize("name", RECURRENT)
def test_gradients_match_reference(cases, name):  # noqa: F811
    check_sound(cases, name)


@pytest.mark.parametrize("name", RECURRENT)
def test_residual_fault_reads_above_tolerance(cases, monkeypatch, name):  # noqa: F811
    check_fault(cases, monkeypatch, name, "residual")


@pytest.mark.parametrize("name", RECURRENT)
def test_remat_gives_identical_gradients(cases, name):  # noqa: F811
    check_remat(cases, name)
