"""Gradients of the training loss in the port against ``jax.value_and_grad``
of the reference's, on the CPU, for the MLA and MoE families: minicpm3-4b
(MLA), olmoe-1b-7b (MoE, its balance loss in the total) and
deepseek-v3-671b (MLA + MoE + MTP, ``mtp_weight`` 0.3). The method, the
tolerances and block 0's planted fault are ``test_torch_grad_dense.py``'s.
Every MoE layer's routing is checked first: ``GradRoundings`` asserts that
both packages send every token to the same experts (and to the same
capacity slots) before the port goes on from the reference's combine
weights. The MoE families also plant the router's top-k weights detached,
which leaves the router only the balance loss's gradient."""
import pytest

from test_torch_grad_dense import cases, check_fault, check_remat, check_sound  # noqa: F401
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

MIXTURE = ("minicpm3-4b", "olmoe-1b-7b", "deepseek-v3-671b")
MOE = ("olmoe-1b-7b", "deepseek-v3-671b")


@pytest.mark.parametrize("name", MIXTURE)
def test_gradients_match_reference(cases, name):  # noqa: F811
    check_sound(cases, name)


@pytest.mark.parametrize("name,fault", [(n, "residual") for n in MIXTURE]
                         + [(n, "router") for n in MOE])
def test_planted_fault_reads_above_tolerance(cases, monkeypatch, name, fault):  # noqa: F811
    check_fault(cases, monkeypatch, name, fault)


@pytest.mark.parametrize("name", MIXTURE)
def test_remat_gives_identical_gradients(cases, name):  # noqa: F811
    check_remat(cases, name)
