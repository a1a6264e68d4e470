"""``gelu`` in the port rounds as ``repro`` rounds it.

``repro.models.layers.activation(x, "gelu")`` is ``jax.nn.gelu(x,
approximate=True)``: on bf16 input XLA rounds each op of the chain to bf16
and computes tanh in f32 by its own rational approximation. The port
repeats that chain (``models/layers.py``), with XLA's tanh written out in
torch ops. Held bit for bit on the CPU: the activation on 10^5 seeded bf16
samples of N(0, 3^2), and the f32 tanh on samples across its whole range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.layers import activation as j_activation
from repro_torch.models.layers import activation, xla_tanh

from test_torch_bridge import t, to_np


def test_gelu_bf16_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    x = jnp.asarray((rng.normal(size=10**5) * 3.0).astype(np.float32)).astype(jnp.bfloat16)
    want = np.asarray(j_activation(x, "gelu").astype(jnp.float32))
    got = to_np(activation(t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16), "gelu"))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # torch's fused tanh gelu rounds once: it is not the reference's function
    fused = to_np(torch.nn.functional.gelu(t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16),
                                           approximate="tanh"))
    assert (fused != want).sum() > 1000


def test_xla_tanh_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 3, 10**5), rng.uniform(-12, 12, 2 * 10**4),
                        rng.normal(0, 1e-3, 10**4), [0.0, -0.0, 0.0004, 7.99881172180175781,
                                                     8.0, -8.0, 40.0, np.inf, -np.inf]])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))
    np.testing.assert_array_equal(to_np(xla_tanh(torch.from_numpy(x.copy()))), want)
