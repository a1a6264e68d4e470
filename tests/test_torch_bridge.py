"""The weight bridge between the two packages, and the helpers the other
``test_torch_*`` files share: flattening a JAX params tree into the
``{"a/b/c": ndarray}`` form ``repro_torch.models.bridge.from_numpy`` reads,
and converting configs and tensors across."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core.policy import QuantPolicy
from repro.core.ptq import quantize_tree
from repro_torch.models import api as tapi
from repro_torch.models.bridge import from_numpy
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.layers import PackedLinear

from conftest import tiny_lm_cfg

POLICY = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256,
                     scale_mode="m2", lorc_rank=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU steps on one thread while a module that imports this
    runs: at these widths torch's intra-op threads only spin, and under a
    parallel test run they take cores from the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flatten_jax(tree):
    """``tree_flatten_with_path`` -> {"/"-joined path: ndarray}; a
    PackedLinear contributes one leaf per (non-None) tensor field."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                 for k in path]
        out["/".join(parts)] = np.asarray(leaf)
    return out


def port_cfg(jcfg):
    """The port's ArchConfig of a reference one, nested specs included."""
    from repro_torch.models import config as tconfig

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, spec in (("moe", tconfig.MoESpec), ("mla", tconfig.MLASpec),
                       ("ssm", tconfig.SSMSpec)):
        if fields[name] is not None:
            fields[name] = spec(**dataclasses.asdict(fields[name]))
    return TArchConfig(**fields)


def to_np(t: torch.Tensor) -> np.ndarray:
    """Exact host copy; bf16 comes back as f32 (exact widening)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def t(a, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (bf16 via a uint16 view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


@pytest.mark.parametrize("packed", [False, True])
def test_from_numpy_round_trips_every_leaf(packed):
    jcfg = tiny_lm_cfg()
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(1))
    if packed:
        params = quantize_tree(params, jmodels.build_def(jcfg), POLICY)
    flat = flatten_jax(params)
    tp = from_numpy(flat, port_cfg(jcfg), "cpu", policy=POLICY if packed else None)
    wq = tp["segments"][0]["mixer"]["attn"]["wq"]
    assert isinstance(wq, PackedLinear) == packed
    if packed:
        assert wq.group_size == 64 and wq.a_fmt == "fp8_e4m3"
        assert wq.codes.shape == (jcfg.n_layers, 64, 32)
    for path, arr in flat.items():
        node = tp
        for p in path.split("/"):
            node = getattr(node, p) if isinstance(node, PackedLinear) else \
                node[int(p)] if isinstance(node, list) else node[p]
        want = np.asarray(arr).astype(np.float32) if arr.dtype.name == "bfloat16" else arr
        np.testing.assert_array_equal(to_np(node), want, err_msg=path)


def test_from_numpy_rejects_wrong_shapes():
    jcfg = tiny_lm_cfg()
    flat = flatten_jax(jmodels.init_params(jcfg, jax.random.PRNGKey(1)))
    flat["embed"] = flat["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        from_numpy(flat, port_cfg(jcfg), "cpu")
    del flat["final_ln/scale"]
    with pytest.raises((KeyError, ValueError)):
        from_numpy(flat, port_cfg(jcfg), "cpu")


def test_port_param_tree_matches_reference_structure():
    """build_def gives the same leaf paths, shapes and axes as the
    reference (so from_numpy can always place a reference checkpoint)."""
    from repro_torch.models.params import ParamDef, tree_items

    jcfg = tiny_lm_cfg()
    jdefs = jax.tree_util.tree_flatten_with_path(
        jmodels.build_def(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    jmap = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(d.shape), tuple(d.axes), d.init) for path, d in jdefs}
    tmap = {p: (tuple(d.shape), tuple(d.axes), d.init) for p, d in
            tree_items(tapi.build_def(port_cfg(jcfg)), is_leaf=lambda x: isinstance(x, ParamDef))}
    assert tmap == jmap


def test_init_params_laws():
    """Same std laws as the reference, drawn from a torch.Generator."""
    from repro_torch.configs.opt_125m import SMOKE

    p = tapi.init_params(SMOKE, seed=3, device="cpu")
    p2 = tapi.init_params(SMOKE, seed=3, device="cpu")
    wq = p["segments"][0]["mixer"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 64)
    assert torch.equal(wq, p2["segments"][0]["mixer"]["attn"]["wq"])
    assert abs(float(wq.float().std()) - 1 / 8) < 0.01  # 1/sqrt(fan_in=64)
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.002
    assert torch.all(p["final_ln"]["scale"] == 1) and torch.all(p["final_ln"]["bias"] == 0)
