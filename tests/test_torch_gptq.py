"""GPTQ in the port (``repro_torch.core.gptq`` and ``core.ptq``'s pipeline)
against the reference on the CPU, with the same numpy inputs.

The reference's ``_gptq_core`` is jitted, and XLA turns its ``absmax /
grid_max`` into a multiply by the f32 reciprocal; the port multiplies by
that reciprocal too, so scales taken from unmodified weights (each row's
first group, M2's ``s_max``) are bit-identical. Later groups' scales under
``scale_mode='none'`` come from error-fed weights, whose f32 sums run in
another order (XLA's dot against torch's, LAPACK's factor against
XLA's): they agree to ~1e-7 relative, and M1/M2 snap them to powers of
two. A code can flip where a value sits on a rounding tie, so codes are
held to an agreement rate, observed at 100 %."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core import gptq as JG
from repro.core.policy import PRESETS as JPRESETS
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.ptq import gptq_quantize_lm as j_gptq_lm
from repro.core.ptq import pack_linear as j_pack_linear
from repro.core.ptq import quantized_shape_tree as j_shape_tree
from repro.data.pipeline import calibration_stream as j_calibration
from repro.models.losses import chunked_xent as j_xent
from repro_torch.core import gptq as TG
from repro_torch.core.formats import value_grid
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.core.ptq import gptq_quantize_lm as t_gptq_lm
from repro_torch.core.ptq import pack_linear as t_pack_linear
from repro_torch.core.ptq import pack_params, quantized_shape_tree
from repro_torch.core.quantize import QuantizedTensor as TQT
from repro_torch.core.quantize import fake_quantize_weight, quantize_weight
from repro_torch.data.pipeline import calibration_stream as t_calibration
from repro_torch.models import api as tapi
from repro_torch.models.bridge import from_numpy
from repro_torch.models.layers import PackedLinear
from repro_torch.models.losses import chunked_xent as t_xent

from test_torch_bridge import flatten_jax, port_cfg, t, to_np
from test_torch_mixed_engine import STRICT_OPTIONS
from test_torch_scheduler import one_thread  # noqa: F401  (autouse: torch on one thread)

CODE_AGREEMENT = 0.999  # of elements (codes) and of groups (M1/M2 scales)
NONE_SCALE_RTOL = 1e-5  # error-fed scales under scale_mode='none'
FMTS = ("fp4_e2m1", "fp4_e3m0", "int4")
MODES = ("none", "m1", "m2")


def _calib(rng, n, d, correlated=True):
    x = rng.normal(size=(n, d)).astype(np.float32)
    if correlated:  # mixed on torch's one thread: numpy's BLAS threads contend under xdist
        mix = rng.normal(size=(d, d)).astype(np.float32) * 0.3 + np.eye(d, dtype=np.float32)
        x = (torch.from_numpy(x) @ torch.from_numpy(mix)).numpy()
    return x


def _hessian(rng, d, n=None):
    """The reference's Hessian of correlated inputs, as numpy."""
    x = _calib(rng, n or 2 * d, d)
    return np.asarray(JG.hessian_update(JG.hessian_init(d), jnp.asarray(x)).h)


def test_hessian_update_matches_reference_over_two_chunks():
    rng = np.random.default_rng(8)
    x = _calib(rng, 300, 48)
    js = JG.hessian_init(48)
    ts = TG.hessian_init(48, "cpu")
    for part in (x[:128], x[128:]):
        js = JG.hessian_update(js, jnp.asarray(part))
        ts = TG.hessian_update(ts, t(part))
    assert float(ts.n) == float(js.n) == 300
    want = np.asarray(js.h)
    np.testing.assert_allclose(to_np(ts.h), want, rtol=0, atol=1e-6 * np.abs(want).max())
    expect = 2.0 * (x.astype(np.float64).T @ x) / 300
    np.testing.assert_allclose(to_np(ts.h), expect, rtol=1e-4, atol=1e-5)


# (out, in, group, format, scale mode): every format and mode at (64, 128,
# group 32), and E2M1 at two wider shapes under 'none' and 'm2'. Each case
# compiles the reference's sweep once (its format, mode and shapes are
# static), the cost of this test; the tests below reuse these programs.
CORE_CASES = ([(64, 128, 32, fmt, mode) for fmt in FMTS for mode in MODES]
              + [(128, 256, 128, "fp4_e2m1", "none"), (128, 256, 128, "fp4_e2m1", "m2"),
                 (96, 768, 256, "fp4_e2m1", "m2")])


@pytest.mark.parametrize("out_f,in_f,group,fmt,scale_mode", CORE_CASES)
def test_gptq_core_matches_reference(out_f, in_f, group, fmt, scale_mode):
    """The port's column sweep on the reference's own Hessian."""
    rng = np.random.default_rng(out_f + in_f + group)
    w = (rng.normal(size=(out_f, in_f)) * 0.05).astype(np.float32)
    h = _hessian(rng, in_f)
    block = min(128, group)
    jq, js = (np.asarray(a) for a in JG._gptq_core(jnp.asarray(w), jnp.asarray(h), fmt, group,
                                                   scale_mode, 0.01, block))
    tq, ts = (to_np(a) for a in TG._gptq_core(t(w), t(h), fmt, group, scale_mode, 0.01, block))
    codes = float((tq == jq).mean())
    print(f"codes equal on {codes:.6f} of {tq.size}")
    assert codes >= CODE_AGREEMENT
    # scales of unmodified weights: each row's first group
    np.testing.assert_array_equal(ts[:, 0], js[:, 0])
    if scale_mode == "none":
        np.testing.assert_allclose(ts, js, rtol=NONE_SCALE_RTOL, atol=0)
    else:
        groups = float((ts == js).mean())
        print(f"{scale_mode} scales equal on {groups:.6f} of {ts.size} groups")
        assert groups >= CODE_AGREEMENT
    if scale_mode == "m2":  # s_max of the initial full-row absmax, as packed
        np.testing.assert_array_equal(ts.max(axis=1), js.max(axis=1))


@pytest.mark.parametrize("fmt", FMTS + ("fp8_e4m3", "fp8_e5m2"))
def test_sweep_rounding_is_round_to_fmt_bit_for_bit(fmt):
    """The column sweep's grid lookup against ``_round_to_fmt`` (and so the
    reference's rounding): normals at six scales, every grid value and
    midpoint and their neighbouring floats, zeros of both signs, negative
    values that round to -0, f32 subnormals, infinities and NaN."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import _round_to_fmt

    g = torch.Generator().manual_seed(3)
    parts = [torch.randn(20000, generator=g) * sc for sc in (1e-3, 0.1, 1, 3, 10, 1e3)]
    if fmt.startswith("fp"):
        grid = torch.from_numpy(value_grid(fmt))
        for v in (grid, (grid[:-1] + grid[1:]) / 2):
            parts += [v, torch.nextafter(v, torch.full_like(v, 1e9)),
                      torch.nextafter(v, torch.full_like(v, -1e9))]
    parts.append(torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 3e38, -3e38,
                               float("inf"), -float("inf"), float("nan")]))
    x = torch.cat(parts).float()
    got, want = TG._grid_rounding(get_format(fmt), "cpu")(x), _round_to_fmt(x, get_format(fmt))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("scale_mode", MODES)
@pytest.mark.parametrize("fmt", FMTS)
def test_identity_hessian_is_rtn_bit_for_bit(fmt, scale_mode):
    """H = c * I feeds no error between columns: GPTQ's codes and scales
    are round to nearest's, in both packages."""
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(64, 128)) * 0.05).astype(np.float32)
    h = np.eye(128, dtype=np.float32) * 2.5
    _, tqt = TG.gptq_quantize(t(w), t(h), fmt, group_size=32, scale_mode=scale_mode)
    _, jqt = JG.gptq_quantize(jnp.asarray(w), jnp.asarray(h), fmt, group_size=32,
                              scale_mode=scale_mode)
    from repro_torch.core.scales import apply_scale_constraint

    rtn_s = apply_scale_constraint(quantize_weight(t(w), fmt, 32).scale, scale_mode)
    rtn = quantize_weight(t(w), fmt, 32, scale=rtn_s)
    for field in ("values", "scale"):
        np.testing.assert_array_equal(to_np(getattr(tqt, field)), to_np(getattr(rtn, field)))
        np.testing.assert_array_equal(to_np(getattr(tqt, field)), np.asarray(getattr(jqt, field)))


def test_inverse_not_positive_definite_gives_nan_in_both():
    """A damped Hessian whose inverse is not positive definite: the
    reference's Cholesky factor is NaN (jnp.linalg.cholesky), and so is the
    port's (torch's raises; the port reads cholesky_ex's info), and NaN
    flows through the sweep to the same places."""
    rng = np.random.default_rng(6)
    d = 128
    h = -np.eye(d, dtype=np.float32) + 0.01 * rng.normal(size=(d, d)).astype(np.float32)
    h = 0.5 * (h + h.T)
    ju = np.asarray(JG._invh_cholesky(jnp.asarray(h), 0.01))
    tu = to_np(TG._invh_cholesky(t(h), 0.01))
    upper = np.triu(np.ones((d, d), bool))
    assert np.isnan(ju[upper]).all() and (ju[~upper] == 0).all()
    np.testing.assert_array_equal(tu, ju)
    w = (rng.normal(size=(64, d)) * 0.05).astype(np.float32)
    jq, js = (np.asarray(a) for a in JG._gptq_core(jnp.asarray(w), jnp.asarray(h), "fp4_e2m1",
                                                   32, "none", 0.01, 32))
    tq, ts = (to_np(a) for a in TG._gptq_core(t(w), t(h), "fp4_e2m1", 32, "none", 0.01, 32))
    assert np.isnan(tq).any() and np.isnan(ts).any()
    np.testing.assert_array_equal(np.isnan(tq), np.isnan(jq))
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_array_equal(tq[~np.isnan(tq)], jq[~np.isnan(jq)])


# the port's copies of the reference's TestGPTQ cases (tests/test_core_quantize.py)
def _rand_w(rng, out_f, in_f):
    return t(rng.normal(size=(out_f, in_f)).astype(np.float32) * 0.05)


def _port_hessian(x):
    return TG.hessian_update(TG.hessian_init(x.shape[1], "cpu"), t(x))


@pytest.mark.parametrize("fmt", ["int4", "fp4_e2m1"])
def test_gptq_beats_rtn(fmt):
    """The point of GPTQ: lower layer-output error than round to nearest."""
    rng = np.random.default_rng(9)
    d, out = 128, 64
    w = _rand_w(rng, out, d)
    x = _calib(rng, 2048, d)
    w_gptq, _ = TG.gptq_quantize(w, _port_hessian(x).h, fmt, group_size=64, block=32)
    w_rtn = fake_quantize_weight(w, fmt, group_size=64)
    xt = t(x)
    y = xt @ w.T
    e_gptq = float(torch.linalg.norm(y - xt @ w_gptq.T))
    e_rtn = float(torch.linalg.norm(y - xt @ w_rtn.T))
    assert e_gptq < e_rtn, (e_gptq, e_rtn)


def test_gptq_values_on_grid():
    rng = np.random.default_rng(10)
    w = _rand_w(rng, 16, 64)
    _, qt = TG.gptq_quantize(w, _port_hessian(_calib(rng, 512, 64)).h, "fp4_e2m1",
                             group_size=32, block=32)
    assert set(np.unique(to_np(qt.values)).tolist()) <= set(value_grid("fp4_e2m1").tolist())


def test_gptq_m2_scales_pow2_structure():
    rng = np.random.default_rng(11)
    w = _rand_w(rng, 16, 128)
    _, qt = TG.gptq_quantize(w, _port_hessian(_calib(rng, 512, 128)).h, "fp4_e2m1",
                             group_size=32, scale_mode="m2", block=32)
    s = to_np(qt.scale)  # (16, 4)
    ratio = s.max(axis=1, keepdims=True) / s
    np.testing.assert_allclose(np.log2(ratio), np.round(np.log2(ratio)), atol=1e-5)


def test_gptq_ignores_the_callers_tf32_setting():
    """The sweep's products run in full f32 under any matmul precision, and
    the caller's setting is restored."""
    rng = np.random.default_rng(12)
    w, h = _rand_w(rng, 32, 128), _port_hessian(_calib(rng, 512, 128)).h
    before = torch.get_float32_matmul_precision()
    ref = TG.gptq_quantize(w, h, "fp4_e2m1", group_size=64)[1]
    try:
        torch.set_float32_matmul_precision("medium")
        got = TG.gptq_quantize(w, h, "fp4_e2m1", group_size=64)[1]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got.values, ref.values) and torch.equal(got.scale, ref.scale)


# --------------------------------------------------------------------------
# pack_linear(qt=...) and the shape tree
# --------------------------------------------------------------------------
PACK_POLICY = dict(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=32, scale_mode="m2",
                   lorc_rank=8, method="gptq")


@pytest.mark.parametrize("with_lorc", [None, False])
def test_pack_linear_of_a_gptq_result_matches_reference(with_lorc):
    """The reference's GPTQ result packed by both packages (the shape of a
    case above, whose compiled sweep is reused)."""
    rng = np.random.default_rng(13)
    w = (rng.normal(size=(64, 128)) * 0.05).astype(np.float32)
    _, jqt = JG.gptq_quantize(jnp.asarray(w), jnp.asarray(_hessian(rng, 128)), "fp4_e2m1",
                              group_size=32, scale_mode="m2")
    tqt = TQT(values=t(np.asarray(jqt.values)), scale=t(np.asarray(jqt.scale)),
              zero_point=None, group_size=jqt.group_size, fmt_name=jqt.fmt_name)
    jp = j_pack_linear(jnp.asarray(w), JPolicy(**PACK_POLICY), qt=jqt, with_lorc=with_lorc)
    tp = t_pack_linear(t(w), TPolicy(**PACK_POLICY), qt=tqt, with_lorc=with_lorc)
    assert (tp.w_fmt, tp.a_fmt, tp.group_size) == (jp.w_fmt, jp.a_fmt, jp.group_size)
    for field in ("codes", "scale", "s_max", "shifts"):
        a, b = to_np(getattr(tp, field)), np.asarray(getattr(jp, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if with_lorc is False:
        assert tp.lorc_a is None and jp.lorc_a is None and tp.lorc_b is None
        return
    corr_t = to_np(tp.lorc_a.float() @ tp.lorc_b.float())
    corr_j = np.asarray(jp.lorc_a.astype(jnp.float32) @ jp.lorc_b.astype(jnp.float32))
    np.testing.assert_allclose(corr_t, corr_j, atol=2.0**-7 * float(np.abs(corr_j).max()), rtol=0)


@pytest.mark.parametrize("preset", ["deploy_w4a8", "w4a8_int_fp"])
def test_quantized_shape_tree_matches_pack_params_and_reference(preset):
    from conftest import tiny_lm_cfg

    jcfg = tiny_lm_cfg()
    tcfg = port_cfg(jcfg)
    jpol, tpol = JPRESETS[preset], TPolicy(**vars(JPRESETS[preset]))
    meta = quantized_shape_tree(tapi.build_def(tcfg), tpol)
    packed = pack_params(tapi.init_params(tcfg, seed=0, device="cpu"), tcfg, tpol, device="cpu")
    jshapes = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in
               _flatten_sds(j_shape_tree(jmodels.build_def(jcfg), jpol)).items()}
    tmeta, tpacked = _flatten_port(meta), _flatten_port(packed)
    assert set(tmeta) == set(tpacked) == set(jshapes)
    for k, m in tmeta.items():
        assert m.device.type == "meta", k
        assert (tuple(m.shape), m.dtype) == (tuple(tpacked[k].shape), tpacked[k].dtype), k
        assert (tuple(m.shape), _np_dtype(m.dtype)) == jshapes[k], k


def _np_dtype(dt):
    if dt == torch.bfloat16:
        return jnp.dtype(jnp.bfloat16)
    return torch.empty((), dtype=dt).numpy().dtype


def _flatten_sds(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                     for k in path): leaf for path, leaf in leaves}


def _flatten_port(tree, prefix=""):
    out = {}
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(tree, PackedLinear):
        for f in PackedLinear._FIELDS:
            if getattr(tree, f) is not None:
                out[join(f)] = getattr(tree, f)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_port(v, join(k)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten_port(v, join(i)))
    else:
        out[prefix] = tree
    return out


# --------------------------------------------------------------------------
# the pipeline on the trained tiny LM
# --------------------------------------------------------------------------
CALIB = dict(n_batches=4, batch=8, seq=32)
EVAL_SEED = 1777
RTN_M2 = dict(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", group_size=256, scale_mode="m2",
              method="rtn")
# the pipeline's RTN branch under unconstrained scales: the reference's M2
# constraint runs eagerly there and costs ~7 s of compiles; RTN's M2
# scales are held bit for bit by tests/test_torch_core.py
RTN = dict(RTN_M2, scale_mode="none")
LM_POLICIES = {  # name: (policy fields, the same policy without LoRC or None)
    "w4a8_fp_fp_m2_lorc": (vars(JPRESETS["w4a8_fp_fp_m2_lorc"]),
                           dict(vars(JPRESETS["w4a8_fp_fp_m2_lorc"]), lorc_rank=0)),
    "w4a8_int_fp": (vars(JPRESETS["w4a8_int_fp"]), None),
    "rtn": (RTN, None),
}


FIG1 = ("wq", "wk", "wv", "wo", "up", "down", "gate")


def _bf16_ulp(a):
    """One bf16 ulp at |a| (normal range; 2^-133 at 0)."""
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


class _JaxNll:
    """The reference's forward_hidden + chunked_xent, compiled once with
    STRICT_OPTIONS (bf16 rounded where the source rounds) for every tree of
    the same structure."""

    def __init__(self, jcfg, a_fmt):
        self.fn = jax.jit(lambda p, tok, lab: j_xent(
            jmodels.forward_hidden(p, jcfg, {"tokens": tok}, a_fmt=a_fmt)[0], p["embed"],
            lab)[0])
        self.compiled = None

    def __call__(self, params, batch):
        args = (params, batch["tokens"], batch["labels"])
        if self.compiled is None:
            self.compiled = self.fn.lower(*args).compile(compiler_options=STRICT_OPTIONS)
        return float(self.compiled(*args))


def _perplexity_jax(nll_fn, params, batches):
    return float(np.exp(np.mean([nll_fn(params, b) for b in batches])))


def _perplexity_port(params, tcfg, batches, a_fmt):
    nll = [float(t_xent(tapi.forward_hidden(params, tcfg, b, a_fmt=a_fmt)[0],
                        params["embed"], b["labels"])[0]) for b in batches]
    return float(np.exp(np.mean(nll)))


@pytest.fixture(scope="module")
def quantized_lms(trained_tiny):
    """Both packages' pipelines on the trained tiny LM, same calibration
    tokens: {name: (repro's flat tree, the port's tree, repro's tree
    without LoRC or None, perplexities (repro, port))}."""
    jcfg, jparams = trained_tiny
    tcfg = port_cfg(jcfg)
    tparams = from_numpy(flatten_jax(jparams), tcfg, "cpu")
    jcal, tcal = j_calibration(jcfg, **CALIB), t_calibration(tcfg, **CALIB)
    for a, b in zip(jcal, tcal):
        np.testing.assert_array_equal(np.asarray(a["tokens"]), b["tokens"].numpy())
    jev = j_calibration(jcfg, 2, CALIB["batch"], CALIB["seq"], seed=EVAL_SEED)
    tev = t_calibration(tcfg, 2, CALIB["batch"], CALIB["seq"], seed=EVAL_SEED)
    out, nll_fn = {"observed": []}, _JaxNll(jcfg, "fp8_e4m3")
    for name, (fields, bare) in LM_POLICIES.items():
        assert fields["a_fmt"] == "fp8_e4m3"
        jq = j_gptq_lm(jparams, jcfg, jcal, JPolicy(**fields))
        observe = _observer(out["observed"]) if name == "w4a8_fp_fp_m2_lorc" else None
        tq = t_gptq_lm(tparams, tcfg, tcal, TPolicy(**fields), observe=observe)
        jbare = None if bare is None else flatten_jax(j_gptq_lm(jparams, jcfg, jcal,
                                                                JPolicy(**bare)))
        ppl = (_perplexity_jax(nll_fn, jq, jev), _perplexity_port(tq, tcfg, tev, "fp8_e4m3"))
        out[name] = (flatten_jax(jq), tq, jbare, ppl)
    return out


def _leaf(tree, path):
    for p in path.split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


@pytest.mark.parametrize("name", list(LM_POLICIES))
def test_gptq_quantize_lm_leaves_match_reference(quantized_lms, name):
    """Every leaf of the port's result against the reference's: the
    quantized ones within one bf16 ulp on >= 99.9 % of elements (plus,
    with LoRC, the LoRC tolerance of tests/test_torch_core.py: 2^-7 of the
    largest correction), the others bit-identical."""
    jflat, tq, jbare, _ = quantized_lms[name]
    quantized = 0
    for path, want in jflat.items():
        got = to_np(_leaf(tq, path))
        want = np.asarray(want).astype(np.float32)
        assert got.shape == want.shape and got.dtype == np.float32, path
        if path.split("/")[-1] not in FIG1:
            np.testing.assert_array_equal(got, want, err_msg=path)
            continue
        quantized += 1
        tol = _bf16_ulp(want)
        if jbare is not None:
            corr = want - np.asarray(jbare[path]).astype(np.float32)
            tol = tol + 2.0 ** -7 * np.abs(corr).max(axis=(-2, -1), keepdims=True)
        within = float((np.abs(got - want) <= tol).mean())
        print(f"{name} {path}: within on {within:.6f}")
        assert within >= CODE_AGREEMENT, (path, within)
    assert quantized == 6


@pytest.mark.parametrize("name", list(LM_POLICIES))
def test_gptq_quantize_lm_perplexity_matches_reference(quantized_lms, name):
    """Perplexity (forward_hidden + chunked_xent on 2 held-out batches at
    the policy's activation format) within 0.1 % of the reference's."""
    pj, pt = quantized_lms[name][3]
    print(f"{name}: perplexity repro {pj:.6f} port {pt:.6f}")
    assert np.isfinite(pt) and abs(pt - pj) <= 1e-3 * pj


def _observer(seen):
    """An ``observe`` callback recording, per weight, its layer and name and
    the Hessian-weighted error tr(dW H dW^T) of the GPTQ codes (before
    LoRC) and of RTN under the same M2 constraint, on the same Hessian."""
    from repro_torch.core.ptq import _rtn

    def observe(layer, name, w, hessian, qt):
        def err(w_hat):
            dw = w.float() - w_hat
            return float(torch.trace(dw @ hessian.h @ dw.T))

        rtn = _rtn(w.float(), TPolicy(**dict(RTN_M2, group_size=qt.group_size)), qt.group_size)
        assert hessian.h.shape == (w.shape[1],) * 2 and float(hessian.n) == 4 * 8 * 32
        seen.append((layer, name, err(qt.dequantize()), err(rtn.dequantize())))
    return observe


def test_gptq_quantize_lm_observes_every_fig1_weight(quantized_lms):
    """``observe`` sees each layer's wq, wk, wv, wo, up and down once, in
    the reference's order, with its float weight, Hessian and codes; the
    model's Hessian-weighted error is below RTN's on the same Hessians."""
    seen = quantized_lms["observed"]
    names = ["mixer/attn/wq", "mixer/attn/wk", "mixer/attn/wv", "mixer/attn/wo",
             "ffn/mlp/up", "ffn/mlp/down"]
    assert [(li, n) for li, n, _, _ in seen] == [(li, n) for li in range(2) for n in names]
    assert sum(e for *_, e, _ in seen) < sum(r for *_, r in seen)
