"""The host-side contract of the paged GQA decode-attention kernel
(``csrc/decode_attn.cu``).

* The launch plan (``kernels.decode_attn.decode_attn_plan``) reads shapes
  only. At every shape ``chip_smoke.py`` drives, its blocks cover each page
  index 0..PP-1 of every (row, query head) exactly once; at the served
  shapes (4 rows, opt-125m's and OLMoE-1B-7B's KV heads, PP 10 and 16) the
  grid has at least one block for each of the card's 132 SMs.
* Split, then combine: a torch emulation of the kernel's dataflow by that
  plan (each split's softmax state (m, l, acc) over its valid tokens only;
  a split with none is never read; the combine weighs split s by
  exp(m_s - M) in split order and divides by max(l, 1e-30)) equals the
  port's plain version and repro's oracle within 1e-5, over FP8, bf16 and
  frozen pages at g = 1 and 4, with windows that empty the leading splits,
  contexts ending on a split boundary, kv_len 1 and 0, and NaN planted
  where no valid token lies (``chip_smoke._stale_nan``: stale page tails,
  the null page, the frozen dummy row). repro's oracle multiplies masked V
  rows by 0, so a planted NaN would reach its output: it is given the same
  inputs before the NaN is planted.
"""
import importlib.util
import inspect
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import page_format
from repro_torch.kernels.decode_attn import decode_attn_plan
from repro_torch.kernels.w4a8_fused import SMS
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parent.parent
_jattn = jax.jit(jref.paged_decode_attn_ref, static_argnames=("fmt", "frozen", "window"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# (B, H, KV, hd, page, PP) of every decode-attention launch chip_smoke.py drives
CHIP_SHAPES = [(4, 12, 12, 64, 64, 32), (4, 12, 12, 9, 64, 32), (4, 16, 16, 128, 64, 32),
               (4, 32, 8, 128, 64, 32)]                                # phase 3
SERVED = [(4, 12, 12, 64, 64, 10), (4, 12, 12, 64, 64, 16), (4, 16, 16, 128, 64, 16)]


def _blocks(shape, esize):
    """(b, query head, page index) of every page each block of the launch reads."""
    b_, h, kv, hd, page, pp = shape
    plan = decode_attn_plan(*shape, esize=esize)
    chunks = h // kv // plan.group
    out = []
    for s in range(plan.splits):
        for y in range(kv * chunks):
            for b in range(b_):
                hk, chunk = divmod(y, chunks)
                heads = [hk * (h // kv) + chunk * plan.group + gi for gi in range(plan.group)]
                pages = range(s * plan.pps, min((s + 1) * plan.pps, pp))
                assert len(pages) > 0
                out += [(b, hd_, j) for hd_ in heads for j in pages]
    return plan, out


@pytest.mark.parametrize("esize", [1, 2])
@pytest.mark.parametrize("shape", CHIP_SHAPES + SERVED, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_each_page_once(shape, esize):
    b, h, kv, hd, page, pp = shape
    plan, read = _blocks(shape, esize)
    assert sorted(read) == [(r, q, j) for r in range(b) for q in range(h) for j in range(pp)]
    assert plan.threads == decode_attn.THREADS and (h // kv) % plan.group == 0
    assert 2 * plan.pps * page * hd * esize <= decode_attn.STAGE_BYTES


@pytest.mark.parametrize("shape", SERVED + CHIP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_fills_the_card(shape):
    b, h, kv, hd, page, pp = shape
    plan = decode_attn_plan(*shape)
    assert b * kv * (h // kv // plan.group) * plan.splits >= SMS, plan


def test_plan_reads_shapes_only():
    """No length reaches the plan, so a captured decode step replays it."""
    assert list(inspect.signature(decode_attn_plan).parameters) == [
        "B", "H", "KV", "hd", "page", "PP", "esize"]


def split_combine(q, k, v, k_smax, k_shift, v_smax, v_shift, table, lens, fmt=None,
                  window=0, frozen=None, k_fz=None, v_fz=None, k_fz_smax=None, k_fz_shift=None,
                  v_fz_smax=None, v_fz_shift=None):
    """The kernel's dataflow in torch, by ``decode_attn_plan``: split s of
    row b holds tokens [max(s * span, lo), min((s + 1) * span, len)), span =
    pps * page; only those rows are decoded (the clamps of the plain
    version: FP8 ids at min(pid, P), frozen ids >= P + 1 at row
    min(pid - P - 1, nfz)); its (m, l, acc) per query head; the combine over
    the splits that hold a token."""
    pf = page_format(fmt)
    b, h, hd = q.shape
    p1, page, kv, _ = k.shape
    pp, g = table.shape[1], h // kv
    plan = decode_attn_plan(b, h, kv, hd, page, pp, esize=1 if pf.quantized else 2)
    span = plan.pps * page
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((b, h, hd))

    def rows(pid, u0, u1):
        if frozen is not None and pid >= p1:
            f = min(pid - p1, k_fz.shape[0] - 1)
            dec = lambda c, sh, sm: page_format(frozen).decode(c[f, u0:u1], sh[f][None, :, None],
                                                               hd) * sm[f]
            return dec(k_fz, k_fz_shift, k_fz_smax), dec(v_fz, v_fz_shift, v_fz_smax)
        a = min(pid, p1 - 1) if frozen is not None else pid
        if not pf.quantized:
            return k[a, u0:u1].float(), v[a, u0:u1].float()
        dec = lambda c, sh, sm: pf.decode(c[a, u0:u1], sh[a][None, :, None], hd) * sm[a]
        return dec(k, k_shift, k_smax), dec(v, v_shift, v_smax)

    for r in range(b):
        n = int(lens[r])
        lenc, lo = min(n, pp * page), max(0, n - window) if window else 0
        parts = []
        for s in range(plan.splits):
            t0, t1 = max(s * span, lo), min(s * span + span, lenc)
            if t0 >= t1:
                continue  # never read
            kr, vr = zip(*(rows(int(table[r, j]), max(t0 - j * page, 0),
                                min(t1 - j * page, page))
                           for j in range(t0 // page, (t1 - 1) // page + 1)))
            kr, vr = torch.cat(kr), torch.cat(vr)  # (tokens, KV, hd)
            sc = torch.einsum("kgd,tkd->kgt", q[r].float().reshape(kv, g, hd), kr) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, vr)))
        if not parts:
            continue  # 0
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        w = torch.exp(m - m.amax(0))
        o = (w[..., None] * acc).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[..., None]
        out[r] = o.reshape(h, hd)
    return out


STORES = ["fp8_e4m3", None, "frozen"]
CASES = {  # each row's length as (splits, tokens): splits * span + tokens; the
    # window as (span +) tokens, 0 for none
    "ragged": ([(3, -3), (1, 5), (0, 1), (2, 0)], 0),
    "window_empties_leading_splits": ([(3, -3), (2, 7), (1, 1), (3, -9)], ("span", 5)),
    "on_split_boundary": ([(2, 0), (1, 0), (3, 0), (1, 1)], ("span", 0)),
    "kv_len_1_and_0": ([(0, 1), (0, 0), (1, 0), (0, 0)], 0),
    "nan_outside_valid_tokens": ([(3, -3), (1, 5), (0, 1), (0, 0)], 0),
}


def _pool(rng, store, kv, hd, page, pp, lens):
    """A random 1-layer pool on the CPU, as chip_smoke builds it: FP8 (or
    bf16) pages from the port's ``quantize_pages``, a table whose entries
    past each row's pages hold the null page; "frozen": half of each row's
    full pages (at least one) in the packed FP4 region."""
    b = len(lens)
    n_pages = b * pp
    layer = {}
    for name in ("k", "v"):
        vals = torch.from_numpy(rng.normal(size=(n_pages + 1, page, kv, hd)).astype(np.float32))
        if store is None:
            layer[name] = vals.to(torch.bfloat16)
            continue
        layer[name], layer[name + "_smax"], layer[name + "_shift"] = tkvc.quantize_pages(vals)
        if store == "frozen":
            fz = torch.from_numpy(rng.normal(size=(n_pages + 1, page, kv, hd)).astype(np.float32))
            (layer[name + "_fz"], layer[name + "_fz_smax"],
             layer[name + "_fz_shift"]) = tkvc.quantize_pages(fz, "fp4_e2m1")
    table = torch.full((b, pp), n_pages, dtype=torch.int32)
    perm, fperm = rng.permutation(n_pages), rng.permutation(n_pages)
    for row, n in enumerate(lens):
        npg = tkvc.pages_needed(n, page)
        table[row, :npg] = torch.from_numpy(perm[row * pp: row * pp + npg].astype(np.int32))
        if store == "frozen":
            nfr = max(1, (n // page) // 2) if n else 0
            table[row, :nfr] = torch.from_numpy(
                n_pages + 1 + fperm[row * pp: row * pp + nfr].astype(np.int32))
    return layer, table


def to_jax(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(to_np(x.float())).astype(jnp.bfloat16)
    return jnp.asarray(to_np(x))


def _call(fn, q, layer, table, lens, store, window, arr=lambda x: x):
    fmt = None if store is None else "fp8_e4m3"
    sc = [arr(layer[n]) for n in ("k_smax", "k_shift", "v_smax", "v_shift")] if fmt else (
        [arr(torch.zeros(1)), arr(torch.zeros((1, 1), dtype=torch.int32))] * 2)
    fz = {n + s: arr(layer[n + s]) for n in ("k", "v") for s in ("_fz", "_fz_smax", "_fz_shift")
          } if store == "frozen" else {}
    kw = {"frozen": "fp4_e2m1", **fz} if fz else {}
    return fn(arr(q), arr(layer["k"]), arr(layer["v"]), *sc, arr(table), arr(lens), fmt=fmt,
              window=window, **kw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("store", STORES, ids=lambda s: s or "bf16")
def test_split_combine_matches_references(store, g, case, monkeypatch):
    """At small widths (2 KV heads of 16, pages of 8, 12 a row) with the
    block budget cut to 32, so the plan puts 3 pages in a split."""
    monkeypatch.setattr(decode_attn, "BLOCK_BUDGET", 32)
    kv, hd, page, pp = 2, 16, 8, 12
    plan = decode_attn_plan(4, kv * g, kv, hd, page, pp, esize=1 if store else 2)
    span = plan.pps * page
    assert plan.pps > 1 and plan.splits > 2
    spec, window = CASES[case]
    lens = [min(pp * page, s * span + t) for s, t in spec]
    window = span + window[1] if window else 0
    rng = np.random.default_rng(STORES.index(store) * 10 + g)
    layer, table = _pool(rng, store, kv, hd, page, pp, lens)
    q = torch.from_numpy(rng.normal(size=(4, kv * g, hd)).astype(np.float32)).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    o_jax = np.asarray(_call(_jattn, q, layer, table, kv_lens, store, window, to_jax))
    if case.startswith("nan"):
        CS._stale_nan(layer, table, lens, page, store and "fp8_e4m3", frozen=store == "frozen")
        assert any(bool(t.isnan().any()) for t in layer.values() if t.is_floating_point())
    o = _call(split_combine, q, layer, table, kv_lens, store, window)
    o_ref = _call(tref.paged_decode_attn_ref, q, layer, table, kv_lens, store, window)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(to_np(o), to_np(o_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(o), o_jax, rtol=1e-5, atol=1e-5)
    if 0 in lens:
        assert not o[lens.index(0)].any()


@pytest.mark.parametrize("store", STORES, ids=lambda s: s or "bf16")
def test_split_combine_at_phase3_shape(store):
    """opt-125m's phase 3 launch as planned (KV 12 of hd 64, 32 pages of 64,
    contexts 2048/1337/300/1: two pages a split) against the port's plain
    version."""
    lens = CS.ATTN_LENS
    rng = np.random.default_rng(7)
    layer, table = _pool(rng, store, 12, 64, 64, 32, lens)
    assert decode_attn_plan(4, 12, 12, 64, 64, 32).pps == 2
    q = torch.from_numpy(rng.normal(size=(4, 12, 64)).astype(np.float32)).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    for window in (0, 300):
        o = _call(split_combine, q, layer, table, kv_lens, store, window)
        o_ref = _call(tref.paged_decode_attn_ref, q, layer, table, kv_lens, store, window)
        np.testing.assert_allclose(to_np(o), to_np(o_ref), rtol=1e-5, atol=1e-5)
