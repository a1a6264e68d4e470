"""The host-side contract of the paged MLA latent decode kernel
(``csrc/mla_decode_attn.cu``).

* The launch plan (``kernels.decode_attn.mla_decode_plan``) reads shapes
  only. At every shape ``chip_smoke.py`` drives, its blocks cover each
  token 0..PP*page-1 of every (row, query head) exactly once, 64 tokens a
  split whatever the page size; at phase 3's ``MLA_SHAPE`` (B 4, H 40, PP
  32) and the served MiniCPM3-4B shapes (4 slots, PP 16: max_seq 1024 of
  pages of 64) the grid has at least one block for each of the card's 132
  SMs, in one wave (three blocks an SM, csrc/mla_decode_attn.cu).
* Split, then combine: a torch emulation of the kernel's dataflow at its
  rounding points, by that plan (each split's operands the codes' exact
  bf16 grid values, or bf16 pages as they are; scores as f32 sums of exact
  products, then ``(s_ckv * post_c + s_krope * post_r) * scale`` with post
  = 2^-shift s_max of the token's page; the split's max, p = exp(s - m)
  and l in f32; p * post_c in three bf16 pieces against the ckv operands; a
  split with no valid token is never read; the combine weighs split s by
  exp(m_s - M) in split order and divides by max(l, 1e-30)) equals the
  port's plain version and repro's oracle within 1e-5, over FP8, bf16 and
  frozen pages, at pages of 8 (8 a split), 24 (splits across page edges)
  and 128 (half a page a split), with contexts ending on a split boundary,
  kv_len 1 and 0, and NaN planted where no valid token lies (``chip_smoke._stale_nan``:
  stale page tails, the null page, the frozen dummy row). repro's oracle
  multiplies masked rows by 0, so a planted NaN would reach its output: it
  is given the same inputs before the NaN is planted.
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
from repro_torch.core.formats import pow2i
from repro_torch.kernels import decode_attn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import decode_fp8, page_format
from repro_torch.kernels.decode_attn import mla_decode_plan
from repro_torch.kernels.w4a8_fused import SMS
from repro_torch.runtime import kv_cache as tkvc

from test_torch_bridge import to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parent.parent
_jmla = jax.jit(jref.paged_mla_decode_attn_ref, static_argnames=("fmt", "frozen", "scale"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
_M = CS.MLA_SHAPE
# (B, H, r, dr, page, PP) of every latent decode launch chip_smoke.py drives
CHIP_SHAPES = [(_M["b"], _M["h"], _M["r"], _M["dr"], _M["page"], 32), (2, 3, 16, 8, 4, 4),
               (2, 3, 9, 5, 4, 4), (4, 40, 256, 32, 64, 3)]  # phase 3, its edge checks
CHIP_SHAPES += [(4, 40, 256, 32, pg, -(-701 // pg)) for pg in CS.MLA_PAGES]
PER_SM = 3  # split blocks an SM holds (csrc/mla_decode_attn.cu: 72 KB a block over FP8 pages)
SERVED = [(4, 40, 256, 32, 64, 16), (2, 40, 256, 32, 64, 16)]  # phases 7 and 8


@pytest.mark.parametrize("esize", [1, 2])
@pytest.mark.parametrize("shape", CHIP_SHAPES + SERVED, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_each_page_once(shape, esize):
    """Every token of every page goes to one split, and every query head to
    one group: the grid (splits, groups, rows) covers each (row, head,
    token) once, and no block is empty."""
    b, h, r, dr, page, pp = shape
    plan = mla_decode_plan(*shape, esize=esize)
    tokens = [range(s * plan.span, min((s + 1) * plan.span, pp * page))
              for s in range(plan.splits)]
    heads = [range(y * plan.group, min(h, (y + 1) * plan.group)) for y in range(-(-h // plan.group))]
    assert all(len(t) > 0 for t in tokens) and all(len(g) > 0 for g in heads)
    assert [t for r_ in tokens for t in r_] == list(range(pp * page))
    assert [q for g in heads for q in g] == list(range(h))
    assert plan.threads == decode_attn.THREADS and plan.group == decode_attn.MLA_GROUP
    assert plan.span == decode_attn.MLA_SPAN == 64


@pytest.mark.parametrize("esize", [1, 2])
@pytest.mark.parametrize("shape", [CHIP_SHAPES[0], SERVED[0]], ids=lambda s: "x".join(map(str, s)))
def test_plan_fills_the_card_in_one_wave(shape, esize):
    b, h, r, dr, page, pp = shape
    plan = mla_decode_plan(*shape, esize=esize)
    blocks = b * -(-h // plan.group) * plan.splits
    assert SMS <= blocks <= SMS * PER_SM, (plan, blocks)


def test_plan_reads_shapes_only():
    """No length reaches the plan, so a captured decode step replays it."""
    assert list(inspect.signature(mla_decode_plan).parameters) == [
        "B", "H", "r", "dr", "page", "PP", "esize"]


def _pieces(x):
    """x (f32) as three bf16 pieces hi + mid + lo, each the rounding of what
    the earlier ones leave."""
    out = []
    for _ in range(3):
        piece = x.to(torch.bfloat16).float()
        out.append(piece)
        x = x - piece
    return out


def _operands(fmt, codes, shift, smax, d):
    """A page's rows as the kernel's bf16 operands and its factor after the
    product: FP8/FP4 codes at their grid value (exact in bf16) with post =
    2^-shift s_max, or, where that would clamp or leave the normal range,
    decode_fp8 at the shift with post = s_max; bf16 rows as they are."""
    if not fmt.quantized:
        return codes.float(), torch.tensor(1.0)
    grid = fmt.fmt
    sh = int(shift)
    post = pow2i(torch.tensor(-sh)) * smax
    fast = (1 - grid.bias - sh >= -126 and 2 ** grid.exp_bits - 1 - grid.bias - sh <= 127
            and -126 <= -sh <= 127 and (post == 0 or 1.17549435e-38 <= abs(post) <= 3.4e38))
    vals = fmt.decode(codes, 0 if fast else sh, d)
    assert torch.equal(vals.to(torch.bfloat16).float(), vals)  # exact in bf16
    return vals, post if fast else smax


def split_combine(q_lat, q_rope, ckv, krope, ckv_smax, ckv_shift, krope_smax, krope_shift,
                  table, lens, scale, fmt=None, frozen=None, ckv_fz=None, krope_fz=None,
                  ckv_fz_smax=None, ckv_fz_shift=None, krope_fz_smax=None, krope_fz_shift=None):
    """The kernel's dataflow in torch, by ``mla_decode_plan``: split s of
    row b holds its tokens [s * span, min((s + 1) * span, len)), whichever
    pages hold them; only those rows become operands (the clamps of the plain version:
    FP8 ids at min(pid, P), frozen ids >= P + 1 at row min(pid - P - 1,
    nfz)); its (m, l, acc) per query head; the combine over the splits that
    hold a token."""
    pf = page_format(fmt)
    fz = page_format(frozen) if frozen is not None else None
    b, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    p1, page = ckv.shape[:2]
    pp = table.shape[1]
    plan = mla_decode_plan(b, h, r, dr, page, pp, esize=1 if pf.quantized else 2)
    span = plan.span
    out = torch.zeros((b, h, r))

    def page_ops(pid, rows):
        if fz is not None and pid >= p1:
            f = min(pid - p1, ckv_fz.shape[0] - 1)
            return [_operands(fz, c[f, rows], sh[f, 0], sm[f], d) for c, sh, sm, d in
                    ((ckv_fz, ckv_fz_shift, ckv_fz_smax, r), (krope_fz, krope_fz_shift,
                                                              krope_fz_smax, dr))]
        a = min(pid, p1 - 1) if fz is not None else pid
        if not pf.quantized:
            return [_operands(pf, ckv[a, rows], None, None, r),
                    _operands(pf, krope[a, rows], None, None, dr)]
        return [_operands(pf, c[a, rows], sh[a, 0], sm[a], d) for c, sh, sm, d in
                ((ckv, ckv_shift, ckv_smax, r), (krope, krope_shift, krope_smax, dr))]

    for row in range(b):
        lenc = min(int(lens[row]), pp * page)
        parts = []
        for s in range(plan.splits):
            n = min(span, lenc - s * span)
            if n <= 0:
                continue  # never read
            oc, orr, pc, pr = [], [], [], []
            t = s * span
            while t < s * span + n:  # the split's tokens, a page's run at a time
                j, u = divmod(t, page)
                k = min(page - u, s * span + n - t)
                (c, post_c), (rr, post_r) = page_ops(int(table[row, j]), slice(u, u + k))
                oc.append(c)
                orr.append(rr)
                pc.append(post_c.expand(k))
                pr.append(post_r.expand(k))
                t += k
            oc, orr, pc, pr = (torch.cat(x) for x in (oc, orr, pc, pr))
            s_c = torch.einsum("hr,tr->ht", q_lat[row].float(), oc)
            s_r = torch.einsum("hd,td->ht", q_rope[row].float(), orr)
            sc = (s_c * pc + s_r * pr) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            acc = sum(torch.einsum("ht,tr->hr", piece, oc) for piece in _pieces(p * pc))
            parts.append((m, p.sum(-1), acc))
        if not parts:
            continue  # 0
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        w = torch.exp(m - m.amax(0))
        out[row] = (w[..., None] * acc).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[:, None]
    return out


STORES = ["fp8_e4m3", None, "frozen"]
CASES = {  # each row's length as (splits, tokens): splits * span + tokens
    "ragged": [(2, -3), (1, 5), (0, 1), (2, 0)],
    "on_split_boundary": [(2, 0), (1, 0), (3, 0), (1, 1)],
    "kv_len_1_and_0": [(0, 1), (0, 0), (1, 0), (0, 0)],
    "nan_outside_valid_tokens": [(2, -3), (1, 5), (0, 1), (0, 0)],
}


def _pool(rng, store, r, dr, page, pp, lens):
    """A random 1-layer latent pool on the CPU, as chip_smoke builds it: FP8
    (or bf16) pages from the port's ``quantize_pages``, a table whose entries
    past each row's pages hold the null page; "frozen": half of each row's
    full pages (at least one) in the packed FP4 region."""
    b = len(lens)
    n_pages = b * pp
    layer = {}
    for name, d in (("ckv", r), ("krope", dr)):
        vals = torch.from_numpy(rng.normal(size=(n_pages + 1, page, 1, d)).astype(np.float32))
        if store is None:
            layer[name] = vals[:, :, 0].to(torch.bfloat16)
            continue
        codes, layer[name + "_smax"], layer[name + "_shift"] = tkvc.quantize_pages(vals)
        layer[name] = codes[:, :, 0].contiguous()
        if store == "frozen":
            fzv = torch.from_numpy(rng.normal(size=(n_pages + 1, page, 1, d)).astype(np.float32))
            codes, layer[name + "_fz_smax"], layer[name + "_fz_shift"] = tkvc.quantize_pages(
                fzv, "fp4_e2m1")
            layer[name + "_fz"] = codes[:, :, 0].contiguous()
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


def _call(fn, q_lat, q_rope, layer, table, lens, store, scale, arr=lambda x: x):
    fmt = None if store is None else "fp8_e4m3"
    names = ("ckv_smax", "ckv_shift", "krope_smax", "krope_shift")
    sc = [arr(layer[n]) for n in names] if fmt else (
        [arr(torch.zeros(1)), arr(torch.zeros((1, 1), dtype=torch.int32))] * 2)
    fz = {n + s: arr(layer[n + s]) for n in ("ckv", "krope")
          for s in ("_fz", "_fz_smax", "_fz_shift")} if store == "frozen" else {}
    kw = {"frozen": "fp4_e2m1", **fz} if fz else {}
    return fn(arr(q_lat), arr(q_rope), arr(layer["ckv"]), arr(layer["krope"]), *sc, arr(table),
              arr(lens), scale=scale, fmt=fmt, **kw)


@pytest.mark.parametrize("page,pp", [(8, 24), (24, 8), (128, 2)], ids=lambda x: str(x))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("store", STORES, ids=lambda s: s or "bf16")
def test_split_combine_matches_references(store, case, page, pp):
    """At small widths (20 heads: groups of 16 and 4; r 32, dr 16) and 192
    or 256 tokens a row: pages of 8 (8 a split), of 24 (splits across page
    edges) and of 128 (half a page a split)."""
    h, r, dr = 20, 32, 16
    plan = mla_decode_plan(4, h, r, dr, page, pp, esize=1 if store else 2)
    span = plan.span
    assert plan.splits > 2
    lens = [min(pp * page, s * span + t) for s, t in CASES[case]]
    rng = np.random.default_rng(STORES.index(store) * 10 + len(case) + page)
    layer, table = _pool(rng, store, r, dr, page, pp, lens)
    q_lat = torch.from_numpy(rng.normal(size=(4, h, r)).astype(np.float32)).to(torch.bfloat16)
    q_rope = torch.from_numpy(rng.normal(size=(4, h, dr)).astype(np.float32)).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    scale = 1.0 / math.sqrt(24.0)
    o_jax = np.asarray(_call(_jmla, q_lat, q_rope, layer, table, kv_lens, store, scale, to_jax))
    if case.startswith("nan"):
        CS._stale_nan(layer, table, lens, page, store and "fp8_e4m3", frozen=store == "frozen",
                      names=("ckv", "krope"))
        assert any(bool(t.isnan().any()) for t in layer.values() if t.is_floating_point())
    o = _call(split_combine, q_lat, q_rope, layer, table, kv_lens, store, scale)
    o_ref = _call(tref.paged_mla_decode_attn_ref, q_lat, q_rope, layer, table, kv_lens, store,
                  scale)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(to_np(o), to_np(o_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(o), o_jax, rtol=1e-5, atol=1e-5)
    if 0 in lens:
        assert not o[lens.index(0)].any()


@pytest.mark.parametrize("store", STORES, ids=lambda s: s or "bf16")
def test_split_combine_at_phase3_shape(store):
    """Phase 3's launch as planned (B 4, H 40, r 256, dr 32, 32 pages of 64,
    contexts 2048/1337/300/1: one page a split) against the port's plain
    version."""
    lens = _M["lens"]
    rng = np.random.default_rng(7)
    layer, table = _pool(rng, store, 256, 32, 64, 32, lens)
    assert mla_decode_plan(4, 40, 256, 32, 64, 32)[:2] == (64, 32)
    q_lat = torch.from_numpy(rng.normal(size=(4, 40, 256)).astype(np.float32)).to(torch.bfloat16)
    q_rope = torch.from_numpy(rng.normal(size=(4, 40, 32)).astype(np.float32)).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    o = _call(split_combine, q_lat, q_rope, layer, table, kv_lens, store, 1.0 / math.sqrt(96))
    o_ref = _call(tref.paged_mla_decode_attn_ref, q_lat, q_rope, layer, table, kv_lens, store,
                  1.0 / math.sqrt(96))
    np.testing.assert_allclose(to_np(o), to_np(o_ref), rtol=1e-5, atol=1e-5)
