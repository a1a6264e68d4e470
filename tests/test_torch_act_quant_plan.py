"""The host-side contract of the token-wise FP8 act-quant kernel
(``csrc/act_quant.cu``), checked on the CPU.

* The launch plan (``kernels.act_quant.act_quant_plan``) reads shapes and
  x's alignment only. It picks one block a row (of as many warps as hold
  it) for narrow rows and for opt-125m's 768, OLMoE-1B-7B's 2048 and
  MiniCPM3-4B's 6400, and a cluster of at most 8 blocks for rows too wide
  for a block or too few to fill the card. Its blocks cover each (row,
  column) exactly once, and no vector access of its lands at an address
  not aligned to its size (4 elements of x; 16 bytes of q), at every shape
  ``chip_smoke.py`` times or checks, with misaligned pointers, and at every
  cluster size the ``cluster`` override gives.
* A torch emulation of the kernel's dataflow run by that plan (each
  thread's registers and the vectors read past them, the scalar head and
  tail of a row, the warp shuffle tree, the block's warp maxima, the
  cluster's partial maxima, the IEEE division and the grid rounding) is
  bit-identical to the port's plain version ``ref.act_quant_ref`` at every
  path, with NaN, Inf, all-zero and outlier rows, and at small shapes to
  repro's ``act_quant_pallas(interpret=True)``. NaN positions must match;
  their payloads are the platform's.
* ``csrc/quant_common.cuh``'s ``round_to_grid``, written out in numpy on
  the f32 bits as the device computes it (the exponent field clamped to
  the grid's, the step and its inverse built from exponent bits, NaN and
  zero by selects), equals the port's ``common.round_to_grid`` bit for bit
  on both FP8 grids, over every f32 exponent, ties and specials.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.act_quant import act_quant_pallas
from repro_torch.core.formats import FORMATS, f32
from repro_torch.kernels import ref as tref
from repro_torch.kernels.act_quant import HELD, MAX_CLUSTER, MAX_THREADS, VEC, act_quant_plan
from repro_torch.kernels.common import round_to_grid

from test_torch_bridge import t, to_np
from test_torch_bridge import one_thread  # noqa: F401  (autouse: torch on one thread)

# (rows, d) of every act_quant launch chip_smoke.py times (phase 11's
# ACT_QUANT_SHAPES), then the widths it checks
TIMED = [(4, 768), (256, 768), (4, 2048), (256, 2048), (256, 6400), (2048, 6400), (16, 73728)]
CHECKED = [(3, 100), (301, 100), (301, 127), (256, 768), (3, 128), (8, 768), (4, 6400),
           (4, 6401), (4, 1600), (4, 10240), (4, 14336)]


def _cdiv(a, b):
    return -(-a // b)


def _row_geometry(plan, row, d):
    """The kernel's split of one row: (head h, vectors nb, tail)."""
    v = plan.vec
    h = min(d, (v - row * d % v) % v) if v > 1 else 0
    nb = (d - h) // v
    return h, nb, d - h - nb * v


def _part(plan, nb, rank):
    """(first vector, vectors) of a row's part for cluster block ``rank``."""
    pv = _cdiv(nb, plan.cluster)
    lo = min(nb, rank * pv)
    return lo, min(nb, lo + pv) - lo


def _slots(plan, n):
    """Vector slots of the part's threads: (thread, slot) -> vector j = t + i
    * threads; returns (j (G, S), valid (G, S), held (S,))."""
    g = plan.threads
    s = max(1, _cdiv(n, g))
    j = torch.arange(g)[:, None] + g * torch.arange(s)[None, :]
    return j, j < n, torch.arange(s) < plan.per_thread


# -- the plan -------------------------------------------------------------------------
@pytest.mark.parametrize("rows,d,eb,aligned,cluster", [
    (4, 768, 2, True, 1), (256, 768, 2, True, 1), (4, 2048, 2, True, 1),
    (256, 2048, 2, True, 1), (256, 6400, 2, True, 1), (2048, 6400, 2, True, 1),
    (16, 73728, 2, True, 8), (16, 73728, 4, True, 8),
    (3, 100, 2, True, 1), (5, 127, 4, True, 1), (301, 100, 2, True, 1),
    (300, 30, 2, False, 1), (4, 2048, 4, True, 1), (255, 768, 2, False, 1),
    (3, 300, 2, False, 1), (6, 1100, 4, False, 2), (7, 2101, 4, True, 1),
    (4, 6400, 2, True, 3), (4, 1600, 2, False, 3), (4, 10240, 2, True, 5),
    (4, 14336, 4, True, 7), (1, 140000, 4, True, 8),
    (256, 73728, 2, True, 5), (8192, 768, 2, True, 1), (8192, 64, 2, True, 1),
    (8192, 2048, 2, True, 1),
])
def test_plan_paths(rows, d, eb, aligned, cluster):
    """Each path where the design puts it: narrow rows and opt-125m's,
    OLMoE's and MiniCPM3's widths to a block, a row of few to a cluster of
    as many blocks as keep 512 threads' worth each (3, 5 and 7 among them),
    too wide rows to as many as hold them; a block of as many warps as hold its part; no
    thread holds more than 4 vectors, and a thread holds one where the card
    has threads to spare."""
    plan = act_quant_plan(rows, d, eb, aligned)
    assert plan.cluster == cluster
    assert plan.path == ("cluster" if cluster > 1 else "block")
    assert plan.vec == (VEC if aligned else 1)
    assert plan.per_thread in HELD
    assert 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    part = _cdiv(_cdiv(d, plan.vec), plan.cluster)
    assert plan.threads == min(MAX_THREADS, 32 * _cdiv(_cdiv(part, plan.per_thread), 32))
    assert plan.blocks == rows * plan.cluster
    if rows * d <= 2048 * 64:
        assert plan.per_thread == 1


@pytest.mark.parametrize("per_thread,cluster", [(1, 1), (2, 3), (4, 8), (None, 6), (1, None)])
def test_plan_overrides(per_thread, cluster):
    """``per_thread`` and ``cluster`` replace the plan's own choices, the
    threads a block following them; values the kernel has no instantiation
    or cluster for are refused."""
    own = act_quant_plan(16, 6400, 2, True)
    plan = act_quant_plan(16, 6400, 2, True, per_thread=per_thread, cluster=cluster)
    assert plan.per_thread == (per_thread or own.per_thread)
    assert plan.cluster == (cluster or own.cluster)
    assert plan.blocks == 16 * plan.cluster
    assert plan.threads == min(MAX_THREADS,
                               32 * _cdiv(_cdiv(_cdiv(1600, plan.cluster), plan.per_thread), 32))
    for bad in ({"per_thread": 3}, {"cluster": 9}):
        with pytest.raises(ValueError):
            act_quant_plan(16, 6400, 2, True, **bad)


@pytest.mark.parametrize("eb,offset", [(2, 0), (4, 0), (2, 8), (2, 2), (4, 4), (2, 6)])
@pytest.mark.parametrize("shape", TIMED + CHECKED + [(3, 4101), (1, 300000), (300, 9), (7, 2101), (300, 30),
                                   (8192, 768), (8192, 2052)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_each_element_once(shape, eb, offset):
    """Every (row, column) is written once, by one block, and every vector
    access is aligned to its size in x (which starts ``offset`` bytes past
    a 16-byte boundary) and to 16 bytes in q. Rows repeat their column split
    with row * d mod vec, so one row of each residue is walked element by
    element."""
    rows, d = shape
    _assert_covers(act_quant_plan(rows, d, eb, offset % (VEC * eb) == 0), rows, d, eb, offset)


@pytest.mark.parametrize("cluster", range(1, MAX_CLUSTER + 1))
@pytest.mark.parametrize("shape,eb,offset", [((3, 4101), 2, 2), ((2, 6401), 4, 0),
                                             ((2, 1601), 2, 0)])
def test_plan_covers_each_element_once_at_every_cluster_size(shape, eb, offset, cluster):
    """As above, under the ``cluster`` override: every part split, odd sizes
    included, with heads, tails and parts of unequal length."""
    rows, d = shape
    plan = act_quant_plan(rows, d, eb, offset % (VEC * eb) == 0, cluster=cluster)
    _assert_covers(plan, rows, d, eb, offset)


def _assert_covers(plan, rows, d, eb, offset):
    """Block b serves part b % cluster of row b // cluster; each element of
    every row is covered once, every vector access aligned."""
    assert plan.blocks == rows * plan.cluster
    v = plan.vec
    for row in {r * d % v: r for r in range(rows)}.values():
        h, nb, tail = _row_geometry(plan, row, d)
        hits = torch.zeros(d, dtype=torch.int64)
        hits[:h] += 1
        hits[d - tail:] += 1
        for rank in range(plan.cluster):
            lo, n = _part(plan, nb, rank)
            j, valid, _ = _slots(plan, n)
            start = (h + (lo + j[valid]) * v)
            e = (start[:, None] + torch.arange(v)[None, :]).flatten()
            hits += torch.bincount(e, minlength=d)
            if v > 1:  # every vector access aligned to its size in x, to 16 bytes in q
                addr = row * d + start
                assert bool(((offset + addr * eb) % (v * eb) == 0).all())
                assert bool((addr * 4 % 16 == 0).all())
        assert bool((hits == 1).all()), f"row {row}: elements covered {hits.unique().tolist()}"


# -- the dataflow ---------------------------------------------------------------------
def _nan_max(a, b):
    """quant_common.cuh's nan_max: a if a is NaN or a > b, else b."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _shuffle_max(mx):
    """The warp shuffle tree (xor 16, 8, 4, 2, 1) over each warp of ``mx``."""
    lane = torch.arange(len(mx))
    for o in (16, 8, 4, 2, 1):
        mx = _nan_max(mx[(lane & ~31) | ((lane & 31) ^ o)], mx)
    return mx


def _emulate(x, plan, fmt_name):
    """The kernel run by ``plan`` on (rows, d) x, in torch: returns (q,
    scale) and the count of writes of each element."""
    fmt = FORMATS[fmt_name]
    inv_max = f32(1.0 / fmt.max_value)
    rows, d = x.shape
    v, g, cl = plan.vec, plan.threads, plan.cluster
    xf = x.float()
    q = torch.full((rows, d), float("nan"))
    writes = torch.zeros((rows, d), dtype=torch.int64)
    scale = torch.full((rows, 1), float("nan"))
    zero = torch.zeros(())
    for row in range(rows):
        h, nb, tail = _row_geometry(plan, row, d)
        xr = xf[row]
        parts, block_max = [], []
        for rank in range(cl):
            lo, n = _part(plan, nb, rank)
            j, valid, held = _slots(plan, n)
            e = h + (lo + j[..., None]) * v + torch.arange(v)  # (G, S, V)
            vals = torch.where(valid[..., None], xr[e.clamp(max=d - 1)], zero)
            tid = torch.arange(g)
            hv = torch.where((rank == 0) & (tid < h), xr[tid.clamp(max=d - 1)], zero)
            tv = torch.where((rank == cl - 1) & (tid < tail),
                             xr[(h + nb * v + tid).clamp(max=d - 1)], zero)
            # each thread: head and tail, its registers' vectors, then the ones past them
            mx = _nan_max(hv.abs(), tv.abs())
            order = [i for i in range(j.shape[1]) if held[i]] + \
                    [i for i in range(j.shape[1]) if not held[i]]
            for i in order:  # each vector's |x| as a tree, into the thread's max
                m = list(vals[:, i].abs().unbind(-1))
                s = 1
                while s < v:
                    for k in range(0, v - s, 2 * s):
                        m[k] = _nan_max(m[k + s], m[k])
                    s *= 2
                mx = torch.where(valid[:, i], _nan_max(m[0], mx), mx)
            mx = _shuffle_max(mx)  # each warp's
            red = mx[::32]  # the warp maxima through shared memory, folded by a warp
            mx = _shuffle_max(torch.cat([red, zero.expand(32 - len(red))]))
            mx = mx[0]
            block_max.append(mx)
            parts.append((e[valid].flatten(), vals[valid].flatten(), hv[:h], tv[:tail]))
        if cl > 1:  # each block folds the cluster's partial maxima, rank 0 to MAX_CLUSTER
            folded = []
            for own in block_max:
                m = own
                for c in range(MAX_CLUSTER):
                    m = _nan_max(block_max[c] if c < cl else zero, m)
                folded.append(m)
            assert all(bool(torch.equal(m.view(torch.int32), folded[0].view(torch.int32)))
                       for m in folded)
            mx = folded[0]
        else:
            mx = block_max[0]
        sc = _nan_max(mx * inv_max, f32(1e-12))
        scale[row, 0] = sc
        for idx, held_vals, _, _ in parts:  # each part from its registers (and reads past them)
            q[row, idx] = round_to_grid(held_vals / sc, fmt)
            writes[row] += torch.bincount(idx, minlength=d)
        head, tl = parts[0][2], parts[-1][3]  # the first part's head, the last part's tail
        q[row, :h] = round_to_grid(head / sc, fmt)
        q[row, d - tail:] = round_to_grid(tl / sc, fmt)
        writes[row, :h] += 1
        writes[row, d - tail:] += 1
    return q, scale, writes


def _special_rows(rng, rows, d, dtype):
    """rows x d of N(0, 13^2), with a NaN row, an Inf row, an all-zero row and an
    outlier row (one element 100, the rest 0.01) where there is room."""
    x = rng.normal(size=(rows, d)).astype(np.float32) * 13.0
    special = [("nan", float("nan")), ("inf", float("inf")), ("zero", 0.0), ("outlier", 100.0)]
    for r, (kind, val) in zip(range(rows), special):
        if kind == "zero":
            x[r] = 0.0
        elif kind == "outlier":
            x[r] = 0.01
            x[r, -1] = val
        else:
            x[r, rng.integers(d)] = val
    out = torch.from_numpy(x)
    return out.to(torch.bfloat16) if dtype == "bf16" else out


def _same(a, b):
    """Bit-identical where not NaN; NaN at the same places."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    na, nb_ = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb_)
    np.testing.assert_array_equal(np.where(na, 0, a).view(np.int32),
                                  np.where(nb_, 0, b).view(np.int32))


# (rows, d, dtype, aligned, path): every path, with vectors, scalar heads and
# tails, one-element accesses (a misaligned x) and a row read past the registers
EMULATED = [(6, 100, "bf16", True, "block"), (6, 127, "f32", True, "block"),
            (6, 30, "bf16", False, "block"), (300, 2101, "f32", True, "block"),
            (4, 6401, "bf16", True, "cluster"), (4, 1600, "bf16", False, "cluster"),
            (4, 300, "bf16", False, "block"), (4, 4101, "f32", True, "cluster"),
            (6, 1100, "f32", False, "cluster"), (16, 73728, "bf16", True, "cluster"),
            (1, 300000, "f32", True, "cluster")]


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("rows,d,dtype,aligned,path", EMULATED,
                         ids=lambda a: str(a) if not isinstance(a, bool) else
                         ("aligned" if a else "misaligned"))
def test_emulation_bit_identical_to_plain(rows, d, dtype, aligned, path, fmt):
    rng = np.random.default_rng(rows * d + len(fmt))
    x = _special_rows(rng, rows, d, dtype)
    plan = act_quant_plan(rows, d, x.element_size(), aligned)
    assert plan.path == path
    q, s, writes = _emulate(x, plan, fmt)
    assert bool((writes == 1).all())
    qr, sr = tref.act_quant_ref(x, fmt)
    _same(q, qr)
    _same(s, sr)
    if fmt == "fp8_e4m3" and rows >= 4:
        assert float(q[3, -1]) == 480.0 and not bool(q[2].any())  # outlier, zero row
        assert bool(torch.isnan(q[0]).all()) and bool(torch.isnan(s[0]))  # NaN row


@functools.lru_cache(maxsize=None)
def _pallas(shape, dtype, fmt):
    rng = np.random.default_rng(sum(shape))
    x = _special_rows(rng, *shape, dtype)
    xj = jnp.asarray(to_np(x))
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
    q, s = act_quant_pallas(xj, fmt, interpret=True)
    return x, np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("shape,dtype,aligned,path", [
    ((6, 100), "bf16", True, "block"), ((4, 300), "f32", False, "block"),
    ((6, 1100), "f32", False, "cluster"), ((2, 1000), "f32", True, "block")])
def test_emulation_bit_identical_to_pallas(shape, dtype, aligned, path):
    x, qk, sk = _pallas(shape, dtype, "fp8_e4m3")
    plan = act_quant_plan(*shape, x.element_size(), aligned)
    assert plan.path == path
    q, s, _ = _emulate(t(to_np(x)).to(x.dtype), plan, "fp8_e4m3")
    _same(qk, to_np(q))
    _same(sk, to_np(s))


# -- the grid rounding as the device computes it ----------------------------------------
def _round_to_grid_device(v, fmt):
    """quant_common.cuh's round_to_grid on f32 ``v`` (numpy), step by step."""
    a = np.abs(v)
    e = np.clip((a.view(np.int32) >> 23) - 127, fmt.min_exp, fmt.max_exp)
    inv_step = ((127 + fmt.man_bits - e) << 23).astype(np.int32).view(np.float32)
    step = ((127 - fmt.man_bits + e) << 23).astype(np.int32).view(np.float32)
    top = np.float32(fmt.max_value)
    with np.errstate(invalid="ignore", over="ignore"):
        q = np.minimum(np.maximum(np.rint(v * inv_step) * step, -top), top)
    return np.where(np.isnan(v), v, np.where(a == 0, np.float32(0), q)).astype(np.float32)


@pytest.mark.parametrize("fmt_name", ["fp8_e4m3", "fp8_e5m2"])
def test_device_round_to_grid_matches_plain(fmt_name):
    fmt = FORMATS[fmt_name]
    rng = np.random.default_rng(len(fmt_name))
    # every exponent field with 256 mantissas each (both signs), the grid's
    # ties and their neighbours, wide random values, and the specials
    exps = np.arange(256, dtype=np.int64)[:, None] << 23
    mants = np.concatenate([np.arange(128), rng.integers(0, 1 << 23, 128)])[None, :]
    bits = (exps | mants).reshape(-1)
    v = np.concatenate([bits, bits | (1 << 31)]).astype(np.uint32).view(np.float32)
    grid_e = np.arange(fmt.min_exp, fmt.max_exp + 1)
    steps = (2.0 ** (grid_e - fmt.man_bits)).astype(np.float32)
    k = np.arange(2 ** (fmt.man_bits + 1) + 2)
    ties = ((k[None, :] + 0.5) * steps[:, None]).astype(np.float32).reshape(-1)
    near = np.concatenate([ties, np.nextafter(ties, np.float32(0)),
                           np.nextafter(ties, np.float32(np.inf))])
    wide = (rng.standard_normal(20000) * np.exp(rng.uniform(-40, 40, 20000))).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-38, -1e-45, 3.4e38],
                       dtype=np.float32)
    v = np.concatenate([v, near, -near, wide, special]).astype(np.float32)
    want = to_np(round_to_grid(torch.from_numpy(v), fmt))
    _same(_round_to_grid_device(v, fmt), want)


def test_grid_args_takes_only_grids_with_normal_steps():
    """The wrappers hand ``round_to_grid`` only grids whose steps 2^(e -
    man_bits) and their inverses are f32 normals over [min_exp, max_exp], as
    it builds them from exponent bits: both FP8 grids pass, bf16's grid is
    refused before any launch."""
    from repro_torch.kernels.w4a8_fused import grid_args

    for name in ("fp8_e4m3", "fp8_e5m2"):
        fmt = FORMATS[name]
        assert grid_args(name)[:4] == (fmt.man_bits, fmt.min_exp, fmt.max_exp, fmt.max_value)
    with pytest.raises(NotImplementedError, match="f32 normals"):
        grid_args("bf16")
