"""Guards of the port's boundaries: it and the ``examples/torch_*.py``
twins import neither jax, nor the JAX package, nor ml_dtypes, nor
``benchmarks``, and its entry points never fall back to the CPU on their
own."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.opt_125m import SMOKE
from repro_torch.models import api
from repro_torch.runtime import serve

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes", "benchmarks"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(twins) == 5
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + twins + [
        ROOT / "chip_smoke.py", ROOT / "kernel_compare.py", ROOT / "attn_ablate.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = api.init_params(SMOKE, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(params, SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(SMOKE, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(params, SMOKE, device="cuda")


def test_contiguous_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    """``api.init_cache`` and the example twins take the card unless asked
    for the CPU."""
    import sys

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_cache(SMOKE, 1, 8, device=device)
    assert api.init_cache(SMOKE, 1, 8, device="cpu")[0]["kv"]["k"].device.type == "cpu"
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_sse_stream_demo
    finally:
        sys.path.remove(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_sse_stream_demo.main(["--max-new", "1"])


def test_training_entry_points_refuse_to_fall_back_without_cuda(monkeypatch, tmp_path):
    """``train_loop`` (and the ``init_params`` it calls) take the card unless
    asked for the CPU; asked, they train there."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optimizer import AdamWConfig
    from repro_torch.runtime.train import TrainLoopConfig, train_loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dc = DataConfig(vocab_size=SMOKE.vocab_size, seq_len=8, global_batch=2)
    loop = TrainLoopConfig(steps=1, ckpt_dir=str(tmp_path), ckpt_every=1)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_loop(SMOKE, dc, AdamWConfig(), loop, device=device)
    assert not list(tmp_path.iterdir())
    state, hist = train_loop(SMOKE, dc, AdamWConfig(), loop, device="cpu")
    assert [h["step"] for h in hist] == [0] and next(iter(state.params.values())).device.type == "cpu"


@pytest.mark.parametrize("field,value,item", [("temperature", 0.7, "item 9")])
def test_unported_serving_options_raise(field, value, item):
    """Serving options the port once refused, by their ROADMAP item. Sampled
    decoding (item 9) is ported: ``temperature > 0`` validates, and the
    bounds checks still raise. Multi-token prediction (item 12) is ported
    too: DeepSeek-V3 serves (``test_no_module_refuses_a_ported_config``)."""
    assert serve.SamplingParams(**{field: value}).validate().temperature == value
    for bad, match in ((dict(temperature=-value), "temperature"),
                       (dict(temperature=value, top_p=0.0), "top_p"),
                       (dict(temperature=value, top_k=-1), "top_k")):
        with pytest.raises(ValueError, match=match):
            serve.SamplingParams(**bad).validate()


@pytest.mark.parametrize("name", ["opt-125m", "olmo-1b", "minitron-8b", "nemotron-4-340b",
                                  "llava-next-34b", "whisper-tiny", "minicpm3-4b",
                                  "olmoe-1b-7b", "xlstm-125m", "zamba2-1.2b",
                                  "deepseek-v3-671b"])
def test_no_module_refuses_a_ported_config(name):
    """Every config the port carries (dense, VLM, enc-dec, MLA, MoE, the
    recurrent xLSTM and Zamba2 hybrid over state slabs, and DeepSeek-V3 with
    its MTP block) builds, serves a request and runs the cache-free forward
    (MLA's materialized form, MoE's grouped dispatch); no refusal names
    item 12 or item 13 for them."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke(name)
    params = api.init_params(cfg, seed=0, device="cpu")
    srv = serve.Server(params, cfg, serve.ServerConfig(slots=1, max_seq=64, page_size=8),
                       device="cpu")
    frames = (np.zeros((cfg.encoder_seq, cfg.d_model), np.float32) if cfg.encoder_layers
              else None)
    srv.submit(serve.Request(rid=0, prompt=[1, 2, 3], max_new=2, frames=frames))
    assert [r.status for r in srv.run_until_drained()] == ["ok"]
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)[None]
    hidden, _, aux = api.forward_hidden(params, cfg, batch)
    assert hidden.shape == (1, 4, cfg.d_model) and bool(torch.isfinite(hidden.float()).all())
    assert (float(aux) > 0) == (cfg.moe is not None)


def test_refusals_name_item_12_only_for_the_recurrent_families_and_mtp():
    """Item 12's families are all ported, DeepSeek-V3's multi-token
    prediction last: no line of the port names ROADMAP queue 1, item 12."""
    src = ROOT / "src" / "repro_torch"
    named = [f"{p.relative_to(src)}:{i + 1}" for p in sorted(src.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines()) if "item 12" in line]
    assert named == []


def test_no_refusal_names_sampling_or_frontend():
    """Sampled decoding and the front-end are ported: no module of the port
    names ROADMAP queue 1, item 9 or item 10."""
    src = ROOT / "src" / "repro_torch"
    named = [str(p.relative_to(src)) for p in sorted(src.rglob("*.py"))
             if re.search(r"item\s+(9|10)\b", p.read_text())]
    assert named == []


def test_no_refusal_names_gptq():
    """GPTQ and the pieces it runs on (ROADMAP queue 1, item 11) are ported:
    no module of the port says GPTQ is not ported or names item 11."""
    src = ROOT / "src" / "repro_torch"
    named = [str(p.relative_to(src)) for p in sorted(src.rglob("*.py"))
             if re.search(r"item\s+11\b|GPTQ[^\n.]*not ported", p.read_text())]
    assert named == []


def _batched_operands(e=4, n=64, k=256, m=3):
    codes = torch.zeros((e, n, k // 2), dtype=torch.uint8)
    scale = torch.ones((e, n, k // 256))
    return torch.zeros((e, m, k), dtype=torch.bfloat16), codes, scale


@pytest.mark.parametrize("kw,err", [
    ({}, ValueError),                                  # CPU tensors: the plain version's
    ({"a_fmt": "fp8_e4m3", "transpose_w": True},       # FP8 activations, transposed: no
     NotImplementedError),                             # served path runs them
    ({"w_fmt": "fp4_e3m0"}, ValueError),               # CPU tensors, E3M0 weights (built)
    ({"a_fmt": "fp8_e4m3"}, ValueError),               # CPU tensors, FP8 activations (row 1d)
])
def test_batched_w4a8_wrapper_refuses(kw, err):
    from repro_torch.kernels.w4a8_fused import w4a8_fused_batched_cuda

    x, codes, scale = _batched_operands()
    with pytest.raises(err):
        w4a8_fused_batched_cuda(x, codes, scale, group_size=256, **kw)
    assert w4a8_fused_batched_cuda.launches == w4a8_fused_batched_cuda.transposed_launches == 0
    assert w4a8_fused_batched_cuda.quant_launches == 0


def _mla_operands(fmt):
    b, h, r, dr, page, p1 = 2, 3, 16, 8, 4, 5
    store = torch.uint8 if fmt else torch.bfloat16
    return (torch.zeros((b, h, r), dtype=torch.bfloat16),
            torch.zeros((b, h, dr), dtype=torch.bfloat16),
            torch.zeros((p1, page, r), dtype=store), torch.zeros((p1, page, dr), dtype=store),
            torch.ones(p1), torch.zeros((p1, 1), dtype=torch.int32), torch.ones(p1),
            torch.zeros((p1, 1), dtype=torch.int32), torch.zeros((b, 2), dtype=torch.int32),
            torch.ones(b, dtype=torch.int32), 0.2)


@pytest.mark.parametrize("fmt,kw,err", [
    ("fp8_e4m3", {}, ValueError),                             # CPU tensors
    (None, {}, ValueError),
    ("fp8_e4m3", {"frozen": "fp4_e2m1"}, ValueError),         # frozen without its operands
    ("fp8_e4m3", {"ckv_fz": torch.zeros(1)}, ValueError),     # operands without frozen=
    (None, {"frozen": "fp4_e2m1"}, NotImplementedError),      # a frozen region behind bf16
    ("fp4_e2m1", {}, NotImplementedError),                    # packed active pages
])
def test_mla_decode_wrapper_refuses(fmt, kw, err):
    from repro_torch.kernels.decode_attn import paged_mla_decode_attn_cuda

    with pytest.raises(err):
        paged_mla_decode_attn_cuda(*_mla_operands(fmt), fmt=fmt, **kw)
    assert paged_mla_decode_attn_cuda.launches == paged_mla_decode_attn_cuda.frozen_launches == 0


def test_mla_smoke_config_serves_on_the_cpu_only_when_asked(monkeypatch):
    """MiniCPM3's smoke config builds a latent pool; without a GPU the
    entry points still refuse to fall back."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke("minicpm3-4b")
    params = api.init_params(cfg, seed=0, device="cpu")
    srv = serve.Server(params, cfg, serve.ServerConfig(slots=1, max_seq=64, page_size=8),
                       device="cpu")
    assert set(srv.pools[0]) >= {"ckv", "krope"} and "k" not in srv.pools[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(params, cfg)


def test_pools_default_to_the_card(monkeypatch):
    """``init_gqa_pool`` / ``init_mla_pool`` without ``device`` take the
    card and raise without one, naming the CPU opt-in."""
    from repro_torch.runtime import kv_cache as kvc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kvc.init_gqa_pool(1, 4, 8, 2, 16, "fp8_e4m3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kvc.init_mla_pool(1, 4, 8, 16, 8, "fp8_e4m3")
    pool = kvc.init_mla_pool(1, 4, 8, 16, 8, "fp8_e4m3", device="cpu")
    assert pool["ckv"].device.type == "cpu"


def _api_wrappers():
    from repro_torch.kernels.act_quant import act_quant_cuda
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.kernels.w4a8_matmul import w4a8_matmul_cuda

    return act_quant_cuda, w4a8_matmul_cuda, flash_attention_cuda


@pytest.mark.parametrize("call,err,match", [
    (lambda aq, mm, fa: aq(torch.zeros((2, 64))), ValueError, "CUDA"),
    (lambda aq, mm, fa: aq(torch.zeros((2, 64)), "int8"), NotImplementedError, "fp8_e4m3"),
    (lambda aq, mm, fa: mm(torch.zeros((2, 256), dtype=torch.bfloat16),
                           torch.zeros((8, 128), dtype=torch.uint8), torch.ones((8, 1))),
     ValueError, "CUDA"),
    (lambda aq, mm, fa: mm(torch.zeros((2, 256), dtype=torch.bfloat16),
                           torch.zeros((8, 128), dtype=torch.uint8), torch.ones((8, 1)),
                           w_fmt="int4"), NotImplementedError, "fp4_e3m0"),
    (lambda aq, mm, fa: fa(*[torch.zeros((1, 8, 2, 16))] * 3), ValueError, "CUDA"),
    (lambda aq, mm, fa: fa(*[torch.zeros((1, 8, 2, 16), dtype=torch.float16)] * 3),
     NotImplementedError, "bf16 and f32"),
    (lambda aq, mm, fa: fa(torch.zeros((1, 8, 2, 160)), torch.zeros((1, 8, 2, 160)),
                           torch.zeros((1, 8, 2, 16))), NotImplementedError, "head widths"),
    (lambda aq, mm, fa: fa(torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 8)),
                           torch.zeros((1, 8, 2, 16))), ValueError, "shapes"),
])
def test_kernel_api_wrappers_refuse(call, err, match):
    """The three CUDA wrappers of the kernel API refuse CPU tensors (the
    plain versions take them, through ``ops``) and the variants they do not
    build, before any launch."""
    wrappers = _api_wrappers()
    with pytest.raises(err, match=match):
        call(*wrappers)
    assert all(fn.launches == 0 for fn in wrappers)



def test_build_lists_six_sources_and_digests_the_shared_header(tmp_path, monkeypatch):
    """Every ``csrc/*.cu`` is a source of the build, and a library's name
    moves with the shared header it includes, so an edited header rebuilds
    the kernels that include it."""
    from repro_torch.kernels import build

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    assert build.SOURCES == ("w4a8_fused", "decode_attn", "mla_decode_attn", "act_quant",
                             "w4a8_matmul", "flash_attn")
    assert sorted(build.SOURCES) == sorted(p.stem for p in csrc.glob("*.cu"))
    for f in csrc.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    before = build._library("act_quant")
    (tmp_path / "quant_common.cuh").write_text("// edited\n")
    assert build._library("act_quant") != before


def test_build_reads_back_the_log_of_a_library_built_before(tmp_path, monkeypatch):
    """A library already built (a second run in one checkout) gives
    ``build_logs`` the nvcc output kept beside it, with no nvcc started, so
    the registers and spills chip_smoke.py reports are always read from a
    build log; with no log kept its summary is None, never zeros."""
    import importlib.util

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_logs", {})
    monkeypatch.setattr(build.subprocess, "Popen", lambda *a, **k: pytest.fail("nvcc started"))
    line = "ptxas info    : Used 40 registers, used 1 barriers, 472 bytes cmem[0]"
    build._library("act_quant").write_bytes(b"")
    build._log("act_quant").write_text(line)
    build._library("flash_attn").write_bytes(b"")  # built with no log kept
    assert build.build_all(["act_quant", "flash_attn"]) == {}
    assert build.build_logs == {"act_quant": line}
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs._ptxas_summary(None) is None and cs._ptxas_summary([]) is None
    row = {"fn": "k", "registers": 40, "spill_stores": 0, "spill_loads": 8}
    assert cs._ptxas_summary([row]) == {"instantiations": 1, "registers": [40, 40],
                                        "spill_bytes_max": 8}
