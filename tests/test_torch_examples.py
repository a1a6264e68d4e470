"""The ``examples/torch_*.py`` twins of the four examples, each ``main`` run
on the CPU at a tiny size (a 2-layer, 64-wide opt-mini, sequences of 32,
2 training steps), through the knobs the reference reads:
``QUICKSTART_STEPS``, ``BENCH_TRAIN_STEPS`` (``torch_common.TRAIN_STEPS``,
read at import as in ``benchmarks/common.py``) and ``--steps``; and
``torch_common``'s copies of ``benchmarks/common.py``'s config and data
settings, field by field. ``--families`` holds the paged FP8 engine's
greedy streams equal to the contiguous path's on whisper-tiny and
MiniCPM3, trained 2 steps (the reference's 150 leave every stream token 0,
F3)."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_common  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_w4a8  # noqa: E402
import torch_sse_stream_demo  # noqa: E402
import torch_train_and_quantize  # noqa: E402

from test_torch_bridge import one_thread  # noqa: E402,F401  (autouse: torch on one thread)

TINY = dataclasses.replace(torch_common.BENCH_CFG, n_layers=2, d_model=64, d_ff=128,
                           vocab_size=256, max_position=128, attn_chunk=64)


def test_common_copies_benchmark_settings():
    from benchmarks import common

    assert dataclasses.asdict(torch_common.BENCH_CFG) == dataclasses.asdict(common.BENCH_CFG)
    assert torch_common.SEQ == common.SEQ and torch_common.TRAIN_STEPS == common.TRAIN_STEPS
    for seed in (0, 99, 1777):
        assert dataclasses.asdict(torch_common.data_cfg(seed)) == \
            dataclasses.asdict(common.data_cfg(seed))
    for a, b in zip(torch_common.calib_batches(2), common.calib_batches(2), strict=True):
        np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """opt-mini cut to 2 layers of 64, sequences of 32, 2 training steps,
    the checkpoint cache and the working directory in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    for mod in (torch_common, torch_quickstart, torch_train_and_quantize, torch_serve_w4a8):
        monkeypatch.setattr(mod, "BENCH_CFG", TINY)
    monkeypatch.setattr(torch_common, "SEQ", 32)
    monkeypatch.setattr(torch_common, "TRAIN_STEPS", 2)
    for mod in (torch_common, torch_serve_w4a8):
        monkeypatch.setattr(mod, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("QUICKSTART_STEPS", "2")
    return tmp_path


def test_quickstart_twin(tiny, capsys):
    reqs = torch_quickstart.main(["--device", "cpu"])
    assert [len(r.out) for r in reqs] == [8, 8]
    out = capsys.readouterr().out
    assert "W4A8(FP-FP+LoRC+M2)" in out and out.rstrip().endswith("done.")


def test_train_and_quantize_twin(tiny):
    rows = torch_train_and_quantize.main(["--device", "cpu", "--steps", "2"])
    assert [r[0] for r in rows] == [r[0] for r in torch_train_and_quantize.MATRIX]
    assert all(np.isfinite(ppl) and ppl > 1 for _, ppl in rows)


def test_serve_twin(tiny, capsys):
    reqs = torch_serve_w4a8.main(["--device", "cpu", "--requests", "4", "--slots", "2",
                                  "--max-new", "4"])
    assert len(reqs) == 4 and all(r.done and r.status == "ok" for r in reqs)
    assert (tiny / "cache" / "torch_opt_mini_2").is_dir()
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "pool audit clean" in out
    with pytest.raises(SystemExit):
        torch_serve_w4a8.main(["--device", "cpu", "--mesh", "2"])
    assert "item 14" in capsys.readouterr().err


def test_serve_twin_families_identity(tiny, monkeypatch, capsys):
    monkeypatch.setattr(torch_serve_w4a8, "FAMILY_TRAIN_STEPS", 2)
    torch_serve_w4a8.main(["--device", "cpu", "--families"])
    out = capsys.readouterr().out
    assert out.count("greedy tokens identical to the contiguous decode") == 2


def test_sse_twin_binds_a_port_the_os_picks(capsys):
    streams, hits = torch_sse_stream_demo.main(["--device", "cpu", "--max-new", "3"])
    assert [len(s) for s in streams] == [3, 3] and hits > 0
    out = capsys.readouterr().out
    port = int(out.split("serving /v1/completions on 127.0.0.1:")[1].split()[0])
    assert port != 8000 and port > 0
