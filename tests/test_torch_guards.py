"""Guards of the port's boundaries: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch.configs.opt_125m import SMOKE
from repro_torch.models import api
from repro_torch.runtime import serve

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


@pytest.mark.parametrize("field,value,item", [
    ("pos_embedding", "rope", "item 4"), ("temperature", 0.7, "item 9")])
def test_unported_serving_options_raise(field, value, item):
    """What the port still refuses names its ROADMAP item: rope models
    (queue 1, item 4) and sampled decoding (item 9)."""
    if field == "temperature":
        with pytest.raises(NotImplementedError, match=item):
            serve.SamplingParams(temperature=value).validate()
        return
    cfg = dataclasses.replace(SMOKE, **{field: value})
    srv = serve.Server(api.init_params(cfg, seed=0, device="cpu"), cfg,
                       serve.ServerConfig(slots=1, max_seq=64, page_size=8), device="cpu")
    srv.submit(serve.Request(rid=0, prompt=[1, 2, 3], max_new=2))
    with pytest.raises(NotImplementedError, match=item):
        srv.run_until_drained()
