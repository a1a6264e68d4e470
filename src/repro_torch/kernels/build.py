"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), at first
use, into ``build/kernels/`` at the root of the checkout. The library name
carries a digest of the source, the shared headers of ``csrc/`` and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. ``build_all`` starts one
``nvcc`` per missing source, all at once. nvcc's output (with the ptxas
register and spill lines) is kept beside each library as ``<library>.log``
and read back into ``build_logs`` when the library is already built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "FLAGS", "nvcc_path", "build_all", "load", "build_logs"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("w4a8_fused", "decode_attn", "mla_decode_attn", "act_quant", "w4a8_matmul",
           "flash_attn")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # source name -> nvcc's output (ptxas register/spill lines)


def _log(name: str) -> Path:
    return _library(name).with_suffix(".log")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
                       "CUDA kernels are built on the machine with the card")


def _library(name: str) -> Path:
    text = (_CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))  # shared headers
    digest = hashlib.sha1(text + " ".join(FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is missing, one nvcc each,
    in parallel. Returns {source: wall seconds from the start until its
    nvcc's output was collected} (the sources are collected in order, so a
    later one may have finished earlier; empty when nothing was missing);
    raises with nvcc's output if a build fails. Fills ``build_logs`` for
    every source of ``names`` built now, and for every one built before
    whose log is kept."""
    names = list(names)
    todo = [n for n in names if not _library(n).exists()]
    for n in names:
        if n not in todo and _log(n).exists():
            build_logs[n] = _log(n).read_text()
    if not todo:
        return {}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _library(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed, done = [], {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        done[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(out)
            os.replace(tmp_log, _log(name))  # the log first: a library never lacks its log
            os.replace(tmp, _library(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_library(name)))
    return lib
