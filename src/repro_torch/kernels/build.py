"""Build the CUDA sources in ``repro_torch/csrc`` with ``nvcc`` into shared
libraries with a plain C interface, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source is rebuilt), built at
first use.  :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(target, process or None)``.  ``-Xptxas -v`` goes to ``<target>.log``."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    proc.tmp = tmp
    return out, proc


def _finish(name: str, out: Path, proc) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(proc.tmp, out)


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Build every source in parallel; returns the wall seconds taken."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in sources()}
    for n, (out, proc) in started.items():
        _finish(n, out, proc)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said for ``csrc/<name>.cu`` (registers, shared
    memory, spills) in the build that produced its library."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    out, proc = _start(name)
    _finish(name, out, proc)
    return ctypes.CDLL(str(out))
