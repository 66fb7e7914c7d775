"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries land in ``build/repro_torch/`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source, the flags and the compiler path, so an edited source
builds afresh and an unchanged one loads at once.  All sources compile in
parallel, one ``nvcc`` each.  Nothing is built when the package is
imported: the first launch (or ``build_all``) builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _target(src: Path, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [nvcc]).encode())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _start(src: Path, nvcc: str):
    """(process, tmp path, target) for one source, or None when built."""
    out = _target(src, nvcc)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                           f"{out.name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc`` processes
    started together; returns the wall seconds it took."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    jobs = [j for j in (_start(s, nvcc) for s in sorted(CSRC.glob("*.cu")))
            if j is not None]
    errors: List[str] = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            nvcc = _nvcc()
            job = _start(src, nvcc)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(str(_target(src, nvcc)))
            _LIBS[name] = lib
        return lib
