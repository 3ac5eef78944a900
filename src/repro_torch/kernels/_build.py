"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` per source, all started together, into
``build/kernels/`` at the repository root (listed in ``.gitignore``).
Library names carry a hash of their source, so an edited source is
rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# process-wide handles of the loaded libraries (a library loads once)
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _lib_path(src: Path) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's build
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per
    built source (0.0 for one already built).  Raises with the
    compiler's output if a build fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in srcs:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    took = {src.stem: 0.0 for src in srcs}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[stem] = time.perf_counter() - t0
        _BUILD_LOG[stem] = log
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of this process's build."""
    return _BUILD_LOG.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
