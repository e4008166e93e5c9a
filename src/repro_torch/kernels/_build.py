"""Build the port's CUDA kernels and load them with ctypes.

Every ``kernels/<name>/csrc/*.cu`` directory is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, one ``nvcc``
process per kernel, all started together. The libraries land in
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so an unchanged tree reuses them and a changed one
rebuilds. Headers shared by several kernels live in ``kernels/include/``:
every build gets it with ``-I`` and every library's hash covers it, so an
edit there rebuilds them all. Nothing is compiled at import: the first
launch builds. A failed build raises; no caller falls back to a plain version
on a CUDA tensor.
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
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build_all() did: seconds spent compiling and each library's
# ptxas report (registers, shared memory, spills per kernel)
build_info: Dict[str, object] = {"seconds": None, "ptxas": {}, "dir": None}


def _sources() -> Dict[str, list]:
    out = {}
    for csrc in sorted(KERNELS_DIR.glob("*/csrc")):
        files = sorted(csrc.glob("*.cu"))
        if files:
            out[csrc.parent.name] = files
    return out


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(sources: Dict[str, list]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    for name, files in sources.items():
        h.update(name.encode())
        for f in files:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        for hdr in sorted(files[0].parent.glob("*.cuh")):
            h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns name -> CDLL."""
    with _lock:
        if _libs:
            return _libs
        sources = _sources()
        out_dir = BUILD_ROOT / _digest(sources)
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name, files in sources.items():
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
                   *map(str, files)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            (out_dir / f"lib{name}.ptxas.txt").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
                continue
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        build_info["seconds"] = time.perf_counter() - t0
        build_info["dir"] = str(out_dir)
        for name in sources:
            report = out_dir / f"lib{name}.ptxas.txt"
            build_info["ptxas"][name] = report.read_text() if report.exists() else ""
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def ptxas_summary(name: str) -> list:
    """The ``ptxas info`` lines (registers, shared memory, spills) of one library."""
    text = build_info["ptxas"].get(name, "")
    return [ln.strip() for ln in text.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
