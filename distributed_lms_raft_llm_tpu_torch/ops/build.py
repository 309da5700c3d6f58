"""Build and load the port's CUDA kernels (nvcc -> plain C `.so` -> ctypes).

Each kernel is one source under `ops/csrc/` with an ``extern "C"`` launch
function. It is compiled at first use, for Hopper (`sm_90a`), into
`build/torch_kernels/` at the repository root, under a name that carries a
hash of the source and the flags, so an edited source is never served by a
stale library. Building takes seconds: the sources include no PyTorch
headers.

Nothing here runs at import time. The CPU tests import every module, and
the CPU has no `nvcc`.
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
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# Every kernel source of the port (csrc/<name>.cu).
KERNELS = ("decode_attention", "int8_matmul", "int8_matmul_wgmma")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
# name -> (seconds, compiler output) of the build this process ran.
build_logs: Dict[str, Tuple[float, str]] = {}  # guarded-by: _lock
# nvcc runs this process started: a warmed server's work must not add any.
builds = 0  # guarded-by: _lock


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}_{digest}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """Compile every named kernel (by default all of them) not yet built,
    one `nvcc` per source, all started together; then load them. Returns
    name -> library."""
    global builds
    with _lock:
        todo: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in names:
            if name in _libs:
                continue
            src, so = _target(name)
            if so.exists():
                continue
            tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp.so"
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            todo.append((name, tmp, so, proc, time.monotonic()))
            builds += 1
        failures = []
        for name, tmp, so, proc, t0 in todo:
            out, _ = proc.communicate()
            build_logs[name] = (time.monotonic() - t0, out)
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)  # atomic: concurrent builders agree
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    return build_all([name])[name]
