"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds, not minutes). Libraries land in the package's
`build/` directory (git-ignored), named by a digest of the source, so an
edited source rebuilds and an unchanged one loads as it is. Nothing here
runs at import time: the CPU tests never need `nvcc`.
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
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("seg_insert", "merge_stack", "popcount", "bitop", "delta_merge",
           "window_merge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> compiler output of its last build (ptxas register/spill report)
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library, one `nvcc` per source, all started
    together. Returns the wall seconds spent; raises on a failed build."""
    names = list(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            BUILD_LOG[n] = out
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
