"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into
``transfuser_torch/_build/`` (git-ignored), under a name that carries a
hash of its source, and loaded with ``ctypes``; PyTorch's headers are not
involved, so a build takes seconds.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# name -> what the kernel is and which TPU kernel it replaces
KERNELS: Dict[str, Dict[str, str]] = {
    "attention": {
        "route": "cuda",
        "source": "transfuser_torch/csrc/attention.cu",
        "replaces": "transfuser_tpu/ops/attention.py:61",
    },
    "scatter_max": {
        "route": "cuda",
        "source": "transfuser_torch/csrc/scatter_max.cu",
        "replaces": "experiments/pallas_scatter_max.py:64",
    },
}

launches: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put the "
                       "CUDA toolkit's bin directory on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() +
                          " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together. Returns
    {name: {"seconds": wall time, "log": compiler output}}; raises if any
    build fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            procs[name] = None
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    result = {}
    failed = []
    for name, entry in procs.items():
        if entry is None:
            result[name] = {"seconds": 0.0, "log": "cached"}
            continue
        proc, tmp, out, t0 = entry
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
