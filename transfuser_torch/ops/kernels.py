"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into
``transfuser_torch/_build/`` (git-ignored), under a name that carries a
hash of its source, and loaded with ``ctypes``; PyTorch's headers are not
involved, so a build takes seconds.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches and nowhere else. ``function`` hands a wrapper
the C entry point with its argument types bound once, at first use.

``KERNELS`` lists the kernels of the port's paths. ``PROBES`` lists
sources that are built the same way only to measure the card (an empty
kernel for the launch floor); no path calls them.
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
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -Xptxas -v: the build log lists each kernel's registers, spills and
# shared memory
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> what the kernel is and which TPU kernel it replaces (or why it
# was added where it replaces none)
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
    "adamw": {
        "route": "cuda",
        "source": "transfuser_torch/csrc/adamw.cu",
        "replaces": "no Pallas kernel: optax's adamw was XLA's; added so "
                    "that a step's update is one pass of 28 bytes an element, "
                    "where 16 _foreach passes moved 148",
    },
}

PROBES = ("launch_floor",)

launches: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Any] = {}


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
    """Compile every source in ``names`` (default: the kernels and the
    probes) that is not built yet, one ``nvcc`` process per source, all
    started together. Returns {name: {"seconds": wall time, "log":
    compiler output}}; raises if any build fails."""
    names = [*KERNELS, *PROBES] if names is None else list(names)
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


def function(name: str, symbol: str, argtypes: Sequence[Any]) -> Any:
    """The C function ``symbol`` of kernel ``name``, returning an int (a
    cudaError_t), with its argument types set once."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def call(fn: Any, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, with the
    device made current only when it is not already. The raw stream
    handle comes from the call PyTorch's own generated code uses: building
    a ``torch.cuda.Stream`` object per call costs the host about as much
    as the bf16 attention kernel costs the card."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
