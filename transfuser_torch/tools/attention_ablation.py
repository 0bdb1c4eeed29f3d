"""Where the attention kernels' time goes, on a card.

    python -m transfuser_torch.tools.attention_ablation

Builds variants of ``csrc/attention.cu`` with parts of a kernel's work
taken out and prints, as one JSON line per variant, shape and dtype, each
one's device time per call (torch.profiler):
  - the resident fp32 kernel at the fusion GPT's fp32 shapes: the logits'
    MMA loop, the reloads of K chunks after the first two, the P.V loop;
  - the key-tiled kernel (forced) at the 2016-token grid, (1,2016,4,D)
    for D = 144 and 378, in both dtypes: the logits' MMAs (QK^T), the
    P.V MMAs, and the K / V (and streamed Q) copies after the ring's
    first fill.
A variant's output is wrong by design: only its time means anything, and
the differences between variants split the kernel's time into its parts.
The variants build into ``transfuser_torch/_build/`` (git-ignored) with
the port's nvcc flags; the port never calls them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from transfuser_torch.ops import kernels
from transfuser_torch.ops.attention import _ARGS, _ARGTYPES, _DTYPE_CODE

SHAPES = [(1, 174, 4, d) for d in (18, 54, 144, 378)] + [(4, 174, 2, 378)]
KT_SHAPES = [(1, 2016, 4, d) for d in (144, 378)]

# `scale > 1e30f` is never true, but the compiler cannot know it: the loop
# it guards is kept in the binary and runs zero times
_NO_LOGITS = ("    for (int kk = 0; kk < width; kk += 8) {",
              "    for (int kk = 0; kk < width * (int)(scale > 1e30f); "
              "kk += 8) {")
_NO_RELOADS = ("      stage_chunk(i + 2);\n", "      cp_async_commit();\n")
_NO_PV = ("    for (int kk = key0 + 8 * grp; kk < key1 && warp < n_tasks;",
          "    for (int kk = key0 + 8 * grp;\n"
          "         kk < key1 && warp < n_tasks && scale > 1e30f;")
# the key-tiled kernel (attention_kt): its QK^T loop, its P.V loop, and
# every stage's copies after the ring's first n_slots stages
_KT_NO_QK = ("    for (int kk = 0; kk < width; kk += kStep) {",
             "    for (int kk = 0; kk < width * (int)(scale > 1e30f); "
             "kk += kStep) {")
_KT_NO_PV = ("      for (int ks = 0; ks < kKeys; ks += kStep) {",
             "      for (int ks = 0; ks < kKeys * (int)(scale > 1e30f); "
             "ks += kStep) {")
_KT_NO_COPIES = ("    const bool copy = next < n_stages;",
                 "    const bool copy = next < min(n_stages, sh.n_slots);")
VARIANTS = {
    "kernel": [],
    "no_logit_mmas": [_NO_LOGITS],
    "no_logit_mmas_no_pv": [_NO_LOGITS, _NO_PV],
    "first_two_k_chunks_only": [_NO_LOGITS, _NO_PV, _NO_RELOADS],
    "kt_no_qk_mmas": [_KT_NO_QK],
    "kt_no_pv_mmas": [_KT_NO_PV],
    "kt_no_mmas": [_KT_NO_QK, _KT_NO_PV],
    "kt_no_kv_copies": [_KT_NO_COPIES],
}
# which variants run where: (shapes, dtypes, the kernel forced: 2 the
# resident ones, 1 the key-tiled one, as AttentionArgs.force)
RUNS = [
    (SHAPES, (torch.float32,), 2,
     ["kernel", "no_logit_mmas", "no_logit_mmas_no_pv",
      "first_two_k_chunks_only"]),
    (KT_SHAPES, (torch.bfloat16, torch.float32), 1,
     ["kernel", "kt_no_qk_mmas", "kt_no_pv_mmas", "kt_no_mmas",
      "kt_no_kv_copies"]),
]


def variant_sources() -> dict:
    """{variant: source text}; raises if a substitution no longer matches
    the kernel's source exactly once."""
    src = (kernels.CSRC / "attention.cu").read_text()
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in "
                                 f"csrc/attention.cu exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> dict:
    """{variant: the C entry point}, nvcc run for all variants at once."""
    out_dir = kernels.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).tf_attention_forward
        fn.argtypes = list(_ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, reps: int = 100) -> float:
    """Device time per call of `reps` warm calls, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device work")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shapes, dtypes, force, names in RUNS:
        for dtype in dtypes:
            for shape in shapes:
                q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                           .to(dtype) for _ in range(3))
                out = torch.empty_like(q)
                args = _ARGS.pack(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], *shape, _DTYPE_CODE[dtype], force)
                for name in names:
                    def call(fn=fns[name], name=name):
                        err = fn(args, stream)
                        if err != 0:
                            raise RuntimeError(f"variant {name}: CUDA error "
                                               f"{err}")
                    print(json.dumps({
                        "variant": name, "shape": list(shape),
                        "dtype": str(dtype).split(".")[-1],
                        "key_tiled": force == 1,
                        "device_ms": device_ms(call), "card": card}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
