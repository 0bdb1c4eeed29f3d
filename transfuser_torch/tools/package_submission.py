"""(Copy of transfuser_tpu/tools/package_submission.py, staging the port:
the image installs torch, builds the port's kernels with the CUDA
toolkit's nvcc and its native library with g++ at first use, and runs
the port's harness CLI on the card.)

Leaderboard-style submission packaging.

Behavioral spec: leaderboard/scripts/make_docker.sh + Dockerfile.master —
stage the team code + checkpoints into a build context, emit a Dockerfile
whose env contract matches the reference's (TEAM_AGENT, TEAM_CONFIG,
CHALLENGE_TRACK_CODENAME, ROUTES, SCENARIOS, REPETITIONS,
CHECKPOINT_ENDPOINT, RESUME), and optionally tar it up. The image runs
the hermetic harness CLI (or the live CARLA adapter when a server address
is provided) instead of the CUDA leaderboard stack.

Usage (numpy only; it runs on either machine):
  python -m transfuser_torch.tools.package_submission \\
      --checkpoint-dir log/transfuser --out submission/ [--tar sub.tgz]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tarfile

DOCKERFILE = """\
# Generated by transfuser_torch.tools.package_submission
# (reference: leaderboard/scripts/Dockerfile.master env contract)
# The CUDA toolkit's devel image: the port builds its kernels with nvcc
# and its native library with g++ at first use.
FROM nvidia/cuda:12.8.1-devel-ubuntu24.04

RUN apt-get update && apt-get install -y --no-install-recommends \\
    python3 python3-pip g++ && rm -rf /var/lib/apt/lists/*
WORKDIR /workspace
COPY transfuser_torch/ /workspace/team_code/transfuser_torch/
COPY pyproject.toml /workspace/team_code/
COPY model_ckpt/ /workspace/team_code/model_ckpt/
RUN pip install --break-system-packages --no-cache-dir --no-deps \\
    /workspace/team_code && \\
    pip install --break-system-packages --no-cache-dir torch numpy

ENV TEAM_CODE_ROOT /workspace/team_code
ENV TEAM_AGENT hybrid
ENV TEAM_CONFIG ${TEAM_CODE_ROOT}/model_ckpt
ENV CHALLENGE_TRACK_CODENAME SENSORS
ENV ROUTES /workspace/data/routes.xml
ENV SCENARIOS /workspace/data/scenarios.json
ENV REPETITIONS 1
ENV CHECKPOINT_ENDPOINT /workspace/results/results.json
ENV RESUME 0

CMD ["python3", "-m", "transfuser_torch.harness.cli", "evaluate"]
"""

RUN_SH = """\
#!/bin/bash
# reference tools/run_docker.sh equivalent
docker run -it --gpus all \\
  --mount source="$(pwd)"/results,target=/workspace/results,type=bind \\
  --rm --net=host transfuser-torch-agent:latest
"""


def stage(repo_root: str, checkpoint_dir: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    pkg_src = os.path.join(repo_root, "transfuser_torch")
    if not os.path.isdir(pkg_src):
        raise SystemExit(f"package not found at {pkg_src}")
    shutil.copytree(pkg_src, os.path.join(out, "transfuser_torch"),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "*.o", "_build"))
    for fname in ("pyproject.toml",):
        src = os.path.join(repo_root, fname)
        if os.path.exists(src):
            shutil.copy(src, out)
    ckpt_out = os.path.join(out, "model_ckpt")
    os.makedirs(ckpt_out, exist_ok=True)
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        shutil.copytree(checkpoint_dir, ckpt_out, dirs_exist_ok=True)
    with open(os.path.join(out, "Dockerfile"), "w") as f:
        f.write(DOCKERFILE)
    run_sh = os.path.join(out, "run_docker.sh")
    with open(run_sh, "w") as f:
        f.write(RUN_SH)
    os.chmod(run_sh, 0o755)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", default="",
                   help="trained checkpoint directory to bundle")
    p.add_argument("--out", default="submission")
    p.add_argument("--tar", default=None,
                   help="also write a .tgz of the staged context")
    p.add_argument("--build", action="store_true",
                   help="run `docker build` on the staged context")
    p.add_argument("--repo-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args()

    stage(args.repo_root, args.checkpoint_dir, args.out)
    print(f"staged submission context at {args.out}")
    if args.tar:
        with tarfile.open(args.tar, "w:gz") as tf:
            tf.add(args.out, arcname="submission")
        print(f"wrote {args.tar}")
    if args.build:
        rc = subprocess.call(["docker", "build", "-t",
                              "transfuser-torch-agent", args.out])
        sys.exit(rc)


if __name__ == "__main__":
    main()
