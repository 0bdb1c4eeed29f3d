"""Why tests/test_torch_parallel.py compares gradients in fp64: prints,
for the uneven batch of 4 of that file, each run's largest per-leaf
gradient error against the JAX single-device fp64 gradients (over the
leaf's largest value) and its count of leaves beyond
tests/test_torch_train.py's per-leaf tolerance:

  * JAX in fp32;
  * the port's one process in fp32;
  * the port in fp32 with every ReLU's mask taken from its fp64 run;
  * the port in fp64;

and how many ReLU mask elements differ between the port's fp32 and fp64
forward passes.

    python tests/fp32_gradient_witness.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import conftest  # noqa: E402,F401  (JAX on the CPU, 8 devices, as pytest)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_parallel as tp  # noqa: E402
from transfuser_tpu.models.lidar_centernet import \
    LidarCenterNet as JaxModel  # noqa: E402
from transfuser_tpu.train.losses import compute_losses, \
    total_loss  # noqa: E402
from transfuser_tpu.train.trainer import _model_inputs  # noqa: E402


def jax_fp32_gradients(case):
    cfg = case["cfg"]
    model = JaxModel(cfg, dtype=jnp.float32)

    def loss_fn(params, stats, batch):
        args, extra = _model_inputs(batch)
        out, _ = model.apply({"params": params, "batch_stats": stats},
                             *args, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             **extra)
        return total_loss(compute_losses(out, batch, cfg), cfg)

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(
        case["variables"]["params"], case["variables"]["batch_stats"],
        case["batch"]))
    return tp.state_dict_from_jax({"params": grads,
                                   "batch_stats": case["stats"]}, cfg)


def report(name, grads, case):
    errors = tp.leaf_errors(grads, case)
    worst = max(errors, key=lambda k: errors[k][0])
    beyond = sum(not ok for _, ok in errors.values())
    print(f"{name}: largest error {errors[worst][0]!r} ({worst}); "
          f"{beyond} of {len(errors)} leaves beyond the tolerance")


def main():
    torch.set_num_threads(2)
    case, masks = tp._jax_case(), []
    port64, _ = tp.port_gradients(case, torch.float64, masks)
    theirs = jax_fp32_gradients(case)
    report("JAX fp32", {k: theirs[k] for k in port64}, case)
    port32, _ = tp.port_gradients(case, torch.float32, [])
    pinned, flips = tp.port_gradients(case, torch.float32, masks, pin=True)
    report("port fp32", port32, case)
    report("port fp32, fp64 ReLU masks", pinned, case)
    report("port fp64", port64, case)
    print(f"ReLU mask elements that differ between the port's fp32 and fp64 "
          f"runs: {flips} of {sum(m.numel() for m in masks)} in "
          f"{len(masks)} calls")


if __name__ == "__main__":
    main()
