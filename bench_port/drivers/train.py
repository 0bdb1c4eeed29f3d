"""Training cells: the port's ``Trainer.train_step`` on resident batches.

Set-up builds one ``Trainer`` from the configuration, loads weights made
on the card from the seed, draws ``distinct_batches`` batches on the card
and drives the trainer's first ``check_steps`` steps through the same
call the window makes, each on its own batch: they are the warm-up and
the first steps the reference follows. The window then runs steps,
cycling over the batches, until ``--seconds`` have passed, and ends on a
synchronisation (the last step's loss read back). Once it has closed and
the peak memory is read, the trainer's state (parameters, BatchNorm
statistics, AdamW's moments and count of updates) is copied, and
``check_steps`` more steps go through the same call, on the batches the
window would have taken next; the weights each of them starts from are
copied too.

``compare``, once the trainer is freed: the reference (fp32, TF32 off)
follows both stretches from the same start, the seeded weights with zero
moments and the copied state, on the same batches and dropout streams.
Read for each are each step's loss, every parameter's gradient norm at
its first step (the port's from AdamW's first moment, (mu' - b1 mu) /
(1 - b1)), every parameter's change over the stretch and every BatchNorm
running statistic's change in its first step (the forward's batch
statistics at every normalisation); the numbers of the stretch after the
window are named ``after_...``. Besides, the reference's loss of each
step after the window from the weights the program started that step
from (``after_step_loss_gap``): a wrong batch or a half one shows there
on every step, where the reference's own chain of steps drifts from the
program's. ``limits/<cell>.json`` says which numbers decide: those of
``numbers``, each also prefixed ``after_``, and ``after_step_loss_gap``.
A model with no BatchNorm has no ``bn_stats_gap`` (nor
``after_bn_stats_gap``): a limits file that names it for such a model
fails every run.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import generate, harness, trace
from ..reference import train as ref_train
from ..weights import seeded_state_dict

UNMOVED = 1e-3  # a leaf whose reference gradient is below this share of
#                 the median leaf's is moved by round-off alone


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    """What the window left for ``compare``: the program's readings of
    both checked stretches and the state the second started from."""
    cfg: object
    batches: List[Dict[str, torch.Tensor]]
    weights_seed: int
    steps: int
    first: Dict
    after: Dict
    states: List[Dict[str, torch.Tensor]]  # before each step after
    moments: tuple
    count: int
    at: int                     # the batch index the second stretch began


def _follow(trainer, step, batches, at: int, n: int, keep: bool = False):
    """``n`` steps through ``step`` on the batches from index ``at``:
    their losses, each parameter's gradient norm at the first, each
    BatchNorm statistic's change in the first and each parameter's change
    over the ``n``. With ``keep``, also the state each step started from
    and the moments and count of updates the first did."""
    model, opt = trainer.model, trainer.optimizer
    names = [n_ for n_, p in model.named_parameters() if p.requires_grad]
    params = dict(model.named_parameters())
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mu0 = [m.detach().clone() for m in opt.mu]
    nu0 = [v.detach().clone() for v in opt.nu] if keep else None
    count = opt.step_count
    losses, states = [], [state]
    for s in range(n):
        if keep and s:
            states.append({k: v.detach().clone()
                           for k, v in model.state_dict().items()})
        losses.append(step(batches[(at + s) % len(batches)])["loss_total"])
        if s == 0:
            grad = torch.stack([
                torch.linalg.vector_norm(m.float() - opt.b1 * m0.float())
                for m, m0 in zip(opt.mu, mu0)]) / (1.0 - opt.b1)
            stats = {k: v - state[k] for k, v in model.state_dict().items()
                     if k.endswith(ref_train.RUNNING)}
    change = torch.stack([torch.linalg.vector_norm(params[k] - state[k])
                          for k in names])
    got = dict(loss=[float(x) for x in losses],
               grad=dict(zip(names, grad.tolist())),
               change=dict(zip(names, change.tolist())), stats=stats)
    if not keep:
        return got, None
    return got, (states, (dict(zip(names, mu0)), dict(zip(names, nu0))),
                 count)


def run(r: harness.Run) -> Outcome:
    """Set up, warm up, time the window, read the program's checked
    steps; the trainer is freed on return."""
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.train.trainer import Trainer

    device, ref = r.device, r.ref
    mix = r.mix
    cfg = ref.namespace(r.config["config"])
    r.cfg = cfg
    port_cfg = GlobalConfig.from_json(json.dumps(r.config["config"]))
    trainer = Trainer(port_cfg, device=device)
    weights_seed = harness.member_seed(r.seed, 0)
    trainer.model.load_state_dict(seeded_state_dict(ref, cfg, weights_seed,
                                                     device))
    batches = generate.train_batches(cfg, mix, r.seed, device)
    step = trainer.train_step
    checked = int(mix["check_steps"])
    first, _ = _follow(trainer, step, batches, 0, checked)
    for s in range(int(mix["warmup_steps"])):
        step(batches[(checked + s) % len(batches)])
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    k = checked + int(mix["warmup_steps"])
    last = None

    def timed_steps(deadline: float, limit: int = 1 << 30) -> int:
        nonlocal k, last
        n = 0
        while n < limit and time.perf_counter() < deadline:
            last = step(batches[k % len(batches)])["loss_total"]
            k += 1
            n += 1
        return n

    r.setup_s = time.perf_counter() - r.t_start
    if r.trace:  # the traced steps first, then the timed window
        with trace.traced(lambda: _sync(device)) as got:
            traced = timed_steps(float("inf"), int(mix["trace_steps"]))
        r.traced = got["trace"]
        r.traced.units = traced
        harness.log(f"traced {traced} steps, {r.traced.kernel_count()} "
                    f"kernels; reduced in {got['reduce_s']:.2f} s")
    with harness.host_load(r):
        t0 = time.perf_counter()
        n = timed_steps(t0 + r.seconds)
        final = float(last)
        r.window_s = time.perf_counter() - t0
    r.units = n
    r.attempted = n
    if not np.isfinite(final):
        r.failed = 1
    batch = int(mix["batch"])
    r.e2e = {"train_samples_per_s": n * batch / r.window_s}
    from ..flops import train_step_flops
    r.flops_per_unit = train_step_flops(ref, cfg, batch)
    if device.type == "cuda":
        r.memory_peak = torch.cuda.max_memory_allocated(device)
    harness.log(f"{n} steps in {r.window_s:.2f} s: "
                f"{r.e2e['train_samples_per_s']:.3f} samples/s, last loss "
                f"{final:.4f}")

    after, (states, moments, count) = _follow(trainer, step, batches, k,
                                             checked, keep=True)
    del trainer, step, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Outcome(cfg, batches, weights_seed, checked, first, after,
                   states, moments, count, k)


def compare(r: harness.Run, out: Outcome, control: bool = False
            ) -> Dict[str, float]:
    """The numbers of both stretches: the program's against the
    reference's, or with ``control`` the reference's in fp8 (put in the
    program's place) against its own in fp32."""
    cfg, device, ref = out.cfg, r.device, r.ref
    got: Dict[str, float] = {}
    with ref.plain_fp32():
        model = ref.build(cfg, device)
        stretches = (
            ("", seeded_state_dict(ref, cfg, out.weights_seed, device), None,
             0, 0, out.first),
            ("after_", out.states[0], out.moments, out.count, out.at,
             out.after))
        for prefix, state, moments, count, at, program in stretches:
            rows = [out.batches[(at + s) % len(out.batches)]
                    for s in range(out.steps)]

            def follow(mode):
                model.load_state_dict(state)
                return ref_train.train(model, cfg, rows, mode, moments,
                                       count)

            want = follow("fp32")
            test = follow("fp8") if control else program
            got.update({prefix + k: v
                        for k, v in numbers(test, want).items()})
        rows = [out.batches[(out.at + s) % len(out.batches)]
                for s in range(out.steps)]

        def losses_at(mode):
            return [ref_train.loss_at(model, cfg, row, state, out.count + s,
                                      mode)
                    for s, (row, state) in enumerate(zip(rows, out.states))]

        want = losses_at("fp32")
        test = losses_at("fp8") if control else out.after["loss"]
        got["after_step_loss_gap"] = max(abs(a - b) / abs(b)
                                         for a, b in zip(test, want))
        del model, stretches, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep) -> np.ndarray:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want.values())
    return np.array([abs(got[n] - want[n]) / max(want[n], med)
                     for n in want if keep(n)])


def numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """Every number that may be compared. ``loss1_gap`` / ``loss_gap``:
    the first / the worst checked step's loss, relative. By
    ``leaf_gaps``, as the worst leaf's, the 90th percentile leaf's
    (``_p90``) and the median leaf's (``_median``) gap: ``grad_gap``, the
    gradient at the first step, and ``update_gap``, the change over the
    checked steps, leaving out leaves whose reference gradient is below
    ``UNMOVED`` of the median leaf's. ``bn_stats_gap``: the median over
    BatchNorm running statistics of the norm of the difference of their
    changes in the first step, over the reference change's norm or the
    median one, whichever is larger; left out, not set to 0, where the
    reference has no running statistics (a model with no BatchNorm), so
    that a limit on it reads it as missing and fails."""
    med = statistics.median(want["grad"].values())
    moved = {n for n, g in want["grad"].items() if g >= UNMOVED * med}
    out = {"loss1_gap": abs(got["loss"][0] - want["loss"][0])
           / abs(want["loss"][0]),
           "loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(got["loss"], want["loss"]))}
    for key, name, keep in (("grad", "grad_gap", lambda n: True),
                            ("change", "update_gap", lambda n: n in moved)):
        gaps = leaf_gaps(got[key], want[key], keep)
        out[name] = float(gaps.max())
        out[f"{name}_p90"] = float(np.quantile(gaps, 0.9))
        out[f"{name}_median"] = float(np.median(gaps))
    if not want["stats"]:
        return out
    ref_norm = {k: float(torch.linalg.vector_norm(v))
                for k, v in want["stats"].items()}
    floor = statistics.median(ref_norm.values())
    out["bn_stats_gap"] = float(np.median([
        float(torch.linalg.vector_norm(got["stats"][k].float() - v))
        / max(ref_norm[k], floor) for k, v in want["stats"].items()]))
    return out
