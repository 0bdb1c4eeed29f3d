"""``correct`` on the CPU at the test size: the reference agrees with the
port in fp32; each fault planted in the timed path, and the fp8 control,
comes out not correct under the cells' own limits."""

import json

import pytest
import torch

from bench_port import faults, harness
from bench_port.reference import model as ref
from bench_port.weights import seeded_state_dict
from tiny import tiny_config, tiny_run


def _fp32(run):
    run.config["config"]["train"]["compute_dtype"] = "float32"
    return run


@pytest.mark.parametrize("name", ["transfuser", "transfuser-pillars"])
def test_reference_forward_equals_the_port_in_fp32(name):
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.models import LidarCenterNet

    raw = tiny_config(harness.load_json(
        f"{harness.HERE}/configs/{name}.json"))["config"]
    cfg = ref.namespace(raw)
    port = LidarCenterNet(GlobalConfig.from_json(json.dumps(raw)),
                          dtype=torch.float32, device="cpu")
    sd = seeded_state_dict(ref, cfg, 21, "cpu")
    port.load_state_dict(sd)
    model = ref.build(cfg)
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(5)
    pp = cfg.model.point_pillars
    x = dict(rgb=torch.rand(2, 64, 128, 3, generator=g) * 255,
             target_point=torch.rand(2, 2, generator=g) * 20,
             target_point_image=(torch.rand(2, 64, 64, 1, generator=g) > .9
                                 ).float(),
             velocity=torch.rand(2, generator=g))
    if pp.use_point_pillars:
        x["lidar"] = (torch.rand(2, 2000, 4, generator=g) - 0.5) * 12
        x["num_points"] = torch.tensor([2000, 1500], dtype=torch.int32)
    else:
        x["lidar"] = torch.rand(2, 64, 64, 2, generator=g)
    args = (x["rgb"], x["lidar"], x["target_point"],
            x["target_point_image"], x["velocity"])
    kw = dict(num_points=x.get("num_points"))
    wp, boxes, _ = port.forward_ego(*args, **kw)
    rwp, rboxes = model.forward_ego(*args, **kw)
    torch.testing.assert_close(rwp, wp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rboxes[..., 7], boxes[..., 7], rtol=1e-5,
                               atol=1e-6)
    port.train()
    model.train()
    out = port(*args, **kw, compute_aux=True,
               gen=torch.Generator().manual_seed(9))
    rout = model(**dict(zip(("rgb", "lidar", "target_point",
                             "target_point_image", "velocity"), args)),
                 **kw, compute_aux=True, gen=torch.Generator().manual_seed(9))
    for k in ("pred_wp", "head_heatmap", "pred_bev", "pred_semantic",
              "pred_depth"):
        torch.testing.assert_close(rout[k], out[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("workload", ["transfuser.train",
                                      "transfuser-pillars.train"])
def test_reference_training_equals_the_port_in_fp32(workload):
    run = _fp32(tiny_run(workload, seconds=0.2))
    harness.drive(run)
    r = run.readings
    assert run.units > 0
    for pre in ("", "after_"):  # the first steps and those after the window
        assert r[pre + "loss_gap"] < 1e-5
        assert r[pre + "grad_gap_p90"] < 1e-4
        assert r[pre + "update_gap_p90"] < 1e-3
        assert r[pre + "bn_stats_gap"] < 1e-4
    assert r["after_step_loss_gap"] < 1e-5


def test_reference_agent_equals_the_port_in_fp32():
    run = _fp32(tiny_run("transfuser.frame", seconds=1.0,
                         sample_compute_frames=4, warmup_frames=4))
    harness.drive(run)
    r = run.readings
    assert r["inputs_gap"] == 0.0
    assert r["post_gap"] < 1e-12
    # the agent's members are bf16 whatever the training dtype: the
    # waypoints carry bf16's rounding, well inside the limit
    assert r["wp_gap_m"] < run.limits["wp_gap_m"]["limit"]


def test_an_ensemble_of_two_members():
    run = tiny_run("transfuser.frame", seconds=0.5, sample_compute_frames=2,
                   warmup_frames=2, members=2)
    harness.drive(run)
    assert run.readings["inputs_gap"] == 0.0
    assert run.readings["post_gap"] < 1e-12


@pytest.mark.parametrize("plant", ["answer", "control"])
def test_a_frame_fault_is_not_correct(plant):
    run = tiny_run("transfuser.frame", seconds=1.0, sample_compute_frames=4,
                   warmup_frames=4)
    with faults.planted(plant):
        harness.drive(run)
    assert not run.correct(), run.checks


@pytest.mark.parametrize("workload", ["transfuser.train",
                                      "transfuser-pillars.train"])
@pytest.mark.parametrize("plant", ["unchanged", "half_batch", "stale_batch"])
def test_a_training_fault_is_not_correct(workload, plant):
    run = tiny_run(workload, seconds=0.2)
    with faults.planted(plant):
        harness.drive(run)
    assert not run.correct(), run.checks
    if plant == "stale_batch":  # only the steps after the window see it
        assert all(v <= lim for k, (v, lim) in run.checks.items()
                   if not k.startswith("after_")), run.checks


def test_the_frame_control_is_not_correct():
    run = tiny_run("transfuser.frame", seconds=1.0, sample_compute_frames=4,
                   warmup_frames=4)
    driver, outcome = harness.drive(run)
    got = driver.compare(run, outcome, control=True)
    lim = run.limits["wp_gap_m"]["limit"]
    assert got["wp_gap_m"] > lim > run.readings["wp_gap_m"]


@pytest.mark.parametrize("workload", ["transfuser.train",
                                      "transfuser-pillars.train"])
def test_the_training_control_is_not_correct(workload):
    run = tiny_run(workload, seconds=0.2)
    driver, outcome = harness.drive(run)
    got = driver.compare(run, outcome, control=True)
    failed = [k for k, spec in run.limits.items()
              if got[k] > spec["limit"]]
    assert failed, (got, run.limits)


def test_fp8_control_rounds_forward_and_backward():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    g = torch.linspace(0.1, 1.3, 101)
    with ref.lowp("fp8"):
        y = ref.qo(x)
        y.backward(g)
        assert not torch.equal(ref.q(x), x)
    assert not torch.equal(y.detach(), x.detach())
    # e4m3 keeps 3 mantissa bits, e5m2 2: relative errors up to 2^-4, 2^-3
    assert torch.all((y.detach() - x.detach()).abs()
                     <= 2.0 ** -4 * x.detach().abs() + 1e-6)
    assert not torch.equal(x.grad, g)
    assert torch.all((x.grad - g).abs() <= 2.0 ** -3 * g)
    assert torch.equal(ref.q(x), x) and torch.equal(ref.qo(x), x)


def test_plain_fp32_restores_both_tf32_flags():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with ref.plain_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("name", faults.NAMES)
def test_a_planted_fault_is_taken_out_on_leaving(name):
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.models.lidar_centernet import LidarCenterNet
    from transfuser_torch.train import trainer
    from transfuser_torch.train.train_state import AdamW

    owners = ((AdamW, "step"), (trainer, "make_train_step"),
              (LidarCenterNet, "forward_ego"), (HybridAgent, "run_step"))
    before = [getattr(o, n) for o, n in owners]
    with faults.planted(name):
        assert [getattr(o, n) for o, n in owners] != before
    assert [getattr(o, n) for o, n in owners] == before
