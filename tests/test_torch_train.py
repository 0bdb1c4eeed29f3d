"""The port's training step vs the JAX package, fp32 on the CPU, with the
LiDAR histogram and with PointPillars.

For each LiDAR mode the tiny model's weights are seeded numpy arrays in
the JAX package's tree (shaped by ``jax.eval_shape`` of its init), carried
to the port by ``state_dict_from_jax``; one jitted JAX program gives the
train-mode loss terms, gradients and BatchNorm statistics.
Dropout is off (all three pdrops 0): the two frameworks cannot draw the
same masks. Tolerances: rtol 1e-3 / atol 1e-4 for outputs and losses
(the full-model bound of tests/test_full_import.py); gradients per leaf
rtol 1e-3 with atol 1e-4 of the leaf's largest gradient (and at least
1e-7 of the model's largest, the rounding floor; leaves whose gradient
is 0 in exact arithmetic only have to be below 1e-6 of it on both
sides); BatchNorm running statistics rtol 1e-5 / atol 1e-5 (the batch
statistic enters them x0.1, from activations that agree to the forward
tolerance); the optimizer on fixed gradients against optax at rtol 1e-6.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_full_import import _parity_config
from transfuser_tpu.data.pack import pack_sample
from transfuser_tpu.data.pack import unpack_batch as jax_unpack
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.ops import centernet as jcn
from transfuser_tpu.train import metrics as jmetrics
from transfuser_tpu.train.losses import compute_losses as jax_losses
from transfuser_tpu.train.losses import total_loss as jax_total
from transfuser_tpu.train.train_state import make_optimizer as jax_optimizer
from transfuser_tpu.train.trainer import _model_inputs as jax_inputs
from transfuser_torch.data.pack import unpack_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.ops import centernet as tcn
from transfuser_torch.ops import kernels
from transfuser_torch.train import metrics as tmetrics
from transfuser_torch.train.jax_import import state_dict_from_jax
from transfuser_torch.train.losses import compute_losses, total_loss
from transfuser_torch.train.train_state import make_optimizer, make_schedule
from transfuser_torch.train.trainer import Trainer, _model_inputs

RTOL, ATOL = 1e-3, 1e-4
# gradients that are 0 in exact arithmetic, so both sides hold only
# rounding noise: softmax ignores a bias added to every key, and a
# training-mode BatchNorm removes a bias added before it
ZERO_GRAD_LEAVES = ("attn.key.bias", "point_net.net.0.bias",
                    "point_net.net.3.bias")
SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))
MODES = ["histogram", "pillars"]


def _config(mode, **train):
    cfg = _parity_config()
    gpt = dataclasses.replace(cfg.model.gpt, n_layer=1, embd_pdrop=0.0,
                              attn_pdrop=0.0, resid_pdrop=0.0)
    model = dataclasses.replace(cfg.model, gpt=gpt)
    if mode == "pillars":
        # 8 m x 8 m at 8 px/m: a 64 x 64 canvas, the tiny LiDAR size
        pp = dataclasses.replace(
            cfg.model.point_pillars, use_point_pillars=True,
            max_lidar_points=500, min_x=-4.0, max_x=4.0, min_y=-8.0,
            max_y=0.0)
        model = dataclasses.replace(model, point_pillars=pp)
    return cfg.replace(model=model,
                       train=dataclasses.replace(cfg.train, **train))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Torch's CPU pool beside XLA's in one process oversubscribes the
    cores (and the suite runs several workers): 2 threads here."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _numpy_variables(shapes, seed):
    """Seeded numpy weights in the JAX model's tree (shapes from
    ``jax.eval_shape`` of its init, so no init program is compiled):
    fan-in scaled kernels, small biases, near-identity norms and
    BatchNorm statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            a = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name in ("bias", "mean", "pos_emb"):
            a = rng.uniform(-0.05, 0.05, s.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.9, 1.1, s.shape)
        else:
            raise KeyError(f"no init for leaf {name}")
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: dict(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_case(mode):
    """Weights, batch, and the JAX package's train-mode loss, gradients
    and updated BatchNorm statistics, for one LiDAR mode."""
    cfg = _config(mode)
    batch = synthetic_batch(cfg, 2, seed=3, **SMALL)
    if mode == "pillars":
        # about half the points fall inside the 8 m grid
        rng = np.random.default_rng(4)
        xy = batch["lidar_raw"][..., :2]
        xy[:] = rng.uniform(-6, 6, xy.shape) + np.array([0.0, -4.0])
    jm = JaxModel(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    args, extra = jax_inputs(jbatch)
    variables = _numpy_variables(jax.eval_shape(
        lambda k: jm.init(k, *args, train=False, **extra),
        jax.random.PRNGKey(0)), seed=0)

    def loss_fn(params, batch_stats, batch):
        args, extra = jax_inputs(batch)
        out, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats},
            *args, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)}, **extra)
        detailed = jax_losses(out, batch, cfg)
        return jax_total(detailed, cfg), (detailed, mutated["batch_stats"])

    (loss, (detailed, stats)), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch))
    return dict(cfg=cfg, batch=batch, jax_model=jm, variables=variables,
                loss=loss, detailed=detailed, grads=grads, stats=stats,
                mode=mode)


@pytest.fixture(scope="module", params=MODES)
def case(request):
    return _jax_case(request.param)


def _port_model(case):
    tm = LidarCenterNet(case["cfg"], dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(case["variables"], case["cfg"]),
                       strict=True)
    return tm


@pytest.fixture(scope="module")
def stepped(case):
    """The port's train-mode forward, loss and backward on the same batch."""
    tm, cfg = _port_model(case), case["cfg"]
    tm.train()
    batch = unpack_batch(_torch_batch(case["batch"]))
    args, extra = _model_inputs(batch)
    out = tm(*args, **extra, compute_aux=True)
    detailed = compute_losses(out, batch, cfg)
    loss = total_loss(detailed, cfg)
    loss.backward()
    return tm, loss, detailed


def test_pillar_forward_ego():
    """The histogram mode's forward_ego is held to JAX in
    tests/test_torch_forward_ego.py."""
    case = _jax_case("pillars")
    jm, jbatch = case["jax_model"], {k: jnp.asarray(v)
                                     for k, v in case["batch"].items()}
    wp_j, boxes_j, labels_j = jax.device_get(jax.jit(
        lambda v, b: jm.apply(v, *jax_inputs(b)[0], method="forward_ego",
                              **jax_inputs(b)[1]))(case["variables"], jbatch))
    tm, batch = _port_model(case), _torch_batch(case["batch"])
    args, extra = _model_inputs(batch)
    kernels.reset_launches()
    wp, boxes, labels = tm.forward_ego(*args, **extra)
    assert sum(kernels.launches.values()) == 0  # CPU: plain versions
    np.testing.assert_allclose(wp.numpy(), wp_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(boxes.numpy(), boxes_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), labels_j)


def test_loss_dict(case, stepped):
    _, loss, detailed = stepped
    assert list(detailed) == list(case["cfg"].loss.detailed_losses)
    assert set(detailed) == set(case["detailed"])
    for k, v in case["detailed"].items():
        np.testing.assert_allclose(detailed[k].item(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=RTOL,
                               atol=ATOL)


def test_gradients_per_leaf(case, stepped):
    tm, cfg = stepped[0], case["cfg"]
    want = state_dict_from_jax({"params": case["grads"],
                                "batch_stats": case["stats"]}, cfg)
    named = dict(tm.named_parameters())
    assert set(named) <= set(want)
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in named.items():
        g, w = p.grad.numpy(), want[name].numpy()
        if name.endswith(ZERO_GRAD_LEAVES):
            assert np.abs(g).max() < 1e-6 * top, name
            assert np.abs(w).max() < 1e-6 * top, name
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=max(1e-4 * np.abs(w).max(),
                                            1e-7 * top), err_msg=name)


def test_batchnorm_running_stats_after_step(case, stepped):
    tm, cfg = stepped[0], case["cfg"]
    want = state_dict_from_jax({"params": case["variables"]["params"],
                                "batch_stats": case["stats"]}, cfg)
    got = tm.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 20
    if case["mode"] == "pillars":
        assert "point_pillar_net.point_net.net.1.running_var" in keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------- targets and losses

def _labels(seed, b=3, k=20, n=6):
    rng = np.random.default_rng(seed)
    lab = np.zeros((b, k, 7), np.float32)
    lab[:, :n, 0] = rng.uniform(16, 240, (b, n))
    lab[:, :n, 1] = rng.uniform(16, 240, (b, n))
    lab[:, :n, 2] = rng.uniform(8, 40, (b, n))
    lab[:, :n, 3] = rng.uniform(16, 60, (b, n))
    lab[:, :n, 4] = rng.uniform(-np.pi, np.pi, (b, n))
    lab[:, :n, 5] = rng.uniform(0, 10, (b, n))
    lab[:, :n, 6] = rng.integers(0, 2, (b, n))
    lab[0, 2, :2] = lab[0, 1, :2] + 0.5  # two boxes on one pixel: last wins
    lab[1, n + 2] = lab[1, 0]            # a box after a padding row
    return lab


def test_build_targets():
    lab = _labels(0)
    valid = np.abs(lab).sum(-1) > 0
    want = jax.jit(lambda lab, valid: jcn.build_targets(
        lab, valid, (64, 64), (256, 256), num_dir_bins=12))(
        jnp.asarray(lab), jnp.asarray(valid))
    got = tcn.build_targets(torch.from_numpy(lab), torch.from_numpy(valid),
                            (64, 64), (256, 256), num_dir_bins=12)
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


def _maps(seed, b=3, h=16, w=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        heat=1 / (1 + np.exp(-f(b, h, w, 1))), heat_t=np.clip(
            rng.uniform(-0.5, 1.3, (b, h, w, 1)), 0, 1).astype(np.float32),
        pred=f(b, h, w, 2), target=f(b, h, w, 2),
        weight=(rng.uniform(size=(b, h, w)) > 0.7).astype(np.float32),
        logits=f(b, h, w, 5), labels=rng.integers(0, 5, (b, h, w)),
        avg=np.float32(7.0))


LOSSES = {
    "gaussian_focal": lambda m, cn, x: cn.gaussian_focal_loss(
        x(m["heat"]), x(m["heat_t"]), x(m["avg"])),
    "weighted_l1": lambda m, cn, x: cn.weighted_l1_loss(
        x(m["pred"]), x(m["target"]), x(m["weight"][..., None]),
        x(m["avg"]), loss_weight=0.1),
    "weighted_smooth_l1": lambda m, cn, x: cn.weighted_smooth_l1_loss(
        x(m["pred"][..., 0]), x(m["target"][..., 0]), x(m["weight"]),
        x(m["avg"])),
    "weighted_ce": lambda m, cn, x: cn.weighted_ce_loss(
        x(m["logits"]), x(m["labels"]), x(m["weight"]), x(m["avg"])),
    "weighted_ce_batch_broadcast": lambda m, cn, x: cn.weighted_ce_loss(
        x(m["logits"]), x(m["labels"]), x(m["weight"]), x(m["avg"]),
        batch_broadcast=True),
    "cross_entropy_mean": lambda m, cn, x: cn.cross_entropy_mean(
        x(m["logits"]), x(m["labels"])),
    "cross_entropy_class_weights": lambda m, cn, x: cn.cross_entropy_mean(
        x(m["logits"]), x(m["labels"]),
        x(np.array([1.0, 1.0, 3.0, 0.5, 2.0], np.float32))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_terms(name):
    m = _maps(1)
    got = LOSSES[name](m, tcn, lambda a: torch.from_numpy(np.asarray(a)))
    want = LOSSES[name](m, jcn, jnp.asarray)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("broadcast", [False, True])
def test_compute_losses_ce_batch_broadcast(broadcast):
    """The whole loss dict on fixed random maps, under both settings of
    the reference's (B,H,W)x(B,1,H,W) CE broadcast."""
    cfg = _config("histogram")
    cfg = cfg.replace(loss=dataclasses.replace(
        cfg.loss, reference_ce_batch_broadcast=broadcast))
    batch = synthetic_batch(cfg, 3, seed=5, **SMALL)
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = dict(pred_wp=f(3, 4, 2), pred_bev=f(3, 40, 40, 3),
               head_heatmap=1 / (1 + np.exp(-f(3, 16, 16, 1))),
               head_wh=f(3, 16, 16, 2), head_offset=f(3, 16, 16, 2),
               head_yaw_class=f(3, 16, 16, 12), head_yaw_res=f(3, 16, 16, 1),
               head_velocity=f(3, 16, 16, 1), head_brake=f(3, 16, 16, 2),
               pred_semantic=f(3, 64, 128, 7),
               pred_depth=rng.uniform(size=(3, 64, 128)).astype(np.float32))
    want = jax.jit(lambda o, b: jax_losses(o, b, cfg))(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = compute_losses(_torch_batch(out), _torch_batch(batch), cfg)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)


def test_eval_metrics():
    rng = np.random.default_rng(7)
    out = dict(pred_wp=rng.standard_normal((3, 4, 2)).astype(np.float32),
               pred_bev=rng.standard_normal((3, 40, 40, 3)).astype(
                   np.float32))
    batch = dict(ego_waypoint=rng.standard_normal((3, 4, 2)).astype(
        np.float32), bev=rng.integers(0, 3, (3, 40, 40)).astype(np.int32))
    want = jmetrics.eval_metrics(out, batch)
    got = tmetrics.eval_metrics(_torch_batch(out), _torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    heat, target = rng.uniform(size=(2, 8, 8, 1)), np.zeros((2, 8, 8, 1))
    target[:, ::3, ::3] = 1.0
    np.testing.assert_allclose(
        tmetrics.heatmap_peak_agreement(torch.from_numpy(heat),
                                        torch.from_numpy(target)).item(),
        float(jmetrics.heatmap_peak_agreement(heat, target)), rtol=1e-6)


def test_unpack_batch_widens_the_wire_format():
    packed = pack_sample(synthetic_batch(_config("histogram"), 2, seed=8,
                                         **SMALL))
    got = unpack_batch(_torch_batch(packed))
    want = jax.device_get(jax_unpack(
        {k: jnp.asarray(v) for k, v in packed.items()}))
    for k, v in want.items():
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# ------------------------------------------------------------- optimizer

def _param_tree(seed):
    """Leaves in the JAX layouts the model has: a dense kernel (in, out), a
    conv kernel (H, W, I, O), a (1, T, C) embedding, a vector, a (1, C)
    dense kernel that squeezes to a vector."""
    rng = np.random.default_rng(seed)
    shapes = dict(dense=(6, 5), conv=(3, 3, 4, 2), emb=(1, 7, 3), vec=(5,),
                  vel=(1, 4))
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _to_torch_layout(k, a):
    if k in ("dense", "vel"):
        return torch.from_numpy(np.array(a.T))
    if k == "conv":
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(a, (3, 2, 0, 1))))
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("clip", ["adamw", "agc", "global_norm", "both"])
def test_optimizer_matches_optax_on_fixed_gradients(clip):
    cfg = _config("histogram",
                  agc_clip=0.05 if clip in ("agc", "both") else 0.0,
                  grad_clip_norm=0.5 if clip in ("global_norm", "both")
                  else 0.0, weight_decay=0.01)
    params = _param_tree(0)
    tx = jax_optimizer(cfg, None)
    opt_state = tx.init(params)
    jp = dict(params)

    @jax.jit
    def update(grads, opt_state, jp):
        updates, opt_state = tx.update(grads, opt_state, jp)
        return optax.apply_updates(jp, updates), opt_state

    tp = {k: _to_torch_layout(k, a).requires_grad_(True)
          for k, a in params.items()}
    opt = make_optimizer(list(tp.values()), cfg)
    for step in range(3):
        grads = {k: v * (3.0 if step == 1 else 1.0)
                 for k, v in _param_tree(10 + step).items()}
        jp, opt_state = update(grads, opt_state, jp)
        for k, p in tp.items():
            p.grad = _to_torch_layout(k, grads[k])
        opt.advance()
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(
                p.detach().numpy(),
                _to_torch_layout(k, np.asarray(jp[k])).numpy(), rtol=1e-6,
                atol=1e-7, err_msg=f"{k} step {step}")


def test_lr_schedule_with_warmup_shifts_the_drops():
    cfg = _config("histogram", warmup_epochs=1.5, schedule_reduce_epoch_01=3,
                  schedule_reduce_epoch_02=5, lr=1e-3)
    steps_per_epoch = 4
    tx = jax_optimizer(cfg, steps_per_epoch)
    params = {"w": jnp.ones(())}
    state = tx.init(params)
    sched = make_schedule(cfg, steps_per_epoch)
    for step in range(30):
        # with zero gradients adamw's update is -lr * wd * w
        updates, state = tx.update({"w": jnp.zeros(())}, state, params)
        want = -float(updates["w"]) / cfg.train.weight_decay
        np.testing.assert_allclose(sched(step), want, rtol=1e-6,
                                   err_msg=f"step {step}")
    # warmup 6 steps; the first drop at 3 epochs + the warmup, not at 12
    assert sched(12) == pytest.approx(1e-3)
    assert sched(18) == pytest.approx(1e-4)


def test_trainer_steps_cut_the_loss(case):
    """A few of the port's own train steps on one fixed batch, with the
    default dropout and the trainer's per-step generator: the loss falls."""
    cfg = case["cfg"].replace(model=dataclasses.replace(
        case["cfg"].model, gpt=_parity_config().model.gpt),
        train=dataclasses.replace(case["cfg"].train, lr=1e-3))
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    losses = [trainer.train_epoch([case["batch"]])["loss_total"]
              for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    val = trainer.validate([case["batch"]])
    assert {"val_loss_total", "val_ade", "val_fde",
            "val_bev_iou_road"} <= set(val)
