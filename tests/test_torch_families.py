"""The port's other backbone families (late_fusion, latentTF,
geometric_fusion) and its ResNet / ConvNeXt trunks inside the whole model,
vs the JAX package, fp32 on the CPU, with the same weights on both sides.

Weights are seeded numpy arrays in the JAX model's tree (shaped by
``jax.eval_shape`` of its init, so no init program is compiled), carried
to the port by ``state_dict_from_jax``. Sizes: 64x128 RGB, 64x64 LiDAR,
one GPT layer, anchors (2, 4) / (2, 2) so that every pool divides and
every resize upsamples, as at full size. Dropout is off. Tolerances:
rtol 1e-3 / atol 1e-4 for outputs and losses (tests/test_full_import.py's
full-model bound); gradients as tests/test_torch_train.py holds them.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_config
from test_family_import import (TorchGeometric, TorchLateFusion,
                                TorchLatentTF, _randomize_bn)
from test_family_import import _cfg as replica_config
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train.losses import compute_losses as jax_losses
from transfuser_tpu.train.losses import total_loss as jax_total
from transfuser_tpu.train.torch_import import convert_lidar_centernet_statedict
from transfuser_tpu.train.trainer import _model_inputs as jax_inputs
from transfuser_torch.data.pack import unpack_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train.jax_import import (load_reference_checkpoint,
                                               state_dict_from_jax)
from transfuser_torch.train.losses import compute_losses, total_loss
from transfuser_torch.train.trainer import _model_inputs

RTOL, ATOL = 1e-3, 1e-4
SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))
FAMILIES = ["transFuser", "late_fusion", "latentTF", "geometric_fusion"]
# family -> (image trunk, LiDAR trunk) of the forward and loss cases:
# late fusion pools each branch on its own, so it mixes trunk families
TRUNKS = {"transFuser": ("resnet_micro", "resnet_micro"),
          "late_fusion": ("convnext_tiny", "resnet_micro"),
          "latentTF": ("resnet_micro", "resnet_micro"),
          "geometric_fusion": ("resnet_micro", "resnet_micro")}
# forward cases: each family, and geometric fusion reading its grids the
# reference's way
FORWARD_CASES = FAMILIES + ["geometric_fusion:reference_view"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Torch's CPU pool beside XLA's in one process oversubscribes the
    cores (and the suite runs several workers): 2 threads here."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config(family, image="resnet_micro", lidar="resnet_micro", **model):
    cfg = tiny_config(family)
    gpt = dataclasses.replace(
        cfg.model.gpt, n_layer=1, n_head=4, n_embd=32,
        img_vert_anchors=2, img_horz_anchors=4, lidar_vert_anchors=2,
        lidar_horz_anchors=2, embd_pdrop=0.0, attn_pdrop=0.0,
        resid_pdrop=0.0)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, image_architecture=image, lidar_architecture=lidar,
        gpt=gpt, use_velocity=True, **model))


def _numpy_variables(shapes, seed):
    """Seeded numpy weights in the JAX model's tree: fan-in scaled
    kernels, small biases, near-identity norms and BatchNorm statistics,
    ConvNeXt layer scales well above their 1e-6 init."""
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
        elif name == "gamma":
            a = rng.uniform(0.2, 0.6, s.shape)
        else:
            raise KeyError(f"no init for leaf {name}")
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: dict(v) for k, v in tree.items()}


def _batch(cfg, seed=3):
    batch = synthetic_batch(cfg, 2, seed=seed, **SMALL)
    if "bev_points" in batch:
        # indices past both ends of the other grid, to exercise the clip
        rng = np.random.default_rng(seed)
        for key in ("bev_points", "cam_points"):
            batch[key] = rng.integers(-1, 6, batch[key].shape).astype(
                np.int32)
    return batch


def _jax_setup(cfg, seed=0):
    batch = _batch(cfg)
    jm = JaxModel(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    args, extra = jax_inputs(jbatch)
    variables = _numpy_variables(jax.eval_shape(
        lambda k: jm.init(k, *args, train=False, **extra),
        jax.random.PRNGKey(0)), seed)
    return batch, jm, jbatch, variables


def _port(cfg, variables):
    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return tm


def _port_inputs(batch):
    b = unpack_batch({k: torch.from_numpy(np.array(v))
                      for k, v in batch.items()})
    return b, *_model_inputs(b)


# ------------------------------------------------------------- forward

@functools.lru_cache(maxsize=None)
def _forward_case(name):
    family, _, view = name.partition(":")
    cfg = _config(family, *TRUNKS[family],
                  geometric_reference_view=bool(view))
    batch, jm, jbatch, variables = _jax_setup(cfg)

    def run(v, b):
        args, extra = jax_inputs(b)
        out = jm.apply(v, *args, train=False, compute_aux=True, **extra)
        return out, jm.apply(v, *args, method="forward_ego", **extra)

    out, ego = jax.device_get(jax.jit(run)(variables, jbatch))
    tm = _port(cfg, variables)
    _, args, extra = _port_inputs(batch)
    with torch.no_grad():
        got = tm(*args, **extra, compute_aux=True)
    got_ego = tm.forward_ego(*args, **extra)
    return dict(want=out, want_ego=ego, got=got, got_ego=got_ego)


@pytest.mark.parametrize("name", FORWARD_CASES)
def test_forward_parity(name):
    """Every output of the train-time forward in eval mode: waypoints,
    the seven head maps and the aux maps (BEV, semantics, depth)."""
    case = _forward_case(name)
    want, got = case["want"], case["got"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", FORWARD_CASES)
def test_forward_ego_parity(name):
    case = _forward_case(name)
    (wp_j, boxes_j, labels_j), (wp, boxes, labels) = (case["want_ego"],
                                                      case["got_ego"])
    assert boxes.shape == boxes_j.shape and labels.dtype == torch.int32
    np.testing.assert_allclose(wp.numpy(), wp_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(boxes.numpy(), boxes_j, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), labels_j)


def test_geometric_reference_view_changes_the_output():
    """The two geometric cases differ (the grids are not symmetric), so
    each one's parity above tests its own reading of the grids."""
    plain = _forward_case("geometric_fusion")["got"]["pred_wp"]
    ref = _forward_case("geometric_fusion:reference_view")["got"]["pred_wp"]
    assert not torch.allclose(plain, ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- weights

REPLICAS = {"late_fusion": TorchLateFusion, "latentTF": TorchLatentTF,
            "geometric_fusion": TorchGeometric}


@pytest.mark.parametrize("family", sorted(REPLICAS))
def test_reference_checkpoint_loads_strictly(family, tmp_path):
    """A model_*.pth in the reference's names (the suite's torch replica
    of the family's backbone, the rest of the model in the port's names,
    which are the reference's; DDP prefix) loads into the port with
    strict=True and drives like the JAX package's converter of it."""
    cfg = replica_config(family)
    if family == "geometric_fusion":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, geometric_reference_view=True,
            gpt=dataclasses.replace(cfg.model.gpt, n_embd=64)))
    torch.manual_seed(5)
    replica = REPLICAS[family]().eval()
    _randomize_bn(replica)
    if family == "latentTF":
        with torch.no_grad():
            for i in range(4):
                getattr(replica, f"transformer{i + 1}").pos_emb.uniform_(
                    -0.1, 0.1)
    rest = LidarCenterNet(cfg, dtype=torch.float32, device="cpu", seed=3)
    state = {f"module._model.{k}": v
             for k, v in replica.state_dict().items()}
    state.update({f"module.{k}": v for k, v in rest.state_dict().items()
                  if not k.startswith("_model.")})
    path = str(tmp_path / "model_0.pth")
    torch.save(state, path)

    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(load_reference_checkpoint(path, cfg), strict=True)
    variables = convert_lidar_centernet_statedict(
        torch.load(path, weights_only=True), cfg)
    batch = _batch(cfg.replace(model=dataclasses.replace(
        cfg.model, gpt=dataclasses.replace(
            cfg.model.gpt, img_vert_anchors=2, img_horz_anchors=4,
            lidar_vert_anchors=2, lidar_horz_anchors=2))), seed=4)
    jm = JaxModel(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.device_get(jax.jit(lambda v, b: jm.apply(
        v, *jax_inputs(b)[0], train=False, compute_aux=False,
        **jax_inputs(b)[1]))(variables, jbatch))
    _, args, extra = _port_inputs(batch)
    with torch.no_grad():
        got = tm(*args, **extra)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# the reference's timm surgery, per trunk family: alias names of tensors
# that also sit under their canonical names (dropped on load), timm's
# classifier head (dropped), and the LiDAR branch's replacement first
# conv (renamed to the stem conv where it is not already canonical)
SURGERY = {
    "regnety_micro": dict(
        alias={"conv1.conv.weight": "stem.conv.weight",
               "layer1.b1.conv1.conv.weight": "s1.b1.conv1.conv.weight"},
        head={"head.fc.weight": (3, 192)},
        lidar_stem={"stem.conv.weight": "conv1.weight"}),
    "resnet_micro": dict(
        alias={}, head={"fc.weight": (3, 128), "fc.bias": (3,)},
        lidar_stem={}),
    "convnext_tiny": dict(
        alias={"conv1.weight": "stem.0.weight", "conv1.bias": "stem.0.bias",
               "layer2.downsample.1.weight":
                   "stages.1.downsample.1.weight"},
        head={"head.fc.weight": (3, 768), "head.norm.weight": (768,)},
        lidar_stem={"stem.0.weight": "conv1.weight",
                    "stem.0.bias": "conv1.bias"}),
}


@pytest.mark.parametrize("trunk", sorted(SURGERY))
def test_reference_trunk_names_are_resolved(trunk, tmp_path):
    """The trunk-dependent alias rule: ResNet's ``conv1`` / ``bn1`` /
    ``layer*`` are canonical and stay; RegNetY's and ConvNeXt's are
    aliases and go; the LiDAR branch's top-level ``conv1`` (weight, and
    bias on ConvNeXt) becomes the stem conv."""
    cfg = _config("transFuser", trunk, trunk)
    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu", seed=4)
    want = tm.state_dict()
    surgery = SURGERY[trunk]
    img, lid = "_model.image_encoder.features.", "_model.lidar_encoder._model."
    state = dict(want)
    for alias, canonical in surgery["alias"].items():
        state[img + alias] = want[img + canonical]
    for key, shape in surgery["head"].items():
        state[img + key] = torch.zeros(shape)
    for canonical, registered in surgery["lidar_stem"].items():
        state[lid + registered] = state.pop(lid + canonical)
    path = str(tmp_path / "model_0.pth")
    torch.save({f"module.{k}": v for k, v in state.items()}, path)
    got = load_reference_checkpoint(path, cfg)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_inactive_geometric_scales_are_dropped(tmp_path):
    """gpt.n_scale = 2 fuses at the last two scales only: the port builds
    no parameters for the others, and a reference checkpoint's are
    dropped on load."""
    full = _config("geometric_fusion")
    state = LidarCenterNet(full, dtype=torch.float32, device="cpu",
                           seed=2).state_dict()
    cfg = full.replace(model=dataclasses.replace(
        full.model, gpt=dataclasses.replace(full.model.gpt, n_scale=2)))
    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    assert tm._model.scales == [2, 3]
    assert "_model.image_conv1.weight" not in tm.state_dict()
    path = str(tmp_path / "model_0.pth")
    torch.save(state, path)
    tm.load_state_dict(load_reference_checkpoint(path, cfg), strict=True)
    assert torch.equal(tm._model.vel_emb4.weight,
                       state["_model.vel_emb4.weight"])


# ---------------------------------------------------------------- train

@functools.lru_cache(maxsize=None)
def _train_case(family):
    """The JAX package's train-mode loss dict (and, for geometric fusion,
    its gradients) on one batch, and the port's on the same weights."""
    cfg = _config(family, *TRUNKS[family])
    batch, jm, jbatch, variables = _jax_setup(cfg, seed=1)

    def loss_fn(params, batch_stats, b):
        args, extra = jax_inputs(b)
        out, _ = jm.apply({"params": params, "batch_stats": batch_stats},
                          *args, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)}, **extra)
        detailed = jax_losses(out, b, cfg)
        return jax_total(detailed, cfg), detailed

    fn = loss_fn
    if family == "geometric_fusion":
        fn = jax.value_and_grad(loss_fn, has_aux=True)
    result = jax.device_get(jax.jit(fn)(
        variables["params"], variables.get("batch_stats", {}), jbatch))
    if family == "geometric_fusion":
        (loss, detailed), grads = result
    else:
        (loss, detailed), grads = result, None

    tm = _port(cfg, variables)
    tm.train()
    b, args, extra = _port_inputs(batch)
    out = tm(*args, **extra, compute_aux=True)
    got = compute_losses(out, b, cfg)
    got_total = total_loss(got, cfg)
    got_total.backward()
    return dict(cfg=cfg, loss=loss, detailed=detailed, grads=grads,
                variables=variables, tm=tm, got=got, got_total=got_total)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_loss_dict(family):
    case = _train_case(family)
    assert set(case["got"]) == set(case["detailed"])
    for k, v in case["detailed"].items():
        np.testing.assert_allclose(case["got"][k].item(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(case["got_total"].item(), case["loss"],
                               rtol=RTOL, atol=ATOL)


def test_geometric_gradients_per_leaf():
    case = _train_case("geometric_fusion")
    cfg, tm = case["cfg"], case["tm"]
    want = state_dict_from_jax({"params": case["grads"],
                                "batch_stats": case["variables"][
                                    "batch_stats"]}, cfg)
    named = dict(tm.named_parameters())
    assert set(named) <= set(want)
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in named.items():
        g, w = p.grad.numpy(), want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=max(1e-4 * np.abs(w).max(),
                                            1e-7 * top), err_msg=name)
