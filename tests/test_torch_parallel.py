"""The port's multi-device training against the JAX package's, on the CPU
with gloo ranks in subprocesses (tests/torch_parallel_worker.py).

(a) The tensor-parallel rule and ZeRO-1's size threshold against JAX
    ``_spec_for_param`` and ``opt_state_sharding`` for every GPT leaf of
    the tiny and the full-size config, at 2 and 4 ranks.
(b) ``PrefetchLoader`` shards against the JAX loader's.
(c, d) One train step at data 2, model 2 (tensor parallel) and data 2 x
    model 2 (ZeRO-1 on) on a global batch of 4 whose halves differ: the
    second half has no boxes (a rank-local ``max(1, peaks)`` would be 1
    there), another BEV class mix and other BatchNorm statistics, so a
    port that normalised per rank would fail. Every rank's loss dict
    equals the JAX mesh trainer's (``Trainer(mesh=MeshSpec(2, 1))``, rtol
    2e-4 as tests/test_trainer_sharding.py), the data group's averaged
    gradients the JAX single-device gradients per leaf and the BatchNorm
    running statistics the JAX ones (tests/test_torch_train.py's
    tolerances, in fp64); the eval dict equals the port's single-process one on
    the global batch (rtol 1e-5), the parameters after 3 steps behind
    global-norm and AGC clipping the one process's; ZeRO-1 on and off give
    bitwise-equal parameters. At model 2 with every dropout on, a step
    equals the one process's from the same generator. A checkpoint of one
    process restores at data 2 (ZeRO-1) and at model 2 to the saved
    parameters and moments, and the next step equals the one process's.
(e) The training CLI at 2 processes: tests/test_torch_parallel_cli.py.
Dropout off (tests/test_torch_train.py's config) but where said; the
ranks of (c, d) train in fp64 (see ``_jax_case``) and meet through a
``file://`` rendezvous. Each launch has 180 s in all.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from test_torch_train import (RTOL, SMALL, ZERO_GRAD_LEAVES, _config,
                              _numpy_variables)
from transfuser_tpu.data.loader import PrefetchLoader as JaxLoader
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.models.gpt import GPTFusion as JaxGPT
from transfuser_tpu.parallel import sharding as jshd
from transfuser_tpu.train.losses import compute_losses as jax_losses
from transfuser_tpu.train.losses import total_loss as jax_total
from transfuser_tpu.train.trainer import Trainer as JaxTrainer
from transfuser_tpu.train.trainer import _model_inputs as jax_inputs
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.loader import PrefetchLoader
from transfuser_torch.data.pack import unpack_batch
from transfuser_torch.models import LidarCenterNet as PortModel
from transfuser_torch.models.encoders import make_encoder
from transfuser_torch.models.gpt import GPTFusion
from transfuser_torch.parallel import sharding as shd
from transfuser_torch.train import checkpoint
from transfuser_torch.train import trainer as trainer_module
from transfuser_torch.train.jax_import import state_dict_from_jax
from transfuser_torch.train.losses import compute_losses, total_loss
from transfuser_torch.train.trainer import Trainer

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WORKER = str(HERE / "torch_parallel_worker.py")
MESHES = {"data2": (2, 1), "model2": (1, 2), "data2_model2": (2, 2)}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _rendezvous(job_path) -> str:
    """A ``file://`` rendezvous beside a job's file, for its gloo ranks: no
    port to race for."""
    return f"file://{job_path}.store"


class PortTaken(AssertionError):
    """A rank could not bind the coordinator's port (taken since
    ``_free_port`` saw it free)."""


def _launch(argvs, timeout=180):
    """Start every argv at once; all must exit 0 within ``timeout``
    seconds in all (each launch takes well under a minute here)."""
    procs = [subprocess.Popen(a, env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        if p.returncode != 0 and "address already in use" in log.lower():
            raise PortTaken(log[-4000:])
        assert p.returncode == 0, log[-4000:]
    return logs


# ----------------------------------------------------------- (a) rules

def _port_name(path) -> str:
    """A JAX GPTFusion leaf path -> the port's parameter name."""
    keys = [k.key for k in path]
    renames = {"mlp_fc": "mlp.0", "mlp_proj": "mlp.2", "kernel": "weight",
               "scale": "weight"}
    if keys[0].startswith("block_"):
        keys[0] = "blocks." + keys[0][len("block_"):]
    return ".".join(renames.get(k, k) for k in keys)


def _jax_dim(spec) -> object:
    """A leaf's PartitionSpec -> the sharded torch dimension (flax kernels
    are [in, out], torch weights [out, in])."""
    if spec == P():
        return None
    if spec in (P(None, "model"), P("model")):
        return 0
    assert spec == P("model", None), spec
    return 1


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", ["resnet_micro", "regnety_032"],
                         ids=["tiny", "full"])
def test_sharding_rule_equals_jax(arch, size):
    gcfg = GlobalConfig().model.gpt
    mesh = jshd.make_mesh(jshd.MeshSpec(data=size, model=1))
    for width in make_encoder(arch).feature_dims:
        ours = dict(GPTFusion(width, gcfg.n_head, gcfg.n_layer,
                              gcfg.block_exp).named_parameters())
        tokens = (jax.ShapeDtypeStruct((1, 5, 22, width), jnp.float32),
                  jax.ShapeDtypeStruct((1, 8, 8, width), jnp.float32),
                  jax.ShapeDtypeStruct((1, 1), jnp.float32))
        theirs = jax.eval_shape(
            lambda k, *t: JaxGPT(width, gcfg.n_head, gcfg.n_layer,
                                 gcfg.block_exp).init(k, *t),
            jax.random.PRNGKey(0), *tokens)["params"]
        leaves = jax.tree_util.tree_leaves_with_path(theirs)
        assert len(leaves) == len(ours)
        moments = jshd.opt_state_sharding(theirs, None, mesh)
        for (path, leaf), (_, moment) in zip(
                leaves, jax.tree_util.tree_leaves_with_path(moments)):
            name = _port_name(path)
            shape = tuple(ours[name].shape)
            flax = tuple(leaf.shape)
            assert shape == (flax[::-1] if len(flax) == 2 else flax), name
            want = _jax_dim(jshd._spec_for_param(
                tuple(k.key for k in path), leaf.shape, size))
            assert shd.spec_for_param(f"x.{name}", shape, size) == want, name
            assert shd.zero_partitioned(shape, size) == \
                (moment.spec != P()), name


def test_zero_plan_balances_whole_parameters():
    shapes = [(64, 16), (16,), (32, 32), (48, 32), (8, 8, 16)]
    owner = shd.zero_plan(shapes, 2)
    assert owner[1] == -1  # below the size threshold: replicated
    load = [sum(int(np.prod(s)) for s, o in zip(shapes, owner) if o == r)
            for r in (0, 1)]
    assert owner[3] == 0 and owner[2] == 1  # largest first
    assert abs(load[0] - load[1]) <= 1024


# ---------------------------------------------------------- (b) loader

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int32(i)}


@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_equal_jax(count):
    ds = _Indexed(23)
    seen = []
    for rank in range(count):
        for epoch in (0, 1):
            ours = PrefetchLoader(ds, 3, num_workers=2, seed=5,
                                  shard_rank=rank, shard_count=count)
            ref = JaxLoader(ds, 3, num_workers=2, seed=5, shard_rank=rank,
                            shard_count=count)
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert ours._batches() == ref._batches()
            assert len(ours) == len(ref)
            got = [np.asarray(b["i"]).tolist() for b in ours]
            assert got == [np.asarray(b["i"]).tolist() for b in ref]
            if epoch == 0:
                seen += [i for b in got for i in b]
    assert len(seen) == len(set(seen))  # the shards are disjoint


# ------------------------------------------------------- (c, d) a step

def _uneven_batch(cfg):
    batch = synthetic_batch(cfg, 4, seed=3, **SMALL)
    assert (np.abs(batch["label"][:2]).sum(-1) > 0).any()
    batch["label"][2:] = 0.0                         # no boxes
    batch["bev"][2:] = np.where(batch["bev"][2:] == 2, 1, batch["bev"][2:])
    batch["rgb"][2:] *= 0.25                         # other BN statistics
    batch["lidar"][2:] *= 3.0
    return batch


@functools.lru_cache(maxsize=None)
def _jax_case():
    """The JAX mesh trainer's gradient program at data 2 in fp32 (its loss
    dict), and the single-device gradients and BatchNorm statistics in
    fp64. In fp32 on this batch of 4 a ReLU input near 0 can change sign
    with the rounding, and the gradients upstream of it then differ by
    more than tests/test_torch_train.py's 1e-4 per leaf, in either
    framework (``test_fp32_gradients_equal_jax_once_relu_masks_agree``);
    fp64 leaves only the semantics to compare, at that test's
    tolerance."""
    cfg = _config("histogram", grad_clip_norm=0.5, agc_clip=0.05)
    batch = _uneven_batch(cfg)
    mesh = jshd.make_mesh(jshd.MeshSpec(data=2, model=1))
    trainer = JaxTrainer(cfg, mesh=mesh, dtype=jnp.float32)
    args, extra = jax_inputs({k: jnp.asarray(v) for k, v in batch.items()})
    variables = _numpy_variables(jax.eval_shape(
        lambda k: trainer.model.init(k, *args, train=False, **extra),
        jax.random.PRNGKey(0)), seed=0)
    params = jax.device_put(variables["params"], jshd.param_sharding(
        variables["params"], mesh))
    stats = jax.device_put(variables["batch_stats"],
                           jshd.replicated_sharding(
                               variables["batch_stats"], mesh))
    _, loss, detailed, _ = jax.device_get(trainer.train_step.grad_jit(
        params, stats, jnp.zeros((), jnp.int32), trainer.put_batch(batch)))
    with jax.enable_x64():
        model = JaxModel(cfg, dtype=jnp.float64)

        def loss_fn(params, stats, batch):
            args, extra = jax_inputs(batch)
            out, mutated = model.apply(
                {"params": params, "batch_stats": stats}, *args, train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)}, **extra)
            detailed = jax_losses(out, batch, cfg)
            return jax_total(detailed, cfg), mutated["batch_stats"]

        wide = jax.tree.map(
            lambda x: np.asarray(x, np.float64)
            if np.asarray(x).dtype == np.float32 else np.asarray(x),
            {"variables": variables, "batch": batch})
        (_, new_stats), grads = jax.device_get(jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(wide["variables"]["params"],
                                    wide["variables"]["batch_stats"],
                                    wide["batch"]))
    return dict(cfg=cfg, batch=batch, variables=variables,
                loss={"loss_total": float(loss),
                      **{k: float(v) for k, v in detailed.items()}},
                grads=grads, stats=new_stats)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    case = _jax_case()
    d = tmp_path_factory.mktemp("parallel")
    cfg = GlobalConfig.from_json(case["cfg"].to_json())
    (d / "config.json").write_text(cfg.to_json())
    weights = state_dict_from_jax(case["variables"], case["cfg"])
    torch.save(weights, d / "weights.pt")
    np.savez(d / "batch.npz", **case["batch"])
    return d, case, cfg, weights


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, inputs):
    d, case, _, _ = inputs
    data, model = MESHES[request.param]
    world = data * model
    job = dict(config=str(d / "config.json"), weights=str(d / "weights.pt"),
               batch=str(d / "batch.npz"), mesh=[data, model],
               world=world, init_method=_rendezvous(d / request.param),
               steps=3, zero=[True, False] if data > 1 else [True],
               out=str(d / request.param))
    path = d / f"{request.param}.json"
    path.write_text(json.dumps(job))
    _launch([[sys.executable, WORKER, "step", str(path), str(r)]
             for r in range(world)])
    return request.param, [torch.load(f"{job['out']}.{r}.pt",
                                      weights_only=False)
                           for r in range(world)]


def test_loss_dict_equals_jax_mesh_trainer(inputs, ranks):
    case = inputs[1]
    runs = ranks[1]
    for run in runs:
        got = run["zero1"]["loss"]
        assert got == runs[0]["zero1"]["loss"]  # the same on every rank
        assert set(got) == set(case["loss"])
        for k, v in case["loss"].items():
            np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=1e-6,
                                       err_msg=k)


def leaf_errors(grads, case):
    """Each leaf's largest gradient error against the JAX single-device
    fp64 gradients, over the leaf's largest value, and whether it lies
    within tests/test_torch_train.py's per-leaf tolerance."""
    want = state_dict_from_jax({"params": case["grads"],
                                "batch_stats": case["stats"]}, case["cfg"])
    top = max(np.abs(w.numpy()).max() for w in want.values())
    assert set(grads) <= set(want)
    out = {}
    for name, g in grads.items():
        g, w = np.asarray(g, np.float64), want[name].numpy()
        if name.endswith(ZERO_GRAD_LEAVES):
            assert np.abs(g).max() < 1e-6 * top, name
            continue
        scale = np.abs(w).max()
        out[name] = (float(np.abs(g - w).max() / max(scale, 1e-300)),
                     bool(np.allclose(g, w, rtol=RTOL,
                                      atol=max(1e-4 * scale, 1e-7 * top))))
    return out


def test_gradients_equal_jax_single_device(inputs, ranks):
    for run in ranks[1]:
        errors = leaf_errors(run["zero1"]["grads"], inputs[1])
        assert all(ok for _, ok in errors.values()), \
            {k: e for k, (e, ok) in errors.items() if not ok}


def port_gradients(case, dtype, masks, pin=False):
    """The port's one-process gradients of the total loss on the case's
    weights and batch, without an update. Every ReLU (``F.relu``, which
    the port's ``nn.ReLU`` calls too) records its mask (x > 0) into
    ``masks``; with ``pin`` it applies the mask recorded at the same call
    instead of its own. Returns (gradients, count of mask elements that
    differ from this run's own)."""
    relu, calls, flips = F.relu, iter(range(len(masks))), [0]

    def record(x, inplace=False):
        masks.append(x.detach() > 0)
        return relu(x)

    def pinned(x, inplace=False):
        mask = masks[next(calls)]
        flips[0] += int((mask != (x.detach() > 0)).sum())
        return torch.where(mask, x, torch.zeros_like(x))

    cfg = GlobalConfig.from_json(case["cfg"].to_json())
    model = PortModel(cfg, dtype=dtype, device="cpu").to(dtype)
    model.load_state_dict(state_dict_from_jax(case["variables"],
                                              case["cfg"]))
    model.train()
    batch = unpack_batch({k: torch.as_tensor(v)
                          for k, v in case["batch"].items()})
    args, extra = trainer_module._model_inputs(batch)
    F.relu = pinned if pin else record
    try:
        out = model(*args, **extra, compute_aux=True)
        total_loss(compute_losses(out, batch, cfg), cfg).backward()
    finally:
        F.relu = relu
    return {k: p.grad for k, p in model.named_parameters()}, flips[0]


def test_fp32_gradients_equal_jax_once_relu_masks_agree():
    """Why the ranks above train in fp64: the port's fp32 gradients on
    this batch differ from JAX's where a ReLU input lies so near 0 that
    fp32 rounding flips its sign (tests/fp32_gradient_witness.py counts
    them and shows JAX's own fp32 gradients off by as much). With the
    fp64 run's masks, the fp32 gradients equal JAX's fp64 ones per leaf."""
    case, masks = _jax_case(), []
    port_gradients(case, torch.float64, masks)
    grads, flips = port_gradients(case, torch.float32, masks, pin=True)
    assert flips <= 1e-5 * sum(m.numel() for m in masks)
    errors = leaf_errors(grads, case)
    assert all(ok for _, ok in errors.values()), \
        {k: e for k, (e, ok) in errors.items() if not ok}


def test_batchnorm_running_stats_equal_jax(inputs, ranks):
    case, cfg = inputs[1], inputs[1]["cfg"]
    want = state_dict_from_jax({"params": case["variables"]["params"],
                                "batch_stats": case["stats"]}, cfg)
    runs = ranks[1]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert sorted(keys) == sorted(runs[0]["zero1"]["stats"])
    for run in runs:
        for k in keys:
            got = run["zero1"]["stats"][k]
            assert torch.equal(got, runs[0]["zero1"]["stats"][k]), k
            np.testing.assert_allclose(got.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_eval_dict_equals_single_process(inputs, ranks):
    """The eval step on the loaded weights, before any update: the global
    batch's losses and metrics on every rank."""
    _, case, cfg, weights = inputs
    trainer = Trainer(cfg, dtype=torch.float64, device="cpu")
    trainer.model.to(torch.float64).load_state_dict(weights)
    want = {k: float(v) for k, v in
            trainer.eval_step(trainer.put_batch(case["batch"])).items()}
    for run in ranks[1]:
        got = run["zero1"]["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _fp64_trainer(cfg, weights):
    """The port's one process in fp64 (the parameters too), as the
    worker builds its ranks."""
    build = trainer_module.LidarCenterNet
    trainer_module.LidarCenterNet = lambda *a, **kw: build(*a, **kw).double()
    try:
        one = Trainer(cfg, dtype=torch.float64, device="cpu")
    finally:
        trainer_module.LidarCenterNet = build
    one.model.load_state_dict(weights)
    return one


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's one process, fp64, 3 steps on the global batch."""
    _, case, cfg, weights = inputs
    one = _fp64_trainer(cfg, weights)
    for _ in range(3):
        one.train_step(one.put_batch(case["batch"]))
    return {k: v.clone() for k, v in one.model.state_dict().items()}


def test_parameters_after_steps_equal_one_process(ranks, one_process):
    """3 AdamW steps behind global-norm and AGC clipping (both active on
    this batch), whose norms span the tensor-parallel shards."""
    for run in ranks[1]:
        for k, v in run["zero1"]["params"].items():
            np.testing.assert_allclose(v, one_process[k], rtol=1e-7,
                                       atol=1e-10, err_msg=k)


def test_zero1_on_and_off_give_equal_parameters(ranks):
    name, runs = ranks
    if MESHES[name][0] == 1:  # a data axis of 1: nothing to partition
        for run in runs:
            assert run["zero1"]["zero_owned"] == len(run["zero1"]["grads"])
        return
    for run in runs:
        on, off = run["zero1"], run["zero0"]
        assert on["zero_owned"] < off["zero_owned"]
        for k, v in off["params"].items():
            assert torch.equal(on["params"][k], v), k
        assert on["params"].keys() == runs[0]["zero1"]["params"].keys()
        for k, v in runs[0]["zero1"]["params"].items():
            assert torch.equal(on["params"][k], v), k


def test_per_rank_normalisation_would_differ(inputs):
    """The batch discriminates: the mean of the two halves' single-process
    losses is not the global batch's loss."""
    _, case, cfg, weights = inputs
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    trainer.model.load_state_dict(weights)
    halves = [{k: v[i:i + 2] for k, v in case["batch"].items()}
              for i in (0, 2)]
    per_rank = [trainer.eval_step(trainer.put_batch(h)) for h in halves]
    whole = trainer.eval_step(trainer.put_batch(case["batch"]))
    for k in ("loss_center_heatmap", "loss_bev", "loss_wh"):
        mean = (float(per_rank[0][k]) + float(per_rank[1][k])) / 2
        assert abs(mean - float(whole[k])) > 1e-3 * abs(float(whole[k])), k


def test_tensor_parallel_dropout_equals_one_process(inputs, tmp_path):
    """A train step at model 2 with every dropout on equals the one
    process's step from the same generator: each rank keeps its heads'
    slice of the attention-probability mask drawn for all heads, so the
    masks are one device's and the replicated dropouts stay in step."""
    _, case, cfg, weights = inputs
    gpt = dataclasses.replace(cfg.model.gpt, embd_pdrop=0.1, attn_pdrop=0.1,
                              resid_pdrop=0.1)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, gpt=gpt))
    one = _fp64_trainer(cfg, weights)
    loss = {k: float(v) for k, v in
            one.train_step(one.put_batch(case["batch"])).items()}
    no_drop = _fp64_trainer(inputs[2], weights)
    plain = float(no_drop.train_step(
        no_drop.put_batch(case["batch"]))["loss_total"])
    assert abs(loss["loss_total"] - plain) > 1e-6 * abs(plain)  # it drops
    grads = {k: p.grad for k, p in one.model.named_parameters()}
    (tmp_path / "config.json").write_text(cfg.to_json())
    torch.save(weights, tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **case["batch"])
    job = dict(config=str(tmp_path / "config.json"),
               weights=str(tmp_path / "weights.pt"),
               batch=str(tmp_path / "batch.npz"), mesh=[1, 2], world=2,
               init_method=_rendezvous(tmp_path / "job"), steps=1,
               zero=[True], out=str(tmp_path / "rank"))
    (tmp_path / "job.json").write_text(json.dumps(job))
    _launch([[sys.executable, WORKER, "step", str(tmp_path / "job.json"),
              str(r)] for r in range(2)])
    top = max(float(g.abs().max()) for g in grads.values())
    for r in range(2):
        run = torch.load(f"{job['out']}.{r}.pt", weights_only=False)["zero1"]
        for k, v in loss.items():
            np.testing.assert_allclose(run["loss"][k], v, rtol=1e-9,
                                       err_msg=k)
        for k, g in grads.items():
            np.testing.assert_allclose(run["grads"][k], g, rtol=1e-7,
                                       atol=1e-9 * top, err_msg=k)


@pytest.fixture(scope="module")
def resumed(inputs, tmp_path_factory):
    """A checkpoint written by one process after one step, restored at 2
    processes (data 2 with ZeRO-1, then model 2) by the function the
    CLI's ``--load_epoch`` calls; the one process's next step beside."""
    _, case, cfg, weights = inputs
    d = tmp_path_factory.mktemp("resume")
    one = _fp64_trainer(cfg, weights)
    one.train_step(one.put_batch(case["batch"]))
    checkpoint.save_checkpoint(str(d / "run"), one.model, one.optimizer, 1)
    saved = torch.load(d / "run" / "1" / checkpoint.TRAIN_STATE,
                       weights_only=True)
    loss = {k: float(v) for k, v in
            one.train_step(one.put_batch(case["batch"])).items()}
    after = {k: v.clone() for k, v in one.model.state_dict().items()}
    (d / "config.json").write_text(cfg.to_json())
    np.savez(d / "batch.npz", **case["batch"])
    job = dict(config=str(d / "config.json"), ckpt=str(d / "run"), epoch=1,
               batch=str(d / "batch.npz"), meshes=[[2, 1], [1, 2]],
               world=2, init_method=_rendezvous(d / "job"),
               out=str(d / "rank"))
    (d / "job.json").write_text(json.dumps(job))
    _launch([[sys.executable, WORKER, "resume", str(d / "job.json"),
              str(r)] for r in range(2)])
    runs = [torch.load(f"{job['out']}.{r}.pt", weights_only=False)
            for r in range(2)]
    return saved, loss, after, runs


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_one_process_checkpoint_resumes_at_two(resumed, mesh):
    saved, loss, after, runs = resumed
    for ranks in runs:
        run = ranks[mesh]
        assert run["step"] == run["step_count"] == saved["step"] == 1
        if mesh == "2x1":  # ZeRO-1: a rank keeps some moments only
            assert run["zero_owned"] < len(saved["optimizer"]["mu"])
        for k, v in saved["model"].items():
            assert torch.equal(run["restored"][k], v), k
        for m in ("mu", "nu"):
            assert len(run[m]) == len(saved["optimizer"][m])
            for got, want in zip(run[m], saved["optimizer"][m]):
                assert torch.equal(got, want), m
        for k, v in loss.items():
            np.testing.assert_allclose(run["loss"][k], v, rtol=1e-9,
                                       err_msg=k)
        for k, v in after.items():
            np.testing.assert_allclose(run["params"][k], v, rtol=1e-7,
                                       atol=1e-10, err_msg=k)


def test_pillars_data_parallel_equals_one_process(tmp_path):
    """PointPillars at data 2 against the port's one process on the whole
    batch (itself held to JAX by tests/test_torch_train.py), fp64: the
    PointNet's BatchNorm stays unmasked across ranks (every rank's B*N
    points, padding included, enter the global statistics)."""
    cfg = GlobalConfig.from_json(_config("pillars").to_json())
    batch = _uneven_batch(cfg)
    rng = np.random.default_rng(4)
    xy = batch["lidar_raw"][..., :2]
    xy[:] = rng.uniform(-6, 6, xy.shape) + np.array([0.0, -4.0])
    batch["num_points"][2:] //= 3  # more padding on the second rank
    one = Trainer(cfg, dtype=torch.float64, device="cpu", seed=1)
    one.model.to(torch.float64)
    weights = {k: v.clone() for k, v in one.model.state_dict().items()}
    loss = {k: float(v) for k, v in
            one.train_step(one.put_batch(batch)).items()}
    grads = {k: p.grad for k, p in one.model.named_parameters()}
    (tmp_path / "config.json").write_text(cfg.to_json())
    torch.save(weights, tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    job = dict(config=str(tmp_path / "config.json"),
               weights=str(tmp_path / "weights.pt"),
               batch=str(tmp_path / "batch.npz"), mesh=[2, 1], world=2,
               init_method=_rendezvous(tmp_path / "job"), steps=1,
               zero=[True], out=str(tmp_path / "rank"))
    (tmp_path / "job.json").write_text(json.dumps(job))
    _launch([[sys.executable, WORKER, "step", str(tmp_path / "job.json"),
              str(r)] for r in range(2)])
    top = max(float(g.abs().max()) for g in grads.values())
    for r in range(2):
        run = torch.load(f"{job['out']}.{r}.pt", weights_only=False)["zero1"]
        for k, v in loss.items():
            np.testing.assert_allclose(run["loss"][k], v, rtol=1e-9,
                                       err_msg=k)
        for k, g in grads.items():
            np.testing.assert_allclose(run["grads"][k], g, rtol=1e-7,
                                       atol=1e-9 * top, err_msg=k)
        stats = run["stats"]
        assert "point_pillar_net.point_net.net.1.running_var" in stats
        for k, v in stats.items():
            np.testing.assert_allclose(v, one.model.state_dict()[k],
                                       rtol=1e-9, atol=1e-12, err_msg=k)
