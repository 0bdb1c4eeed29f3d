"""The port's checkpoints against the JAX package's: the flax msgpack codec
(read and written), the weight bridge in both directions, forward parity
of weights exported by either package in the other, and the train state
(round trip, asynchronous writer, resume in a fresh process)."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from test_full_import import _parity_config
from test_torch_forward_ego import _inputs, _torch_args
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from test_torch_train import _numpy_variables
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train import checkpoint as jax_ckpt
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train import checkpoint
from transfuser_torch.train.jax_import import (state_dict_from_jax,
                                               variables_from_state_dict)
from transfuser_torch.train.trainer import Trainer

RTOL, ATOL = 1e-3, 1e-4
TESTS = Path(__file__).resolve().parent
SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))


def _config(pillars=False, dropout=None):
    """The parity shapes with natively trained weights (no reference
    view-unpack quirk); pillars on a 64 x 64 canvas."""
    cfg = _parity_config()
    gpt = dataclasses.replace(cfg.model.gpt, reference_view_unpack=False)
    if dropout is not None:
        gpt = dataclasses.replace(gpt, embd_pdrop=dropout,
                                  attn_pdrop=dropout, resid_pdrop=dropout)
    model = dataclasses.replace(cfg.model, gpt=gpt)
    if pillars:
        model = dataclasses.replace(model, point_pillars=dataclasses.replace(
            model.point_pillars, use_point_pillars=True,
            max_lidar_points=500, min_x=-4.0, max_x=4.0, min_y=-8.0,
            max_y=0.0))
    return cfg.replace(model=model)


def _port_config(cfg):
    return GlobalConfig.from_json(cfg.to_json())


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, v in want.items():
        g = got[path]
        assert np.asarray(g).dtype == np.asarray(v).dtype, path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(v),
                                      err_msg="/".join(path))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model at the parity shapes, seeded numpy variables with
    non-trivial BatchNorm statistics, and its jitted forward."""
    cfg = _config()
    x = _inputs()
    args = [jnp.asarray(x[k]) for k in ("rgb", "lidar", "tp", "tpi", "vel")]
    jm = JaxModel(cfg, dtype=jnp.float32)
    variables = _numpy_variables(jax.eval_shape(
        lambda key: jm.init(key, *args, train=False), jax.random.PRNGKey(2)),
        seed=2)
    forward = jax.jit(lambda v: jm.apply(v, *args, train=False,
                                         compute_aux=False))
    return cfg, variables, forward, x


def _port_forward(tm, x):
    with torch.no_grad():
        return tm(*_torch_args(x))


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# ------------------------------------------------------------------ msgpack

def test_msgpack_read_equals_flax(tmp_path, jax_side):
    _, variables, _, _ = jax_side
    path = str(tmp_path / "model_0.msgpack")
    jax_ckpt.save_inference_weights(path, variables)
    want = serialization.msgpack_restore(Path(path).read_bytes())
    _assert_trees_equal(checkpoint.load_inference_weights(path), want)


def test_flax_restores_the_port_written_file(tmp_path, jax_side):
    cfg, variables, _, _ = jax_side
    tm = LidarCenterNet(_port_config(cfg), dtype=torch.float32,
                        device="cpu", seed=4)
    ours = variables_from_state_dict(tm.state_dict(), cfg)
    path = str(tmp_path / "model_1.msgpack")
    checkpoint.save_inference_weights(path, ours)
    # the JAX package writes the same bytes for the same tree
    jax_path = str(tmp_path / "model_2.msgpack")
    jax_ckpt.save_inference_weights(jax_path, ours)
    assert Path(path).read_bytes() == Path(jax_path).read_bytes()
    restored = jax_ckpt.load_inference_weights(path, variables)
    _assert_trees_equal(jax.device_get(restored), ours)


def test_msgpack_scalars_chunks_and_refusals(monkeypatch):
    from transfuser_torch.train import flax_msgpack

    tree = {"a": {"k": np.arange(40, dtype=np.float32).reshape(8, 5),
                  "n": np.int32(-7)},
            "b": {"f": np.float64(2.5), "u": np.ones(3, np.uint8)}}
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = flax_msgpack.encode(tree)
    assert blob == serialization.msgpack_serialize(tree)
    _assert_trees_equal(flax_msgpack.decode(blob),
                        serialization.msgpack_restore(blob))
    with pytest.raises(ValueError, match="flax subset"):
        flax_msgpack.encode({"x": 1.5})
    with pytest.raises(ValueError, match="flax subset"):
        flax_msgpack.decode(b"\xc0")  # nil
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.decode(blob + b"\x00")


# ------------------------------------------------------------- weight bridge

@pytest.mark.parametrize("pillars", [False, True],
                         ids=["histogram", "pillars"])
def test_bridge_round_trips_are_exact(pillars):
    """port -> flax -> port is bit-exact, and the flax tree has exactly the
    JAX model's paths and shapes."""
    cfg = _config(pillars=pillars)
    tm = LidarCenterNet(_port_config(cfg), dtype=torch.float32, device="cpu",
                        seed=3)
    with torch.no_grad():  # non-trivial running statistics
        for name, buf in tm.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    state = tm.state_dict()
    variables = variables_from_state_dict(state, cfg)
    back = state_dict_from_jax(variables, cfg)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k

    batch = synthetic_batch(_port_config(cfg), 1, **SMALL)
    jm = JaxModel(cfg, dtype=jnp.float32)
    lidar = batch["lidar_raw"] if pillars else batch["lidar"]
    extra = {"num_points": batch["num_points"]} if pillars else {}
    shapes = jax.eval_shape(lambda k: jm.init(
        k, batch["rgb"], lidar, batch["target_point"],
        batch["target_point_image"], batch["speed"], train=False, **extra),
        jax.random.PRNGKey(0))
    for col in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in _leaves(
            jax.tree.map(lambda a: a, {k: dict(v) for k, v in
                                       shapes.items()})[col])}
        got = {p: a.shape for p, a in _leaves(variables[col])}
        assert got == want, col


# ---------------------------------------------------------- forward parity

def test_jax_written_weights_drive_the_port(tmp_path, jax_side):
    cfg, variables, forward, x = jax_side
    path = str(tmp_path / "model_0.msgpack")
    jax_ckpt.save_inference_weights(path, variables)
    pcfg = _port_config(cfg)
    tm = LidarCenterNet(pcfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(
        checkpoint.load_inference_weights(path), pcfg), strict=True)
    _assert_close(_port_forward(tm, x), forward(variables))


def test_port_written_weights_drive_jax(tmp_path, jax_side):
    cfg, variables, forward, x = jax_side
    pcfg = _port_config(cfg)
    tm = LidarCenterNet(pcfg, dtype=torch.float32, device="cpu", seed=6)
    with torch.no_grad():
        for name, buf in tm.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    path = str(tmp_path / "model_0.msgpack")
    checkpoint.save_inference_weights(
        path, variables_from_state_dict(tm.state_dict(), pcfg))
    theirs = jax_ckpt.load_inference_weights(path, variables)
    _assert_close(_port_forward(tm, x), forward(theirs))


# --------------------------------------------------------------- train state

@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(_port_config(_config()), 2, seed=3, **SMALL)


def _trainer(seed):
    cfg = _port_config(_config(dropout=0.0))
    return Trainer(cfg, steps_per_epoch=1, dtype=torch.float32,
                   device="cpu", seed=seed)


def _assert_state_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.optimizer.step_count == b.optimizer.step_count
    for name in ("mu", "nu"):
        for x, y in zip(getattr(a.optimizer, name),
                        getattr(b.optimizer, name)):
            assert torch.equal(x, y), name


def test_train_state_round_trip_is_exact(tmp_path, batch):
    trained = _trainer(seed=1)
    trained.train_epoch([batch])
    path = checkpoint.save_checkpoint(str(tmp_path), trained.model,
                                      trained.optimizer, epoch=3)
    assert path == str(tmp_path / "3")
    assert checkpoint.list_ensemble_weights(str(tmp_path)) == []
    fresh = _trainer(seed=2)
    step = checkpoint.restore_checkpoint(str(tmp_path), 3, fresh.model,
                                         fresh.optimizer)
    assert step == 1
    _assert_state_equal(fresh, trained)


def test_async_writer_returns_before_the_write(tmp_path, batch, monkeypatch):
    trained = _trainer(seed=1)
    trained.train_epoch([batch])
    gate = threading.Event()
    write = checkpoint.write_state

    def gated(*args):
        gate.wait(10)
        return write(*args)

    monkeypatch.setattr(checkpoint, "write_state", gated)
    fresh = _trainer(seed=2)
    saved = {k: v.clone() for k, v in trained.model.state_dict().items()}
    with checkpoint.AsyncCheckpointWriter(str(tmp_path)) as ckpt:
        ckpt.save(1, trained.model, trained.optimizer)
        assert not (tmp_path / "1").exists()  # save returned first
        # the snapshot is a copy: training on does not change what is saved
        trained.train_epoch([batch])
        threading.Timer(0.2, gate.set).start()
        t0 = time.perf_counter()
        ckpt.restore(1, fresh.model, fresh.optimizer)  # waits for the write
        assert time.perf_counter() - t0 >= 0.1
        assert ckpt.saves[0]["done_s"] >= ckpt.saves[0]["return_s"]
    assert fresh.optimizer.step_count == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert not torch.equal(trained.model.output.weight, saved["output.weight"])


def test_cross_process_resume_continues_the_run(tmp_path, batch):
    """A run checkpoints after step 1 in one process and takes step 2; a
    fresh process restores the checkpoint and takes the same step 2."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(_port_config(_config(dropout=0.0)).to_json())
    logdir = str(tmp_path / "run")
    script = f"""
import json, sys
sys.path.insert(0, {str(TESTS.parent)!r})
import torch
torch.set_num_threads(2)
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.train.checkpoint import AsyncCheckpointWriter
from transfuser_torch.train.trainer import Trainer
cfg = GlobalConfig.from_json(open({str(cfg_path)!r}).read())
batch = synthetic_batch(cfg, 2, seed=3, img_hw=(64, 128), lidar_hw=(64, 64),
                        bev_hw=(40, 40))
trainer = Trainer(cfg, steps_per_epoch=1, dtype=torch.float32, device="cpu",
                  seed=5)
trainer.train_epoch([batch])
with AsyncCheckpointWriter({logdir!r}) as ckpt:
    ckpt.save(1, trainer.model, trainer.optimizer)
print("NEXT", json.dumps(trainer.train_epoch([batch])))
"""
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    uninterrupted = json.loads(proc.stdout.split("NEXT", 1)[1])

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        resumed = _trainer(seed=111)
        with checkpoint.AsyncCheckpointWriter(logdir) as ckpt:
            ckpt.restore(1, resumed.model, resumed.optimizer)
        got = resumed.train_epoch([batch])
    finally:
        torch.set_num_threads(before)
    assert got == uninterrupted
    assert os.listdir(logdir) == ["1"]
