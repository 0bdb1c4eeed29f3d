"""The port's HybridAgent in its one-frame-lag modes (``pipelined_fetch``,
``async_inference``), on the CPU at the tiny config of
tests/test_torch_agent.py, over the replay route of
tests/test_hybrid_agent.py's lag-mode tests.

  * pipelined, in lockstep with the JAX agent in the same mode: the same
    priming frame, equal action repeats, the same GPS buffer, waypoints
    within the bf16 bound of test_torch_agent.py on every compute frame;
  * async controls equal to pipelined ones, and both lagged waypoint
    streams equal to the synchronous one shifted by one compute frame,
    exactly (the replay ego does not move, so the inputs do not depend
    on the controls);
  * a worker exception re-raised on the control thread, and ``destroy``
    closing the worker.
"""

import dataclasses
import sys

import numpy as np
import pytest

from test_torch_agent import WP_ATOL, WP_RTOL, _model_dir
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.agents.hybrid_agent import HybridAgent as JaxAgent
from transfuser_tpu.harness import route_parser as jax_routes
from transfuser_tpu.sim.types import Location as JaxLocation
from transfuser_tpu.sim.types import Transform as JaxTransform
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.harness import route_parser
from transfuser_torch.harness.evaluator import default_sensor_feeder
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.sim.replay import ReplaySimulation
from transfuser_torch.sim.types import Location, Transform

TICKS = 10  # 5 compute frames


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory.mktemp("lag"))[1]


def _set_mode(agent, **ctrl):
    agent.config = agent.config.replace(controller=dataclasses.replace(
        agent.config.controller, **ctrl))
    return agent


def _plan(routes, location, transform):
    traj = [transform(location(float(x), 0.0)) for x in range(0, 100, 10)]
    world = [(t, routes.RoadOption.LANEFOLLOW) for t in traj]
    return routes.location_route_to_gps(world), world


@pytest.fixture(scope="module")
def frames(model_dir):
    """The replay route's sensor dicts, as the port's harness feeds them
    (tests/test_hybrid_agent.py:185-223)."""
    port_sensors._NOISE_POOLS.clear()
    traj = [Transform(Location(float(x), 0.0)) for x in range(0, 100, 10)]
    sim = ReplaySimulation(traj, fps=20)
    probe = HybridAgent(model_dir, device="cpu")
    for spec in probe.sensors():
        probe.sensor_interface.register_sensor(spec["id"], spec["type"])
    frames = []
    for _ in range(TICKS):
        default_sensor_feeder(sim, probe)
        frames.append((dict(probe.sensor_interface.get_data().copy()),
                       sim.game_time))
        sim.tick()
    return frames


def _drive(agent, frames):
    """Controls and the waypoints of every compute frame (None while the
    pipe primes)."""
    agent.set_global_plan(*_plan(route_parser, Location, Transform))
    controls, wps = [], []
    for data, t in frames:
        controls.append(agent.run_step(dict(data), t))
        if agent.step % 2 == 0:
            wps.append(None if agent.pred_wp is None
                       else agent.pred_wp.copy())
    return controls, wps


def test_pipelined_agent_matches_jax_pipelined_agent(model_dir, frames):
    ours = _set_mode(HybridAgent(model_dir, device="cpu"),
                     pipelined_fetch=True)
    ref = _set_mode(JaxAgent(model_dir), pipelined_fetch=True)
    ours.set_global_plan(*_plan(route_parser, Location, Transform))
    ref.set_global_plan(*_plan(jax_routes, JaxLocation, JaxTransform))
    c_ours, c_ref = [], []
    for i, (data, t) in enumerate(frames):
        c_ours.append(ours.run_step(dict(data), t))
        c_ref.append(ref.run_step(dict(data), t))
        assert len(ours.gps_buffer) == len(ref.gps_buffer) == i + 1
        if i == 0:  # priming: the held control, a forward pending
            for c in (c_ours[0], c_ref[0]):
                assert (c.steer, c.throttle, c.brake) == (0.0, 0.0, 1.0)
            assert ours._pending is not None and ref._pending is not None
            assert ours.pred_wp is None and ref.pred_wp is None
        elif i % 2 == 0:
            np.testing.assert_allclose(ours.pred_wp, ref.pred_wp,
                                       rtol=WP_RTOL, atol=WP_ATOL,
                                       err_msg=f"tick {i}")
    for controls in (c_ours, c_ref):  # action repeat: two frames each
        for k in range(0, TICKS, 2):
            assert controls[k + 1] is controls[k]
    np.testing.assert_allclose(np.stack(list(ours.gps_buffer.buffer)),
                               np.stack(list(ref.gps_buffer.buffer)),
                               rtol=0, atol=WP_ATOL)


def test_lag_modes_shift_the_synchronous_stream(model_dir, frames):
    _, sync_wp = _drive(HybridAgent(model_dir, device="cpu"), frames)
    lagged = {}
    interval = sys.getswitchinterval()
    for mode in ("pipelined_fetch", "async_inference"):
        agent = _set_mode(HybridAgent(model_dir, device="cpu"),
                          **{mode: True})
        # the worker and the control thread share the frame slots: switch
        # between them as often as the interpreter allows
        sys.setswitchinterval(1e-6)
        try:
            lagged[mode] = _drive(agent, frames)
        finally:
            sys.setswitchinterval(interval)
        assert (agent._worker is not None) == (mode == "async_inference")
        agent.destroy()
        assert agent._worker is None
    (pipe_c, pipe_wp), (async_c, async_wp) = lagged.values()
    as_tuples = [[(c.steer, c.throttle, c.brake) for c in cs]
                 for cs in (pipe_c, async_c)]
    assert as_tuples[0] == as_tuples[1]
    assert as_tuples[0][0] == (0.0, 0.0, 1.0)  # the priming frame
    assert pipe_wp[0] is None and async_wp[0] is None
    for k in range(1, len(sync_wp)):
        np.testing.assert_array_equal(pipe_wp[k], sync_wp[k - 1])
        np.testing.assert_array_equal(async_wp[k], sync_wp[k - 1])


def test_worker_exception_reraised_and_destroy_closes(model_dir, frames):
    agent = _set_mode(HybridAgent(model_dir, device="cpu"),
                      async_inference=True)
    agent.set_global_plan(*_plan(route_parser, Location, Transform))

    def broken(*args):
        raise RuntimeError("forward failed on the worker")

    agent.members[0].forward_ego = broken
    agent.run_step(dict(frames[0][0]), frames[0][1])  # primes, no raise
    agent.run_step(dict(frames[1][0]), frames[1][1])  # action repeat
    with pytest.raises(RuntimeError, match="forward failed on the worker"):
        agent.run_step(dict(frames[2][0]), frames[2][1])
    thread = agent._worker._thread
    assert thread.is_alive()
    agent.destroy()
    assert agent._worker is None and not thread.is_alive()
