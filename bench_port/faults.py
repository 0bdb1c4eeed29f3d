"""Faults planted in the program from outside, to see ``correct`` come out
false: the harness's tests and ``calibrate.py --fault`` use them; the
benchmark's own runs never do. Each patches a method of the port's
classes for the duration of a ``with planted(name):`` block.

* "unchanged": AdamW's step does nothing (a step that returns its state
  unchanged);
* "half_batch": every train step trains on the first half of its rows
  (the mean taken over the rest);
* "stale_batch": from the ``after``-th train step on, every step gets the
  batch of that step again (a captured graph that keeps one batch's
  pointers);
* "answer": every waypoint that a model's ``forward_ego`` returns is
  moved by 0.5 m (an answer altered where it is produced);
* "control": the steer that the agent's ``run_step`` returns is moved by
  0.01.
"""

from __future__ import annotations

import contextlib

from . import generate

NAMES = ("unchanged", "half_batch", "stale_batch", "answer", "control")


def _patch(stack, owner, name, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    stack.callback(setattr, owner, name, old)


@contextlib.contextmanager
def planted(name: str, after: int = 4):
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; faults: {NAMES}")
    with contextlib.ExitStack() as stack:
        if name == "unchanged":
            from transfuser_torch.train.train_state import AdamW

            _patch(stack, AdamW, "step", lambda self: None)
        elif name in ("half_batch", "stale_batch"):
            from transfuser_torch.train import trainer

            make = trainer.make_train_step

            def broken(*args, **kwargs):
                step = make(*args, **kwargs)
                calls = [0, None]

                def train_step(batch):
                    if name == "half_batch":
                        return step(generate.half_rows(batch))
                    calls[0] += 1
                    if calls[0] == after:
                        calls[1] = batch
                    return step(calls[1] if calls[0] >= after else batch)

                return train_step

            _patch(stack, trainer, "make_train_step", broken)
        elif name == "answer":
            from transfuser_torch.models.lidar_centernet import LidarCenterNet

            forward_ego = LidarCenterNet.forward_ego

            def moved(self, *args, **kwargs):
                wp, boxes, labels = forward_ego(self, *args, **kwargs)
                return wp + 0.5, boxes, labels

            _patch(stack, LidarCenterNet, "forward_ego", moved)
        else:
            from transfuser_torch.agents.hybrid_agent import HybridAgent

            run_step = HybridAgent.run_step

            def steered(self, *args, **kwargs):
                c = run_step(self, *args, **kwargs)
                return type(c)(steer=c.steer + 0.01, throttle=c.throttle,
                               brake=c.brake)

            _patch(stack, HybridAgent, "run_step", steered)
        yield
