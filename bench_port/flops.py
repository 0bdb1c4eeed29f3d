"""Floating-point operations of the reference model, counted from shapes
on the meta device: the benchmark's own frozen copy of the formulas the
port's ``ops/flops.py`` reads (PyTorch's ``flop_registry``, with the
port's rule for a grouped convolution's backward). Two operations per
multiply-add; elementwise work, normalisation, reductions, resizes and
the optimizer count nothing. The model is the run's reference module's
(``harness.reference``); its ``_resizing`` counter marks the resizes.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference import train as ref_train

aten = torch.ops.aten


def _mm(a, b, *_, **__):
    m, k = a.shape
    return 2 * m * k * b.shape[1]


def _addmm(bias, a, b, *_, **__):
    return _mm(a, b)


def _bmm(a, b, *_, **__):
    n, m, k = a.shape
    return 2 * n * m * k * b.shape[2]


def _baddbmm(bias, a, b, *_, **__):
    return _bmm(a, b)


def conv_flops(x_shape, w_shape, out_shape, transposed=False) -> int:
    """2 x batch x output positions x the weight's size (Cout x Cin/groups
    x kernel); a transposed convolution counts its input positions."""
    spatial = x_shape[2:] if transposed else out_shape[2:]
    return 2 * x_shape[0] * math.prod(spatial) * math.prod(w_shape)


def _conv(x, w, bias, stride, padding, dilation, transposed, *_, out=None,
          **__):
    return conv_flops(x.shape, w.shape, out.shape, transposed)


def _conv_backward(grad_out, x, w, bias_sizes, stride, padding, dilation,
                   transposed, output_padding, groups, mask, out=None, **__):
    """Each gradient asked for costs what the forward costs (PyTorch's own
    formula counts a grouped convolution's weight gradient groups times)."""
    fwd = conv_flops(x.shape, w.shape, grad_out.shape, transposed)
    return fwd * (int(mask[0]) + int(mask[1]))


FORMULAS = {
    aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _bmm,
    aten.baddbmm: _baddbmm, aten.convolution: _conv,
    aten._convolution: _conv, aten.convolution_backward: _conv_backward,
}


class FlopCounter(TorchDispatchMode):
    """Counts the operations run inside it; with ``ref``, none while that
    reference module's resize runs (its ``_resizing`` counter)."""

    def __init__(self, ref=None):
        super().__init__()
        self.counts = defaultdict(int)
        self.resizing = [0] if ref is None else ref._resizing

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = FORMULAS.get(func._overloadpacket)
        if f is not None and not self.resizing[0]:
            self.counts[func._overloadpacket.__name__] += int(
                f(*args, **kwargs, out=out))
        return out


def _meta_inputs(cfg, batch: int, train: bool):
    s, m = cfg.sensors, cfg.model
    h, w = s.img_resolution
    lh, lw = s.lidar_resolution_height, s.lidar_resolution_width
    kw = dict(device="meta")
    pp = m.point_pillars
    x = dict(rgb=torch.empty(batch, h, w, 3, **kw),
             target_point=torch.empty(batch, 2, **kw),
             target_point_image=torch.empty(batch, lh, lw, 1, **kw),
             speed=torch.empty(batch, **kw))
    if pp.use_point_pillars:
        x["lidar_raw"] = torch.empty(batch, pp.max_lidar_points, 4, **kw)
        x["num_points"] = torch.empty(batch, dtype=torch.int32, **kw)
    else:
        x["lidar"] = torch.empty(batch, lh, lw, 2, **kw)
    if train:
        bev = (cfg.bev.bev_resolution_height, cfg.bev.bev_resolution_width)
        x.update(ego_waypoint=torch.empty(batch, m.pred_len, 2, **kw),
                 label=torch.empty(batch, m.centernet.max_label_boxes, 7,
                                   **kw),
                 bev=torch.empty(batch, *bev, dtype=torch.long, **kw),
                 depth=torch.empty(batch, h, w, **kw),
                 semantic=torch.empty(batch, h, w, dtype=torch.long, **kw))
    return x


def forward_flops(ref, cfg, batch: int = 1) -> int:
    """One eval forward of the model that the reference module ``ref``
    builds (``forward_ego``'s network)."""
    model = ref.build(cfg, "meta")
    with FlopCounter(ref) as c, torch.no_grad():
        model(**ref_train.model_inputs(_meta_inputs(cfg, batch, False)))
    return c.total


def train_step_flops(ref, cfg, batch: int) -> int:
    """One training step of ``ref``'s model: forward with the auxiliary
    maps, the loss, and the backward."""
    model = ref.build(cfg, "meta").train()
    x = _meta_inputs(cfg, batch, True)
    with FlopCounter(ref) as c:
        out = model(**ref_train.model_inputs(x), compute_aux=True)
        ref_train.total(ref_train.losses(out, x, cfg), cfg).backward()
    return c.total
