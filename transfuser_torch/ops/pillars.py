"""Dynamic-pillar voxelization (counterpart of transfuser_tpu/ops/pillars.py;
reference team_code_transfuser/point_pillar.py:37-122).

Batched where the JAX package vmaps over samples: the (B, N) cell ids of
a batch are offset by ``b * (num_cells + 1)`` into one flat id space, so a
whole batch is one ``segment_mean`` and one ``segment_max``. Invalid
(padding or out-of-range) points go to each sample's sentinel cell,
``num_cells``, which ``scatter_to_canvas`` slices away.

``segment_max`` is the pillar pooling. On a CUDA tensor it launches the
hand-written kernel ``csrc/scatter_max.cu`` (the port of the Pallas
probe experiments/pallas_scatter_max.py, and of the XLA scatter-max the
JAX package runs) or raises; on a CPU tensor it computes the same
function with ``reference_segment_max``, the plain version the tests and
``chip_smoke.py`` hold the kernel against. Both sit inside one
``autograd.Function`` whose backward is JAX's VJP of ``.at[].max``: a
segment's gradient is split evenly among all the points that tie for its
max.

``segment_mean`` stays ordinary PyTorch (``index_add_``), as it was an
XLA scatter-add, not a Pallas kernel, in the JAX package. On CUDA its
float atomics make it not bitwise deterministic from run to run.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels

NEG_INF = -1e30
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p]


def pillar_cells(points: torch.Tensor, num_points: torch.Tensor,
                 min_x: float, max_x: float, min_y: float, max_y: float,
                 pixels_per_meter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (B, N, 4), num_points (B,) -> (cell_ids (B, N) int32,
    valid (B, N) bool). Invalid points get the sentinel id ny*nx."""
    n = points.shape[1]
    nx = int((max_x - min_x) * pixels_per_meter)
    ny = int((max_y - min_y) * pixels_per_meter)
    idx = torch.arange(n, device=points.device)
    x, y = points[..., 0], points[..., 1]
    in_range = (x >= min_x) & (x < max_x) & (y >= min_y) & (y < max_y)
    valid = in_range & (idx[None] < num_points.reshape(-1, 1))
    cx = torch.floor((x - min_x) * pixels_per_meter).to(torch.int32)
    cy = torch.floor((y - min_y) * pixels_per_meter).to(torch.int32)
    cell = cy.clamp(0, ny - 1) * nx + cx.clamp(0, nx - 1)
    return torch.where(valid, cell, ny * nx).to(torch.int32), valid


def flat_ids(cell_ids: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(B, N) per-sample ids -> (B*N,) ids into B blocks of num_cells+1."""
    b = cell_ids.shape[0]
    offset = torch.arange(b, device=cell_ids.device,
                          dtype=torch.int32) * (num_cells + 1)
    return (cell_ids + offset[:, None]).reshape(-1)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean of values (N, C) -> (num_segments, C); 0 where
    empty."""
    sums = values.new_zeros((num_segments, values.shape[-1]))
    sums = sums.index_add(0, segment_ids, values)
    counts = values.new_zeros((num_segments, 1)).index_add(
        0, segment_ids, values.new_ones((values.shape[0], 1)))
    return sums / counts.clamp_min(1.0)


def reference_segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: max from NEG_INF, then entries <= NEG_INF/2
    (empty segments) set to 0, as the JAX package's segment_max."""
    out = values.new_full((num_segments, values.shape[-1]), NEG_INF)
    out = out.index_reduce(0, segment_ids, values, "amax", include_self=True)
    return torch.where(out <= NEG_INF / 2, torch.zeros_like(out), out)


def _check(values: torch.Tensor, segment_ids: torch.Tensor,
           num_segments: int) -> None:
    if values.dim() != 2 or segment_ids.shape != values.shape[:1]:
        raise ValueError(
            f"segment_max takes values (N, C) and ids (N,); got "
            f"{tuple(values.shape)} and {tuple(segment_ids.shape)}")
    if values.dtype != torch.float32 or segment_ids.dtype != torch.int32:
        raise TypeError(f"the scatter-max kernel takes float32 values and "
                        f"int32 ids; got {values.dtype}, {segment_ids.dtype}")
    if values.device != segment_ids.device:
        raise ValueError("values and ids must be on one device")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("the scatter-max kernel needs contiguous values "
                         "and ids")
    if num_segments < 1 or values.shape[1] < 1:
        raise ValueError(f"need num_segments >= 1 and C >= 1; got "
                         f"{num_segments}, {values.shape[1]}")


def _segment_max_forward(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    if values.device.type == "cpu":
        return reference_segment_max(values, segment_ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_max runs on CUDA or CPU, not "
                         f"{values.device}")
    _check(values, segment_ids, num_segments)
    fn = kernels.function("scatter_max", "tf_scatter_max_forward", _ARGTYPES)
    n, c = values.shape
    # the canvas, then the kernel's touched-cell bitmap (one bit per cell)
    buf = torch.empty(num_segments * c + (num_segments + 31) // 32,
                      dtype=values.dtype, device=values.device)
    out = buf[:num_segments * c].view(num_segments, c)
    args = (values.data_ptr(), segment_ids.data_ptr(), buf.data_ptr(), n, c,
            num_segments)
    err = kernels.call(fn, values.device, *args)
    if err != 0:
        raise RuntimeError(f"scatter-max kernel launch failed: CUDA error "
                           f"{err} at N={n}, C={c}, S={num_segments}")
    kernels.count_launch("scatter_max")
    return out


def tie_split_grad(values: torch.Tensor, segment_ids: torch.Tensor,
                   out: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """JAX's VJP of ``.at[].max`` followed by the empty-segment fill: each
    segment's gradient split evenly among the points equal to its max. A
    filled segment's points (NEG_INF) equal no output, so get none."""
    at = out.index_select(0, segment_ids)
    tie = values == at
    count = torch.zeros_like(out).index_add_(0, segment_ids, tie.to(out.dtype))
    share = grad_out.index_select(0, segment_ids) / \
        count.index_select(0, segment_ids).clamp_min(1.0)
    return torch.where(tie, share, torch.zeros_like(share))


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, num_segments):
        out = _segment_max_forward(values, segment_ids, num_segments)
        ctx.save_for_backward(values, segment_ids, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        values, segment_ids, out = ctx.saved_tensors
        return tie_split_grad(values, segment_ids, out, grad_out), None, None


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max of float32 values (N, C) with int32 ids (N,) ->
    (num_segments, C); empty segments 0. Differentiable."""
    return _SegmentMax.apply(values, segment_ids, num_segments)


def decorate_points(points: torch.Tensor, cell_ids: torch.Tensor,
                    valid: torch.Tensor, num_cells: int, min_x: float,
                    min_y: float, nx: int,
                    pixels_per_meter: int) -> torch.Tensor:
    """9-feature decoration (point_pillar.py:54-67), batched: points
    (B, N, 4) -> (B, N, 9) [x y z i, cluster-offset xyz, center-offset
    xy], zero for invalid points."""
    b, n, _ = points.shape
    xyz = points[..., :3]
    ids = flat_ids(cell_ids, num_cells)
    masked = torch.where(valid[..., None], xyz, torch.zeros_like(xyz))
    means = segment_mean(masked.reshape(b * n, 3), ids,
                         b * (num_cells + 1))
    cluster = xyz - means.index_select(0, ids).reshape(b, n, 3)
    cx = (cell_ids % nx).to(points.dtype) / pixels_per_meter + min_x
    cy = torch.div(cell_ids, nx, rounding_mode="floor").to(points.dtype) \
        / pixels_per_meter + min_y
    xp = xyz[..., 0:1] - cx[..., None]
    yp = xyz[..., 1:2] - cy[..., None]
    feats = torch.cat([points, cluster, xp, yp], dim=-1)
    return torch.where(valid[..., None], feats, torch.zeros_like(feats))


def scatter_to_canvas(pillar_feats: torch.Tensor, ny: int,
                      nx: int) -> torch.Tensor:
    """(B, num_cells+1, C) -> (B, ny, nx, C) dense canvas with the
    reference's vertical flip (canvas row = ny-1-cy, point_pillar.py:93-96)."""
    b = pillar_feats.shape[0]
    return pillar_feats[:, :-1].reshape(b, ny, nx, -1).flip(1)
