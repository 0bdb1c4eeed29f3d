"""The (data x model) process mesh and its placement rules (counterpart of
transfuser_tpu/parallel/sharding.py).

The reference trains with DDP, SyncBatchNorm and ZeRO-1
(train.py:132-140). The JAX package gets all three, and a Megatron
tensor-parallel GPT, from one GSPMD mesh, with global-batch semantics: a
step under a mesh computes what one device computes on the whole batch.
The port keeps those semantics with explicit process groups, one rank per
device:

  * data parallel: ``DistributedDataParallel`` over the data group
    (``train/trainer.py``); BatchNorm's training statistics and the loss
    normalisers are all-reduced over it (``models/layers.py``,
    ``train/losses.py``), so they are the global batch's;
  * ZeRO-1: whole parameters partitioned over the data group by
    ``zero_plan`` (those that JAX ``opt_state_sharding`` would shard); a
    rank keeps Adam moments for what it owns, updates it and broadcasts
    it (``train/train_state.py``);
  * tensor parallel: the GPT's q/k/v and first MLP linear hold a column
    shard, the attention projection and second MLP linear a row shard
    (``spec_for_param``); each rank runs its heads, and the row-parallel
    outputs are summed over the model group (``models/gpt.py``).

Rank ``r`` sits at data index ``r // model`` and model index
``r % model``, as ``np.reshape(devices, (data, model))`` lays the JAX
mesh out.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


@dataclass
class Mesh:
    """This rank's place in the mesh, the global ranks of its data group,
    and the groups it belongs to. ``data_group`` carries the global statistics and normalisers and the
    ZeRO-1 broadcasts, ``ddp_group`` DistributedDataParallel's gradient
    reduction (a group of its own, so its bucketed all-reduces never
    interleave with the others'), ``model_group`` the tensor-parallel
    sums. A group is None where its axis has size 1."""
    spec: MeshSpec
    rank: int
    data_index: int
    model_index: int
    data_ranks: Tuple[int, ...]
    data_group: Optional[dist.ProcessGroup] = field(repr=False)
    ddp_group: Optional[dist.ProcessGroup] = field(repr=False)
    model_group: Optional[dist.ProcessGroup] = field(repr=False)

    @property
    def data(self) -> int:
        return self.spec.data

    @property
    def model(self) -> int:
        return self.spec.model


def make_mesh(spec: MeshSpec) -> Mesh:
    """The groups of a (data x model) mesh over the initialised world,
    whose size must be ``spec.n_devices``. Every rank calls it: each group
    is created by every rank, in one order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != spec.n_devices:
        raise ValueError(f"mesh {spec.data}x{spec.model} needs "
                         f"{spec.n_devices} processes, the world has {world}")
    groups = {}

    def new(kind, ranks):
        g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
        if rank in ranks:
            groups[kind] = (tuple(ranks), g)

    for m in range(spec.model):
        ranks = [d * spec.model + m for d in range(spec.data)]
        new("data", ranks)
        new("ddp", ranks)
    for d in range(spec.data):
        new("model", [d * spec.model + m for m in range(spec.model)])
    return Mesh(spec=spec, rank=rank, data_index=rank // spec.model,
                model_index=rank % spec.model,
                data_ranks=groups["data"][0], data_group=groups["data"][1],
                ddp_group=groups["ddp"][1],
                model_group=groups["model"][1])


# ------------------------------------------------------------ processes

def local_device(device: str = "cuda") -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK`` (0 when the launcher set none); a
    device with an index, or the CPU, as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(device: torch.device, backend: Optional[str] = None,
                     init_method: str = "env://",
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = 1800.0) -> None:
    """The default process group: NCCL for a CUDA device, gloo for the
    CPU, unless ``backend`` says otherwise (ranks that share one card use
    gloo). ``init_method`` is ``env://`` under torchrun, or
    ``tcp://host:port`` with ``world_size`` and ``rank``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    given = {k: v for k, v in (("world_size", world_size), ("rank", rank))
             if v is not None}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **given)


def is_chief() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# ----------------------------------------------------------- param rules

# Megatron column-parallel (output rows of a torch [out, in] weight
# sharded) and row-parallel (input columns sharded) linears of the GPT
# blocks: the JAX package's query|key|value|mlp_fc and proj|mlp_proj.
_COL_PARALLEL = re.compile(
    r"(^|\.)blocks\.\d+\.(attn\.(query|key|value)|mlp\.0)\.(weight|bias)$")
_ROW_PARALLEL = re.compile(r"(^|\.)blocks\.\d+\.(attn\.proj|mlp\.2)\.weight$")


def spec_for_param(name: str, shape: Sequence[int],
                   model_size: int) -> Optional[int]:
    """The dimension of a port parameter that the model axis shards, or
    None (replicated): JAX ``_spec_for_param`` on the torch layout. A
    dimension is sharded only where ``model_size`` divides it."""
    if model_size <= 1:
        return None
    if _COL_PARALLEL.search(name) and shape[0] % model_size == 0:
        return 0
    if _ROW_PARALLEL.search(name) and shape[1] % model_size == 0:
        return 1
    return None


ZERO_MIN_SIZE = 1024


def zero_partitioned(shape: Sequence[int], data_size: int) -> bool:
    """Whether ZeRO-1 partitions a parameter's moments: JAX
    ``opt_state_sharding``'s rule for a moment leaf (at least
    ``ZERO_MIN_SIZE`` elements, and an axis that the data axis divides).
    Smaller leaves stay replicated: every rank updates them."""
    n = 1
    for d in shape:
        n *= d
    return data_size > 1 and len(shape) > 0 and n >= ZERO_MIN_SIZE and \
        any(d % data_size == 0 for d in shape)


def zero_plan(shapes: Sequence[Sequence[int]], n: int) -> List[int]:
    """ZeRO-1 owners: each partitioned parameter goes whole to the data
    rank holding the fewest elements so far, largest first (ties to the
    lower rank, then the earlier parameter); -1 for a replicated one."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    load = [0] * n
    owner = [-1] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        if not zero_partitioned(shapes[i], n):
            continue
        r = min(range(n), key=lambda r: load[r])
        owner[i] = r
        load[r] += sizes[i]
    return owner


def batch_rows(batch: Dict[str, torch.Tensor], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the data index's contiguous
    share of the leading axis (the model ranks of one data index get the
    same rows)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch of {n} rows ({k}) does not divide "
                             f"over {mesh.data} data ranks")
        rows = n // mesh.data
        out[k] = v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
    return out


# ------------------------------------------------------- tensor parallel

@dataclass
class TensorParallel:
    """A model's tensor-parallel layout: the model group, its size, this
    rank's index in it, and the sharded dimension of each parameter."""
    group: Optional[dist.ProcessGroup]
    size: int
    index: int
    dims: Dict[str, int]


def shard_tensor(full: torch.Tensor, dim: int, size: int,
                 index: int) -> torch.Tensor:
    n = full.shape[dim] // size
    return full.narrow(dim, index * n, n).clone()


def gather_tensor(part: torch.Tensor, dim: int, tp: TensorParallel
                  ) -> torch.Tensor:
    """The full tensor from every model rank's shard (a sum of zero-padded
    shards: all-reduce only)."""
    shape = list(part.shape)
    n = shape[dim]
    shape[dim] = n * tp.size
    full = torch.zeros(shape, dtype=part.dtype, device=part.device)
    full.narrow(dim, tp.index * n, n).copy_(part)
    dist.all_reduce(full, group=tp.group)
    return full


def shard_model(model: torch.nn.Module, mesh: Mesh) -> None:
    """Keep this rank's shard of every tensor-parallel parameter (the full
    model was built, or loaded, first) and switch the GPT blocks to their
    local heads. Sets ``model.tensor_parallel``."""
    from ..models.gpt import Block

    size = mesh.model
    dims = {}
    for name, p in list(model.named_parameters()):
        dim = spec_for_param(name, tuple(p.shape), size)
        if dim is None:
            continue
        dims[name] = dim
        owner, leaf = name.rpartition(".")[::2]
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
            shard_tensor(p.detach(), dim, size, mesh.model_index)))
    for prefix, block in model.named_modules():
        if isinstance(block, Block):
            sharded = [n for n in dims if n.startswith(prefix + ".")]
            if sharded:
                if len(sharded) != 10:
                    raise ValueError(f"{prefix}: {len(sharded)} of its 10 "
                                     f"tensor-parallel leaves divide by "
                                     f"{size}")
                block.set_tensor_parallel(mesh.model_group, size,
                                          mesh.model_index)
    model.tensor_parallel = TensorParallel(mesh.model_group, size,
                                           mesh.model_index, dims)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The unsharded state dict (collective over the model group under
    tensor parallelism; the plain state dict otherwise)."""
    sd = model.state_dict()
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return sd
    return {k: gather_tensor(v, tp.dims[k], tp) if k in tp.dims else v
            for k, v in sd.items()}


def load_full_state_dict(model: torch.nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load an unsharded state dict, keeping this rank's shards."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is not None:
        state = {k: shard_tensor(v, tp.dims[k], tp.size, tp.index)
                 if k in tp.dims else v for k, v in state.items()}
    model.load_state_dict(state, strict=True)
