"""The (data, model) mesh of ranks, a port of kuiperllama_tpu/parallel/mesh.py.

The JAX package runs one controller over a grid of devices and lets
shard_map place the pieces. Here every rank is a process that runs the same
Python on the same inputs (SPMD): a `Mesh` holds the grid's shape, this
rank's coordinates in it and the process groups of its two axes. The model
axis carries Megatron tensor parallelism (or, with seqpar, the page-sharded
KV pool); the data axis gives each rank its own rows of the batch and needs
no collective at all.

Ranks are laid out model-axis fastest, as the JAX package reshapes its
device list: global rank = data_rank * tp + model_rank.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# initialize_distributed's timeout, which make_mesh gives every group it
# makes (None: new_group's own default)
_group_timeout: Optional[datetime.timedelta] = None


@dataclass
class Mesh:
    """A (data=dp, model=tp) grid of ranks and this rank's place in it.

    model_group / data_group: the process groups of this rank's row and
    column (None for a one-rank mesh built without a process group: its
    collectives are the identity and issue nothing). control_group: a gloo
    group over the model group's ranks for host-side messages (the
    multi-rank server's, serving/server.py), kept off the NCCL model group
    whose collectives the CUDA graphs capture; None where the model axis
    has one rank and there is no peer to tell."""

    dp: int
    tp: int
    dp_rank: int = 0
    tp_rank: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    control_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        """Axis sizes under the JAX mesh's names."""
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def backend(self) -> Optional[str]:
        """The model group's backend ("nccl", "gloo"), None without a group."""
        return None if self.model_group is None else dist.get_backend(self.model_group)

    @property
    def key(self) -> tuple:
        """What tells one rank's place and group from another's: CUDA graph
        keys carry it, so a graph captured on one group is not replayed on
        another."""
        return (self.dp, self.tp, self.dp_rank, self.tp_rank, self.backend,
                id(self.model_group))

    def graphs_capturable(self) -> bool:
        """Whether the model group's collectives can be captured in a CUDA
        graph: NCCL's can (on the capturing stream); gloo's run on the host
        and cannot. A mesh without a group issues none."""
        return self.model_group is None or self.backend == "nccl"


def make_mesh(dp: int = 1, tp: Optional[int] = None) -> Optional[Mesh]:
    """This rank's (data=dp, model=tp) mesh over the first dp * tp ranks of
    the default process group (tp defaults to world_size // dp). Every
    rank of the group must call it, in the same order as its other group
    creations; a rank beyond dp * tp gets None. The model axis always
    issues its collectives, a one-rank one included; the data axis issues
    none. Every group bounds its collectives by initialize_distributed's
    `timeout_s`, so a rank that stops answering fails its peers'
    collectives within it (new_group alone would give each the backend's
    default, 10 or 30 minutes; a group joined without
    initialize_distributed keeps that default)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_distributed first (or single_device_mesh)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp is None:
        if world % dp:
            raise ValueError(f"make_mesh: dp {dp} does not divide {world} ranks")
        tp = world // dp
    if dp * tp > world:
        raise ValueError(f"make_mesh: dp {dp} x tp {tp} > world size {world}")
    rows = [[d * tp + t for t in range(tp)] for d in range(dp)]
    model_groups = [dist.new_group(r, timeout=_group_timeout) for r in rows]
    data_groups = [dist.new_group([d * tp + t for d in range(dp)], timeout=_group_timeout)
                   for t in range(tp)]
    control_groups = [dist.new_group(r, timeout=_group_timeout, backend="gloo") if tp > 1
                      else None for r in rows]
    if rank >= dp * tp:
        return None
    d, t = divmod(rank, tp)
    return Mesh(dp=dp, tp=tp, dp_rank=d, tp_rank=t, model_group=model_groups[d],
                data_group=data_groups[t], control_group=control_groups[d])


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh with no process group: its collectives issue nothing."""
    return Mesh(dp=1, tp=1)


def initialize_distributed(coordinator: str, num_processes: int, process_id: int,
                           *, backend: str, timeout_s: float = 600.0,
                           device_id: Optional[torch.device] = None):
    """Join this process to a group of `num_processes` ranks: a thin wrapper
    over torch.distributed.init_process_group. `coordinator` is a
    torch init method ("tcp://host:port", "file:///path") or a bare
    "host:port", read as tcp. The backend ("nccl" or "gloo") is the
    caller's choice; nothing here picks one. `timeout_s` bounds every
    collective of the group, and of the groups make_mesh makes, so a rank
    that hangs fails its peers."""
    global _group_timeout
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    kw = {} if device_id is None else dict(device_id=device_id)
    _group_timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=_group_timeout, **kw)
