"""Process-group set-up, the (dp, tp) mesh, and moving rows between ranks.

Counterpart of `fish_speech_tpu/parallel/distributed.py`. JAX runs one
controller over every device, and jit inserts the collectives; here each
rank is a process that holds one shard, and the collectives are explicit
(`torch.distributed`). One rank serves and drives the others
(`parallel/driver.py`).

    from fish_speech_tpu_torch.parallel import distributed as dist
    dist.initialize_distributed()        # FISH_TPU_* set, or a no-op
    mesh = dist.global_mesh(tp=2)        # (dp, tp) over every rank
    params = shard_lm_params(params, mesh, cfg)

Backends: `nccl` where every rank owns a card of its own (`cuda:<rank
modulo the card count>`; the ranks of a world are on one host), `gloo`
on the CPU. Ranks that would share a card take `backend="gloo"`, asked
for explicitly: NCCL refuses two ranks on one card, and there is no
silent switch. Gloo takes CUDA tensors for `all_reduce` and
`broadcast`, the two collectives the port uses (a gather is an
all-reduce into zeros, which is exact).

Every process group is made with a timeout, so a lost rank fails the
others' next collective instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

COORDINATOR_ENV = "FISH_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "FISH_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "FISH_TPU_PROCESS_ID"
DEFAULT_TIMEOUT_S = 600.0  # a collective's longest wait (a first kernel build included)


_state = {"timeout_s": DEFAULT_TIMEOUT_S}  # the world's, set by initialize_distributed


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=_state["timeout_s"])


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the world of `num_processes` ranks at `coordinator_address`
    ("host:port" or "tcp://host:port") as rank `process_id`; each
    argument left None is read from FISH_TPU_COORDINATOR,
    FISH_TPU_NUM_PROCESSES and FISH_TPU_PROCESS_ID. With no coordinator
    it is a no-op and returns False, so single-process use needs nothing.

    backend: None takes nccl where CUDA is available and gloo elsewhere.
    nccl with more ranks than cards raises. On CUDA the rank's card
    (rank modulo the card count) becomes the current device. Returns
    True when the world has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if coordinator_address is None:
        return False
    if num_processes is None and NUM_PROCESSES_ENV in os.environ:
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None and PROCESS_ID_ENV in os.environ:
        process_id = int(os.environ[PROCESS_ID_ENV])
    if num_processes is None or process_id is None:
        raise ValueError(f"initialize_distributed: a coordinator ({coordinator_address}) needs "
                         f"the number of processes and this process's id "
                         f"({NUM_PROCESSES_ENV}, {PROCESS_ID_ENV})")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend or ("nccl" if cards else "gloo")
    if backend == "nccl" and num_processes > cards:
        raise ValueError(
            f"initialize_distributed: nccl needs a card of its own for every rank; "
            f"{num_processes} ranks, {cards} card(s). A card shared by several ranks takes "
            "backend='gloo'")
    if cards:
        torch.cuda.set_device(process_id % cards)
    _state["timeout_s"] = float(timeout_s)
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=_timeout())
    return num_processes > 1


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device_type: Optional[str] = None):
    """A (dp, tp) `DeviceMesh` over ranks [0, n_devices) of the world
    (default: all of it), with mesh_dim_names ("dp", "tp"): rank
    dp_rank * tp + tp_rank, the tp axis innermost. Its groups are made
    with the world's timeout (init_device_mesh's would take the 30-minute
    default), so it is built from them by `DeviceMesh.from_group`.
    Every rank of the world calls it. device_type: "cuda" where CUDA is
    available, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the world has {world} ranks")
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} devices")
    layout = torch.arange(n).reshape(n // tp, tp)
    rank = dist.get_rank()
    groups = {}
    for row in layout.tolist():
        g = dist.new_group(row, timeout=_timeout())
        if rank in row:
            groups["tp"] = g
    for col in layout.T.tolist():
        g = dist.new_group(col, timeout=_timeout())
        if rank in col:
            groups["dp"] = g
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh.from_group([groups["dp"], groups["tp"]], device_type, mesh=layout,
                                 mesh_dim_names=("dp", "tp"))


def global_mesh(tp: int = 1, device_type: Optional[str] = None):
    """The (dp, tp) mesh over every rank of the world."""
    return make_mesh(None, tp, device_type)


class Coords(NamedTuple):
    """This rank's place in a (dp, tp) mesh; (1, 1, 0, 0) without one."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int

    @property
    def size(self) -> int:
        return self.dp * self.tp


def coords(mesh) -> Coords:
    if mesh is None:
        return Coords(1, 1, 0, 0)
    return Coords(mesh.size(0), mesh.size(1), mesh.get_local_rank("dp"),
                  mesh.get_local_rank("tp"))


def local_rows(batch: int, mesh) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a batch: its dp block where dp
    divides the batch, else every row (kept whole on every dp rank, as
    the JAX engine keeps a batch the mesh does not divide). The
    counterpart of `host_local_to_global`, which feeds a process's rows
    into a global array: here a rank only ever holds its own."""
    c = coords(mesh)
    if batch % c.dp:
        return 0, batch
    n = batch // c.dp
    return c.dp_rank * n, (c.dp_rank + 1) * n


def fetch_replicated(x: torch.Tensor, mesh, offset: int, total: int) -> torch.Tensor:
    """Rows dp-sharded over the mesh, gathered to every rank: x holds rows
    [offset, offset + len(x)) of a tensor of `total` rows, and each dp
    rank holds its own (possibly none). One all-reduce over dp into
    zeros, which is exact: every element is one rank's value plus
    zeros. Floating rows are summed in float32, other rows in int64."""
    acc = torch.float32 if x.is_floating_point() else torch.int64
    out = torch.zeros((total, *x.shape[1:]), dtype=acc, device=x.device)
    out[offset:offset + x.shape[0]] = x.to(acc)
    dist.all_reduce(out, group=mesh.get_group("dp"))
    return out.to(x.dtype)
