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

A world may span hosts, as a JAX pod does. Its ranks are numbered host
by host, rank = host x local count + local id: every host runs the same
count of ranks (FISH_TPU_LOCAL_NUM_PROCESSES), and each rank knows its
place among them (FISH_TPU_LOCAL_PROCESS_ID). Without those two
variables the world is one host. A rank takes the card `cuda:<local
id>` (modulo this host's cards, for ranks that share one). `global_mesh`
puts tp innermost, so where tp divides a host's ranks every tp group
stays on one host and only dp crosses hosts, as JAX's `global_mesh`
lays a pod out. Each host feeds its own rows of a batch
(`host_local_to_global`). A launcher starts each rank with the five
variables; for two hosts of 8 cards, on host h, local id i:

    FISH_TPU_COORDINATOR=<host 0's address>:29500 FISH_TPU_NUM_PROCESSES=16
    FISH_TPU_PROCESS_ID=$((8 * h + i))
    FISH_TPU_LOCAL_NUM_PROCESSES=8 FISH_TPU_LOCAL_PROCESS_ID=$i

Backends: `nccl` where every rank of a host owns a card of its own,
`gloo` on the CPU. Ranks that would share a card take `backend="gloo"`,
asked for explicitly: NCCL refuses two ranks on one card, and there is
no silent switch. Gloo takes CUDA tensors for `all_reduce` and
`broadcast`, the two collectives the port uses (a gather is an
all-reduce into zeros, which is exact).

Every process group is made with a timeout, so a lost rank fails the
others' next collective instead of hanging them.
"""

from __future__ import annotations

import datetime
import logging
import os
import subprocess
import sys
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

COORDINATOR_ENV = "FISH_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "FISH_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "FISH_TPU_PROCESS_ID"
LOCAL_NUM_PROCESSES_ENV = "FISH_TPU_LOCAL_NUM_PROCESSES"
LOCAL_PROCESS_ID_ENV = "FISH_TPU_LOCAL_PROCESS_ID"
DEFAULT_TIMEOUT_S = 600.0  # a collective's longest wait (a first kernel build included)


# the world's, set by initialize_distributed: the collectives' timeout and
# this rank's HostLayout
_state = {"timeout_s": DEFAULT_TIMEOUT_S, "layout": None}

# What this process's model and training collectives sent (`all_reduce`):
# calls and bytes of the tensors reduced. Callers reset it to 0 and read it.
traffic = {"calls": 0, "bytes": 0}


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over `group` in place, counted in `traffic`; returns x."""
    traffic["calls"] += 1
    traffic["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, group=group)
    return x


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=_state["timeout_s"])


class HostLayout(NamedTuple):
    """A rank's place among the world's hosts: its host's index of `hosts`,
    and its local id among the `local_count` ranks of every host."""

    host: int
    hosts: int
    local_id: int
    local_count: int


class Placement(NamedTuple):
    """What `place_rank` decides for a rank: the backend, the card index
    (None without a card) and the rank's HostLayout."""

    backend: str
    card: Optional[int]
    layout: HostLayout


def place_rank(num_processes: int, process_id: int, local_id: Optional[int],
               local_count: Optional[int], cards: int, backend: Optional[str]) -> Placement:
    """The backend, card and host layout of rank `process_id` of a world
    of `num_processes`, numbered host by host, on a host with `cards`
    cards; local_id / local_count None: the world is one host. backend
    None takes nccl where there are cards and gloo elsewhere. Raises
    ValueError for a layout that is not host by host in equal hosts, and
    for nccl with more ranks on this host than it has cards."""
    if (local_id is None) != (local_count is None):
        raise ValueError(f"initialize_distributed: a local id ({local_id}) and a local count "
                         f"({local_count}) go together ({LOCAL_PROCESS_ID_ENV}, "
                         f"{LOCAL_NUM_PROCESSES_ENV})")
    if local_count is None:
        local_id, local_count = process_id, num_processes
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_distributed: rank {process_id} of a world of "
                         f"{num_processes}")
    if not 0 <= local_id < local_count:
        raise ValueError(f"initialize_distributed: local id {local_id} of a host of "
                         f"{local_count} ranks")
    if num_processes % local_count:
        raise ValueError(f"initialize_distributed: {num_processes} ranks do not make equal "
                         f"hosts of {local_count}")
    if process_id % local_count != local_id:
        raise ValueError(f"initialize_distributed: rank {process_id} cannot be local id "
                         f"{local_id} on hosts of {local_count}: ranks are numbered host by "
                         "host (rank = host x local count + local id)")
    backend = backend or ("nccl" if cards else "gloo")
    if backend == "nccl" and local_count > cards:
        raise ValueError(
            f"initialize_distributed: nccl needs a card of its own for every rank of a host; "
            f"this host runs {local_count} ranks on {cards} card(s). A card shared by several "
            "ranks takes backend='gloo'")
    return Placement(backend, local_id % cards if cards else None,
                     HostLayout(process_id // local_count, num_processes // local_count,
                                local_id, local_count))


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           local_process_id: Optional[int] = None,
                           local_num_processes: Optional[int] = None) -> bool:
    """Join the world of `num_processes` ranks at `coordinator_address`
    ("host:port" or "tcp://host:port") as rank `process_id`, local id
    `local_process_id` of the `local_num_processes` ranks of each host;
    each argument left None is read from FISH_TPU_COORDINATOR,
    FISH_TPU_NUM_PROCESSES, FISH_TPU_PROCESS_ID,
    FISH_TPU_LOCAL_PROCESS_ID and FISH_TPU_LOCAL_NUM_PROCESSES. Without
    the local pair the world is one host. With no coordinator it is a
    no-op and returns False, so single-process use needs nothing.

    `place_rank` decides the backend and the card, and raises before
    anything is initialised; on CUDA the card becomes the current device.
    Returns True when the world has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = _env_int(NUM_PROCESSES_ENV)
    if process_id is None:
        process_id = _env_int(PROCESS_ID_ENV)
    if num_processes is None or process_id is None:
        raise ValueError(f"initialize_distributed: a coordinator ({coordinator_address}) needs "
                         f"the number of processes and this process's id "
                         f"({NUM_PROCESSES_ENV}, {PROCESS_ID_ENV})")
    if local_process_id is None:
        local_process_id = _env_int(LOCAL_PROCESS_ID_ENV)
    if local_num_processes is None:
        local_num_processes = _env_int(LOCAL_NUM_PROCESSES_ENV)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    place = place_rank(num_processes, process_id, local_process_id, local_num_processes, cards,
                       backend)
    if place.card is not None:
        torch.cuda.set_device(place.card)
    _state["timeout_s"] = float(timeout_s)
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(place.backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, timeout=_timeout())
    _state["layout"] = place.layout
    return num_processes > 1


def host_layout() -> HostLayout:
    """This rank's HostLayout: as `initialize_distributed` placed it; one
    host of the whole world where the world was made otherwise; (0, 1, 0,
    1) without a world."""
    if not dist.is_initialized():
        return HostLayout(0, 1, 0, 1)
    layout = _state["layout"]
    world = dist.get_world_size()
    if layout is None or layout.hosts * layout.local_count != world:
        return HostLayout(0, 1, dist.get_rank(), world)
    return layout


def crossing_tp_groups(n: int, tp: int, local_count: int) -> List[List[int]]:
    """The tp groups of make_mesh's layout over n ranks (rank = dp_rank x
    tp + tp_rank) whose ranks lie on more than one host of `local_count`
    ranks: none where tp divides local_count."""
    rows = [list(range(d * tp, (d + 1) * tp)) for d in range(n // tp)]
    return [row for row in rows if len({r // local_count for r in row}) > 1]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device_type: Optional[str] = None):
    """A (dp, tp) `DeviceMesh` over ranks [0, n_devices) of the world
    (default: all of it), with mesh_dim_names ("dp", "tp"): rank
    dp_rank * tp + tp_rank, the tp axis innermost. Its groups are made
    with the world's timeout (init_device_mesh's would take the 30-minute
    default), so it is built from them by `DeviceMesh.from_group`.
    Every rank of the world calls it. device_type: "cuda" where CUDA is
    available, else "cpu".

    Ranks are numbered host by host, so where tp divides a host's ranks
    each tp group lies on one host and only dp crosses hosts (JAX's
    topology layout). Where it does not, the mesh is built all the same,
    as JAX's fallback builds it, and a warning names the tp groups that
    cross hosts: the results are the same, the tp all-reduces travel
    further. A layout with dp inside a host and tp across hosts is not
    supported."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the world has {world} ranks")
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} devices")
    hosts = host_layout()
    crossing = crossing_tp_groups(n, tp, hosts.local_count)
    assert hosts.local_count % tp or not crossing, crossing
    if crossing:
        logger.warning("make_mesh: tp=%d does not divide the %d ranks of a host, so the tp "
                       "groups %s cross hosts", tp, hosts.local_count, crossing)
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
    """This rank's rows [lo, hi) of a serving batch that every rank holds
    whole: its dp block where dp divides the batch, else every row (kept
    whole on every dp rank, as the JAX engine keeps a batch the mesh does
    not divide). A training batch that each host feeds in part goes
    through `host_local_to_global`."""
    c = coords(mesh)
    if batch % c.dp:
        return 0, batch
    n = batch // c.dp
    return c.dp_rank * n, (c.dp_rank + 1) * n


def host_rows(batch: int) -> Tuple[int, int]:
    """This host's block [lo, hi) of a global batch of `batch` rows that
    every host draws alike (the finetune CLI's seeded order): block host
    of hosts, the rows the host passes to `host_local_to_global`."""
    layout = host_layout()
    if batch % layout.hosts:
        raise ValueError(f"host_rows: a batch of {batch} does not split over "
                         f"{layout.hosts} hosts")
    n = batch // layout.hosts
    return layout.host * n, (layout.host + 1) * n


def host_local_to_global(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of the global batch that the hosts' rows make,
    the counterpart of JAX's `host_local_to_global`: x holds this host's
    B rows, the global batch is every host's rows in host order (B x
    hosts rows), and the rank takes its dp block of it. Where tp divides
    a host's ranks, that block lies in this host's rows and nothing is
    sent; else (tp groups across hosts) the global rows are gathered over
    the world first, one all-reduce into zeros. On one host x is the
    global batch. Every rank of the mesh calls it."""
    c, layout = coords(mesh), host_layout()
    b = x.shape[0]
    total = b * layout.hosts
    on_host = layout.hosts == 1 or layout.local_count % c.tp == 0
    if on_host and b % (c.dp // layout.hosts):
        raise ValueError(f"shard_batch: this host's batch {b} is not a multiple of its "
                         f"{c.dp // layout.hosts} dp ranks (dp={c.dp} over {layout.hosts} "
                         "hosts)")
    if total % c.dp:
        raise ValueError(f"shard_batch: the global batch {total} ({layout.hosts} hosts x {b}) "
                         f"is not a multiple of dp={c.dp}")
    n = total // c.dp
    if on_host:
        lo = c.dp_rank * n - layout.host * b
        return x[lo:lo + n]
    acc = torch.float32 if x.is_floating_point() else torch.int64
    whole = torch.zeros((total, *x.shape[1:]), dtype=acc, device=x.device)
    if layout.local_id == 0:  # one rank a host contributes its host's rows
        whole[layout.host * b:(layout.host + 1) * b] = x.to(acc)
    all_reduce(whole, None)
    return whole[c.dp_rank * n:(c.dp_rank + 1) * n].to(x.dtype)


def fetch_replicated(x: torch.Tensor, mesh, offset: int, total: int) -> torch.Tensor:
    """Rows dp-sharded over the mesh, gathered to every rank: x holds rows
    [offset, offset + len(x)) of a tensor of `total` rows, and each dp
    rank holds its own (possibly none). One all-reduce over dp into
    zeros, which is exact: every element is one rank's value plus
    zeros. The dp group spans the world's hosts, so every host gets every
    row. Floating rows are summed in float32, other rows in int64."""
    acc = torch.float32 if x.is_floating_point() else torch.int64
    out = torch.zeros((total, *x.shape[1:]), dtype=acc, device=x.device)
    out[offset:offset + x.shape[0]] = x.to(acc)
    all_reduce(out, mesh.get_group("dp"))
    return out.to(x.dtype)


def rank0() -> bool:
    """Whether this process is global rank 0 (or runs without a world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def launch_ranks(n: int, module: str, argv: List[str]) -> Tuple[str, List[subprocess.Popen]]:
    """Start ranks 1..n-1 of a world on this host, each `python -m module
    argv` with the FISH_TPU_* variables of its rank (the world one host:
    local id = rank, local count n); returns the coordinator's address
    (this process joins it as rank 0) and the processes."""
    from fish_speech_tpu_torch.parallel.dryrun import free_port

    address = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(1, n):
        env = dict(os.environ, **{COORDINATOR_ENV: address, NUM_PROCESSES_ENV: str(n),
                                  PROCESS_ID_ENV: str(rank), LOCAL_NUM_PROCESSES_ENV: str(n),
                                  LOCAL_PROCESS_ID_ENV: str(rank)})
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))
    return address, procs


def wait_ranks(procs: List[subprocess.Popen], timeout_s: float = 60.0) -> None:
    """Wait for the ranks `launch_ranks` started; kill those still running
    after timeout_s."""
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
