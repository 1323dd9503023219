"""Several processes: rank-0 I/O and the collectives a mesh needs.

Port of tpulbm/parallel/multihost.py on torch.distributed. tpulbm's
`jax.distributed.initialize()` becomes `initialize()`, which reads
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); each process then drives its own run of a mesh's shards
(parallel/mesh.py) on `local_device()`. The backend is NCCL where that
device is a card and gloo on the host; a caller may ask for gloo on cards
(processes that share one card, which NCCL refuses), and then every
message goes through host buffers. Nothing here switches backend or
device because something failed: a failure raises.

A run of one process never initializes torch.distributed and never calls
it: every function below is then the identity or a plain host copy.
Files are written by process 0 (`is_primary`); the fetches are symmetric,
every process receives the whole array, as tpulbm's process_allgather.
"""
from __future__ import annotations

import os

import numpy as np
import torch

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# rank, world, device, backend of an initialized run; None in one process
_STATE: dict | None = None


def _dist():
    import torch.distributed as dist
    return dist


def initialize(backend: str | None = None, cpu: bool = False) -> torch.device:
    """Join the processes torchrun's variables describe; returns this
    process's device (local_device()). backend: "nccl" (the default on
    cards), "gloo" (the default with `cpu`; on cards it moves every
    message through host memory). Raises where a variable is missing, the
    run is already initialized, NCCL is asked for on the host, or no card
    is visible without `cpu`."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError("multihost.initialize was already called")
    missing = [name for name in ENV if name not in os.environ]
    if missing:
        raise RuntimeError(
            f"several processes need torchrun's variables; {missing[0]} is "
            f"not set (missing: {', '.join(missing)})")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not 0 <= rank < world:
        raise ValueError(f"RANK {rank} outside WORLD_SIZE {world}")
    device = _device(cpu)
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves card tensors; the host takes gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist = _dist()
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=rank, world_size=world)
    _STATE = dict(rank=rank, world=world, device=device, backend=backend)
    # every rank's first collective: NCCL asks that no point-to-point
    # batch come first
    sync("initialize")
    return device


def shutdown() -> None:
    """Leave the process group (a no-op in one process)."""
    global _STATE
    if _STATE is not None:
        _dist().destroy_process_group()
        _STATE = None


def _device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("torch finds no CUDA device; pass cpu=True (the "
                           "CLI's --cpu) to run the processes on the host")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)


def process_index() -> int:
    return 0 if _STATE is None else _STATE["rank"]


def process_count() -> int:
    return 1 if _STATE is None else _STATE["world"]


def is_primary() -> bool:
    """The rank-0 analog: the process that owns file writes and banners."""
    return process_index() == 0


def backend() -> str | None:
    """"nccl" or "gloo" once initialized, else None."""
    return None if _STATE is None else _STATE["backend"]


def local_device() -> torch.device:
    """This process's device: the one initialize chose, else cuda:LOCAL_RANK
    modulo the visible cards (cuda:0 without torchrun)."""
    return _device(False) if _STATE is None else _STATE["device"]


def _carrier(t: torch.Tensor) -> torch.Tensor:
    """t as the backend moves it: itself under NCCL (a card tensor) and
    for a host tensor under gloo, else a pinned host copy (the caller
    synchronizes before the copy is read)."""
    t = t.contiguous()
    if t.device.type == "cpu" or _STATE["backend"] == "nccl":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A receive buffer for a tensor bound for `device`."""
    if device.type == "cpu" or _STATE["backend"] == "nccl":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _staged(tensors) -> None:
    """Wait for the copies _carrier queued on the cards."""
    if _STATE["backend"] == "gloo":
        for dev in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()


def send_recv(ops: list) -> list:
    """Point-to-point messages as one torch.distributed.batch_isend_irecv,
    posted in list order (every process lists the moves of an exchange in
    the same order, so a pair's messages match in order): ops holds
    ("send", tensor, peer, tag) and ("recv", (shape, dtype, device), peer,
    tag). Returns the received tensors, in order, each on its device; no
    ops (one process) touch nothing."""
    if not ops:
        return []
    dist = _dist()
    posted, received, sent = [], [], []
    for kind, what, peer, tag in ops:
        if kind == "send":
            sent.append(what)
            posted.append(dist.P2POp(dist.isend, _carrier(what), peer,
                                     tag=tag))
        else:
            shape, dtype, device = what
            buf = _buffer(shape, dtype, device)
            received.append((buf, device))
            posted.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    _staged(sent)
    for req in dist.batch_isend_irecv(posted):
        req.wait()
    return [buf.to(device, non_blocking=True) for buf, device in received]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(process_count(), *t.shape) on t's device: every process's t, in
    process order (t[None] in one process)."""
    if _STATE is None:
        return t[None]
    dist = _dist()
    src = _carrier(t[None])
    _staged([t])
    out = _buffer((_STATE["world"],) + tuple(t.shape), t.dtype, t.device)
    # all_gather_single is all_gather_into_tensor's newer name
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, src)
    return out.to(t.device)


def fetch_global(x, mesh=None) -> np.ndarray:
    """Host NumPy copy of a global array: a tensor every process holds, or
    the grid of blocks of `mesh` ([[block or None, ...], ...], None where
    another process holds the shard, parallel/mesh.py), which every
    process receives whole (process_allgather semantics; callers gate
    file writes on is_primary()). Each process's blocks are all-gathered
    and placed by the mesh's process map (Mesh.by_process)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if mesh is None:
        raise ValueError("fetch_global of a grid of blocks needs its mesh")
    blocks = [x[iy][ix].detach() for iy, ix in mesh.local_shards()]
    every = all_gather(torch.stack([b.to(blocks[0].device) for b in blocks]))
    placed = dict(zip(mesh.by_process(), every.reshape(
        (-1,) + tuple(blocks[0].shape)).cpu().numpy()))
    my, mx = mesh.shape
    return np.concatenate([np.concatenate(
        [placed[iy, ix] for ix in range(mx)], axis=-1) for iy in range(my)],
        axis=-2)


def fetch_tree(tree, mesh=None):
    """fetch_global over a tuple, list of grids or dict (e.g. the (rho, u)
    fields pair)."""
    if isinstance(tree, dict):
        return {k: fetch_global(v, mesh) for k, v in tree.items()}
    return type(tree)(fetch_global(v, mesh) for v in tree)


def broadcast_one_to_all(array: np.ndarray) -> np.ndarray:
    """Process 0's `array` on every process; the others pass a placeholder
    of the same shape and dtype (tpulbm's multihost_utils semantics)."""
    array = np.ascontiguousarray(array)
    if _STATE is None:
        return array
    t = torch.from_numpy(array.copy())
    if _STATE["backend"] == "nccl":
        t = t.to(_STATE["device"])
    _dist().broadcast(t, src=0)
    return t.cpu().numpy()


def sync(tag: str) -> None:
    """A barrier of every process (tpulbm's sync_global_devices); `tag`
    names it in errors."""
    if _STATE is None:
        return
    dist = _dist()
    if _STATE["backend"] == "nccl":
        dist.barrier(device_ids=[_STATE["device"].index])
    else:
        dist.barrier()
