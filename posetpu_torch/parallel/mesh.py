"""Data parallelism over ``torch.distributed``: one process per device.

The reference scales with one process per GPU under NCCL DDP
(run/pose2d/train.py:129-225); the JAX package lays a 1-D ``data`` mesh over
every device of every process and lets jit insert the collectives. A JAX
process is a host (``jax.distributed.initialize``) driving its local
devices; here a host's command starts one rank, a process of its own, per
local device (:class:`Layout`, cli/common.launch), and the mesh is the world
of ranks (:class:`DataMesh`): the model and its optimizer stay whole on
every rank, each rank holds its own rows of the global batch, and the steps
(train/step.py, train/gan.py) make the collectives themselves:

- :func:`gather_rows`: the ranks' rows joined in rank order, the global
  batch as ``jax.make_array_from_process_local_data`` builds it. With
  ``live=True`` this rank's rows keep their graph and the others arrive
  detached, so a loss over the global batch back-propagates exactly this
  rank's share;
- parallel/batchnorm.py: BatchNorm's moments over the global batch, an
  autograd Function with one all-reduce forward and one backward;
- :func:`all_reduce_grads`: the shares of the gradient summed, flat buffers
  of one dtype at a time, so every rank steps its optimizer on the same
  bytes.

The backend follows the device the caller asks for: NCCL for CUDA, gloo for
``device="cpu"``. Every collective adds one to :func:`collective_count`.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from posetpu_torch import resolve_device

_calls = [0]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The 1-D data mesh: the process group, this process's rank, the
    number of processes (each one device) and the device this rank drives."""

    group: Any
    rank: int
    size: int
    device: torch.device


# the longest a collective waits for the other ranks: a rank that fails ends
# its siblings' waits (seconds)
COLLECTIVE_TIMEOUT_S = 900.0


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a rank sits, in JAX's terms: ``hosts`` processes of
    ``jax.distributed.initialize`` (``--num-processes``), this rank's
    ``host`` (``--process-id``), each host driving ``local_ranks`` devices,
    one rank each, ``local`` this rank's index on its host. The world is
    hosts x local_ranks ranks and a rank is ``host * local_ranks + local``:
    the order in which ``jax.make_array_from_process_local_data`` lays the
    hosts' rows, each host's split over its devices in turn. ``url``: the
    group's rendezvous, None for a lone rank, which joins no group."""

    hosts: int = 1
    host: int = 0
    local_ranks: int = 1
    local: int = 0
    url: str | None = None

    @property
    def world(self) -> int:
        return self.hosts * self.local_ranks

    @property
    def rank(self) -> int:
        return self.host * self.local_ranks + self.local

    def rows(self, batch_size: int) -> tuple[int, int]:
        """This rank's rows [start, stop) of its host's batch of
        ``batch_size``."""
        if batch_size % self.local_ranks:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.local_ranks} local ranks")
        per = batch_size // self.local_ranks
        return self.local * per, (self.local + 1) * per


def host_layout(coordinator: str = "", num_processes: int = 0, process_id: int = 0,
                device=None, local_ranks: int | None = None) -> Layout:
    """The layout of a host's command (its local rank 0) from the CLIs'
    process flags, which keep ``jax.distributed.initialize``'s meaning:
    ``num_processes`` hosts, this one ``process_id``, meeting at
    ``coordinator`` (``host:port``, or a URL given whole). On CUDA a host
    runs one rank per visible GPU (``CUDA_VISIBLE_DEVICES`` narrows them),
    or one on the GPU that ``device`` names (``cuda:<i>``); ``local_ranks``
    may only confirm that count. On the CPU ``local_ranks`` (default 1)
    gloo ranks, as ``--xla_force_host_platform_device_count`` gives JAX CPU
    devices."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = 1 if dev.index is not None else torch.cuda.device_count()
        if local_ranks not in (None, n):
            raise ValueError(f"{local_ranks} local ranks asked on a host with {n} GPU(s) in "
                             f"use: a host runs one rank per visible GPU (narrow them with "
                             f"CUDA_VISIBLE_DEVICES, or pin one with device='cuda:<i>')")
    else:
        n = int(local_ranks or 1)
    hosts = int(num_processes or 1)
    if hosts > 1 and not coordinator:
        raise ValueError("--num-processes > 1 needs --coordinator host:port")
    if not 0 <= int(process_id) < hosts:
        raise ValueError(f"--process-id {process_id} is not one of {hosts} processes")
    url = None
    if coordinator:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    return Layout(hosts, int(process_id), n, 0, url)


def join(layout: Layout, device=None, timeout: float = COLLECTIVE_TIMEOUT_S) -> DataMesh | None:
    """This rank into its group (:func:`initialize_distributed` at
    ``layout.url``, each collective waiting at most ``timeout`` seconds):
    the mesh over the world, on CUDA the GPU of its local index (or the one
    ``device`` names). A lone rank (no url) joins nothing: None."""
    if layout.url is None:
        if layout.world > 1:
            raise ValueError(f"{layout.world} ranks need a rendezvous (a coordinator, or "
                             f"the local one cli/common.launch makes)")
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", layout.local)
    initialize_distributed(layout.url, layout.world, layout.rank, device=dev, timeout=timeout)
    return data_mesh()


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, device=None,
                           timeout: float | None = None) -> None:
    """The process-group rendezvous (init_process_group, train.py:133-135)
    at ``tcp://<coordinator>`` (or a URL given whole, ``file://...``), on
    NCCL when ``device`` is CUDA (the default) and gloo for ``device="cpu"``.
    On CUDA this process drives ``cuda:<process_id mod the local device
    count>`` unless ``device`` names one. ``timeout``: seconds a collective
    may wait for the others. No coordinator: nothing to do."""
    if coordinator is None:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else int(process_id or 0) % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                            world_size=int(num_processes or 1), rank=int(process_id or 0),
                            **kw)


def data_mesh(n_devices: int | None = None) -> DataMesh:
    """The mesh over every process of the initialized group (one device
    each: the current CUDA device under NCCL, the CPU under gloo).
    ``n_devices``, where given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh: no process group; call initialize_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"data_mesh: {n_devices} devices asked, the group has {size} "
                         f"processes of one device each")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    return DataMesh(dist.group.WORLD, dist.get_rank(), size, dev)


def check_mesh(mesh, where: str) -> None:
    """TypeError unless ``mesh`` is None or a :class:`DataMesh`."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"{where}: mesh must be a posetpu_torch.parallel.DataMesh "
                        f"(data_mesh()), got {type(mesh).__name__}")


def use_mesh(mesh: DataMesh | None, batch_size: int | None = None) -> DataMesh | None:
    """The mesh a step runs over, or None for the plain step: ``mesh`` when
    it spans more than one process and ``batch_size`` (where given) splits
    evenly over them, JAX's ``use_mesh`` (posetpu/cli/validate.py:146-149).
    A one-process group has no one to share the batch with, so its steps
    run plain and make no collective. The train and validate CLIs both
    decide by this rule."""
    if mesh is None or mesh.size == 1:
        return None
    if batch_size is not None and batch_size % mesh.size:
        return None
    return mesh


def collective_count() -> int:
    """Collectives made by this module since the last reset."""
    return _calls[0]


def reset_collective_count() -> None:
    _calls[0] = 0


# ------------------------------------------------------------- collectives


def _all_reduce_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    _calls[0] += 1
    dist.all_reduce(t, group=mesh.group)
    return t


def _all_gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    _calls[0] += 1
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


class _GatherLive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.rank
        return _all_gather(x.detach(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


def gather_rows(x, mesh: DataMesh, live: bool = False):
    """The ranks' ``x`` joined on axis 0 in rank order (every rank the same
    row count). ``live``: this rank's rows keep ``x``'s graph, the others'
    come detached. A dict is gathered leaf by leaf; None stays None."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: gather_rows(v, mesh, live) for k, v in x.items()}
    if live and x.requires_grad:
        return _GatherLive.apply(x, mesh)
    return _all_gather(x.detach(), mesh)


def _buckets(tensors):
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return list(by_dtype.values())


@torch.no_grad()
def all_reduce_grads(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Every ``.grad`` of ``module`` replaced by its sum over the ranks: one
    all-reduce per dtype over a flat buffer. The ranks run the same graph,
    so the same parameters carry a gradient on each."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    for bucket in _buckets(grads):
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), mesh)
        torch._foreach_copy_(bucket, [f.view_as(g) for f, g in
                                      zip(flat.split([g.numel() for g in bucket]), bucket)])


# ------------------------------------------------------ batches and state


def _rows(x, mesh: DataMesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.size} processes")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(batch, mesh: DataMesh):
    """The full batch, the same on every process -> this rank's rows of it
    (the leading axis split evenly in rank order)."""
    return {k: _rows(v, mesh) for k, v in batch.items()}


def global_batch_from_full_host(batch, mesh: DataMesh):
    """Validate's placement: every process iterates the full test loader in
    lockstep and takes its own rows (:func:`shard_batch`); the eval step
    gathers the outputs back in rank order, and process 0 writes them."""
    return shard_batch(batch, mesh)


def shard_host_batch(batch, mesh: DataMesh):
    """Train's placement: the loader already gave this rank its rows (the
    data set sharded by host, ``GroupLoader(num_shards=hosts,
    shard_index=host)``, and each host batch split over its local ranks,
    ``part=(local, local_ranks)``), so the batch is taken as it stands;
    every leaf must have the same row count (the collectives join equal
    shards)."""
    rows = {k: np.shape(v)[0] for k, v in batch.items()}
    if len(set(rows.values())) > 1:
        raise ValueError(f"shard_host_batch: uneven rows {rows}")
    return batch


def local_data(arr) -> np.ndarray:
    """This process's rows of a batch-sharded array, as numpy: the rows a
    rank holds are its own."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _is_train_state(tree) -> bool:
    """A train/state.TrainState, by its fields (this module imports nothing
    of train/): the module, its optimizer state and its step."""
    return (isinstance(getattr(tree, "params", None), torch.nn.Module)
            and hasattr(tree, "opt_state") and hasattr(tree, "step"))


def _leaves(tree, out):
    if _is_train_state(tree):
        _leaves(tree.params, out)
        _leaves(tree.opt_state, out)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.state_dict().values())
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _scalars(tree):
    """(holder, key) of every Python int or float in the state: the
    optimizer counts and the train states' steps."""
    out = []
    if _is_train_state(tree):
        out.append((tree, "step"))
        tree = tree.opt_state
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.append((tree, k))
            else:
                out.extend(_scalars(v))
    return out


@torch.no_grad()
def replicate(tree, mesh: DataMesh):
    """Rank 0's parameters, buffers, optimizer state and step counts on
    every rank, in place (a TrainState, a module, or dicts of them); returns
    ``tree``. Tensors go over in flat buffers, one per (device, dtype)."""
    tensors = _leaves(tree, [])
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for (device, _), bucket in groups.items():
        flat = torch.cat([t.reshape(-1) for t in bucket]).to(mesh.device)
        _calls[0] += 1
        dist.broadcast(flat, src=0, group=mesh.group)
        flat = flat.to(device)
        torch._foreach_copy_(bucket, [f.view_as(t) for f, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])
    holders = _scalars(tree)
    values = [getattr(h, k) if not isinstance(h, dict) else h[k] for h, k in holders]
    broadcast_object(values, mesh)
    for (h, k), v in zip(holders, values):
        if isinstance(h, dict):
            h[k] = v
        else:
            setattr(h, k, v)
    return tree


def broadcast_object(values: list, mesh: DataMesh) -> None:
    """Rank 0's picklable ``values`` on every rank, in place."""
    _calls[0] += 1
    dist.broadcast_object_list(values, src=0, group=mesh.group,
                               device=mesh.device if mesh.device.type == "cuda" else None)


def barrier(mesh: DataMesh | None) -> None:
    """Wait for every rank (nothing to wait for without a mesh)."""
    if mesh is not None:
        _calls[0] += 1
        if mesh.device.type == "cuda":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def is_primary(mesh: DataMesh | None) -> bool:
    """Rank 0 (the only process without a mesh) writes the outputs."""
    return mesh is None or mesh.rank == 0
