"""Data-parallel process groups and the row layouts of sharded batches.

The counterpart of ``qbold_vi_tpu/parallel/mesh.py``. qBOLD training and
inference are data-parallel over voxels and subjects, and the model is
small (~10^4 parameters at the published widths), so parameters are
replicated and batches are split on their leading axis, as in the JAX
package. PyTorch's idiom takes the place of the JAX mesh: one process per
device, and the JAX mesh's device ``d`` is rank ``d`` of the process
group. A ``Mesh`` holds that group, the world size, the rank and the
rank's ``torch.device``; the sharded steps (train/steps.py), the sharded
maps (infer.py) and the Trainer take one.

Backends, decided before the group is created and logged:

* CPU ranks use gloo;
* ranks that each have a card of their own use NCCL;
* ranks that share a card use gloo on CUDA tensors: NCCL refuses two ranks
  on one GPU ("Duplicate GPU detected"), which is the layout of a
  one-card machine running several ranks. Every collective the port
  issues (all_reduce, broadcast, all_gather) runs there on the CUDA
  tensors themselves; a collective gloo refused would fail the run.

A failed initialisation is a failed run: no other backend is tried.

Collectives a training step issues: one all-reduce of the rank's mask
count in the forward pass (the masked-mean rescaling of
``steps.finetune_terms``) and one all-reduce of ONE flat buffer holding
every gradient and the step's metrics (``all_reduce_sum``), not one
collective a parameter: the step is host-bound, and each collective is a
launch. ``Mesh.counts`` counts the collectives issued, and with
``Mesh.timed`` set, ``Mesh.seconds`` sums their host time (the device
synchronised around each).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import socket
import sys
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "Mesh", "initialize_distributed", "make_mesh",
           "choose_backend", "require_device",
           "host_local_rows", "crop_rows", "shard_batch",
           "shard_batch_local", "replicate", "all_gather_rows",
           "all_reduce_sum", "barrier", "process_index", "process_count",
           "DEFAULT_TIMEOUT_S"]

DATA_AXIS = "data"
# a collective whose peer died fails the run after this long instead of
# blocking it
DEFAULT_TIMEOUT_S = 600.0


def _log(msg: str) -> None:
    print(f"[qbold_vi_tpu_torch.parallel] {msg}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel mesh: ``world_size`` ranks, this process being
    ``rank`` on ``device``. ``backend`` is the process group's ("" for a
    one-rank mesh without a group, whose collectives are the identity)."""

    world_size: int
    rank: int
    device: torch.device
    backend: str = ""
    timed: bool = False
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    seconds: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def grouped(self) -> bool:
        return bool(self.backend)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> Optional[str]:
    """Join the process group of ``num_processes`` ranks, this one being
    ``process_id``, whose rendezvous is ``coordinator_address``
    ("HOST:PORT", served by rank 0); returns the backend. A no-op (None)
    without a coordinator, as in the JAX package.

    The rendezvous is a ``TCPStore`` at the coordinator -- what
    ``init_process_group(init_method="tcp://HOST:PORT")`` builds -- opened
    first, so that the ranks can post their cards and every rank can
    choose the same backend from them before the group exists. Each CUDA
    rank is pinned to card ``process_id % torch.cuda.device_count()``.
    ``timeout_s`` bounds the rendezvous and every collective."""
    if coordinator_address is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    host, port = coordinator_address.rsplit(":", 1)
    dev = require_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local = process_id % n_cards
        torch.cuda.set_device(local)
        card = torch.cuda.get_device_properties(local).uuid
        store.set(f"qbold/card/{process_id}", f"{socket.gethostname()}/{card}")
        backend, why = choose_backend(
            [store.get(f"qbold/card/{r}").decode()
             for r in range(num_processes)])
    else:
        why = "CPU ranks"
    if process_id == 0:
        _log(f"{num_processes} ranks, backend {backend} ({why})")
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return backend


def choose_backend(cards: list) -> tuple:
    """(backend, why) for CUDA ranks on ``cards`` (one "host/card" entry a
    rank): NCCL when no two ranks share a card, else gloo on CUDA tensors
    (NCCL refuses two ranks on one GPU)."""
    sharing = max(collections.Counter(cards).values())
    if sharing == 1:
        return "nccl", "one rank a card"
    return "gloo", (f"{sharing} ranks share a card, which NCCL refuses: "
                    "gloo on CUDA tensors")


def require_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device asked for where there
    is none raises (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for and no CUDA device is "
                           "available: pass device='cpu'")
    return device


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialised process group (every rank), or a
    one-rank mesh without a group. ``device``: the rank's card (the one
    initialize_distributed pinned) unless another is given ("cpu")."""
    device = require_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(1, 0, device)
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group runs on CUDA devices")
    return Mesh(dist.get_world_size(), dist.get_rank(), device, backend)


def process_index() -> int:
    """This process's rank in the initialised group (0 without one): the
    counterpart of ``jax.process_index()``."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The initialised group's world size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


# ---- layouts ----------------------------------------------------------------


def host_local_rows(mesh: Mesh, global_shape, dim: int = 0
                    ) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` rows of a ``dim``-sharded global array
    that this rank owns: JAX's chunked leading-axis layout, rows
    ``[d * chunk, (d + 1) * chunk)`` on device d, the sharded dimension
    divisible by the mesh (as a JAX NamedSharding requires)."""
    rows = (int(global_shape) if np.ndim(global_shape) == 0
            else int(global_shape[dim]))
    if rows % mesh.world_size:
        raise ValueError(
            f"array axis {dim} of size {rows} is partitioned "
            f"{mesh.world_size} times: the mesh size should evenly divide "
            "it (pad the rows, as the sharded maps do)")
    chunk = rows // mesh.world_size
    return mesh.rank * chunk, (mesh.rank + 1) * chunk


def crop_rows(b_global: int, world_size: int, rank: int) -> tuple[int, int]:
    """The ``[lo, hi)`` rows of a host-global batch of ``b_global`` rows
    that are rank's live slots under steps._device_crop_counts' layout:
    ``b // n + (d < b % n)`` rows a rank, in rank order."""
    base, rem = divmod(b_global, world_size)
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (rank < rem)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_device(mesh: Mesh, x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(mesh.device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def shard_batch(mesh: Mesh, batch: Any, time_axis: bool = False) -> Any:
    """This rank's rows (``host_local_rows``) of each array of a
    host-global pytree, on the rank's device; the columns (axis 1) with
    ``time_axis``, for (T, B, ...) stacks."""
    dim = 1 if time_axis else 0

    def put(x):
        lo, hi = host_local_rows(mesh, np.shape(x), dim)
        return _to_device(mesh, x[(slice(None),) * dim + (slice(lo, hi),)])

    return _tree_map(put, batch)


def shard_batch_local(mesh: Mesh, local_batch: Any, global_rows: int) -> Any:
    """Per-rank data feeding: each rank passes ONLY its own leading-axis
    rows of a global batch of ``global_rows`` rows (e.g. the subjects it
    loaded); the row counts are checked against the rank's range, and the
    arrays go to its device."""

    def put(x):
        lo, hi = host_local_rows(mesh, global_rows)
        if np.shape(x)[0] != hi - lo:
            raise ValueError(
                f"process {mesh.rank} passed {np.shape(x)[0]} local rows but "
                f"its devices own rows [{lo}, {hi}) of {global_rows}")
        return _to_device(mesh, x)

    return _tree_map(put, local_batch)


# ---- collectives ------------------------------------------------------------


def _collective(mesh: Mesh, name: str, tensors: list, run) -> None:
    """Run collective ``name`` through ``run(*tensors)``, which works on
    them in place; counted, and timed under ``mesh.timed``."""
    mesh.counts[name] += 1
    if not mesh.grouped:
        return
    cuda = tensors[0].device.type == "cuda"
    if mesh.timed:
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
    run(*tensors)
    if mesh.timed:
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        mesh.seconds[name] += time.perf_counter() - t0


def all_reduce_sum(mesh: Mesh, tensors: list) -> list:
    """The sums over ranks of ``tensors`` (float32, any shapes), through
    ONE all-reduce of a flat buffer; new tensors, shaped as given."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _collective(mesh, "all_reduce", [flat], dist.all_reduce)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def barrier(mesh: Mesh) -> None:
    """Every rank waits here for the others (a one-element all-reduce on
    the rank's device, which every backend runs)."""
    all_reduce_sum(mesh, [torch.zeros(1, device=mesh.device)])


def replicate(mesh: Mesh, tree: Any) -> Any:
    """A pytree of arrays / tensors with rank 0's values on every rank, on
    the rank's device: a broadcast from rank 0 a leaf (a tensor already on
    the device is overwritten in place and returned)."""

    def put(x):
        t = _to_device(mesh, x)
        _collective(mesh, "broadcast", [t], lambda u: dist.broadcast(u, 0))
        return t

    return _tree_map(put, tree)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order, each rank
    holding the same number: the counterpart of the JAX package's
    ``infer._fetch_global``."""
    x = x.contiguous()
    out = torch.empty((mesh.world_size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    out[mesh.rank] = x
    _collective(mesh, "all_gather", [out, x],
                lambda o, t: dist.all_gather(list(o.unbind(0)), t))
    return out.reshape((-1,) + tuple(x.shape[1:]))
