"""The process group (the counterpart of
`mxnet_tpu/parallel/distributed.py`: ``initialize``, ``rank``, ``size``,
``barrier`` and ``global_mesh``).

The reference wires its processes with the launcher's env contract
(``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` / ``DMLC_NUM_WORKER`` /
``DMLC_WORKER_ID``, `include/mxnet/kvstore.h:282-326`), which
`tools/launch.py` sets for each process.  Here they form one
`torch.distributed` group: a TCP store at ``ROOT_URI:ROOT_PORT`` (the
async parameter server binds ``ROOT_PORT + 1``, `ps_server.ps_port`), over
NCCL where every rank has a card of its own and over gloo otherwise (on
the CPU, or with several ranks sharing one card: NCCL refuses two ranks
on one device).

The collectives of the ``dist`` stores go through `all_gather_sum` and
`all_gather`.  Over gloo a device tensor is copied to the host, gathered
there and copied back; over NCCL it is gathered on its card.  The sum
adds the ranks' contributions in rank order, one elementwise ``+`` at a
time, so every rank gets the same bits, and a bucket of concatenated keys
sums to the same bits as the keys one by one.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as tdist

from .. import config
from ..base import MXNetError

__all__ = ["initialize", "rank", "size", "barrier", "is_initialized",
           "backend", "all_gather", "all_gather_sum", "new_group",
           "gather_parts", "global_mesh"]

#: seconds the group waits for its ranks to join, and a collective for
#: its peers, when ``initialize`` is given no ``timeout``
DEFAULT_TIMEOUT_S = 300.0

_state = {"initialized": False}


def _group_up() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _pick_backend(num_processes: int) -> str:
    """NCCL where each rank has a card of its own, gloo otherwise."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes and \
            tdist.is_nccl_available():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Join the group of processes.

    Arguments absent fall back to the launcher's env:
    ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT`` is the store's address,
    ``DMLC_NUM_WORKER`` (else ``MXTPU_NUM_PROCESSES``) the world size,
    ``DMLC_WORKER_ID`` (else ``MXTPU_PROCESS_ID``) this rank.  One process
    (no env) is a no-op, as ``launch.py -n 1``, and a later call reads the
    env again; a group of one forms only when the caller passes the
    store's address itself (a one-rank NCCL group, say).  A group that
    does not form within ``timeout`` seconds raises `MXNetError`."""
    explicit_one = coordinator_address is not None and num_processes == 1
    if _group_up():
        _state["initialized"] = True
        return
    if coordinator_address is None:
        # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
        if uri:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None:
        # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
        n = os.environ.get("DMLC_NUM_WORKER") or \
            config.get_env("MXTPU_NUM_PROCESSES")
        num_processes = int(n) if n else None
    if process_id is None:
        # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
        r = os.environ.get("DMLC_WORKER_ID")
        if r is None:
            r = config.get_env("MXTPU_PROCESS_ID")
        process_id = int(r) if r is not None else None
    if num_processes and (num_processes > 1 or explicit_one):
        if not coordinator_address or process_id is None:
            raise MXNetError(
                f"a group of {num_processes} processes needs the store's "
                "address and this process's rank (DMLC_PS_ROOT_URI, "
                "DMLC_PS_ROOT_PORT, DMLC_WORKER_ID)")
        backend = backend or _pick_backend(num_processes)
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        secs = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)
        try:
            tdist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=secs))
        except Exception as e:  # the store's or the backend's own error
            raise MXNetError(
                f"the group of {num_processes} processes at "
                f"{coordinator_address} did not form (rank {process_id}, "
                f"{backend}): {e}") from e
    _state["initialized"] = True


def is_initialized() -> bool:
    return _state["initialized"]


def rank() -> int:
    """This process's rank (reference `KVStore::get_rank`)."""
    return tdist.get_rank() if _group_up() else 0


def size() -> int:
    """The number of processes (reference `KVStore::get_group_size`)."""
    return tdist.get_world_size() if _group_up() else 1


def backend() -> Optional[str]:
    """The group's backend, or None without a group."""
    return str(tdist.get_backend()) if _group_up() else None


def barrier(name: str = "mxnet_tpu_barrier") -> None:
    """Every process waits for the others (reference
    `KVStore::Barrier`, `include/mxnet/kvstore.h:364`)."""
    if size() > 1:
        tdist.barrier()


_WIRE_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def new_group(ranks):
    """The sub-group of ``ranks``, formed by its members alone (the others
    need not call), with the group's collective timeout."""
    return tdist.new_group(sorted(int(r) for r in ranks),
                           timeout=datetime.timedelta(
                               seconds=DEFAULT_TIMEOUT_S),
                           use_local_synchronization=True)


def gather_parts(t: torch.Tensor, group=None,
                 line=None) -> List[torch.Tensor]:
    """Every member's ``t`` (the members of ``group``, by default the
    whole group), in the order of ``line`` (their global ranks; rank
    order by default), on the device the backend gathers on: the tensor's
    card for NCCL, the host for gloo, where a device tensor is copied
    over synchronously first."""
    if group is None and size() <= 1:
        return [t]
    parts = _gather_on(t, group)
    if line is None:
        return parts
    by_rank = dict(zip(sorted(line), parts))
    return [by_rank[r] for r in line]


def _gather_on(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order, on the device the backend
    gathers on (the tensor's card for NCCL, the host for gloo)."""
    if backend() != "nccl" and t.device.type != "cpu":
        # gloo on the host: a synchronous copy, so the tensor's producer
        # on any stream of this thread has finished before the wire
        # reads it
        t = t.to("cpu")
    t = t.contiguous()
    # gloo has no unsigned words wider than a byte: they travel as the
    # signed type of their width, bit for bit
    wire = _WIRE_VIEW.get(t.dtype)
    src = t.view(wire) if wire is not None else t
    n = size() if group is None else tdist.get_world_size(group)
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return [p.view(t.dtype) for p in parts] if wire is not None else parts


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t``, on ``t``'s device."""
    if size() <= 1:
        return t.unsqueeze(0)
    return torch.stack(_gather_on(t)).to(t.device)


def all_gather_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t``, added in rank order, on ``t``'s
    device: the same bits on every rank, and elementwise, so a bucket of
    concatenated keys sums as the keys do one by one."""
    if size() <= 1:
        return t
    parts = _gather_on(t)
    total = parts[0].clone()
    for p in parts[1:]:
        total.add_(p)
    return total.to(t.device)


def global_mesh(tp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1):
    """A mesh over every rank of the group (dp fills the remainder): pass
    it to `SPMDTrainer` for data and model parallelism across
    processes."""
    from .mesh import auto_mesh
    return auto_mesh(size(), tp=tp, pp=pp, sp=sp, ep=ep)
