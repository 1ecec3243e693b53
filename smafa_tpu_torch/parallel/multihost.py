"""Multi-process bring-up over ``torch.distributed``: one process per GPU.

Counterpart of ``smafa_tpu.parallel.multihost``. Every process runs the
same command with its own ``--process-id`` (SPMD); each holds only its
row shard of the db (``parallel.sharded.ShardedRunner``) or of the
cluster's centroid buffer, results merge through collectives
(``parallel.comm.Comm``), and process 0 alone writes output.

- ``initialize`` starts the process group at ``tcp://<coordinator>``
  with a finite timeout, so a dead peer fails the run instead of hanging
  it. With no coordinator and one process (or none given) it does
  nothing, as in ``smafa_tpu``.
- The device: ``cuda:LOCAL_RANK`` if that variable is set, else
  ``cuda:(process_id % torch.cuda.device_count())``; the CPU when the
  run asked for it (``SMAFA_TPU_TORCH_DEVICE=cpu``). Unlike
  ``smafa_tpu``, which meshes every device a process sees, a process
  uses one card.
- The backend: the default group is gloo, and carries the host
  exchanges. Device tensors go through NCCL when the device is a card
  and no two ranks hold the same card of one host (the ranks exchange
  their host names and card indices to decide, so every rank decides
  alike); else through gloo. NCCL refuses two ranks on one card
  ("Duplicate GPU detected"), so two ranks sharing a card, and every
  CPU run, use gloo. A backend that fails to start raises: nothing
  falls back after a failure.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

from smafa_tpu_torch.parallel.comm import Comm

logger = logging.getLogger("smafa")

# A collective that waits longer than this for a peer fails the run.
TIMEOUT = datetime.timedelta(seconds=600)

_COMM: Comm | None = None  # the process's collectives, once initialized


def initialize(coordinator: str | None, num_processes: int | None,
               process_id: int | None,
               device: torch.device) -> torch.device:
    """Join the run's process group; returns this rank's device (``device``
    itself when there is no group to join)."""
    global _COMM
    if coordinator is None and num_processes in (None, 1):
        return device
    if _COMM is not None:
        raise RuntimeError("torch.distributed is already initialized")
    if coordinator is None:
        raise ValueError("--num-processes needs --coordinator HOST:PORT")
    size = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None and size == 1 else process_id
    if rank is None or not 0 <= rank < size:
        raise ValueError(f"--process-id {process_id} is not in "
                         f"[0, {size}) (--num-processes {size})")
    device = torch.device(device)
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else rank % torch.cuda.device_count())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=size, rank=rank, timeout=TIMEOUT)
    world = dist.group.WORLD
    nccl, card_ranks = False, 1
    if device.type == "cuda":
        seats = [None] * size
        dist.all_gather_object(seats, (socket.gethostname(), device.index))
        nccl = len(set(seats)) == size
        card_ranks = seats.count(seats[rank])
    device_group = world
    if nccl:
        device_group = dist.new_group(backend="nccl", timeout=TIMEOUT)
        # NCCL starts lazily: one collective now, so a failure raises here
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe, group=device_group)
        if int(probe.item()) != size:
            raise RuntimeError(f"NCCL all_reduce gave {int(probe.item())}, "
                               f"expected {size}")
    _COMM = Comm(rank, size, device_group, world, nccl, card_ranks)
    logger.info("distributed: rank %d of %d on %s, device collectives %s, "
                "host exchanges gloo", rank, size, device,
                "nccl" if nccl else "gloo")
    return device


def comm() -> Comm | None:
    """The process's collectives, None without a process group."""
    return _COMM


def rank() -> int:
    return 0 if _COMM is None else _COMM.rank


def world_size() -> int:
    return 1 if _COMM is None else _COMM.size


def is_emitter() -> bool:
    """Process 0 writes output; the others write nothing."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group (after the run's last collective)."""
    global _COMM
    if _COMM is not None:
        dist.destroy_process_group()
        _COMM = None
