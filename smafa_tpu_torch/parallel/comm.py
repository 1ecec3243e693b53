"""Collectives of a multi-process run: one object per process, built by
``parallel.multihost.initialize``.

A tensor's collective runs where the tensor lives:

- a CUDA tensor goes through the device group: NCCL when every rank on
  the host has a card of its own, else gloo, through pinned host memory
  (gloo does not implement every collective on CUDA tensors, so this
  stages explicitly: copy out, collective, copy back);
- a CPU tensor goes through the host group (gloo), which also carries
  the host exchanges: the query split's metadata and batches, the resume
  broadcasts and the compactions' hit lists.

On a CPU-only run both groups are the one gloo group. Every rank must
call the same collectives in the same order (``torch.distributed``'s
contract); results come back on the input's device, in rank order.

``LocalComm`` is the one-rank counterpart: its collectives return their
input, so a layout forced in a single-process run builds over it, as
``smafa_tpu`` builds it over a one-device mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class Comm:
    """``rank`` of ``size`` processes; ``device_group`` and ``host_group``
    as ``torch.distributed`` groups; ``device_nccl`` says whether CUDA
    tensors go through NCCL; ``card_ranks`` is the number of ranks on
    this rank's card, itself included (1 on the CPU)."""

    def __init__(self, rank: int, size: int, device_group, host_group,
                 device_nccl: bool, card_ranks: int = 1):
        self.rank, self.size = rank, size
        self._device_group, self._host_group = device_group, host_group
        self.device_nccl = device_nccl
        self.card_ranks = card_ranks

    def _route(self, t: torch.Tensor):
        """(tensor to hand to torch.distributed, its group)."""
        if not t.is_cuda:
            return t.contiguous(), self._host_group
        if self.device_nccl:
            return t.contiguous(), self._device_group
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)  # waits for the current stream's work on t
        return host, self._device_group

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), in rank order."""
        x, group = self._route(t)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=group)
        return [o.to(t.device, non_blocking=True) for o in out]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """The elementwise ``op`` (sum, min or max) of every rank's ``t``,
        as a new tensor."""
        x, group = self._route(t)
        if x is t:
            x = t.clone()
        dist.all_reduce(x, op=_OPS[op], group=group)
        return x.to(t.device, non_blocking=True)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t``; the other ranks pass a tensor of its shape
        and dtype."""
        x, group = self._route(t)
        if x is t:
            x = t.clone()
        dist.broadcast(x, src, group=group)
        return x.to(t.device, non_blocking=True)

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """What rank ``(rank - 1) % size`` passes, while ``t`` goes to rank
        ``(rank + 1) % size`` (one shape on every rank): the ring step,
        ``lax.ppermute`` over the forward neighbours in ``smafa_tpu``."""
        if self.size == 1:
            return t
        x, group = self._route(t)
        got = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (self.rank + 1) % self.size,
                       group=group),
            dist.P2POp(dist.irecv, got, (self.rank - 1) % self.size,
                       group=group)])
        for req in reqs:
            req.wait()
        return got.to(t.device, non_blocking=True)

    def gather_var(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t``, whose first dimension may differ between
        ranks (the rest may not), in rank order: the lengths first, then
        the tensors padded to the longest."""
        n = torch.tensor([t.shape[0]], dtype=torch.int64)
        lengths = [int(v) for v in self.all_gather(n)]
        pad = torch.zeros((max(lengths), *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[:t.shape[0]] = t
        return [p[:k] for p, k in zip(self.all_gather(pad), lengths)]


class LocalComm:
    """The collectives of a run of one process: each returns its input."""

    rank, size, device_nccl, card_ranks = 0, 1, False, 1

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        return [t]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        return t

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def gather_var(self, t: torch.Tensor) -> list[torch.Tensor]:
        return [t]
