"""Data parallelism across learner processes, one card each (the port's
counterpart of the reference's `jax.distributed` layer).

The reference joins its processes with `jax.distributed.initialize` and
lets XLA insert the gradient all-reduce into its SPMD step. The port runs
one learner process per card, and the train step calls the few
collectives it needs through a `Dist`:

- `all_reduce_`: a sum over the ranks, in place (the loss statistics and
  the gradient bucket of each update);
- `all_gather_rows`: the batch-leading leaves of a tree concatenated in
  rank order, as the reference assembles the processes' shares (the reuse
  step's frozen batch);
- `host_all_gather`: one host number from every rank (resume steps, the
  published high-water mark, peak FLOP/s, the loop's step votes), over a
  gloo group of its own.

`init_distributed` makes a `Dist` from the learner's flags: `coordinator`
is the rendezvous address, `num_processes` the world size and
`process_id` the rank; a flag left unset defers to torch's env rendezvous
(MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK), as the reference's unset
flags defer to jax's autodetection. The step's collectives run over NCCL
on a card and gloo on the CPU. A world of one joins its rendezvous all the
same, and then every collective is the identity: the step is the plain
one. `Dist()`, with no process group at all, is a single process.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.ops.batch import tree_flatten, tree_unflatten

_log = logging.getLogger(__name__)


class Dist:
    """This process's place among the data-parallel learner processes."""

    def __init__(self, world: int = 1, rank: int = 0, device: Optional[torch.device] = None, host_group=None,
                 stage: bool = False, joined: bool = False):
        self.world = world
        self.rank = rank
        self.device = device
        # the step's collectives use the default group; host numbers this
        # gloo group (None: the default group is gloo already)
        self._host_group = host_group
        # gloo over a card's tensors: collectives go through host copies
        self._stage = stage
        self._joined = joined  # a member of torch.distributed's default group

    @property
    def is_primary(self) -> bool:
        """Process 0: the one that publishes weights and pushes the mirror."""
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns `t`. Every rank gets the
        same bits."""
        if self.world == 1:
            return t
        buf = t.cpu() if self._stage else t
        torch.distributed.all_reduce(buf)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather_rows(self, tree):
        """The batch-leading leaves of `tree` (every rank's tree has the same
        structure and row count) concatenated across the ranks in rank
        order, as one collective over their bytes."""
        if self.world == 1:
            return tree
        leaves, structure = tree_flatten(tree)
        rows = leaves[0].shape[0]
        cols = [x.reshape(rows, -1).contiguous().view(torch.uint8) for x in leaves]
        src = torch.cat(cols, dim=1)
        if self._stage:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        torch.distributed.all_gather(parts, src)
        full = torch.cat(parts).to(leaves[0].device)
        out, off = [], 0
        for x, c in zip(leaves, cols):
            width = c.shape[1]
            out.append(full[:, off : off + width].contiguous().view(x.dtype).reshape((-1,) + tuple(x.shape[1:])))
            off += width
        return tree_unflatten(structure, out)

    def host_all_gather(self, value: float) -> List[float]:
        """`value` from every rank, in rank order (float64: integers up to
        2**53 are exact; NaN stands for "none")."""
        if self.world == 1:
            return [float(value)]
        t = torch.tensor([float(value)], dtype=torch.float64)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        torch.distributed.all_gather(parts, t, group=self._host_group)
        return [float(p) for p in parts]

    def close(self) -> None:
        """Leave the process group (a no-op for a single process)."""
        if self._joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
            self._joined = False


def _rendezvous(cfg):
    """(address "host:port", world size, rank) from the flags, each unset
    one from torch's env rendezvous; ValueError naming what neither has."""
    addr = cfg.coordinator
    if not addr and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = cfg.num_processes if cfg.num_processes >= 0 else int(os.environ.get("WORLD_SIZE", -1))
    rank = cfg.process_id if cfg.process_id >= 0 else int(os.environ.get("RANK", -1))
    missing = [what for what, unset in (("--coordinator (or MASTER_ADDR and MASTER_PORT)", not addr),
                                        ("--num_processes (or WORLD_SIZE)", world < 1),
                                        ("--process_id (or RANK)", rank < 0)) if unset]
    if missing:
        raise ValueError(f"multihost: no {', no '.join(missing)}")
    if rank >= world:
        raise ValueError(f"multihost: process_id={rank} is not below num_processes={world}")
    return addr, world, rank


def _rank_device(rank: int) -> torch.device:
    """This rank's card: LOCAL_RANK's where a launcher set it, else
    rank modulo the cards the host has."""
    resolve_device(None)  # raises when there is no card
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_distributed(cfg, device=None, backend: Optional[str] = None) -> Dist:
    """Join the learner processes' rendezvous (`cfg.coordinator`,
    `num_processes`, `process_id`, each unset one from torch's env) and
    return this rank's Dist. `device` None is this rank's card. `backend`
    None is NCCL on a card and gloo on the CPU; gloo on a card stages every
    collective through host copies (two ranks sharing one card, which NCCL
    refuses)."""
    addr, world, rank = _rendezvous(cfg)
    device = _rank_device(rank) if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    torch.distributed.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank, **kw)
    host_group = torch.distributed.new_group(backend="gloo") if backend != "gloo" else None
    _log.info("multihost: rank %d of %d on %s over %s (rendezvous %s)", rank, world, device, backend, addr)
    return Dist(world, rank, device, host_group=host_group, stage=backend == "gloo" and device.type == "cuda",
                joined=True)
