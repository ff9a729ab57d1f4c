"""The port's learner processes, one card each, and the rank groups the
train step runs its collectives over (the port's counterpart of the
reference's `jax.distributed` layer and its mesh axes).

The reference joins its processes with `jax.distributed.initialize` and
lets XLA place the collectives of its SPMD step. The port runs one learner
process per card, lays `--mesh_shape` over the ranks (parallel/mesh.py
Layout: dp-major, world = dp × the model axes) and calls the collectives it
needs through a `Dist` and its `Group`s:

- `Dist.group(*axes)`: the ranks that vary over `axes` and share every
  other coordinate. "dp" reduces the loss statistics and the metrics, the
  model axes (`group(*layout.model_axes())`) share one dp index's rows,
  "sp" splits the unroll's time axis, "tp" the sharded leaves, and
  ("dp", sp) is where a sequence-parallel gradient is summed;
- a Group's `all_reduce_` (a sum, in place), `all_gather_rows` (the
  batch-leading leaves of a tree concatenated in group order), `all_gather`
  (along a dim), `all_to_all` (chunk j of dim 0 to member j) and `shift`
  (a ring: to the next member, from the previous one);
- `host_all_gather`: one host number from every rank (resume steps, the
  published high-water mark, peak FLOP/s, the loop's step votes), over a
  gloo group of its own, world-wide.

`init_distributed` makes a `Dist` from the learner's flags: `coordinator`
is the rendezvous address, `num_processes` the world size and
`process_id` the rank; a flag left unset defers to torch's env rendezvous
(MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK), as the reference's unset
flags defer to jax's autodetection. The step's collectives run over NCCL
on a card and gloo on the CPU; gloo on a card stages every collective
through host copies (two ranks sharing one card, which NCCL refuses). A
world of one joins its rendezvous all the same, and then every collective
is the identity: the step is the plain one. `Dist()`, with no process group
at all, is a single process.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.ops.batch import tree_flatten, tree_unflatten
from dotaclient_tpu_torch.parallel.mesh import Layout, resolve_mesh

_log = logging.getLogger(__name__)


class Group:
    """A set of ranks that run collectives together: `ranks` in order,
    this rank's `index` among them. A group of one runs nothing; `pg` None
    with more than one member is torch's default (world) group."""

    def __init__(self, ranks: Sequence[int], rank: int, pg=None, stage: bool = False):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self._pg = pg
        self._stage = stage  # gloo over a card's tensors: through host copies

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._stage else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the members, in place; returns `t`. Every member
        gets the same bits."""
        if self.size == 1:
            return t
        buf = self._host(t)
        torch.distributed.all_reduce(buf, group=self._pg)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every member's `t` (equal shapes) concatenated along `dim` in
        group order; on t's device. No autograd."""
        if self.size == 1:
            return t
        src = self._host(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.size)]
        torch.distributed.all_gather(parts, src, group=self._pg)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_gather_rows(self, tree):
        """The batch-leading leaves of `tree` (every member's tree has the
        same structure and row count) concatenated across the members in
        group order, as one collective over their bytes."""
        if self.size == 1:
            return tree
        leaves, structure = tree_flatten(tree)
        rows = leaves[0].shape[0]
        cols = [x.reshape(rows, -1).contiguous().view(torch.uint8) for x in leaves]
        full = self.all_gather(torch.cat(cols, dim=1))
        out, off = [], 0
        for x, c in zip(leaves, cols):
            width = c.shape[1]
            out.append(full[:, off : off + width].contiguous().view(x.dtype).reshape((-1,) + tuple(x.shape[1:])))
            off += width
        return tree_unflatten(structure, out)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk j of `t`'s dim 0 (size divisible by the group's) goes to
        member j; the result's chunk i came from member i. No autograd."""
        if self.size == 1:
            return t
        src = self._host(t.contiguous())
        out = torch.empty_like(src)
        torch.distributed.all_to_all_single(out, src, group=self._pg)
        return out.to(t.device)

    def shift(self, t: torch.Tensor, hops: int = 1) -> torch.Tensor:
        """The ring: `t` goes to member index + hops, and the result is the
        tensor of member index − hops (indices modulo the size). No
        autograd."""
        if self.size == 1 or hops % self.size == 0:
            return t
        src = self._host(t.contiguous())
        out = torch.empty_like(src)
        dst_rank = self.ranks[(self.index + hops) % self.size]
        src_rank = self.ranks[(self.index - hops) % self.size]
        ops = [torch.distributed.P2POp(torch.distributed.isend, src, dst_rank, group=self._pg),
               torch.distributed.P2POp(torch.distributed.irecv, out, src_rank, group=self._pg)]
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)


def _layout_groups(layout: Layout, rank: int, stage: bool, make) -> Dict[Tuple[str, ...], Group]:
    """One Group per set of axes the step uses, each member of this rank's
    partition. `make(ranks)` creates a process group; torch's new_group is
    collective over the whole world, so every rank creates every group of
    every partition, in the same order."""
    kinds = [("dp",), layout.model_axes()] + [(n,) for n in layout.model_axes()]
    kinds += [("dp", n) for n in layout.model_axes()]
    made: Dict[Tuple[int, ...], object] = {}
    out: Dict[Tuple[str, ...], Group] = {}
    for axes in kinds:
        for ranks in layout.groups(axes):
            if len(ranks) not in (1, layout.world) and ranks not in made:
                made[ranks] = make(list(ranks))
            if rank in ranks:
                out[tuple(sorted(axes))] = Group(ranks, rank, made.get(ranks), stage)
    return out


class Dist:
    """This process's place among the learner processes and its groups."""

    def __init__(self, world: int = 1, rank: int = 0, device: Optional[torch.device] = None, host_group=None,
                 joined: bool = False, axes: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[Tuple[str, ...], Group]] = None):
        self.world = world
        self.rank = rank
        self.device = device
        self.axes = dict(axes) if axes is not None else {"dp": world}
        self.layout = Layout.of(self.axes)
        if self.layout.world != world:
            raise ValueError(f"mesh {self.axes} does not cover {world} processes")
        if groups is None:
            # no process group of our own: the world is one dp group
            if world != self.layout.size("dp"):
                raise ValueError(f"mesh {self.axes}: model axes need the rank groups of init_distributed")
            groups = {("dp",): Group(range(world), rank)}
        self._groups = groups
        # host numbers go over this gloo group (None: the default group is gloo already)
        self._host_group = host_group
        self._joined = joined  # a member of torch.distributed's default group

    @property
    def is_primary(self) -> bool:
        """Process 0: the one that publishes weights and pushes the mirror."""
        return self.rank == 0

    def group(self, *axes: str) -> Group:
        """The ranks that vary over `axes` (axes of size 1 and absent ones
        add nobody) and share every other coordinate."""
        axes = tuple(sorted(a for a in axes if self.layout.size(a) > 1))
        if not axes:
            return Group((self.rank,), self.rank)
        if axes not in self._groups:
            raise KeyError(f"no rank group over {axes} in mesh {self.axes}")
        return self._groups[axes]

    @property
    def model(self) -> Group:
        """The ranks of this rank's dp index: they train on the same rows."""
        return self.group(*self.layout.model_axes())

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
    `num_processes`, `process_id`, each unset one from torch's env), lay
    `cfg.mesh_shape` over the ranks and return this rank's Dist with its
    groups. `device` None is this rank's card. `backend` None is NCCL on a
    card and gloo on the CPU; gloo on a card stages every collective
    through host copies (two ranks sharing one card, which NCCL refuses)."""
    addr, world, rank = _rendezvous(cfg)
    axes = resolve_mesh(cfg.mesh_shape, world)
    device = _rank_device(rank) if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    torch.distributed.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank, **kw)
    host_group = torch.distributed.new_group(backend="gloo") if backend != "gloo" else None
    stage = backend == "gloo" and device.type == "cuda"
    groups = _layout_groups(Layout.of(axes), rank, stage, lambda ranks: torch.distributed.new_group(ranks))
    _log.info("multihost: rank %d of %d on %s over %s (rendezvous %s, mesh %s)", rank, world, device, backend, addr,
              axes)
    return Dist(world, rank, device, host_group=host_group, joined=True, axes=axes, groups=groups)
