"""The `--mesh_shape` grammar (own copy of dotaclient_tpu/parallel/mesh.py
`parse_mesh_spec` and `_leaf_spec`) over the port's learner processes, one
card each.

The reference lays its mesh over every chip of every process and lets XLA
place the collectives. The port runs one process per card, so the mesh is
laid over the ranks: world = dp × g, g the product of the other axes (the
model axes). Rank r has dp index r // g and model coordinates r % g,
unravelled in the order the spec writes the axes after dp: dp-major, as the
reference requires (no axis of size > 1 may come ahead of dp). A tp or sp
axis of two or more therefore spans processes; parallel/dist.py makes a
rank group for each axis (and the groups the train step reduces over), and
parallel/train_step.py runs the collectives over them.

- `dp`: each dp index trains on its B / dp rows of the global batch;
- `tp`: a leaf whose last dim divides by tp and which has at least
  tp·128 elements is stored as tp column slices, one per tp rank (params
  and Adam moments alike, `leaf_sharded`); the compute runs on the
  gathered leaves;
- `sp` (`policy.tf_sp_axis`, the transformer family): the unroll's time
  axis is split over the sp ranks (ops/ring_attention.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _parse_axes(spec: str):
    """({axis: size as written}, the -1 axis or None)."""
    axes: Dict[str, int] = {}
    wild = None
    for part in spec.replace(" ", "").split(","):
        if not part:
            continue
        name, _, val = part.partition("=")
        size = int(val)
        if size == -1:
            if wild is not None:
                raise ValueError(f"multiple -1 axes in mesh spec {spec!r}")
            wild = name
        axes[name] = size
    return axes, wild


def parse_mesh_spec(spec: str, n_devices: int) -> Dict[str, int]:
    """Parse "dp=4,tp=2" (value -1 = all remaining devices) into axis sizes."""
    axes, wild = _parse_axes(spec)
    fixed = int(np.prod([s for s in axes.values() if s != -1])) if axes else 1
    if wild is not None:
        if n_devices % fixed:
            raise ValueError(f"{n_devices} devices not divisible by {fixed} ({spec!r})")
        axes[wild] = n_devices // fixed
    if int(np.prod(list(axes.values()))) != n_devices:
        raise ValueError(f"mesh spec {spec!r} does not cover {n_devices} devices")
    return axes


def resolve_mesh(spec: str, world: int) -> Dict[str, int]:
    """The axis sizes of `spec` over `world` processes, one card each, in
    the order written. ValueError for a malformed spec or one that does not
    cover the processes (parse_mesh_spec), and, over more than one
    process, the reference's multi-process rules: the mesh names a dp
    axis, and no axis of size > 1 comes ahead of it."""
    axes = parse_mesh_spec(spec, world)
    if world > 1:
        if "dp" not in axes:
            raise ValueError(f"multihost needs the mesh dp axis to span the processes: mesh {spec!r} names no dp "
                             f"axis over {world} processes (write --mesh_shape dp=...,<rest>)")
        ahead = 1
        for name, size in axes.items():
            if name == "dp":
                break
            ahead *= size
        if ahead != 1:
            raise ValueError(f"multihost needs 'dp' as the MAJOR mesh axis (no axis of size > 1 ahead of it); got "
                             f"{axes} — write --mesh_shape dp=...,<rest>")
    return axes


@dataclasses.dataclass(frozen=True)
class Layout:
    """Ranks laid over a resolved mesh, dp-major: `names` / `sizes` are
    dp first, then the other axes in the order written."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @classmethod
    def of(cls, axes: Dict[str, int]) -> "Layout":
        rest = [(n, s) for n, s in axes.items() if n != "dp"]
        return cls(("dp",) + tuple(n for n, _ in rest), (axes.get("dp", 1),) + tuple(s for _, s in rest))

    @property
    def world(self) -> int:
        return int(np.prod(self.sizes))

    def size(self, axis: str) -> int:
        return self.sizes[self.names.index(axis)] if axis in self.names else 1

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank → its index on every axis."""
        return dict(zip(self.names, np.unravel_index(rank, self.sizes)))

    def groups(self, axes: Sequence[str]) -> List[Tuple[int, ...]]:
        """The partition of the ranks into groups that vary over `axes`
        and share every other coordinate; each group in rank order, the
        groups in order of their first rank."""
        vary = [n for n in self.names if n in axes]
        fixed = [n for n in self.names if n not in axes]
        out = []
        for key in itertools.product(*(range(self.size(n)) for n in fixed)):
            at = dict(zip(fixed, key))
            ranks = []
            for idx in itertools.product(*(range(self.size(n)) for n in vary)):
                at.update(zip(vary, idx))
                ranks.append(int(np.ravel_multi_index([at[n] for n in self.names], self.sizes)))
            out.append(tuple(sorted(ranks)))
        return sorted(out)

    def model_axes(self) -> Tuple[str, ...]:
        return self.names[1:]


def leaf_sharded(shape, tp: int) -> bool:
    """The reference's `_leaf_spec` rule: a leaf is split over tp on its
    last (output-feature) dim when that dim divides by tp and the leaf has
    at least tp·128 elements; every other leaf is replicated."""
    shape = tuple(shape)
    return tp > 1 and len(shape) >= 1 and shape[-1] % tp == 0 and int(np.prod(shape)) >= tp * 128


def local_config(cfg, world: int):
    """`cfg` with `batch_size` this process's share, B / world rows: what
    its staging packs and its transfer layouts hold (the reference's
    `staging_cfg`)."""
    if world == 1:
        return cfg
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // world)
