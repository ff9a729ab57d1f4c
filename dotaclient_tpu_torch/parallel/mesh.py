"""The `--mesh_shape` grammar (own copy of dotaclient_tpu/parallel/mesh.py
`parse_mesh_spec`) over the port's data-parallel processes, one card each.

The reference lays its mesh over every chip of every process and needs
`dp` as the major axis, so that each tp / sp axis stays inside one
process. The port runs one process per card: `dp` is the world size, and
a tp or sp axis of two or more would span processes, which needs rank
groups of its own (ROADMAP A.14b) and is refused. With every other axis of
size 1, the reference's rules that dp spans the processes and that no
axis of size > 1 comes ahead of it hold by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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


def _refuse_model_axes(spec: str, axes: Dict[str, int]) -> None:
    beyond = {name: size for name, size in axes.items() if name != "dp" and size >= 2}
    if beyond:
        raise NotImplementedError(
            f"mesh_shape={spec!r} shards the model over {beyond}: the port runs one process per card with "
            f"data parallelism only (tensor and sequence parallelism over rank groups is ROADMAP A.14b)"
        )


def resolve_mesh(spec: str, world: int) -> Dict[str, int]:
    """The axis sizes of `spec` over `world` processes, one card each. A
    malformed spec, or one that does not cover the processes, raises
    ValueError as parse_mesh_spec does; a tp / sp axis of two or more
    raises NotImplementedError naming ROADMAP A.14b."""
    _refuse_model_axes(spec, _parse_axes(spec)[0])
    axes = parse_mesh_spec(spec, world)
    _refuse_model_axes(spec, axes)
    return axes


def local_config(cfg, world: int):
    """`cfg` with `batch_size` this process's share, B / world rows: what
    its staging packs and its transfer layouts hold (the reference's
    `staging_cfg`)."""
    if world == 1:
        return cfg
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // world)
