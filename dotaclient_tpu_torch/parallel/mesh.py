"""The `--mesh_shape` grammar (own copy of dotaclient_tpu/parallel/mesh.py
`parse_mesh_spec`). The port runs on one device: a spec that resolves to
one device is accepted, any other is refused until multi-GPU data
parallelism lands (ROADMAP A.14)."""

from __future__ import annotations

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


def one_device_mesh(spec: str) -> Dict[str, int]:
    """The axis sizes of `spec` on one device. A malformed spec raises
    ValueError; one with an axis of two or more devices raises
    NotImplementedError naming ROADMAP A.14."""
    axes, _ = _parse_axes(spec)
    if any(size >= 2 for size in axes.values()):
        raise NotImplementedError(
            f"mesh_shape={spec!r} spans more than one device: the port runs on one device "
            f"(multi-GPU data parallelism is ROADMAP A.14)"
        )
    return parse_mesh_spec(spec, 1)
