"""Weight bridge: flax-named (name, ndarray) pairs ↔ a torch PolicyNet.

The pairs take the exact form of the reference's
`transport/serialize.py::flatten_params`: sorted by name, f32 arrays,
names like `params/core/unit_mlp1/kernel` and `params/core/lstm/w_h`. The
torch module tree uses the same names with dots, and Dense kernels keep
the flax [in, out] layout, so nothing is transposed.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch
from torch import nn

_PREFIX = "params/"


def _flax_name(torch_name: str) -> str:
    return _PREFIX + torch_name.replace(".", "/")


def named_params(net: nn.Module) -> List[Tuple[str, np.ndarray]]:
    """(flax path, f32 ndarray) pairs in sorted order."""
    out = [(_flax_name(n), p.detach().to("cpu", torch.float32).numpy()) for n, p in net.named_parameters()]
    return sorted(out, key=lambda kv: kv[0])


@torch.no_grad()
def load_named(net: nn.Module, named: Iterable[Tuple[str, np.ndarray]]) -> nn.Module:
    """Copy every pair into `net`'s parameters. The name sets must match
    exactly and every shape must agree; raises ValueError otherwise."""
    lookup = dict(named)
    params = {_flax_name(n): p for n, p in net.named_parameters()}
    missing, extra = sorted(set(params) - set(lookup)), sorted(set(lookup) - set(params))
    if missing or extra:
        raise ValueError(f"param names differ: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        arr = np.array(lookup[name], np.float32)  # a writable copy: wire buffers are read-only
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr))
    return net
