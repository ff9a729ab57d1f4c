"""Weight bridge: flax-named (name, ndarray) pairs ↔ a torch PolicyNet,
and the same for the optimizer's Adam state.

The pairs take the exact form of the reference's
`transport/serialize.py::flatten_params`: sorted by name, f32 arrays,
names like `params/core/unit_mlp1/kernel` and `params/core/lstm/w_h`. The
torch module tree uses the same names with dots, and Dense kernels keep
the flax [in, out] layout, so nothing is transposed. The Adam state
travels as `count` plus `mu/<param name>` and `nu/<param name>` pairs, so
an optax `ScaleByAdamState` and the port's `AdamState` carry across.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn

from dotaclient_tpu_torch.ops.clip_adam import AdamState

_PREFIX = "params/"


def _flax_name(torch_name: str) -> str:
    return _PREFIX + torch_name.replace(".", "/")


def named_tensors(net: nn.Module) -> Dict[str, torch.Tensor]:
    """flax path -> the net's parameter itself, sorted by path."""
    return dict(sorted((_flax_name(n), p) for n, p in net.named_parameters()))


def _to_host(tensors: Dict[str, torch.Tensor]) -> List[Tuple[str, np.ndarray]]:
    """f32 host copies in one device-to-host transfer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors.values()]).cpu().numpy()
    out, off = [], 0
    for name, t in tensors.items():
        out.append((name, flat[off : off + t.numel()].reshape(tuple(t.shape))))
        off += t.numel()
    return out


def named_params(net: nn.Module) -> List[Tuple[str, np.ndarray]]:
    """(flax path, f32 ndarray) pairs in sorted order."""
    return _to_host(named_tensors(net))


def named_adam_state(state: AdamState) -> List[Tuple[str, np.ndarray]]:
    """("count", int32 scalar), then ("mu/<param>", f32), ("nu/<param>", f32)."""
    moments = {**{f"mu/{n}": t for n, t in state.mu.items()}, **{f"nu/{n}": t for n, t in state.nu.items()}}
    return [("count", np.asarray(int(state.count), np.int32))] + _to_host(moments)


def load_named_adam(named: Iterable[Tuple[str, np.ndarray]], net: nn.Module) -> AdamState:
    """An AdamState for `net`'s parameters from `named_adam_state`-shaped
    pairs, on the net's device. Names and shapes must match exactly."""
    lookup = dict(named)
    params = named_tensors(net)
    want = {"count"} | {f"{k}/{n}" for k in ("mu", "nu") for n in params}
    if set(lookup) != want:
        raise ValueError(f"adam state names differ: missing {sorted(want - set(lookup))}, unexpected {sorted(set(lookup) - want)}")
    moments = {}
    for k in ("mu", "nu"):
        moments[k] = {}
        for n, p in params.items():
            arr = np.array(lookup[f"{k}/{n}"], np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {k}/{n}: {arr.shape} vs {tuple(p.shape)}")
            moments[k][n] = torch.from_numpy(arr).to(p.device)
    count = torch.tensor(int(lookup["count"]), dtype=torch.int32, device=next(iter(params.values())).device)
    return AdamState(count, moments["mu"], moments["nu"])


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
