"""Weight bridge: flax-named (name, ndarray) pairs ↔ a torch PolicyNet,
and the same for the optimizer's Adam state.

The pairs take the exact form of the reference's
`transport/serialize.py::flatten_params`: sorted by name, f32 arrays,
names like `params/core/unit_mlp1/kernel` and `params/core/lstm/w_h`. The
torch module tree uses the same names with dots, and Dense kernels keep
the flax [in, out] layout, so nothing is transposed. The Adam state
travels as `count` plus `mu/<param name>` and `nu/<param name>` pairs, so
an optax `ScaleByAdamState` and the port's `AdamState` carry across.

Under tensor parallelism a tp rank keeps column slices of the leaves that
the reference's `_leaf_spec` shards (parallel/mesh.py leaf_sharded), by
flax name: `TensorShards` cuts them (`shard`), puts the whole leaves back
together over the tp group (`gather`, one collective) and lends them to a
net for a forward and backward (`gathered`). `state_tensors` is a train
state's params and Adam moments, whole.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dotaclient_tpu_torch.ops.clip_adam import AdamState
from dotaclient_tpu_torch.parallel.mesh import leaf_sharded

_PREFIX = "params/"


def _flax_name(torch_name: str) -> str:
    return _PREFIX + torch_name.replace(".", "/")


def named_tensors(net: nn.Module) -> Dict[str, torch.Tensor]:
    """flax path -> the net's parameter itself, sorted by path."""
    return dict(sorted((_flax_name(n), p) for n, p in net.named_parameters()))


def host_named(tensors: Dict[str, torch.Tensor]) -> List[Tuple[str, np.ndarray]]:
    """f32 host copies in one device-to-host transfer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors.values()]).cpu().numpy()
    out, off = [], 0
    for name, t in tensors.items():
        out.append((name, flat[off : off + t.numel()].reshape(tuple(t.shape))))
        off += t.numel()
    return out


def named_params(net: nn.Module) -> List[Tuple[str, np.ndarray]]:
    """(flax path, f32 ndarray) pairs in sorted order."""
    return host_named(named_tensors(net))


def adam_moments(state: AdamState) -> Dict[str, torch.Tensor]:
    """"mu/<param name>" and "nu/<param name>" -> the moment tensor."""
    return {**{f"mu/{n}": t for n, t in state.mu.items()}, **{f"nu/{n}": t for n, t in state.nu.items()}}


class TensorShards:
    """The tp group's layout of the sharded leaves. `group` is the tp
    ranks (parallel/dist.py Group); `shapes` the whole leaves' shapes by
    flax name. Member t of n keeps columns [t·c/n, (t+1)·c/n) of the last
    dim (c) of each sharded leaf, the order of the reference's
    NamedSharding; a moment "mu/<name>" or "nu/<name>" is cut as its
    param."""

    def __init__(self, group, shapes: Dict[str, Tuple[int, ...]]):
        self.group = group
        self.names = [n for n, shape in shapes.items() if leaf_sharded(shape, group.size)]
        self._sharded = set(self.names)

    def sharded(self, name: str) -> bool:
        return (name[3:] if name[:3] in ("mu/", "nu/") else name) in self._sharded

    def shard(self, name: str, whole):
        """This member's columns of the whole leaf `name` (a tensor or an
        ndarray; contiguous), or the leaf itself when it is replicated."""
        if not self.sharded(name):
            return whole
        width = whole.shape[-1] // self.group.size
        cols = whole[..., self.group.index * width : (self.group.index + 1) * width]
        return cols.contiguous() if isinstance(cols, torch.Tensor) else np.ascontiguousarray(cols)

    def gather(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`tensors` (f32, this member's slices of the sharded names) with
        every sharded leaf whole again: one all-gather over the group of
        the slices, in name order."""
        names = [n for n in tensors if self.sharded(n)]
        if not names:
            return dict(tensors)
        flat = torch.cat([tensors[n].detach().reshape(-1).float() for n in names])
        parts = self.group.all_gather(flat[None], dim=0)  # [members, slices]
        out, off = dict(tensors), 0
        for n in names:
            cut = tensors[n]
            out[n] = torch.cat([parts[t, off : off + cut.numel()].view(cut.shape) for t in range(self.group.size)],
                               dim=-1)
            off += cut.numel()
        return out

    @contextlib.contextmanager
    def gathered(self, net: nn.Module):
        """`net`'s sharded params hold the whole leaves inside the block
        (autograd sees them whole) and their slices again after it."""
        params = named_tensors(net)
        whole = self.gather({n: params[n] for n in self.names})
        cuts = {}
        try:
            for n in self.names:
                cuts[n] = params[n].data
                params[n].data = whole[n]
            yield
        finally:
            for n, cut in cuts.items():
                params[n].data = cut


def state_tensors(net: nn.Module, adam: Optional[AdamState] = None, tp: Optional[TensorShards] = None):
    """flax name -> the whole param (and "mu/"/"nu/" moment, with `adam`):
    the tensors themselves, or with `tp` the leaves gathered over the tp
    group (a collective: every member calls it)."""
    tensors = named_tensors(net)
    if adam is not None:
        tensors.update(adam_moments(adam))
    return tp.gather(tensors) if tp is not None else tensors


def named_adam_state(state: AdamState) -> List[Tuple[str, np.ndarray]]:
    """("count", int32 scalar), then ("mu/<param>", f32), ("nu/<param>", f32)."""
    return [("count", np.asarray(int(state.count), np.int32))] + host_named(adam_moments(state))


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
