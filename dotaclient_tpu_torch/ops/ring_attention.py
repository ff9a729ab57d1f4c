"""The attention dispatch of the transformer family (torch twin of the
local half of dotaclient_tpu/ops/ring_attention.py).

The reference also shards the time axis over a mesh axis (ring attention
over ppermute, Ulysses over all-to-all). That needs the time axis split
over a group of ranks and is not ported (ROADMAP A.14b): a mesh with the
axis raises here.
"""

from __future__ import annotations

from typing import Optional

import torch

from dotaclient_tpu_torch.ops import attention as A


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    mesh: Optional[object] = None,
    sp_axis: str = "",
    kv_block: int = 0,
) -> torch.Tensor:
    """Local causal attention: blockwise when `kv_block` is set and the
    key axis exceeds it, dense else. Sequence parallelism (a mesh given
    together with `sp_axis`) raises NotImplementedError."""
    if mesh is not None and sp_axis:
        raise NotImplementedError(f"sequence-parallel attention over {sp_axis!r} is not ported yet (ROADMAP A.14b)")
    if kv_block and k.shape[-3] > kv_block:
        return A.blockwise_causal_attention(q, k, v, q_pos, k_pos, kv_block)
    return A.causal_attention(q, k, v, q_pos, k_pos)
