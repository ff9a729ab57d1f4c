"""The |TD-error| priority of a rollout chunk (own copy of
dotaclient_tpu/replay/reservoir.py's `td_error_priority`). The reservoir
itself is not ported (ROADMAP A.10g)."""

from __future__ import annotations

import numpy as np


def td_error_priority(rewards, values, dones, gamma: float) -> float:
    """Mean |one-step TD residual| over the chunk: the standard PER proxy
    for |advantage|, computed on the host from the actor-stamped behavior
    values. The final step bootstraps from its own value (the bias is
    uniform across chunks, which is all a ranking key needs). A diverged
    chunk (NaN/inf) gets a finite key."""
    r = np.asarray(rewards, np.float32)
    if r.size == 0:
        return 0.0
    v = np.asarray(values, np.float32)
    d = np.asarray(dones, np.float32)
    v_next = np.concatenate([v[1:], v[-1:]])
    delta = r + gamma * v_next * (1.0 - d) - v
    return float(np.nan_to_num(np.mean(np.abs(delta)), nan=0.0, posinf=1e6, neginf=0.0))
