"""Host-side staging helpers (torch twin of the part of
dotaclient_tpu/runtime/staging.py the train step needs).

Only `cast_obs_to_compute_dtype` is ported so far; the staging buffer,
packer and transport glue come with the learner loop.
"""

from __future__ import annotations

import numpy as np
import torch

from dotaclient_tpu_torch.config import LearnerConfig
from dotaclient_tpu_torch.ops.batch import TrainBatch


def cast_obs_to_compute_dtype(cfg: LearnerConfig, batch: TrainBatch) -> TrainBatch:
    """Cast the float32 obs leaves of a numpy batch to the policy compute
    dtype on the host. The policy's first op on every obs float is the
    same cast, so this changes no result and halves the bytes of the
    dominant host-to-device transfer; GAE/loss scalars stay f32.

    numpy has no bfloat16, so a bf16 leaf is a CPU `torch.bfloat16`
    tensor: raw 2-byte words, cast by torch with round-to-nearest-even,
    as ml_dtypes casts in the reference. NaN and inf pass through (wire
    frames are untrusted; rows are masked or dropped downstream)."""
    if not cfg.stage_obs_compute_dtype or cfg.policy.dtype != "bfloat16":
        return batch
    obs = batch.obs._replace(
        **{
            f: torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
            for f, v in batch.obs._asdict().items()
            if getattr(v, "dtype", None) == np.float32
        }
    )
    return batch._replace(obs=obs)
