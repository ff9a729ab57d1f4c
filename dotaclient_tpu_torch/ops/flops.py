"""Analytic FLOPs model of the PPO train step (own copy of
dotaclient_tpu/ops/flops.py, both policy families), and the peak table the
MFU meter divides by.

Counts matmul FLOPs only (2·M·N·K per [M,K]x[K,N]); the backward pass is
twice the forward, so one update is 3x forward. The optimizer update is
elementwise and ignored.
"""

from __future__ import annotations

from typing import Optional

from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F


def policy_forward_flops_per_frame(cfg: PolicyConfig) -> float:
    """Matmul FLOPs for one batch element, one time frame, forward only:
    obs trunk, temporal core, heads. The LSTM pays its input and hidden
    projections; the transformer its QKV/out/MLP projections per layer and
    the attention scores against its context (`tf_context`, as the
    reference counts it)."""
    U, UF = F.MAX_UNITS, F.UNIT_FEATURES
    D, M, H = cfg.unit_embed_dim, cfg.mlp_hidden, cfg.lstm_hidden

    fl = 0.0
    fl += 2.0 * U * UF * M  # unit_mlp1
    fl += 2.0 * U * M * D  # unit_mlp2
    fl += 2.0 * F.HERO_FEATURES * M  # hero_mlp
    fl += 2.0 * F.GLOBAL_FEATURES * (M // 4)  # global_mlp
    trunk_in = M + M // 4 + 2 * D  # hero ++ glob ++ pool_max ++ pool_mean
    fl += 2.0 * trunk_in * H  # trunk dense
    if cfg.arch == "transformer":
        Dh = H  # qkv/out are HxH each; MLP is Hx4H up + 4HxH down
        per_layer = 2.0 * (4 * H * Dh) + 2.0 * (2 * H * 4 * H)
        per_layer += 2.0 * 2 * cfg.tf_context * H  # scores QK^T + attn·V vs the context
        fl += cfg.tf_layers * per_layer
    else:
        fl += 2.0 * H * 4 * H  # x-projection (input is the trunk's H)
        fl += 2.0 * H * 4 * H  # recurrence hidden projection
    head_out = F.N_ACTION_TYPES + 2 * cfg.n_move_bins + D + 1
    if cfg.aux_heads:
        head_out += 3
    fl += 2.0 * H * head_out
    fl += 2.0 * U * D  # target dot-product attention scores
    return fl


def train_step_flops(cfg: LearnerConfig) -> float:
    """Matmul FLOPs of one PPO train step (fwd + bwd) over seq_len+1
    frames of the whole batch. Sample reuse (R epochs x M minibatches > 1)
    is one precompute forward plus R full-data fwd+bwd passes: (3R + 1) x
    forward."""
    frames = cfg.batch_size * (cfg.seq_len + 1)
    fwd = frames * policy_forward_flops_per_frame(cfg.policy)
    R, M = cfg.ppo.epochs, cfg.ppo.minibatches
    if R * M == 1:
        return 3.0 * fwd
    return (3.0 * R + 1.0) * fwd


# Peak dense bf16 FLOP/s by CUDA device name: the H100 SXM5 (NVIDIA H100
# Tensor Core GPU datasheet, 989.4 TFLOPS bf16 without sparsity). MFU is
# only reported for a device listed here.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def peak_flops_for(device_name: str) -> Optional[float]:
    return PEAK_BF16_FLOPS.get(device_name)


def device_peak_flops(device) -> Optional[float]:
    """The MFU denominator for a torch device: None on the CPU or on a
    card with no table entry (compute_mfu is then not reported)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_for(torch.cuda.get_device_name(device))


def aggregate_peak_flops(peaks) -> Optional[float]:
    """The MFU denominator of a step data parallel over several cards: the
    sum of every rank's device_peak_flops (one entry per rank, None or NaN
    where its device has no table entry). None when any rank's is missing:
    a partial sum would overstate utilization (the reference's
    aggregate_peak_flops over its device list)."""
    total = 0.0
    for peak in peaks:
        if peak is None or peak != peak:
            return None
        total += peak
    return total or None
