"""The slice of the reference configs the port needs, as plain dataclasses
with the reference defaults (dotaclient_tpu/config.py: PolicyConfig,
PPOConfig, LearnerConfig.batch_size/seq_len). No flag parsing yet."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PolicyConfig:
    """Architecture of the LSTM actor-critic."""

    arch: str = "lstm"  # only the LSTM family is ported
    unit_embed_dim: int = 128
    lstm_hidden: int = 128
    mlp_hidden: int = 128
    n_move_bins: int = 9  # 9-way discretized move offsets per axis
    move_step: float = 350.0  # map units per outermost move-grid cell
    # Auxiliary value heads (win-prob, last-hit, net-worth).
    aux_heads: bool = False
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    # LSTM recurrence implementation (ops/lstm.py): "auto" = the CUDA
    # kernel on a CUDA tensor, the plain torch scan on a CPU tensor;
    # "kernel" | "torch" force one.
    lstm_impl: str = "auto"


@dataclass
class PPOConfig:
    """PPO + GAE hyperparameters."""

    gamma: float = 0.98
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    value_clip: float = 0.2
    entropy_coef: float = 0.01
    lr: float = 1e-4
    adam_eps: float = 1e-5
    max_grad_norm: float = 0.5
    max_staleness: int = 4
    epochs: int = 1
    minibatches: int = 1
    kl_stop: float = 0.0
    # ACER truncated-importance-weight cap, applied to replayed rows only.
    replay_rho_bar: float = 2.0


@dataclass
class LearnerConfig:
    """The learner fields the forward slice reads."""

    batch_size: int = 256  # sequences per train step
    seq_len: int = 16  # rollout chunk length = LSTM truncation window
    ppo: PPOConfig = field(default_factory=PPOConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
