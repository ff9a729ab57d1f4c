"""Mini config for the OBS-rule fixtures (mirrors the real config.py
shape: flat dataclasses, nested via default_factory). Never imported."""

from dataclasses import dataclass, field


@dataclass
class ObsMini:
    enabled: bool = False
    metrics_port: int = 0


@dataclass
class LearnerConfig:
    batch_size: int = 8
    seq_len: int = 4
    # OBS003: defined, exposed as --dead_flag, consumed nowhere
    dead_flag: int = 0
    obs: ObsMini = field(default_factory=ObsMini)


@dataclass
class ControlMini:
    port: int = 13400
    policy: str = ""


@dataclass
class ControlConfig:
    control: ControlMini = field(default_factory=ControlMini)
    obs: ObsMini = field(default_factory=ObsMini)


@dataclass
class FleetMini:
    port: int = 13420
    alerts: str = ""


@dataclass
class FleetConfig:
    fleet: FleetMini = field(default_factory=FleetMini)
    obs: ObsMini = field(default_factory=ObsMini)
