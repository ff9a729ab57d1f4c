"""Replay-side helpers (own copy of part of dotaclient_tpu/replay/). Only
the publish-time priority is ported; the prioritized reservoir is ROADMAP
A.10g."""

from dotaclient_tpu_torch.replay.reservoir import td_error_priority  # noqa: F401
