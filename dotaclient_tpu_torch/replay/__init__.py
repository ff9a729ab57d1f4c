"""Host-side prioritized experience replay between staging and the learner
(own copy of dotaclient_tpu/replay/).

Frames older than `ppo.max_staleness` learner versions, which staging
would drop, are kept in a ReplayReservoir while they are within
`replay.max_staleness`, and each batch draws up to `replay.ratio` of its
rows from it, every row stamped with its behavior-policy staleness; the
loss truncates the IS ratio of stale rows at `ppo.replay_rho_bar`
(ops/ppo.py, ACER's c-bar). The reservoir hangs off the staging consumer
thread (runtime/staging.py) and is touched by that thread only. Off by
default (`replay.enabled`): nothing here runs on the hot path then.
"""

from dotaclient_tpu_torch.replay.reservoir import AGE_BUCKET_EDGES, ReplayReservoir, td_error_priority

__all__ = ["AGE_BUCKET_EDGES", "ReplayReservoir", "td_error_priority"]
