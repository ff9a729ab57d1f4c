"""Metric-name registry (the part of dotaclient_tpu/obs/registry.py the
port's binaries emit, same names and meanings): every scalar the port's
learner, inference server, carry store, fabric shards, actors (local,
vector, remote and self-play), serve client, evaluator, league, control
plane and fleet aggregator log or serve on /metrics is named here, so
dashboards, the control policy, fleetd's conservation ledgers and the
reference's alert clauses resolve against the port.

- SCALARS: exact names.
- PREFIXES: documented families whose tails are data-dependent
  (histogram edges, per-worker meters, scrape-only gauges).
"""

from __future__ import annotations

from typing import Dict

SCALARS: Dict[str, str] = {
    # --- train step (parallel/train_step.py metric keys)
    "loss": "total PPO objective",
    "policy_loss": "clipped-surrogate policy term",
    "value_loss": "clipped value regression term",
    "entropy": "mean policy entropy over real steps",
    "ratio_mean": "mean importance ratio",
    "ratio_clip_frac": "fraction of ratios clipped",
    "approx_kl": "approximate KL(new || behavior)",
    "advantage_mean": "mean GAE advantage (pre-normalization)",
    "return_mean": "mean bootstrapped return target",
    "value_mean": "mean predicted value",
    "replay_trunc_frac": "fraction of replayed rows with truncated IS ratio",
    "grad_norm": "global gradient norm before clipping",
    "aux_loss": "auxiliary value-head loss (aux_heads only)",
    "ppo_updates_done": "minibatch updates applied (KL early stop aware)",
    "ppo_kl_stopped": "1 if the KL early stop fired for this batch",
    # --- learner loop (runtime/learner.py)
    "env_steps_per_sec": "real (unmasked) env steps trained per second",
    "time_wait_batch_s": "per-step host wait for a packed batch (pipelined loop: paid on the prefetch lane, hidden behind the device step)",
    "time_device_put_s": "per-step host→device transfer time (pipelined loop: paid on the prefetch lane)",
    "time_step_s": "per-step residual — device step + dispatch (pipelined loop: wall minus the exposed take-wait)",
    "active_actors": "actors heard from within the heartbeat window",
    "staleness_dropped": "rollouts dropped for version staleness (cumulative)",
    "staging_quarantined": "frames filed in the staging dead-letter ring (parse/layout poison — evidence kept, dumped by the flight recorder)",
    "queue_ready": "packed batches waiting in the staging queue",
    "episodes": "episodes completed (cumulative, from done frames)",
    "wire_bytes_consumed_total": "serialized experience bytes entering the staging intake (cumulative; the bf16 wire roughly halves the obs share)",
    "wire_frames_obs_bf16_total": "frames whose float obs leaves traveled as bf16 (DTR3 quantized wire, --wire.obs_dtype bf16 producers)",
    "wire_frames_obs_f32_total": "frames whose float obs leaves traveled as f32 (legacy DTR1/DTR2 producers) — nonzero during a rolling upgrade",
    "weights_published": "weight fanout frames actually sent",
    "weights_coalesced": "weight publishes superseded before sending",
    "mean_episode_return": "mean per-episode return over consumed frames",
    # --- obs trace (obs/trace.py)
    "trace_e2e_actor_apply_s": "mean actor-publish → train-step-apply latency",
    # --- obs compute (obs/compute.py)
    "compute_phase_fetch_s": "mean per-step host wait for a packed batch",
    "compute_phase_pack_s": "mean per-step io.pack fallback time (≈0 on the fused path)",
    "compute_phase_h2d_s": "mean per-step fenced host→device transfer time",
    "compute_phase_device_step_s": "mean per-step fenced device train-step time",
    "compute_phase_host_s": "mean per-step publish/checkpoint/metrics host work",
    "compute_phase_wall_s": "mean loop-iteration wall time (phases sum to ≈ this)",
    "compute_phase_fetch_frac": "fetch share of step wall (watchdog starvation signal)",
    "compute_recompiles_total": "train-step signatures beyond the first (MUST stay 0 steady-state)",
    "compute_compiles_total": "train-step compiles including the first",
    "compute_compile_s": "cumulative train-step compile wall seconds",
    "compute_last_compile_s": "wall seconds of the most recent compile",
    "compute_flops_per_sec": "achieved model FLOP/s (ops/flops.py analytic count)",
    "compute_mfu": "cumulative model-FLOPs utilization vs platform peak (no entry in the peak table, no value)",
    # --- full-state checkpoints (runtime/checkpoint.py, runtime/learner.py CheckpointWorker)
    "ckpt_aux_written": "full-state aux manifests written (cumulative)",
    "ckpt_aux_superseded": "aux manifests coalesced away before writing (latest-wins)",
    "ckpt_aux_failures": "aux manifest writes that failed (prior step stays restorable)",
    "ckpt_last_aux_bytes": "size of the newest aux manifest (reservoir + pending + RNG)",
    "ckpt_last_aux_step": "step label of the newest durable aux manifest",
    "ckpt_async_saves_total": "checkpoints written by the off-critical-path saver",
    "ckpt_async_coalesced_total": "async checkpoints superseded before writing",
    # --- resume provenance: the first metrics window after a restore
    "resume_restored_step": "checkpoint step label this boot restored (-1 = none)",
    "resume_version_hwm_bump": "versions the counter jumped past the restored step to the published high-water mark (staleness stamps stay monotonic)",
    "resume_reservoir_entries": "replay-reservoir entries rehydrated from the aux manifest",
    "resume_pending_frames": "staged-but-untrained frames re-injected from the aux manifest",
    "resume_restore_wall_s": "wall seconds from restore start to full-state rehydration",
    # --- serve batcher (runtime/actor.py InferenceBatcher; the inference
    #     server exports the actor_* family under the reference's names)
    "actor_offered_steps_per_sec": "real env steps offered by this process per second",
    "actor_batch_occupancy": "mean real-rows / capacity of the batched inference tick",
    "actor_gather_wait_s": "mean per-tick wait assembling the batch (bounded by --gather_window_s)",
    "actor_jit_step_s": "mean per-tick batched jit inference latency (incl. the one device_get)",
    # --- producer ledger (runtime/actor.py VectorActor, serve/client.py
    #     RemoteFleet): fleetd's producer identity joins on these
    "actor_publish_attempted_total": "rollout chunks this process tried to publish (published + shed + failed, derived from the same reads so the identity is exact)",
    "actor_rollouts_published_total": "rollout chunks acked by the broker (cumulative)",
    # --- remote inference client (serve/client.py RemoteFleet.stats)
    "serve_failover_endpoints": "configured inference endpoints in the failover list",
    "serve_failover_endpoints_down": "endpoints currently sitting out a health cooldown",
    "serve_failover_total": "failovers to a different endpoint (cumulative)",
    "serve_failover_reconnects_total": "reconnect dials attempted (cumulative)",
    "serve_failover_episodes_abandoned_total": "episodes abandoned on remote-inference failure — connection loss, reply deadline, UNKNOWN_CLIENT (the serve chaos soak's explicit abandon ledger)",
    "serve_fallback_engaged": "1 while the local-policy fallback is stepping episodes",
    "serve_fallback_engagements_total": "distinct fallback engagements — counted per outage, not per return-to-remote probe cycle",
    "serve_fallback_steps_total": "policy steps served by the warm local tree (cumulative)",
    "serve_fallback_version": "model version of the broker-fanout-refreshed local tree",
    "serve_handoff_client_resumes_total": "episodes RESUMED after a remote-inference failure instead of abandoned (--serve.resume; the zero-abandon soak's ledger)",
    "serve_handoff_replay_steps_total": "replay steps sent while rebuilding resumed sessions (at most one chunk per resume — the recompute bound)",
    "serve_route_load_mode": "1 when --serve.route load is active (0 = the list order)",
    "serve_route_probes_total": "endpoint load probes issued at (re)connect time (S_INFO dials across the in-rotation candidates)",
    "serve_route_picks_total": "connects whose endpoint order came from a load probe pass",
    "serve_topology_refreshes_total": "endpoint lists adopted from the control plane's GET /topology (--serve.endpoint control:<host:port>; 0 with literal lists)",
    "serve_topology_errors_total": "failed /topology fetches — the client keeps its current list (rollback semantics: discovery can only improve on the static list)",
    # --- evaluator (eval/evaluator.py) and rating (eval/rating.py)
    "skill": "conservative TrueSkill estimate (mu - 3 sigma)",
    "trueskill_mu": "anchored TrueSkill mean",
    "trueskill_sigma": "anchored TrueSkill uncertainty",
    "win_rate": "evaluation win rate vs the scripted yardstick",
    "mean_eval_return": "mean evaluation episode return",
    # --- inference service (serve/server.py)
    "serve_requests_total": "policy-step requests handled (cumulative, all connections)",
    "serve_unknown_client_total": "steps naming a client_key with no resident carry and no episode-start flag (server restarted/evicted; the client abandons the episode)",
    "serve_bad_requests_total": "malformed step requests refused",
    "serve_episode_resets_total": "carry resets on EPISODE_START flags (cumulative)",
    "serve_evictions_total": "carries evicted on client disconnect (cumulative)",
    "serve_weight_swaps_total": "param-tree hot-swaps applied between ticks (cumulative)",
    "serve_version": "model version of the currently-serving param tree",
    "serve_clients_connected": "live client connections",
    "serve_carries_resident": "LSTM carries held server-side across all connections",
    "serve_load_clients": "live client connections (the S_INFO load report's clients field)",
    "serve_load_occupancy": "mean real-rows / capacity over the tick-occupancy histogram",
    "serve_load_pending": "step requests queued for the next inference tick",
    "serve_load_capacity": "batched-tick capacity (--serve.max_batch)",
    # --- session continuity, server side (serve/server.py + serve/handoff.py)
    "serve_handoff_store_writes_total": "chunk-boundary carries write-ahead-streamed to the shared store BEFORE the chunk-fill reply (cumulative)",
    "serve_handoff_store_errors_total": "carry-store RPCs that failed (write or failover read); the affected sessions degrade to abandon-on-failover",
    "serve_handoff_resumes_total": "sessions restored from the store on failover (S_RESUME answered OK; the client replays and the episode continues)",
    "serve_handoff_resume_misses_total": "resume handshakes refused (no store, store miss, or no entry matching the client's boundary) — the client abandons",
    "serve_handoff_replayed_steps_total": "FLAG_REPLAY steps served — buffered partial-chunk observations re-driven to rebuild a resumed session's mid-chunk carry",
    # --- multi-model serve tier (serve/server.py, --serve.models > 1)
    "serve_models_resident": "param-tree slots resident on this server (--serve.models)",
    "serve_league_syncs_total": "league-assignment slot installs applied by the sync loop (--serve.league_endpoint; cumulative)",
    "serve_league_sync_errors_total": "failed league assignment/snapshot polls — current slots keep serving",
    # --- obs watchdog (obs/watchdog.py)
    "watchdog_ok": "1 while /healthz serves 200, 0 once tripped",
    "watchdog_strikes": "escalation ladder position: max of consecutive failing checks (stall/NaN) and consecutive failing metrics windows (starvation/regression) — window strikes advance per logged window, not per check",
    "watchdog_trips_total": "times the watchdog flipped /healthz to 503",
    "watchdog_checks_total": "watchdog checks executed",
}

PREFIXES: Dict[str, str] = {
    # replay reservoir stats and age histogram, re-prefixed by staging:
    # replay_occupancy, replay_admitted, replay_age_le_<edge>, replay_hit_ratio, ...
    "replay_": "replay reservoir health (runtime/staging.py stats passthrough)",
    "ckpt_mirror_": "checkpoint remote-mirror health (runtime/checkpoint.py)",
    "trace_": "pipeline per-stage latency scalars (obs/trace.py)",
    "obs_": "live scrape-surface gauges (obs/__init__.py sources)",
    "pipeline_": "overlapped learner pipeline lane accounting (runtime/learner.py)",
    "staging_pack_": "parallel host feed scoreboard (sharded pack pool + transfer ring)",
    # the learner's fabric fan-in (transport/fabric.py fabric_stats, only
    # with a shard-list --broker_url): fanin_queue_depth, _delivered_total,
    # _fence_dropped_total, _dup_dropped_total, _pop_threads, _keys_tracked,
    # _publish_failovers_total, _publish_failed_total
    "fanin_": "broker-fabric fan-in consumer ledgers (transport/fabric.py)",
    # per-shard fabric meters, two emitters: the learner's fan-in
    # (broker_shard_<i>_popped_total / _starved_s / _up, i = index in its
    # shard list) and the shard binary's own /metrics (the un-indexed
    # ledger broker_shard_enqueued_total / _popped_total / _dropped_total /
    # _shed_total / _reply_lost_total / _evicted_low_total / _resident /
    # _depth, transport/fabric.py shard_metrics_source)
    "broker_shard_": "per-shard broker-fabric health (transport/fabric.py)",
    # the shard binary's assembly-station ledger (--broker.assemble; all
    # zero on an unarmed shard): broker_assemble_rows_admitted_total /
    # _rows_packed_total / _rows_reject_total / _rows_bypassed_total /
    # _rows_dropped_total / _rows_resident / _blocks_built_total /
    # _blocks_served_total / _block_bytes_total / _cpu_s_total
    "broker_assemble_": "in-network batch assembly ledger (transport/tcp.py assemble tier)",
    # rows-per-fired-tick occupancy histogram: actor_tick_rows_<k>
    "actor_tick_rows_": "rows-per-fired-tick occupancy histogram (runtime/actor.py InferenceBatcher)",
    # the carry-store binary's /metrics (serve/handoff.py CarryStoreServer):
    # serve_handoff_store_sessions, _puts_total, _gets_total, _hits_total,
    # _misses_total, _stale_total, _requests_total, _bad_requests_total
    "serve_handoff_store_": "carry-store service health (serve/handoff.py)",
    # per-slot serve ledgers at --serve.models > 1: serve_model_requests_total_<m>,
    # serve_model_swaps_total_<m>, serve_model_evictions_total_<m>, serve_model_version_<m>
    "serve_model_": "per-model-slot serve tier ledgers (serve/server.py)",
    # actor publish degradation (runtime/actor.py ShedThrottle via
    # VectorActor / RemoteFleet stats): broker_shed_observed_total,
    # broker_shed_publish_failed_total, broker_shed_throttle_s
    "broker_shed_": "broker load-shed observability (admission refusals + actor throttle)",
    # per-configured-endpoint client health (serve/client.py RemoteFleet):
    # serve_endpoint_up_<i>, serve_endpoint_cooldown_s_<i>
    "serve_endpoint_": "per-endpoint client-side health gauges (serve/client.py)",
    # league population health (eval/league.py League.stats and
    # league/server.py LeagueService.stats): league_pool_size,
    # league_snapshots_total, league_matches_total, ...
    "league_": "league population health (eval/league.py + league/)",
    # seeded fault-injection meters (chaos/broker.py ChaosBroker): chaos_ops,
    # chaos_corrupted, chaos_truncated, chaos_duplicated, chaos_resets,
    # chaos_sheds, chaos_stall_s, chaos_latency_s; emitted only under
    # --chaos.enabled (never in production)
    "chaos_": "fault-injection layer meters (chaos/)",
    # control-plane loop health (control/server.py ControlPlane.stats):
    # control_polls_total, control_scrapes_total, control_scrape_errors_total,
    # control_scale_ups_total / _downs_total, control_holds_total,
    # control_actuation_failures_total, control_topology_epoch,
    # control_managed_tiers, control_decisions_ledgered,
    # control_policy_clauses, control_replicas_<tier>
    "control_": "control-plane autoscaler loop health (control/)",
    # fleet telemetry plane (obs/fleet.py FleetAggregator, served by
    # obs/fleetd.py): fleet_targets(_up), fleet_unaccounted_frames /
    # _overaccounted_frames / _fenced_frames, fleet_ledger_<name>_*,
    # fleet_tier_up_<tier>, fleet_e2e_env_steps_per_sec, fleet_alerts_*,
    # fleet_incidents_total, fleet_topology_*, ...
    "fleet_": "fleet telemetry rollups + conservation audit (obs/fleet.py)",
}


def is_registered(name: str) -> bool:
    return name in SCALARS or any(name.startswith(p) for p in PREFIXES)


def unregistered(names) -> list:
    """The subset of `names` that is not registered (`step`/`time` are the
    JSONL record's envelope, not scalars)."""
    return sorted(n for n in names if n not in ("step", "time") and not is_registered(n))
