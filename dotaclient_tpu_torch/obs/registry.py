"""Metric-name registry of the learner (the learner-side part of
dotaclient_tpu/obs/registry.py, same names and meanings): every scalar the
port's learner logs or serves on /metrics is named here, so dashboards and
the reference's alert and control clauses resolve against the port.

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
    # --- obs watchdog (obs/watchdog.py)
    "watchdog_ok": "1 while /healthz serves 200, 0 once tripped",
    "watchdog_strikes": "escalation ladder position: max of consecutive failing checks (stall/NaN) and consecutive failing metrics windows (starvation/regression) — window strikes advance per logged window, not per check",
    "watchdog_trips_total": "times the watchdog flipped /healthz to 503",
    "watchdog_checks_total": "watchdog checks executed",
}

PREFIXES: Dict[str, str] = {
    "ckpt_mirror_": "checkpoint remote-mirror health (runtime/checkpoint.py)",
    "trace_": "pipeline per-stage latency scalars (obs/trace.py)",
    "obs_": "live scrape-surface gauges (obs/__init__.py sources)",
    "pipeline_": "overlapped learner pipeline lane accounting (runtime/learner.py)",
    "staging_pack_": "parallel host feed scoreboard (sharded pack pool + transfer ring)",
}


def is_registered(name: str) -> bool:
    return name in SCALARS or any(name.startswith(p) for p in PREFIXES)


def unregistered(names) -> list:
    """The subset of `names` that is not registered (`step`/`time` are the
    JSONL record's envelope, not scalars)."""
    return sorted(n for n in names if n not in ("step", "time") and not is_registered(n))
