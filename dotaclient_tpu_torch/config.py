"""The slice of the reference configs the port needs, as plain dataclasses
with the reference defaults (dotaclient_tpu/config.py), and the same
argparse bridge: `parse_config(LearnerConfig(), argv)` reads
`--batch_size 8 --policy.lstm_hidden 16 --learner.prefetch false …` as the
reference learner binary does.

The switches of modes the port has not ported yet keep their reference
names and defaults; the learner refuses a non-default value with
NotImplementedError naming its ROADMAP item. Settings only those modes
read are left out, so their flags fail to parse.

Binaries: the learner (`LearnerConfig`), the inference server
(`InferenceConfig`), the carry store (`HandoffConfig`), the actor
(`ActorConfig`), the league service (`LeagueConfig`) and the evaluator
(`EvalConfig`).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
from dataclasses import dataclass, field


@dataclass
class PolicyConfig:
    """Architecture of the actor-critic."""

    # Temporal core family: "lstm" (the flagship) or "transformer" (causal
    # attention over the chunk, chunk-local context;
    # models/transformer_policy.py).
    arch: str = "lstm"
    unit_embed_dim: int = 128
    lstm_hidden: int = 128  # temporal-core width (d_model for the transformer family)
    mlp_hidden: int = 128
    # Transformer-family shape (ignored for arch="lstm").
    tf_layers: int = 2
    tf_heads: int = 4
    # Actor KV-cache capacity; past it the cache wraps into a sliding
    # window. The default leaves one slot over the default rollout_len 16.
    tf_context: int = 17
    # Sequence parallelism over a mesh axis of this name (not ported;
    # refused).
    tf_sp_axis: str = ""
    # Key-block size of the blockwise (streaming-softmax) attention in the
    # learner unroll: intermediates [N, T, block] instead of [N, T, T] at a
    # time (in training, together with tf_remat). 0 = dense; engages only
    # when the key axis exceeds it.
    tf_attn_block: int = 0
    # Recompute each transformer block's activations in the backward
    # (torch.utils.checkpoint) instead of storing them. Unroll only; the
    # math is unchanged.
    tf_remat: bool = False
    n_move_bins: int = 9  # 9-way discretized move offsets per axis
    move_step: float = 350.0  # map units per outermost move-grid cell
    # Auxiliary value heads (win-prob, last-hit, net-worth).
    aux_heads: bool = False
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    # LSTM recurrence implementation (ops/lstm.py lstm_recurrence):
    # "auto" = the CUDA kernel on a CUDA tensor, the plain torch scan on a
    # CPU tensor; "kernel" | "torch" | "scan_recompute" force one.
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
    # Experience older than this many learner versions is dropped on the
    # host by the staging buffer.
    max_staleness: int = 4
    epochs: int = 1
    minibatches: int = 1
    kl_stop: float = 0.0
    # ACER truncated-importance-weight cap, applied to replayed rows only.
    replay_rho_bar: float = 2.0


@dataclass
class ReplayConfig:
    """Prioritized replay reservoir; only the switch is ported (the fused
    train step and the learner refuse it)."""

    enabled: bool = False


@dataclass
class StagingConfig:
    """Host feed of the staging buffer (runtime/staging.py)."""

    # 1 = the classic path: one consumer thread pops, parses and packs.
    # N>1 = the parallel feed: a pop thread, an assembler thread, and N
    # packer threads that each fill a disjoint row shard of one ring slot
    # (the C packer releases the GIL). Bitwise the same buffer for any N.
    pack_workers: int = 1
    # Pinned transfer-buffer ring depth (pack_workers > 1 only): a slot
    # goes back to the packers once its host-to-device copy has retired.
    transfer_depth: int = 2
    # In-network batch assembly (DTB1 blocks; not ported; refused).
    assemble: bool = False


@dataclass
class LearnerPipelineConfig:
    """The learner loop's shape (runtime/learner.py PrefetchLane): True =
    a prefetch thread stages batch N+1 while the device runs step N;
    False = the serial fetch-after-step loop. Same batch order either way,
    so the params come out bitwise equal."""

    prefetch: bool = True
    # Batches the lane may hold fetched ahead (1 = double buffering).
    prefetch_depth: int = 1


@dataclass
class CkptConfig:
    """Preemption tolerance of checkpoints (runtime/checkpoint.py,
    runtime/learner.py). Every switch is off by default: then a
    checkpoint is the plain synchronous params/Adam/step save."""

    # An aux manifest beside each step (pending frames in order, the
    # publish high-water mark, env steps), written after the step, and the
    # version_hwm side file; restore bumps the version counter to it.
    full_state: bool = False
    # The loop thread pays one on-device clone of the state; a worker
    # thread copies it to the host and writes it (latest wins).
    async_save: bool = False
    # Learner main only: SIGTERM stops fetching, trains out what staging
    # holds, saves full state and exits 0.
    drain_on_sigterm: bool = False
    # Wall-clock budget of that drain; past it the process exits 1.
    drain_budget_s: float = 45.0


@dataclass
class WatchdogConfig:
    """Learner liveness watchdog (obs/watchdog.py): stall, input
    starvation, NaN loss and steps/s regression escalate log →
    flight-recorder dump → /healthz 503. Needs obs.enabled."""

    enabled: bool = False
    interval_s: float = 5.0  # seconds between checks
    stall_s: float = 120.0  # no version advance for this long
    # Stall threshold until the first advance: boot, restore and the
    # first batch wait must not read as a stall.
    boot_grace_s: float = 600.0
    # compute_phase_fetch_frac above this for consecutive windows (0 = off).
    starvation_frac: float = 0.0
    nan_check: bool = True  # latest logged loss not finite
    # env_steps_per_sec below this fraction of the trailing median (0 = off).
    regression_frac: float = 0.0
    window: int = 12  # metric windows in that median
    dump_after: int = 2  # strikes before the flight-recorder dump
    trip_after: int = 3  # strikes before /healthz turns 503


@dataclass
class ObsConfig:
    """Learner observability (obs/): trace hops, flight recorder, compute
    phases and MFU, the /metrics + /healthz + POST /profile surface and the
    watchdog. Off by default; nothing is built then."""

    enabled: bool = False
    metrics_port: int = 0  # HTTP port of /metrics (0 = no server)
    ring_size: int = 2048  # flight-recorder events kept
    dump_dir: str = ""  # flight-recorder dumps ("" = cwd)
    # Process-wide SIGTERM and excepthook dump triggers.
    install_handlers: bool = True
    # compute_phase_* split: the serial loop fences each step with a CUDA
    # event; the pipelined loop records the lane's phases with no fence.
    step_phases: bool = True
    # POST /profile captures land here ("" = dump_dir, then cwd).
    profile_dir: str = ""
    profile_max_seconds: float = 60.0  # a capture is clamped to this
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)


@dataclass
class ChaosConfig:
    """Seeded fault injection (dotaclient_tpu_torch/chaos/). Off by
    default and import-free: with enabled=False no chaos module is ever
    imported and the broker and env objects are the production ones, with
    the same wire bytes."""

    # Wrap this binary's broker in a ChaosBroker driving the schedule
    # below. The k8s manifests pin it off.
    enabled: bool = False
    # Seed of every fault decision: the same seed and spec give the same
    # faults at the same operation indices.
    seed: int = 0
    # Fault schedule, e.g. "latency:0.002~0.001,corrupt:0.01,dup:0.02,
    # reset:0.005,stall@8:1.5,kill@10:2" (chaos/schedule.py has the
    # grammar). Empty = no faults even when enabled.
    spec: str = ""


@dataclass
class RetryConfig:
    """Broker-client retry policy (transport/base.py RetryPolicy): the tcp
    client's reconnect loop reads it. Jitter keeps a fleet whose broker
    restarted from reconnecting in lockstep."""

    # Seconds a failed broker request keeps reconnect-retrying before it
    # gives up and raises.
    window_s: float = 60.0
    # First backoff sleep; doubles per attempt up to the cap.
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 2.0
    # Uniform jitter fraction: each sleep is drawn from
    # [b*(1-jitter), b*(1+jitter)]. 0 = deterministic.
    jitter: float = 0.5


@dataclass
class ServeConfig:
    """Server-side knobs of the inference service
    (`python -m dotaclient_tpu_torch.serve.server`): one param tree,
    per-client LSTM carries resident, continuous batching over a bounded
    gather window (fire at capacity or gather_window_s after the tick's
    first request)."""

    # TCP port the service listens on (0 = pick a free port).
    port: int = 13380
    # Rows in one inference tick at most.
    max_batch: int = 16
    # A tick fires at capacity or this long after its first request.
    gather_window_s: float = 0.005
    # Cadence of the weight-fanout poll (poke() wakes it early).
    weight_poll_s: float = 0.5
    # Session continuity (serve/handoff.py): "host:port" of the shared
    # carry store this replica writes each chunk-boundary carry to before
    # the chunk-fill reply, and reads on S_RESUME. A comma list shards the
    # store by rendezvous hash of the client key. "" = no store: S_RESUME
    # is answered UNKNOWN_CLIENT.
    handoff_endpoint: str = ""
    # Per-RPC budget against the carry store; a failed RPC is counted
    # (serve_handoff_store_errors_total) and serving goes on.
    handoff_timeout_s: float = 2.0
    # Resident model slots: slot 0 is the live hot-swapped tree, slots
    # 1..N-1 hold frozen trees installed with swap_model() or the league
    # sync.
    models: int = 1
    # League service "host:port" whose GET /assignments and GET /snapshot
    # fill the frozen slots ("" = no sync; ignored with models 1).
    league_endpoint: str = ""
    # Cadence of the league assignment poll, seconds.
    league_sync_s: float = 5.0


@dataclass
class WireConfig:
    """Experience-wire quantization (transport/serialize.py DTR3), on the
    producer side only: consumers take DTR1/2/3 alike."""

    # Wire dtype of the float obs leaves of published rollout frames:
    # "f32" ships DTR1/DTR2 frames; "bf16" casts the obs to bf16 at the
    # source (the rounding staging's compute-dtype cast applies anyway) and
    # ships DTR3.
    obs_dtype: str = "f32"


@dataclass
class ServeClientConfig:
    """The actor's opt-in to the remote inference service
    (serve/client.py). With `endpoint` empty the actor steps its own
    policy and the client is never imported."""

    # Inference-service endpoint(s): "host:port", a comma-separated
    # failover list, or "control:host:port" (the list comes from the
    # control plane's GET /topology). A client sticks to one replica (the
    # LSTM carry lives there) and fails over to the next healthy one on
    # connection loss or reply timeout. "" = the local policy step.
    endpoint: str = ""
    # Reply timeout of one request, seconds: a server that dies without a
    # reset surfaces as a retryable RemoteInferenceError.
    timeout_s: float = 30.0
    # TCP connect + handshake timeout of one dial, seconds.
    connect_timeout_s: float = 5.0
    # Seconds a failed endpoint sits out of the rotation; the return-to-
    # remote probes of an engaged fallback pace at this cadence too.
    cooldown_s: float = 5.0
    # Keep a local net warm from the broker's weight fanout and, once every
    # endpoint has been down longer than fallback_after_s, step whole
    # episodes locally until an endpoint is back.
    fallback_local: bool = False
    # All-endpoints-down time before the local fallback engages, seconds.
    fallback_after_s: float = 10.0
    # Session continuity: on a failure mid-episode, reconnect, restore the
    # last chunk-boundary carry through S_RESUME and replay the steps of
    # the partial chunk, instead of abandoning the episode.
    resume: bool = False
    # Time one resume may take (retried across failovers), seconds; past
    # it the episode is abandoned.
    resume_window_s: float = 20.0
    # Endpoint pick at (re)connect: "order" (list order, sticky) or "load"
    # (probe each candidate's S_INFO load report, least loaded first).
    route: str = "order"
    # Resident model slot this client's sessions step against (0 = the
    # live tree; N > 0 binds the connection to frozen slot N).
    model: int = 0
    # League service "host:port": league-opponent actors (--opponent
    # league with an endpoint) ask it GET /match for each episode's
    # opponent and POST /result with the outcome.
    league: str = ""


@dataclass
class ActorConfig:
    """The actor binary's flags (`python -m dotaclient_tpu_torch.runtime.actor`;
    reference: dotaclient_tpu/config.py ActorConfig).

    `platform` differs from the reference: "" (the default) runs the
    policy step on the CUDA device and "cpu" on the host, where the
    reference defaults to "cpu"."""

    # The env server's gRPC address (the binary dials it; in-process envs
    # are handed to Actor / VectorActor as stubs instead).
    env_addr: str = "localhost:13337"
    # "internal": the framework's env messages; "valve": a real
    # dotaservice's schema (not ported; refused, ROADMAP A.11d).
    env_dialect: str = "internal"
    broker_url: str = "mem://"
    rollout_len: int = 16  # steps per published experience chunk
    host_timescale: float = 10.0
    ticks_per_observation: int = 30
    max_dota_time: float = 600.0
    # One hero name or a comma-separated pool; both sides draw from it.
    hero: str = "npc_dota_hero_nevermore"
    # "scripted" (the env's passive bot), "scripted_hard" (farms and
    # retreats), "self" (mirror self-play, both sides the live net) or
    # "league" (the opposing team plays a frozen league snapshot; with
    # --serve.endpoint and --serve.league, a slot of the serve tier
    # matched by the league service) — runtime/selfplay.py.
    opponent: str = "scripted"
    # Heroes per team in self-play; all the heroes one net steps go in one
    # batched call per tick (B = 2 * team_size in mirror).
    team_size: int = 1
    league_capacity: int = 8  # snapshots in the local league pool at most
    league_snapshot_every: int = 20  # learner versions between snapshots
    pfsp_mode: str = "hard"  # "hard" | "even" | "uniform"
    # Kill switch: exit (for a supervisor restart) when no weight frame
    # arrived for this many seconds; 0 disables it.
    max_weight_age_s: float = 900.0
    # Ablation: mask CAST out of every observation.
    disable_cast: bool = False
    # Env sessions one process drives on one asyncio loop (VectorActor),
    # their policy steps gathered into one tick; 1 = the single-env Actor.
    envs_per_process: int = 1
    # A tick fires when every env slot has submitted, and no later than
    # this long after its first request.
    gather_window_s: float = 0.005
    obs: ObsConfig = field(default_factory=ObsConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    wire: WireConfig = field(default_factory=WireConfig)
    serve: ServeClientConfig = field(default_factory=ServeClientConfig)
    # Param init (the learner fleet's seed) and the actor's streams.
    seed: int = 0
    actor_id: int = 0
    # "" = the CUDA device; "cpu" runs the policy step on the host.
    platform: str = ""


@dataclass
class InferenceConfig:
    """The inference-service binary's flags (reference:
    dotaclient_tpu/config.py InferenceConfig). The service owns one param
    tree, initialised from `seed` and hot-swapped from the broker's weight
    fanout, and serves batched policy steps to remote actors.

    `platform` differs from the reference: "" (the default) serves on the
    CUDA device and "cpu" on the host, where the reference defaults to
    "cpu". The port's entry points run on the card unless asked otherwise.
    """

    serve: ServeConfig = field(default_factory=ServeConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    # /metrics (serve_*, actor_*), /healthz, /debug/flight; the watchdog
    # and the compute observer are the learner's and stay off here.
    obs: ObsConfig = field(default_factory=ObsConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    # Weight-fanout source (the URL the actors use); the service only
    # subscribes to weights.
    broker_url: str = "mem://"
    # Param-init seed: the learner fleet's seed, so the service answers
    # from step zero.
    seed: int = 0
    platform: str = ""


@dataclass
class HandoffConfig:
    """The carry-store binary's flags (`python -m
    dotaclient_tpu_torch.serve.handoff`; reference: dotaclient_tpu/config.py
    HandoffConfig): the session-continuity store the inference replicas
    write chunk-boundary carries to. Stdlib and numpy only."""

    # TCP port the store listens on (0 = pick a free port).
    port: int = 13390
    # Entries kept per session key; at least 2, so the previous boundary
    # stays readable for a client whose chunk-fill reply a kill ate.
    keep: int = 2
    # The store shard ring this process belongs to, the same comma list
    # the replicas get in --serve.handoff_endpoint ("" = one store); the
    # ready line names it.
    stores: str = ""
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass
class LearnerConfig:
    """The learner binary's flags (reference: dotaclient_tpu/config.py
    LearnerConfig). The port runs on one device: `mesh_shape` takes the
    specs that resolve to one (parallel/mesh.py)."""

    batch_size: int = 256  # sequences per train step
    seq_len: int = 16  # rollout chunk length = LSTM truncation window
    ppo: PPOConfig = field(default_factory=PPOConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    broker_url: str = "mem://"
    broker_shards: str = ""
    checkpoint_dir: str = ""
    checkpoint_remote_dir: str = ""
    checkpoint_every: int = 100  # steps between durable checkpoints
    ckpt: CkptConfig = field(default_factory=CkptConfig)
    publish_every: int = 1  # steps between weight fanout publishes
    # Emit legacy DTW1 weight frames (no boot_epoch) while a fleet of old
    # subscribers rolls.
    publish_legacy_dtw1: bool = False
    # Steps between metric windows; a window is the loop's one routine
    # device sync.
    metrics_every: int = 10
    log_dir: str = ""
    # Param init and the reuse step's per-step shuffle stream.
    seed: int = 0
    mesh_shape: str = "dp=-1"  # "dp=-1", "dp=1", "dp=1,tp=1": one device
    # The C++ batch packer on the staging path (dotaclient_tpu_torch/native);
    # False takes the Python path. A failed build raises.
    native_packer: bool = True
    staging: StagingConfig = field(default_factory=StagingConfig)
    learner: LearnerPipelineConfig = field(default_factory=LearnerPipelineConfig)
    # Stage obs floats in the policy compute dtype (bf16) on the host
    # (runtime/staging.py cast_obs_to_compute_dtype): the policy's first
    # op is the same cast, and the host-to-device bytes halve.
    stage_obs_compute_dtype: bool = True
    # The batch crosses host-to-device as dtype-grouped buffers, and with
    # fused_single_h2d as ONE [B, row_bytes] u8 buffer
    # (parallel/fused_io.py). The port has the single-buffer mode only.
    fused_h2d: bool = True
    fused_single_h2d: bool = True
    profile_port: int = 0
    # "" = the CUDA device; "cpu" runs the learner on the host.
    platform: str = ""
    multihost: bool = False
    # Stop after this many train steps (0 = run forever).
    train_steps: int = 0


@dataclass
class LeagueServiceConfig:
    """The --league.* flags of the standing league service
    (league/server.py): a disk-backed snapshot registry with lineage
    records, matchmaking over the clause grammar (league/policy.py) and
    TrueSkill ratings of ingested results."""

    # Port of the HTTP surface (GET /match, /leaderboard, /lineage,
    # /assignments, /snapshot; POST /result, /snapshot; /metrics,
    # /healthz); 0 = pick a free port.
    port: int = 13410
    # Registry root (<dir>/<name>.npz, lineage.json, matches.jsonl);
    # "" = in memory only.
    dir: str = ""
    # Pool size; past it the weakest member by mu (never the newest) is
    # evicted.
    capacity: int = 8
    # Serve model slots 1..slots that GET /assignments fills with the most
    # recent members (slot 0 is the live tree).
    slots: int = 3
    # Learner versions between snapshots admitted from the weight fanout.
    snapshot_every: int = 20
    # ";"-separated clauses "kind[@weight]", kind uniform | prioritized |
    # exploiter; each GET /match draws one by weight.
    policy: str = "uniform"
    # The serve endpoint /match hands to its callers (never dialled here).
    serve_endpoint: str = ""
    # Weight-fanout source feeding the registry ("" = POST /snapshot only).
    broker_url: str = ""
    # Fanout poll cadence, seconds.
    poll_s: float = 1.0
    # Exploiter promotion gate: this many results against the agent, at
    # this win rate at least.
    gate_games: int = 5
    gate_winrate: float = 0.55
    # Matchmaking draw seed.
    seed: int = 0


@dataclass
class LeagueConfig:
    """The league-service binary's flags (`python -m
    dotaclient_tpu_torch.league.server`). Stdlib and numpy only: it never
    touches the device."""

    league: LeagueServiceConfig = field(default_factory=LeagueServiceConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass
class EvalConfig:
    """The evaluator binary's flags (`python -m
    dotaclient_tpu_torch.eval.evaluator`): frozen-policy episodes against
    the scripted bot on each fresh weight version."""

    actor: ActorConfig = field(default_factory=ActorConfig)
    episodes: int = 16  # episodes per evaluation round
    eval_every: int = 10  # learner versions between evaluations
    log_dir: str = ""


@dataclass
class ControlLoopConfig:
    """The --control.* flags of the control-plane binary (control/server.py;
    reference: dotaclient_tpu/config.py ControlLoopConfig). The topology
    lists are comma `host:port` lists of each tier's OBS surfaces: the
    controller scrapes /metrics + /healthz there."""

    # Port of GET /topology (discovery), /metrics (control_*), /healthz and
    # /debug/flight; 0 = pick a free port.
    port: int = 13400
    poll_s: float = 2.0  # scrape-decide-actuate cadence, seconds
    # ";"-separated "tier:meter,high=H,low=L,min=M,max=X,cooldown=C,step=S"
    # clauses (control/policy.py); "" = observe-only.
    policy: str = ""
    # "static" ledgers decisions and actuates nothing; "k8s" runs `kubectl
    # scale` against the committed manifests.
    driver: str = "static"
    brokers: str = ""
    servers: str = ""
    actors: str = ""
    stores: str = ""
    learner: str = ""
    # k8s driver scope and the kubectl binary it runs.
    namespace: str = "dotaclient"
    kubectl: str = "kubectl"


@dataclass
class ControlConfig:
    """The control-plane binary's flags (`python -m
    dotaclient_tpu_torch.control.server`). Stdlib only: it never imports
    torch, numpy or the wire stack."""

    control: ControlLoopConfig = field(default_factory=ControlLoopConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass
class FleetLoopConfig:
    """The --fleet.* flags of the fleet telemetry aggregator (obs/fleetd.py;
    reference: dotaclient_tpu/config.py FleetLoopConfig)."""

    # Port of GET /fleet, /metrics (fleet_*), /healthz (503 while a ledger
    # is stale or alarming) and /debug/flight; 0 = pick a free port.
    port: int = 13420
    # Scrape-audit-alert cadence, seconds: one poll is one audit window.
    poll_s: float = 2.0
    window: int = 64  # poll windows kept per target
    stale_s: float = 10.0  # seconds without a scrape before /fleet says stale
    # Control plane whose GET /topology "metrics" map is merged with the
    # literal lists below ("" = literal lists only).
    control: str = ""
    brokers: str = ""
    servers: str = ""
    actors: str = ""
    stores: str = ""
    learners: str = ""
    leagues: str = ""
    # ";"-separated "meter,op,threshold,for=W" clauses over fleetd's own
    # gauges; a firing edge writes an incident bundle. Parse errors fail boot.
    alerts: str = ""
    bundle_dir: str = ""  # incident bundles ("" = cwd)


@dataclass
class FleetConfig:
    """The fleet telemetry binary's flags (`python -m
    dotaclient_tpu_torch.obs.fleetd`). Stdlib only, as the controller."""

    fleet: FleetLoopConfig = field(default_factory=FleetLoopConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


# Modes of the reference binaries that the port has not ported: the flag,
# the test of its value that selects the mode, what the mode is, and its
# ROADMAP item. The learner, the staging buffer, the single-buffer train
# step and the inference server refuse them from this one table; a flag
# applies to the configs that have it.
UNPORTED = {
    "staging.assemble": (bool, "DTB1 in-network batch assembly", "A.10f"),
    "replay.enabled": (bool, "the prioritized replay reservoir", "A.10g"),
    "fused_h2d": (lambda v: not v, "the per-leaf tree transfer", "A.10b"),
    "fused_single_h2d": (lambda v: not v, "the grouped four-buffer transfer", "A.10b"),
    "multihost": (bool, "multi-process data parallelism", "A.14"),
    "profile_port": (bool, "the deprecated always-on profiler server (use POST /profile)", "A.13b"),
    "policy.tf_sp_axis": (bool, "sequence-parallel attention (ring / Ulysses)", "A.14"),
}

# The actor binary's modes that are not ported, in UNPORTED's form: Actor
# and the actor binary refuse them.
ACTOR_UNPORTED = {
    "env_dialect": (lambda v: v == "valve", "the valve dialect adapter (env/valve_adapter.py)", "A.11d"),
}


_ABSENT = object()


def flag_value(cfg, flag: str):
    """The value of a dotted flag in `cfg`, or `_ABSENT` when `cfg` has no
    such field."""
    value = cfg
    for name in flag.split("."):
        value = getattr(value, name, _ABSENT)
        if value is _ABSENT:
            break
    return value


def unported_flags(cfg, table=UNPORTED) -> list:
    """The flags of `table` that `cfg`'s binary has."""
    return [f for f in table if flag_value(cfg, f) is not _ABSENT]


def refuse_unported(cfg, flags=None, table=UNPORTED) -> None:
    """NotImplementedError, naming the ROADMAP item, for the first of
    `flags` (default: every flag of `table` that `cfg` has) whose value
    selects a mode the port does not have."""
    for flag in unported_flags(cfg, table) if flags is None else flags:
        selects, what, item = table[flag]
        value = flag_value(cfg, flag)
        if selects(value):
            raise NotImplementedError(f"{flag}={value!r} ({what}) is not ported yet (ROADMAP {item})")


def _parse_bool(s: str) -> bool:
    low = s.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def add_flags(parser: argparse.ArgumentParser, cfg, prefix: str = "") -> None:
    """Register one --flag per (possibly nested) dataclass field."""
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(val):
            add_flags(parser, val, prefix=f"{name}.")
        elif isinstance(val, bool):
            parser.add_argument(f"--{name}", type=_parse_bool, default=val)
        else:
            parser.add_argument(f"--{name}", type=type(val), default=val)


def parse_config(cfg, argv=None):
    """Parse CLI flags into a fresh deep copy of `cfg` (returns the copy)."""
    cfg = copy.deepcopy(cfg)
    parser = argparse.ArgumentParser()
    add_flags(parser, cfg)
    args = parser.parse_args(argv)
    _apply(cfg, vars(args))
    return cfg


def _apply(cfg, flat: dict, prefix: str = "") -> None:
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(val):
            _apply(val, flat, prefix=f"{name}.")
        elif name in flat:
            setattr(cfg, f.name, flat[name])
