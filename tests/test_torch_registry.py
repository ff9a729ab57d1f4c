"""The port's metric registry covers every name its tiers emit, and the
stdlib tiers stay stdlib: the actor (VectorActor), the remote-inference
client (RemoteFleet), the evaluator and the league (the standing service
and the per-actor pool) run on the CPU, and every name they log or serve
is registered in the port's registry and in the reference's. A fresh
interpreter that imports the port's control server and fleetd holds no
torch, numpy, jax or dotaclient_tpu."""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dotaclient_tpu.obs import registry as jregistry
from dotaclient_tpu_torch.config import (
    ActorConfig,
    InferenceConfig,
    LeagueConfig,
    LeagueServiceConfig,
    ObsConfig,
    PolicyConfig,
    ServeClientConfig,
    ServeConfig,
)
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.obs import registry as tregistry
from dotaclient_tpu_torch.transport import memory as tmem

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
SMALL_FLAGS = ["--actor.policy.lstm_hidden", "16", "--actor.policy.unit_embed_dim", "16",
               "--actor.policy.mlp_hidden", "16", "--actor.policy.dtype", "float32"]


def _metrics_names(port: int) -> list:
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    return [ln.split()[0][len("dotaclient_"):] for ln in body.splitlines() if ln and ln[0] != "#"]


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scraped_after_run(agent, run):
    """Run `agent` (obs on, a metrics port) to its end with its surface
    kept up, and return the names its /metrics served."""
    close = agent.obs.close
    agent.obs.close = lambda: None
    try:
        asyncio.new_event_loop().run_until_complete(run)
        return _metrics_names(agent.obs.cfg.metrics_port)
    finally:
        close()


def _vector_actor(tmp_path):
    from dotaclient_tpu_torch.runtime.actor import VectorActor

    cfg = ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", envs_per_process=2, rollout_len=8,
                      max_dota_time=5.0, obs=ObsConfig(enabled=True, metrics_port=_free_port(),
                                                      install_handlers=False, dump_dir=str(tmp_path)))
    tmem.reset("c1_vector")
    actor = VectorActor(cfg, tmem.MemoryBroker("c1_vector"), actor_id=2,
                        stubs=[LocalDotaServiceStub(FakeDotaService()) for _ in range(2)])
    return _scraped_after_run(actor, actor.run(num_episodes=2))


def _remote_fleet(tmp_path):
    from dotaclient_tpu_torch.serve.client import RemoteFleet
    from dotaclient_tpu_torch.serve.server import InferenceServer

    server = InferenceServer(InferenceConfig(serve=ServeConfig(port=0, max_batch=4, gather_window_s=0.002),
                                             policy=PolicyConfig(**SMALL), seed=1, platform="cpu")).start()
    try:
        cfg = ActorConfig(rollout_len=8, max_dota_time=3.0, policy=PolicyConfig(**SMALL), seed=3,
                          max_weight_age_s=0.0, platform="cpu", envs_per_process=2,
                          serve=ServeClientConfig(endpoint=f"127.0.0.1:{server.port}", resume=True,
                                                  fallback_local=True, route="load"),
                          obs=ObsConfig(enabled=True, metrics_port=_free_port(), install_handlers=False,
                                        dump_dir=str(tmp_path)))
        tmem.reset("c1_fleet")
        fleet = RemoteFleet(cfg, tmem.MemoryBroker("c1_fleet"), actor_id=1)
        svc = FakeDotaService()
        for e in fleet.envs:
            e._stub = LocalDotaServiceStub(svc)
        return _scraped_after_run(fleet, fleet.run(num_episodes=2))
    finally:
        server.stop()


def _evaluator(tmp_path):
    from dotaclient_tpu_torch.eval import evaluator as tev

    tmem.reset("c1_eval")
    args = ["--actor.broker_url", "mem://c1_eval", "--episodes", "1", "--eval_every", "1", "--log_dir",
            str(tmp_path), "--actor.platform", "cpu", "--actor.max_dota_time", "5", *SMALL_FLAGS]
    path = tmp_path / "metrics.jsonl"
    polls = []

    def should_stop():
        polls.append(1)
        return (path.exists() and path.stat().st_size > 0) or len(polls) > 50

    tev.main(args, stub=LocalDotaServiceStub(FakeDotaService()), should_stop=should_stop)
    return list(json.loads(path.read_text().splitlines()[0]))


def _league_service(tmp_path):
    from dotaclient_tpu_torch.league.server import LeagueService

    svc = LeagueService(LeagueConfig(league=LeagueServiceConfig(port=0, slots=2, policy="uniform"))).start()
    try:
        rs = np.random.RandomState(0)
        for v in (1, 2, 3):
            svc.ingest_snapshot(f"v{v}", v, [("params/w", rs.randn(3, 2).astype(np.float32))])
        opponent = svc.match()["name"]
        svc.result(json.dumps({"winner": "agent", "loser": opponent}).encode())
        return list(svc.stats()) + _metrics_names(svc.port)
    finally:
        svc.stop()


def _league_pool(tmp_path):
    from dotaclient_tpu_torch.eval.league import League

    lg = League(capacity=3, snapshot_every=1, seed=1)
    for v in range(4):
        lg.maybe_snapshot(v, [("w", np.zeros(2, np.float32) + v)])
    snap = lg.sample_opponent()
    lg.record_result(snap.name, 1.0)
    return list(lg.stats())


TIERS = {
    "vector_actor": (_vector_actor, {"actor_publish_attempted_total", "actor_rollouts_published_total",
                                     "broker_shed_observed_total", "actor_tick_rows_1"}),
    "remote_fleet": (_remote_fleet, {"actor_publish_attempted_total", "serve_failover_total",
                                     "serve_fallback_engaged", "serve_handoff_client_resumes_total",
                                     "serve_route_load_mode", "serve_topology_refreshes_total",
                                     "serve_endpoint_up_0"}),
    "evaluator": (_evaluator, {"skill", "trueskill_mu", "trueskill_sigma", "win_rate", "mean_eval_return"}),
    "league_service": (_league_service, {"league_matches_total", "league_pool_size"}),
    "league_pool": (_league_pool, {"league_pool_size"}),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_every_name_a_tier_emits_is_registered_in_both_registries(tier, tmp_path):
    run, expected = TIERS[tier]
    names = set(run(tmp_path)) - {"step", "time"}
    assert expected <= names, expected - names
    assert tregistry.unregistered(names) == [], tregistry.unregistered(names)
    assert jregistry.unregistered(names) == [], jregistry.unregistered(names)


def test_the_c1_names_are_registered_with_the_reference_s_meanings():
    c1 = [n for n in jregistry.SCALARS if n.startswith(("serve_failover_", "serve_fallback_", "serve_route_",
                                                         "serve_topology_"))]
    c1 += ["actor_publish_attempted_total", "actor_rollouts_published_total", "serve_handoff_client_resumes_total",
           "serve_handoff_replay_steps_total", "skill", "trueskill_mu", "trueskill_sigma", "win_rate",
           "mean_eval_return"]
    assert len(c1) == 23
    for name in c1:
        assert name in tregistry.SCALARS, name
        if name != "serve_route_load_mode":  # the reference's meaning names its PR; the port's says the list order
            assert tregistry.SCALARS[name] == jregistry.SCALARS[name], name
    for family in ("broker_shed_", "league_", "serve_endpoint_", "control_", "fleet_"):
        assert family in tregistry.PREFIXES and family in jregistry.PREFIXES


def test_the_stdlib_tiers_import_no_torch_numpy_jax_or_the_reference():
    script = r"""
import json, sys
import dotaclient_tpu_torch.control.server, dotaclient_tpu_torch.obs.fleetd, dotaclient_tpu_torch.obs.preflight
import dotaclient_tpu_torch.obs.http
held = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib")
              or m == "dotaclient_tpu" or m.startswith("dotaclient_tpu."))
hwm = [int(ln.split()[1]) for ln in open("/proc/self/status") if ln.startswith("VmHWM:")]
print(json.dumps({"held": held, "vmhwm_kib": hwm[0] if hwm else 0}))
"""
    from tests.conftest import clean_subprocess_env

    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, cwd=str(REPO),
                          env=clean_subprocess_env(extra={"PYTHONPATH": str(REPO)}))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["held"] == []
    assert out["vmhwm_kib"] < 64 * 1024  # the stdlib tiers' pods are capped at 256Mi / 512Mi


def test_the_lazy_obs_names_still_import():
    from dotaclient_tpu_torch import obs
    from dotaclient_tpu_torch.obs import ComputeObserver, ProfileCapture, Watchdog, compute, http, watchdog

    assert (ComputeObserver, ProfileCapture, Watchdog) == (compute.ComputeObserver, compute.ProfileCapture,
                                                           watchdog.Watchdog)
    assert compute.CaptureBusyError is http.CaptureBusyError
    with pytest.raises(AttributeError):
        obs.NoSuchName  # noqa: B018
    assert torch.device("cpu") == __import__("dotaclient_tpu_torch").resolve_device("cpu")
