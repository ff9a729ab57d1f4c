"""The port's league (dotaclient_tpu_torch/eval/league.py and
dotaclient_tpu_torch/league/) against the reference on the CPU: the
local pool's PFSP draws and stats, the matchmaking grammar, registry
directories cross-loaded both ways, the LeagueService's JSON answers
over one seeded request script, its HTTP surface through the stdlib
client, and the league-service binary with k8s/league.yaml's args."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.config import LeagueConfig as JLeagueConfig
from dotaclient_tpu.config import LeagueServiceConfig as JLeagueServiceConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.eval import league as jleague
from dotaclient_tpu.league import policy as jpolicy
from dotaclient_tpu.league.registry import SnapshotRegistry as JRegistry
from dotaclient_tpu.league.server import LeagueService as JLeagueService
from dotaclient_tpu_torch.config import LeagueConfig, LeagueServiceConfig, parse_config
from dotaclient_tpu_torch.eval import league as tleague
from dotaclient_tpu_torch.league import policy as tpolicy
from dotaclient_tpu_torch.league.client import LeagueClient
from dotaclient_tpu_torch.league.registry import EVICTED, SnapshotRegistry
from dotaclient_tpu_torch.league.server import LeagueService, _decode_named, _encode_named

REPO = Path(__file__).resolve().parents[1]


def _params(seed: int, n: int = 3):
    rs = np.random.RandomState(seed)
    return [(f"params/core/layer{i}/kernel", rs.randn(4, 3 + i).astype(np.float32)) for i in range(n)]


# ------------------------------------------------------------ local pool


@pytest.mark.parametrize("mode", ["hard", "even", "uniform"])
def test_local_league_draws_and_stats_equal_the_reference(mode):
    """A seeded script of snapshots, draws and results: the same opponent
    sequence, pool, ratings and league_* stats (np.random.RandomState
    draws, as the reference)."""
    rs = np.random.RandomState(7)
    ours, theirs = tleague.League(capacity=3, snapshot_every=2, mode=mode, seed=5), \
        jleague.League(capacity=3, snapshot_every=2, mode=mode, seed=5)
    seq = ([], [])
    version = 0
    for _ in range(60):
        version += int(rs.randint(0, 3)) if rs.rand() > 0.05 else -3
        version = max(version, 0)
        named = _params(version)
        assert ours.maybe_snapshot(version, named) == theirs.maybe_snapshot(version, named)
        for lg, out in zip((ours, theirs), seq):
            snap = lg.sample_opponent()
            out.append(None if snap is None else snap.name)
        name = seq[0][-1]
        if name is not None:
            win = float(rs.choice([-1.0, 0.0, 1.0]))
            ours.record_result(name, win)
            theirs.record_result(name, win)
    assert seq[0] == seq[1] and len(set(seq[0])) > 2
    assert ours.names == theirs.names and ours.stats() == theirs.stats()
    for n in ours.names + [tleague.AGENT]:
        a, b = ours.table.get(n), theirs.table.get(n)
        assert (a.mu, a.sigma) == (b.mu, b.sigma)
    snap = ours.sample_opponent()
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(snap.named_params, _params(snap.version)))
    with pytest.raises(ValueError, match="pfsp"):
        tleague.League(mode="greedy")


# --------------------------------------------------------------- grammar

POLICIES = ["uniform", "prioritized@0.7;exploiter@0.3", " uniform@2 ; prioritized ", "exploiter@1e-3;",
            "", ";", "greedy", "uniform@0", "uniform@-1", "uniform@x", "prioritized@"]


@pytest.mark.parametrize("spec", POLICIES)
def test_match_policy_grammar_equals_the_reference(spec):
    def outcome(fn):
        try:
            return [tuple(c) for c in fn(spec)]
        except ValueError:
            return "ValueError"

    assert outcome(tpolicy.parse_match_policy) == outcome(jpolicy.parse_match_policy)


# -------------------------------------------------------------- registry


def _fill(reg):
    reg.admit("v1", 1, _params(1))
    reg.admit("v2", 2, _params(2), parent="v1")
    reg.admit("x1", 2, _params(3), kind="exploiter", parent="v2")
    reg.promote("x1")
    reg.admit("v3", 3, _params(4))
    reg.evict("v1")
    reg.append_match({"winner": "agent", "loser": "v2", "draw": False})


@pytest.mark.parametrize("writer,reader", [(SnapshotRegistry, JRegistry), (JRegistry, SnapshotRegistry)])
def test_registry_directories_load_in_the_other_package(tmp_path, writer, reader):
    """A registry directory written by either package loads in the other:
    the same lineage, members, params (bitwise) and match log; a member
    whose .npz went missing is demoted on load in both."""
    _fill(writer(str(tmp_path)))
    got, ref = reader(str(tmp_path)), writer(str(tmp_path))
    assert got.lineage() == ref.lineage() and got.pool() == ref.pool() == ["v2", "x1", "v3"]
    assert got.candidates() == [] and got.record("v1")["status"] == EVICTED
    for name in got.pool():
        for (n1, a), (n2, b) in zip(got.params(name), ref.params(name)):
            assert n1 == n2 and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.iter_matches() == ref.iter_matches() == [{"winner": "agent", "loser": "v2", "draw": False}]
    os.remove(os.path.join(tmp_path, "v3.npz"))
    assert SnapshotRegistry(str(tmp_path)).lineage() == JRegistry(str(tmp_path)).lineage()
    assert SnapshotRegistry(str(tmp_path)).record("v3")["status"] == EVICTED


def test_registry_reads_archives_without_pickles(tmp_path):
    reg = SnapshotRegistry(str(tmp_path))
    reg.admit("v1", 1, _params(1))
    np.savez(os.path.join(tmp_path, "v1.npz"), **{"params/core/layer0/kernel": np.array([{"a": 1}], dtype=object)})
    reg._params.clear()
    with pytest.raises(ValueError, match="pickle"):
        reg.params("v1")


# --------------------------------------------------------------- service


def _svc(cls, cfg_cls, svc_cls, tmp, **kw):
    kw.setdefault("policy", "prioritized@0.5;exploiter@0.25;uniform@0.25")
    cfg = cls(league=cfg_cls(port=0, dir=str(tmp), capacity=3, slots=2, snapshot_every=2, gate_games=2,
                             gate_winrate=0.5, seed=11, serve_endpoint="inference:13380", **kw))
    return svc_cls(cfg)


def _script(svc, decode_named):
    """One seeded request script against a service's handlers (the HTTP
    routes' own callables); the list of JSON answers."""
    rs = np.random.RandomState(3)
    out = []
    names, exploiters = ["agent"], []
    for step in range(80):
        op = rs.randint(0, 7)
        try:
            if op == 0:
                v = len(names) + int(rs.randint(0, 3))
                out.append(svc.maybe_snapshot(v, _params(v)))
                names.append(f"v{v}")
            elif op == 1 and step % 9 == 0:
                kind = "exploiter" if rs.rand() < 0.5 else "snapshot"
                body = {"name": f"e{step}", "version": step, "kind": kind, "parent": names[-1],
                        "params": _encode_named(_params(step))}
                out.append(svc.snapshot_post(json.dumps(body).encode()))
                names.append(f"e{step}")
                if kind == "exploiter":
                    exploiters.append(f"e{step}")
            elif op in (1, 2, 3):
                out.append(svc.match({}))
            elif op == 4:
                a, b = rs.choice(names, 2)
                if exploiters and rs.rand() < 0.5:  # feed an exploiter's promotion gate
                    a, b = exploiters[-1], "agent"
                out.append(svc.result(json.dumps({"winner": str(a), "loser": str(b), "draw": bool(rs.rand() < .1)})
                                      .encode()))
            elif op == 5:
                out.append([svc.leaderboard(), svc.assignments(), svc.lineage(), svc.stats(), svc.health()])
            else:
                name = str(rs.choice(names))
                snap = svc.snapshot_get({"name": [name]})
                out.append({k: v for k, v in snap.items() if k != "params"})
                out.append([(n, a.tobytes()) for n, a in decode_named(snap["params"])])
        except (KeyError, ValueError) as e:
            out.append(type(e).__name__)
    return out


def test_service_answers_equal_the_reference_over_a_seeded_script(tmp_path):
    """Admissions (cadence-gated and POSTed, exploiters among them),
    matches, results (self-matches refused, gates promoting), queries and
    snapshot reads: every answer equals the reference service's, and a
    fresh service of either package rebuilt from the other's directory
    answers /leaderboard and /assignments as the live one did."""
    from dotaclient_tpu.league.server import _decode_named as j_decode_named

    ours = _svc(LeagueConfig, LeagueServiceConfig, LeagueService, tmp_path / "t")
    theirs = _svc(JLeagueConfig, JLeagueServiceConfig, JLeagueService, tmp_path / "j")
    a, b = _script(ours, _decode_named), _script(theirs, j_decode_named)
    assert json.dumps(a, default=repr) == json.dumps(b, default=repr)
    assert ours.promotions_total >= 1 and ours.evictions_total >= 1 and ours.matches_total > 10
    for cls, cfg_cls, svc_cls, d in ((LeagueConfig, LeagueServiceConfig, LeagueService, "j"),
                                     (JLeagueConfig, JLeagueServiceConfig, JLeagueService, "t")):
        fresh = _svc(cls, cfg_cls, svc_cls, tmp_path / d)
        live = theirs if d == "j" else ours
        assert fresh.leaderboard() == live.leaderboard() and fresh.assignments() == live.assignments()


def test_http_surface_through_the_client(tmp_path):
    svc = LeagueService(LeagueConfig(league=LeagueServiceConfig(port=0, dir=str(tmp_path), slots=2,
                                                                serve_endpoint="s:1"))).start()
    try:
        cli = LeagueClient(f"127.0.0.1:{svc.port}")
        assert cli.match()["name"] is None
        assert cli.register("v1", 1, _params(1))["admitted"] is True
        m = cli.match()
        assert (m["name"], m["model"], m["serve"], m["version"]) == ("v1", 1, "s:1", 1)
        assert cli.result("agent", "v1")["ok"]
        board = {r["name"]: r["games"] for r in cli.leaderboard()}
        assert board == {"agent": 1, "v1": 1}
        assert cli.assignments() == {"1": {"name": "v1", "version": 1}} and "v1" in cli.lineage()
        got = _decode_named(cli.snapshot("v1")["params"])
        assert all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(got, _params(1)))
        for path, body in (("/result", {"winner": "a", "loser": "a"}), ("/snapshot", {"name": ""})):
            req = urllib.request.Request(f"http://127.0.0.1:{svc.port}{path}", data=json.dumps(body).encode(),
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/snapshot?name=nobody", timeout=5)
        assert e.value.code == 400
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/metrics", timeout=5).read().decode()
        assert "dotaclient_league_results_total 1" in metrics
    finally:
        svc.stop()


def _league_manifest(tmp, broker_url):
    import chip_smoke

    args = chip_smoke.manifest_args(os.path.join(REPO, "k8s", "league.yaml"))
    for flag, value in (("--league.port", "0"), ("--league.dir", str(tmp)), ("--league.broker_url", broker_url)):
        args[args.index(flag) + 1] = value
    return args


def test_league_binary_takes_the_manifest_and_admits_fanout_snapshots(tmp_path):
    """`python -m dotaclient_tpu_torch.league.server` with k8s/league.yaml's
    args (port, registry dir and shard list swapped for local ones):
    parses as the reference parses them, prints its ready line, admits
    the weight frames a learner publishes at --league.snapshot_every, and
    exits 0 on SIGINT; nothing of JAX is imported."""
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.config import PolicyConfig
    from dotaclient_tpu_torch.transport.params import named_params
    from dotaclient_tpu_torch.transport.serialize import serialize_weights
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    import torch

    shards = [BrokerServer("127.0.0.1", 0).start() for _ in range(3)]
    url = ",".join(f"tcp://127.0.0.1:{s.port}" for s in shards)
    args = _league_manifest(tmp_path, url)
    ours, theirs = parse_config(LeagueConfig(), args), j_parse_config(JLeagueConfig(), args)
    assert vars(ours.league) == vars(theirs.league) and ours.league.snapshot_every == 20
    args[args.index("--league.snapshot_every") + 1] = "2"
    args += ["--league.poll_s", "0.05"]
    err_path = tmp_path / "stderr.log"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, "-X", "importtime", "-m", "dotaclient_tpu_torch.league.server",
                                 *args], cwd=REPO, stdout=subprocess.PIPE, stderr=err_file, text=True)
    try:
        import select

        assert select.select([proc.stdout], [], [], 60)[0], "no ready line"
        ready = json.loads(proc.stdout.readline())
        assert ready["serving"] is True and ready["pool"] == 0 and ready["policy"] == "prioritized@0.7;exploiter@0.3"
        port = ready["port"]
        net = P.init_params(PolicyConfig(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16),
                            torch.Generator().manual_seed(0), "cpu")
        pub = TcpBroker("127.0.0.1", shards[0].port)
        import time

        deadline = time.monotonic() + 30
        version, pool = 0, []
        while len(pool) < 2 and time.monotonic() < deadline:
            version += 1
            pub.publish_weights(serialize_weights(named_params(net), version=version))
            time.sleep(0.15)
            body = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/lineage", timeout=5).read())
            pool = sorted(body["lineage"])
        pub.close()
        assert len(pool) >= 2 and all(n.startswith("v") for n in pool)
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read())
        assert health["role"] == "league" and health["pool"] >= 2
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
        err = err_path.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for s in shards:
            s.stop()
    assert proc.returncode == 0
    imported = [line.rsplit("|", 1)[1].strip() for line in err.splitlines() if line.startswith("import time:")]
    assert "dotaclient_tpu_torch.league.registry" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "flax", "grpc") or m == "dotaclient_tpu"
                or m.startswith("dotaclient_tpu.") or m.startswith("google.protobuf")]
    assert set(os.listdir(tmp_path)) >= {"lineage.json", "matches.jsonl", f"{pool[0]}.npz"}
