"""The league-through-serve soak's twin (dotaclient_tpu_torch/scripts/
soak_league.py) against the reference (scripts/soak_league.py): the same
flags, defaults and --quick values, the same league, server and actor
configs field by field, the same rolling schedules parsed to the same
events, the verdict's twelve bars recomputed from the committed
LEAGUE_SOAK.json equal to its own, and a cut CPU run (tiny f32 policy,
the actors' envs over gRPC as the reference's) whose artifact carries the
committed artifact's keys with every verdict true."""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import dotaclient_tpu.league.client as jclient
import dotaclient_tpu.league.server as jserver
import dotaclient_tpu.runtime.selfplay as jselfplay
import dotaclient_tpu.serve.handoff as jhandoff
import dotaclient_tpu.serve.server as jserve
from dotaclient_tpu.chaos import schedule as jschedule
import dotaclient_tpu.chaos as jchaos
import dotaclient_tpu.env.service as jservice
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.scripts import soak_league as L

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "LEAGUE_SOAK.json").read_text())


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_soak_league", REPO / "scripts" / "soak_league.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _reference_args(ref, monkeypatch, argv):
    """The reference main's parsed args after its --quick rewrite, stopped
    at its first use of the policy."""
    box = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        return box["args"]

    def stop():
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(ref, "_tiny_policy", stop)
    with pytest.raises(_Stop):
        ref.main(argv)
    return vars(box["args"])


@pytest.mark.parametrize("quick", [False, True])
def test_flags_defaults_and_quick_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = _reference_args(ref, monkeypatch, argv)
    got = vars(L.parse_args(argv))
    assert got.pop("out") == "league_soak_torch.json" and want.pop("out") == "LEAGUE_SOAK.json"
    assert (got.pop("platform"), got.pop("env")) == ("", "grpc")  # the card; envs over gRPC as the reference's
    assert got == want


@pytest.mark.parametrize("quick", [False, True])
def test_rolling_schedules_are_the_references(quick):
    a = L.parse_args(["--quick"] if quick else [])
    for spec in (a.rolling, L.SMOKE_CUT["rolling"]):
        mine = [vars(e) for e in tschedule.FaultSchedule.parse(spec, seed=0).events]
        assert mine == [vars(e) for e in jschedule.FaultSchedule.parse(spec, seed=0).events], spec
        assert {(e["kind"], e["target"]) for e in mine} == {("rolling", "server")}
    assert L.cut_args().episodes_per_actor > L.parse_args(["--quick"]).episodes_per_actor
    assert len(L.cut_args().rolling.split(",")) == 2


def _reference_configs(ref, monkeypatch):
    """The league, server and actor configs the reference's main builds,
    caught at their constructors (nothing is started)."""
    seen = {"actors": []}

    class Service:
        def __init__(self, cfg):
            seen["league"] = cfg
            self.port = 4321
            self.registry = types.SimpleNamespace(candidates=lambda: ["exp-1"])

        def start(self):
            return self

    class Client:
        def __init__(self, ep):
            pass

        def register(self, *a, **k):
            pass

        def assignments(self):
            return {}

    class Store:
        port = 4444

        def __init__(self, port=0):
            pass

        def start(self):
            return self

    class Server:
        def __init__(self, cfg):
            seen["server"] = cfg
            self.port, self.model_swaps = 5555, [0, 1, 1, 1]

        def start(self):
            return self

    class Inc:
        def __init__(self, make_server, port=0):
            self.server = make_server(port)
            self.port = self.server.port

    def actor(cfg, broker, actor_id=0):
        seen["actors"].append(cfg)
        if len(seen["actors"]) == 3:
            raise _Stop
        return types.SimpleNamespace(league=None)

    monkeypatch.setattr(jserver, "LeagueService", Service)
    monkeypatch.setattr(jclient, "LeagueClient", Client)
    monkeypatch.setattr(jhandoff, "CarryStoreServer", Store)
    monkeypatch.setattr(jserve, "InferenceServer", Server)
    monkeypatch.setattr(jchaos, "ServeIncarnations", Inc)
    monkeypatch.setattr(jselfplay, "SelfPlayActor", actor)
    monkeypatch.setattr(jservice, "serve", lambda servicer: (types.SimpleNamespace(stop=lambda g: None), 7000))
    monkeypatch.setattr(ref, "_tiny_policy", _tiny_policy)
    # the reference's main runs its host preflight first, which exits when
    # any other process of this repo listens (another test worker's soak):
    # the capture measures nothing, so disclose strays instead
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    with pytest.raises(_Stop):
        ref.main([])
    return seen


def _tiny_policy():
    from dotaclient_tpu.config import PolicyConfig

    return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")


def test_configs_are_the_references(ref, monkeypatch):
    seen = _reference_configs(ref, monkeypatch)
    got = dataclasses.asdict(L.league_config(seen["league"].league.dir))
    assert got == dataclasses.asdict(seen["league"])
    server = dataclasses.asdict(L.server_config(L.tiny_policy(), 0, "127.0.0.1:4321", 4444, "cpu"))
    want = dataclasses.asdict(seen["server"])
    assert server.pop("platform") == "cpu"
    want.pop("platform")
    assert server == want
    for j, theirs in enumerate(seen["actors"]):
        mine = dataclasses.asdict(L.actor_config(L.tiny_policy(), j, "127.0.0.1:7000", 5555, "127.0.0.1:4321", "cpu"))
        theirs = dataclasses.asdict(theirs)
        assert mine.pop("platform") == "cpu"  # the reference's ActorConfig defaults to "cpu" (ROADMAP §C)
        theirs.pop("platform")
        assert mine == theirs
    assert (L.MODELS, L.SLOTS, L.GATE_GAMES) == (4, 3, 2)


def test_verdict_of_the_committed_artifact_is_its_own():
    """The twin's verdict, recomputed from the reference's committed
    LEAGUE_SOAK.json (its default run: two rolls), equals the verdict it
    records."""
    assert L.verdict_of(L.parse_args([]), REFERENCE) == REFERENCE["verdict"]
    broken = json.loads(json.dumps(REFERENCE))
    broken["serve"]["per_life"][0]["model_requests"][0] = 1
    broken["fleet"]["remote_fallbacks"] = 1
    v = L.verdict_of(L.parse_args([]), broken)
    assert not v["live_tree_never_stepped_remotely"] and not v["model_requests_partition_aggregate"]
    assert not v["zero_abandoned_episodes"]
    assert not L.verdict_of(L.parse_args([]), dict(REFERENCE, kills_executed=1))["rolling_killed_server"]
    assert L.verdict_of(L.parse_args(["--quick"]), dict(REFERENCE, kills_executed=1))["rolling_killed_server"]


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield L.run_soak(L.cut_args(["--platform", "cpu"]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    for part in ("fleet", "serve", "league", "replay", "verdict"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part
    assert set(REFERENCE["serve"]["totals"]) <= set(artifact["serve"]["totals"])
    assert set(REFERENCE["serve"]["per_life"][0]) <= set(artifact["serve"]["per_life"][0])


def test_every_verdict_holds(artifact):
    red = [k for k, v in artifact["verdict"].items() if isinstance(v, bool) and not v]
    assert not red, (red, artifact["fleet"], artifact["serve"]["totals"])
    assert artifact["kills_executed"] == 2 and artifact["serve"]["totals"]["incarnations"] == 3
    league = artifact["league"]
    assert league["exploiter_lineage_events"] == ["admit", "promote"] and "exp-1" in league["pool"]
    assert artifact["fleet"]["remote_results_posted"] == league["results_total"] == 3 * L.SMOKE_CUT["episodes_per_actor"]


@pytest.mark.nightly
@pytest.mark.slow
def test_league_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "league.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_league", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == 0 and all(v.values()), (v, proc.stderr[-4000:])
