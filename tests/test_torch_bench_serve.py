"""The serve-tier bench's twin (dotaclient_tpu_torch/scripts/bench_serve.py)
against the reference (scripts/bench_serve.py): the same flags (and the
same --quick overrides), the same merge of client processes, the same
row, arm and verdict keys as the reference's main run on canned arms,
the verdict anchored to the fresh vector arm at both edges of its 1.5x
bar, the children's environment free of the reference's JAX settings,
and a cut CPU run: a vector process, a fresh port server and a remote
client process at the small policy."""

import json
import types

import pytest

from dotaclient_tpu_torch.scripts import bench_serve as BS
from torch_ab_reference import Stop, load_reference

PARTS = [
    {"offered_steps_per_sec": 50.0, "steps": 100, "seconds": 2.0, "p50_ms": 4.0, "p99_ms": 9.0, "samples": 100,
     "wire_errors": 0, "cpu_util": 0.5},
    {"offered_steps_per_sec": 70.0, "steps": 140, "seconds": 2.1, "p50_ms": 3.0, "p99_ms": 12.0, "samples": 140,
     "wire_errors": 1, "cpu_util": 0.6},
]
VECTOR = {"offered_steps_per_sec": 80.0, "steps": 160, "seconds": 2.0, "p50_ms": 5.0, "p99_ms": 7.0, "samples": 160,
          "occupancy": 1.0, "cpu_util": 1.0}
STATS = {"actor_batch_occupancy": 0.9, "actor_tick_rows_1": 3.0, "actor_tick_rows_2": 0.0, "serve_requests_total": 9}


@pytest.fixture(scope="module")
def ref():
    return load_reference("bench_serve")


@pytest.mark.parametrize("argv", [[], ["--quick"], ["--role", "remote", "--envs", "3", "--warmup_seconds", "1"]])
def test_flags_defaults_and_quick_are_the_references(ref, monkeypatch, argv):
    got = vars(BS.parse_args(argv))
    box = {}
    import argparse

    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        return box["args"]

    def stop(*a, **k):
        raise Stop

    import dotaclient_tpu.obs.preflight as jpreflight

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(jpreflight, "check", stop)
    monkeypatch.setattr(ref, "run_remote_client", stop)
    with pytest.raises(Stop):
        ref.main(argv)
    want = vars(box["args"])  # after the reference's --quick overrides
    assert got.pop("out") == "serve_bench_torch.json" and want.pop("out") == "SERVE_BENCH.json"
    assert got.pop("platform") == ""
    if want["role"] != "orchestrate":
        want["envs"] = str(want["envs"])  # the reference casts a client's --envs before it returns
    assert got == want


def test_the_client_merge_is_the_references(ref):
    assert BS._merge_serve_clients(PARTS) == ref._merge_serve_clients(PARTS)


def _reference_artifact(ref, monkeypatch, tmp_path):
    """The reference's orchestrator on canned clients and server."""
    def client(role, args, envs, extra):
        return dict(VECTOR) if role == "vector" else dict(PARTS[0], wire_errors=0)

    monkeypatch.setattr(ref, "_run_client", client)
    monkeypatch.setattr(ref, "_spawn_server", lambda *a: (types.SimpleNamespace(kill=lambda: None,
                                                                                 wait=lambda timeout: 0), 1))
    monkeypatch.setattr(ref, "_server_stats", lambda port: dict(STATS))
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    out = tmp_path / "ref.json"
    assert ref.main(["--out", str(out), "--envs", "2,8"]) == 0
    return json.loads(out.read_text())


def _twin_artifact(monkeypatch, tmp_path):
    def client(role, args, envs, extra, name, children):
        return dict(VECTOR) if role == "vector" else dict(PARTS[0], wire_errors=0)

    monkeypatch.setattr(BS, "_run_client", client)
    monkeypatch.setattr(BS, "_spawn_server", lambda *a: (types.SimpleNamespace(
        send_signal=lambda sig: None, kill=lambda: None, wait=lambda timeout: 0), 1))
    monkeypatch.setattr(BS, "_server_stats", lambda port: dict(STATS))
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    out = tmp_path / "twin.json"
    assert BS.main(["--out", str(out), "--envs", "2,8", "--platform", "cpu"]) == 0
    return json.loads(out.read_text())


def test_the_keys_and_rows_are_the_references(ref, monkeypatch, tmp_path):
    theirs = _reference_artifact(ref, monkeypatch, tmp_path)
    mine = _twin_artifact(monkeypatch, tmp_path)
    assert set(mine) == set(theirs) and set(mine["verdict"]) == set(theirs["verdict"])
    assert set(mine["host"]) == set(theirs["host"]) - {"jax"} | {"torch", "device"}
    assert mine["serve_config"] == theirs["serve_config"]
    for a, b in zip(mine["curve"], theirs["curve"]):
        assert set(a) == set(b) and a["vector"] == b["vector"] and a["serve"] == b["serve"]
        assert a["serve_speedup_vs_fresh_vector"] == b["serve_speedup_vs_fresh_vector"]
        assert a["vector_pr5_committed_steps_per_sec"] is None and a["serve_speedup_vs_pr5_fleet"] is None
    # the twin anchors its verdict to the fresh arm, the reference to its committed curve
    assert mine["verdict"]["speedup_at_largest"] == theirs["verdict"]["fresh_vector_speedup_at_largest"]


def _row(n, vector, serve, errors=0):
    return {"envs": n, "vector": {"offered_steps_per_sec": vector}, "serve": {"offered_steps_per_sec": serve,
                                                                               "wire_errors": errors},
            "serve_speedup_vs_fresh_vector": round(serve / (vector or 1.0), 3)}


def test_the_verdict_holds_the_fresh_anchor_to_the_bar_at_both_edges():
    assert BS.verdict_of([_row(2, 10.0, 5.0), _row(8, 10.0, 15.0)])["ok"]
    v = BS.verdict_of([_row(2, 10.0, 5.0), _row(8, 10.0, 14.99)])
    assert not v["ok"] and v["largest_matched_envs"] == 8 and v["speedup_at_largest"] == 1.499
    assert not BS.verdict_of([_row(8, 10.0, 20.0, errors=1)])["ok"]
    assert not BS.verdict_of([_row(2, 0.0, 20.0), _row(8, 10.0, 20.0)])["ok"]
    assert not BS.verdict_of([_row(4, 10.0, 40.0)])["ok"]  # no N >= 8: nothing to judge
    assert BS.verdict_of([_row(8, 10.0, 15.0), _row(16, 10.0, 16.0)])["largest_matched_envs"] == 16


def test_the_childrens_environment_has_the_port_and_no_jax_settings(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    env = BS._clean_env()
    assert not any(k.startswith(("JAX_", "XLA_")) for k in env)
    assert env["PYTHONPATH"].split(":")[0] == BS.REPO


def test_the_cut_is_one_n_at_the_flagship_policy():
    args = BS.cut_args(["--platform", "cpu"])
    assert (args.envs, args.seconds, args.warmup, args.warmup_seconds, args.policy) == ("4", 1.0, 2.0, 2.0,
                                                                                        "flagship")


def test_a_cut_cpu_run_serves_and_steps_both_arms(tmp_path, monkeypatch):
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    out = tmp_path / "sb.json"
    assert BS.main(["--platform", "cpu", "--policy", "small", "--envs", "2", "--seconds", "0.5", "--warmup", "1",
                    "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    (row,) = art["curve"]
    assert row["vector"]["offered_steps_per_sec"] > 0 and row["serve"]["offered_steps_per_sec"] > 0
    assert row["serve"]["wire_errors"] == 0 and row["serve"]["client_processes"] == 1
    assert row["serve"]["server"]["requests_total"] > 0 and 0 < row["serve"]["server"]["occupancy"] <= 1.0
    assert art["verdict"]["largest_matched_envs"] is None and art["verdict"]["ok"] is False  # no N >= 8 in this cut
