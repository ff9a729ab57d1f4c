"""The overlap A/B's twin (dotaclient_tpu_torch/scripts/ab_overlap.py)
against the reference (scripts/ab_overlap.py): the same flags, the parity
and throughput learners' configs the reference's field by field, the
schedcheck section on the port's copy equal to the reference's, the host
probe's keys, the verdict from the committed OVERLAP_AB.json its own and
each bar at both edges, and a cut CPU run: serial and pipelined learners
bitwise on both transfer layouts, the three layouts timed, the defaults
on."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dotaclient_tpu_torch.config import LearnerConfig
from dotaclient_tpu_torch.scripts import ab_overlap as OV
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "OVERLAP_AB.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_overlap")


@pytest.mark.parametrize("quick", [False, True])
def test_flags_and_defaults_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = reference_args(monkeypatch, ref, argv, "preflight_check")
    got = vars(OV.parse_args(argv))
    assert got.pop("out") == "overlap_ab_torch.json" and want.pop("out").endswith("OVERLAP_AB.json")
    assert got.pop("platform") == ""
    assert got == want
    assert vars(OV.cut_args()) == vars(OV.parse_args(["--quick"]))


def _same(mine, theirs):
    got, want = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert got.pop("platform") == "cpu" and want.pop("platform") == ""
    assert got == want


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("single", [False, True])
def test_parity_learners_are_the_references(ref, prefetch, single):
    _same(OV.parity_config("n", prefetch, single, log_dir="/x", platform="cpu"),
          ref._cfg("n", prefetch, single, log_dir="/x"))


@pytest.mark.parametrize("prefetch", [False, True])
def test_throughput_learners_are_the_references(ref, prefetch):
    _same(OV.throughput_config("t", prefetch, log_dir="/y", platform="cpu"), ref._tp_cfg("t", prefetch, log_dir="/y"))


def test_schedcheck_section_on_the_ports_copy_is_the_references(ref):
    assert OV.section_schedcheck() == ref.section_schedcheck()
    assert OV.section_schedcheck()["ok"]


def test_host_probe_keys_are_the_references(ref):
    assert set(OV.section_host_concurrency(2)) == set(ref.section_host_concurrency(2))


def test_the_committed_verdict_is_the_twins_rule():
    want = {k: v for k, v in COMMITTED["verdict"].items() if k != "overlap_caveat"}
    got = OV.verdict_of(COMMITTED, LearnerConfig())
    assert got.pop("overlap_caveat") and got == want


def _with(ratio, probe, pipe_over_serial=1.0):
    res = json.loads(json.dumps(COMMITTED))
    res["throughput"]["pipelined"]["e2e_over_device_only"] = ratio
    res["host_concurrency"]["compute_retention_with_helper"] = probe
    res["throughput"]["pipelined_over_serial"] = pipe_over_serial
    return OV.verdict_of(res, LearnerConfig())


def test_the_overlap_bar_arms_only_where_the_probe_keeps_compute():
    assert _with(0.98, 0.97)["overlap_ok"] and _with(0.98, 0.97)["all_green"]
    v = _with(0.979, 0.97)
    assert not v["overlap_ok"] and not v["all_green"] and v["host_can_express_overlap"]
    v = _with(0.979, 0.969)
    assert v["overlap_ok"] and v["all_green"] and v["overlap_caveat"]


def test_the_no_regression_bar_holds_on_every_host():
    assert _with(0.5, 0.2, 0.9)["no_regression_ok"]
    v = _with(0.5, 0.2, 0.899)
    assert not v["no_regression_ok"] and not v["all_green"]


def test_the_defaults_are_checked():
    cfg = LearnerConfig()
    cfg.learner.prefetch = False
    assert not OV.verdict_of(COMMITTED, cfg)["all_green"]
    assert not OV.verdict_of(COMMITTED, LearnerConfig(fused_single_h2d=False))["fused_single_h2d_default_on"]


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
        return OV.run(OV.cut_args(["--platform", "cpu"]))


def test_cut_run_serial_and_pipelined_are_bitwise_on_both_layouts(artifact):
    par = artifact["parity"]
    assert par["all_identical"]
    for layout in ("single_buffer", "groups_4_buffers"):
        for arm in ("serial", "pipelined"):
            rec = par[layout][arm]
            assert rec["frames_consumed"] == OV.B * 6 and not rec["lane_alive_after_run"]
            assert rec["loss_history"], (layout, arm)
    assert par["single_buffer"]["serial"]["state_sha256"] == par["groups_4_buffers"]["serial"]["state_sha256"]


def test_cut_run_has_the_references_keys_and_held_bars(artifact):
    v = artifact["verdict"]
    assert set(v) == set(COMMITTED["verdict"]) and set(COMMITTED) <= set(artifact)
    assert v["params_bitwise_identical"] and v["schedcheck_ok"] and v["prefetch_default_on"]
    assert v["fused_single_h2d_default_on"]
    tp = artifact["throughput"]
    assert tp["serial"]["steps"] == tp["pipelined"]["steps"] == 12
    assert [len(tp[a]["runs"]) for a in ("serial", "pipelined")] == [2, 2] and tp["turns"] == list(OV.TP_TURNS)
    for arm in ("serial", "pipelined"):
        mean = sum(r["env_steps_per_sec"] for r in tp[arm]["runs"]) / 2
        assert abs(tp[arm]["env_steps_per_sec"] - mean) <= 0.05
    assert tp["device_only_steps"] == 13 and tp["device_only_steps_per_sec"] > 0
    assert set(artifact["transfer_layout"]) >= {"tree_leaves_ms", "groups_4_buffers_ms", "single_buffer_ms"}


@pytest.mark.nightly
@pytest.mark.slow
def test_ab_overlap_quick_on_the_cpu(tmp_path):
    out = tmp_path / "ov.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.ab_overlap", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=1800, env=env)
    art = json.loads(out.read_text())
    assert proc.returncode == 0 and art["verdict"]["all_green"], (art["verdict"], proc.stderr[-4000:])
    assert art["parity"]["all_identical"]
