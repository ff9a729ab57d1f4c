"""The in-network-pack A/B's twin (dotaclient_tpu_torch/scripts/
ab_inet_pack.py) against the reference (scripts/ab_inet_pack.py): the same
flags, its mixed-wire frames byte for byte, the classic staged rows (both
packers, group and single layouts) the reference's row for row, the rows
assembled by real shards at every split (1-4) on both packers bitwise the
reference's classic pack, the inertness check strict (no assemble module,
torch or jax), the verdict from the committed INET_PACK_AB.json its own and
each bar at both edges, and a cut CPU run all green."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dotaclient_tpu_torch.scripts import ab_inet_pack as IP
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "INET_PACK_AB.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_inet_pack")


@pytest.fixture(scope="module")
def frames():
    return IP.mixed_frames()


@pytest.mark.parametrize("quick", [False, True])
def test_flags_and_defaults_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = reference_args(monkeypatch, ref, argv, "preflight_check")
    got = vars(IP.parse_args(argv))
    assert got.pop("out") == "inet_pack_ab_torch.json" and want.pop("out").endswith("INET_PACK_AB.json")
    assert got.pop("platform") == ""
    assert got == want
    assert vars(IP.cut_args()) == vars(IP.parse_args(["--quick"]))


def test_mixed_frames_are_the_references(ref, frames):
    assert frames == ref._mixed_frames()


@pytest.mark.parametrize("single", [False, True], ids=["groups", "single"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_classic_rows_are_the_references(ref, frames, native, single):
    assert IP.classic_hashes(f"c{native}{single}", list(frames), native, CPU, single=single) == \
        ref._classic_hashes(f"rc{native}{single}", list(frames), native, single=single)


@pytest.mark.parametrize("shards", IP.SHARD_SPLITS)
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_assembled_rows_are_the_references_classic_pack(ref, frames, native, shards):
    """Real armed shards, the fabric's block fan-in, the port's staging:
    every row bitwise the reference's classic pack of the same frames, and
    the landing counted in the pool meters."""
    hashes, stats = IP.assembled_hashes(f"a{native}{shards}", list(frames), shards, native, CPU)
    assert hashes == ref._classic_hashes(f"ra{native}{shards}", list(frames), native)
    assert stats["rows_packed"] == IP.SMALL_B and stats["pack_wall_s"] > 0


def test_the_unarmed_broker_is_inert(monkeypatch):
    """The subprocess passes, and its import check names the assemble
    module, torch and jax."""
    assert IP.section_off_inert() == {"inert_ok": True}
    for mod in ("dotaclient_tpu_torch.transport.assemble", "torch", "jax"):
        assert f'"{mod}"' in IP.INERT_CODE
    monkeypatch.setattr(IP, "INERT_CODE", IP.INERT_CODE.replace("srv = BrokerServer(port=0).start()",
                                                                "import torch\nsrv = BrokerServer(port=0).start()"))
    assert IP.section_off_inert()["inert_ok"] is False  # an import on the unarmed path is caught


def test_the_committed_verdict_is_the_twins_rule():
    want = {k: v for k, v in COMMITTED["verdict"].items() if k != "collapse_caveat"}
    got = IP.verdict_of(COMMITTED)
    assert got.pop("collapse_caveat") and got == want


def _with(collapse, copy_4t):
    res = json.loads(json.dumps(COMMITTED))
    res["host_cost"]["pack_over_concat_x"] = collapse
    res["host_memcpy_probe"]["copy_scaling_4t"] = copy_4t
    return IP.verdict_of(res)


def test_the_collapse_bar_arms_only_where_the_probe_shows_parallel_copy():
    v = _with(2.0, 1.5)
    assert v["concat_collapse_ok"] and v["all_green"] and v["collapse_caveat"] is None
    v = _with(1.999, 1.5)
    assert not v["concat_collapse_ok"] and not v["all_green"] and v["collapse_caveat"]
    v = _with(1.999, 1.499)
    assert v["concat_collapse_ok"] and v["all_green"] and "excused" in v["collapse_caveat"]
    res = json.loads(json.dumps(COMMITTED))
    res["parity"]["all_identical"] = False
    res["off_inert"]["inert_ok"] = False
    v = IP.verdict_of(res)
    assert not (v["assembled_bitwise_identical"] or v["assemble_off_inert"] or v["all_green"])


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
        return IP.run(IP.cut_args(["--platform", "cpu"]))


def test_cut_run_is_all_green_with_the_references_keys(artifact):
    v = artifact["verdict"]
    assert v["all_green"], v
    assert set(v) == set(COMMITTED["verdict"]) and set(COMMITTED) <= set(artifact)
    for key in ("parity", "host_cost", "host_memcpy_probe"):
        assert set(COMMITTED[key]) <= set(artifact[key]), key
    assert artifact["host_cost"]["row_bytes"] == COMMITTED["host_cost"]["row_bytes"]


@pytest.mark.nightly
@pytest.mark.slow
def test_ab_inet_pack_quick_on_the_cpu(tmp_path):
    out = tmp_path / "ip.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.ab_inet_pack", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=570, env=env)
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == 0 and v["all_green"], (v, proc.stderr[-4000:])
