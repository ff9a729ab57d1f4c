"""The transformer micro-bench's twin (dotaclient_tpu_torch/scripts/
bench_tf.py) against the reference (scripts/bench_tf.py): the same flags,
the same shape ladder (read off the reference's main by recording its
bench_config calls), each shape's LearnerConfig field by field and its
FLOPs per step equal to the reference's ops/flops.py, and a cut CPU run
(a two-shape ladder at batch 2) that writes the reference's artifact and
row keys (read from its source), with the smoke's measure hook."""

import argparse
import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.ops import flops as jflops
from dotaclient_tpu_torch.ops import flops
from dotaclient_tpu_torch.scripts import bench_tf as BT
from torch_ab_reference import Stop, load_reference

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    return load_reference("bench_tf")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    got = vars(BT.parse_args([]))
    box = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        raise Stop  # the reference's main catches what a shape raises: stop at the parse

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        ref.main([])
    want = vars(box["args"])
    assert got.pop("out") == "tf_bench_torch.json" and want.pop("out") == "TF_BENCH.json"
    assert got.pop("platform") == ""
    assert got == want


def _reference_ladder(ref, monkeypatch, tmp_path):
    seen = []

    def record(*a):
        seen.append(a)
        raise RuntimeError("recorded")  # the reference records the failed shape and goes on

    monkeypatch.setattr(ref, "bench_config", record)
    ref.main(["--out", str(tmp_path / "tf.json")])
    return seen


def test_the_ladder_is_the_references(ref, monkeypatch, tmp_path):
    seen = _reference_ladder(ref, monkeypatch, tmp_path)
    assert [(c, b, r) for c, b, r, _batch, _iters in seen] == list(BT.LADDER)
    assert {(batch, iters) for *_, batch, iters in seen} == {(64, 10)}


def _reference_config(ctx, block, remat, batch):
    return JLearnerConfig(batch_size=batch, seq_len=ctx - 1, mesh_shape="dp=-1", policy=JPolicyConfig(
        arch="transformer", tf_layers=2, tf_heads=4, tf_context=ctx, tf_attn_block=block, tf_remat=remat))


@pytest.mark.parametrize("shape", BT.LADDER)
def test_each_shapes_config_and_flops_are_the_references(shape):
    ctx, block, remat = shape
    mine, theirs = BT.ladder_config(ctx, block, remat, 64), _reference_config(ctx, block, remat, 64)
    got, want = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert got.pop("platform") == want.pop("platform")
    assert got == want
    assert flops.train_step_flops(mine) == jflops.train_step_flops(theirs)


def _reference_keys():
    tree = ast.parse((REPO / "scripts" / "bench_tf.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            row = {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and node.targets[0].id == "artifact":
            artifact = {k.value for k in node.value.keys}
    return artifact, row


def test_a_cut_cpu_run_writes_the_references_keys(tmp_path):
    args = BT.parse_args(["--platform", "cpu", "--iters", "1", "--batch", "2", "--out", str(tmp_path / "tf.json")])
    art = BT.run(args, ladder=((8, 0, False), (8, 4, True)))
    artifact_keys, row_keys = _reference_keys()
    assert set(art) == artifact_keys and art["backend"] == "cpu" and art["valid_as_silicon_evidence"] is False
    assert [set(r) for r in art["rows"]] == [row_keys, row_keys], art["rows"]
    for row in art["rows"]:
        assert row["flops_per_step_model"] == round(jflops.train_step_flops(
            _reference_config(row["tf_context"], row["attn_block"], row["remat"], 2)))
        assert row["mfu_pct"] is None and row["env_steps_per_sec"] > 0  # no peak on the CPU


def test_the_measure_hook_sees_the_first_step_and_adds_its_keys():
    seen = {}

    def measure(run, state, metrics):
        seen["first"] = {k: v.detach().clone() for k, v in state.net.state_dict().items()}
        seen["metrics"] = metrics
        run()
        return {"extra_ms": 1.0}

    row = BT.bench_config(8, 0, False, 2, 1, torch.device("cpu"), measure=measure)
    assert row["extra_ms"] == 1.0 and set(seen["metrics"]) >= {"loss", "grad_norm"}
    assert json.dumps(row)
