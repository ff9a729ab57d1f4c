"""The bench's twin (dotaclient_tpu_torch/bench.py) against the reference's
root bench.py: the producers' frames byte for byte, the flagship config
field by field, the accounting (FLOPs per step, wire bytes per env step,
H2D and D2H bytes) equal to the reference's functions on the same config,
and a cut CPU run at a small config that emits the reference's keys (read
from its source), nested sections included, with the staging ring and
the other transfer layout switched on by the reference's env knobs."""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.ops import flops as jflops
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.parallel.fused_io import FusedBatchIO as JFusedBatchIO
from dotaclient_tpu.runtime.staging import cast_obs_to_compute_dtype as j_cast
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch import bench as B
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig

REPO = Path(__file__).resolve().parents[1]
SMALL_POLICY = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16)
SMALL = dict(batch_size=8, seq_len=4)


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_keys():
    """The keys of the reference main's output dict and of its nested
    sections, from its source: {section: keys}, "" for the top level."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if names and names[0] in ("out", "compute_section", "transfer_ab"):
                d = node.value
                keys.setdefault("" if names[0] == "out" else names[0], set()).update(
                    k.value for k in d.keys if isinstance(k, ast.Constant))
                if names[0] == "out":
                    for k, v in zip(d.keys, d.values):
                        if isinstance(v, ast.Dict):
                            keys[k.value] = {x.value for x in v.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if isinstance(target.value, ast.Name) and target.value.id in ("out", "transfer_ab"):
                keys.setdefault("" if target.value.id == "out" else target.value.id, set()).add(target.slice.value)
    return keys


def _small_configs():
    return (LearnerConfig(**SMALL, policy=PolicyConfig(**SMALL_POLICY)),
            JLearnerConfig(**SMALL, policy=JPolicyConfig(**SMALL_POLICY)))


@pytest.mark.parametrize("n,width", [(3, 16), (2, 128)])
def test_the_producers_frames_are_the_references(ref, n, width):
    cfg = LearnerConfig(batch_size=8, seq_len=16, policy=PolicyConfig(lstm_hidden=width))
    jcfg = JLearnerConfig(batch_size=8, seq_len=16, policy=JPolicyConfig(lstm_hidden=width))
    assert B._make_frames(cfg, n) == ref._make_frames(jcfg, n)


def test_the_flagship_config_is_the_references():
    got = dataclasses.asdict(B.bench_config())
    want = dataclasses.asdict(JLearnerConfig(batch_size=256, seq_len=16, mesh_shape="dp=-1"))
    assert got.pop("platform") == want.pop("platform")
    assert got == want
    assert B.bench_config(4).staging.pack_workers == 4 and not B.bench_config(single=False).fused_single_h2d


def test_the_flagship_flops_are_the_references():
    assert B.run.__defaults__ == ("", None, None)  # the flagship and the reference's depths by default
    from dotaclient_tpu_torch.ops import flops

    assert flops.train_step_flops(B.bench_config()) == jflops.train_step_flops(
        JLearnerConfig(batch_size=256, seq_len=16))


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DOTACLIENT_TPU_BENCH_PACK_WORKERS", raising=False)
        mp.delenv("DOTACLIENT_TPU_BENCH_SINGLE", raising=False)
        return B.run("cpu", B.SMOKE_CUT, base=_small_configs()[0])


def test_the_cut_run_emits_the_references_keys(artifact):
    keys = _reference_keys()
    # the reference's optional keys: the alternate layout (an env knob) and
    # its accelerator probe's CPU fallback (not carried over)
    optional = {"e2e_alt_layout_steps_per_sec", "e2e_alt_layout", "e2e_alt_layout_error", "fallback_reason",
                "last_silicon"}
    assert set(artifact) == (keys[""] - optional) | {"vs_baseline_reason"}
    for section in ("split", "pipeline"):
        assert set(artifact[section]) == keys[section]
    assert set(artifact["compute_breakdown"]) == keys["compute_section"] - {"error"}  # "error": its failure dict
    assert set(artifact["transfer_layout_ab"]) == keys["transfer_ab"]
    assert set(artifact["trace_stage_breakdown"]) >= {"pack_ms", "h2d_ms", "apply_ms", "e2e_actor_apply_s"}


def test_the_cut_run_states_no_foreign_baseline(artifact):
    assert artifact["vs_baseline"] is None and artifact["vs_baseline_reason"] == B.VS_BASELINE_REASON
    assert artifact["flops_per_step_xla"] is None and artifact["mfu_pct"] is None  # no card, no peak
    assert artifact["platform"] == "cpu" and artifact["pack_workers"] == 1
    assert artifact["value"] > 0 and artifact["device_only_steps_per_sec"] > 0
    assert artifact["compute_breakdown"]["recompiles"] == 0 and artifact["compute_breakdown"]["first_call_s"] == 0.0
    assert "CPU device(s): CPU, batch 8x4" in artifact["unit"]


def test_the_accounting_is_the_references(artifact):
    cfg, jcfg = _small_configs()
    assert artifact["flops_per_step_model"] == round(jflops.train_step_flops(jcfg))
    frame = B._make_frames(cfg, 1)[0]
    assert artifact["wire_bytes_per_env_step"] == round(len(frame) / 4, 1)
    bf16 = jser.serialize_rollout(jser.cast_rollout_obs_bf16(jser.deserialize_rollout(frame)))
    assert artifact["wire_bytes_per_env_step_bf16"] == round(len(bf16) / 4, 1)
    template = j_cast(jcfg, jax.tree.map(np.asarray, jts._batch_template(jcfg)))
    jio = JFusedBatchIO(template, jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))
    assert artifact["h2d_bytes_per_iter"] == 8 * jio.row_bytes  # the single [B, row_bytes] buffer
    assert artifact["transfer_layout_ab"]["bytes"] == 8 * jio.row_bytes
    obs = (template.obs.global_feats, template.obs.hero_feats, template.obs.unit_feats)
    assert artifact["h2d_obs_bytes_per_iter"] == sum(int(leaf.nbytes) for leaf in obs)
    assert artifact["pack_path_obs_dtype"] == np.dtype(obs[0].dtype).name == "bfloat16"
    shapes = jax.eval_shape(lambda: jts.init_train_state(jcfg, jax.random.PRNGKey(0)).params)
    assert artifact["d2h_bytes_per_iter"] == 4 * sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_the_env_knobs_run_the_ring_and_the_other_layout(monkeypatch):
    monkeypatch.setenv("DOTACLIENT_TPU_BENCH_PACK_WORKERS", "2")
    monkeypatch.setenv("DOTACLIENT_TPU_BENCH_SINGLE", "1")
    cut = dict(B.SMOKE_CUT, pack_window_s=0.3, e2e_iters=2, trace_batches=1, compute_steps=1, put_reps=1)
    out = B.run("cpu", cut, base=_small_configs()[0])
    assert out["pack_workers"] == 2 and out["value"] > 0
    assert out["e2e_alt_layout"] == "groups_4_buffers" and out["e2e_alt_layout_steps_per_sec"] > 0


def test_main_keeps_the_one_line_contract_on_failure(monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("no card")

    monkeypatch.setattr(B, "run", boom)
    out = tmp_path / "b.json"
    assert B.main(["--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text())
    assert line["value"] == 0.0 and line["error"] == "RuntimeError: no card" and line["vs_baseline"] is None


def test_the_card_is_the_default_and_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B._device_of("")
