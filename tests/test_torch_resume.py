"""Full-state checkpoints, the remote mirror and the SIGTERM drain of the
port's learner: the aux manifest against the reference learner's
`_build_aux` on the same frames; async saves bitwise the synchronous
arrays; the version_hwm bump on restore; a restore pulled from a local
"remote" after the local directory is deleted; a drained learner's restart
trains bitwise the steps an uninterrupted learner trains; and the learner
binary under SIGTERM exits 0 with its final step durable. A scheme-ful
remote (gs://) is refused."""

import dataclasses
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dotaclient_tpu.config import CkptConfig as JCkptConfig
from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.runtime.learner import Learner as JLearner
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu_torch.config import CkptConfig, LearnerConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer, state_arrays
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker
from test_torch_learner import B, POL, T, _state_words, frames_for

REPO = Path(__file__).resolve().parents[1]


def _cfg(name, tmp_path, **kw):
    ckpt = kw.pop("ckpt", CkptConfig(full_state=True, async_save=True))
    return LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**POL, dtype="float32"), broker_url=f"mem://{name}",
                         log_dir=str(tmp_path / name / "logs"), metrics_every=1, ppo=PPOConfig(max_staleness=1000),
                         checkpoint_dir=str(tmp_path / name / "ck"), ckpt=ckpt, **kw)


def _learner(cfg, frames=(), reset=True, prefetch=True):
    name = cfg.broker_url[len("mem://"):]
    if reset:
        tmem.reset(name)
    for f in frames:
        tmem.MemoryBroker(name).publish_experience(f)
    cfg.learner.prefetch = prefetch
    return tlearner.Learner(cfg, tmem.MemoryBroker(name), device="cpu")


def _drain_at(learner, version):
    """run() on a thread, request_drain once `version` steps are done (a
    SIGTERM mid-run), then the drain's final save."""
    t = threading.Thread(target=lambda: learner.run(num_steps=None, batch_timeout=5.0, max_idle=5))
    t.start()
    deadline = time.monotonic() + 60
    while learner.version < version and t.is_alive() and time.monotonic() < deadline:
        time.sleep(0.002)
    learner.request_drain()
    t.join(timeout=60)
    assert not t.is_alive()
    learner.drain_save()


def test_aux_manifest_equals_the_reference_learners(tmp_path):
    """The same pending frames (fewer than a batch) in both learners'
    staging: the decoded manifests agree on step, version_hwm, the pending
    frames in order, env steps and the metrics mark."""
    frames = frames_for(_cfg("x", tmp_path), 1)[: B - 3]
    jcfg = JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**POL, dtype="float32"), broker_url="mem://rs_aux_j",
                          ppo=JPPOConfig(max_staleness=1000), checkpoint_dir=str(tmp_path / "j"),
                          ckpt=JCkptConfig(full_state=True), mesh_shape="dp=1")
    jmem.reset("rs_aux_j")
    jl = JLearner(jcfg, jmem.MemoryBroker("rs_aux_j"), mesh=jmesh.make_mesh("dp=1", devices=__import__("jax").devices()[:1]))
    tl = _learner(_cfg("rs_aux_t", tmp_path))
    try:
        for learner in (jl, tl):
            learner.version = 7
            learner.env_steps_done = 96
            with learner.staging._mutate_lock:
                learner.staging._ingest(list(frames))
        ref = pickle.loads(jl._build_aux(7))
        ours = tlearner.decode_aux(tl._build_aux(7))
    finally:
        jl.close()
        tl.close()
    for key in ("manifest_version", "step", "version_hwm", "env_steps_done", "metrics_last_step"):
        assert ours[key] == ref[key], key
    assert ours["staging"]["pending"] == ref["staging"]["pending"] == frames
    assert tlearner.decode_aux(tlearner.encode_aux(ours)) == ours
    with pytest.raises(ValueError):
        tlearner.decode_aux(b"DTA1" + b"\xff" * 8)


def test_async_full_state_round_trip(tmp_path):
    """ckpt.async_save + full_state: the worker's arrays are bitwise the
    synchronous save's; a fresh learner restores the state bitwise, with
    its version and env steps, and logs the resume scalars once."""
    cfg = _cfg("rs_async", tmp_path, checkpoint_every=2)
    learner = _learner(cfg, frames_for(cfg, 4))
    clone = learner._copier.clone_on_device(learner.state)
    assert {k: v.tobytes() for k, v in learner._copier.to_host(clone).items()} == {
        k: v.tobytes() for k, v in state_arrays(learner.state).items()}
    try:
        assert learner.run(num_steps=4, batch_timeout=30.0, max_idle=3) == 4
    finally:
        learner.close()
    assert learner._ckpt_worker.saved + learner._ckpt_worker.coalesced == 2
    ck = Path(cfg.checkpoint_dir)
    assert (ck / "aux_4.bin").exists() and (ck / "version_hwm").read_text() == "4"
    lines = [json.loads(x) for x in open(Path(cfg.log_dir) / "metrics.jsonl")]
    assert lines[-1]["ckpt_async_saves_total"] >= 1 and "ckpt_aux_written" in lines[-1]
    fresh = _learner(_cfg("rs_async", tmp_path), reset=False)
    try:
        assert fresh.version == 4 and fresh.state.step == 4 and fresh.env_steps_done == learner.env_steps_done
        assert _state_words(fresh.state) == _state_words(learner.state)
        assert fresh.resume_info["resume_restored_step"] == 4 and fresh.resume_info["resume_version_hwm_bump"] == 0
    finally:
        fresh.close()


def test_restore_bumps_the_version_to_the_published_high_water(tmp_path):
    cfg = _cfg("rs_hwm", tmp_path, checkpoint_every=3, ckpt=CkptConfig(full_state=True))
    learner = _learner(cfg, frames_for(cfg, 4))
    try:
        learner.run(num_steps=4, batch_timeout=30.0, max_idle=3)
    finally:
        learner.close()
    ck = Checkpointer(cfg.checkpoint_dir)
    assert ck.latest_step() == 3 and ck.published_hwm() == 4
    fresh = _learner(_cfg("rs_hwm", tmp_path, ckpt=CkptConfig(full_state=True)), frames_for(cfg, 1), reset=False)
    try:
        assert fresh.state.step == 3 and fresh.version == 4
        assert fresh.resume_info["resume_version_hwm_bump"] == 1.0
        fresh.run(num_steps=1, batch_timeout=30.0, max_idle=3)
        line = [json.loads(x) for x in open(Path(cfg.log_dir) / "metrics.jsonl")][-1]
        assert line["step"] == 5 and line["resume_version_hwm_bump"] == 1.0
    finally:
        fresh.close()
    # the plain mode keeps no high-water: a restore resumes at the step
    plain = _cfg("rs_hwm_plain", tmp_path, checkpoint_every=3, ckpt=CkptConfig())
    p = _learner(plain, frames_for(plain, 4))
    p.run(num_steps=4, batch_timeout=30.0, max_idle=3)
    p.close()
    assert not (Path(plain.checkpoint_dir) / "version_hwm").exists()
    assert _learner(plain, reset=False).version == 3


def test_restore_pulls_the_mirror_after_the_local_directory_is_lost(tmp_path):
    remote = tmp_path / "remote"
    cfg = _cfg("rs_mirror", tmp_path, checkpoint_every=2, checkpoint_remote_dir=str(remote))
    frames = frames_for(cfg, 3)
    learner = _learner(cfg, frames[: 2 * B + 5])
    try:
        _drain_at(learner, 2)
    finally:
        learner.close()
    assert sorted(p.name for p in remote.iterdir() if p.name.isdigit()) == ["2"]
    assert (remote / "2" / "MIRROR_COMPLETE").exists() and (remote / "aux_2.bin").exists()
    lines = [json.loads(x) for x in open(Path(cfg.log_dir) / "metrics.jsonl")]
    assert lines[-1]["ckpt_mirror_failures"] == 0 and "ckpt_mirror_superseded" in lines[-1]
    stats = learner.checkpointer.mirror_stats()
    assert stats["mirrored"] >= 1 and stats["last_mirrored_step"] == 2 and stats["lag_steps"] == 0
    shutil.rmtree(cfg.checkpoint_dir)
    fresh = _learner(_cfg("rs_mirror", tmp_path, checkpoint_remote_dir=str(remote)), reset=False)
    try:
        assert fresh.version >= 2 and fresh.state.step == 2
        assert fresh.version >= int((remote / "version_hwm").read_text())
        assert _state_words(fresh.state) == _state_words(learner.state)
        assert fresh.staging.snapshot_state()["pending"] == frames[2 * B : 2 * B + 5]
    finally:
        fresh.close()
    with pytest.raises(ValueError, match="URL scheme"):
        _learner(_cfg("rs_gs", tmp_path, checkpoint_remote_dir="gs://bucket/ck"))


@pytest.mark.parametrize("workers", [1, 2], ids=["pack1", "pack2"])
@pytest.mark.parametrize("prefetch", [True, False], ids=["pipelined", "serial"])
def test_a_drained_learner_resumes_bitwise(tmp_path, prefetch, workers):
    """Drain after 2 batches with half a batch more popped (it goes into
    the aux manifest), save, restart on the same queue with the rest of the
    frames behind it: the final state is bitwise an uninterrupted
    learner's over the same frames."""
    base = _cfg("rs_ref", tmp_path)
    frames = frames_for(base, 6, seed0=30)
    staging = dataclasses.replace(base.staging, pack_workers=workers)
    ref = _learner(dataclasses.replace(base, staging=staging), frames, prefetch=prefetch)
    ref.run(num_steps=6, batch_timeout=30.0, max_idle=3)
    ref.close()
    cut = 2 * B + B // 2
    cfg = dataclasses.replace(_cfg("rs_drain", tmp_path), staging=staging)
    first = _learner(cfg, frames[:cut], prefetch=prefetch)
    _drain_at(first, 2)
    first.close()
    assert first.version == 2
    aux = tlearner.decode_aux((Path(cfg.checkpoint_dir) / "aux_2.bin").read_bytes())
    assert aux["staging"]["pending"] == frames[2 * B : cut]
    for f in frames[cut:]:
        tmem.MemoryBroker("rs_drain").publish_experience(f)
    second = _learner(dataclasses.replace(_cfg("rs_drain", tmp_path), staging=staging), reset=False, prefetch=prefetch)
    assert second.version == 2 and second.resume_info["resume_pending_frames"] == B // 2
    second.run(num_steps=4, batch_timeout=30.0, max_idle=3)
    second.close()
    assert _state_words(second.state) == _state_words(ref.state)


def test_learner_binary_drains_on_sigterm(tmp_path):
    """python -m dotaclient_tpu_torch.runtime.learner with the manifest's
    checkpoint flags over tcp://: SIGTERM mid-run exits 0, and the final
    full-state step (aux manifest and high-water included) is on disk."""
    server = BrokerServer("127.0.0.1", 0).start()
    try:
        cfg = _cfg("rs_bin", tmp_path)
        client = TcpBroker("127.0.0.1", server.port)
        for f in frames_for(cfg, 40, seed0=50):
            client.publish_experience(f)
        ck, logs = tmp_path / "ck", tmp_path / "logs"
        argv = [sys.executable, "-m", "dotaclient_tpu_torch.runtime.learner", "--platform", "cpu",
                "--broker_url", f"tcp://127.0.0.1:{server.port}", "--mesh_shape", "dp=-1", "--batch_size", str(B),
                "--seq_len", str(T), "--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16",
                "--policy.mlp_hidden", "16", "--policy.dtype", "float32", "--ppo.max_staleness", "1000",
                "--checkpoint_dir", str(ck), "--checkpoint_remote_dir", str(tmp_path / "remote"),
                "--checkpoint_every", "1000", "--ckpt.full_state", "true", "--ckpt.async_save", "true",
                "--ckpt.drain_on_sigterm", "true", "--ckpt.drain_budget_s", "45", "--staging.pack_workers", "2",
                "--log_dir", str(logs), "--metrics_every", "1", "--obs.enabled", "true", "--obs.dump_dir", str(logs)]
        proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": str(REPO)})
        try:
            deadline = time.monotonic() + 120
            while not (logs / "metrics.jsonl").exists() or not (logs / "metrics.jsonl").read_text().count("\n"):
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.1)
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, out
        assert "SIGTERM drain complete" in out
        steps = Checkpointer(str(ck)).all_steps()
        version = int(out.split("SIGTERM drain complete at version ")[1].split(";")[0])
        assert steps[-1] == version >= 1 and (ck / f"aux_{version}.bin").exists()
        aux = tlearner.decode_aux((ck / f"aux_{version}.bin").read_bytes())
        assert aux["step"] == version and len(aux["staging"]["pending"]) < B
        assert int((ck / "version_hwm").read_text()) == version
        assert (tmp_path / "remote" / str(version) / "MIRROR_COMPLETE").exists()
        assert not list(logs.glob("flight_*sigterm*"))  # the drain replaced the recorder's dump
        client.close()
    finally:
        server.stop()
