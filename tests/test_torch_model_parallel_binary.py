"""The port's learner binary over rank groups on the CPU: two real rank
processes over gloo (tests/torch_model_parallel_worker.py, `binary` job),
each fed by its own mem:// broker (mem:// cannot span processes;
production shares one tcp:// broker):

- `--mesh_shape dp=1,sp=2` with the transformer family and
  `--policy.tf_sp_axis sp` (the tree path);
- `--mesh_shape dp=1,tp=2` with the LSTM: its checkpoint keeps whole
  leaves and restores bitwise into a one-process learner, and a restart of
  both ranks from the mirror takes the same next step as that learner;
- a restart at dp=2 with rank 1's /ckpt empty: rank 1 restores from rank
  0's mirror without re-injecting rank 0's pending frames, so no frame is
  trained by two ranks.

Every spawn has a join timeout, so a hang fails its test."""

import dataclasses
import json
import os

import numpy as np

from dotaclient_tpu_torch.config import LearnerConfig, parse_config
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.params import named_params
from test_torch_learner import frames_for
from test_torch_model_parallel import _free_port, join, spawn

WORLD = 2
SMALL = ["--policy.unit_embed_dim", "16", "--policy.lstm_hidden", "16", "--policy.mlp_hidden", "16",
         "--policy.dtype", "float32", "--platform", "cpu", "--metrics_every", "1"]
TF = ["--policy.arch", "transformer", "--policy.tf_heads", "2", "--policy.tf_context", "16", "--batch_size", "8",
      "--seq_len", "7"]
LSTM = ["--batch_size", "8", "--seq_len", "4"]


def _frames(flags, n_rows: int, seed0: int) -> dict:
    """n_rows rollout frames for the policy of `flags`."""
    cfg = parse_config(LearnerConfig(), flags)
    per = 4
    frames = frames_for(LearnerConfig(batch_size=per, seq_len=cfg.seq_len, policy=cfg.policy), -(-n_rows // per),
                        seed0=seed0)[:n_rows]
    return {f"f{i}": np.frombuffer(f, np.uint8) for i, f in enumerate(frames)}


def _binary(out: str, argvs, frames) -> list:
    with open(os.path.join(out, "port"), "w") as f:
        f.write(str(_free_port()))
    for r in range(WORLD):
        with open(os.path.join(out, f"argv_{r}.json"), "w") as f:
            json.dump(argvs[r], f)
        np.savez(os.path.join(out, f"frames_{r}.npz"), **frames[r])
    join(spawn("binary", out, WORLD), "binary")
    return [json.load(open(os.path.join(out, f"binary_{r}.json"))) for r in range(WORLD)]


def _params(out: str, rank: int) -> dict:
    return dict(np.load(os.path.join(out, f"params_{rank}.npz")))


def _whole(out: str, sharded) -> dict:
    """The two ranks' params, the sharded leaves' slices joined on the last dim."""
    p0, p1 = _params(out, 0), _params(out, 1)
    return {n: np.concatenate([p0[n], p1[n]], axis=-1) if n in sharded else p0[n] for n in p0}


def test_sequence_parallel_binary_at_two_ranks(tmp_path):
    """learner.main with --mesh_shape dp=1,sp=2: three steps; each rank
    trains its own rows (no row twice), both end bitwise equal, rank 0
    alone publishes."""
    t = str(tmp_path)
    flags = TF + SMALL + ["--mesh_shape", "dp=1,sp=2", "--policy.tf_sp_axis", "sp", "--train_steps", "3"]
    res = _binary(t, [flags + ["--log_dir", os.path.join(t, f"logs{r}")] for r in range(WORLD)],
                  [_frames(flags, 12, 10 * r) for r in range(WORLD)])
    assert [r["version"] for r in res] == [3, 3]
    assert [len(r["trained"]) for r in res] == [12, 12] and not set(res[0]["trained"]) & set(res[1]["trained"])
    assert res[0]["weights"] and res[0]["published"] >= 1 and not res[1]["weights"]
    p0, p1 = _params(t, 0), _params(t, 1)
    assert all(np.array_equal(p0[n], p1[n]) and np.isfinite(p0[n]).all() for n in p0)


def test_tensor_parallel_checkpoint_restores_into_one_process_and_back(tmp_path):
    """--mesh_shape dp=1,tp=2: three steps, a checkpoint at step 3 with a
    mirror. The ranks hold halves of the sharded leaves; the file holds
    whole leaves, and a one-process learner restores them bitwise. Then
    both ranks restart from the mirror (empty /ckpt) and take one step on
    their rows; a one-process learner restored from the same step and fed
    the same rows in rank order ends bitwise equal to the joined slices."""
    t = str(tmp_path)
    base = LSTM + SMALL + ["--mesh_shape", "dp=1,tp=2", "--checkpoint_every", "3"]
    ck = [os.path.join(t, f"ck{r}") for r in range(WORLD)]
    mirror = os.path.join(t, "mirror")
    argv = lambda r, steps, ckpt: base + ["--train_steps", str(steps), "--checkpoint_dir", ckpt,
                                          "--checkpoint_remote_dir", mirror, "--log_dir", os.path.join(t, f"l{r}_{steps}")]
    res = _binary(t, [argv(r, 3, ck[r]) for r in range(WORLD)], [_frames(base, 12, 10 * r) for r in range(WORLD)])
    assert [r["version"] for r in res] == [3, 3]
    sharded = set(res[0]["sharded"])
    assert sharded and set(res[1]["sharded"]) == sharded
    whole = _whole(t, sharded)
    cfg = parse_config(LearnerConfig(), LSTM + SMALL)
    one = tlearner.Learner(dataclasses.replace(cfg, checkpoint_dir=ck[0]), tmem.MemoryBroker("mpb_one"), device="cpu")
    try:
        assert one.version == 3
        assert all(np.array_equal(a, whole[n]) for n, a in named_params(one.state.net))
    finally:
        one.close()

    frames = [_frames(base, 4, 70 + 10 * r) for r in range(WORLD)]
    res = _binary(t, [argv(r, 1, os.path.join(t, f"empty{r}")) for r in range(WORLD)], frames)
    assert [r["version"] for r in res] == [4, 4]  # restored at 3 from the mirror, one step
    tmem.reset("mpb_next")
    hub = tmem.MemoryBroker("mpb_next")
    for r in range(WORLD):
        for i in range(len(frames[r])):
            hub.publish_experience(frames[r][f"f{i}"].tobytes())
    one = tlearner.Learner(dataclasses.replace(cfg, checkpoint_dir=ck[0], broker_url="mem://mpb_next"), hub,
                           device="cpu")
    try:
        assert one.run(1, max_idle=100, batch_timeout=0.1) == 1
        whole = _whole(t, sharded)
        assert all(np.array_equal(a, whole[n]) for n, a in named_params(one.state.net))
    finally:
        one.close()


def test_a_rank_restored_from_the_mirror_leaves_rank_0_its_pending_frames(tmp_path):
    """Two dp ranks drained by SIGTERM, each with two frames pending in its
    full-state manifest; rank 0 mirrors its checkpoint. Restarted with rank
    1's /ckpt empty, rank 1 pulls rank 0's step from the mirror: it takes
    the version high-water mark but re-injects none of rank 0's pending
    frames, which rank 0 re-injects itself. No row is trained by both
    ranks."""
    t = str(tmp_path)
    mirror = os.path.join(t, "mirror")
    base = LSTM + SMALL + ["--mesh_shape", "dp=-1", "--checkpoint_every", "2", "--ckpt.full_state", "true",
                           "--checkpoint_remote_dir", mirror]
    drain = ["--ckpt.drain_on_sigterm", "true", "--ckpt.drain_budget_s", "60", "--train_steps", "0"]
    first = _binary(t, [base + drain + ["--checkpoint_dir", os.path.join(t, f"ck{r}"), "--log_dir",
                                        os.path.join(t, f"a{r}")] for r in range(WORLD)],
                    [_frames(base, 14, 10 * r) for r in range(WORLD)])
    assert [r["version"] for r in first] == [3, 3]
    ckpts = [os.path.join(t, "ck0"), os.path.join(t, "empty")]
    second = _binary(t, [base + ["--train_steps", "1", "--checkpoint_dir", ckpts[r], "--log_dir",
                                 os.path.join(t, f"b{r}")] for r in range(WORLD)],
                     [_frames(base, 2, 50), _frames(base, 4, 60)])
    assert [r["version"] for r in second] == [4, 4]
    windows = [json.loads(open(os.path.join(t, f"b{r}", "metrics.jsonl")).readline()) for r in range(WORLD)]
    assert [w["resume_restored_step"] for w in windows] == [3.0, 3.0]
    assert [w["resume_pending_frames"] for w in windows] == [2.0, 0.0]
    assert [len(r["trained"]) for r in second] == [4, 4]
    assert not set(second[0]["trained"]) & set(second[1]["trained"])
    assert not set(second[1]["trained"]) & set(first[0]["trained"] + first[1]["trained"])
