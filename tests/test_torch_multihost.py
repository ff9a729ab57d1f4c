"""The port's multi-process learner (parallel/dist.py, one process per card,
`dp` = the world size) on the CPU: two real processes over gloo
(tests/torch_multihost_worker.py), each on its B / 2 rows of the global
batch, held against the JAX `build_train_step` on one CPU device at the
global batch and against the port's own single-process step; the learner
binary at two ranks (rank 0 alone publishes, both ranks' params bitwise
equal, a SIGTERM drain over unequal feeds); the restore's agreement and
mismatch; and `k8s/learner-multihost.yaml` through the port's parser and
mesh checks. Every spawn has a join timeout, so a hang fails its test."""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.ops import ppo as jppo
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, parse_config, refuse_unported
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.clip_adam import ClipAdam
from dotaclient_tpu_torch.ops.flops import aggregate_peak_flops
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.dist import Dist, init_distributed
from dotaclient_tpu_torch.parallel.mesh import resolve_mesh
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.transport.params import load_named, named_params
from test_torch_learner import frames_for
from test_torch_train import GRAD_TOL, METRIC_TOL, PARAM_LR, _assert_tree_close, _jax_perms
from torch_multihost_worker import B, POL, STEP_CASES, T, step_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
MANIFEST = os.path.join(REPO, "k8s", "learner-multihost.yaml")
JOIN_S = 90  # each spawn's join timeout
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(job: str, out: str, world: int = WORLD) -> None:
    """Run `world` ranks of `job` and join them within JOIN_S; a rank that
    fails or hangs fails the test (every rank is killed first)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, WORKER, job, str(r), str(world), str(port), out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {job}: rc {p.returncode}\n{log[-3000:]}"


def _jcfg(ppo: dict) -> JLearnerConfig:
    return JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**POL, aux_heads=True), ppo=JPPOConfig(**ppo))


def _uneven(jb):
    """Rank 0's rows (the first B/2) keep one real step each; rank 1's keep
    all of theirs: a mean over each rank's own steps is not the global one."""
    mask = jb.mask.copy()
    mask[: B // 2, 1:] = 0.0
    mask[B // 2 :] = 1.0
    return jb._replace(mask=mask, rewards=jb.rewards * mask, dones=jb.dones * mask)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both ranks' results of every STEP_CASES case, with the JAX start
    params and the global batches they stepped on."""
    out = str(tmp_path_factory.mktemp("mh_steps"))
    params = JP.init_params(_jcfg({}).policy, jax.random.PRNGKey(7))
    named = flatten_params(params)
    inp = {"param_names": np.array([n for n, _ in named])}
    inp.update({f"param/{n}": a for n, a in named})
    batches, perms = {}, {}
    for i, (case, ppo, _) in enumerate(STEP_CASES):
        jb = _uneven(jts.make_train_batch(_jcfg(ppo), 30 + i))
        batches[case] = jb
        leaves, _ = tbatch.tree_flatten(jb)
        inp.update({f"{case}/batch/{k}": np.asarray(x) for k, x in enumerate(leaves)})
        if ppo.get("epochs", 1) > 1:
            perms[case] = [np.array(p) for p in _jax_perms(_jcfg(ppo), 0)]
            inp.update({f"{case}/perm/{e}": p for e, p in enumerate(perms[case])})
    np.savez(os.path.join(out, "input.npz"), **inp)
    _spawn("steps", out)
    ranks = [dict(np.load(os.path.join(out, f"steps_{r}.npz"))) for r in range(WORLD)]
    return dict(params=params, named=named, batches=batches, perms=perms, ranks=ranks)


def _case(res, case, kind):
    return {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith(f"{case}/{kind}/")}


def _port_single(steps, case, batch=None):
    """The port's single-process step at the global batch from the same
    params: (metrics, params, first update's gradients)."""
    ppo = dict(next(c for c in STEP_CASES if c[0] == case)[1])
    tcfg = step_config(ppo)
    state = ts.init_train_state(tcfg, "cpu")
    load_named(state.net, steps["named"])
    seen = []
    apply = ClipAdam.apply

    def recording_apply(self, params, grads, opt_state):
        seen.append({n: g.detach().clone().numpy() for n, g in grads.items()})
        return apply(self, params, grads, opt_state)

    ClipAdam.apply = recording_apply
    try:
        args = (steps["perms"][case],) if case in steps["perms"] else ()
        jb = steps["batches"][case] if batch is None else batch
        state, metrics = ts.build_train_step(tcfg, "cpu")(state, tbatch.as_tensors(jb, "cpu"), *args)
    finally:
        ClipAdam.apply = apply
    return {k: v.numpy() for k, v in metrics.items()}, dict(named_params(state.net)), seen[0]


@pytest.mark.parametrize("case", ["single", "reuse", "reuse_kl"])
def test_two_ranks_match_jax_at_the_global_batch(steps, case):
    """Each rank steps on its B/2 rows (rank 0's mostly padding); the
    all-reduced gradient, every metric and the params equal the JAX step at
    the global batch B on one device, within test_torch_train's f32 bounds."""
    ppo = dict(next(c for c in STEP_CASES if c[0] == case)[1])
    jcfg = _jcfg(ppo)
    jb = jax.tree.map(jnp.asarray, steps["batches"][case])
    apply = JP.PolicyNet(jcfg.policy).apply
    step, _, _ = jts.build_train_step(jcfg, jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))
    jstate, jm = step(jts.init_train_state(jcfg, jax.random.PRNGKey(7)), jb)
    if ppo.get("epochs", 1) == 1:
        jgrads = jax.grad(lambda p: jppo.ppo_loss(p, apply, jb, jcfg.ppo)[0])(steps["params"])
        rtol, _ = GRAD_TOL["float32"]
        for res in steps["ranks"]:
            _assert_tree_close(list(_case(res, case, "grad").items()), flatten_params(jgrads), rtol, f"{case} grad")
    updates = int(float(jm.get("ppo_updates_done", 1.0)))
    for r, res in enumerate(steps["ranks"]):
        metrics = _case(res, case, "metric")
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=METRIC_TOL["float32"],
                                       atol=METRIC_TOL["float32"], err_msg=f"rank {r} {case} {k}")
        assert int(res[f"{case}/updates"]) == updates
        for n, a in flatten_params(jstate.params):
            err = np.abs(_case(res, case, "param")[n] - a).max()
            assert err <= PARAM_LR["float32"] * JPPOConfig().lr * updates, f"rank {r} {case} {n}: {err}"
    if case == "reuse_kl":
        assert updates == 1 and float(jm["ppo_kl_stopped"]) == 1.0


# Two ranks against the port's own single-process step: the same
# arithmetic but for the order of f32 sums (each rank sums its rows, then
# the ranks' sums add; the advantage moments go through float64) and the
# one-pass variance. Gradients and metrics agree to 2e-6 of each leaf's
# largest value (measured ≤ 4e-7); params to 2e-2·lr per update, as
# test_torch_train's params (Adam's step amplifies the last bits of a
# gradient near eps).
PORT_TOL = 2e-6


@pytest.mark.parametrize("case", ["single", "reuse", "reuse_kl", "padding"])
def test_two_ranks_match_the_single_process_step(steps, case):
    """Both ranks end bitwise equal; against the single-process step at the
    global batch (for "padding", rank 0's rows alone: rank 1's share of
    padding rows adds nothing), within reduction order."""
    a, b = steps["ranks"]
    for k in a:
        if f"{case}/" in k:
            assert np.array_equal(a[k], b[k]), f"{k} differs between the ranks"
    batch = None
    if case == "padding":
        batch = tbatch.tree_map(lambda x: x[: B // 2], steps["batches"][case])
    metrics, params, grads = _port_single(steps, case, batch)
    updates = int(a[f"{case}/updates"])
    assert updates == int(metrics.get("ppo_updates_done", 1))
    for k, v in _case(a, case, "metric").items():
        np.testing.assert_allclose(v, metrics[k], rtol=PORT_TOL, atol=PORT_TOL, err_msg=f"{case} {k}")
    _assert_tree_close(list(_case(a, case, "grad").items()), grads.items(), PORT_TOL, f"{case} grad")
    for n, p in params.items():
        err = np.abs(_case(a, case, "param")[n] - p).max()
        assert err <= PARAM_LR["float32"] * JPPOConfig().lr * updates, f"{case} {n}: {err}"


# ------------------------------------------------------------------ binary


def _frames(n_batches: int, seed0: int) -> dict:
    cfg = LearnerConfig(batch_size=B // WORLD, seq_len=T, policy=PolicyConfig(**POL))
    return {f"f{i}": np.frombuffer(f, np.uint8) for i, f in enumerate(frames_for(cfg, n_batches, seed0=seed0))}


def _binary(out: str, argvs, frames) -> list:
    for r in range(WORLD):
        with open(os.path.join(out, f"argv_{r}.json"), "w") as f:
            json.dump(argvs[r], f)
        np.savez(os.path.join(out, f"frames_{r}.npz"), **frames[r])
    _spawn("binary", out)
    return [json.load(open(os.path.join(out, f"binary_{r}.json"))) for r in range(WORLD)]


def _flags(tmp, rank, steps=0, ckpt=None, remote=None, extra=()):
    flags = ["--platform", "cpu", "--batch_size", str(B), "--seq_len", str(T), "--mesh_shape", "dp=-1",
             "--policy.unit_embed_dim", "16", "--policy.lstm_hidden", "16", "--policy.mlp_hidden", "16",
             "--policy.dtype", "float32", "--train_steps", str(steps), "--metrics_every", "1",
             "--log_dir", os.path.join(tmp, f"logs_{rank}_{steps}")]
    if ckpt is not None:
        flags += ["--checkpoint_dir", ckpt, "--checkpoint_every", "2", "--ckpt.full_state", "true"]
    if remote is not None:
        flags += ["--checkpoint_remote_dir", remote]
    return flags + list(extra)


def _params(out, rank):
    return dict(np.load(os.path.join(out, f"params_{rank}.npz")))


def _first_window(tmp, rank, steps):
    with open(os.path.join(tmp, f"logs_{rank}_{steps}", "metrics.jsonl")) as f:
        return json.loads(f.readline())


def test_the_binary_at_two_ranks_then_its_restores(tmp_path):
    """learner.main with --multihost at two ranks, per-rank mem:// brokers
    (mem:// cannot span processes; production shares one tcp:// broker):
    3 steps, checkpoints every 2 steps with a mirror each. Rank 0 alone
    publishes and pushes its mirror; both ranks' params are bitwise equal.
    Then a restart with rank 1's disk empty pulls rank 0's mirror: both
    resume at step 2, and both bump the version counter to the global
    published high-water mark (3, on rank 0's disk only). A rank with no
    checkpoint and no mirror makes both ranks refuse to start."""
    t = str(tmp_path)
    ck = [os.path.join(t, f"ck{r}") for r in range(WORLD)]
    mirror = [os.path.join(t, f"mirror{r}") for r in range(WORLD)]
    res = _binary(t, [_flags(t, r, 3, ck[r], mirror[r]) for r in range(WORLD)], [_frames(3, 10 * r) for r in range(WORLD)])
    assert [r["version"] for r in res] == [3, 3]
    assert res[0]["weights"] and res[0]["published"] >= 1
    assert not res[1]["weights"] and res[1]["published"] == 0
    p0, p1 = _params(t, 0), _params(t, 1)
    assert all(np.array_equal(p0[n], p1[n]) for n in p0)
    assert "2" in os.listdir(mirror[0]) and not (os.path.exists(mirror[1]) and os.listdir(mirror[1]))

    empty = os.path.join(t, "empty")
    res = _binary(t, [_flags(t, 0, 1, ck[0], mirror[0]), _flags(t, 1, 1, empty, mirror[0])],
                  [_frames(1, 50), _frames(1, 60)])
    assert [r["version"] for r in res] == [4, 4]  # resumed at 2, bumped to 3, one step
    for r in range(WORLD):
        first = _first_window(t, r, 1)
        assert first["resume_restored_step"] == 2.0 and first["resume_version_hwm_bump"] == 1.0
    p0, p1 = _params(t, 0), _params(t, 1)
    assert all(np.array_equal(p0[n], p1[n]) for n in p0)

    res = _binary(t, [_flags(t, 0, 1, ck[0]), _flags(t, 1, 1, os.path.join(t, "fresh"))],
                  [_frames(1, 70), _frames(1, 80)])
    for r in res:  # the un-bumped steps: rank 0's state holds 3 updates (its version counter read 4)
        assert "multihost restore mismatch" in r["error"] and "[3, 0]" in r["error"]


def test_a_sigterm_drain_over_unequal_feeds(tmp_path):
    """Rank 0's broker holds 3 batches, rank 1's one. After the first step
    rank 1 has nothing to train and waits; each rank SIGTERMs itself once
    its broker is empty. Rank 1's drain completes first and it takes its
    part of rank 0's last two steps with padding rows; both exit 0 at
    version 3 with bitwise equal params, and the env steps are each rank's
    own batches'."""
    t = str(tmp_path)
    drain = ["--ckpt.drain_on_sigterm", "true", "--ckpt.drain_budget_s", "60"]
    frames = [_frames(3, 0), _frames(1, 30)]
    res = _binary(t, [_flags(t, r, 0, os.path.join(t, f"ck{r}"), extra=drain) for r in range(WORLD)], frames)
    assert [r["version"] for r in res] == [3, 3]
    cfg = LearnerConfig(batch_size=B // WORLD, seq_len=T, policy=PolicyConfig(**POL))
    want = [sum(int(tbatch.make_train_batch(cfg, s).mask.sum()) for s in seeds) for seeds in ((0, 1, 2), (30,))]
    assert [r["env_steps"] for r in res] == want
    p0, p1 = _params(t, 0), _params(t, 1)
    assert all(np.array_equal(p0[n], p1[n]) for n in p0)
    assert all(os.path.isdir(os.path.join(t, f"ck{r}", "3")) for r in range(WORLD))  # the drain's save


# ------------------------------------------------------------------ in-process


def _manifest_args():
    import chip_smoke

    return chip_smoke.manifest_args(MANIFEST)


def test_the_multihost_manifest_parses_and_its_mesh_rules_hold():
    """k8s/learner-multihost.yaml's args pass the port's parser and refusal
    table; its dp=-1 resolves to the world size. A spec that does not cover
    the processes, names no dp axis or puts an axis of size > 1 ahead of
    it raises ValueError; tp and sp axes resolve over the world, dp-major;
    policy.tf_sp_axis passes the table; and the batch splits as the
    reference's rules say."""
    cfg = parse_config(LearnerConfig(), _manifest_args())
    refuse_unported(cfg)
    assert cfg.multihost and (cfg.coordinator, cfg.num_processes, cfg.process_id) == ("", -1, -1)
    assert resolve_mesh(cfg.mesh_shape, 2) == {"dp": 2} and resolve_mesh("tp=1,dp=-1", 4) == {"tp": 1, "dp": 4}
    for spec in ("dp=3", "dp=1", "dp=-1,tp=-1", "dp=x", "dp=2,tp=2", "sp=2,dp=1", "tp=-1"):
        with pytest.raises(ValueError):
            resolve_mesh(spec, 2)
    assert resolve_mesh("dp=-1,tp=2", 2) == {"dp": 1, "tp": 2} and resolve_mesh("dp=1,sp=2", 2) == {"dp": 1, "sp": 2}
    assert resolve_mesh("dp=2,sp=2", 4) == {"dp": 2, "sp": 2}
    sp = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, arch="transformer", tf_sp_axis="sp"))
    refuse_unported(sp)
    with pytest.raises(ValueError, match="tf_sp_axis='sp' names no axis of mesh"):
        ts.build_train_step(sp, "cpu", Dist(world=2))
    small = dataclasses.replace(cfg, batch_size=10)
    with pytest.raises(ValueError, match=r"batch_size=10 must be divisible by the mesh dp axis \(4\)"):
        ts.build_train_step(small, "cpu", Dist(world=4))
    with pytest.raises(ValueError, match=r"minibatch size 4 \(batch_size/minibatches\) must divide by the mesh dp"):
        ts.build_train_step(dataclasses.replace(cfg, batch_size=8, ppo=dataclasses.replace(cfg.ppo, minibatches=2)),
                            "cpu", Dist(world=8))


def test_rendezvous_flags_defer_to_torch_env(monkeypatch):
    """Unset --coordinator / --num_processes / --process_id read
    MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK; what neither gives is
    named. World 1 joins (over gloo on the CPU) and every collective is the
    identity."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = LearnerConfig(multihost=True)
    with pytest.raises(ValueError, match=r"no --coordinator .* no --num_processes .* no --process_id"):
        init_distributed(cfg, "cpu")
    with pytest.raises(ValueError, match="process_id=2 is not below num_processes=2"):
        init_distributed(dataclasses.replace(cfg, coordinator="h:1", num_processes=2, process_id=2), "cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    dist = init_distributed(cfg, "cpu")
    try:
        assert (dist.world, dist.rank, dist.is_primary) == (1, 0, True) and torch.distributed.is_initialized()
        t = torch.arange(3.0)
        dp = dist.group("dp")
        assert dp.size == 1 and dp.all_reduce_(t) is t and torch.equal(t, torch.arange(3.0))
        assert dist.host_all_gather(5) == [5.0]
        tree = (torch.ones(2, 3), None)
        assert dp.all_gather_rows(tree) is tree
    finally:
        dist.close()
    assert not torch.distributed.is_initialized()


VOTES = [
    ((tlearner._BATCH, tlearner._BATCH), tlearner._BATCH),
    ((tlearner._BATCH, tlearner._DONE), tlearner._BATCH),
    ((tlearner._BATCH, tlearner._IDLE), tlearner._IDLE),
    ((tlearner._DONE, tlearner._IDLE), tlearner._IDLE),
    ((tlearner._DONE, tlearner._DONE), tlearner._STOP),
    ((tlearner._BATCH, tlearner._STOP), tlearner._STOP),
    ((tlearner._IDLE, tlearner._IDLE), tlearner._IDLE),
]


@pytest.mark.parametrize("votes,decision", VOTES)
def test_the_ranks_step_vote(votes, decision):
    """The loop's agreement over every rank's vote: a step when some rank
    holds a batch and none is still waiting for one (a trained-out rank
    steps on padding rows), a stop when any rank stops or all are done."""

    class Votes(Dist):
        def host_all_gather(self, value):
            return [float(v) for v in votes]

    ln = tlearner.Learner.__new__(tlearner.Learner)
    ln.dist = Votes(world=len(votes))
    assert ln._agree(votes[0]) == decision


def test_aggregate_peak_flops_sums_the_ranks_peaks():
    assert aggregate_peak_flops([989.4e12, 989.4e12]) == 2 * 989.4e12
    assert aggregate_peak_flops([989.4e12, math.nan]) is None and aggregate_peak_flops([None]) is None
