"""Tensor and sequence parallelism over rank groups (parallel/mesh.py,
parallel/dist.py, ops/ring_attention.py, parallel/train_step.py) on the
CPU: real gloo ranks (tests/torch_model_parallel_worker.py) at two and four
processes, held against the JAX package in this process on its CPU
devices:

- ring and Ulysses attention (and Ulysses with kv_block) at sp=2 and sp=4,
  forward against the reference's `ring_causal_attention` /
  `ulysses_causal_attention` over a mesh and its `causal_attention`,
  gradients against `causal_attention`'s (the reference's own bounds);
- the transformer train step at dp=1,sp=2 and dp=2,sp=2, ring and Ulysses,
  remat off and on, two steps against the JAX single-device step of the
  global batch, every rank bitwise equal after every step;
- the LSTM step at dp=1,tp=2 and dp=2,tp=2, two single updates and a 2×2
  reuse step, against the JAX step within
  `test_dp_tp_mesh_matches_single_device`'s bounds; the sharded leaf names
  are the JAX `param_shardings`'; each rank holds 1/tp of those leaves and
  of their moments; at dp=1 the step is bitwise the port's one-process
  step;
- the build-time validation against the reference's errors.

Every spawn has a join timeout, so a hang fails its test."""

import dataclasses
import functools
import json
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
from dotaclient_tpu.ops import attention as JA
from dotaclient_tpu.ops import ring_attention as JRA
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.dist import Dist, _layout_groups
from dotaclient_tpu_torch.parallel.mesh import Layout, leaf_sharded, resolve_mesh
from dotaclient_tpu_torch.transport.params import host_named, load_named, state_tensors
from torch_model_parallel_worker import B, KV_BLOCK, POL, SP_CASES, T_LSTM, T_TF, TF, TP_CASES, sp_config, tp_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_model_parallel_worker.py")
JOIN_S = 90  # each spawn's join timeout
ATTN_SHAPE = (2, 16, 4, 8)  # B, T, N, Dh: 4 heads, so Ulysses runs at sp=4
MESHES = {  # world -> (attention, transformer step, LSTM step)
    2: (("attn", "dp=1,sp=2"), ("sp", "dp=1,sp=2"), ("tp", "dp=1,tp=2")),
    4: (("attn", "dp=1,sp=4"), ("sp", "dp=2,sp=2"), ("tp", "dp=2,tp=2")),
}
# the reference's own bounds (tests/test_attention.py, tests/test_transformer.py,
# tests/test_train_step.py test_dp_tp_mesh_matches_single_device)
FWD, GRAD = (1e-5, 1e-6), (1e-4, 1e-5)
METRIC = (1e-4, 1e-5)
PARAM = (1e-3, 1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, out: str, world: int):
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, WORKER, job, str(r), str(world), out], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def join(procs, job: str) -> None:
    """Join every rank within JOIN_S; a rank that fails or hangs fails the
    test (every rank is killed first)."""
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


def _jcfg_tf():
    return JLearnerConfig(batch_size=B, seq_len=T_TF, policy=JPolicyConfig(**TF))


def _jcfg_lstm(ppo: dict):
    return JLearnerConfig(batch_size=B, seq_len=T_LSTM, policy=JPolicyConfig(**POL), ppo=JPPOConfig(**ppo))


def _jax_perms(jcfg, step: int):
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), step)
    return [np.asarray(jax.random.permutation(k, jcfg.batch_size)) for k in jax.random.split(rng, jcfg.ppo.epochs)]


@functools.lru_cache(maxsize=1)
def inputs():
    """Everything the ranks and the references start from (seeded)."""
    r = np.random.RandomState(0)
    Bq, T, N, Dh = ATTN_SHAPE
    inp = {k: r.randn(Bq, T, N, Dh).astype(np.float32) for k in ("q", "k", "v", "cot")}
    inp["pos"] = np.tile(np.arange(T, dtype=np.int32), (Bq, 1))
    tf_params = jax.jit(lambda key: JP.init_params(_jcfg_tf().policy, key))(jax.random.PRNGKey(3))
    lstm_params = JP.init_params(_jcfg_lstm({}).policy, jax.random.PRNGKey(4))
    for tag, params in (("tf", tf_params), ("lstm", lstm_params)):
        named = flatten_params(params)
        inp[f"{tag}_names"] = np.array([n for n, _ in named])
        inp.update({f"{tag}_param/{n}": a for n, a in named})
    batches = {}
    for i in range(2):
        batches[f"tf_batch{i}"] = jts.make_train_batch(_jcfg_tf(), 40 + i)
    for case, ppo, n_steps in TP_CASES:
        for i in range(n_steps):
            batches[f"{case}_batch{i}"] = jts.make_train_batch(_jcfg_lstm(ppo), 50 + i)
        if ppo.get("epochs", 1) > 1:
            inp.update({f"{case}_perm/{e}": p for e, p in enumerate(_jax_perms(_jcfg_lstm(ppo), 0))})
    for tag, jb in batches.items():
        inp.update({f"{tag}/{k}": np.asarray(x) for k, x in enumerate(tbatch.tree_flatten(jb)[0])})
    return inp, tf_params, lstm_params, batches


@pytest.fixture(scope="module")
def jref():
    """The JAX side on one CPU device: the steps at the global batch, the
    sharded names at tp=2, causal attention and its gradients."""
    inp, tf_params, lstm_params, batches = inputs()
    out = {}
    mesh1 = jmesh.make_mesh("dp=1", devices=jax.devices()[:1])
    jcfg = _jcfg_tf()
    step = jts.build_train_step(jcfg, mesh1)[0]
    state = jts.init_train_state(jcfg, jax.random.PRNGKey(0))._replace(params=tf_params)
    state = state._replace(opt_state=jts.make_optimizer(jcfg).init(tf_params))
    for i in range(2):
        state, m = step(state, jax.tree.map(jnp.asarray, batches[f"tf_batch{i}"]))
        out[f"tf/{i}"] = ({k: float(v) for k, v in m.items()}, dict(flatten_params(state.params)))
    for case, ppo, n_steps in TP_CASES:
        jcfg = _jcfg_lstm(ppo)
        step = jts.build_train_step(jcfg, mesh1)[0]
        state = jts.init_train_state(jcfg, jax.random.PRNGKey(0))._replace(params=lstm_params)
        state = state._replace(opt_state=jts.make_optimizer(jcfg).init(lstm_params))
        for i in range(n_steps):
            state, m = step(state, jax.tree.map(jnp.asarray, batches[f"{case}_batch{i}"]))
            out[f"{case}/{i}"] = ({k: float(v) for k, v in m.items()}, dict(flatten_params(state.params)))
    shardings = jmesh.param_shardings(jmesh.make_mesh("dp=4,tp=2"), lstm_params)
    marks = jax.tree.map(lambda leaf, sh: np.float32(tuple(sh.spec)[-1:] == ("tp",)), lstm_params, shardings)
    out["sharded"] = {n for n, a in flatten_params(marks) if a}
    q, k, v, cot, pos = (jnp.asarray(inp[x]) for x in ("q", "k", "v", "cot", "pos"))
    out["attn/out"] = np.asarray(JA.causal_attention(q, k, v, pos, pos))
    grads = jax.grad(lambda q, k, v: jnp.sum(JA.causal_attention(q, k, v, pos, pos) * cot), argnums=(0, 1, 2))(q, k, v)
    out["attn/grad"] = dict(zip("qkv", (np.asarray(g) for g in grads)))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' ranks, started at once; the JAX side compiles while
    they run. world -> (out dir, processes)."""
    inp = inputs()[0]
    runs = {}
    for world, meshes in MESHES.items():
        out = str(tmp_path_factory.mktemp(f"mp_{world}"))
        np.savez(os.path.join(out, "input.npz"), **inp)
        with open(os.path.join(out, "meshes.json"), "w") as f:
            json.dump([(name, mesh, _free_port()) for name, mesh in meshes], f)
        runs[world] = (out, spawn("steps", out, world))
    return runs


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, spawned):
    """(world, [each rank's results]), and the reference's sp attention over
    a mesh of `world` CPU devices in jref."""
    world = request.param
    out, procs = spawned[world]
    try:
        ref = request.getfixturevalue("jref")
        inp = inputs()[0]
        mesh = jmesh.make_mesh(f"sp={world}", devices=jax.devices()[:world])
        q, k, v, pos = (jnp.asarray(inp[x]) for x in ("q", "k", "v", "pos"))
        ref[f"ring/{world}"] = np.asarray(JRA.ring_causal_attention(q, k, v, pos, pos, mesh))
        ref[f"ulysses/{world}"] = np.asarray(JRA.ulysses_causal_attention(q, k, v, pos, pos, mesh))
        ref[f"ulysses_block/{world}"] = np.asarray(JRA.ulysses_causal_attention(q, k, v, pos, pos, mesh,
                                                                                kv_block=KV_BLOCK))
    finally:
        join(procs, f"steps at world {world}")
    return world, [dict(np.load(os.path.join(out, f"steps_{r}.npz"))) for r in range(world)]


def _sub(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _whole_time(ranks, world, key):
    """The attention shards of the sp ranks concatenated along time (at
    world 4 the attention mesh is dp=1,sp=4: every rank is an sp rank)."""
    return np.concatenate([ranks[r][f"attn/{key}"] for r in range(world)], axis=1)


@pytest.mark.parametrize("mode", ["ring", "ulysses", "ulysses_block"])
def test_sequence_parallel_attention_forward_matches_jax(ranks, jref, mode):
    world, res = ranks
    got = _whole_time(res, world, f"{mode}/out")
    np.testing.assert_allclose(got, jref[f"{mode}/{world}"], rtol=FWD[0], atol=FWD[1])
    np.testing.assert_allclose(got, jref["attn/out"], rtol=FWD[0], atol=FWD[1])


@pytest.mark.parametrize("mode", ["ring", "ulysses", "ulysses_block"])
def test_sequence_parallel_attention_gradients_match_jax(ranks, jref, mode):
    """Each rank backpropagates its own shard's sum(out · cot); the ring's
    and the all-to-alls' backward bring every other rank's part home."""
    world, res = ranks
    for x in "qkv":
        np.testing.assert_allclose(_whole_time(res, world, f"{mode}/grad_{x}"), jref["attn/grad"][x], rtol=GRAD[0],
                                   atol=GRAD[1], err_msg=f"{mode} d{x}")


def _compare_step(metrics, params, ref, what):
    jm, jp = ref
    assert set(metrics) == set(jm), what
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=METRIC[0], atol=METRIC[1], err_msg=f"{what} {k}")
    assert set(params) == set(jp), what
    for n, a in jp.items():
        np.testing.assert_allclose(params[n], a, rtol=PARAM[0], atol=PARAM[1], err_msg=f"{what} {n}")


@pytest.mark.parametrize("mode,remat", SP_CASES, ids=[f"{m}-remat{int(r)}" for m, r in SP_CASES])
def test_sequence_parallel_step_matches_jax_at_the_global_batch(ranks, jref, mode, remat):
    """Two steps of the transformer family with its time axis split over
    sp=2 (and dp=2 at world 4): metrics and params against the JAX step of
    the global batch on one device; every rank ends each step bitwise
    equal."""
    world, res = ranks
    for i in range(2):
        tag = f"sp/{mode}_{int(remat)}/{i}/"
        for r in range(world):
            _compare_step(_sub(_sub(res[r], tag), "metric/"), _sub(_sub(res[r], tag), "param/"), jref[f"tf/{i}"],
                          f"world {world} rank {r} step {i}")
        for r in range(1, world):
            for k, v in _sub(res[0], tag).items():
                assert np.array_equal(v, res[r][tag + k]), f"{tag}{k}: rank {r} differs from rank 0"


@pytest.mark.parametrize("case", [c[0] for c in TP_CASES])
def test_tensor_parallel_step_matches_jax_at_the_global_batch(ranks, jref, case):
    """The LSTM step with its sharded leaves split over tp=2 (and dp=2 at
    world 4): metrics and the whole params (gathered) against the JAX step;
    the recurrence runs on the gathered W_h, the norm is the whole
    gradient's."""
    world, res = ranks
    n_steps = next(c[2] for c in TP_CASES if c[0] == case)
    for i in range(n_steps):
        tag = f"tp/{case}/{i}/"
        for r in range(world):
            state = _sub(_sub(res[r], tag), "state/")
            params = {n: a for n, a in state.items() if n.startswith("params/")}
            _compare_step(_sub(_sub(res[r], tag), "metric/"), params, jref[f"{case}/{i}"], f"world {world} rank {r}")
        for r in range(1, world):
            for k, v in _sub(res[0], tag).items():
                assert np.array_equal(v, res[r][tag + k]), f"{tag}{k}: rank {r} differs from rank 0"


def test_tensor_parallel_shards_the_reference_leaves(ranks, jref):
    """The sharded names are the JAX param_shardings' at tp=2; each rank
    holds half of each sharded leaf and of its moments, and every other
    leaf whole."""
    world, res = ranks
    whole = {n: int(np.prod(a.shape)) for n, a in _sub(res[0], "tp/single/0/state/").items()}
    for r in range(world):
        sharded = {str(n) for n in res[r]["tp/single/sharded"]}
        assert sharded == jref["sharded"] and sharded
        held = {n: int(v) for n, v in _sub(res[r], "tp/single/held/").items()}
        for n, size in held.items():
            base = n[3:] if n.startswith("mu/") else n
            assert size == (whole[n] // 2 if base in sharded else whole[n]), n
        assert sum(held.values()) < sum(whole[n] for n in held)


# dp=2: the port's own arithmetic but for the order of the f32 sums over
# the dp group (as tests/test_torch_multihost.py's PORT_TOL: mu to 2e-6 of
# each leaf's largest value, nu twice that, params to 2e-2·lr per update).
PORT_TOL, PARAM_LR = 2e-6, 2e-2


def test_tensor_parallel_against_the_one_process_step(ranks):
    """At dp=1 each tp rank computes the whole step on the same rows: the
    gathered params and moments equal the port's one-process step bit for
    bit (the norm is the whole gradient's and Adam is elementwise). At
    dp=2 they agree within the order of the dp sums."""
    world, res = ranks
    inp, _, _, batches = inputs()
    for case, ppo, n_steps in TP_CASES:
        cfg = tp_config(ppo)
        state = ts.init_train_state(cfg, "cpu")
        load_named(state.net, [(str(n), inp[f"lstm_param/{n}"]) for n in inp["lstm_names"]])
        step = ts.build_train_step(cfg, "cpu")
        for i in range(n_steps):
            args = [[inp[f"{case}_perm/{e}"] for e in range(cfg.ppo.epochs)]] if cfg.ppo.epochs > 1 else []
            state, _ = step(state, tbatch.as_tensors(batches[f"{case}_batch{i}"], "cpu"), *args)
            for n, a in host_named(state_tensors(state.net, state.opt_state)):
                got = res[0][f"tp/{case}/{i}/state/{n}"]
                if world == 2:
                    assert np.array_equal(a, got), f"{case} step {i} {n}"
                elif n.startswith("params/"):
                    assert np.abs(a - got).max() <= PARAM_LR * cfg.ppo.lr * (i + 1), f"{case} step {i} {n}"
                else:  # nu ~ g²: twice the gradient's relative error, as test_torch_train's moments
                    tol = PORT_TOL * (2 if n.startswith("nu/") else 1)
                    assert np.abs(a - got).max() <= tol * max(np.abs(a).max(), 1e-30), f"{case} {i} {n}"


# ------------------------------------------------------------ validation


def _dist(axes, rank=0):
    """A Dist laid over `axes` whose groups never run a collective."""
    layout = Layout.of(axes)
    return Dist(layout.world, rank, axes=axes, groups=_layout_groups(layout, rank, False, lambda ranks: None))


def _tf(**kw):
    jpol = dict(TF, tf_sp_axis="sp")
    jpol.update(kw.pop("policy", {}))
    return JLearnerConfig(batch_size=B, seq_len=kw.pop("seq_len", T_TF), policy=JPolicyConfig(**jpol), **kw)


def _port(jcfg):
    cfg = sp_config()
    return dataclasses.replace(cfg, seq_len=jcfg.seq_len, policy=dataclasses.replace(
        cfg.policy, **{f.name: getattr(jcfg.policy, f.name) for f in dataclasses.fields(cfg.policy)}))


VALIDATION = [
    ("indivisible_frames", dict(seq_len=8), "seq_len"),
    ("ulysses_heads", dict(policy=dict(tf_sp_mode="ulysses")), "tf_heads"),
    ("unknown_mode", dict(policy=dict(tf_sp_mode="bogus")), "tf_sp_mode"),
    ("axis_not_in_mesh", dict(policy=dict(tf_sp_axis="sq")), "names no axis"),
    ("lstm_ignores_the_axis", dict(policy=dict(arch="lstm")), None),
]


@pytest.mark.parametrize("jkw,match", [v[1:] for v in VALIDATION], ids=[v[0] for v in VALIDATION])
def test_build_time_validation_matches_the_reference(jkw, match):
    """At dp=2,sp=4 the builders raise what the reference's _build_core
    raises, of the same type (the JAX side over 8 CPU devices), and the
    LSTM family builds with tf_sp_axis set."""
    jcfg = _tf(**jkw)
    mesh = jmesh.make_mesh("dp=2,sp=4")
    cfg, dist = _port(jcfg), _dist({"dp": 2, "sp": 4})
    if match is None:
        jts.build_train_step(jcfg, mesh)
        ts.build_train_step(cfg, "cpu", dist)
        return
    with pytest.raises(ValueError, match=match):
        jts.build_train_step(jcfg, mesh)
    with pytest.raises(ValueError, match=match):
        ts.build_train_step(cfg, "cpu", dist)


def test_fused_builders_and_the_mesh_rules_refuse_as_the_reference():
    """The fused builders refuse sp (the learner takes the tree path); the
    multi-process mesh rules raise ValueError; tp / sp resolve dp-major."""
    jcfg = _tf()
    cfg, dist = _port(jcfg), _dist({"dp": 2, "sp": 4})
    for jbuild, build in ((jts.build_fused_train_step, ts.build_fused_train_step),
                          (jts.build_single_train_step, ts.build_single_train_step)):
        with pytest.raises(ValueError, match="incompatible with sequence parallelism"):
            jbuild(jcfg, jmesh.make_mesh("dp=2,sp=4"))
        with pytest.raises(ValueError, match="incompatible with sequence parallelism"):
            build(cfg, "cpu", dist)
    for spec in ("sp=2,dp=1", "tp=-1"):
        with pytest.raises(ValueError, match="multihost needs"):
            resolve_mesh(spec, 2)
    layout = Layout.of(resolve_mesh("dp=2,sp=2,tp=2", 8))
    assert [layout.coords(r) for r in (0, 1, 2, 5)] == [dict(dp=0, sp=0, tp=0), dict(dp=0, sp=0, tp=1),
                                                       dict(dp=0, sp=1, tp=0), dict(dp=1, sp=0, tp=1)]
    assert layout.groups(("dp",)) == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert layout.groups(("sp", "tp")) == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert layout.groups(("dp", "sp")) == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert not leaf_sharded((64,), 2) and leaf_sharded((16, 64), 2) and not leaf_sharded((16, 64), 3) and not leaf_sharded((4, 64), 4)
