"""The port's LSTM policy against the JAX reference: weights carried over
the flax-named leaves (`flatten_params` → `load_named`), then the single
step and the teacher-forced unroll compared head by head, in f32 and
bf16, with and without the aux heads. Also the actor step entry points
and the port's import boundary."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.parallel.train_step import make_train_batch as j_make_train_batch
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.runtime.actor import make_batched_key_actor_step, make_key_actor_step
from dotaclient_tpu_torch.transport.params import load_named, named_params

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)
B, T = 3, 4
# f32: same products, sums in another order: a few ulp. bf16: the Dense
# layers round to bf16 at the same points in both frameworks, but a
# last-ulp difference of a matmul's f32 sum can flip one bf16 rounding
# (2^-8 relative) of an activation; the f32 heads see at most that.
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype, aux):
    kw = dict(SMALL, dtype=dtype, aux_heads=aux)
    return JPolicyConfig(**kw), PolicyConfig(**kw)


@pytest.fixture(scope="module", params=[("float32", False), ("bfloat16", False), ("float32", True), ("bfloat16", True)],
                ids=lambda p: f"{p[0]}-{'aux' if p[1] else 'noaux'}")
def pair(request):
    """(dtype, jax cfg, jax params, torch cfg, torch net, numpy obs [B, T+1], numpy carry)."""
    dtype, aux = request.param
    jcfg, tcfg = _cfgs(dtype, aux)
    params = JP.init_params(jcfg, jax.random.PRNGKey(0))
    net = load_named(P.PolicyNet(tcfg, device="cpu"), flatten_params(params))
    obs = j_make_train_batch(JLearnerConfig(batch_size=B, seq_len=T, policy=jcfg), 7).obs
    r = np.random.RandomState(8)
    carry = tuple((0.5 * r.randn(B, SMALL["lstm_hidden"])).astype(np.float32) for _ in range(2))
    return dtype, jcfg, params, tcfg, net, obs, carry


def _close(ref, out, atol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32), rtol=1e-6, atol=atol)


def _compare_outputs(jout, tout, atol):
    for ref, out in zip(jout.dist, tout.dist):
        _close(ref, out, atol)
    _close(jout.value, tout.value, atol)
    assert (jout.aux is None) == (tout.aux is None)
    if jout.aux is not None:
        for ref, out in zip(jout.aux, tout.aux):
            _close(ref, out, atol)


def test_unroll_matches_jax(pair):
    dtype, jcfg, params, tcfg, net, obs, carry = pair
    (jc, jh), jout = JP.PolicyNet(jcfg).apply(params, tuple(map(jnp.asarray, carry)), jax.tree.map(jnp.asarray, obs), unroll=True)
    with torch.no_grad():
        (tc, th), tout = net(as_tensors(carry, "cpu"), as_tensors(obs, "cpu"), unroll=True)
    assert tuple(tout.value.shape) == (B, T + 1)
    _compare_outputs(jout, tout, ATOL[dtype])
    _close(jc, tc, ATOL[dtype])
    _close(jh, th, ATOL[dtype])


def test_step_matches_jax(pair):
    dtype, jcfg, params, tcfg, net, obs, carry = pair
    obs0 = jax.tree.map(lambda x: x[:, 0], obs)
    (jc, jh), jout = JP.PolicyNet(jcfg).apply(params, tuple(map(jnp.asarray, carry)), jax.tree.map(jnp.asarray, obs0))
    with torch.no_grad():
        (tc, th), tout = net(as_tensors(carry, "cpu"), as_tensors(obs0, "cpu"))
    assert tuple(tout.value.shape) == (B,)
    _compare_outputs(jout, tout, ATOL[dtype])
    _close(jc, tc, ATOL[dtype])
    _close(jh, th, ATOL[dtype])


# The single step rounds z = x_proj + h @ W_h to the compute dtype, the
# unroll keeps it f32 (as in the reference), so in bf16 the two agree to
# the reference's own step-vs-unroll tolerance (tests/test_policy.py).
STEP_VS_UNROLL = {"float32": 1e-5, "bfloat16": 2e-3}


def test_step_equals_unroll(pair):
    dtype, _, _, tcfg, net, obs, carry = pair
    tobs, state = as_tensors(obs, "cpu"), as_tensors(carry, "cpu")
    with torch.no_grad():
        final, out = net(state, tobs, unroll=True)
        values, type_logp = [], []
        for t in range(T + 1):
            state, o = net(state, F.Observation(*(x[:, t] for x in tobs)))
            values.append(o.value)
            type_logp.append(o.dist.type_logp)
    tol = STEP_VS_UNROLL[dtype]
    torch.testing.assert_close(out.value, torch.stack(values, 1), rtol=tol, atol=tol)
    torch.testing.assert_close(out.dist.type_logp, torch.stack(type_logp, 1), rtol=tol, atol=tol)
    torch.testing.assert_close(final[0], state[0], rtol=tol, atol=tol)


def test_named_params_round_trip_in_flax_order():
    jcfg, tcfg = _cfgs("float32", True)
    named = flatten_params(JP.init_params(jcfg, jax.random.PRNGKey(3)))
    net = load_named(P.PolicyNet(tcfg, device="cpu"), named)
    back = named_params(net)
    assert [n for n, _ in back] == [n for n, _ in named]
    assert "params/core/lstm/w_h" in dict(back) and "params/core/unit_mlp1/kernel" in dict(back)
    for (_, a), (_, b) in zip(named, back):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_load_named_rejects_mismatches():
    jcfg, tcfg = _cfgs("float32", False)
    named = flatten_params(JP.init_params(jcfg, jax.random.PRNGKey(0)))
    net = P.PolicyNet(tcfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_named(net, named[1:])
    with pytest.raises(ValueError, match="unexpected"):
        load_named(net, named + [("params/core/extra/kernel", np.zeros(1, np.float32))])
    bad = [(n, a if n != "params/core/lstm/w_h" else a[:, :4]) for n, a in named]
    with pytest.raises(ValueError, match="shape mismatch"):
        load_named(net, bad)


def test_init_params_layout_and_scale():
    """Same names and shapes as the flax init; kernels drawn from flax's
    lecun_normal (truncated at ±2σ), biases zero, deterministic in the
    generator's seed."""
    jcfg, tcfg = _cfgs("bfloat16", True)
    jshapes = {n: a.shape for n, a in flatten_params(JP.init_params(jcfg, jax.random.PRNGKey(0)))}
    net = P.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    named = dict(named_params(net))
    assert {n: a.shape for n, a in named.items()} == jshapes
    for n, a in named.items():
        if n.endswith("bias"):
            assert not a.any()
        else:
            std = 1.0 / np.sqrt(a.shape[0]) / 0.87962566103423978
            assert np.abs(a).max() <= 2 * std + 1e-6
    w = named["params/core/lstm/w_h"]
    assert abs(w.std() * np.sqrt(w.shape[0]) - 1.0) < 0.05
    again = dict(named_params(P.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")))
    assert all(np.array_equal(again[n], named[n]) for n in named)


def test_state_helpers_and_device_rule(monkeypatch):
    cfg = PolicyConfig(**SMALL)
    c, h = P.initial_state(cfg, (5,), "cpu")
    assert c.shape == h.shape == (5, 32) and c.dtype == torch.float32 and not c.any()
    assert P.wire_state(cfg, (c, h)) == (c, h)
    assert P.reset_between_chunks(cfg, (c, h)) == (c, h)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.PolicyNet(cfg)
    with pytest.raises(ValueError, match="unknown policy family"):
        P.PolicyNet(dataclasses.replace(cfg, arch="gru"), device="cpu")


def test_batched_actor_step_rows_match_single_step():
    """Each row of a batched key-step tick is bitwise the B=1 key step of
    that row with that row's key (the reference's lax.map contract), also
    when the row sits among other neighbours; every key advances as its
    own split; sampling respects the masks."""
    cfg = PolicyConfig(**SMALL)
    net = P.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    M = 6
    obs_seq = as_tensors(j_make_train_batch(JLearnerConfig(batch_size=M, seq_len=3, policy=JPolicyConfig(**SMALL)), 2).obs, "cpu")
    step, single = make_batched_key_actor_step(cfg), make_key_actor_step(cfg)
    keys = np.stack([np.array([0, 100 + i], np.uint32) for i in range(M)])
    state = P.initial_state(cfg, (M,), "cpu")
    row = lambda tree, i: tuple(x[i : i + 1].clone() for x in tree)
    for t in range(4):
        # the last tick reverses the rows: every row gets new neighbours and a new slot
        order = list(range(M)) if t < 3 else list(reversed(range(M)))
        obs = F.Observation(*(x[:, min(t, 2)][order] for x in obs_seq))
        prev = tuple(s[order] for s in state)
        tick_keys = keys[order]
        new, action, logp, value, keys2 = step(net, prev, obs, tick_keys)
        assert (logp <= 0).all() and torch.isfinite(value).all()
        rows = torch.arange(M)
        assert obs.action_mask[rows, action.type].all()
        targeted = (action.type == F.ACT_ATTACK) | (action.type == F.ACT_CAST)
        assert obs.target_mask[rows, action.target][targeted].all()
        for j in range(M):
            (c1, h1), a1, lp1, v1, k1 = single(net, row(prev, j), F.Observation(*row(obs, j)), tick_keys[j])
            assert c1.shape == (1, 32) and a1.type.shape == lp1.shape == v1.shape == (1,)
            for x1, xb in zip((c1, h1, *a1, lp1, v1), (new[0], new[1], *action, logp, value)):
                assert torch.equal(x1, xb[j : j + 1])
            assert np.array_equal(k1, keys2[j]) and not np.array_equal(k1, tick_keys[j])  # each advanced its own key
        inverse = [order.index(i) for i in range(M)]
        state = tuple(s[inverse] for s in new)
        keys = keys2[inverse]
    with pytest.raises(ValueError, match="keys"):
        step(net, prev, obs, keys[:2])


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "etils", "ml_dtypes", "dotaclient_tpu")
# grpc is imported only inside these functions of env/service.py: the ones
# that dial or serve a network env address.
GRPC_ALLOWED = {("env/service.py", "_grpc")}


def _imported_roots(path: Path):
    """(module, enclosing function or None) of every import in `path`."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, func
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module, func
                for alias in child.names:
                    yield f"{child.module}.{alias.name}", func
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            yield from walk(child, inner)

    yield from walk(tree, None)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """No jax, flax, optax, dotaclient_tpu anywhere in the port or the GPU
    smoke; no google.protobuf anywhere; grpc only inside the env service's
    network dial/serve helper, never at module level."""
    files = sorted((REPO / "dotaclient_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("transport/fabric.py", "serve/handoff.py", "protos/message.py", "env/service.py", "runtime/actor.py",
                "chaos/schedule.py", "chaos/controller.py", "scripts/train_north_star.py", "scripts/chaos_soak.py",
                "scripts/resume_soak.py", "scripts/soak_broker_fabric.py", "scripts/soak_serve_chaos.py",
                "scripts/soak_serve_handoff.py", "scripts/soak_fleet_obs.py", "scripts/soak_autoscale.py",
                "scripts/obs_smoke.py", "scripts/train_league.py", "scripts/train_hero_pool.py",
                "scripts/grade_5v5.py", "scripts/soak_league.py", "scripts/soak_wire_bf16.py",
                "scripts/aggregate_soak.py", "scripts/ab_wire_quant.py", "scripts/ab_pack_scale.py",
                "scripts/ab_inet_pack.py", "scripts/ab_overlap.py", "scripts/ab_cast.py", "scripts/ab_ppo_reuse.py",
                "scripts/ab_replay.py", "analysis/schedcheck.py", "analysis/core.py", "analysis/thr_rules.py",
                "analysis/lif_rules.py", "analysis/obs_rules.py", "analysis/fleetgraph.py", "analysis/grammar_check.py",
                "analysis/proto_rules.py", "analysis/lockcheck.py", "analysis/racecheck.py", "scripts/lint_graft.py",
                "bench.py", "scripts/bench_lstm.py", "scripts/bench_tf.py", "scripts/bench_actors.py",
                "scripts/bench_serve.py"):
        assert REPO / "dotaclient_tpu_torch" / new in files
    grpc_sites = set()
    for path in files:
        rel = path.relative_to(REPO / "dotaclient_tpu_torch").as_posix() if "dotaclient_tpu_torch" in path.parts \
            else path.name
        for mod, func in _imported_roots(path):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{rel} imports {mod}"
            assert not (mod == "google.protobuf" or mod.startswith("google.protobuf.")), f"{rel} imports {mod}"
            if root == "grpc":
                assert (rel, func) in GRPC_ALLOWED, f"{rel} imports grpc in {func or 'module scope'}"
                grpc_sites.add((rel, func))
    assert grpc_sites == GRPC_ALLOWED


# The remote client, self-play, the league and the evaluator: no grpc and
# no google.protobuf anywhere in them, not even inside a function (the env
# dial they need goes through env/service.py).
NO_GRPC_MODULES = ["serve/client.py", "runtime/selfplay.py", "eval/__init__.py", "eval/rating.py", "eval/league.py",
                   "eval/evaluator.py", "league/__init__.py", "league/policy.py", "league/registry.py",
                   "league/client.py", "league/server.py"]


@pytest.mark.parametrize("rel", NO_GRPC_MODULES)
def test_remote_selfplay_and_league_modules_import_no_grpc_or_protobuf(rel):
    path = REPO / "dotaclient_tpu_torch" / rel
    assert path.exists()
    for mod, func in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN + ("grpc",), f"{rel} imports {mod} in {func or 'module scope'}"
        assert not (mod == "google" or mod.startswith("google.")), f"{rel} imports {mod}"
