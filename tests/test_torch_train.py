"""The port's learner update against the JAX reference: the full ppo_loss
gradient, the clip + Adam chain against optax, and whole train steps
(single update, and sample reuse with the KL early stop) against the JAX
`build_train_step` on a one-device CPU mesh, both sides starting from the
same JAX TrainState carried across (params and Adam state by flax name)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.config import ReplayConfig as JReplayConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.ops import ppo as jppo
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.transport.serialize import flatten_params, unflatten_params
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig, ReplayConfig
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.clip_adam import ClipAdam
from dotaclient_tpu_torch.ops.ppo import ppo_loss
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.transport.params import load_named, load_named_adam, named_adam_state, named_params, named_tensors

SMALL = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)
B, T = 6, 5


def _configs(dtype="float32", aux=False, staleness=False, lstm=("auto", "auto"), **ppo):
    jcfg = JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**SMALL, dtype=dtype, aux_heads=aux, lstm_impl=lstm[0]),
                          ppo=JPPOConfig(**ppo), replay=JReplayConfig(enabled=staleness))
    tcfg = LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**SMALL, dtype=dtype, aux_heads=aux, lstm_impl=lstm[1]),
                         ppo=PPOConfig(**ppo), replay=ReplayConfig(enabled=staleness))
    return jcfg, tcfg


def _stale_batch(jb):
    """Rows 0-2 replayed, two of them far off-policy (ratio > rho_bar)."""
    blogp = jb.behavior_logp.copy()
    blogp[:2] -= 3.0
    return jb._replace(behavior_staleness=np.array([3.0, 1.0, 2.0, 0.0, 0.0, 0.0], np.float32), behavior_logp=blogp)


def _assert_tree_close(got, want, rtol, what, cos=None):
    """Leaf by leaf over flax-named pairs: max abs error within rtol of the
    leaf's largest magnitude (and, if given, cosine similarity >= cos)."""
    want = dict(want)
    assert sorted(n for n, _ in got) == sorted(want), what
    for n, a in got:
        b = np.asarray(want[n], np.float32)
        a = np.asarray(a, np.float32)
        scale = max(float(np.abs(b).max()), 1e-8)
        assert np.abs(a - b).max() <= rtol * scale, f"{what} {n}: {np.abs(a - b).max()} > {rtol} x {scale}"
        if cos is not None and np.abs(b).max() > 0:
            c = float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert c >= cos, f"{what} {n}: cosine {c}"


# Gradients. f32: the same arithmetic up to the order of f32 sums. bf16:
# each bf16 Dense layer's gradients are bf16 products and bf16 reductions,
# rounded at other points by XLA and by torch. The worst leaf is a bias of
# the unit MLP: its gradient sums B·(T+1)·U bf16 terms that mostly cancel,
# so one-ulp differences of the terms add up to several percent of the
# small sum (measured up to 5.7e-2 of the leaf's largest value, cosine
# >= 0.998). So 0.1 of the largest value, and cosine >= 0.995.
GRAD_TOL = {"float32": (1e-5, None), "bfloat16": (0.1, 0.995)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("staleness", [False, True])
def test_ppo_loss_gradient_tree_matches_jax(dtype, aux, staleness):
    jcfg, tcfg = _configs(dtype, aux, staleness)
    jb = jts.make_train_batch(jcfg, 3)
    if staleness:
        jb = _stale_batch(jb)
    params = JP.init_params(jcfg.policy, jax.random.PRNGKey(5))
    apply = JP.PolicyNet(jcfg.policy).apply
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jppo.ppo_loss(p, apply, b, JPPOConfig()), has_aux=True))
    (jloss, _), jgrads = grad_fn(params, jax.tree.map(jnp.asarray, jb))
    net = load_named(P.PolicyNet(tcfg.policy, device="cpu"), flatten_params(params))
    tensors = named_tensors(net)
    loss, _ = ppo_loss(net, tbatch.as_tensors(jb, "cpu"), PPOConfig())
    grads = torch.autograd.grad(loss, list(tensors.values()))
    rtol, cos = GRAD_TOL[dtype]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol, atol=rtol)
    _assert_tree_close([(n, g.numpy()) for n, g in zip(tensors, grads)], flatten_params(jgrads), rtol, "grad", cos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ppo_loss_gradient_through_the_recompute_backward_matches_jax(dtype):
    """The kernel path's backward (LSTMRecurrence, here with the plain
    forward) against the reference's pallas custom VJP in interpret mode."""
    jcfg, tcfg = _configs(dtype, lstm=("pallas_interpret", "scan_recompute"))
    jb = jts.make_train_batch(jcfg, 4)
    params = JP.init_params(jcfg.policy, jax.random.PRNGKey(6))
    apply = JP.PolicyNet(jcfg.policy).apply
    jgrads = jax.jit(jax.grad(lambda p, b: jppo.ppo_loss(p, apply, b, JPPOConfig())[0]))(params, jax.tree.map(jnp.asarray, jb))
    net = load_named(P.PolicyNet(tcfg.policy, device="cpu"), flatten_params(params))
    tensors = named_tensors(net)
    grads = torch.autograd.grad(ppo_loss(net, tbatch.as_tensors(jb, "cpu"), PPOConfig())[0], list(tensors.values()))
    rtol, cos = GRAD_TOL[dtype]
    _assert_tree_close([(n, g.numpy()) for n, g in zip(tensors, grads)], flatten_params(jgrads), rtol, "grad", cos)


# ------------------------------------------------------------------ optimizer


def _fixed_grads(scale, seed=0):
    r = np.random.RandomState(seed)
    return {"params/a/kernel": (scale * r.randn(4, 3)).astype(np.float32),
            "params/a/bias": (scale * r.randn(3)).astype(np.float32),
            "params/b/kernel": (scale * r.randn(5)).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 3.0], ids=["below_max_norm", "above_max_norm"])
def test_clip_adam_matches_the_optax_chain(scale):
    """Three updates on fixed gradients: updates and (count, mu, nu) against
    optax.chain(clip_by_global_norm, adam). f32 throughout; the norm is
    summed per tensor first (a few ulp)."""
    max_norm, lr, eps = 0.5, 1e-4, 1e-5
    opt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, eps=eps))
    port = ClipAdam(max_norm, lr, eps)
    params = {k: np.zeros_like(v) for k, v in _fixed_grads(1.0).items()}
    jstate = opt.init(jax.tree.map(jnp.asarray, params))
    tstate = port.init({k: torch.tensor(v) for k, v in params.items()})
    for i in range(3):
        g = _fixed_grads(scale, seed=i)
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
        assert (norm > max_norm) == (scale > 1)
        jupd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate)
        tupd, tstate, g_norm = port.update({k: torch.tensor(v) for k, v in g.items()}, tstate)
        np.testing.assert_allclose(g_norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        adam = jstate[1][0]
        assert int(tstate.count) == int(adam.count) == i + 1
        for k in g:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-15)


def test_clip_below_max_norm_keeps_the_gradient_bits():
    port = ClipAdam(max_norm=1e6, lr=1.0, eps=0.0)
    g = {k: torch.tensor(v) for k, v in _fixed_grads(1.0).items()}
    state = port.init({k: torch.zeros_like(v) for k, v in g.items()})
    _, state, _ = port.update(g, state)
    for k in g:  # mu = (1 - b1) * g exactly when g is not rescaled
        assert torch.equal(state.mu[k], g[k] * (1.0 - 0.9))


# ---------------------------------------------------------------- train steps


def _jax_adam_named(opt_state):
    adam = opt_state[1][0]
    return ([("count", np.asarray(adam.count))] + [(f"mu/{n}", a) for n, a in flatten_params(adam.mu)]
            + [(f"nu/{n}", a) for n, a in flatten_params(adam.nu)])


def _carry_state(jstate, tcfg):
    net = load_named(P.PolicyNet(tcfg.policy, device="cpu"), flatten_params(jstate.params))
    return ts.TrainState(net, load_named_adam(_jax_adam_named(jstate.opt_state), net), int(jstate.step))


def _to_jax_state(tstate, template):
    """The port's TrainState as a JAX TrainState shaped like `template`."""
    named = dict(named_adam_state(tstate.opt_state))
    moment = lambda k: unflatten_params([(n[3:], a) for n, a in named.items() if n.startswith(k)], template.params)
    adam = optax.ScaleByAdamState(count=jnp.asarray(named["count"]), mu=moment("mu/"), nu=moment("nu/"))
    opt_state = (template.opt_state[0], (adam, *template.opt_state[1][1:]))
    return jts.TrainState(unflatten_params(named_params(tstate.net), template.params), opt_state, jnp.asarray(tstate.step, jnp.int32))


def test_train_state_carries_to_jax_and_back():
    """params + Adam (count, mu, nu) + step: JAX → port → JAX is the
    identity, leaf for leaf and bit for bit, in the same tree structure."""
    jcfg, tcfg = _configs("float32", aux=True)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(3))
    r = np.random.RandomState(4)
    rand = lambda tree: jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape).astype(np.float32)), tree)
    adam = jstate.opt_state[1][0]._replace(count=jnp.asarray(7, jnp.int32))
    adam = adam._replace(mu=rand(adam.mu), nu=jax.tree.map(jnp.abs, rand(adam.nu)))
    jstate = jstate._replace(opt_state=(jstate.opt_state[0], (adam, *jstate.opt_state[1][1:])), step=jnp.asarray(7, jnp.int32))
    back = _to_jax_state(_carry_state(jstate, tcfg), jstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def _compare_states(tstate, jstate, dtype, updates, what):
    assert tstate.step == int(jstate.step)
    lr = PPOConfig().lr
    for (n, a), (m, b) in zip(named_params(tstate.net), flatten_params(jstate.params)):
        assert n == m
        err = np.abs(a - b).max()
        assert err <= PARAM_LR[dtype] * lr * updates, f"{what} {n}: {err} > {PARAM_LR[dtype]} lr x {updates}"
    got, want = named_adam_state(tstate.opt_state), _jax_adam_named(jstate.opt_state)
    assert got[0][0] == "count" and int(got[0][1]) == int(want[0][1]) == updates
    rtol, cos = GRAD_TOL[dtype]
    _assert_tree_close([kv for kv in got[1:] if kv[0].startswith("mu/")], [kv for kv in want[1:] if kv[0].startswith("mu/")],
                       rtol, f"{what} mu", cos)
    _assert_tree_close([kv for kv in got[1:] if kv[0].startswith("nu/")], [kv for kv in want[1:] if kv[0].startswith("nu/")],
                       2 * rtol, f"{what} nu", cos)


def _compare_metrics(tm, jm, tol):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=tol, atol=tol, err_msg=k)


def _jax_step(jcfg):
    mesh = jmesh.make_mesh("dp=1", devices=jax.devices()[:1])
    step, _, _ = jts.build_train_step(jcfg, mesh)
    return step


# Params after k updates, in units of lr·k: Adam moves an element by
# lr·m̂/(sqrt(v̂)+eps), about ±lr whatever the gradient's size. Where |g| is
# near eps the step is sensitive to the gradient's last bits (up to lr/eps
# times its error), so f32 params agree to 2e-2·lr per update. In bf16
# the gradients differ by up to a few percent of each leaf's largest
# value, which moves an element whose gradient is near eps by a fraction
# of lr (measured 0.44·lr after one update, 0.15·lr·3 after three); lr
# per update fails an element whose update took the other sign (2·lr).
# Params alone cannot see a gradient wrong by a positive factor (Adam's
# step is about ±lr whatever the size): the moments (mu ~ g, nu ~ g²) are
# held to the gradients' tolerance, nu twice.
PARAM_LR = {"float32": 2e-2, "bfloat16": 1.0}
# Metrics are masked means, as in tests/test_torch_ppo.py.
METRIC_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype,aux", [("float32", True), ("bfloat16", False)])
def test_single_update_steps_match_jax(dtype, aux):
    jcfg, tcfg = _configs(dtype, aux)
    jstep = _jax_step(jcfg)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = _carry_state(jstate, tcfg)
    tstep = ts.build_train_step(tcfg, "cpu")
    for i in range(3):
        jb = jts.make_train_batch(jcfg, 10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jb))
        tstate, tm = tstep(tstate, tbatch.as_tensors(jb, "cpu"))
        _compare_metrics(tm, jm, METRIC_TOL[dtype])
        if i in (0, 2):
            _compare_states(tstate, jstate, dtype, i + 1, f"after {i + 1} steps:")


def _jax_perms(jcfg, step):
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), step)
    return [np.asarray(jax.random.permutation(k, jcfg.batch_size)) for k in jax.random.split(rng, jcfg.ppo.epochs)]


@pytest.mark.parametrize("kl_stop", [0.0, 1e-9], ids=["all_updates", "kl_stop_after_first"])
def test_reuse_step_matches_jax(kl_stop):
    """epochs=2 x minibatches=2 with the reference's permutations injected.
    kl_stop=1e-9: the first update's approx_kl exceeds it, so exactly one
    update lands (apply-then-stop)."""
    jcfg, tcfg = _configs("float32", epochs=2, minibatches=2, kl_stop=kl_stop)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(2))
    tstate = _carry_state(jstate, tcfg)
    jb = jts.make_train_batch(jcfg, 20)
    perms = _jax_perms(jcfg, int(jstate.step))
    jstate, jm = _jax_step(jcfg)(jstate, jax.tree.map(jnp.asarray, jb))
    tstate, tm = ts.build_train_step(tcfg, "cpu")(tstate, tbatch.as_tensors(jb, "cpu"), perms)
    _compare_metrics(tm, jm, METRIC_TOL["float32"])
    _compare_states(tstate, jstate, "float32", int(tm["ppo_updates_done"].item()), "reuse:")
    want = (1.0, 1.0) if kl_stop else (4.0, 0.0)
    assert (tm["ppo_updates_done"].item(), tm["ppo_kl_stopped"].item()) == want


def test_reuse_step_default_permutations_are_seeded_by_step():
    _, tcfg = _configs("float32", epochs=2, minibatches=3)
    a, b = ts.epoch_permutations(tcfg, 4, "cpu"), ts.epoch_permutations(tcfg, 4, "cpu")
    assert a.shape == (2, B) and torch.equal(a, b)
    assert all(sorted(p.tolist()) == list(range(B)) for p in a)
    assert not torch.equal(a, ts.epoch_permutations(tcfg, 5, "cpu"))
    other_seed = ts.epoch_permutations(dataclasses.replace(tcfg, seed=1), 4, "cpu")
    assert not torch.equal(a, other_seed)
    # the default path runs and counts its updates
    state = ts.init_train_state(tcfg, "cpu")
    batch = tbatch.as_tensors(tbatch.make_train_batch(tcfg, 0), "cpu")
    state, m = ts.build_train_step(tcfg, "cpu")(state, batch)
    assert state.step == 1 and m["ppo_updates_done"].item() == 6.0 and m["ppo_kl_stopped"].item() == 0.0
    assert all(torch.isfinite(v) for v in m.values())


def test_init_train_state_is_seeded_and_fresh():
    _, tcfg = _configs("bfloat16")
    a, b = ts.init_train_state(tcfg, "cpu"), ts.init_train_state(tcfg, "cpu")
    assert a.step == 0 and int(a.opt_state.count) == 0
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(named_params(a.net), named_params(b.net)))
    assert all(not v.any() for v in a.opt_state.mu.values())
    assert list(a.opt_state.mu) == list(named_tensors(a.net))


def test_builders_refuse_what_the_port_does_not_have():
    _, tcfg = _configs("float32")
    with pytest.raises(NotImplementedError, match="only the LSTM family"):
        ts.build_train_step(dataclasses.replace(tcfg, policy=dataclasses.replace(tcfg.policy, arch="transformer")), "cpu")
    with pytest.raises(ValueError, match="use build_train_step"):
        ts.build_single_train_step(dataclasses.replace(tcfg, fused_h2d=False), "cpu")
    with pytest.raises(NotImplementedError, match="grouped four-buffer"):
        ts.build_single_train_step(dataclasses.replace(tcfg, fused_single_h2d=False), "cpu")
    with pytest.raises(ValueError, match="replay reservoir"):
        ts.build_single_train_step(dataclasses.replace(tcfg, replay=ReplayConfig(enabled=True)), "cpu")
    with pytest.raises(ValueError, match="must divide by ppo.minibatches"):
        ts.build_train_step(dataclasses.replace(tcfg, ppo=PPOConfig(minibatches=4)), "cpu")
