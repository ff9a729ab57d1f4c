"""The port's transformer policy family against the JAX reference at a
tiny size (width 16, 2 heads, 2 layers): weights carried over the
flax-named leaves, then the teacher-forced unroll and the KV-cache step
(outputs and cache contents), the cache wrap, chunk-local and causal
unrolls, init names and shapes, one PPO train step on a one-device CPU
mesh, remat, the flop count, the config, the refusals, the batched key
step and the learner binary with `--policy.arch transformer`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.ops import flops as jflops
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.transport.serialize import flatten_params, named_param_leaves
from dotaclient_tpu_torch.config import InferenceConfig, LearnerConfig, PolicyConfig, PPOConfig, ServeConfig, parse_config
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.models import transformer_policy as TP
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops import flops as tflops
from dotaclient_tpu_torch.ops.attention import EMPTY_POS
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.runtime.actor import make_batched_key_actor_step, make_key_actor_step
from dotaclient_tpu_torch.serve import server as tserver
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.params import load_named, named_params
from dotaclient_tpu_torch.transport.serialize import deserialize_weights
from test_torch_learner import frames_for
from test_torch_train import METRIC_TOL, _carry_state, _compare_metrics, _compare_states, _jax_step

TF = dict(arch="transformer", unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, tf_layers=2, tf_heads=2, tf_context=9)
B, T = 3, 7  # T+1 = 8 frames unrolled and stepped, within tf_context 9
# f32: the same f32 arithmetic, sums in another order (a few ulp, read
# below 2e-6). bf16: the port rounds to bf16 at the reference's points
# (Dense outputs, RoPE, the cached K/V, the attention output, GELU op by
# op with its constants rounded), but a last-bit difference of an f32 sum
# inside a bf16 product can flip one bf16 rounding (2^-8 relative) of an
# activation; the f32 heads see at most that.
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype, **kw):
    kw = dict(TF, dtype=dtype, **kw)
    return JPolicyConfig(**kw), PolicyConfig(**kw)


def _jax_params(jcfg, seed):
    """JP.init_params compiled once (op-by-op it compiles every op)."""
    return jax.jit(lambda key: JP.init_params(jcfg, key))(jax.random.PRNGKey(seed))


def _obs(jcfg, seed=7):
    return jts.make_train_batch(JLearnerConfig(batch_size=B, seq_len=T, policy=jcfg), seed).obs


def _frame(obs, t):
    return jax.tree.map(lambda x: np.ascontiguousarray(x[:, t]), obs)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    """(dtype, jax cfg, jax params, jitted jax step, port cfg, port net,
    numpy obs [B, T+1], jax unroll output, jax step outputs, jax cache
    after T+1 steps)."""
    dtype = request.param
    jcfg, tcfg = _cfgs(dtype)
    params = _jax_params(jcfg, 0)
    net = load_named(P.PolicyNet(tcfg, device="cpu"), flatten_params(params))
    obs = _obs(jcfg)
    jnet = JP.PolicyNet(jcfg)
    _, unroll = jax.jit(jnet.apply, static_argnames="unroll")(params, JP.initial_state(jcfg, (B,)),
                                                               jax.tree.map(jnp.asarray, obs), unroll=True)
    jstep = jax.jit(jnet.apply)
    state, steps = JP.initial_state(jcfg, (B,)), []
    for t in range(T + 1):
        state, out = jstep(params, state, jax.tree.map(jnp.asarray, _frame(obs, t)))
        steps.append(out)
    return dtype, jcfg, params, jstep, tcfg, net, obs, unroll, steps, state


def _close(ref_arr, out, atol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jnp.asarray(ref_arr).astype(jnp.float32)),
                               rtol=1e-6, atol=atol)


def _compare(jout, tout, atol):
    for r, o in zip(jout.dist, tout.dist):
        _close(r, o, atol)
    _close(jout.value, tout.value, atol)


def _port_steps(net, tcfg, obs, n, batch=B):
    state, outs = P.initial_state(tcfg, (batch,), "cpu"), []
    with torch.no_grad():
        for t in range(n):
            state, out = net(state, tbatch.as_tensors(_frame(obs, t % (T + 1)), "cpu"))
            outs.append(out)
    return state, outs


def test_unroll_matches_jax(ref):
    dtype, _, _, _, tcfg, net, obs, unroll, _, _ = ref
    with torch.no_grad():
        _, out = net(P.initial_state(tcfg, (B,), "cpu"), tbatch.as_tensors(obs, "cpu"), unroll=True)
    assert tuple(out.value.shape) == (B, T + 1)
    _compare(unroll, out, ATOL[dtype])


def test_kv_cache_steps_match_jax(ref):
    """Each of the T+1 steps' heads, then the cache itself: K/V in the
    compute dtype, positions and write index exactly."""
    dtype, _, _, _, tcfg, net, obs, _, jsteps, jstate = ref
    state, outs = _port_steps(net, tcfg, obs, T + 1)
    for jout, out in zip(jsteps, outs):
        _compare(jout, out, ATOL[dtype])
    assert isinstance(state, TP.KVCache)
    assert state.k.dtype == state.v.dtype == P._dtype(tcfg) and state.pos.dtype == state.idx.dtype == torch.int32
    _close(jstate.k, state.k, ATOL[dtype])
    _close(jstate.v, state.v, ATOL[dtype])
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.idx.numpy(), np.asarray(jstate.idx))


# Step vs unroll in the port: the same ops on [B, 1] and [B, T] shapes.
# f32: sums in another order. bf16: a last-bit difference of such a sum
# can flip one bf16 rounding of an activation, as against the reference.
STEP_VS_UNROLL = {"float32": 1e-5, "bfloat16": 2e-2}


def test_steps_reproduce_the_unroll(ref):
    """T+1 KV-cache steps reproduce the teacher-forced unroll: PPO's ratio
    rests on it (the actor's logp is a step, the learner's an unroll)."""
    dtype, _, _, _, tcfg, net, obs, _, _, _ = ref
    _, outs = _port_steps(net, tcfg, obs, T + 1)
    with torch.no_grad():
        _, out = net(P.initial_state(tcfg, (B,), "cpu"), tbatch.as_tensors(obs, "cpu"), unroll=True)
    tol = STEP_VS_UNROLL[dtype]
    torch.testing.assert_close(out.value, torch.stack([o.value for o in outs], 1), rtol=tol, atol=tol)
    for k in range(4):
        torch.testing.assert_close(out.dist[k], torch.stack([o.dist[k] for o in outs], 1), rtol=tol, atol=tol)


def test_cache_wraps_to_a_sliding_window(ref):
    """Past tf_context the ring buffer overwrites the oldest slot (a
    sliding window over the last C positions), never drops the write; the
    wrapped cache and heads match the reference's."""
    dtype, jcfg, params, jstep, tcfg, net, obs, _, _, _ = ref
    C = tcfg.tf_context
    n = C + 3
    jstate = JP.initial_state(jcfg, (B,))
    for t in range(n):
        jstate, jout = jstep(params, jstate, jax.tree.map(jnp.asarray, _frame(obs, t % (T + 1))))
    state, outs = _port_steps(net, tcfg, obs, n)
    np.testing.assert_array_equal(np.sort(state.pos.numpy(), axis=1), np.tile(np.arange(3, C + 3), (B, 1)))
    assert state.idx.tolist() == [n] * B
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    _close(jstate.k, state.k, ATOL[dtype])
    _compare(jout, outs[-1], ATOL[dtype])


def test_unroll_ignores_initial_state(ref):
    """Context is chunk-local: the unroll does not read the (c, h) pair
    the wire ships."""
    _, _, _, _, _, net, obs, _, _, _ = ref
    tobs = tbatch.as_tensors(obs, "cpu")
    H = TF["lstm_hidden"]
    with torch.no_grad():
        carry_in = (torch.full((B, H), 1e6), torch.full((B, H), -1e6))
        carry_out, a = net(carry_in, tobs, unroll=True)
        _, b = net((torch.zeros(B, H), torch.zeros(B, H)), tobs, unroll=True)
    assert carry_out is carry_in
    assert torch.equal(a.value, b.value) and torch.equal(a.dist.type_logp, b.dist.type_logp)


def test_unroll_is_causal(ref):
    dtype, _, _, _, _, net, obs, _, _, _ = ref
    tobs = tbatch.as_tensors(obs, "cpu")
    pert = tobs._replace(hero_feats=tobs.hero_feats.clone())
    pert.hero_feats[:, -1] += 100.0
    zeros = (torch.zeros(B, 16), torch.zeros(B, 16))
    with torch.no_grad():
        _, base = net(zeros, tobs, unroll=True)
        _, out = net(zeros, pert, unroll=True)
    assert torch.equal(base.value[:, :-1], out.value[:, :-1])
    assert not torch.allclose(base.value[:, -1], out.value[:, -1])


def test_blockwise_unroll_matches_dense():
    """tf_attn_block 3 (blocks of 3, 3 and a ragged 2 over 8 frames)
    against dense attention, the same params; f32 sums in another order."""
    jcfg, tcfg = _cfgs("float32")
    named = flatten_params(_jax_params(jcfg, 1))
    dense = load_named(P.PolicyNet(tcfg, device="cpu"), named)
    block = load_named(P.PolicyNet(dataclasses.replace(tcfg, tf_attn_block=3), device="cpu"), named)
    tobs = tbatch.as_tensors(_obs(jcfg, 3), "cpu")
    zeros = P.initial_state(tcfg, (B,), "cpu")
    with torch.no_grad():
        _, a = dense(zeros, tobs, unroll=True)
        _, b = block(zeros, tobs, unroll=True)
    torch.testing.assert_close(a.value, b.value, rtol=0, atol=1e-5)
    torch.testing.assert_close(a.dist.target_logp, b.dist.target_logp, rtol=0, atol=1e-5)


def test_init_params_flax_names_shapes_and_values():
    """The port's init gives the reference's flax paths and shapes (here
    and, by shape alone, at the flagship width: 44 leaves, 493,239
    parameters), LayerNorm scales at one, biases at zero."""
    jcfg, tcfg = _cfgs("bfloat16")
    want = [(n, a.shape) for n, a in flatten_params(_jax_params(jcfg, 0))]
    got = named_params(P.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert [(n, a.shape) for n, a in got] == want
    for n, a in got:
        if n.endswith("/scale"):
            assert (a == 1.0).all(), n
        elif n.endswith("/bias"):
            assert not a.any(), n
        else:
            assert a.std() > 0, n
    assert any("/tf/block1/mlp_down/kernel" in n for n, _ in got)
    flag_j, flag_t = JPolicyConfig(arch="transformer"), PolicyConfig(arch="transformer")
    shapes = named_param_leaves(jax.eval_shape(lambda: JP.init_params(flag_j, jax.random.PRNGKey(0))))
    port = [(n, a.shape) for n, a in named_params(P.PolicyNet(flag_t, device="cpu"))]
    assert port == [(n, tuple(a.shape)) for n, a in shapes]
    assert (len(port), sum(int(np.prod(s)) for _, s in port)) == (44, 493239)


def test_one_train_step_matches_jax():
    """One PPO update from the same JAX TrainState against the reference's
    build_train_step on a one-device CPU mesh: metrics (grad norm among
    them), params and Adam moments, with test_torch_train's tolerances."""
    jpol, tpol = _cfgs("float32")
    jcfg = JLearnerConfig(batch_size=4, seq_len=5, policy=jpol)
    tcfg = LearnerConfig(batch_size=4, seq_len=5, policy=tpol)
    jstate = jax.jit(lambda key: jts.init_train_state(jcfg, key))(jax.random.PRNGKey(1))
    tstate = _carry_state(jstate, tcfg)
    jb = jts.make_train_batch(jcfg, 11)
    jstate, jm = _jax_step(jcfg)(jstate, jax.tree.map(jnp.asarray, jb))
    tstate, tm = ts.build_train_step(tcfg, "cpu")(tstate, tbatch.as_tensors(jb, "cpu"))
    _compare_metrics(tm, jm, METRIC_TOL["float32"])
    _compare_states(tstate, jstate, "float32", 1, "transformer step:")


@pytest.mark.parametrize("attn_block", [0, 4])
def test_remat_changes_nothing_bitwise(attn_block):
    """tf_remat recomputes each block in the backward: after one step the
    params and metrics are bitwise those of the run without it."""
    _, tpol = _cfgs("bfloat16", tf_attn_block=attn_block)
    cfg = LearnerConfig(batch_size=4, seq_len=7, policy=tpol)
    batch = tbatch.as_tensors(tbatch.make_train_batch(cfg, 5), "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, policy=dataclasses.replace(tpol, tf_remat=remat))
        state, m = ts.build_train_step(c, "cpu")(ts.init_train_state(c, "cpu"), batch)
        out.append((named_params(state.net), m))
    (pa, ma), (pb, mb) = out
    assert all(n == k and np.array_equal(a, b) for (n, a), (k, b) in zip(pa, pb))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("policy,ppo", [
    (dict(), dict()),
    (dict(arch="transformer"), dict()),
    (dict(arch="transformer", tf_context=256, tf_layers=3, aux_heads=True), dict()),
    (dict(arch="transformer"), dict(epochs=2, minibatches=2)),
], ids=["lstm", "transformer", "transformer_ctx256_aux", "transformer_reuse"])
def test_flop_count_matches_jax(policy, ppo):
    jcfg = JLearnerConfig(policy=JPolicyConfig(**policy), ppo=JPPOConfig(**ppo))
    tcfg = LearnerConfig(policy=PolicyConfig(**policy), ppo=PPOConfig(**ppo))
    assert tflops.policy_forward_flops_per_frame(tcfg.policy) == jflops.policy_forward_flops_per_frame(jcfg.policy)
    assert tflops.train_step_flops(tcfg) == jflops.train_step_flops(jcfg)


def test_config_defaults_flags_and_refusals():
    ref, ours = JPolicyConfig(), PolicyConfig()
    for f in ("arch", "tf_layers", "tf_heads", "tf_context", "tf_sp_axis", "tf_attn_block", "tf_remat"):
        assert getattr(ours, f) == getattr(ref, f), f
    cfg = parse_config(LearnerConfig(), ["--policy.arch", "transformer", "--policy.tf_attn_block", "64",
                                         "--policy.tf_remat", "true", "--policy.tf_context", "128"])
    assert (cfg.policy.arch, cfg.policy.tf_attn_block, cfg.policy.tf_remat, cfg.policy.tf_context) == (
        "transformer", 64, True, 128)
    assert ours.tf_sp_mode == ref.tf_sp_mode == "ring"
    assert parse_config(LearnerConfig(), ["--policy.tf_sp_mode", "ulysses"]).policy.tf_sp_mode == "ulysses"
    with pytest.raises(ValueError, match="unknown policy family"):
        P.PolicyNet(PolicyConfig(arch="gru"), device="cpu")
    with pytest.raises(ValueError, match="must divide by tf_heads"):
        TP.init_cache(PolicyConfig(arch="transformer", lstm_hidden=18), (2,), "cpu")
    with pytest.raises(ValueError, match="must be even"):
        P.PolicyNet(PolicyConfig(arch="transformer", lstm_hidden=12, tf_heads=4), device="cpu")
    sp = LearnerConfig(policy=PolicyConfig(arch="transformer", tf_sp_axis="sp"))
    with pytest.raises(ValueError, match="names no axis of mesh"):  # the reference's rule
        ts.build_train_step(sp, "cpu")
    # the inference server serves the LSTM family only, as the reference's does
    serve = InferenceConfig(serve=ServeConfig(port=0), policy=PolicyConfig(**TF), platform="cpu")
    with pytest.raises(ValueError, match="requires policy.arch='lstm'"):
        tserver.InferenceServer(serve)


def test_state_helpers(monkeypatch):
    _, tcfg = _cfgs("bfloat16")
    st = P.initial_state(tcfg, (3,), "cpu")
    assert isinstance(st, TP.KVCache)
    assert st.k.shape == st.v.shape == (3, 2, 9, 2, 8) and st.k.dtype == torch.bfloat16
    assert st.pos.shape == (3, 9) and (st.pos == EMPTY_POS).all() and not st.idx.any()
    c, h = P.wire_state(tcfg, st)
    assert c.shape == h.shape == (3, 16) and c.dtype == torch.float32 and not c.any()
    net = P.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        st, _ = net(st, tbatch.as_tensors(_frame(_obs(_cfgs("bfloat16")[0]), 0), "cpu"))
    assert st.idx.tolist() == [1, 1, 1] and st.k.any()
    fresh = P.reset_between_chunks(tcfg, st)
    assert not fresh.idx.any() and not fresh.k.any() and (fresh.pos == EMPTY_POS).all()
    with pytest.raises(TypeError, match="KVCache"):
        net((c, h), tbatch.as_tensors(_frame(_obs(_cfgs("bfloat16")[0]), 0), "cpu"))
    # device=None means the card: without one the entry points raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: TP.init_cache(tcfg, (1,)), lambda: P.initial_state(tcfg, (1,)), lambda: P.PolicyNet(tcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_batched_key_step_rows_match_single_step():
    """A tick of transformer rows (their KVCache rows stacked) is, row by
    row, bitwise the single-row key step with that row's key; the state
    stays a KVCache whose every leaf is sliced and stacked."""
    jcfg, tcfg = _cfgs("bfloat16")
    net = P.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    M = 4
    obs = tbatch.as_tensors(jts.make_train_batch(JLearnerConfig(batch_size=M, seq_len=3, policy=jcfg), 2).obs, "cpu")
    step, single = make_batched_key_actor_step(tcfg), make_key_actor_step(tcfg)
    keys = np.stack([np.array([0, 50 + i], np.uint32) for i in range(M)])
    state = P.initial_state(tcfg, (M,), "cpu")
    for t in range(3):
        order = list(range(M)) if t < 2 else list(reversed(range(M)))
        prev = TP.KVCache(*(x[order] for x in state))
        o = F.Observation(*(x[:, t][order] for x in obs))
        new, action, logp, value, keys2 = step(net, prev, o, keys[order])
        assert isinstance(new, TP.KVCache)
        for i in range(M):
            row = TP.KVCache(*(x[i : i + 1].clone() for x in prev))
            s1, a1, l1, v1, k1 = single(net, row, F.Observation(*(x[i : i + 1].clone() for x in o)), keys[order][i])
            assert all(torch.equal(x[i : i + 1], y) for x, y in zip(new, s1))
            assert all(torch.equal(x[i : i + 1], y) for x, y in zip(action, a1))
            assert torch.equal(logp[i : i + 1], l1) and torch.equal(value[i : i + 1], v1)
            assert np.array_equal(keys2[i], k1)
        inv = np.argsort(order)
        state, keys = TP.KVCache(*(x[inv] for x in new)), keys2[inv]
    assert state.idx.tolist() == [3] * M


def test_learner_binary_trains_the_family(tmp_path):
    """`python -m dotaclient_tpu_torch.runtime.learner --policy.arch
    transformer` on the CPU: two steps over mem://, a checkpoint, the
    last DTW2 frame bitwise the params, and a restore bitwise the state."""
    flags = ["--policy.arch", "transformer", "--policy.unit_embed_dim", "16", "--policy.lstm_hidden", "16",
             "--policy.mlp_hidden", "16", "--policy.tf_heads", "2", "--batch_size", "8", "--seq_len", "4"]
    name = "tf_binary"
    cfg = parse_config(LearnerConfig(), flags)
    tmem.reset(name)
    hub = tmem.MemoryBroker(name)
    for f in frames_for(cfg, 2):
        hub.publish_experience(f)
    ck = str(tmp_path / "ck")
    learner = tlearner.main(flags + ["--broker_url", f"mem://{name}", "--platform", "cpu", "--train_steps", "2",
                                     "--checkpoint_dir", ck, "--checkpoint_every", "2", "--metrics_every", "1"])
    assert learner.version == 2 and isinstance(learner.state.net.core, TP.TransformerPolicyCore)
    named, version, _ = deserialize_weights(hub.poll_weights())
    params = named_params(learner.state.net)
    assert version == 2 and all(n == m and np.array_equal(a, b) for (n, a), (m, b) in zip(named, params))
    assert all(np.isfinite(a).all() for _, a in params)
    restored = tlearner.Learner(dataclasses.replace(cfg, checkpoint_dir=ck), tmem.MemoryBroker("tf_binary_restore"),
                                device="cpu")
    try:
        assert restored.version == 2
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(restored.state.net), params))
    finally:
        restored.close()
