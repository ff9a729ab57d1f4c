"""The port's inference server against the reference's.

- the jax random stream the serve wire carries (ops/threefry.py): keys,
  splits and bits bitwise `jax.random`, Gumbel noise within a stated
  tolerance, categorical picks equal under the stated gap criterion;
- every serve/wire.py message and the single-observation frame byte for
  byte the reference's;
- the reference's RemotePolicyClient stepping the port's server and the
  reference's server with the same request sequences (f32 and bf16
  policies, f32 and bf16 obs codes): keys bitwise, actions under the gap
  criterion, logp/value/carries within tolerance, versions and statuses
  equal;
- the port's contracts: rows bitwise the standalone key step at any
  occupancy, no tick mixing versions under a hot-swap, frozen model slots,
  UNKNOWN_CLIENT / BAD_REQUEST, eviction on disconnect, the weight
  fanout over tcp://, the refusals, the binary's ready line;
- one CPU interop run: the reference RemoteActor on the reference fake
  dotaservice steps episodes through the port server, fed weights by the
  port Learner over tcp:// through the port's BrokerServer.
"""

import asyncio
import dataclasses
import json
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import InferenceConfig as JInferenceConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import ServeClientConfig as JServeClientConfig
from dotaclient_tpu.config import ServeConfig as JServeConfig
from dotaclient_tpu.env import featurizer as JF
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu.env.service import serve as serve_env
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.ops import action_dist as jad
from dotaclient_tpu.serve import wire as JW
from dotaclient_tpu.serve.client import RemoteActor, RemoteInferenceError, RemotePolicyClient
from dotaclient_tpu.serve.server import InferenceServer as JInferenceServer
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu.transport import tcp as jtcp
from dotaclient_tpu_torch.config import (
    InferenceConfig,
    LearnerConfig,
    PolicyConfig,
    PPOConfig,
    ServeConfig,
    parse_config,
    unported_flags,
)
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.runtime.actor import (
    InferenceBatcher,
    apply_weight_frame,
    key_row_inputs,
    make_batched_key_actor_step,
    make_key_actor_step,
)
from dotaclient_tpu_torch.serve import server as tserver
from dotaclient_tpu_torch.serve import wire as W
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport import tcp as ttcp
from dotaclient_tpu_torch.transport.params import named_params
from test_torch_transport import _special_f32

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16)
H = SMALL["lstm_hidden"]
N_KEYS = 1024
KEYS = np.random.RandomState(0).randint(0, 2**32, size=(N_KEYS, 2), dtype=np.uint64).astype(np.uint32)
HEADS = (F.N_ACTION_TYPES, 9, 9, F.MAX_UNITS)

# Gumbel noise, port vs jax: g = -log(t), t = -log(u), and each log is
# within an ulp of exact in both frameworks (torch's CPU log takes a
# vector or a scalar path by an element's place in the tensor). Two ulp
# of t move g by 2 eps absolute (dg = dt/t), and the outer log adds up
# to 2 ulp of g: |dg| <= 4 eps + 2 eps |g|, twice that sum. Over these
# keys the largest difference read 4.8e-7 (|g| < 17), a third of it.
GUMBEL_EPS = np.finfo(np.float32).eps
# A sampled index may differ from jax's only where jax's two largest
# perturbed logits lie closer than both noises' bounds together
# (2 x (4 + 2 x 17) eps = 9.1e-6), rounded up to 1e-5; for the server
# comparison the policies' own agreement is added
# (tests/test_torch_policy.py ATOL, twice: two logits).
GAP_TOL = 1e-5
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def rand_obs(rs: np.random.RandomState) -> F.Observation:
    """A seeded unbatched observation (numpy leaves: valid for both packages)."""
    o = F.zeros_observation()
    action_mask = rs.rand(F.N_ACTION_TYPES) > 0.3
    action_mask[0] = True
    return o._replace(
        unit_feats=rs.randn(*o.unit_feats.shape).astype(np.float32),
        hero_feats=rs.randn(*o.hero_feats.shape).astype(np.float32),
        global_feats=rs.randn(*o.global_feats.shape).astype(np.float32),
        unit_mask=rs.rand(F.MAX_UNITS) > 0.3,
        target_mask=rs.rand(F.MAX_UNITS) > 0.3,
        action_mask=action_mask,
    )


def jkey(seed: int) -> np.ndarray:
    return np.asarray(jax.random.PRNGKey(seed))


# ------------------------------------------------------------------ threefry


def test_port_implements_the_installed_jax_threefry_mode():
    assert bool(jax.config.jax_threefry_partitionable) == threefry.PARTITIONABLE


@pytest.mark.parametrize("num", [2, 4])
def test_split_is_bitwise_jax(num):
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(KEYS))
    got = threefry.split(KEYS, num)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    # one key alone is hashed as it is inside the batch
    assert np.array_equal(threefry.split(KEYS[5], num), np.asarray(jax.random.split(KEYS[5], num)))


@pytest.mark.parametrize("shape", [(1, 4), (1, 9), (1, 16), (3, 5), (37,)])
def test_random_bits_and_uniforms_are_bitwise_jax(shape):
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(KEYS))
    assert np.array_equal(threefry.random_bits(KEYS, shape), bits)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, minval=tiny, maxval=1.0))(KEYS))
    assert np.array_equal(threefry.gumbel_uniform(KEYS, shape).view(np.uint32), want.view(np.uint32))
    want01 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(KEYS))
    assert np.array_equal(threefry.uniform(KEYS, shape).view(np.uint32), want01.view(np.uint32))


def test_key_step_stream_is_the_reference_actor_step_stream():
    """What a serving row draws: rng' = split(rng)[0], and per head the
    uniforms of gumbel(split(split(rng)[1], 4)[h], (1, K_h))."""
    keys2, u = key_row_inputs(PolicyConfig(), KEYS)
    assert np.array_equal(keys2, np.asarray(jax.vmap(lambda k: jax.random.split(k)[0])(KEYS)))
    tiny = np.finfo(np.float32).tiny

    def ref(k):
        r4 = jax.random.split(jax.random.split(k)[1], 4)
        return jnp.concatenate([jax.random.uniform(r4[h], (1, n), minval=tiny) for h, n in enumerate(HEADS)], -1)

    assert np.array_equal(u, np.asarray(jax.vmap(ref)(KEYS)))
    assert u.shape == (N_KEYS, 1, sum(HEADS))


@pytest.fixture()
def fresh_compile():
    """jax compiles what the test runs anew, in this process: nothing comes
    from the persistent compilation cache (whose entries may have been
    compiled by another process, for other CPU features) or from an
    earlier test's in-memory executables. Switching the cache off is not
    enough by itself: jax decides once per process whether it uses the
    cache, so that decision is reset too. Both are restored afterwards."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        cc.reset_cache()
        jax.clear_caches()


# Each side's noise against the float64 value of the same uniform: two
# logs within two ulp each move g by at most eps * (2 + |g|), half the
# pair bound above. Measured over these keys on an x86-64 CPU with
# AVX-512: the port's noise within 0.49 eps (1 + |g|), jax's within
# 0.76 eps (1 + |g|) (its inner log reads up to 1.13 ulp).
def _side_bound(g):
    return GUMBEL_EPS * (2 + np.abs(g))


def _worst(name, got, bound, u, exact) -> str:
    r = np.abs(got - exact) / bound
    i = np.unravel_index(np.argmax(r), r.shape)
    return (f"{name}: worst at key {i[0]} element {i[1:]}: u {u[i]!r}, value {got[i]!r}, reference "
            f"{exact[i]!r}, |diff| {abs(float(got[i]) - float(exact[i])):.3g} = {r[i]:.3f} x its bound")


def test_gumbel_noise_within_tolerance_of_jax(fresh_compile):
    for shape in [(1, 38), (16,)]:
        want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(KEYS))
        un = threefry.gumbel_uniform(KEYS, shape)
        got = (-torch.log(-torch.log(torch.from_numpy(un)))).numpy()
        exact = -np.log(-np.log(un.astype(np.float64)))
        pair = GUMBEL_EPS * (4 + 2 * np.abs(want))
        report = "; ".join([_worst("port vs float64", got, _side_bound(exact), un, exact),
                            _worst("jax vs float64", want, _side_bound(exact), un, exact),
                            _worst("port vs jax", got, pair, un, want)])
        assert np.all(np.abs(got - exact) <= _side_bound(exact)), report
        assert np.all(np.abs(want - exact) <= _side_bound(exact)), report
        assert np.all(np.abs(got - want) <= pair), report


def _count_flips(got, want, perturbed):
    """(pairs whose index differs, pairs among them outside GAP_TOL)."""
    top = np.sort(perturbed, -1)
    gap = top[..., -1] - top[..., -2]
    diff = got != want
    return int(diff.sum()), int((diff & (gap >= GAP_TOL)).sum())


@pytest.mark.parametrize("K,scale", [(4, 1.0), (9, 0.01), (16, 3.0)])
def test_categorical_picks_jax_index(K, scale, fresh_compile):
    logits = (np.random.RandomState(K).randn(N_KEYS, K) * scale).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(KEYS, logits))
    noise = -torch.log(-torch.log(torch.from_numpy(threefry.gumbel_uniform(KEYS, (K,)))))
    got = torch.argmax(torch.from_numpy(logits) + noise, -1).numpy()
    perturbed = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(KEYS)) + logits
    flips, outside = _count_flips(got, want, perturbed)
    assert outside == 0
    assert flips == 0  # the count over these pairs (none lies within GAP_TOL)


def _rand_dist(rs, lead=(1,)):
    def head(n, p_masked):
        logits = rs.randn(*lead, n).astype(np.float32) * 2
        mask = rs.rand(*lead, n) > p_masked
        mask[..., 0] = True
        return logits, mask

    return [head(n, p) for n, p in zip(HEADS, (0.3, 0.0, 0.0, 0.5))]


def test_sample_key_picks_the_reference_sample():
    """ad.sample_key(key, dist) against the reference's ad.sample(key, dist)
    on masked dists (BIG_NEG entries included), [1]-row and [3]-row."""
    rs = np.random.RandomState(1)
    flips = outside = 0
    for i in range(N_KEYS):
        lead = (1,) if i % 4 else (3,)
        heads = _rand_dist(rs, lead)
        jdist = jad.Dist(*(jad.masked_log_softmax(jnp.asarray(lg), jnp.asarray(m)) for lg, m in heads))
        want = jad.sample(KEYS[i], jdist)
        tdist = ad.Dist(*(torch.from_numpy(np.array(x)) for x in jdist))
        got = ad.sample_key(KEYS[i], tdist)
        r4 = jax.random.split(KEYS[i], 4)
        for h, (g, w, lp) in enumerate(zip(got, want, jdist)):
            perturbed = np.asarray(jax.random.gumbel(r4[h], lp.shape) + lp)
            f, o = _count_flips(g.numpy(), np.asarray(w), perturbed)
            flips, outside = flips + f, outside + o
    assert outside == 0
    assert flips == 0  # the count over these pairs


# ---------------------------------------------------------------------- wire


def _obs_pair(rs, special=False):
    obs = rand_obs(rs)
    if special:  # NaNs, infinities, denormals and rounding ties in the float leaves
        sp = _special_f32().view(np.float32)
        uf = obs.unit_feats.copy().reshape(-1)
        uf[: sp.size] = sp
        obs = obs._replace(unit_feats=uf.reshape(obs.unit_feats.shape))
    return obs


@pytest.mark.parametrize("obs_bf16", [False, True])
def test_obs_frames_byte_equal(obs_bf16):
    rs = np.random.RandomState(3)
    assert tser.obs_wire_nbytes(obs_bf16) == jser.obs_wire_nbytes(obs_bf16)
    for special in (False, True):
        obs = _obs_pair(rs, special)
        with np.errstate(invalid="ignore", over="ignore"):
            want = jser.serialize_obs(JF.Observation(*obs), obs_bf16)
        got = tser.serialize_obs(obs, obs_bf16)
        assert got == want
        back, off = tser.deserialize_obs(b"xx" + got, 2, obs_bf16)
        jback, joff = jser.deserialize_obs(b"xx" + want, 2, obs_bf16)
        assert off == joff == 2 + len(got)
        for a, b in zip(back, jback):
            if tser.is_bf16(a):
                assert np.array_equal(tser.bf16_bits(a), np.asarray(b).view(np.uint16))
            else:
                assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
        # a port obs already in bf16 serializes to the same bytes
        assert tser.serialize_obs(back, obs_bf16) == want
    with pytest.raises(ValueError, match="truncated"):
        tser.deserialize_obs(got[:-1], 0, obs_bf16)


def _jresp(r: W.StepResponse) -> JW.StepResponse:
    return JW.StepResponse(*r)


def test_every_wire_message_byte_equal():
    rs = np.random.RandomState(4)
    for m in (0, 1, 7, W.MAX_MODEL_ID):
        assert W.encode_info_request(m) == JW.encode_info_request(m)
        assert W.decode_info_request(W.encode_info_request(m)) == m
    for bad in (b"\x01", b"\x01\x02\x03\x04\x05"):
        with pytest.raises(ValueError):
            W.decode_info_request(bad)
    with pytest.raises(ValueError):
        W.encode_info_request(W.MAX_MODEL_ID + 1)
    assert W.compose_store_key(123, 0) == JW.compose_store_key(123, 0) == 123
    assert W.compose_store_key(123, 5) == JW.compose_store_key(123, 5)
    with pytest.raises(ValueError):
        W.compose_store_key(W.MAX_CLIENT_KEY + 1, 0)
    for episode_start, want_carry, obs_bf16, replay in [(1, 0, 0, 0), (0, 1, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)]:
        key, obs, rng = int(rs.randint(1 << 40)), rand_obs(rs), jkey(int(rs.randint(1000)))
        flags = dict(episode_start=bool(episode_start), want_carry=bool(want_carry), obs_bf16=bool(obs_bf16),
                     replay=bool(replay))
        req = W.encode_step_request(key, obs, rng, **flags)
        assert req == JW.encode_step_request(key, JF.Observation(*obs), rng, **flags)
        assert W.frame(W.S_STEP, req) == JW.frame(JW.S_STEP, req)
        got, want = W.decode_step_request(req), JW.decode_step_request(req)
        assert got[:4] == want[:4] and got.replay == want.replay and np.array_equal(got.rng, want.rng)
        assert tser.serialize_obs(got.obs, got.obs_bf16) == jser.serialize_obs(want.obs, want.obs_bf16)
    for bad in (req[:5], req[:-1], req + b"\x00", req[:9] + b"\x07" + req[10:]):
        with pytest.raises(ValueError):
            W.decode_step_request(bad)
        with pytest.raises(ValueError):
            JW.decode_step_request(bad)
    for carry in (None, (rs.randn(H).astype(np.float32), rs.randn(H).astype(np.float32))):
        r = W.StepResponse(client_key=99, status=W.OK, version=7, tick=2**40 + 3, rng=jkey(5),
                           action=np.asarray([3, 8, 0, 15], np.int32), logp=-1.25, value=0.5, carry=carry)
        b = W.encode_step_response(r)
        assert b == JW.encode_step_response(_jresp(r))
        got, want = W.decode_step_response(b, H), JW.decode_step_response(b, H)
        assert got[:4] == want[:4] and (got.logp, got.value) == (want.logp, want.value)
        assert np.array_equal(got.rng, want.rng) and np.array_equal(got.action, want.action)
        assert (got.carry is None) == (carry is None)
        if carry is not None:
            assert all(np.array_equal(a, b) for a, b in zip(got.carry, want.carry))
            with pytest.raises(ValueError, match="truncated carry"):
                W.decode_step_response(b[:-4], H)
    for status in (W.UNKNOWN_CLIENT, W.BAD_REQUEST):
        b = W.encode_step_response(W.StepResponse(42, status))
        assert b == JW.encode_step_response(JW.StepResponse(42, status)) and len(b) == 9
        assert W.decode_step_response(b, H) == W.StepResponse(42, status)
    assert W.encode_resume_request(7, 16, 2**63 + 1) == JW.encode_resume_request(7, 16, 2**63 + 1)
    assert W.decode_resume_request(W.encode_resume_request(7, 16, 5)) == (7, 16, 5)
    rr = W.ResumeResponse(7, W.OK, 3, 16)
    assert W.encode_resume_response(rr) == JW.encode_resume_response(JW.ResumeResponse(*rr))
    assert W.decode_resume_response(W.encode_resume_response(rr)) == rr
    for dec in (W.decode_resume_request, W.decode_resume_response):
        with pytest.raises(ValueError):
            dec(b"\x00" * 3)
    assert (W.S_STEP, W.S_STATS, W.S_INFO, W.S_RESUME, W.R_STEP, W.R_STATS, W.R_INFO, W.R_RESUME) == (
        JW.S_STEP, JW.S_STATS, JW.S_INFO, JW.S_RESUME, JW.R_STEP, JW.R_STATS, JW.R_INFO, JW.R_RESUME)
    assert (W.OBS_F32, W.OBS_BF16, W.MAX_FRAME) == (JW.OBS_F32, JW.OBS_BF16, JW.MAX_FRAME)


# ----------------------------------------------------------- server helpers


def port_server(dtype="float32", max_batch=4, window_s=0.005, broker=None, **serve_kw):
    cfg = InferenceConfig(serve=ServeConfig(port=0, max_batch=max_batch, gather_window_s=window_s,
                                            weight_poll_s=0.05, **serve_kw),
                          policy=PolicyConfig(**SMALL, dtype=dtype), seed=1, platform="cpu")
    return tserver.InferenceServer(cfg, broker=broker).start()


def ref_server(dtype="float32", max_batch=4, window_s=0.005):
    cfg = JInferenceConfig(serve=JServeConfig(port=0, max_batch=max_batch, gather_window_s=window_s),
                           policy=JPolicyConfig(**SMALL, dtype=dtype), seed=1)
    return JInferenceServer(cfg).start()


def client(server, dtype="float32", obs="f32", model=0):
    return RemotePolicyClient(f"127.0.0.1:{server.port}", JPolicyConfig(**SMALL, dtype=dtype), wire_obs_dtype=obs,
                              model=model)


def standalone(net, cfg, state, obs, key):
    """The port's standalone B=1 key step on one unbatched numpy obs."""
    obs_b = as_tensors(F.stack([obs]), "cpu")
    return make_key_actor_step(cfg)(net, state, obs_b, key)


def assert_row_is(resp, want):
    (c, h), action, logp, value, key2 = want
    assert np.array_equal(resp.rng, key2)
    assert np.array_equal(resp.action, np.asarray([int(a[0]) for a in action], np.int32))
    assert np.float32(resp.logp).tobytes() == logp.numpy().astype(np.float32)[0].tobytes()
    assert np.float32(resp.value).tobytes() == value.numpy().astype(np.float32)[0].tobytes()
    if resp.carry is not None:
        assert np.array_equal(resp.carry[0], c[0].numpy()) and np.array_equal(resp.carry[1], h[0].numpy())


# ------------------------------------------------------ server against server


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def server_pair(request):
    """(dtype, reference server, port server) serving the same params at
    version 3 (the reference's seed init, carried over by flax name)."""
    dtype = request.param
    ref = ref_server(dtype, max_batch=4)
    port = port_server(dtype, max_batch=4)
    named = [(n, np.asarray(a)) for n, a in jser.flatten_params(ref.params)]
    ref.swap_params(named, version=3)
    port.swap_params(named, version=3)
    yield dtype, ref, port
    ref.stop()
    port.stop()


SESSIONS, STEPS = 6, 9


def _drive(server, dtype, obs_code):
    """SESSIONS concurrent sessions of STEPS steps through one reference
    client: an episode start at steps 0 and 5, the carry asked for at every
    step (the gap check needs each pre-step carry)."""

    async def session(c, k):
        rng, out = jkey(100 + k), []
        for t in range(STEPS):
            obs = rand_obs(np.random.RandomState(1000 * k + t))
            resp = await c.step(k, JF.Observation(*obs), rng, episode_start=t in (0, 5), want_carry=True)
            out.append((obs, rng, resp))
            rng = resp.rng
        return out

    async def go():
        c = client(server, dtype, obs_code)
        try:
            return await asyncio.gather(*(session(c, k) for k in range(SESSIONS)))
        finally:
            await c.close()

    return run(go())


def _jax_perturbed(params, pol, carry, obs, rng):
    """The reference step's perturbed logits, head by head."""
    state = (jnp.asarray(carry[0])[None], jnp.asarray(carry[1])[None])
    obs_b = jax.tree.map(lambda x: np.asarray(x)[None], obs)
    _, out = JP.PolicyNet(pol).apply(params, state, obs_b)
    r4 = jax.random.split(jax.random.split(rng)[1], 4)
    return [np.asarray(jax.random.gumbel(k, lp.shape) + lp)[0] for k, lp in zip(r4, out.dist)]


@pytest.mark.parametrize("obs_code", ["f32", "bf16"])
def test_port_server_answers_as_the_reference_server(server_pair, obs_code):
    dtype, ref, port = server_pair
    want, got = _drive(ref, dtype, obs_code), _drive(port, dtype, obs_code)
    tol, gap_tol = ATOL[dtype], GAP_TOL + 2 * ATOL[dtype]
    pol = JPolicyConfig(**SMALL, dtype=dtype)
    flips = 0
    for ws, gs in zip(want, got):
        prev = (np.zeros(H, np.float32), np.zeros(H, np.float32))
        for t, ((obs, rng, w), (_, _, g)) in enumerate(zip(ws, gs)):
            if t == 5:
                prev = (np.zeros(H, np.float32), np.zeros(H, np.float32))
            assert (g.status, g.version, g.client_key) == (w.status, w.version, w.client_key) == (W.OK, 3, w.client_key)
            assert np.array_equal(g.rng, w.rng)
            np.testing.assert_allclose(g.logp, w.logp, rtol=1e-6, atol=tol)
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6, atol=tol)
            for a, b in zip(g.carry, w.carry):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=tol)
            if not np.array_equal(g.action, w.action):
                wire_obs = JInferenceServer._canon_obs(
                    JW.decode_step_request(JW.encode_step_request(0, JF.Observation(*obs), rng,
                                                                  obs_bf16=obs_code == "bf16")).obs)
                perturbed = _jax_perturbed(ref.params, pol, prev, wire_obs, rng)
                for h in np.flatnonzero(g.action != w.action):
                    top = np.sort(perturbed[h])
                    assert top[-1] - top[-2] < gap_tol, (h, top[-2:])
                    flips += 1
            prev = w.carry
    assert flips == 0  # the count over these 54 steps x 4 heads, every case
    # statuses of the refusals agree too
    for server in (ref, port):
        status = _raw_step_status(server.port, key=77, episode_start=False)
        assert status == (77, W.UNKNOWN_CLIENT)


def _raw_step_status(port, key, episode_start):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(W.frame(W.S_INFO, b""))
        _recv_frame(s)
        req = W.encode_step_request(key, rand_obs(np.random.RandomState(0)), jkey(0), episode_start=episode_start)
        s.sendall(W.frame(W.S_STEP, req))
        mtype, payload = _recv_frame(s)
        assert mtype == W.R_STEP
        return struct.unpack_from("<QB", payload)


def _recv_frame(s):
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    n, mtype = struct.unpack("<IB", exact(5))
    return mtype, exact(n) if n else b""


# ---------------------------------------------------------- port contracts


@pytest.fixture(scope="module")
def srv():
    server = port_server(max_batch=4, window_s=0.05)
    yield server
    server.stop()


@pytest.mark.parametrize("occupancy", [1, 3, 4])
def test_rows_bitwise_the_standalone_key_step(srv, occupancy):
    """Every row of a tick, at occupancy 1, partial and full, and over
    resident carries, is bitwise the standalone key step."""
    cfg = srv.cfg.policy
    net = srv._bundle[0]
    before = srv.stats()[f"actor_tick_rows_{occupancy}"]

    async def session(c, k):
        rng, state, out = jkey(k), P.initial_state(cfg, (1,), "cpu"), []
        for t in range(3):
            obs = rand_obs(np.random.RandomState(50 * k + t))
            resp = await c.step(k, JF.Observation(*obs), rng, episode_start=t == 0, want_carry=t != 1)
            want = standalone(net, cfg, state, obs, rng)
            out.append((resp, want))
            state, rng = want[0], resp.rng
        return out

    async def go():
        c = client(srv)
        try:
            return await asyncio.gather(*(session(c, 10 * occupancy + k) for k in range(occupancy)))
        finally:
            await c.close()

    for rows in run(go()):
        for resp, want in rows:
            assert_row_is(resp, want)
            assert (resp.carry is None) == (resp is rows[1][0])
    assert srv.stats()[f"actor_tick_rows_{occupancy}"] >= before + 3


def test_batched_key_step_rows_match_the_single_key_step():
    """make_batched_key_actor_step at M=5 against make_key_actor_step per
    row, on stacked state and obs in another row order."""
    cfg = PolicyConfig(**SMALL, dtype="bfloat16")
    net = P.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rs = np.random.RandomState(7)
    obs = as_tensors(F.stack([rand_obs(rs) for _ in range(5)]), "cpu")
    state = tuple(torch.from_numpy(rs.randn(5, H).astype(np.float32)) for _ in range(2))
    keys = KEYS[:5]
    (c, h), action, logp, value, keys2 = make_batched_key_actor_step(cfg)(net, state, obs, keys)
    single = make_key_actor_step(cfg)
    for i in range(5):
        row = lambda x: x[i : i + 1].clone()  # noqa: E731
        (c1, h1), a1, lp1, v1, k1 = single(net, (row(state[0]), row(state[1])), F.Observation(*map(row, obs)), keys[i])
        assert np.array_equal(k1, keys2[i])
        for x1, xb in zip((c1, h1, *a1, lp1, v1), (c, h, *action, logp, value)):
            assert torch.equal(x1, xb[i : i + 1])


def test_hot_swap_mid_stream_never_mixes_versions_in_a_tick():
    server = port_server(max_batch=4, window_s=0.002)
    try:
        per_tick, stop = {}, threading.Event()

        def swapper():
            v = 0
            while not stop.is_set():
                v += 1
                server.swap_params(P.init_params(server.cfg.policy, torch.Generator().manual_seed(v), "cpu"), v)
                time.sleep(0.003)

        th = threading.Thread(target=swapper, daemon=True)
        th.start()

        async def stream(c, k):
            rng, seen = jkey(k), []
            for t in range(40):
                resp = await c.step(k, JF.Observation(*rand_obs(np.random.RandomState(t))), rng, episode_start=t == 0)
                rng = resp.rng
                seen.append(resp.version)
                per_tick.setdefault(resp.tick, set()).add(resp.version)
            return seen

        async def go():
            c = client(server)
            try:
                return await asyncio.gather(*(stream(c, k) for k in range(4)))
            finally:
                await c.close()

        seen = run(go())
        stop.set()
        th.join(timeout=5)
        assert not {t: v for t, v in per_tick.items() if len(v) > 1}
        assert max(v for s in seen for v in s) > 0
        assert all(a <= b for s in seen for a, b in zip(s, s[1:]))
        assert server.weight_swaps_total > 0
    finally:
        server.stop()


def test_two_models_serve_slot_one_frozen():
    server = port_server(max_batch=4, models=2)
    try:
        cfg = server.cfg.policy
        frozen = P.init_params(cfg, torch.Generator().manual_seed(11), "cpu")
        server.swap_model(1, named_params(frozen), 7)
        obs = rand_obs(np.random.RandomState(2))

        async def one(model):
            c = client(server, model=model)
            try:
                return await c.step(1, JF.Observation(*obs), jkey(9), episode_start=True, want_carry=True)
            finally:
                await c.close()

        zero = P.initial_state(cfg, (1,), "cpu")
        r1 = run(one(1))
        assert r1.version == 7
        assert_row_is(r1, standalone(server._bundles[1][0], cfg, zero, obs, jkey(9)))
        server.swap_params(P.init_params(cfg, torch.Generator().manual_seed(12), "cpu"), 9)
        r1b, r0 = run(one(1)), run(one(0))
        assert r1b.version == 7 and r0.version == 9
        assert np.array_equal(r1b.carry[0], r1.carry[0]) and r1b.logp == r1.logp
        assert_row_is(r0, standalone(server.params, cfg, zero, obs, jkey(9)))
        with pytest.raises(ValueError, match="not resident"):
            run(one(5))
        with pytest.raises(ValueError, match="not resident"):
            server.swap_model(2, frozen, 1)
        stats = server.stats()
        assert stats["serve_model_version_1"] == 7.0 and stats["serve_model_requests_total_1"] == 2.0
    finally:
        server.stop()


def test_unknown_client_bad_request_and_resume_refusal(srv):
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
        s.sendall(W.frame(W.S_INFO, b""))
        mtype, payload = _recv_frame(s)
        info = json.loads(payload)
        assert mtype == W.R_INFO and info["lstm_hidden"] == H and info["arch"] == "lstm" and info["model"] == 0
        good = W.encode_step_request(0xABCDEF, rand_obs(np.random.RandomState(1)), jkey(1))
        s.sendall(W.frame(W.S_STEP, good))  # no resident carry, no EPISODE_START
        assert _recv_frame(s) == (W.R_STEP, struct.pack("<QB", 0xABCDEF, W.UNKNOWN_CLIENT))
        for bad in (good[:-3], good[:9] + b"\x05" + good[10:]):  # short frame; unknown obs code
            s.sendall(W.frame(W.S_STEP, bad))
            assert _recv_frame(s) == (W.R_STEP, struct.pack("<QB", 0xABCDEF, W.BAD_REQUEST))
        s.sendall(W.frame(W.S_RESUME, W.encode_resume_request(0xABCDEF, 16, 5)))
        assert _recv_frame(s) == (W.R_RESUME, W.encode_resume_response(W.ResumeResponse(0xABCDEF, W.UNKNOWN_CLIENT)))
        s.sendall(W.frame(W.S_STATS, b""))
        mtype, payload = _recv_frame(s)
        stats = json.loads(payload)
        assert mtype == W.R_STATS and stats["serve_unknown_client_total"] >= 1 and stats["serve_bad_requests_total"] >= 2
        assert stats["serve_handoff_resume_misses_total"] >= 1
        s.sendall(W.frame(0x7F, b""))  # an unknown message type closes the connection
        assert s.recv(8) == b""


def test_disconnect_evicts_the_connections_carries(srv):
    async def go():
        c = client(srv)
        for k in (1, 2):
            await c.step(k, JF.Observation(*rand_obs(np.random.RandomState(k))), jkey(k), episode_start=True)
        resident = srv.stats()["serve_carries_resident"]
        await c.close()
        return resident

    evicted = srv.evictions_total
    assert run(go()) >= 2
    deadline = time.monotonic() + 5
    while srv.evictions_total < evicted + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.evictions_total == evicted + 2

    async def again():
        c = client(srv)
        try:
            await c.step(1, JF.Observation(*rand_obs(np.random.RandomState(1))), jkey(1))
        finally:
            await c.close()

    with pytest.raises(RemoteInferenceError, match="lost the carry"):
        run(again())


def test_carries_stay_on_the_serving_device(srv):
    async def go():
        c = client(srv)
        try:
            await c.step(5, JF.Observation(*rand_obs(np.random.RandomState(5))), jkey(5), episode_start=True)
            conn = next(x for x in list(srv._conns) if 5 in x.carries)
            return conn.carries[5]
        finally:
            await c.close()

    c, h = run(go())
    assert c.device == h.device == srv.device and c.shape == (1, H) and c.dtype == torch.float32


def test_weight_fanout_over_tcp_swaps_between_ticks():
    broker_server = ttcp.BrokerServer("127.0.0.1", 0).start()
    pub = jtcp.TcpBroker("127.0.0.1", broker_server.port)
    server = port_server(broker=ttcp.TcpBroker("127.0.0.1", broker_server.port))
    try:
        cfg = server.cfg.policy
        new = P.init_params(cfg, torch.Generator().manual_seed(21), "cpu")
        pub.publish_weights(tser.serialize_weights(named_params(new), 5, boot_epoch=17))
        server.poke()
        deadline = time.monotonic() + 10
        while server.version != 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.version == 5 and server.weight_epoch == 17
        obs = rand_obs(np.random.RandomState(8))

        async def one():
            c = client(server)
            try:
                return await c.step(3, JF.Observation(*obs), jkey(3), episode_start=True, want_carry=True)
            finally:
                await c.close()

        resp = run(one())
        assert resp.version == 5
        assert_row_is(resp, standalone(new, cfg, P.initial_state(cfg, (1,), "cpu"), obs, jkey(3)))
        # same boot, older version: ignored; a new boot: resync even to a lower version
        pub.publish_weights(tser.serialize_weights(named_params(new), 4, boot_epoch=17))
        server.poke()
        time.sleep(0.3)
        assert server.version == 5
        pub.publish_weights(tser.serialize_weights(named_params(new), 2, boot_epoch=18))
        server.poke()
        deadline = time.monotonic() + 10
        while server.version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (server.version, server.weight_epoch, server.stats()["serve_weight_swaps_total"]) == (2, 18, 2.0)
    finally:
        server.stop()
        pub.close()
        broker_server.stop()


class _Agent:
    def __init__(self, net):
        self.params, self.version = net, 0


def test_weight_frame_rules():
    cfg = PolicyConfig(**SMALL)
    net = P.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    agent = _Agent(net)
    named = named_params(P.init_params(cfg, torch.Generator().manual_seed(2), "cpu"))
    applied = []
    assert not apply_weight_frame(agent, b"DTW2junk", "t")
    wrong = named_params(P.init_params(PolicyConfig(**dict(SMALL, lstm_hidden=8)), torch.Generator(), "cpu"))
    assert not apply_weight_frame(agent, tser.serialize_weights(wrong, 3, boot_epoch=1), "t")
    assert agent.params is net and agent.version == 0
    assert apply_weight_frame(agent, tser.serialize_weights(named, 3, boot_epoch=1), "t",
                              on_applied=lambda n, v: applied.append(v))
    assert agent.params is not net and agent.version == 3 and applied == [3]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(agent.params), named))
    assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(net), named))  # the old net is whole
    assert not apply_weight_frame(agent, tser.serialize_weights(named, 2, boot_epoch=1), "t")
    assert apply_weight_frame(agent, tser.serialize_weights(named, 1, boot_epoch=2), "t") and agent.version == 1


def test_batcher_gathers_to_capacity_and_fails_pending_on_stop():
    cfg = PolicyConfig(**SMALL, dtype="float32")
    net = P.init_params(cfg, torch.Generator().manual_seed(4), "cpu")

    async def go():
        b = InferenceBatcher(cfg, lambda: (net, 7), capacity=3, window_s=5.0)
        tick_loop = asyncio.ensure_future(b.run())
        zero = P.initial_state(cfg, (1,), "cpu")
        obs = [rand_obs(np.random.RandomState(i)) for i in range(4)]
        t0 = time.monotonic()
        rows = await asyncio.gather(*(b.step(zero, obs[i], jkey(i)) for i in range(3)))
        fired = time.monotonic() - t0
        late = asyncio.ensure_future(b.step(zero, obs[3], jkey(3)))
        await asyncio.sleep(0.05)
        b.stop()
        await asyncio.gather(tick_loop, return_exceptions=True)
        with pytest.raises(RuntimeError):
            await late
        with pytest.raises(RuntimeError, match="stopped"):
            await b.step(zero, obs[0], jkey(0))
        return rows, fired, b.stats(), obs

    rows, fired, stats, obs = run(go())
    assert fired < 4.0  # a full tick fires at capacity, not at the window
    assert stats["actor_tick_rows_3"] == 1.0 and stats["actor_batch_occupancy"] == 1.0
    assert [(version, tick) for _, version, tick in rows] == [(7, 1)] * 3
    for i, (((c, h), action, logp, value, key2), _, _) in enumerate(rows):
        want = standalone(net, cfg, P.initial_state(cfg, (1,), "cpu"), obs[i], jkey(i))
        assert torch.equal(c, want[0][0]) and np.array_equal(key2, want[4])
        assert np.array_equal(action, [int(a[0]) for a in want[1]]) and logp == want[2].numpy()[0]


def test_batcher_resumes_a_ticks_requesters_before_the_next_tick():
    """With more requests queued than one tick takes, the requesters a tick
    served resume (a server sends their replies) before the next tick runs."""
    cfg = PolicyConfig(**SMALL, dtype="float32")
    net = P.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    events = []

    async def go():
        b = InferenceBatcher(cfg, lambda: (net, 0), capacity=2, window_s=0.5)
        run_tick = b._run_tick

        def tick(reqs, gather_wait):
            events.append("tick")
            run_tick(reqs, gather_wait)

        b._run_tick = tick
        zero = P.initial_state(cfg, (1,), "cpu")

        async def one(i):
            await b.step(zero, rand_obs(np.random.RandomState(i)), jkey(i))
            events.append(i)

        tasks = [asyncio.ensure_future(one(i)) for i in range(6)]
        tick_loop = asyncio.ensure_future(b.run())
        await asyncio.gather(*tasks)
        b.stop()
        await asyncio.gather(tick_loop, return_exceptions=True)

    run(go())
    assert events == ["tick", 0, 1, "tick", 2, 3, "tick", 4, 5]


def test_the_server_reads_tf_sp_axis_as_the_reference_server():
    """policy.tf_sp_axis is a learner setting: the reference's server takes
    the flag and ignores it for the LSTM family it serves, and refuses
    another family by its own rule; so does the port's."""
    cfg = InferenceConfig(serve=ServeConfig(port=0), policy=PolicyConfig(**SMALL, tf_sp_axis="sp"), platform="cpu")
    assert parse_config(InferenceConfig(), ["--policy.tf_sp_axis", "sp"]).policy.tf_sp_axis == "sp"
    server = tserver.InferenceServer(cfg)
    assert server.cfg.policy.tf_sp_axis == "sp"
    tf = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, arch="transformer"))
    with pytest.raises(ValueError, match="requires policy.arch='lstm'"):
        tserver.InferenceServer(tf)


class _BrokerSeen(Exception):
    """Raised by a stand-in server once main has handed it the broker."""


def test_main_chaos_enabled_wraps_the_weights_broker(monkeypatch):
    """--chaos.enabled: the server binary's weights broker is a ChaosBroker
    over the production broker; chaos off hands it the broker itself."""
    from dotaclient_tpu_torch.transport import memory as tmem

    seen = []

    def fake_server(cfg, broker, device=None, obs_runtime=None):
        seen.append(broker)
        raise _BrokerSeen

    monkeypatch.setattr(tserver, "InferenceServer", fake_server)
    argv = ["--platform", "cpu", "--broker_url", "mem://serve_chaos", "--chaos.enabled", "true", "--chaos.spec",
            "latency:0.002~0.001,stall@5:1"]
    for a in (argv, argv[:4]):
        with pytest.raises(_BrokerSeen):
            tserver.main(a)
    from dotaclient_tpu_torch.chaos import ChaosBroker

    wrapped, plain = seen
    assert type(wrapped) is ChaosBroker and type(wrapped.inner) is tmem.MemoryBroker
    assert wrapped.schedule.latency_jitter_s == 0.001 and len(wrapped.schedule.stalls()) == 1
    assert type(plain) is tmem.MemoryBroker


def test_every_unported_serve_mode_is_tested_and_the_defaults(monkeypatch):
    assert unported_flags(InferenceConfig()) == []
    # amqp:// is ported (A.10d3): main hands the server an RmqBroker that
    # polls the learner's weights off the model fanout (fake pika)
    from tests import fake_pika
    from dotaclient_tpu_torch.transport.rmq import RmqBroker

    monkeypatch.setitem(sys.modules, "pika", fake_pika)
    fake_pika.reset()
    seen = []

    def fake_server(cfg, broker, device=None, obs_runtime=None):
        seen.append(broker)
        raise _BrokerSeen

    monkeypatch.setattr(tserver, "InferenceServer", fake_server)
    url = "amqp://guest@localhost/"
    with pytest.raises(_BrokerSeen):
        tserver.main(["--platform", "cpu", "--broker_url", url])
    (broker,) = seen
    RmqBroker(url).publish_weights(b"DTW2-v1")
    assert type(broker) is RmqBroker and broker.poll_weights() == b"DTW2-v1"
    fake_pika.reset()
    cfg = parse_config(InferenceConfig(), ["--serve.max_batch", "8", "--retry.window_s", "3"])
    assert cfg.serve.max_batch == 8 and cfg.retry.window_s == 3.0 and cfg.platform == ""
    ref = JInferenceConfig()
    assert (cfg.serve.port, cfg.serve.gather_window_s, cfg.serve.weight_poll_s, cfg.seed, cfg.broker_url) == (
        ref.serve.port, ref.serve.gather_window_s, ref.serve.weight_poll_s, ref.seed, ref.broker_url)
    with pytest.raises(ValueError, match="platform"):
        tserver.serve_device(InferenceConfig(platform="tpu"))


def test_default_platform_is_the_card(monkeypatch):
    """platform "" means the CUDA device: without one the server refuses
    rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.InferenceServer(InferenceConfig(policy=PolicyConfig(**SMALL)))


def test_server_binary_prints_its_ready_line():
    broker = ttcp.BrokerServer("127.0.0.1", 0).start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dotaclient_tpu_torch.serve.server", "--serve.port", "0", "--platform", "cpu",
         "--broker_url", f"tcp://127.0.0.1:{broker.port}", "--policy.lstm_hidden", "16",
         "--policy.unit_embed_dim", "16", "--policy.mlp_hidden", "16"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["serving"] is True and ready["port"] > 0 and set(ready) == {"serving", "port"}
        assert _raw_step_status(ready["port"], key=4, episode_start=False) == (4, W.UNKNOWN_CLIENT)
    finally:
        proc.terminate()
        proc.wait(timeout=20)
        broker.stop()


# ------------------------------------------------------------------- interop


@pytest.fixture()
def env_addr():
    server, port = serve_env(FakeDotaService(), max_workers=4)
    yield f"127.0.0.1:{port}"
    server.stop(0)


def test_reference_remote_actor_through_the_port_server_fed_by_the_port_learner(env_addr, tmp_path):
    """fake dotaservice → the reference's RemoteActor, stepping through the
    port's InferenceServer → DTR frames into the port's BrokerServer over
    tcp:// → the port Learner trains → DTW2 back through the broker → the
    port server hot-swaps, and the served version advances."""
    broker = ttcp.BrokerServer("127.0.0.1", 0).start()
    url = f"tcp://127.0.0.1:{broker.port}"
    pol = dict(SMALL, dtype="float32")
    server = port_server(broker=ttcp.TcpBroker("127.0.0.1", broker.port))
    lcfg = LearnerConfig(batch_size=4, seq_len=8, policy=PolicyConfig(**pol), publish_every=1, metrics_every=1,
                         log_dir=str(tmp_path), broker_url=url, ppo=PPOConfig(max_staleness=1000), seed=1)
    learner = tlearner.Learner(lcfg, ttcp.TcpBroker("127.0.0.1", broker.port), device="cpu")
    acfg = JActorConfig(env_addr=env_addr, broker_url=url, rollout_len=8, max_dota_time=15.0,
                        policy=JPolicyConfig(**pol), seed=2,
                        serve=JServeClientConfig(endpoint=f"127.0.0.1:{server.port}"))
    actor = RemoteActor(acfg, jtcp.TcpBroker("127.0.0.1", broker.port), actor_id=0)
    errors = []

    def train():
        try:
            learner.run(num_steps=3, batch_timeout=60.0, max_idle=2)
        except BaseException as e:
            errors.append(e)

    async def interleave():
        t = threading.Thread(target=train, daemon=True)
        t.start()
        while t.is_alive():
            await actor.run_episode()
        server.poke()
        deadline = time.monotonic() + 10
        while server.version < 3 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        await actor.run_episode()  # stepped under the newest weights
        await actor.remote_policy.close()
        return t

    try:
        t = run(interleave())
    finally:
        learner.close()
        server.stop()
        broker.stop()
    assert not t.is_alive() and not errors
    assert learner.version == 3 and server.version == 3 and server.weight_epoch == learner.boot_epoch
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(server.params),
                                                                named_params(learner.state.net)))
    assert actor.version == 3  # chunks stamped with the served version
    stats = learner.staging.stats()
    assert stats["consumer_errors"] == 0 and stats["dropped_bad"] == 0 and stats["batches"] >= 3
    s = server.stats()
    assert s["serve_requests_total"] > 0 and s["serve_weight_swaps_total"] >= 1 and s["serve_unknown_client_total"] == 0
