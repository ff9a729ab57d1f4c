"""The port's learner-forward math against the JAX reference: action
distribution, GAE, the TrainBatch layout and random batch, and the PPO
loss with every metric, in f32 and bf16, with replay staleness on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.config import ReplayConfig as JReplayConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.ops import action_dist as jad
from dotaclient_tpu.ops import batch as jbatch
from dotaclient_tpu.ops import gae as jgae
from dotaclient_tpu.ops import ppo as jppo
from dotaclient_tpu.parallel.train_step import make_train_batch as j_make_train_batch
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops import gae as tgae
from dotaclient_tpu_torch.ops.ppo import ppo_loss
from dotaclient_tpu_torch.transport.params import load_named

SMALL = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)


def random_dist(shape=(5,), seed=0, n_bins=9):
    """numpy (logp heads, masks) with some all-masked target rows."""
    r = np.random.RandomState(seed)
    amask = r.rand(*shape, F.N_ACTION_TYPES) < 0.7
    amask[..., F.ACT_NOOP] = True
    tmask = r.rand(*shape, F.MAX_UNITS) < 0.4
    tmask[0] = False  # an all-masked target head
    logits = [r.randn(*shape, n).astype(np.float32) for n in (F.N_ACTION_TYPES, n_bins, n_bins, F.MAX_UNITS)]
    return logits, amask, tmask


def both_dists(seed=0):
    logits, amask, tmask = random_dist(seed=seed)
    jd = jad.Dist(
        type_logp=jad.masked_log_softmax(jnp.asarray(logits[0]), jnp.asarray(amask)),
        move_x_logp=jax.nn.log_softmax(jnp.asarray(logits[1])),
        move_y_logp=jax.nn.log_softmax(jnp.asarray(logits[2])),
        target_logp=jad.masked_log_softmax(jnp.asarray(logits[3]), jnp.asarray(tmask)),
    )
    t = [torch.tensor(x) for x in logits]
    td = ad.Dist(
        type_logp=ad.masked_log_softmax(t[0], torch.tensor(amask)),
        move_x_logp=torch.log_softmax(t[1], -1),
        move_y_logp=torch.log_softmax(t[2], -1),
        target_logp=ad.masked_log_softmax(t[3], torch.tensor(tmask)),
    )
    return jd, td, amask, tmask


def test_masked_log_softmax_matches_jax_and_all_masked_is_uniform():
    jd, td, _, tmask = both_dists()
    for j, t in zip(jd, td):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-5)
    assert not tmask[0].any()
    np.testing.assert_allclose(td.target_logp[0].numpy(), np.full(F.MAX_UNITS, -np.log(F.MAX_UNITS)), rtol=1e-5)
    assert torch.isfinite(td.target_logp).all()


def test_log_prob_entropy_mode_match_jax():
    jd, td, amask, tmask = both_dists(seed=1)
    r = np.random.RandomState(2)
    acts = [r.randint(0, n, 5) for n in (F.N_ACTION_TYPES, 9, 9, F.MAX_UNITS)]
    acts[0][:4] = [F.ACT_NOOP, F.ACT_MOVE, F.ACT_ATTACK, F.ACT_CAST]
    ja = jad.Action(*(jnp.asarray(a, jnp.int32) for a in acts))
    ta = ad.Action(*(torch.tensor(a, dtype=torch.int64) for a in acts))
    np.testing.assert_allclose(ad.log_prob(td, ta).numpy(), np.asarray(jad.log_prob(jd, ja)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ad.entropy(td).numpy(), np.asarray(jad.entropy(jd)), rtol=1e-6, atol=1e-5)
    for j, t in zip(jad.mode(jd), ad.mode(td)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_sample_gumbel_is_argmax_of_noisy_logp():
    _, td, _, _ = both_dists(seed=3)
    r = np.random.RandomState(4)
    noise = [r.gumbel(size=x.shape).astype(np.float32) for x in td]
    got = ad.sample_gumbel(td, ad.Dist(*(torch.tensor(n) for n in noise)))
    for head, n, a in zip(td, noise, got):
        np.testing.assert_array_equal(a.numpy(), np.argmax(head.numpy() + n, axis=-1))


def test_sample_follows_the_distribution_and_never_picks_masked():
    logp = torch.log_softmax(torch.tensor([[0.5, -1.0, 2.0, 0.0]]), -1)
    masked = ad.masked_log_softmax(torch.tensor([[3.0, 1.0, 0.0, 0.0]]), torch.tensor([[False, True, True, False]]))
    n = 20000
    d = ad.Dist(logp.expand(n, 4), masked.expand(n, 4), logp.expand(n, 4), masked.expand(n, 4))
    a = ad.sample(torch.Generator().manual_seed(0), d)
    freq = torch.bincount(a.type, minlength=4).float() / n
    # binomial std at n=20000 is <= 0.0036; 0.015 is ~4 sigma
    torch.testing.assert_close(freq, logp.exp()[0], rtol=0, atol=0.015)
    assert set(a.move_x.tolist()) <= {1, 2}
    torch.testing.assert_close(torch.bincount(a.move_x, minlength=4).float()[1:3] / n, masked.exp()[0, 1:3], rtol=0, atol=0.015)


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_and_masked_stats_match_jax(seed):
    r = np.random.RandomState(seed)
    B, T = 4, 6
    rewards = r.randn(B, T).astype(np.float32)
    values = r.randn(B, T + 1).astype(np.float32)
    mask = (np.arange(T)[None] < r.randint(1, T + 1, B)[:, None]).astype(np.float32)
    dones = ((r.rand(B, T) < 0.2) * mask).astype(np.float32)
    ja, jr = jgae.gae(*(jnp.asarray(x) for x in (rewards, values, dones, mask)), 0.98, 0.95)
    ta, tr = tgae.gae(*(torch.tensor(x) for x in (rewards, values, dones, mask)), 0.98, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    assert not ta.numpy()[mask == 0].any()
    for jf, tf in ((jgae.masked_mean, tgae.masked_mean), (jgae.masked_std, tgae.masked_std)):
        np.testing.assert_allclose(tf(ta, torch.tensor(mask)).item(), float(jf(ja, jnp.asarray(mask))), rtol=1e-5)


@pytest.mark.parametrize("aux,staleness", [(False, False), (True, True)])
def test_batches_match_the_reference_draw_for_draw(aux, staleness):
    jcfg = JLearnerConfig(batch_size=5, seq_len=4, policy=JPolicyConfig(**SMALL, aux_heads=aux),
                          replay=JReplayConfig(enabled=staleness))
    tcfg = LearnerConfig(batch_size=5, seq_len=4, policy=PolicyConfig(**SMALL, aux_heads=aux))
    jb, tb = j_make_train_batch(jcfg, 11), tbatch.make_train_batch(tcfg, 11, with_staleness=staleness)
    jz = jbatch.zeros_train_batch(5, 4, 32, aux, with_staleness=staleness)
    tz = tbatch.zeros_train_batch(5, 4, 32, aux, with_staleness=staleness)
    for j, t in ((jb, tb), (jz, tz)):
        jl, tl = jax.tree.leaves(j), jax.tree.leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tt = tbatch.as_tensors(tb, "cpu")
    assert tt.actions.type.dtype == torch.int64 and tt.obs.unit_mask.dtype == torch.bool
    assert tt.obs.unit_feats.dtype == torch.float32 and (tt.aux is None) == (not aux)


def _ppo_pair(dtype, aux, staleness):
    jpol = JPolicyConfig(**SMALL, dtype=dtype, aux_heads=aux)
    tpol = PolicyConfig(**SMALL, dtype=dtype, aux_heads=aux)
    jcfg = JLearnerConfig(batch_size=6, seq_len=5, policy=jpol, replay=JReplayConfig(enabled=staleness))
    jb = j_make_train_batch(jcfg, 3)
    tb = tbatch.make_train_batch(LearnerConfig(batch_size=6, seq_len=5, policy=tpol), 3, with_staleness=staleness)
    if staleness:  # rows 0-2 replayed, two of them far off-policy (ratio > rho_bar)
        stale = np.array([3.0, 1.0, 2.0, 0.0, 0.0, 0.0], np.float32)
        blogp = jb.behavior_logp.copy()
        blogp[:2] -= 3.0
        jb = jb._replace(behavior_staleness=stale, behavior_logp=blogp)
        tb = tb._replace(behavior_staleness=stale, behavior_logp=blogp)
    params = JP.init_params(jpol, jax.random.PRNGKey(5))
    net = load_named(P.PolicyNet(tpol, device="cpu"), flatten_params(params))
    return params, jpol, jb, net, tbatch.as_tensors(tb, "cpu")


# f32: identical math up to the order of f32 sums. bf16: the policy's
# bf16 activations may flip one rounding (see test_torch_policy.py), and
# the loss averages such flips over every masked step.
PPO_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("staleness", [False, True])
def test_ppo_loss_and_every_metric_match_jax(dtype, aux, staleness):
    params, jpol, jb, net, tb = _ppo_pair(dtype, aux, staleness)
    jloss, jm = jppo.ppo_loss(params, JP.PolicyNet(jpol).apply, jax.tree.map(jnp.asarray, jb), JPPOConfig())
    with torch.no_grad():
        tloss, tm = ppo_loss(net, tb, PPOConfig())
    assert set(tm) == set(jm)
    assert ("aux_loss" in tm) == aux
    tol = PPO_TOL[dtype]
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=tol, atol=tol)
    if staleness:
        assert tm["replay_trunc_frac"].item() > 0
