"""The port's evaluator (dotaclient_tpu_torch/eval/evaluator.py) against the
reference on the CPU: the same frozen params on each package's fake env
give the same results and TrueSkill rating, and the evaluator binary
takes k8s/evaluator.yaml's args and logs a round per version."""

from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import EvalConfig as JEvalConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.env.service import LocalDotaServiceStub as JLocalStub
from dotaclient_tpu.eval.evaluator import Evaluator as JEvaluator
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import ActorConfig, EvalConfig, PolicyConfig, parse_config
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.eval import evaluator as tev
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.params import named_params
from dotaclient_tpu_torch.transport.serialize import serialize_weights

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
SMALL_FLAGS = ["--actor.policy.lstm_hidden", "16", "--actor.policy.unit_embed_dim", "16",
               "--actor.policy.mlp_hidden", "16", "--actor.policy.dtype", "float32"]


@pytest.mark.parametrize("opponent,seed", [("scripted_hard", 0), ("scripted", 4)])
def test_results_and_rating_equal_the_reference(opponent, seed):
    """The same f32 params, seed and actor id: episodes, wins, losses,
    draws, mean return and the TrueSkill rating against the anchored bot
    equal the reference evaluator's, round after round."""
    tcfg = ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", opponent=opponent, seed=seed,
                       max_dota_time=25.0, rollout_len=8)
    jcfg = JActorConfig(policy=JPolicyConfig(**SMALL), opponent=opponent, seed=seed, max_dota_time=25.0,
                        rollout_len=8)
    net = P.init_params(tcfg.policy, torch.Generator().manual_seed(seed + 1), "cpu")
    jparams = jser.unflatten_params(named_params(net), JP.init_params(jcfg.policy, jax.random.PRNGKey(0)))
    ours = tev.Evaluator(tcfg, stub=LocalDotaServiceStub(FakeDotaService()))
    theirs = JEvaluator(jcfg, stub=JLocalStub(JFakeDotaService()))
    try:
        for version in (3, 4):
            a = ours.evaluate(net, n_episodes=3, version=version)
            b = theirs.evaluate(jparams, n_episodes=3, version=version)
            assert (a.version, a.episodes, a.wins, a.losses, a.draws, a.abandoned) == \
                (b.version, b.episodes, b.wins, b.losses, b.draws, b.abandoned)
            assert a.mean_return == pytest.approx(b.mean_return, abs=1e-9)
            assert (a.rating.mu, a.rating.sigma, a.win_rate, a.skill) == \
                (b.rating.mu, b.rating.sigma, b.win_rate, b.skill)
        assert ours._actor.actor_id == theirs._actor.actor_id == 10_000
    finally:
        ours.close()
        theirs.close()


def test_evaluator_refuses_a_non_scripted_opponent_and_the_null_broker_drops():
    with pytest.raises(ValueError, match="scripted"):
        tev.Evaluator(ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", opponent="self"))
    b = tev.NullBroker()
    b.publish_experience(b"x")
    b.publish_weights(b"y")
    assert b.consume_experience(5, timeout=0.1) == [] and b.poll_weights() is None


def _manifest(log_dir, broker_url):
    import chip_smoke

    args = chip_smoke.manifest_args(os.path.join(REPO, "k8s", "evaluator.yaml"))
    out, i = [], 0
    while i < len(args):
        if args[i] == "--actor.env_addr":
            i += 2
            continue
        out.append(args[i])
        i += 1
    out[out.index("--actor.broker_url") + 1] = broker_url
    out[out.index("--log_dir") + 1] = str(log_dir)
    return out


def test_evaluator_binary_takes_the_manifest_and_logs_each_version(tmp_path):
    """k8s/evaluator.yaml's args (the env in-process, --episodes cut to 2,
    small policy, the host): parses as the reference parses them; main
    evaluates version 0 at once and the first version --eval_every past
    it from the weight fanout, logging win_rate, mean_eval_return and the
    TrueSkill fields to metrics.jsonl stepped by version."""
    args = _manifest(tmp_path, "tcp://a:1,tcp://b:2,tcp://c:3")
    ours, theirs = parse_config(EvalConfig(), args), j_parse_config(JEvalConfig(), args)
    assert (ours.episodes, ours.eval_every, ours.actor.opponent) == (theirs.episodes, theirs.eval_every,
                                                                       theirs.actor.opponent) == (16, 10, "scripted_hard")
    assert vars(ours.actor.serve) == vars(theirs.actor.serve) and ours.actor.platform == ""
    tmem.reset("evalhub")
    args = _manifest(tmp_path, "mem://evalhub")
    args[args.index("--episodes") + 1] = "2"
    args += ["--actor.platform", "cpu", "--actor.max_dota_time", "10", *SMALL_FLAGS]
    net = P.init_params(PolicyConfig(**SMALL), torch.Generator().manual_seed(3), "cpu")
    hub = tmem.MemoryBroker("evalhub")
    lines = lambda: [json.loads(x) for x in open(tmp_path / "metrics.jsonl")] if (tmp_path / "metrics.jsonl").exists() \
        else []  # noqa: E731
    polls = []

    def should_stop():
        polls.append(1)
        if len(polls) == 2:
            hub.publish_weights(serialize_weights(named_params(net), version=12))
        return len(lines()) >= 2 or len(polls) > 50

    tev.main(args, stub=LocalDotaServiceStub(FakeDotaService()), should_stop=should_stop)
    got = lines()
    assert [r["step"] for r in got] == [0, 12]
    for r in got:
        assert set(r) >= {"win_rate", "mean_eval_return", "trueskill_mu", "trueskill_sigma", "skill"}
        assert 0.0 <= r["win_rate"] <= 1.0
