"""Evaluation (torch twin of dotaclient_tpu/eval/evaluator.py): win rate and
TrueSkill of a frozen policy against the scripted bot.

The evaluator subscribes to the learner's weight fanout as an actor does,
and plays whole episodes with the latest net through the port's Actor
loop on a broker that drops its experience, so it takes no learner or
actor cycles:

    learner ──weights fanout──▶ evaluator ──env──▶ scripted bot
                                     └─▶ metrics.jsonl / TensorBoard

Library use: `Evaluator(cfg).evaluate(net, n_episodes)`. Binary use:
`python -m dotaclient_tpu_torch.eval.evaluator --actor.broker_url ...`
(k8s/evaluator.yaml's flags); the policy steps on the card unless
`--actor.platform cpu`.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import List, Optional

from dotaclient_tpu_torch.config import ActorConfig
from dotaclient_tpu_torch.eval.rating import Rating, RatingTable
from dotaclient_tpu_torch.transport.base import Broker

_log = logging.getLogger(__name__)


class NullBroker(Broker):
    """Drops experience and never yields weights: evaluation plays whole
    episodes through the actor loop without feeding the learner."""

    def publish_experience(self, data: bytes) -> None:
        pass

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        return []

    def publish_weights(self, data: bytes) -> None:
        pass

    def poll_weights(self) -> Optional[bytes]:
        return None


@dataclass
class EvalResult:
    version: int
    episodes: int  # decided episodes (abandoned ones excluded)
    wins: int
    losses: int
    draws: int
    mean_return: float
    rating: Rating
    abandoned: int = 0

    @property
    def win_rate(self) -> float:
        return self.wins / max(self.episodes, 1)

    @property
    def skill(self) -> float:
        return self.rating.conservative


class Evaluator:
    """Plays frozen-policy episodes against the scripted opponent and keeps
    a TrueSkill table with that bot anchored at the default rating (a
    fixed yardstick: the agent's conservative skill against it).

    `stub` replaces dialling cfg.env_addr (an in-process env). One event
    loop and one actor serve every evaluate() call, so the env channel
    outlives a round."""

    SCRIPTED = "scripted"

    def __init__(self, cfg: ActorConfig, name: str = "agent", stub=None):
        from dotaclient_tpu_torch.runtime.actor import Actor

        if cfg.opponent not in ("scripted", "scripted_hard"):
            raise ValueError(f"Evaluator measures vs a scripted bot, got opponent={cfg.opponent!r}")
        self.cfg = cfg
        self.name = name
        self.opponent_name = cfg.opponent
        self.table = RatingTable()
        self.table.add(self.opponent_name, Rating(), anchored=True)
        self.table.add(name)
        self._loop = asyncio.new_event_loop()
        self._actor = Actor(cfg, NullBroker(), actor_id=10_000 + cfg.actor_id, stub=stub)

    def evaluate(self, params, n_episodes: int = 10, version: int = 0) -> EvalResult:
        """`n_episodes` episodes with `params` (a PolicyNet); an episode
        whose env session was lost counts as abandoned, with no result."""
        actor = self._actor
        actor.params = params
        wins = losses = draws = abandoned = 0
        returns = []

        async def run():
            nonlocal wins, losses, draws, abandoned
            for _ in range(n_episodes):
                ret = await actor.run_episode()
                if actor.last_win is None:
                    abandoned += 1
                    continue
                returns.append(ret)
                if actor.last_win > 0:
                    wins += 1
                    self.table.record(self.name, self.opponent_name)
                elif actor.last_win < 0:
                    losses += 1
                    self.table.record(self.opponent_name, self.name)
                else:  # the episode ended with no winning team
                    draws += 1
                    self.table.record(self.name, self.opponent_name, draw=True)

        self._loop.run_until_complete(run())
        return EvalResult(
            version=version,
            episodes=n_episodes - abandoned,
            wins=wins,
            losses=losses,
            draws=draws,
            abandoned=abandoned,
            mean_return=sum(returns) / max(len(returns), 1),
            rating=self.table.get(self.name),
        )

    def close(self) -> None:
        stub = self._actor._stub
        if stub is not None and hasattr(stub, "channel"):
            # the channel's tasks live on this loop: close it there first
            self._loop.run_until_complete(stub.channel.close())
        self._loop.close()


def main(argv=None, stub=None, should_stop=None):
    """`python -m dotaclient_tpu_torch.eval.evaluator [--flags]`: poll the
    weight fanout at --actor.broker_url; every --eval_every versions (and
    at once for the first), play --episodes episodes and log win_rate,
    mean_eval_return, trueskill_mu, trueskill_sigma and skill to
    --log_dir, stepped by version. Runs until interrupted (or until
    `should_stop()` is true). `stub` is an in-process env; without one
    the binary dials --actor.env_addr over gRPC."""
    import time

    from dotaclient_tpu_torch.config import EvalConfig, parse_config
    from dotaclient_tpu_torch.runtime.actor import apply_weight_frame
    from dotaclient_tpu_torch.runtime.metrics import MetricsLogger
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.base import connect as broker_connect

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(EvalConfig(), argv)
    if stub is None:
        from dotaclient_tpu_torch.env.service import require_grpc

        require_grpc()
    broker = broker_connect(cfg.actor.broker_url, retry=RetryPolicy.from_config(cfg.actor.retry))
    metrics = MetricsLogger(cfg.log_dir)
    evaluator = Evaluator(cfg.actor, stub=stub)
    # the inner actor is the weight target: the hot-swap rules of every
    # subscriber (stale frames ignored, a learner restart resynced)
    agent = evaluator._actor
    last_eval = -cfg.eval_every  # evaluate the first version at once
    try:
        while should_stop is None or not should_stop():
            frame = broker.poll_weights()
            if frame is not None:
                apply_weight_frame(agent, frame, "evaluator")
            version = agent.version
            # a learner restart moves the version back: evaluate again at once
            last_eval = min(last_eval, version)
            if version - last_eval >= cfg.eval_every:
                res = evaluator.evaluate(agent.params, n_episodes=cfg.episodes, version=version)
                last_eval = version
                metrics.log(version, {
                    "win_rate": res.win_rate,
                    "mean_eval_return": res.mean_return,
                    "trueskill_mu": res.rating.mu,
                    "trueskill_sigma": res.rating.sigma,
                    "skill": res.skill,
                })
                metrics.flush()
                _log.info("eval v%d: win_rate %.2f skill %.2f (mu %.2f ± %.2f)", version, res.win_rate, res.skill,
                          res.rating.mu, res.rating.sigma)
            else:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        metrics.close()
        evaluator.close()
        broker.close()


if __name__ == "__main__":
    main()
