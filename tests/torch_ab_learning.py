"""Helpers of the learning A/Bs' tests (test_torch_ab_cast.py,
test_torch_ab_ppo_reuse.py, test_torch_ab_replay.py): the configs a
reference closed loop builds, caught at its constructors."""

import types

import pytest

from torch_ab_reference import Stop


def reference_configs(monkeypatch, ref, call):
    """(the learner's config, the actors' configs) the reference's run_arm
    builds under `call()`: its ActorPool builds every actor at once, its
    Actor records the config, its Learner records and stops the run."""
    seen = {"actors": []}

    class Pool:
        def __init__(self, make_actor, n, on_episode=None):
            for i in range(n):
                make_actor(i)

        def start(self):
            return self

    def actor(cfg, broker, actor_id=0, stub=None):
        seen["actors"].append(cfg)
        return types.SimpleNamespace()

    def learner(cfg, broker):
        seen["learner"] = cfg
        raise Stop

    monkeypatch.setattr(ref, "ActorPool", Pool)
    monkeypatch.setattr(ref, "Actor", actor)
    monkeypatch.setattr(ref, "Learner", learner)
    with pytest.raises(Stop):
        call()
    return seen["learner"], seen["actors"]


def same_config(mine, theirs) -> None:
    """Field by field but `platform`: the twin's is the caller's ("cpu"
    here); the reference's learner has "" and its actor "cpu" by default."""
    import dataclasses

    got, want = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert got.pop("platform") == "cpu"
    want.pop("platform")
    assert got == want
