"""The port's sanitizer fixtures and shared scenarios, for
tests/test_torch_lockcheck.py and tests/test_torch_racecheck.py.

- ``lockcheck`` / ``racecheck``: the port's LockMonitor / RaceMonitor
  installed for one test (import them into a test module; they shadow
  the reference's fixtures of the same names in tests/conftest.py).
- ``inversion_scenario`` / ``race_scenario``: one scripted thread
  scenario each (an inverted pair and a three-lock cycle; an
  unsynchronised write-write pair), run under either package's monitor
  so the two can be held to the same reports.
- ``port_frames``: seeded DTR1 frames made with the port's own types
  (the reference's tests/test_transport.py draws, value for value).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

# The port's threaded modules are imported here, before any fixture
# installs a monitor: torch (and tqdm through it) subclass threading.Thread
# at import, which a patched factory function cannot be.
import dotaclient_tpu_torch.obs.watchdog  # noqa: F401
import dotaclient_tpu_torch.runtime.learner  # noqa: F401
import dotaclient_tpu_torch.runtime.staging  # noqa: F401
import dotaclient_tpu_torch.serve.server  # noqa: F401
from dotaclient_tpu_torch.analysis.lockcheck import LockMonitor
from dotaclient_tpu_torch.analysis.racecheck import RaceMonitor


@pytest.fixture
def lockcheck():
    """The port's lock sanitizer for one test: only locks created by repo
    code are instrumented. Production never imports the module."""
    monitor = LockMonitor()
    monitor.install()
    try:
        yield monitor
    finally:
        monitor.uninstall()


@pytest.fixture
def racecheck():
    """The port's happens-before race sanitizer for one test; opt
    instances into write tracing with monitor.watch(obj)."""
    monitor = RaceMonitor()
    monitor.install()
    try:
        yield monitor
    finally:
        monitor.uninstall()


class Box:
    """Plain watched object; attribute writes are the race surface."""

    def __init__(self):
        self.x = 0


def inversion_scenario() -> None:
    """An A→B / B→A inversion, then A→B, B→C, C→A over three fresh locks
    in which no pair is ever reversed: two distinct cycles."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    x = threading.Lock()
    y = threading.Lock()
    z = threading.Lock()
    with x:
        with y:
            pass
    with y:
        with z:
            pass
    with z:
        with x:
            pass


def race_scenario(monitor) -> None:
    """Two named threads write one watched attribute; the second starts
    once the first has written, signalled through a plain list (visible
    under the GIL, conveying no monitored happens-before edge)."""
    box = Box()
    monitor.watch(box)
    wrote = []

    def first():
        box.x = 1
        wrote.append(1)

    def second():
        box.x = 2

    a = threading.Thread(target=first, name="racer-a")
    a.start()
    deadline = time.monotonic() + 5
    while not wrote and time.monotonic() < deadline:
        time.sleep(0.001)
    b = threading.Thread(target=second, name="racer-b")
    b.start()
    b.join(5)
    a.join(5)


def port_frames(n: int, L: int = 4, H: int = 8, version: int = 0) -> list:
    """n DTR1 frames (seeds 0..n-1) of L steps at lstm_hidden H."""
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.transport.serialize import Rollout, serialize_rollout

    frames = []
    for seed in range(n):
        r = np.random.RandomState(seed)
        T1 = L + 1
        obs = F.Observation(
            global_feats=r.randn(T1, F.GLOBAL_FEATURES).astype(np.float32),
            hero_feats=r.randn(T1, F.HERO_FEATURES).astype(np.float32),
            unit_feats=r.randn(T1, F.MAX_UNITS, F.UNIT_FEATURES).astype(np.float32),
            unit_mask=r.rand(T1, F.MAX_UNITS) < 0.5,
            target_mask=r.rand(T1, F.MAX_UNITS) < 0.3,
            action_mask=r.rand(T1, F.N_ACTION_TYPES) < 0.8,
        )
        actions = Action(
            type=r.randint(0, 4, L).astype(np.int32),
            move_x=r.randint(0, 9, L).astype(np.int32),
            move_y=r.randint(0, 9, L).astype(np.int32),
            target=r.randint(0, F.MAX_UNITS, L).astype(np.int32),
        )
        frames.append(
            serialize_rollout(
                Rollout(
                    obs=obs,
                    actions=actions,
                    behavior_logp=r.randn(L).astype(np.float32),
                    behavior_value=r.randn(L).astype(np.float32),
                    rewards=r.randn(L).astype(np.float32),
                    dones=np.concatenate([np.zeros(L - 1, np.float32), np.ones(1, np.float32)]),
                    initial_state=(r.randn(H).astype(np.float32), r.randn(H).astype(np.float32)),
                    version=version,
                    actor_id=seed % 3,
                    episode_return=1.25,
                )
            )
        )
    return frames
