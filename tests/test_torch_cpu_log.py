"""torch's CPU log in a process's first OpenMP parallel region.

On the CPU torch computes a log over a large float tensor through MKL,
chunk by chunk inside an OpenMP parallel region. In a process's first such
region MKL can compute the chunks of newly started worker threads about
1e-4 relative off (whole chunks: every element of a thread's share); a
later call in the same process is within an ulp. This made
tests/test_torch_serve.py's Gumbel test fail now and then under the
driver's six workers: its measured log was the worker process's first
large one. The nightly test reproduces the miss in fresh processes and
shows it gone with MKL's conditional numerical reproducibility on
(MKL_CBWR=COMPATIBLE: MKL's code-path dispatch); the fast test holds the
Gumbel test's remedy, one throwaway log before the measured one, in fresh
processes. Neither the port's noise formula nor its inputs are involved."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# Each fresh process prints, for each of its calls, the elements of the
# test's Gumbel noise that miss the test's bound (tests/test_torch_serve.py
# _side_bound): "CALLS n0 n1 n2".
PROBE = """
import sys
import numpy as np
import torch
from dotaclient_tpu_torch.ops import threefry
KEYS = np.random.RandomState(0).randint(0, 2**32, size=(1024, 2), dtype=np.uint64).astype(np.uint32)
un = threefry.gumbel_uniform(KEYS, (1, 38))
exact = -np.log(-np.log(un.astype(np.float64)))
bound = np.finfo(np.float32).eps * (2 + np.abs(exact))
if sys.argv[1] == "warm":
    x = torch.rand((1024, 1, 38), generator=torch.Generator().manual_seed(0)) * 0.5 + 0.25
    torch.log(-torch.log(x))
misses = []
for _ in range(3):
    got = (-torch.log(-torch.log(torch.from_numpy(un)))).numpy()
    misses.append(int((np.abs(got - exact) > bound).sum()))
print("CALLS", *misses, flush=True)
"""


def _fresh(n: int, mode: str, env=None) -> list:
    """The miss counts of `n` fresh processes, 8 at a time."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=str(REPO))

    def one(_):
        out = subprocess.run([sys.executable, "-c", PROBE, mode], capture_output=True, text=True, timeout=300,
                             env=env, cwd=REPO).stdout
        line = next(ln for ln in out.splitlines() if ln.startswith("CALLS "))
        return [int(x) for x in line.split()[1:]]

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def test_gumbel_noise_on_warm_threads_in_fresh_processes():
    """After one throwaway log every measured call of a fresh process is
    within the Gumbel test's bound, its first one included."""
    runs = _fresh(8, "warm")
    assert all(r == [0, 0, 0] for r in runs), runs


@pytest.mark.nightly
@pytest.mark.slow
def test_first_parallel_log_of_a_fresh_process_can_miss_and_mkl_dispatch_is_why():
    cold = _fresh(240, "cold")
    assert all(r[1:] == [0, 0] for r in cold), cold  # a later call is always within an ulp
    assert sum(r[0] > 0 for r in cold) >= 1, cold  # 7 of 120 on an 8-core x86-64 host
    assert all(r[0] > 1000 for r in cold if r[0]), cold  # whole chunks, not an element
    strict = _fresh(120, "cold", {"MKL_CBWR": "COMPATIBLE"})
    assert all(r == [0, 0, 0] for r in strict), strict
