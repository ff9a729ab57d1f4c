"""OBS002 scripts fixture: a bench-driver-shaped subprocess spawn whose
argv list names a known binary with one valid flag and one flag the
fixture config.py does not define. The self-reinvocation list below it
names no binary and must stay out of scope. Never executed."""

import subprocess
import sys


def spawn_learner():
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dotaclient_tpu_torch.runtime.learner",
            "--batch_size",
            "8",
            # OBS002: no such field in the fixture config.py
            "--not_a_learner_flag",
            "1",
        ]
    )


def respawn_self():
    # a script's OWN argparse namespace: no module string, never judged
    return subprocess.Popen(
        [sys.executable, __file__, "--role", "worker", "--own_private_flag", "x"]
    )
