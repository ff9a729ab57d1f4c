"""Durable checkpoint/resume of the learner's TrainState (torch twin of the
plain path of dotaclient_tpu/runtime/checkpoint.py).

A step is one directory `<dir>/<step>/` holding `arrays.npz`: the params
by flax name (`params/...`), the Adam state (`count`, `mu/<param>`,
`nu/<param>`, transport/params.py's names) and `step`. It is written under
a dot-prefixed temp name, fsynced, then renamed into place, so a crash
mid-save leaves the previous step restorable and never a visible torn
step. The newest `max_to_keep` steps are kept. `feature_schema.json`
stamps the feature schema; a restore under another schema refuses.

The format is the port's own (the reference writes orbax); states carry
between the two packages by flax name through transport/params.py.
"""

from __future__ import annotations

import io
import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from dotaclient_tpu_torch.env.featurizer import FEATURE_SCHEMA_VERSION
from dotaclient_tpu_torch.transport.params import load_named, load_named_adam, named_adam_state, named_params

_ARRAYS = "arrays.npz"


class SchemaMismatchError(RuntimeError):
    """Checkpoint was written under a different feature schema."""


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(dst: Path, data: bytes) -> None:
    """tmp + fsync + replace: `dst` holds the previous complete contents
    or the new complete contents, never a torn write. The dot-prefixed
    temp name is invisible to the step scan."""
    tmp = dst.parent / f".{dst.name}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dst)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _schema_path(self) -> Path:
        return self._dir / "feature_schema.json"

    def all_steps(self):
        return sorted(int(p.name) for p in self._dir.iterdir() if p.name.isdigit() and (p / _ARRAYS).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int) -> None:
        """Write `state` (a TrainState) as step `step`. Synchronous: the
        params and Adam moments come to the host in two device-to-host
        copies and are on disk when this returns (the reference's
        asynchronous save is ckpt.async_save, ROADMAP A.10h)."""
        arrays = dict(named_params(state.net))
        arrays.update(named_adam_state(state.opt_state))
        arrays["step"] = np.asarray(int(state.step), np.int64)
        tmp = self._dir / f".tmp_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)  # a leftover of an interrupted save
        tmp.mkdir()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with open(tmp / _ARRAYS, "wb") as f:
            f.write(buf.getbuffer())
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        final = self._dir / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self._dir)
        # Stamp the current build's schema on every save: the newest steps
        # are always this version.
        _atomic_write(self._schema_path(), json.dumps({"feature_schema_version": FEATURE_SCHEMA_VERSION}).encode())
        for old in self.all_steps()[: -self._max_to_keep]:
            shutil.rmtree(self._dir / str(old))

    def restore_latest(self, template):
        """The newest step loaded into `template` (a TrainState whose net
        and Adam tensors take the values, on their device), or None when
        there is no checkpoint. Raises SchemaMismatchError on a schema
        mismatch and ValueError on a name or shape mismatch."""
        step = self.latest_step()
        if step is None:
            return None
        p = self._schema_path()
        if p.exists():
            saved = json.loads(p.read_text()).get("feature_schema_version")
            if saved != FEATURE_SCHEMA_VERSION:
                raise SchemaMismatchError(
                    f"checkpoint at {self._dir} was written with feature schema v{saved}, this build uses "
                    f"v{FEATURE_SCHEMA_VERSION} (env/featurizer.py history): param shapes will not restore; "
                    f"retrain or convert the checkpoint"
                )
        with np.load(self._dir / str(step) / _ARRAYS) as z:
            arrays = {k: z[k] for k in z.files}
        net = load_named(template.net, [(k, v) for k, v in arrays.items() if k.startswith("params/")])
        adam = load_named_adam([(k, v) for k, v in arrays.items() if k == "count" or k[:3] in ("mu/", "nu/")], net)
        return template._replace(net=net, opt_state=adam, step=int(arrays["step"]))

    def close(self) -> None:
        """Nothing is pending: every save is complete when it returns."""
