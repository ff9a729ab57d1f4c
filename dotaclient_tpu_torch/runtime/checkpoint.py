"""Durable checkpoint/resume of the learner's TrainState, with full-state
aux manifests and a remote mirror (torch twin of
dotaclient_tpu/runtime/checkpoint.py).

A step is one directory `<dir>/<step>/` holding `arrays.npz`: the params
by flax name (`params/...`), the Adam state (`count`, `mu/<param>`,
`nu/<param>`, transport/params.py's names) and `step`. It is written under
a dot-prefixed temp name, fsynced, then renamed into place, so a crash
mid-save leaves the previous step restorable and never a visible torn
step. The newest `max_to_keep` steps are kept. `feature_schema.json`
stamps the feature schema; a restore under another schema refuses.

Full-state mode adds, beside the steps:
- `aux_<step>.bin`: the learner's aux manifest for that step (pending
  frames, publish high-water, env steps), written atomically after its
  step is complete, so an aux file certifies its step;
- `version_hwm`: the highest weight version ever published, refreshed by
  the publisher thread, so a restore never rolls the version counter
  below versions the fleet has stamped on rollouts.

The remote mirror (`remote_dir`) copies each finished step, its aux
manifest, the high-water file and the schema to another POSIX path (a
mounted bucket, for one; only a `remote_push` checkpointer writes it, and
every one reads it); a marker file lands last, so a reader never
trusts a half-copied step. A restore pulls the newest complete remote step
when it is newer than the local one (a fresh pod with an empty disk). A
URL scheme (`gs://...`) is refused: the port has no object-store client.

The format is the port's own (the reference writes orbax); states carry
between the two packages by flax name through transport/params.py.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from dotaclient_tpu_torch.env.featurizer import FEATURE_SCHEMA_VERSION
from dotaclient_tpu_torch.transport.params import host_named, load_named, load_named_adam, state_tensors

_log = logging.getLogger(__name__)

_ARRAYS = "arrays.npz"
_STEP_DONE = "MIRROR_COMPLETE"  # marker file, written last per mirrored step
_AUX_FMT = "aux_{}.bin"
_HWM_FILE = "version_hwm"
_SCHEMA = "feature_schema.json"


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
    temp name is invisible to the step scans."""
    tmp = dst.parent / f".{dst.name}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dst)


def state_arrays(state) -> Dict[str, np.ndarray]:
    """The arrays of one step: params, Adam state and `step`, read to the
    host on the calling thread's current stream; whole leaves, gathered
    over the tp group under tensor parallelism (every tp rank calls it)."""
    arrays = dict(host_named(state_tensors(state.net, state.opt_state, state.tp)))
    arrays["count"] = np.asarray(int(state.opt_state.count), np.int32)
    arrays["step"] = np.asarray(int(state.step), np.int64)
    return arrays


def _is_url(path: str) -> bool:
    return "://" in path


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5, remote_dir: str = "", remote_push: bool = True):
        """`remote_push=False` makes the remote read-only for this process:
        restores still pull the newest complete step, saves never mirror up
        (the learner's ranks but 0, as the reference's processes but 0)."""
        if _is_url(remote_dir):
            raise ValueError(
                f"checkpoint_remote_dir={remote_dir!r} has a URL scheme: the port mirrors checkpoints "
                f"through pathlib to a POSIX path (a mounted bucket); it has no object-store client"
            )
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._remote = Path(remote_dir) if remote_dir else None
        self._max_to_keep = max_to_keep
        # One mirror thread keeps uploads ordered; its queue is coalesced to
        # the newest pending step (a slow remote must not grow an unbounded
        # backlog while local GC deletes the queued steps).
        self._mirror_pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-mirror")
            if self._remote is not None and remote_push else None
        )
        self._mirror_cond = threading.Condition()
        self._mirror_pending: Optional[int] = None
        self._mirror_inflight = False
        self._mirror_counts = {"mirrored": 0, "superseded": 0, "failures": 0}
        self._last_saved_step: Optional[int] = None
        self.restored_from_remote = False  # the last restore_latest pulled its step from the mirror
        self._last_mirrored_step: Optional[int] = None
        self._aux_lock = threading.Lock()
        self._aux_counts = {"aux_written": 0, "aux_failures": 0}
        self._last_aux_step: Optional[int] = None
        self._last_aux_bytes = 0
        self._hwm_lock = threading.Lock()
        self._hwm: Optional[int] = None
        # Saves come from the loop thread, the async worker and a drain:
        # one lock keeps step order equal to call order.
        self._save_lock = threading.Lock()

    def _schema_path(self) -> Path:
        return self._dir / _SCHEMA

    def all_steps(self):
        return sorted(int(p.name) for p in self._dir.iterdir() if p.name.isdigit() and (p / _ARRAYS).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int, wait: bool = False, aux: Optional[bytes] = None) -> None:
        """Write `state` (a TrainState) as step `step`; see save_arrays."""
        self.save_arrays(state_arrays(state), step, wait=wait, aux=aux)

    def save_arrays(self, arrays: Dict[str, np.ndarray], step: int, wait: bool = False,
                    aux: Optional[bytes] = None) -> None:
        """Write one step (state_arrays' layout): the arrays are on disk
        when this returns, then `aux` (a full-state manifest) lands beside
        them, then the step is handed to the mirror. `wait` also waits for
        the mirror to finish it."""
        with self._save_lock:
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
            # Stamp the current build's schema on every save: the newest
            # steps are always this version.
            _atomic_write(self._schema_path(), json.dumps({"feature_schema_version": FEATURE_SCHEMA_VERSION}).encode())
            for old in self.all_steps()[: -self._max_to_keep]:
                shutil.rmtree(self._dir / str(old))
            if aux is not None:
                try:
                    _atomic_write(self._dir / _AUX_FMT.format(step), aux)
                    with self._aux_lock:
                        self._aux_counts["aux_written"] += 1
                        self._last_aux_step, self._last_aux_bytes = step, len(aux)
                except OSError:
                    with self._aux_lock:
                        self._aux_counts["aux_failures"] += 1
                    _log.exception("aux manifest write for step %d failed; the step restores state-only", step)
            self._gc_aux()
            self._last_saved_step = step
        if self._mirror_pool is not None:
            with self._mirror_cond:
                if self._mirror_pending is not None:
                    self._mirror_counts["superseded"] += 1
                self._mirror_pending = step
                if not self._mirror_inflight:
                    self._mirror_inflight = True
                    self._mirror_pool.submit(self._mirror_worker)
            if wait:
                with self._mirror_cond:
                    self._mirror_cond.wait_for(lambda: self._mirror_pending is None and not self._mirror_inflight)

    def _gc_aux(self) -> None:
        """Drop aux manifests whose step is gone (max_to_keep GC): an aux
        file must never pair with another step's arrays."""
        live = set(self.all_steps())
        for child in self._dir.iterdir():
            stem = child.name[4:-4]
            if child.name.startswith("aux_") and child.name.endswith(".bin") and stem.isdigit() and int(stem) not in live:
                child.unlink(missing_ok=True)

    def load_aux(self, step: Optional[int]) -> Optional[bytes]:
        """The aux manifest of `step`, or None (no full-state save for it)."""
        if step is None:
            return None
        p = self._dir / _AUX_FMT.format(step)
        return p.read_bytes() if p.exists() else None

    def discard_pending(self) -> None:
        """SIGKILL emulation (chaos/controller.py): drop the queued mirror
        upload as a real kill -9 would; the durable state is what already
        hit the disk. The aux manifest is written inside save_arrays, so
        no aux work is ever queued here."""
        with self._mirror_cond:
            self._mirror_pending = None

    def save_stats(self) -> dict:
        """Full-state save health (the ckpt_* scalars); empty before the
        first aux manifest."""
        with self._aux_lock:
            if not any(self._aux_counts.values()):
                return {}
            out = dict(self._aux_counts)
            out["last_aux_bytes"] = self._last_aux_bytes
            if self._last_aux_step is not None:
                out["last_aux_step"] = self._last_aux_step
            return out

    # ------------------------------------------------- publish high-water

    def record_published_version(self, version: int) -> None:
        """Publisher-thread hook: persist the highest version fanned out
        (monotonic; an atomic write, so the file is always a whole int)."""
        with self._hwm_lock:
            if self._hwm is not None and version <= self._hwm:
                return
            self._hwm = version
            try:
                _atomic_write(self._dir / _HWM_FILE, str(version).encode())
            except OSError:
                _log.exception("version high-water write failed; continuing")

    def published_hwm(self) -> Optional[int]:
        """The highest version published from this directory (None before
        any full-state publish)."""
        return _read_int(self._dir / _HWM_FILE)

    # ---------------------------------------------------------- mirroring

    def _mirror_worker(self) -> None:
        """Mirror the newest pending step until none is pending."""
        while True:
            with self._mirror_cond:
                step = self._mirror_pending
                self._mirror_pending = None
                if step is None:
                    self._mirror_inflight = False
                    self._mirror_cond.notify_all()
                    return
            try:
                self._mirror_step(step)
                with self._mirror_cond:
                    self._mirror_counts["mirrored"] += 1
                    self._last_mirrored_step = step
            except Exception:
                with self._mirror_cond:
                    self._mirror_counts["failures"] += 1
                _log.exception("remote mirror of step %d failed; continuing", step)

    def mirror_stats(self) -> dict:
        """Mirror health for the metrics stream (the ckpt_mirror_*
        scalars); `lag_steps` is None before the first mirror completes.
        Empty without a remote."""
        if self._mirror_pool is None:
            return {}
        with self._mirror_cond:
            lag = None
            if self._last_saved_step is not None and self._last_mirrored_step is not None:
                lag = self._last_saved_step - self._last_mirrored_step
            return {"last_saved_step": self._last_saved_step, "last_mirrored_step": self._last_mirrored_step,
                    "lag_steps": lag, **self._mirror_counts}

    def _mirror_step(self, step: int) -> None:
        """Copy the finished local step, its aux manifest, the high-water
        file and the schema to the remote; the marker lands last. Then keep
        the newest max_to_keep complete remote steps and sweep markerless
        leftovers of interrupted uploads."""
        local_step = self._dir / str(step)
        if not local_step.exists():  # GC'd by a newer save before its turn
            _log.warning("mirror: local step dir %s missing; skipping", local_step)
            return
        remote_step = self._remote / str(step)
        if remote_step.exists():
            shutil.rmtree(remote_step)
        shutil.copytree(local_step, remote_step)
        local_aux = self._dir / _AUX_FMT.format(step)
        if local_aux.exists():
            _atomic_write(self._remote / _AUX_FMT.format(step), local_aux.read_bytes())
        hwm = self.published_hwm()
        if hwm is not None:
            _atomic_write(self._remote / _HWM_FILE, str(hwm).encode())
        _atomic_write(self._remote / _SCHEMA, json.dumps({"feature_schema_version": FEATURE_SCHEMA_VERSION}).encode())
        _atomic_write(remote_step / _STEP_DONE, b"ok")
        complete = set(self._remote_steps())
        for child in self._remote.iterdir():
            name = child.name
            if name.isdigit() and int(name) != step and int(name) not in complete:
                shutil.rmtree(child)
            elif name.startswith("aux_") and name.endswith(".bin"):
                stem = name[4:-4]
                if stem.isdigit() and int(stem) != step and int(stem) not in complete:
                    child.unlink()
        for old in sorted(complete)[: -self._max_to_keep]:
            shutil.rmtree(self._remote / str(old))
            (self._remote / _AUX_FMT.format(old)).unlink(missing_ok=True)

    def _remote_steps(self):
        if self._remote is None or not self._remote.exists():
            return []
        return [int(c.name) for c in self._remote.iterdir() if c.name.isdigit() and (c / _STEP_DONE).exists()]

    def pull_latest_remote(self, steps=None) -> Optional[int]:
        """Copy the newest complete remote step (and its aux manifest) into
        the local directory; returns the step or None. The copy lands under
        a dot-prefixed temp name and is renamed into place, so an
        interrupted pull never leaves a partial step. The local high-water
        file only ever moves up."""
        steps = self._remote_steps() if steps is None else steps
        if not steps:
            return None
        step = max(steps)
        tmp = self._dir / f".pull_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        shutil.copytree(self._remote / str(step), tmp)
        (tmp / _STEP_DONE).unlink()  # a mirror artifact, not part of the step
        dst = self._dir / str(step)
        if dst.exists():
            shutil.rmtree(dst)
        os.replace(tmp, dst)
        remote_aux = self._remote / _AUX_FMT.format(step)
        if remote_aux.exists():
            _atomic_write(self._dir / _AUX_FMT.format(step), remote_aux.read_bytes())
        rh = _read_int(self._remote / _HWM_FILE)
        if rh is not None:
            lh = self.published_hwm()
            if lh is None or rh > lh:
                _atomic_write(self._dir / _HWM_FILE, str(rh).encode())
        remote_schema = self._remote / _SCHEMA
        if remote_schema.exists():
            _atomic_write(self._schema_path(), remote_schema.read_bytes())
        _log.info("pulled remote checkpoint step %d from %s", step, self._remote)
        return step

    def restore_latest(self, template):
        """The newest step loaded into `template` (a TrainState whose net
        and Adam tensors take the values, on their device), or None when
        there is no checkpoint. A newer complete remote step is pulled
        first (`restored_from_remote` then says so). Raises SchemaMismatchError on a schema mismatch and
        ValueError on a name or shape mismatch."""
        step = self.latest_step()
        remote_steps = self._remote_steps()
        self.restored_from_remote = False
        if remote_steps and (step is None or max(remote_steps) > step):
            step = self.pull_latest_remote(remote_steps)
            self.restored_from_remote = True
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
        """Drain pending mirror uploads (every save is on disk already)."""
        if self._mirror_pool is not None:
            self._mirror_pool.shutdown(wait=True)


def _read_int(path: Path) -> Optional[int]:
    if not path.exists():
        return None
    try:
        return int(path.read_text().strip())
    except (ValueError, OSError):
        return None
