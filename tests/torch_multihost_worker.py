"""One rank of the port's multi-process learner tests
(tests/test_torch_multihost.py; the `steps` job on the card too,
tests/test_torch_cuda.py), run as `python tests/torch_multihost_worker.py
JOB RANK WORLD PORT DIR [DEVICE]`. It imports the port and numpy only (no
JAX), joins the others over gloo (on the CPU, or on one card that the ranks
share) and writes what the test compares into DIR.

Jobs:
- `steps`: train steps at this rank's B / N rows of the global batches in
  DIR/input.npz (single updates, a 2×2 reuse step with and without a
  KL stop, a step with this rank's rows all padding); writes the params,
  the metrics and the all-reduced gradients each step saw;
- `binary`: `learner.main` with the flags in DIR/argv_<rank>.json, fed by
  a per-rank mem:// broker holding DIR/frames_<rank>.npz's frames; with
  `drain` in the job's flags it SIGTERMs itself once its broker is empty;
  writes the params, the version, the env steps, the publishes and
  whether its broker holds a weights frame (or the error it raised).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.clip_adam import ClipAdam
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.dist import init_distributed
from dotaclient_tpu_torch.transport.params import load_named, named_params

B, T = 8, 4
POL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
# (name, ppo flags, whether this rank's rows are replaced by padding on rank 1)
STEP_CASES = [
    ("single", {}, False),
    ("reuse", dict(epochs=2, minibatches=2), False),
    ("reuse_kl", dict(epochs=2, minibatches=2, kl_stop=1e-9), False),
    ("padding", {}, True),
]


def step_config(ppo: dict, aux: bool = True, **kw) -> LearnerConfig:
    return LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**POL, aux_heads=aux), ppo=PPOConfig(**ppo),
                         **kw)


def batch_from(arrays, prefix: str, rows: int, aux: bool = True):
    """A numpy TrainBatch from `arrays[prefix + i]`, leaf i of the flat tree."""
    _, structure = tbatch.tree_flatten(tbatch.zeros_train_batch(rows, T, POL["lstm_hidden"], aux))
    n = sum(1 for k in arrays if k.startswith(prefix))
    return tbatch.tree_unflatten(structure, [arrays[f"{prefix}{i}"] for i in range(n)])


def run_steps(rank: int, world: int, port: int, out: str, device: str = "cpu") -> None:
    seen = []  # the gradients each update's clip + Adam got, all-reduced
    apply = ClipAdam.apply

    def recording_apply(self, params, grads, state):
        seen.append({n: g.detach().cpu().numpy() for n, g in grads.items()})
        return apply(self, params, grads, state)

    ClipAdam.apply = recording_apply
    inp = np.load(os.path.join(out, "input.npz"))
    names = [str(n) for n in inp["param_names"]]
    cfg = step_config({}, multihost=True, coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    dist = init_distributed(cfg, device, backend="gloo")
    assert (dist.world, dist.rank, dist.is_primary) == (world, rank, rank == 0)
    result = {}
    try:
        for case, ppo, padding in STEP_CASES:
            tcfg = step_config(ppo)
            state = ts.init_train_state(tcfg, device)
            load_named(state.net, [(n, inp[f"param/{n}"]) for n in names])
            step = ts.build_train_step(tcfg, device, dist)
            share = B // world
            full = batch_from(inp, f"{case}/batch/", B)
            local = tbatch.tree_map(lambda x: x[rank * share : (rank + 1) * share], full)
            if padding and rank == 1:
                local = tbatch.zeros_train_batch(share, T, POL["lstm_hidden"], True)
            perms = [inp[f"{case}/perm/{e}"] for e in range(tcfg.ppo.epochs)] if tcfg.ppo.epochs > 1 else None
            seen.clear()
            args = (perms,) if perms is not None else ()
            state, metrics = step(state, tbatch.as_tensors(local, device), *args)
            result.update({f"{case}/metric/{k}": v.cpu().numpy() for k, v in metrics.items()})
            result.update({f"{case}/param/{n}": a for n, a in named_params(state.net)})
            result.update({f"{case}/grad/{n}": g for n, g in seen[0].items()})
            result[f"{case}/updates"] = np.asarray(len(seen))
        np.savez(os.path.join(out, f"steps_{rank}.npz"), **result)
    finally:
        dist.close()


def run_binary(rank: int, world: int, port: int, out: str) -> None:
    """The learner binary on the CPU (DIR/argv_<rank>.json's flags)."""
    from dotaclient_tpu_torch.runtime import learner as tlearner
    from dotaclient_tpu_torch.transport import memory as tmem

    argv = json.load(open(os.path.join(out, f"argv_{rank}.json")))
    drain = "--ckpt.drain_on_sigterm" in argv
    name = f"mh_{rank}"
    broker = tmem.MemoryBroker(name)
    frames = np.load(os.path.join(out, f"frames_{rank}.npz"))
    for i in range(len(frames.files)):
        broker.publish_experience(frames[f"f{i}"].tobytes())
    argv = argv + ["--broker_url", f"mem://{name}", "--multihost", "true", "--coordinator", f"127.0.0.1:{port}",
                   "--num_processes", str(world), "--process_id", str(rank)]
    if drain:

        def terminate_once_empty():
            while broker.experience_depth() > 0:
                time.sleep(0.05)
            time.sleep(2.0)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=terminate_once_empty, daemon=True).start()
    record = {}
    try:
        learner = tlearner.main(argv)
    except RuntimeError as e:
        record["error"] = str(e)
    else:
        record.update(version=learner.version, env_steps=learner.env_steps_done,
                      published=learner.publisher.published, weights=broker.poll_weights() is not None)
        np.savez(os.path.join(out, f"params_{rank}.npz"), **dict(named_params(learner.state.net)))
    with open(os.path.join(out, f"binary_{rank}.json"), "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    job, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    torch.manual_seed(0)
    {"steps": run_steps, "binary": run_binary}[job](rank, world, port, out, *sys.argv[6:])
