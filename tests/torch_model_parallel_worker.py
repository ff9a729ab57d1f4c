"""One rank of the port's tensor- and sequence-parallel tests
(tests/test_torch_model_parallel.py), run as `python
tests/torch_model_parallel_worker.py JOB RANK WORLD DIR`. It imports the
port and numpy only (no JAX), joins the others over gloo on the CPU and
writes what the test compares into DIR/<job>_<rank>.npz (or .json).

Jobs:
- `steps`: for each (name, mesh, port) of DIR/meshes.json, a rendezvous at
  that port with `--mesh_shape` mesh, then
  - "attn": ring and Ulysses attention (and Ulysses with kv_block) on this
    rank's time block of DIR/input.npz's q, k, v, the forward and the
    gradients of sum(out · cot);
  - "sp": the transformer train step (ring / Ulysses, remat off / on) for
    two steps on this rank's B / world rows of the global batches;
  - "tp": the LSTM train step laid out by shard_state, two single updates
    and one 2×2 reuse step with the given permutations;
  writing metrics, whole params and moments, and what the rank holds;
- `binary`: `learner.main` with the flags of DIR/argv_<rank>.json, fed by a
  per-rank mem:// broker holding DIR/frames_<rank>.npz's frames (with
  `--ckpt.drain_on_sigterm` it SIGTERMs itself once its broker is empty);
  writes the version, the params, and a digest of every row it trained.
"""

from __future__ import annotations

import hashlib
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
from dotaclient_tpu_torch.ops import ring_attention as RA
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.dist import init_distributed
from dotaclient_tpu_torch.transport.params import host_named, load_named, named_tensors, state_tensors

B = 8
POL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
TF = dict(POL, arch="transformer", tf_layers=2, tf_heads=2, tf_context=16)
T_TF, T_LSTM = 7, 4  # the transformer unrolls 8 frames: 4 per rank at sp=2
SP_CASES = [(mode, remat) for mode in RA.SP_MODES for remat in (False, True)]
TP_CASES = [("single", {}, 2), ("reuse", dict(epochs=2, minibatches=2), 1)]  # (name, ppo, steps)
KV_BLOCK = 4


def sp_config(mode: str = "ring", remat: bool = False, mesh: str = "dp=-1", **kw) -> LearnerConfig:
    pol = PolicyConfig(**TF, tf_sp_axis="sp" if "sp=" in mesh else "", tf_sp_mode=mode, tf_remat=remat)
    return LearnerConfig(batch_size=B, seq_len=T_TF, policy=pol, mesh_shape=mesh, **kw)


def tp_config(ppo: dict, mesh: str = "dp=-1", **kw) -> LearnerConfig:
    return LearnerConfig(batch_size=B, seq_len=T_LSTM, policy=PolicyConfig(**POL), ppo=PPOConfig(**ppo),
                         mesh_shape=mesh, **kw)


def batch_from(arrays, prefix: str, cfg: LearnerConfig):
    """A numpy TrainBatch from `arrays[prefix + i]`, leaf i of the flat tree."""
    _, structure = tbatch.tree_flatten(tbatch.zeros_train_batch(B, cfg.seq_len, cfg.policy.lstm_hidden, False))
    n = sum(1 for k in arrays if k.startswith(prefix))
    return tbatch.tree_unflatten(structure, [arrays[f"{prefix}{i}"] for i in range(n)])


def _rows(tree, rank: int, world: int):
    share = B // world
    return tbatch.tree_map(lambda x: x[rank * share : (rank + 1) * share], tree)


def _attention(inp, dist, out: dict) -> None:
    group = dist.group("sp")
    n, s = group.size, group.index
    T = inp["q"].shape[1]
    blk = slice(s * T // n, (s + 1) * T // n)
    pos = torch.from_numpy(inp["pos"][:, blk])
    cot = torch.from_numpy(inp["cot"][:, blk])
    for name, fn in (("ring", lambda *a: RA.attend(*a, pos, pos, group, "ring")),
                     ("ulysses", lambda *a: RA.attend(*a, pos, pos, group, "ulysses")),
                     ("ulysses_block", lambda *a: RA.attend(*a, pos, pos, group, "ulysses", kv_block=KV_BLOCK))):
        leaves = [torch.from_numpy(inp[k][:, blk]).requires_grad_(True) for k in "qkv"]
        o = fn(*leaves)
        (o * cot).sum().backward()
        out[f"{name}/out"] = o.detach().numpy()
        for k, x in zip("qkv", leaves):
            out[f"{name}/grad_{k}"] = x.grad.numpy()


def _sp_steps(inp, dist, mesh: str, out: dict) -> None:
    names = [str(n) for n in inp["tf_names"]]
    for mode, remat in SP_CASES:
        cfg = sp_config(mode, remat, mesh)
        state = ts.init_train_state(cfg, "cpu")
        load_named(state.net, [(n, inp[f"tf_param/{n}"]) for n in names])
        step = ts.build_train_step(cfg, "cpu", dist)
        for i in range(2):
            batch = _rows(batch_from(inp, f"tf_batch{i}/", cfg), dist.rank, dist.world)
            state, metrics = step(state, tbatch.as_tensors(batch, "cpu"))
            tag = f"{mode}_{int(remat)}/{i}"
            out.update({f"{tag}/metric/{k}": v.numpy() for k, v in metrics.items()})
            out.update({f"{tag}/param/{n}": a for n, a in host_named(named_tensors(state.net))})


def _tp_steps(inp, dist, mesh: str, out: dict) -> None:
    names = [str(n) for n in inp["lstm_names"]]
    for case, ppo, n_steps in TP_CASES:
        cfg = tp_config(ppo, mesh)
        state = ts.init_train_state(cfg, "cpu")
        load_named(state.net, [(n, inp[f"lstm_param/{n}"]) for n in names])
        state = ts.shard_state(state, dist)
        out[f"{case}/sharded"] = np.array(state.tp.names)
        held = {**named_tensors(state.net), **{f"mu/{n}": t for n, t in state.opt_state.mu.items()}}
        out.update({f"{case}/held/{n}": np.asarray(t.numel()) for n, t in held.items()})
        step = ts.build_train_step(cfg, "cpu", dist)
        for i in range(n_steps):
            batch = _rows(batch_from(inp, f"{case}_batch{i}/", cfg), dist.rank, dist.world)
            args = [[inp[f"{case}_perm/{e}"] for e in range(cfg.ppo.epochs)]] if cfg.ppo.epochs > 1 else []
            state, metrics = step(state, tbatch.as_tensors(batch, "cpu"), *args)
            tag = f"{case}/{i}"
            out.update({f"{tag}/metric/{k}": v.numpy() for k, v in metrics.items()})
            out.update({f"{tag}/state/{n}": a for n, a in host_named(state_tensors(state.net, state.opt_state,
                                                                                   state.tp))})


def run_steps(rank: int, world: int, out_dir: str) -> None:
    inp = np.load(os.path.join(out_dir, "input.npz"))
    meshes = json.load(open(os.path.join(out_dir, "meshes.json")))
    result = {}
    for name, mesh, port in meshes:
        cfg = LearnerConfig(mesh_shape=mesh, multihost=True, coordinator=f"127.0.0.1:{port}", num_processes=world,
                            process_id=rank)
        dist = init_distributed(cfg, "cpu", backend="gloo")
        try:
            part: dict = {}
            {"attn": _attention, "sp": lambda i, d, o: _sp_steps(i, d, mesh, o),
             "tp": lambda i, d, o: _tp_steps(i, d, mesh, o)}[name](inp, dist, part)
            result.update({f"{name}/{k}": v for k, v in part.items()})
        finally:
            dist.close()
    np.savez(os.path.join(out_dir, f"steps_{rank}.npz"), **result)


def run_binary(rank: int, world: int, out_dir: str) -> None:
    """The learner binary on the CPU (DIR/argv_<rank>.json's flags; the
    rendezvous port is DIR/port)."""
    from dotaclient_tpu_torch.runtime import learner as tlearner
    from dotaclient_tpu_torch.transport import memory as tmem

    argv = json.load(open(os.path.join(out_dir, f"argv_{rank}.json")))
    port = open(os.path.join(out_dir, "port")).read().strip()
    drain = "--ckpt.drain_on_sigterm" in argv
    name = f"mp_{rank}"
    broker = tmem.MemoryBroker(name)
    frames = np.load(os.path.join(out_dir, f"frames_{rank}.npz"))
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
    trained = []  # a digest of every row of every consumed batch, as staged
    step = tlearner.Learner._step

    def recording_step(self, payload):
        batch = self.io.consume(*payload)
        leaves = [batch] if self.fused_io is not None else tbatch.tree_flatten(batch)[0]
        for i in range(leaves[0].shape[0]):
            trained.append(hashlib.sha1(b"".join(x[i].cpu().numpy().tobytes() for x in leaves)).hexdigest())
        self.state, metrics = self.train_step(self.state, batch)
        return metrics

    tlearner.Learner._step = recording_step
    try:
        learner = tlearner.main(argv)
    finally:
        tlearner.Learner._step = step
    state = learner.state
    np.savez(os.path.join(out_dir, f"params_{rank}.npz"), **dict(host_named(named_tensors(state.net))))
    record = dict(version=learner.version, env_steps=learner.env_steps_done, trained=trained,
                  resume=learner.resume_info, sharded=list(state.tp.names) if state.tp is not None else [],
                  published=learner.publisher.published, weights=broker.poll_weights() is not None)
    with open(os.path.join(out_dir, f"binary_{rank}.json"), "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    job, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.manual_seed(0)
    torch.set_num_threads(1)  # up to six ranks share the host with the test run's other workers
    {"steps": run_steps, "binary": run_binary}[job](rank, world, out)
