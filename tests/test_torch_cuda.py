"""GPU-only checks of the port's CUDA kernels against their plain PyTorch
versions. Every test here needs an NVIDIA GPU and the CUDA toolkit and
skips without one. This file imports neither JAX nor the JAX package, so
on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import json
import time

import pytest
import torch

from dotaclient_tpu_torch.ops import lstm as L

pytestmark = pytest.mark.cuda

# Same tolerances and reasons as chip_smoke.py: f32 sums in another
# order over 17 dependent steps; in bf16 one ulp flip of a rounded h.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def inputs(B, T, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x_proj = torch.randn(B, T, 4 * H, generator=g).to(device, dtype)
    w_h = (torch.randn(H, 4 * H, generator=g) / H**0.5).to(device, dtype)
    c0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    h0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    return x_proj, w_h, c0, h0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,T,H",
    # B=128: a minibatch of the reuse step; H=48: a cluster of 3; H=40: the
    # per-thread design; H=1024: per-thread, W_h from global memory; 16x17x16:
    # the skill run's learner (scripts/train_north_star.py); 16x9x128,
    # 8x9x128, 8x5x128: the soaks' learners at the flagship width; 8x17x16:
    # a 2x2 reuse step's minibatch in the hero-pool run and the 5v5 grader;
    # 16x9x16, 32x17x64, 64x17x32: the A/B twins' learners (overlap parity
    # and throughput, the wire-quant and pack-scale closed loops)
    [(256, 17, 128), (128, 17, 128), (37, 17, 128), (5, 3, 32), (3, 1, 64), (9, 4, 256), (21, 5, 48), (4, 3, 40), (2, 2, 1024),
     (16, 17, 16), (16, 9, 128), (8, 9, 128), (8, 5, 128), (8, 17, 16), (16, 9, 16), (32, 17, 64), (64, 17, 32)],
)
def test_kernel_matches_scan(cuda, dtype, B, T, H):
    ins = inputs(B, T, H, dtype, cuda)
    before = L.LAUNCHES
    with torch.no_grad():
        got = L.lstm_kernel(*ins)
        ref = L.lstm_scan(*ins)
    torch.cuda.synchronize()
    assert L.LAUNCHES == before + 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_are_bitwise_invariant(cuda, dtype):
    """A row's outputs do not depend on the launch it is in: B=256 vs the
    row alone (B=1) and vs the row among others in a B=37 launch."""
    x_proj, w_h, c0, h0 = inputs(256, 17, 128, dtype, cuda, seed=5)
    idx = list(range(40, 77))
    idx[3], idx[20], idx[36] = 255, 0, 17
    sel = torch.tensor(idx, device=cuda)
    with torch.no_grad():
        full = L.lstm_kernel(x_proj, w_h, c0, h0)
        mixed = L.lstm_kernel(x_proj[sel], w_h, c0[sel], h0[sel])
        for r in (0, 17, 255):
            alone = L.lstm_kernel(x_proj[r : r + 1], w_h, c0[r : r + 1], h0[r : r + 1])
            for f, a, m in zip(full, alone, mixed):
                assert torch.equal(f[r], a[0])
                assert torch.equal(f[r], m[idx.index(r)])


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "cluster_mma"), (torch.float32, "cluster_ffma")])
@pytest.mark.parametrize("B", [256, 37])
def test_flagship_shapes_run_the_cluster_design(cuda, dtype, design, B):
    geo = L.kernel_geometry(B, 128, dtype, cuda)
    assert geo.design == design and geo.cluster == 8 and geo.rows == 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_misaligned_inputs(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary give the same bits
    as aligned copies (the wrapper re-homes W_h; x_proj is read in place)."""
    ins = inputs(37, 5, 128, dtype, cuda, seed=6)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    x_proj, w_h, c0, h0 = ins
    with torch.no_grad():
        want = L.lstm_kernel(*ins)
        got = L.lstm_kernel(shifted(x_proj), shifted(w_h), shifted(c0), shifted(h0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_auto_dispatch_launches_kernel(cuda):
    ins = inputs(8, 5, 128, torch.bfloat16, cuda)
    before = L.LAUNCHES
    with torch.no_grad():
        L.lstm_recurrence(*ins)
    assert L.LAUNCHES == before + 1


def test_kernel_refuses_grad(cuda):
    """The raw launch stays forward-only; gradients go through LSTMRecurrence."""
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.float32, cuda)
    w_h.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        L.lstm_kernel(x_proj, w_h, c0, h0)


def _grads(impl, ins, cot):
    ins = [x.detach().clone().requires_grad_() for x in ins]
    h_seq, (c_T, h_T) = L.lstm_recurrence(*ins, impl=impl)
    torch.autograd.backward([h_seq, c_T, h_T], list(cot))
    return [x.grad for x in ins]


# Gradients through the kernel forward vs through the plain forward, both
# with the recompute backward: the backward recomputes z from the saved
# h/c, so it inherits the forward's differences (TOL) and carries them
# through 17 reverse steps; as a share of each gradient's largest value.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [256, 128, 37])
def test_kernel_gradients_match_the_plain_forward(cuda, dtype, B):
    ins = inputs(B, 17, 128, dtype, cuda, seed=7)
    g = torch.Generator().manual_seed(8)
    cot = [torch.randn(B, 17, 128, generator=g).to(cuda), *(torch.randn(B, 128, generator=g).to(cuda) for _ in range(2))]
    before = L.LAUNCHES
    got = _grads("kernel", ins, cot)
    assert L.LAUNCHES == before + 1
    want = _grads("scan_recompute", ins, cot)
    for a, b, x in zip(got, want, ins):
        assert a.dtype == b.dtype == x.dtype and a.shape == x.shape and torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= GRAD_TOL[dtype] * b.float().abs().max().item()


def test_auto_dispatch_is_differentiable_through_the_kernel(cuda):
    x_proj, w_h, c0, h0 = inputs(8, 5, 128, torch.bfloat16, cuda)
    w_h.requires_grad_(True)
    before = L.LAUNCHES
    h_seq, (c_T, h_T) = L.lstm_recurrence(x_proj, w_h, c0, h0)
    (h_seq.sum() + c_T.sum()).backward()
    assert L.LAUNCHES == before + 1
    assert w_h.grad is not None and w_h.grad.dtype == torch.bfloat16 and torch.isfinite(w_h.grad.float()).all()


def test_single_train_step_on_the_card_matches_the_plain_arm(cuda):
    """A small learner, one step through the kernel and one through the
    plain forward, from the same start: metrics within the learner
    forward's bf16 tolerance, Adam's mu and nu leaf by leaf within the
    recurrence gradients' bf16 tolerance (nu twice), params within lr/2
    (the reasons are chip_smoke.py's)."""
    import dataclasses

    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.parallel import train_step as ts
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
    from dotaclient_tpu_torch.transport.params import named_params

    cfg = LearnerConfig(batch_size=32, seq_len=8, policy=PolicyConfig(unit_embed_dim=64, lstm_hidden=128, mlp_hidden=64))
    plain = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, lstm_impl="scan_recompute"))
    out = []
    for c in (cfg, plain):
        step, io = ts.build_single_train_step(c, cuda)
        payload = io.consume(*io.transfer(io.pack_transfer(cast_obs_to_compute_dtype(c, make_train_batch(c, 0)))))
        before = L.LAUNCHES
        state, metrics = step(ts.init_train_state(c, cuda), payload)
        out.append((state, metrics, L.LAUNCHES - before))
    (sk, mk, nk), (sp, mp, np_) = out
    assert (nk, np_) == (1, 0)
    for k in mk:
        assert torch.isfinite(mk[k]) and abs(mk[k].item() - mp[k].item()) <= 5e-3 * (1 + abs(mp[k].item())), k
    for name, tol in (("mu", GRAD_TOL[torch.bfloat16]), ("nu", 2 * GRAD_TOL[torch.bfloat16])):
        mk, mp = getattr(sk.opt_state, name), getattr(sp.opt_state, name)
        for n in mp:
            assert (mk[n] - mp[n]).abs().max().item() <= tol * mp[n].abs().max().item(), (name, n)
    for (_, a), (_, b) in zip(named_params(sk.net), named_params(sp.net)):
        assert abs(a - b).max() <= 0.5 * cfg.ppo.lr


def test_kernel_rejects_bad_inputs(cuda):
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.bfloat16, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="w_h"):
            L.lstm_kernel(x_proj, w_h.float(), c0, h0)
        with pytest.raises(ValueError, match="contiguous"):
            L.lstm_kernel(x_proj.transpose(0, 1).contiguous().transpose(0, 1), w_h, c0, h0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            L.lstm_kernel(x_proj.half(), w_h.half(), c0, h0)


# ------------------------------------------------------------ learner loop


def _loop_cfg(**kw):
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig

    return LearnerConfig(batch_size=16, seq_len=8, policy=PolicyConfig(unit_embed_dim=64, lstm_hidden=128, mlp_hidden=64), **kw)


def _frames(cfg, n_batches, seed0=0):
    """DTR1 frames of each row's real length, every third one cast to a
    bf16 DTR3 frame at the source."""
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.transport import serialize as S

    out = []
    for k in range(n_batches):
        b = make_train_batch(cfg, seed0 + k)
        for i in range(cfg.batch_size):
            L = int(b.mask[i].sum())
            r = S.Rollout(obs=F.Observation(*(x[i, : L + 1] for x in b.obs)), actions=Action(*(a[i, :L] for a in b.actions)),
                          behavior_logp=b.behavior_logp[i, :L], behavior_value=b.behavior_value[i, :L],
                          rewards=b.rewards[i, :L], dones=b.dones[i, :L],
                          initial_state=(b.initial_state[0][i], b.initial_state[1][i]), version=0, actor_id=i)
            out.append(S.serialize_rollout(S.cast_rollout_obs_bf16(r) if i % 3 == 2 else r))
    return out


def _ios(cfg, cuda):
    from dotaclient_tpu_torch.ops.batch import zeros_train_batch
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype

    p = cfg.policy
    template = cast_obs_to_compute_dtype(cfg, zeros_train_batch(cfg.batch_size, cfg.seq_len, p.lstm_hidden, p.aux_heads))
    return FusedBatchIO(template, cuda), FusedBatchIO(template, "cpu")


def test_native_packer_equals_the_python_packer(cuda):
    from dotaclient_tpu_torch import native
    from dotaclient_tpu_torch.runtime.staging import fill_rollouts
    from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

    cfg = _loop_cfg()
    io, _ = _ios(cfg, cuda)
    frames = _frames(cfg, 1)
    (buf_n, out_n), (buf_p, out_p) = io.alloc_transfer(), io.alloc_transfer()
    assert buf_n.is_pinned() and buf_p.is_pinned()
    native.pack_frames(native.load_packer(), frames, cfg.seq_len, cfg.policy.lstm_hidden, False, True, out_n)
    fill_rollouts(out_p, [deserialize_rollout(f) for f in frames], cfg.seq_len)
    assert torch.equal(buf_n, buf_p)


def test_side_stream_transfer_unpacks_to_the_cpu_batch(cuda):
    """Packed into pinned memory, copied on the io's side stream, waited
    for by the current stream and unpacked on the card: every leaf equals
    the same buffer unpacked on the CPU."""
    from dotaclient_tpu_torch import native
    from dotaclient_tpu_torch.ops.batch import tree_flatten

    cfg = _loop_cfg()
    io, io_cpu = _ios(cfg, cuda)
    buf, out = io.alloc_transfer()
    native.pack_frames(native.load_packer(), _frames(cfg, 1, seed0=3), cfg.seq_len, cfg.policy.lstm_hidden, False, True, out)
    payload, ready = io.transfer(buf)
    assert isinstance(ready, torch.cuda.Event) and payload.device.type == "cuda"
    got = tree_flatten(io.unpack_single(io.consume(payload, ready)))[0]
    want = tree_flatten(io_cpu.unpack_single(buf))[0]
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_learner_loop_launches_the_kernel_once_per_step(cuda, tmp_path):
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport import memory as M
    from dotaclient_tpu_torch.transport.params import named_params
    from dotaclient_tpu_torch.transport.serialize import deserialize_weights

    cfg = _loop_cfg(log_dir=str(tmp_path), metrics_every=3)
    M.reset("cuda_loop")
    for f in _frames(cfg, 3):
        M.MemoryBroker("cuda_loop").publish_experience(f)
    watcher = M.MemoryBroker("cuda_loop")
    learner = Learner(cfg, M.MemoryBroker("cuda_loop"), cuda)
    before = L.LAUNCHES
    try:
        assert learner.run(num_steps=3, batch_timeout=30.0, max_idle=3) == 3
    finally:
        learner.close()
    assert L.LAUNCHES - before == 3
    named, version, _ = deserialize_weights(watcher.poll_weights())
    assert version == 3 and all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(named, named_params(learner.state.net)))
    assert learner.staging.stats()["consumer_errors"] == 0


def test_learner_incarnations_term_then_kill_on_the_card(cuda):
    """chaos/controller.py's LearnerIncarnations on the card, as the resume
    soak's part B drives them (dotaclient_tpu_torch/scripts/resume_soak.py):
    real actors over tcp:// while a ScheduleRunner drains one life with
    SIGTERM and kills the next; both recover in budget, every life's intake
    balances, no popped frame is unaccounted, and the learners' threads
    launch the recurrence once per step while the actors' launch none."""
    import chip_smoke
    from dotaclient_tpu_torch.scripts import resume_soak as R

    args = R.cut_args()
    with chip_smoke.launches_by_thread() as by_thread:
        b = R.run_part_b(args, _loop_cfg().policy)
    assert [k["sig"] for k in b["kills"]] == ["term", "kill"] and len(b["lives"]) == 3
    assert all(k["recovery_s"] is not None and k["recovery_s"] < args.recovery_budget_s for k in b["kills"])
    assert b["conservation"]["unaccounted_frames"] == 0 and not any(b["conservation"]["intake_balances"])
    assert chip_smoke.soak_launch_split(by_thread) == (R.part_b_steps(b), 0) and R.part_b_steps(b) > 0


def _soak_policy():
    return _loop_cfg().policy


def test_resume_soak_on_the_card(cuda):
    """The resume soak's twin as phase 21 runs it, at a 64/128/64 policy:
    part A bit-exact after the drain (the drained state restored bitwise),
    the kill life at the published high-water, part B's term and kill,
    part C inert; one launch per learner step (chip_smoke raises on any)."""
    import chip_smoke

    res = chip_smoke._soak_resume(_soak_policy())
    assert res["verdict"]["sigterm_resume_bit_exact"] and res["term"]["restore_bitwise"]
    assert res["kill"]["published_hwm"] == res["kill"]["resumed_at_version"] and res["part_c"]["ok"]
    assert res["launches"] == res["steps"] > 0 and res["launches_other_threads"] == 0


def test_fabric_soak_on_the_card(cuda):
    """The broker-fabric soak's twin: shard kills and a rolling restart
    with every generation exact, the resurrection fenced, learner B
    bit-exact across its drain and restart on the card."""
    import chip_smoke

    from dotaclient_tpu_torch.scripts.soak_broker_fabric import HOST_BOUND_VERDICTS

    res = chip_smoke._soak_fabric(_soak_policy())
    held = {k: v for k, v in res["verdict"].items() if k not in HOST_BOUND_VERDICTS}
    assert all((v is True) if isinstance(v, bool) else (v == 0) for v in held.values()), res["verdict"]
    assert res["two_learner"]["bit_exact"]
    assert res["launches"] == res["steps"] > 0 and res["launches_other_threads"] == 0


@pytest.mark.parametrize("name", ["chaos", "handoff"])
def test_serve_soaks_on_the_card(cuda, name):
    """The serve chaos and serve handoff soaks' twins with servers, the
    learner and the fallback on the card (the fleets' envs in process):
    every verdict true, the parity prefix (chaos) or the whole stream
    (handoff) bitwise, launches only on the learner's thread."""
    import chip_smoke

    res = chip_smoke._soak_serve(name, _soak_policy())
    assert all(v for v in res["verdict"].values() if isinstance(v, bool)) and res["unaccounted"] == [0]
    assert res["launches"] == res["steps"] > 0 and res["launches_other_threads"] == 0


def test_fleet_obs_soak_leaves_its_process_without_a_cuda_context(cuda):
    """The fleet telemetry soak's twin as phase 22 runs it, in a process of
    its own: every verdict true, 0 unaccounted, no launch, and no CUDA
    context at its end (chip_smoke raises otherwise)."""
    import os
    import subprocess
    import sys

    import chip_smoke

    proc = subprocess.run([sys.executable, chip_smoke.__file__, "--soak", "fleet_obs"], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(chip_smoke.__file__),
                          env=dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    res = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("soak fleet_obs {"))[15:])
    assert res["cuda_initialized"] is False and res["launches"] == res["steps"] == 0
    assert res["fenced"] == res["resident_at_kill"] > 0 and res["polls_theft_to_flag"] <= 2


def test_autoscale_soak_serves_from_the_card(cuda):
    """The autoscale soak's twin with its serve replicas on the card: serve
    and broker 2→4→2, the actor pool up and back, no abandoned episode, no
    recurrence launch (the replicas' T=1 steps are torch ops)."""
    import chip_smoke

    res = chip_smoke._soak_autoscale(_soak_policy())
    assert all(v for v in res["verdict"].values() if isinstance(v, bool)) and not any(res["unaccounted"])
    assert res["paths"]["server"] == [2, 4, 2] and res["abandoned"] == 0
    assert res["launches"] == res["steps"] == 0


def test_obs_smoke_launches_once_per_learner_step_on_the_card(cuda):
    """The obs smoke's twin on the card: `ok` (POST /profile answered
    through CUPTI), fleetd's audit at 0 unaccounted, one recurrence launch
    per learner step, all on the learner's thread."""
    import chip_smoke

    res = chip_smoke._soak_obs_smoke(_soak_policy())
    assert res["verdict"]["ok"] and res["unaccounted"] == [0.0] and res["profile_error"] is None
    assert res["launches"] == res["steps"] == 20 and res["launches_other_threads"] == 0


@pytest.mark.parametrize("name", ["train_league", "hero_pool", "grade_5v5"])
def test_ladder_training_runs_on_the_card(cuda, name):
    """The league run, the hero-pool run and the 5v5 grader as phase 23 runs
    them, cut: the result agrees with the exit code and with the recorded
    numbers by the reference's rule, the reference's summary fields, one
    launch per learner step plus one per reuse update, none in the
    evaluator or the grader (chip_smoke raises otherwise)."""
    import chip_smoke

    res = chip_smoke.SOAKS[name](None)
    assert all(res["verdict"].values()) and res["dead"] == 0 and res["rc"] in (0, 1)
    assert res["launches"] == res["steps"] + res["ppo_updates"] and res["launches_other_threads"] == 0
    assert res["steps"] == res["updates"] > 0


def test_league_soak_on_the_card(cuda):
    """The league soak's twin with its multi-model server and its actors on
    the card: every verdict true through two rolling restarts, no launch."""
    import chip_smoke

    res = chip_smoke._soak_league(_soak_policy())
    assert all(res["verdict"].values()) and res["kills"] == 2 and res["promotions"] >= 1
    assert res["launches"] == res["steps"] == 0


def test_wire_soak_on_the_card(cuda):
    """The bf16-wire soak's twin with its learner and actors on the card:
    `ok`, the bytes ratio in band, one launch per learner step."""
    import chip_smoke

    res = chip_smoke._soak_wire(_soak_policy())
    assert res["verdict"]["ok"] and 0.4 <= res["ratio"] <= 0.8 and not any(res["unaccounted"])
    assert res["launches"] == res["steps"] > 0 and res["launches_other_threads"] == 0


def test_aggregate_soak_on_the_card(cuda):
    """The aggregate soak's twin cut as phase 23 runs it, phase B's learner
    on the card at the flagship policy and batch: every replayer reporting,
    every process heard, 0 bad frames, one launch per learner step."""
    import chip_smoke

    res = chip_smoke._soak_aggregate()
    assert res["verdict"]["closed_loop_live"] and res["unaccounted"] == [0, 0]
    assert res["launches"] == res["steps"] > 1 and res["launches_other_threads"] == 0


@pytest.mark.parametrize("name", ["ab_wire_quant", "ab_pack_scale", "ab_inet_pack", "ab_overlap", "ab_cast",
                                  "ab_ppo_reuse", "ab_replay"])
def test_ab_twin_on_the_card(cuda, name):
    """Each A/B twin at its smoke cut as phase 24 runs it: every bar held
    but a host-bound one its probe armed and the host missed (left out by
    name) and the learning bars (chance at a cut), the exit code agreeing
    with the verdict, launches = steps + reuse updates on the learner
    thread alone."""
    import chip_smoke

    res = chip_smoke.SOAKS[name](None)
    held = {k: v for k, v in res["verdict"].items() if isinstance(v, bool) and k not in res["left_out"]}
    assert all(held.values()), res["verdict"]
    assert res["launches"] == res["steps"] + res["ppo_updates"] and res["launches_other_threads"] == 0
    assert (res["steps"] > 0) == (name != "ab_inet_pack")


def test_a_ring_slot_goes_back_only_after_its_copy_retired(cuda):
    """A one-slot ring while the side stream is held up: the copy of
    batch A has not run when the next fetch wants the slot, so the lease
    reaper waits for A's copy event before the slot is re-zeroed and
    packed with batch B. The device batch is A's bytes, not B's or zeros."""
    from dotaclient_tpu_torch import native
    from dotaclient_tpu_torch.runtime.learner import _LeaseReaper

    cfg = _loop_cfg()
    io, _ = _ios(cfg, cuda)
    ring, reaper, lib = io.make_ring(1), _LeaseReaper(), native.load_packer()
    pack = lambda slot, seed: native.pack_frames(lib, _frames(cfg, 1, seed0=seed), cfg.seq_len, cfg.policy.lstm_hidden,
                                                 False, True, slot.batch)
    slot = ring.acquire(timeout=1)
    pack(slot, 11)
    want_a = slot.payload.clone()
    with torch.cuda.stream(io._stream):
        torch.cuda._sleep(int(3e8))  # the side stream is busy for a while: A's copy waits behind it
    payload, ready = io.transfer(slot.payload)
    reaper.hold(slot, ready)
    assert not ready.query()  # the copy has not retired yet
    reaper.reap(ring.depth)  # every slot is held: waits for A's copy, then releases
    assert ready.query()
    again = ring.acquire(timeout=1)
    assert again is slot
    pack(again, 12)
    assert not torch.equal(again.payload, want_a)
    got = io.consume(payload, ready).cpu()
    assert torch.equal(got, want_a)


def test_the_ring_learner_trains_bitwise_the_classic_one(cuda, tmp_path):
    """pack_workers 4 over a one-slot ring vs the classic fresh buffer per
    batch, both loops: the same params, one kernel launch per step."""
    import dataclasses

    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport import memory as M
    from dotaclient_tpu_torch.transport.params import named_params

    frames = _frames(_loop_cfg(), 4, seed0=20)
    out = {}
    for workers, prefetch in ((1, True), (4, True), (4, False)):
        cfg = _loop_cfg()
        cfg.staging = dataclasses.replace(cfg.staging, pack_workers=workers, transfer_depth=1)
        cfg.learner.prefetch = prefetch
        name = f"cuda_ring_{workers}_{prefetch}"
        M.reset(name)
        for f in frames:
            M.MemoryBroker(name).publish_experience(f)
        learner = Learner(cfg, M.MemoryBroker(name), cuda)
        before = L.LAUNCHES
        try:
            assert learner.run(num_steps=4, batch_timeout=30.0, max_idle=3) == 4
        finally:
            learner.close()
        assert L.LAUNCHES - before == 4
        out[(workers, prefetch)] = [a.tobytes() for _, a in named_params(learner.state.net)]
    assert out[(1, True)] == out[(4, True)] == out[(4, False)]


def test_the_phase_fence_waits_for_the_loop_stream_only(cuda):
    """fence() returns once the work on the current stream is done, not
    behind a side stream's (the prefetch copy's) queue."""
    from dotaclient_tpu_torch.obs.compute import fence

    side = torch.cuda.Stream(cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e9))  # long: the side stream stays busy
    busy = torch.cuda.Event()
    busy.record(side)
    torch.cuda._sleep(int(5e7))  # short, on the current stream
    step = torch.cuda.Event()
    step.record()
    fence(cuda)
    assert step.query()  # the loop stream's work is done
    assert not busy.query()  # and the side stream's was not waited for
    torch.cuda.synchronize()


def test_a_profile_capture_names_the_recurrence_kernel(cuda, tmp_path):
    """torch.profiler started on another thread than the one launching:
    the trace holds that thread's device kernels, the recurrence kernel by
    name; a window with no device work is an error, not an empty trace."""
    import threading

    from dotaclient_tpu_torch.obs.compute import ProfileCapture, trace_kernel_names

    ins = inputs(256, 17, 128, torch.bfloat16, cuda)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            with torch.no_grad():
                L.lstm_kernel(*ins)
            torch.cuda.synchronize()

    cap = ProfileCapture(str(tmp_path), max_seconds=2.0, device=cuda)
    t = threading.Thread(target=loop)
    t.start()
    try:
        time.sleep(0.2)
        path, seconds = cap.capture(0.5)
    finally:
        stop.set()
        t.join(timeout=10)
    names = trace_kernel_names(f"{path}/trace.json")
    assert seconds == 0.5 and any("lstm_" in n for n in names)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="no device kernel"):
        cap.capture(0.2)


def _serve_obs(rs):
    from dotaclient_tpu_torch.env import featurizer as F

    mask = rs.rand(F.N_ACTION_TYPES) > 0.3
    mask[0] = True
    return F.Observation(rs.randn(F.GLOBAL_FEATURES).astype("float32"), rs.randn(F.HERO_FEATURES).astype("float32"),
                         rs.randn(F.MAX_UNITS, F.UNIT_FEATURES).astype("float32"), rs.rand(F.MAX_UNITS) > 0.3,
                         rs.rand(F.MAX_UNITS) > 0.3, mask)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batched_key_step_rows_are_bitwise_the_single_key_step(cuda, dtype):
    """The serve tick at the flagship width on the card: every row of 16 is
    its standalone key step, bit for bit."""
    import numpy as np

    from dotaclient_tpu_torch.config import PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops.batch import as_tensors
    from dotaclient_tpu_torch.runtime.actor import make_batched_key_actor_step, make_key_actor_step

    cfg = PolicyConfig(dtype=dtype)
    net = P.init_params(cfg, torch.Generator().manual_seed(1), cuda)
    rs = np.random.RandomState(0)
    obs = as_tensors(F.stack([_serve_obs(rs) for _ in range(16)]), cuda)
    state = tuple(torch.randn(16, cfg.lstm_hidden, generator=torch.Generator().manual_seed(2)).to(cuda) for _ in range(2))
    keys = np.stack([np.array([0, k], np.uint32) for k in range(16)])
    before = L.LAUNCHES
    (c, h), action, logp, value, keys2 = make_batched_key_actor_step(cfg)(net, state, obs, keys)
    single = make_key_actor_step(cfg)
    for i in (0, 7, 15):
        row = lambda x: x[i : i + 1].clone()  # noqa: E731
        (c1, h1), a1, lp1, v1, k1 = single(net, tuple(map(row, state)), F.Observation(*map(row, obs)), keys[i])
        assert (k1 == keys2[i]).all()
        for x1, xb in zip((c1, h1, *a1, lp1, v1), (c, h, *action, logp, value)):
            assert torch.equal(x1, xb[i : i + 1])
    assert L.LAUNCHES == before  # the T=1 cell runs no recurrence kernel


def test_served_rows_are_bitwise_the_standalone_key_step(cuda):
    """The port's InferenceServer on the card, stepped over the port's serve
    wire by 3 concurrent sessions (one tick): each reply is the standalone
    key step replayed on the card, and the carries stay on the card."""
    import asyncio
    import struct

    import numpy as np

    from dotaclient_tpu_torch.config import InferenceConfig, PolicyConfig, ServeConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops.batch import as_tensors
    from dotaclient_tpu_torch.runtime.actor import make_key_actor_step
    from dotaclient_tpu_torch.serve import wire as W
    from dotaclient_tpu_torch.serve.server import InferenceServer

    cfg = PolicyConfig(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)
    server = InferenceServer(InferenceConfig(serve=ServeConfig(port=0, max_batch=4, gather_window_s=0.2), policy=cfg),
                             device=cuda).start()

    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(W.frame(W.S_INFO, b""))
        await W.read_frame(reader)
        out = {}
        for t in range(3):
            for k in range(3):
                obs = _serve_obs(np.random.RandomState([k, t]))
                key = np.array([0, k], np.uint32) if t == 0 else out[k][-1][1].rng
                writer.write(W.frame(W.S_STEP, W.encode_step_request(k, obs, key, episode_start=t == 0, want_carry=True)))
                out.setdefault(k, []).append((obs, None, key))
            await writer.drain()
            for _ in range(3):
                _, payload = await W.read_frame(reader)
                r = W.decode_step_response(payload, cfg.lstm_hidden)
                obs, _, key = out[r.client_key][-1]
                out[r.client_key][-1] = (obs, r, key)
        carries = [dict(c.carries) for c in list(server._conns)]
        writer.close()
        return out, carries

    try:
        out, conn_carries = asyncio.run(asyncio.wait_for(go(), 120))
        net = server.params
    finally:
        server.stop()
    step = make_key_actor_step(cfg)
    for k, rows in out.items():
        state = P.initial_state(cfg, (1,), cuda)
        for obs, r, key in rows:
            assert r.status == W.OK
            state, action, logp, value, key2 = step(net, state, as_tensors(F.stack([obs]), cuda), key)
            assert (r.rng == key2).all() and list(r.action) == [int(a.item()) for a in action]
            assert struct.pack("<ff", r.logp, r.value) == struct.pack("<ff", logp.item(), value.item())
            assert r.carry[0].tobytes() == state[0][0].cpu().numpy().tobytes()
            assert r.carry[1].tobytes() == state[1][0].cpu().numpy().tobytes()
    assert sum(len(c) for c in conn_carries) == 3
    assert all(c.device == cuda for carries in conn_carries for pair in carries.values() for c in pair)


def test_server_binary_serves_on_the_card_by_default(cuda):
    """`python -m dotaclient_tpu_torch.serve.server --serve.port 0
    --broker_url tcp://…` with no --platform: the card; its one stdout line
    is the ready line with the bound port, and it answers S_INFO."""
    import json
    import socket
    import struct
    import subprocess
    import sys
    from pathlib import Path

    from dotaclient_tpu_torch.serve import wire as W

    root = Path(__file__).resolve().parents[1]
    broker = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.transport.tcp_server", "--port", "0",
                               "--host", "127.0.0.1"], cwd=root, stdout=subprocess.PIPE, text=True)
    server = None
    try:
        port = int(broker.stdout.readline().split(":")[1].split()[0])
        server = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.serve.server", "--serve.port", "0",
                                   "--broker_url", f"tcp://127.0.0.1:{port}"], cwd=root, stdout=subprocess.PIPE,
                                  text=True)
        ready = json.loads(server.stdout.readline())
        assert ready["serving"] is True and ready["port"] > 0
        with socket.create_connection(("127.0.0.1", ready["port"]), timeout=30) as s:
            s.sendall(W.frame(W.S_INFO, b""))
            buf = s.makefile("rb")
            n, mtype = struct.unpack("<IB", buf.read(5))
            info = json.loads(buf.read(n))
        assert mtype == W.R_INFO and info["lstm_hidden"] == 128 and info["max_batch"] == 16
    finally:
        for p in (server, broker):
            if p is not None:
                p.terminate()
                p.wait(timeout=30)


# ------------------------------------------------------------ transformer family

# Step vs unroll at full width on the card: the same ops at [B, 1] and
# [B, T] shapes, summed by cuBLAS in other orders; in bf16 a last-bit
# difference can flip one bf16 rounding of an activation (as chip_smoke.py
# phase 12).
TF_STEP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_steps_reproduce_the_unroll(cuda, dtype):
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch

    cfg = PolicyConfig(arch="transformer", dtype=dtype)
    net = P.init_params(cfg, torch.Generator().manual_seed(3), cuda)
    obs = as_tensors(make_train_batch(LearnerConfig(batch_size=64, seq_len=16, policy=cfg), 3).obs, cuda)
    state, values, type_logp = P.initial_state(cfg, (64,), cuda), [], []
    with torch.no_grad():
        _, out = net(state, obs, unroll=True)
        for t in range(17):
            state, o = net(state, F.Observation(*(x[:, t] for x in obs)))
            values.append(o.value)
            type_logp.append(o.dist.type_logp)
    tol = TF_STEP_TOL[dtype]
    assert (torch.stack(values, 1) - out.value).abs().max().item() <= tol
    assert (torch.stack(type_logp, 1) - out.dist.type_logp).abs().max().item() <= tol
    assert state.idx.tolist() == [17] * 64 and state.k.device == cuda


def test_transformer_blockwise_unroll_matches_dense(cuda):
    """tf_attn_block 64 over 128 frames against dense attention, f32 (TF32
    off): the streaming softmax sums in another order."""
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch
    from dotaclient_tpu_torch.transport.params import load_named, named_params

    cfg = PolicyConfig(arch="transformer", dtype="float32", tf_context=128)
    dense = P.init_params(cfg, torch.Generator().manual_seed(4), cuda)
    block = load_named(P.PolicyNet(PolicyConfig(arch="transformer", dtype="float32", tf_context=128, tf_attn_block=64),
                                   cuda), named_params(dense))
    obs = as_tensors(make_train_batch(LearnerConfig(batch_size=8, seq_len=127, policy=cfg), 4).obs, cuda)
    zeros = P.initial_state(cfg, (8,), cuda)
    with torch.no_grad():
        _, a = dense(zeros, obs, unroll=True)
        _, b = block(zeros, obs, unroll=True)
    for x, y in zip((*a.dist, a.value), (*b.dist, b.value)):
        assert (x - y).abs().max().item() <= 1e-4


def test_transformer_batched_key_step_rows_match_single_step(cuda):
    import numpy as np

    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.models.transformer_policy import KVCache
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch
    from dotaclient_tpu_torch.runtime.actor import make_batched_key_actor_step, make_key_actor_step

    cfg = PolicyConfig(arch="transformer")
    net = P.init_params(cfg, torch.Generator().manual_seed(5), cuda)
    M = 16
    obs = as_tensors(make_train_batch(LearnerConfig(batch_size=M, seq_len=2, policy=cfg), 5).obs, cuda)
    step, single = make_batched_key_actor_step(cfg), make_key_actor_step(cfg)
    keys = np.stack([np.array([1, 900 + i], np.uint32) for i in range(M)])
    state = P.initial_state(cfg, (M,), cuda)
    for t in range(2):
        o = F.Observation(*(x[:, t] for x in obs))
        new, action, logp, value, keys2 = step(net, state, o, keys)
        assert isinstance(new, KVCache)
        for i in range(M):
            s1, a1, l1, v1, k1 = single(net, KVCache(*(x[i : i + 1].clone() for x in state)),
                                        F.Observation(*(x[i : i + 1].clone() for x in o)), keys[i])
            assert all(torch.equal(x[i : i + 1], y) for x, y in zip(new, s1))
            assert all(torch.equal(x[i : i + 1], y) for x, y in zip(action, a1))
            assert torch.equal(logp[i : i + 1], l1) and torch.equal(value[i : i + 1], v1) and np.array_equal(keys2[i], k1)
        state, keys = new, keys2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vector_actor_frames_on_the_card_are_the_standalone_actors(cuda, dtype):
    """The fleet contract on the card: every frame env slot j of a
    VectorActor publishes (flagship width) is byte for byte the frame of a
    standalone Actor with id actor_id*M + j, on the port's fake env."""
    import asyncio

    from dotaclient_tpu_torch.config import ActorConfig, PolicyConfig
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor, VectorActor
    from dotaclient_tpu_torch.transport import memory as tmem
    from dotaclient_tpu_torch.transport.serialize import peek_rollout_actor_id

    cfg = ActorConfig(policy=PolicyConfig(dtype=dtype), max_dota_time=30.0, rollout_len=8, seed=3)
    M, svc = 3, FakeDotaService()
    for hub in ("cuda_fleet", "cuda_single"):
        tmem.reset(hub)
    vec = VectorActor(cfg, tmem.MemoryBroker("cuda_fleet"), actor_id=2, envs=M,
                      stubs=[LocalDotaServiceStub(svc) for _ in range(M)])
    assert vec.envs[0].device.type == "cuda"  # ActorConfig.platform "" is the card
    asyncio.run(vec.run_episodes(2))
    for j in range(M):
        asyncio.run(Actor(cfg, tmem.MemoryBroker("cuda_single"), actor_id=2 * M + j,
                          stub=LocalDotaServiceStub(svc)).run(num_episodes=2))

    def by_actor(hub):
        out = {}
        for f in tmem.MemoryBroker(hub).consume_experience(100000, timeout=0.05):
            out.setdefault(peek_rollout_actor_id(f), []).append(f)
        return out

    fleet, single = by_actor("cuda_fleet"), by_actor("cuda_single")
    assert sorted(fleet) == sorted(single) == [6, 7, 8]
    for aid in single:
        assert fleet[aid] == single[aid] and len(single[aid]) >= 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("team_size", [1, 5])
def test_selfplay_batched_step_rows_are_bitwise_their_b1_rows(cuda, dtype, team_size):
    """SelfPlayActor._batched_step on the card (flagship width): one call
    for the 2 * team_size mirror heroes; each hero's state, action, logp
    and value bitwise the B=1 group step on its own inputs with its row of
    the group's uniforms, and the actor's key advanced once."""
    import numpy as np

    from dotaclient_tpu_torch.config import ActorConfig, PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops import action_dist as ad
    from dotaclient_tpu_torch.ops import threefry
    from dotaclient_tpu_torch.ops.batch import as_tensors
    from dotaclient_tpu_torch.runtime import actor as A
    from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor, _Side
    from dotaclient_tpu_torch.transport import memory as tmem

    cfg = ActorConfig(policy=PolicyConfig(dtype=dtype), opponent="self", team_size=team_size, seed=5)
    actor = SelfPlayActor(cfg, tmem.MemoryBroker("cuda_sp"), actor_id=1)
    assert actor.device.type == "cuda"
    rs = np.random.RandomState(team_size)
    group = []
    for i in range(2 * team_size):
        s = _Side(i, 2 if i < team_size else 3, cfg, actor.device)
        o = F.zeros_observation()
        mask = rs.rand(F.N_ACTION_TYPES) > 0.3
        mask[0] = True
        s.obs = o._replace(unit_feats=rs.randn(*o.unit_feats.shape).astype(np.float32),
                           hero_feats=rs.randn(*o.hero_feats.shape).astype(np.float32),
                           global_feats=rs.randn(*o.global_feats.shape).astype(np.float32),
                           unit_mask=rs.rand(F.MAX_UNITS) > 0.3, target_mask=rs.rand(F.MAX_UNITS) > 0.3,
                           action_mask=mask)
        s.state = tuple(torch.from_numpy(0.5 * rs.randn(1, 128).astype(np.float32)).to(actor.device) for _ in range(2))
        group.append(s)
    inputs = [(s.state, s.obs) for s in group]
    key = actor.rng.copy()
    actor._batched_step(actor.params, group)
    assert np.array_equal(actor.rng, threefry.split(key, 2)[0])
    sizes = (F.N_ACTION_TYPES, 9, 9, F.MAX_UNITS)
    u = torch.from_numpy(ad.key_uniforms(threefry.split(key, 2)[1], (len(group),), sizes)).to(actor.device)
    for i, (s, (state, obs)) in enumerate(zip(group, inputs)):
        want = A._key_step_row(actor.params, state, as_tensors(F.stack([obs]), actor.device), u[i : i + 1].clone())
        for x, y in zip(s.state, want[0]):
            assert torch.equal(x, y)
        action, logp, value = s._step_record
        acts, floats = A._to_host(want[1], want[2], want[3])
        assert [int(a[0]) for a in action] == acts[0].tolist()
        assert (logp, value) == (float(floats[0, 0]), float(floats[0, 1]))


def test_control_plane_and_fleetd_binaries_watch_a_server_on_the_card(cuda, tmp_path):
    """The two stdlib binaries beside a port inference server on the card:
    the control plane (k8s/control.yaml's policy, static driver) scrapes
    the server's obs surface, fleetd discovers it through the plane's GET
    /topology, and neither process imports torch or numpy (their
    `-X importtime` logs)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import urllib.request

    from dotaclient_tpu_torch.config import InferenceConfig, ObsConfig, PolicyConfig, ServeConfig
    from dotaclient_tpu_torch.obs import ObsRuntime
    from dotaclient_tpu_torch.serve.server import InferenceServer

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    mport, cport = free_port(), free_port()
    obs = ObsRuntime.create(ObsConfig(enabled=True, metrics_port=mport, install_handlers=False), role="serve")
    server = InferenceServer(InferenceConfig(serve=ServeConfig(port=0, max_batch=4), policy=PolicyConfig(),
                                             obs=obs.cfg), obs_runtime=obs).start()
    assert server.device.type == "cuda"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = []

    def start(name, module, args):
        err = open(tmp_path / f"{name}.log", "w")
        procs.append(subprocess.Popen([sys.executable, "-X", "importtime", "-m", module, *args], cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=err, text=True, env=env))
        return json.loads(procs[-1].stdout.readline())

    try:
        ready = start("control", "dotaclient_tpu_torch.control.server", [
            "--control.port", str(cport), "--control.poll_s", "0.5", "--control.driver", "static",
            "--control.policy", "server:serve_load_occupancy.mean,high=0.75,low=0.25,min=2,max=8,cooldown=120",
            "--control.servers", f"127.0.0.1:{mport}", "--obs.enabled", "true", "--obs.metrics_port", "0"])
        assert ready == {"serving": True, "port": cport, "driver": "static", "tiers": ["server"]}
        fready = start("fleetd", "dotaclient_tpu_torch.obs.fleetd", [
            "--fleet.port", "0", "--fleet.poll_s", "0.5", "--fleet.control", f"127.0.0.1:{cport}",
            "--fleet.alerts", "fleet_unaccounted_frames,gt,0,for=3", "--fleet.bundle_dir", str(tmp_path),
            "--obs.enabled", "true", "--obs.metrics_port", "0"])
        deadline, fleet, control = time.time() + 60, {}, {}
        while time.time() < deadline:
            fleet = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{fready['port']}/fleet", timeout=10).read())
            body = urllib.request.urlopen(f"http://127.0.0.1:{cport}/metrics", timeout=10).read().decode()
            control = {ln.split()[0]: float(ln.split()[1]) for ln in body.splitlines() if ln and ln[0] != "#"}
            if fleet.get("targets", {}).get(f"server/127.0.0.1:{mport}", {}).get("up") and \
                    control.get("dotaclient_control_polls_total", 0) >= 2:
                break
            time.sleep(0.2)
        assert fleet["targets"][f"server/127.0.0.1:{mport}"]["up"] is True
        assert control["dotaclient_control_scrape_errors_total"] == 0.0
        assert control["dotaclient_control_scale_ups_total"] == control["dotaclient_control_topology_epoch"] == 0.0
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)
        server.stop()
    for name in ("control", "fleetd"):
        mods = [ln.rsplit("|", 1)[1].strip() for ln in open(tmp_path / f"{name}.log")
                if ln.startswith("import time:") and "|" in ln]
        assert "dotaclient_tpu_torch" in mods
        assert not [m for m in mods if m.split(".")[0] in ("torch", "numpy", "jax")], name


def _modes_base():
    from dotaclient_tpu_torch.config import LearnerConfig

    return LearnerConfig(batch_size=32, seq_len=8, policy=_loop_cfg().policy)


def test_transfer_paths_train_bitwise_the_single_buffer_on_the_card(cuda, tmp_path):
    """chip_smoke.py's phase-17 turn (a) at a small shape: the groups and
    tree learners end bitwise the single buffer's (or within phase 6's
    bounds), one recurrence launch per step, 1 / 4 / one-per-leaf copies."""
    import chip_smoke

    out = chip_smoke._transfer_paths_turn(cuda, "test", str(tmp_path), _modes_base())
    assert [out[p]["copies_per_step"] for p in ("single", "groups")] == [1, 4] and out["tree"]["copies_per_step"] > 4
    assert all(p["launches"] == 2 * chip_smoke.DATA_MODE_STEPS for p in out.values())


def test_replay_learner_on_the_card_restores_its_reservoir_bitwise(cuda, tmp_path):
    """Turn (b): the replay learner replays aged frames (hit ratio within
    replay.ratio), its step holds phase 6's bounds of the plain arm, and a
    full-state restore continues bitwise."""
    import chip_smoke

    out = chip_smoke._replay_turn(cuda, "test", str(tmp_path), _modes_base())
    assert out["rows_replayed"] > 0 and out["launches"] == chip_smoke.REPLAY_STEPS and out["restored_entries"] >= 0


def test_assembled_learner_on_the_card_is_bitwise_the_classic_pack(cuda, tmp_path):
    """Turn (c) with three armed shard processes and four producers: rows
    and params bitwise the classic pack's, each shard's ledger exact, an
    unarmed shard refused."""
    import chip_smoke

    base = _modes_base()
    flags = ["--batch_size", str(base.batch_size), "--seq_len", str(base.seq_len)]
    for k in ("unit_embed_dim", "lstm_hidden", "mlp_hidden", "dtype"):
        flags += [f"--policy.{k}", str(getattr(base.policy, k))]
    out = chip_smoke._assembly_turn(cuda, "test", str(tmp_path), base, producer_flags=flags)
    assert out["rows_checked"] == chip_smoke.ASM_PARITY_STEPS * base.batch_size and len(out["ledgers"]) == 3


def test_amqp_learner_on_the_card_is_bitwise_its_mem_run(cuda, tmp_path):
    """chip_smoke.py's phase-20 turn (a) at a small shape, on the tests'
    in-memory pika: the learner over amqp:// (frames published as it
    trains) bitwise the mem:// learner after every step, one recurrence
    launch per step, and the actor-side poll's DTW2 frame bitwise the
    params."""
    import sys

    import chip_smoke

    fake = chip_smoke.install_fake_pika()
    try:
        out = chip_smoke._amqp_parity_turn(cuda, "test", str(tmp_path), fake, _modes_base())
    finally:
        fake.reset()
        sys.modules.pop("pika", None)
    assert out["bitwise_per_step"] == [True] * chip_smoke.AMQP_STEPS
    assert out["launches"] == out["mem_launches"] == chip_smoke.AMQP_STEPS == out["weights_version"]


def test_two_ranks_on_the_card_step_as_one_process(cuda, tmp_path):
    """Two learner ranks sharing the card over gloo (NCCL refuses two ranks
    on one device), each on its half of the global batch (rank 0's rows
    mostly padding), through tests/torch_multihost_worker.py: both ranks'
    params bitwise equal; the all-reduced gradient and every metric against
    the single-process step on the card at the global batch within f32 1e-4
    of each leaf's largest value (sums in another order; cuBLAS picks its
    algorithm by shape), params within 2e-2·lr per update."""
    import os
    import socket
    import subprocess
    import sys

    import numpy as np

    from dotaclient_tpu_torch.ops import batch as tbatch
    from dotaclient_tpu_torch.ops.clip_adam import ClipAdam
    from dotaclient_tpu_torch.parallel import train_step as ts
    from dotaclient_tpu_torch.transport.params import load_named, named_params

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_multihost_worker as W

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    named = named_params(ts.init_train_state(W.step_config({}), "cpu").net)
    inp = {"param_names": np.array([n for n, _ in named]), **{f"param/{n}": a for n, a in named}}
    batches, perms = {}, {}
    for i, (case, ppo, _) in enumerate(W.STEP_CASES):
        b = tbatch.make_train_batch(W.step_config(ppo), 40 + i)
        mask = b.mask.copy()
        mask[: W.B // 2, 1:] = 0.0
        b = b._replace(mask=mask, rewards=b.rewards * mask, dones=b.dones * mask)
        batches[case] = b
        inp.update({f"{case}/batch/{k}": np.asarray(x) for k, x in enumerate(tbatch.tree_flatten(b)[0])})
        if ppo.get("epochs", 1) > 1:
            perms[case] = [p.numpy() for p in ts.epoch_permutations(W.step_config(ppo), 0, "cpu")]
            inp.update({f"{case}/perm/{e}": p for e, p in enumerate(perms[case])})
    np.savez(tmp_path / "input.npz", **inp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.join(repo, "tests", "torch_multihost_worker.py"), "steps", str(r),
                               "2", str(port), str(tmp_path), "cuda:0"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    a, b = (dict(np.load(tmp_path / f"steps_{r}.npz")) for r in range(2))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    apply = ClipAdam.apply
    for case, ppo, padding in W.STEP_CASES:
        if padding:
            continue
        cfg = W.step_config(ppo)
        state = ts.init_train_state(cfg, cuda)
        load_named(state.net, named)
        seen = []
        ClipAdam.apply = lambda self, p, g, s, seen=seen: (seen.append({n: x.cpu().numpy() for n, x in g.items()}),
                                                            apply(self, p, g, s))[1]
        try:
            args = (perms[case],) if case in perms else ()
            state, metrics = ts.build_train_step(cfg, cuda)(state, tbatch.as_tensors(batches[case], cuda), *args)
        finally:
            ClipAdam.apply = apply
        for k, v in metrics.items():
            got = float(a[f"{case}/metric/{k}"])
            assert abs(got - v.item()) <= 1e-4 * max(1.0, abs(v.item())), (case, k)
        for n, g in seen[0].items():
            assert np.abs(a[f"{case}/grad/{n}"] - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-8), (case, n)
        updates = int(a[f"{case}/updates"])
        for n, p in named_params(state.net):
            assert np.abs(a[f"{case}/param/{n}"] - p).max() <= 2e-2 * cfg.ppo.lr * updates, (case, n)


def test_sanitized_learner_and_server_on_the_card(cuda):
    """Phase 25 at a small width (16 × 8, the soaks' policy): the lint
    process imports no torch, numpy or jax; the pipelined learner with two
    pack workers, the ring and its lease reaper, the publisher, the async
    checkpoint and the watchdog under lockcheck (0 inversions, 0 long
    holds) and under racecheck beside an in-process server whose sessions
    see two hot-swaps (0 races, CUDA events as happens-before edges, every
    reply bitwise its standalone key step); both runs' params and Adam
    state bitwise the run with no monitor (chip_smoke raises otherwise)."""
    from dotaclient_tpu_torch.config import LearnerConfig

    import chip_smoke

    res = chip_smoke.phase_sanitizers(cuda, "test", base=LearnerConfig(batch_size=16, seq_len=8,
                                                                        policy=_soak_policy()))
    assert res["launches"] == res["launches_race"] == chip_smoke.SANITIZER_STEPS
    assert res["lock"]["inversions"] == [] and res["lock"]["over_held"] == []
    assert len(res["versions_served"]) >= chip_smoke.SANITIZER_SWAPS + 1
