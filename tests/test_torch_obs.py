"""The port's learner observability against the reference's obs package:
the FLOPs model, the one-device mesh grammar, the Prometheus rendering,
the step-phase timer (serial and overlap), MFU, the watchdog's verdicts,
trace histograms, the recompile sentinel and the registry, each on the
same inputs; then the scrape surface (/metrics, /healthz, POST /profile)
and a port learner with obs on, whose every logged and scraped name the
registries of both packages know. Tolerances are exact unless stated."""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import pytest

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.config import WatchdogConfig as JWatchdogConfig
from dotaclient_tpu.obs import compute as jcompute
from dotaclient_tpu.obs import registry as jregistry
from dotaclient_tpu.obs.http import render_prometheus as j_render
from dotaclient_tpu.obs.trace import PipelineTracer as JPipelineTracer
from dotaclient_tpu.obs.trace import TraceRef as JTraceRef
from dotaclient_tpu.obs.watchdog import Watchdog as JWatchdog
from dotaclient_tpu.ops import flops as jflops
from dotaclient_tpu.parallel.mesh import parse_mesh_spec as j_parse_mesh_spec
from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PolicyConfig, PPOConfig, WatchdogConfig
from dotaclient_tpu_torch.obs import compute as tcompute
from dotaclient_tpu_torch.obs import cupti as tcupti
from dotaclient_tpu_torch.obs import registry as tregistry
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer, render_prometheus
from dotaclient_tpu_torch.obs.trace import PipelineTracer, TraceRef
from dotaclient_tpu_torch.obs.watchdog import Watchdog
from dotaclient_tpu_torch.ops import flops as tflops
from dotaclient_tpu_torch.parallel.mesh import parse_mesh_spec, resolve_mesh
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.params import named_params
from dotaclient_tpu_torch.transport.serialize import stamp_rollout_trace
from test_torch_learner import B, POL, T, frames_for

FLOPS_CASES = [
    dict(),  # the flagship: PolicyConfig defaults, B=256 x T=16
    dict(batch_size=8, seq_len=4, policy=dict(unit_embed_dim=16, lstm_hidden=32, mlp_hidden=24, aux_heads=True)),
    dict(batch_size=12, seq_len=7, policy=dict(unit_embed_dim=8, lstm_hidden=16, mlp_hidden=16, n_move_bins=5),
         ppo=dict(epochs=2, minibatches=3)),
]


@pytest.mark.parametrize("case", range(len(FLOPS_CASES)), ids=["flagship", "small-aux", "small-reuse"])
def test_train_step_flops_equal_the_reference(case):
    kw = dict(FLOPS_CASES[case])
    pol, ppo = kw.pop("policy", {}), kw.pop("ppo", {})
    ours = LearnerConfig(policy=PolicyConfig(**pol), ppo=PPOConfig(**ppo), **kw)
    ref = JLearnerConfig(policy=JPolicyConfig(**pol), ppo=JPPOConfig(**ppo), **kw)
    assert tflops.policy_forward_flops_per_frame(ours.policy) == jflops.policy_forward_flops_per_frame(ref.policy)
    assert tflops.train_step_flops(ours) == jflops.train_step_flops(ref)
    if case == 0:
        assert abs(tflops.train_step_flops(ours) - 13.20e9) < 0.01e9


def test_peak_table_names_only_the_h100_sxm():
    assert tflops.peak_flops_for("NVIDIA H100 80GB HBM3") == 989.4e12
    assert tflops.peak_flops_for("NVIDIA H100 PCIe") is None
    assert tflops.device_peak_flops("cpu") is None


@pytest.mark.parametrize("spec", ["dp=-1", "dp=1", "dp=1,tp=1", "tp=-1,dp=1", " dp = -1 "])
def test_one_device_specs_parse_as_the_reference(spec):
    assert parse_mesh_spec(spec, 1) == j_parse_mesh_spec(spec, 1)
    assert resolve_mesh(spec, 1) == j_parse_mesh_spec(spec, 1)


def test_mesh_specs_beyond_one_device_are_refused():
    """Over the world size (one process per card): the spec covers the
    ranks and resolves as the reference's parse does, tp and sp axes of two
    or more included; a spec that does not cover the ranks raises
    ValueError, as parse_mesh_spec does, and so do the reference's
    multi-process rules (a dp axis, and none of size > 1 ahead of it)."""
    for spec, n in (("dp=4,tp=2", 8), ("dp=-1,tp=2", 8), ("dp=2", 2), ("dp=2,sp=2", 4), ("dp=1,sp=2", 2)):
        assert parse_mesh_spec(spec, n) == j_parse_mesh_spec(spec, n)
        assert resolve_mesh(spec, n) == j_parse_mesh_spec(spec, n)
    for spec in ("sp=2,dp=4", "tp=-1"):
        with pytest.raises(ValueError, match="multihost needs"):
            resolve_mesh(spec, 8)
    for spec in ("dp=-1,tp=-1", "dp=x", "dp=0", "dp=2"):
        with pytest.raises(ValueError):
            resolve_mesh(spec, 1)


def test_render_prometheus_is_byte_equal():
    scalars = {"loss": 0.5, "compute_mfu": 4.123456789e-4, "9lives": 3, "a-b.c": 1e12, "nan": math.nan,
               "inf": math.inf, "text": "x", "none": None, "big_counter": 123456789012.0, "neg": -2.5e-9,
               "staging_pack_worker_busy_s_0": 0.1234}
    assert render_prometheus(scalars) == j_render(scalars)
    assert render_prometheus({}) == j_render({})


def _drive_timer(timer):
    """One fixed add/add_overlap/step sequence over two windows."""
    outs = []
    for w in range(2):
        for i in range(3):
            timer.add("fetch", 0.001 * (i + 1) + w)
            timer.add("pack", 0.0)
            timer.add("h2d", 0.0005 * i)
            timer.add("device_step", 0.02 + 0.001 * i)
            timer.add("host", 0.0003)
            timer.add("fetch", -1.0)  # negative durations clamp to 0
            if timer.overlap:
                timer.add_overlap("fetch", 0.004 * (i + 1))
                timer.add_overlap("pack", 0.0001)
                timer.add_overlap("h2d", 0.002 + w)
            timer.step(0.03 + 0.002 * i)
        outs.append(timer.window_scalars())
    outs.append(timer.window_scalars())  # an empty window
    return outs


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_step_phase_timer_equals_the_reference(overlap):
    assert _drive_timer(tcompute.StepPhaseTimer(overlap)) == _drive_timer(jcompute.StepPhaseTimer(overlap))


def test_mfu_accountant_equals_the_reference():
    for peak in (989.4e12, None):
        ours, ref = tcompute.MfuAccountant(13.2e9, peak), jcompute.MfuAccountant(13.2e9, peak)
        assert ours.scalars() == ref.scalars() == {}
        for steps, secs in ((5, 0.11), (5, 0.13), (0, 0.0), (7, -1.0)):
            ours.add_window(steps, secs)
            ref.add_window(steps, secs)
            assert ours.scalars() == ref.scalars()
        assert ("compute_mfu" in ours.scalars()) == (peak is not None)


WATCHDOG_SEQ = [
    # (clock, version, latest scalars, window id)
    (0.0, 0, {}, -1),
    (5.0, 0, {}, -1),
    (10.0, 1, {"loss": 0.5, "compute_phase_fetch_frac": 0.99, "env_steps_per_sec": 100.0}, 1),
    (15.0, 2, {"loss": 0.5, "compute_phase_fetch_frac": 0.99, "env_steps_per_sec": 100.0}, 1),
    (20.0, 3, {"loss": 0.4, "compute_phase_fetch_frac": 0.97, "env_steps_per_sec": 90.0}, 2),
    (25.0, 4, {"loss": 0.4, "compute_phase_fetch_frac": 0.98, "env_steps_per_sec": 95.0}, 3),
    (30.0, 5, {"loss": 0.3, "compute_phase_fetch_frac": 0.5, "env_steps_per_sec": 20.0}, 4),
    (35.0, 6, {"loss": float("nan"), "compute_phase_fetch_frac": 0.5, "env_steps_per_sec": 95.0}, 5),
    (40.0, 7, {"loss": float("nan"), "env_steps_per_sec": 95.0}, 6),
    (45.0, 8, {"loss": float("nan"), "env_steps_per_sec": 95.0}, 6),
    (50.0, 9, {"loss": 0.1, "env_steps_per_sec": 95.0}, 7),
    (200.0, 9, {"loss": 0.1, "env_steps_per_sec": 95.0}, 7),
    (260.0, 9, {"loss": 0.1, "env_steps_per_sec": 95.0}, 7),
    (320.0, 9, {"loss": 0.1, "env_steps_per_sec": 95.0}, 7),
    (330.0, 10, {"loss": 0.1, "env_steps_per_sec": 96.0}, 8),
]


def _drive_watchdog(cls, cfg, tmp_path):
    state = {"t": 0.0, "v": 0, "latest": {}, "seq": -1}
    rec = FlightRecorder("learner", dump_dir=str(tmp_path))
    wd = cls(cfg, lambda: dict(state["latest"]), lambda: state["v"], recorder=rec, time_fn=lambda: state["t"],
             latest_seq_fn=lambda: state["seq"])
    out = []
    for t, v, latest, seq in WATCHDOG_SEQ:
        state.update(t=t, v=v, latest=latest, seq=seq)
        verdict = wd.check()
        verdict.pop("uptime_s")
        out.append((verdict, wd.scalars()))
    return out


def test_watchdog_verdicts_equal_the_reference(tmp_path):
    kw = dict(enabled=True, stall_s=100.0, boot_grace_s=150.0, starvation_frac=0.95, regression_frac=0.5, window=3,
              dump_after=2, trip_after=3)
    ours = _drive_watchdog(Watchdog, WatchdogConfig(**kw), tmp_path / "port")
    ref = _drive_watchdog(JWatchdog, JWatchdogConfig(**kw), tmp_path / "ref")
    assert ours == ref
    reasons = {r.split(":")[0] for verdict, _ in ours for r in verdict["reasons"]}
    assert reasons == {"starvation", "regression", "nan_loss", "stall"}
    assert any(verdict["tripped"] for verdict, _ in ours) and not ours[-1][0]["tripped"]
    assert list((tmp_path / "port").glob("flight_learner_*_watchdog_*.json"))


def test_trace_histograms_equal_the_reference():
    ours, ref = PipelineTracer(), JPipelineTracer()
    for i in range(12):
        births = (100.0 + i, 100.0 + i)
        r_ours, r_ref = TraceRef(i, births[0]), JTraceRef(i, births[1])
        t = 100.0 + i
        for stage, dt in (("consume", 0.0004 * i), ("staging_admit", 0.002), ("pack", 0.05 * i), ("h2d", 0.0),
                          ("apply", 0.3 * i)):
            t += dt
            ours.hop(stage, r_ours, now=t)
            ref.hop(stage, r_ref, now=t)
        ours.e2e([r_ours, None], now=t + 1.0)
        ref.e2e([r_ref, None], now=t + 1.0)
    assert ours.scalars() == ref.scalars() and "trace_e2e_actor_apply_s" in ours.scalars()


def test_recompile_sentinel_counts_new_batch_signatures(tmp_path):
    import torch

    rec = FlightRecorder("learner", dump_dir=str(tmp_path))
    calls = []
    s = tcompute.RecompileSentinel(lambda state, payload: calls.append(payload.shape) or (state, {}), recorder=rec)
    for shape in ((8, 100), (8, 100), (4, 100), (8, 100)):
        s("state", torch.zeros(shape, dtype=torch.uint8))
    assert calls == [(8, 100), (8, 100), (4, 100), (8, 100)]
    assert s.scalars() == {"compute_recompiles_total": 1.0, "compute_compiles_total": 2.0, "compute_compile_s": 0.0,
                           "compute_last_compile_s": 0.0}
    events = [e for e in rec._ring if e["ev"] == "recompile"]
    assert [e["n"] for e in events] == [1] and "(8, 100)" in events[0]["diff"][0]


def test_the_port_registry_is_the_reference_registry_for_its_names():
    for name, meaning in tregistry.SCALARS.items():
        assert jregistry.is_registered(name), name
    for prefix in tregistry.PREFIXES:
        assert prefix in jregistry.PREFIXES
    assert tregistry.unregistered(["loss", "step", "time", "staging_pack_workers", "nope"]) == ["nope"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_scrape_surface_routes(tmp_path):
    health = {"ok": True}
    cap = tcompute.ProfileCapture(str(tmp_path), max_seconds=0.5, device="cpu")
    server = MetricsHTTPServer(0, [lambda: {"loss": 0.25, "bad": math.nan}, lambda: 1 / 0],
                               health_provider=lambda: dict(health), profile_handler=cap.capture).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, body = _get(base + "/metrics")
        assert code == 200 and "dotaclient_loss 0.25\n" in body and "bad" not in body
        assert "dotaclient_obs_boot_epoch_ms" in body
        assert _get(base + "/healthz")[0] == 200
        health["ok"] = False
        code, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["ok"] is False
        assert _get(base + "/nope")[0] == 404
        code, body = _post(base + "/profile?seconds=9")
        assert code == 200 and body["seconds"] == 0.5 and (tmp_path / body["trace_dir"].split("/")[-1] / "trace.json").exists()
        assert _post(base + "/profile?seconds=nan")[0] == 400
        assert cap._lock.acquire(blocking=False)
        try:
            assert _post(base + "/profile?seconds=0.1")[0] == 409
        finally:
            cap._lock.release()
        server.profile_handler = lambda s: (_ for _ in ()).throw(RuntimeError("no kernels"))
        code, body = _post(base + "/profile?seconds=1")
        assert code == 500 and "no kernels" in body["error"]
    finally:
        server.stop()


def _launch_trace(path, lost_thread_kernels: bool):
    """A torch.profiler-shaped Chrome trace: two launching threads, each
    with 3 kernel launches (driver and runtime names), a launch in the
    window's first ms whose kernel CUPTI did not trace and one in its last
    ms whose kernel had not run. With `lost_thread_kernels` the second
    thread's kernels are missing."""
    events = [{"ph": "M", "name": "thread_name", "tid": 1, "args": {"name": "loop"}},
              {"ph": "M", "name": "thread_name", "tid": 2, "args": {"name": "autograd"}},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2, "ts": 0.8e5,
               "args": {"correlation": 98}}]
    corr = 0
    for tid, name in ((1, "cudaLaunchKernel"), (2, "cudaLaunchKernelExC_v11060")):
        for i in range(3):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": 1e5 * corr,
                           "args": {"correlation": corr}})
            if not (lost_thread_kernels and tid == 2):
                events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": 1e5 * corr + 5,
                               "args": {"correlation": corr}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1, "ts": 6.5e5,
                   "args": {"correlation": 99}})
    events.append({"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "tid": 1, "ts": 6.6e5,
                   "args": {"correlation": 100}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_lost_kernel_launches_are_counted_by_launching_thread(tmp_path):
    """Each kernel launch is matched to its kernel by correlation id; a copy
    is no launch, and a launch within an edge of the window is not checked
    (CUPTI may not trace the first kernels; the last may run after the
    stop)."""
    whole, partial = str(tmp_path / "whole.json"), str(tmp_path / "partial.json")
    _launch_trace(whole, False)
    _launch_trace(partial, True)
    assert tcompute.lost_kernel_launches(whole) == {}
    assert tcompute.lost_kernel_launches(partial) == {"autograd": 3}
    assert tcompute.lost_kernel_launches(whole, edge_ms=0.0) == {"autograd": 1, "loop": 1}
    assert len(tcompute.trace_kernel_names(partial)) == 3


def test_a_partial_profile_window_is_never_a_200(tmp_path, monkeypatch):
    """On the card a window whose trace lost a launching thread's kernels,
    or whose records CUPTI dropped, raises, and POST /profile answers 500
    naming the lost launches per thread (or the dropped count); a whole
    window answers 200. (The card's CUPTI recording is stood in for by one
    that writes the trace; the device sync runs before its stop.)"""
    state = {"lossy": True, "dropped": 0, "synced": 0}

    class FakeTrace:
        def window(self, seconds, before_stop=None):
            before_stop()
            return [], [], state["dropped"]

    monkeypatch.setattr(tcupti, "activity_trace", lambda: FakeTrace())
    monkeypatch.setattr(tcupti, "write_chrome_trace", lambda path, k, c: _launch_trace(path, state["lossy"]))
    monkeypatch.setattr(tcompute.torch.cuda, "synchronize",
                        lambda device=None: state.update(synced=state["synced"] + 1))
    cap = tcompute.ProfileCapture(str(tmp_path), max_seconds=0.2, device="cpu")
    cap.cuda = True
    server = MetricsHTTPServer(0, [lambda: {}], profile_handler=cap.capture).start()
    try:
        code, body = _post(f"http://127.0.0.1:{server.port}/profile?seconds=0.1")
        assert code == 500 and "partial" in body["error"] and '{"autograd": 3}' in body["error"]
        assert cap.captures_done == 0 and state["synced"] == 1
        state.update(lossy=False, dropped=2)
        code, body = _post(f"http://127.0.0.1:{server.port}/profile?seconds=0.1")
        assert code == 500 and "CUPTI dropped 2 records" in body["error"]
        state["dropped"] = 0
        code, body = _post(f"http://127.0.0.1:{server.port}/profile?seconds=0.1")
        assert code == 200 and cap.captures_done == 1
    finally:
        server.stop()


def test_cuptis_buffers_are_kept_and_read_in_c():
    """csrc/cupti_buffers.cc, built with g++ as on the card, stands in for
    CUPTI's side: a buffer handed out and given back is counted, queued
    and taken; its kernel and runtime records (laid out at CUPTI's struct
    offsets, walked by a stand-in for cuptiActivityGetNextRecord) read back
    field for field, other kinds skipped."""
    import ctypes

    from dotaclient_tpu_torch.ops import _kernels

    native = _kernels.load("cupti_buffers")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    native.dt_cupti_buffer_requested.argtypes = [ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
                                                 ctypes.POINTER(ctypes.c_size_t)]
    native.dt_cupti_buffer_completed.argtypes = [ctypes.c_void_p, ctypes.c_uint32, u8p, ctypes.c_size_t,
                                                 ctypes.c_size_t]
    buf, size, cap = u8p(), ctypes.c_size_t(), ctypes.c_size_t()
    native.dt_cupti_buffer_requested(ctypes.byref(buf), ctypes.byref(size), ctypes.byref(cap))
    assert size.value == 8 << 20 and ctypes.addressof(buf.contents) % 8 == 0 and native.dt_cupti_held() == 1

    def put(off, fmt, *values):
        import struct

        struct.pack_into(fmt, (ctypes.c_uint8 * size.value).from_address(ctypes.addressof(buf.contents)), off, *values)

    name = ctypes.create_string_buffer(b"_Z4lstmv")
    put(0, "<IIQQIII", 5, 211, 1000, 1010, 7, 42, 3)  # runtime: cbid, start, end, process, thread, correlation
    put(40, "<I", 6)  # another kind: skipped
    put(80, "<I", 10)  # kernel
    put(80 + 16, "<QQ", 1100, 1900)
    put(80 + 40, "<I", 0)
    put(80 + 48, "<I", 13)
    put(80 + 92, "<I", 3)
    put(80 + 104, "<Q", ctypes.addressof(name))
    sizes = {5: 40, 6: 40, 10: 160}
    valid = 80 + 160

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p))
    def next_record(base, n, record):
        at = base if not record[0] else record[0] + sizes[ctypes.c_uint32.from_address(record[0]).value]
        if at - base >= n:
            return 12  # CUPTI_ERROR_MAX_LIMIT_REACHED
        record[0] = at
        return 0

    native.dt_cupti_buffer_completed(None, 0, buf, size, valid)
    assert native.dt_cupti_held() == 0
    trace = tcupti.ActivityTrace.__new__(tcupti.ActivityTrace)
    trace.native, trace._next_record = native, ctypes.cast(next_record, ctypes.c_void_p)
    trace._names = {(tcupti.KIND_RUNTIME, 211): "cudaLaunchKernel_v7000"}
    kernels, calls = trace._drain()
    assert kernels == [tcupti.Kernel("_Z4lstmv", 1100, 1900, 0, 13, 3)]
    assert calls == [tcupti.Call(tcupti.KIND_RUNTIME, "cudaLaunchKernel_v7000", 1000, 1010, 7, 42, 3)]
    assert trace._drain() == ([], [])  # taken once, freed


def test_the_cupti_route_writes_a_trace_the_detector_reads(tmp_path):
    """obs/cupti.py's records as a Chrome trace in torch.profiler's
    categories: kernels paired with their launch calls by correlation,
    calls on their threads under Python's thread names, kernel names
    demangled; a launch whose kernel record is missing is counted against
    its thread. Without a CUPTI library the recorder refuses (OSError)."""
    me = threading.current_thread()
    tid = me.ident & 0xFFFFFFFF
    mangled = "_Z20lstm_recurrence_stepPf"
    calls = [tcupti.Call(tcupti.KIND_RUNTIME, "cudaLaunchKernel_v7000", int(t * 1e9), int(t * 1e9) + 10, 7, tid, c)
             for c, t in enumerate((0.0, 0.1, 0.2, 0.3, 0.4), start=1)]
    calls.append(tcupti.Call(tcupti.KIND_DRIVER, "cuLaunchKernel", int(0.25e9), int(0.25e9) + 5, 7, 99, 9))
    kernels = [tcupti.Kernel(mangled, c.start_ns + 100, c.start_ns + 900, 0, 13, c.correlation) for c in calls]
    path = str(tmp_path / "trace.json")
    tcupti.write_chrome_trace(path, kernels, calls)
    events = json.load(open(path))["traceEvents"]
    assert {e["cat"] for e in events if e["ph"] == "X"} == {"kernel", "cuda_runtime", "cuda_driver"}
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names == {tid: me.name, 99: "99"}
    assert tcompute.trace_kernel_names(path) == ["lstm_recurrence_step(float*)"] * 6
    assert tcompute.lost_kernel_launches(path) == {}
    tcupti.write_chrome_trace(path, kernels[:2] + kernels[3:], calls)  # the 0.2 s launch's kernel lost
    assert tcompute.lost_kernel_launches(path) == {me.name: 1}
    assert tcupti.demangle("not_mangled") == "not_mangled"
    if not any("libcupti" in line for line in open("/proc/self/maps")):
        with pytest.raises(OSError, match="no CUPTI library"):
            tcupti._load()


def test_a_surface_with_no_device_wires_no_profiler():
    """serve_metrics takes the caller's device: None (a tier that steps no
    net) serves /metrics and answers POST /profile 404."""
    from dotaclient_tpu_torch.obs import ObsRuntime

    rt = ObsRuntime(ObsConfig(enabled=True, metrics_port=_free_port()), role="control")
    server = rt.serve_metrics([lambda: {"x": 1.0}], device=None)
    try:
        assert rt.profiler is None
        assert _get(f"http://127.0.0.1:{server.port}/metrics")[0] == 200
        assert _post(f"http://127.0.0.1:{server.port}/profile?seconds=0.1")[0] == 404
    finally:
        rt.close()


def test_flight_recorder_dumps_sections_and_chains_sigterm(tmp_path):
    import signal

    rec = FlightRecorder("learner", ring_size=3, dump_dir=str(tmp_path))
    rec.add_section("staging_quarantine", lambda: [{"reason": "parse"}])
    for i in range(5):
        rec.record("hop", i=i)
    path = rec.dump("layout error")
    payload = json.loads(open(path).read())
    assert [e["i"] for e in payload["events"]] == [2, 3, 4] and payload["events_recorded"] == 5
    assert payload["sections"]["staging_quarantine"] == [{"reason": "parse"}] and "layout_error" in path
    assert rec.dump("layout error") is None  # once per reason
    prev = signal.getsignal(signal.SIGTERM)
    seen = []
    signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        rec.install_handlers()
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert seen == [signal.SIGTERM] and list(tmp_path.glob("flight_learner_*_sigterm_*.json"))
    finally:
        import sys

        sys.excepthook, threading.excepthook = sys.__excepthook__, threading.__excepthook__
        signal.signal(signal.SIGTERM, prev)


def _obs_learner(name, tmp_path, prefetch, **obs_kw):
    cfg = LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**POL, dtype="float32"), broker_url=f"mem://{name}",
                        log_dir=str(tmp_path / name), metrics_every=2, ppo=PPOConfig(max_staleness=1000),
                        obs=ObsConfig(**{"enabled": True, "install_handlers": False, "dump_dir": str(tmp_path / name),
                                         **obs_kw}))
    cfg.learner.prefetch = prefetch
    tmem.reset(name)
    birth = time.time()
    for i, f in enumerate(frames_for(cfg, 4)):  # every other frame trace-stamped (DTR2)
        tmem.MemoryBroker(name).publish_experience(stamp_rollout_trace(f, 1000 + i, birth) if i % 2 else f)
    return tlearner.Learner(cfg, tmem.MemoryBroker(name), device="cpu")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("prefetch", [False, True], ids=["serial", "pipelined"])
def test_learner_with_obs_logs_registered_names_and_trains_as_without(tmp_path, prefetch):
    """obs on changes no bit of the training; every name the learner logs
    and serves is in both registries; the serial loop's fenced phases tile
    the wall."""
    off = _obs_learner(f"obs_off_{prefetch}", tmp_path, prefetch, enabled=False)
    assert off.obs is None
    off.run(num_steps=4, batch_timeout=30.0, max_idle=3)
    off.close()
    on = _obs_learner(f"obs_on_{prefetch}", tmp_path, prefetch, metrics_port=_free_port(),
                      watchdog=WatchdogConfig(enabled=True, interval_s=0.05))
    server = on.obs.server
    try:
        assert on.run(num_steps=4, batch_timeout=30.0, max_idle=3) == 4
        code, body = _get(f"http://127.0.0.1:{server.port}/metrics")
        assert code == 200 and _get(f"http://127.0.0.1:{server.port}/healthz")[0] == 200
    finally:
        on.close()
    assert [(n, a.tobytes()) for n, a in named_params(on.state.net)] == [
        (n, a.tobytes()) for n, a in named_params(off.state.net)]
    lines = [json.loads(x) for x in open(tmp_path / f"obs_on_{prefetch}" / "metrics.jsonl")]
    logged = set().union(*lines)
    scraped = {ln.split()[0][len("dotaclient_"):] for ln in body.splitlines() if not ln.startswith("#")}
    for names in (logged, scraped):
        assert tregistry.unregistered(names) == [] and jregistry.unregistered(names) == []
    for key in ("compute_phase_fetch_s", "compute_phase_device_step_s", "compute_flops_per_sec",
                "compute_recompiles_total"):
        assert key in lines[-1]
    assert "compute_mfu" not in lines[-1]  # no peak for the CPU
    assert ("pipeline_prefetch_h2d_s" in lines[-1]) == prefetch
    last = lines[-1]
    tiled = sum(last[f"compute_phase_{p}_s"] for p in ("fetch", "pack", "h2d", "device_step", "host"))
    if not prefetch:
        assert tiled <= last["compute_phase_wall_s"] * 1.0001 + 1e-6
    assert last["compute_recompiles_total"] == 0.0 and last["compute_compiles_total"] == 1.0
    assert "obs_learner_version" in scraped and "watchdog_ok" in scraped
    # the trace-stamped half of the frames hopped consume → … → apply
    for stage in ("consume", "staging_admit", "pack", "h2d", "apply"):
        assert f"trace_{stage}_mean_ms" in last, stage
    assert sum(v for k, v in last.items() if k.startswith("trace_apply_ms_")) == 4 * B // 2  # every bucket
    assert last["trace_e2e_actor_apply_s"] > 0
