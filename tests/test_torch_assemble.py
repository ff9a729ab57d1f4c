"""In-network batch assembly against the JAX package: DTB1 blocks byte for
byte the reference's goldens, the port's RowAssembler rows equal to the
reference's (native and Python packers, DTR1/2/3, FAB1-enveloped), a real
tcp:// shard of the port armed with assembly (GET_BLOCK; the refusal on an
unarmed shard; the conservation ledger through a partial drain and a
kill), and assembled staging through the port's FabricBroker bitwise the
classic pack of the same frames (per-row sha256, as the fan-in order is
not fixed). Bytes and ledgers are exact."""

import hashlib
import subprocess
import sys
import time

import numpy as np
import pytest

from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu.transport.assemble import RowAssembler as JRowAssembler
from dotaclient_tpu.transport.tcp import TcpBroker as JTcpBroker
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
from dotaclient_tpu_torch.runtime import staging as tstaging
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.ops.batch import tree_flatten, zeros_train_batch
from dotaclient_tpu_torch.transport.assemble import RowAssembler
from dotaclient_tpu_torch.transport.base import RetryPolicy
from dotaclient_tpu_torch.transport.fabric import FabricBroker, wrap_fabric
from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker
from test_inet_assemble import BLOCK_GOLDEN_HEX, BLOCK_GOLDEN_SPEC, _golden_rows
from test_transport import make_rollout

FAST = RetryPolicy(window_s=0.4, backoff_base_s=0.01, backoff_cap_s=0.05, jitter=0.0)
T, H = 8, 8
REPO = str(__import__("pathlib").Path(__file__).resolve().parents[1])


def _port_rows(rows):
    return [tser.AssembledRow(*r) for r in rows]


def test_dtb1_block_golden_bytes_and_rejects():
    spec = tser.BlockSpec(*BLOCK_GOLDEN_SPEC)
    data = tser.serialize_block(spec, _port_rows(_golden_rows()))
    assert data.hex() == BLOCK_GOLDEN_HEX and tser.block_spec_flags(spec) == 2 and tser.BLOCK_MAGIC == b"DTB1"
    assert tser.peek_block_spec(data) == spec
    got_spec, rows = tser.deserialize_block(data)
    assert got_spec == spec and rows == _port_rows(jser.deserialize_block(data)[1])
    assert tser.deserialize_block(tser.serialize_block(spec, [])) == (spec, [])
    assert tser.peek_block_spec(b"garbage") is None
    assert tser.peek_block_spec(data[:4] + b"\x02" + data[5:]) is None  # another format revision
    with pytest.raises(ValueError, match="block length"):
        tser.deserialize_block(data[:-3])
    with pytest.raises(ValueError, match="row_bytes"):
        tser.serialize_block(spec, [tser.AssembledRow(payload=b"short", version=0)])


def _mixed_frames(n=6, bf16_every=3):
    """Partial-length frames over DTR1, traced DTR2 and DTR3 with distinct
    actor ids (the reference's assembly test mix)."""
    frames = []
    for i in range(n):
        r = make_rollout(L=3 + (i % (T - 3)), H=H, version=i, actor_id=100 + i, seed=i)
        if i % bf16_every == 1:
            r = r._replace(trace_id=0x1000 + i, birth_time=1.5 + i)
        elif i % bf16_every == 2:
            r = jser.cast_rollout_obs_bf16(r)
        frames.append(jser.serialize_rollout(r))
    return frames


@pytest.mark.parametrize("obs_bf16", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_row_assembler_rows_equal_the_reference_s(native, obs_bf16):
    ours = RowAssembler(T, H, True, obs_bf16, use_native=native)
    ref = JRowAssembler(T, H, True, obs_bf16=obs_bf16, use_native=native)
    assert tuple(ours.spec) == tuple(ref.spec) and ours.native_active == native
    frames = _mixed_frames() + [wrap_fabric(_mixed_frames(2)[1], 101, 77, 2, 9)]
    for f in frames:
        assert tuple(ours.assemble(f, priority=0.25)) == tuple(ref.assemble(f, priority=0.25))
    for bad, reason in ((b"not a frame", "parse"),
                        (jser.serialize_rollout(make_rollout(L=T + 1, H=H, seed=5)), "layout"),
                        (jser.serialize_rollout(make_rollout(L=3, H=H + 1, seed=6)), "layout")):
        with pytest.raises(ValueError, match=reason):
            ours.assemble(bad)
        with pytest.raises(ValueError):
            ref.assemble(bad)


def test_row_assembler_views_keep_the_batch_structure():
    """The assembler's one-row batch has the template's structure, and each
    of its 17 leaves is a view into the row buffer that crosses."""
    ours = RowAssembler(T, H, False, obs_bf16=False, use_native=False)
    leaves, structure = tree_flatten(ours._batch)
    tmpl_leaves, tmpl_structure = tree_flatten(zeros_train_batch(1, T, H, False))
    assert structure == tmpl_structure and len(leaves) == 17
    for view, leaf in zip(leaves, tmpl_leaves):
        assert view.shape == leaf.shape and np.shares_memory(view, ours._buf)
    assert ours._buf.nbytes == ours.spec.row_bytes


def test_armed_shard_serves_blocks_to_both_packages_clients_and_refuses_when_unarmed():
    frames = _mixed_frames()
    ref = JRowAssembler(T, H, False, obs_bf16=True, use_native=False)
    srv = BrokerServer(port=0, assemble=True).start()
    unarmed = BrokerServer(port=0).start()
    try:
        ours = TcpBroker("127.0.0.1", srv.port, retry=FAST)
        for f in frames:
            ours.publish_experience(f)
        spec = tser.BlockSpec(*ref.spec)
        got_spec, rows = tser.deserialize_block(ours.consume_block(spec, 4, timeout=5.0))
        assert got_spec == spec and [tuple(r) for r in rows] == [tuple(ref.assemble(f)) for f in frames[:4]]
        theirs = JTcpBroker("127.0.0.1", srv.port, retry=FAST)  # the reference's client, same wire
        _, rest = jser.deserialize_block(theirs.consume_block(ref.spec, 8, timeout=5.0))
        assert [r.payload for r in rest] == [ref.assemble(f).payload for f in frames[4:]]
        assert tser.deserialize_block(ours.consume_block(spec, 4, timeout=0.05))[1] == []  # an empty wait
        with pytest.raises((ConnectionError, OSError)):  # another row layout: the shard closes the connection
            TcpBroker("127.0.0.1", srv.port, retry=FAST).consume_block(spec._replace(layout_crc=1), 4, timeout=0.2)
        with pytest.raises((ConnectionError, OSError)):
            TcpBroker("127.0.0.1", unarmed.port, retry=FAST).consume_block(spec, 4, timeout=0.2)
        assert set(unarmed.assemble_ledger().values()) == {0}
    finally:
        srv.stop()
        unarmed.stop()


def _balanced(led):
    return led["rows_admitted"] == (led["rows_packed"] + led["rows_reject"] + led["rows_bypassed"]
                                    + led["rows_dropped"] + led["rows_resident"])


def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < 10, what
        time.sleep(0.01)


def test_assembly_ledger_is_exact_through_a_partial_drain_and_a_kill():
    """admitted = packed + reject + bypassed + dropped + resident at every
    quiescent point: the pre-spec backlog, a partial block, a reject, a
    classic CONSUME bypass, drop-oldest overflow, and a kill with rows
    still resident."""
    spec = tser.BlockSpec(*JRowAssembler(T, H, False, obs_bf16=False, use_native=False).spec)
    srv = BrokerServer(port=0, assemble=True, assemble_native=False, maxlen=16).start()
    try:
        cli = TcpBroker("127.0.0.1", srv.port, retry=FAST)
        frames = _mixed_frames(bf16_every=99)
        for f in frames[:5]:
            cli.publish_experience(f)
        cli.publish_experience(b"not a rollout frame")
        _wait(lambda: srv.assemble_ledger()["rows_admitted"] == 6, "admits")
        led = srv.assemble_ledger()
        assert led["rows_resident"] == 6 and led["rows_packed"] == 0 and _balanced(led)
        _, rows = tser.deserialize_block(cli.consume_block(spec, 3, timeout=5.0))
        led = srv.assemble_ledger()
        assert len(rows) == 3 and led["rows_packed"] == 3 and led["rows_resident"] == 3 and _balanced(led)
        _wait(lambda: srv.assemble_ledger()["blocks_served"] == 1, "served")
        _, rows = tser.deserialize_block(cli.consume_block(spec, 8, timeout=5.0))  # 2 good + the garbage
        led = srv.assemble_ledger()
        assert len(rows) == 2 and led["rows_reject"] == 1 and led["rows_resident"] == 0 and _balanced(led)
        cli.publish_experience(frames[5])  # packed at admission now the spec is known
        assert len(cli.consume_experience(4, timeout=5.0)) == 1  # a classic consume bypasses the station
        for f in (frames * 4)[:20]:  # 4 over the bound: drop-oldest
            cli.publish_experience(f)
        _wait(lambda: srv.assemble_ledger()["rows_admitted"] == 27, "overflow admits")
        led = srv.assemble_ledger()
        assert led["rows_bypassed"] == 1 and led["rows_dropped"] == 4 and led["rows_resident"] == 16
        assert _balanced(led) and led["cpu_s"] > 0 and led["block_bytes"] > 0
    finally:
        srv.stop()  # the kill: the resident rows stay in the final snapshot
    led = srv.assemble_ledger()
    assert led["rows_resident"] == 16 and _balanced(led)
    assert srv.ledger()["enqueued"] == srv.ledger()["popped"] + srv.ledger()["dropped_oldest"] + 16


def _cfg(assemble: bool, single: bool = True):
    cfg = LearnerConfig(batch_size=6, seq_len=T, fused_single_h2d=single,
                        policy=PolicyConfig(unit_embed_dim=16, lstm_hidden=H, mlp_hidden=16))
    cfg.staging.assemble = assemble
    return cfg, FusedBatchIO(ts.batch_template(cfg), "cpu", single=single)


def _row_hashes(payload, n):
    if isinstance(payload, dict):
        rows = [b"".join(payload[k][r].view(__import__("torch").uint8).numpy().tobytes() for k in sorted(payload))
                for r in range(n)]
    else:
        rows = [payload[r].numpy().tobytes() for r in range(n)]
    return sorted(hashlib.sha256(r).hexdigest() for r in rows)


def _staged(sb):
    sb.start()
    try:
        batch, payload = sb.get_batch_groups(timeout=30.0)
        assert batch is not None, sb.stats()
        hashes = _row_hashes(payload, 6)
        if sb.last_batch_lease is not None:
            sb.last_batch_lease.release()
        return hashes, sb.stats()
    finally:
        sb.stop()


@pytest.mark.parametrize("single", [True, False])
def test_assembled_staging_is_bitwise_the_classic_pack(single):
    """Two armed shards of the port behind its FabricBroker's block fan-in
    into an assembled StagingBuffer land the rows the classic pack of the
    same frames writes, in the single buffer and in the four groups; a
    learner-side config whose broker cannot serve blocks raises."""
    frames = [jser.serialize_rollout(jser.cast_rollout_obs_bf16(make_rollout(L=3 + i % 5, H=H, version=0,
                                                                             actor_id=200 + i, seed=i)) if i % 2
                                     else make_rollout(L=3 + i % 5, H=H, version=0, actor_id=200 + i, seed=i))
              for i in range(6)]
    servers = [BrokerServer(port=0, assemble=True).start() for _ in range(2)]
    fab = FabricBroker([f"tcp://127.0.0.1:{s.port}" for s in servers], retry=FAST)
    try:
        cfg, io = _cfg(True, single)
        sb = tstaging.StagingBuffer(cfg, fab, version_fn=lambda: 0, fused_io=io)
        for f in frames:
            fab.publish_experience(f)
        asm_hashes, asm_stats = _staged(sb)
        ledgers = [s.assemble_ledger() for s in servers]
    finally:
        fab.close()
        for s in servers:
            s.stop()
    assert asm_stats["rows_packed"] == 6 and "pack_wall_s" in asm_stats and "pack_ring_occupancy" in asm_stats
    assert sum(led["rows_packed"] for led in ledgers) == 6 and all(_balanced(led) for led in ledgers)
    tmem.reset("asm_classic")
    pub = tmem.MemoryBroker("asm_classic")
    for f in frames:
        pub.publish_experience(f)
    cfg, io = _cfg(False, single)
    classic, _ = _staged(tstaging.StagingBuffer(cfg, tmem.MemoryBroker("asm_classic"), version_fn=lambda: 0,
                                                fused_io=io))
    assert asm_hashes == classic
    cfg, io = _cfg(True, single)
    with pytest.raises(ValueError, match="DTB1"):
        tstaging.StagingBuffer(cfg, tmem.MemoryBroker("asm_classic"), fused_io=io)
    with pytest.raises(ValueError, match="fused H2D"):
        tstaging.StagingBuffer(cfg, tmem.MemoryBroker("asm_classic"))


def test_an_unarmed_shard_never_loads_the_assembly_module():
    code = ("import sys\n"
            "from dotaclient_tpu_torch.transport.tcp import BrokerServer\n"
            "from dotaclient_tpu_torch.transport.base import connect\n"
            "srv = BrokerServer(port=0).start()\n"
            "c = connect(f'tcp://127.0.0.1:{srv.port}')\n"
            "c.publish_experience(b'x' * 100)\n"
            "assert c.consume_experience(4, timeout=5.0) == [b'x' * 100]\n"
            "assert srv._asm_meta is None and set(srv.assemble_ledger().values()) == {0}\n"
            "assert 'dotaclient_tpu_torch.transport.assemble' not in sys.modules\n"
            "srv.stop()\n"
            "print('INERT')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "INERT" in proc.stdout, proc.stderr
