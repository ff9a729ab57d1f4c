"""The port's transport against the reference: DTR1/DTR2/DTR3 rollout
frames byte for byte (and against the reference's frozen goldens), the
header peeks, strip/stamp and dtype-map checks, the in-process broker's
FIFO / latest-wins / shed behaviour, the connect refusals, the legacy
DTW1 emit, and the explicit f32 → bf16 rounding against ml_dtypes."""

import hashlib
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from dotaclient_tpu.env import featurizer as JF
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops.action_dist import Action
from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
from dotaclient_tpu_torch.transport import base as tbase
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from test_transport import (
    GOLDEN_BIRTH,
    GOLDEN_TRACE_ID,
    ROLLOUT_DTR1_HEADER_HEX,
    ROLLOUT_DTR1_SHA256,
    ROLLOUT_DTR2_HEADER_HEX,
    ROLLOUT_DTR2_SHA256,
    ROLLOUT_DTR3_HEADER_HEX,
    ROLLOUT_DTR3_SHA256,
    ROLLOUT_DTR3_TRACED_SHA256,
    make_golden_rollout,
    make_rollout,
)


def to_port(r: jser.Rollout) -> tser.Rollout:
    """A reference Rollout as the port's: same arrays, bf16 obs leaves as
    torch.bfloat16 tensors of the same words."""

    def leaf(x):
        x = np.asarray(x)
        return tser.bf16_tensor(x.view(np.uint16)) if x.dtype == ml_dtypes.bfloat16 else x

    return tser.Rollout(
        obs=F.Observation(*(leaf(x) for x in r.obs)),
        actions=Action(*r.actions),
        behavior_logp=r.behavior_logp,
        behavior_value=r.behavior_value,
        rewards=r.rewards,
        dones=r.dones,
        initial_state=r.initial_state,
        version=r.version,
        actor_id=r.actor_id,
        episode_return=r.episode_return,
        aux=tser.RolloutAux(*r.aux) if r.aux is not None else None,
        trace_id=r.trace_id,
        birth_time=r.birth_time,
    )


def _words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tser.bf16_bits(x)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


FORMS = {
    "dtr1": lambda r: r,
    "dtr2": lambda r: r._replace(trace_id=GOLDEN_TRACE_ID, birth_time=GOLDEN_BIRTH),
    "dtr3": jser.cast_rollout_obs_bf16,
    "dtr3_traced": lambda r: jser.cast_rollout_obs_bf16(r)._replace(trace_id=7, birth_time=2.5),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("aux", [False, True])
def test_port_frames_are_byte_equal_to_the_reference(form, aux):
    r = FORMS[form](make_rollout(L=5, H=8, aux=aux, seed=4))
    want = jser.serialize_rollout(r)
    assert tser.serialize_rollout(to_port(r)) == want
    assert want[:4] == {"dtr1": b"DTR1", "dtr2": b"DTR2"}.get(form, b"DTR3")


def test_port_frames_equal_the_frozen_goldens():
    g = to_port(make_golden_rollout())
    dtr1 = tser.serialize_rollout(g)
    assert dtr1[:21].hex() == ROLLOUT_DTR1_HEADER_HEX and hashlib.sha256(dtr1).hexdigest() == ROLLOUT_DTR1_SHA256
    dtr2 = tser.serialize_rollout(g._replace(trace_id=GOLDEN_TRACE_ID, birth_time=GOLDEN_BIRTH))
    assert dtr2[:37].hex() == ROLLOUT_DTR2_HEADER_HEX and hashlib.sha256(dtr2).hexdigest() == ROLLOUT_DTR2_SHA256
    assert dtr2 == tser.stamp_rollout_trace(dtr1, GOLDEN_TRACE_ID, GOLDEN_BIRTH)
    assert tser.strip_rollout_trace(dtr2) == dtr1
    # the port's own source cast (explicit rounding) gives the golden DTR3
    dtr3 = tser.serialize_rollout(tser.cast_rollout_obs_bf16(g))
    assert dtr3[:54].hex() == ROLLOUT_DTR3_HEADER_HEX and hashlib.sha256(dtr3).hexdigest() == ROLLOUT_DTR3_SHA256
    traced = tser.serialize_rollout(tser.cast_rollout_obs_bf16(g)._replace(trace_id=GOLDEN_TRACE_ID, birth_time=GOLDEN_BIRTH))
    assert hashlib.sha256(traced).hexdigest() == ROLLOUT_DTR3_TRACED_SHA256
    assert tser.strip_rollout_trace(dtr3) is dtr3 and tser.strip_rollout_trace(dtr1) is dtr1


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("aux", [False, True])
def test_reference_frames_deserialize_to_equal_arrays(form, aux):
    r = FORMS[form](make_rollout(L=6, H=8, aux=aux, seed=9))
    frame = jser.serialize_rollout(r)
    want, got = jser.deserialize_rollout(frame), tser.deserialize_rollout(frame)
    assert tser.rollout_obs_bf16(got) == form.startswith("dtr3")
    for a, b in zip([*want.obs, *want.actions, want.behavior_logp, want.behavior_value, want.rewards, want.dones,
                     *want.initial_state, *(want.aux or ())],
                    [*got.obs, *got.actions, got.behavior_logp, got.behavior_value, got.rewards, got.dones,
                     *got.initial_state, *(got.aux or ())]):
        a, b = _words(a), _words(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert (got.version, got.actor_id, got.episode_return, got.trace_id, got.birth_time, got.length) == (
        want.version, want.actor_id, want.episode_return, want.trace_id, want.birth_time, want.length)
    assert (got.aux is None) == (not aux)
    # and the port re-serializes it to the same bytes
    assert tser.serialize_rollout(got) == frame


def _corruptions():
    r = make_rollout(L=3, H=8, seed=2)
    q = jser.serialize_rollout(jser.cast_rollout_obs_bf16(r))
    d1 = jser.serialize_rollout(r)
    bad_code = bytearray(q)
    bad_code[38] = 7  # an obs entry of the dtype-map names no dtype
    mixed = bytearray(q)
    mixed[39] = 0  # obs leaves not uniformly bf16
    count = bytearray(q)
    count[37] = 15  # wrong map length
    return {
        "good_dtr3": q,
        "good_dtr1": d1,
        "bad_code": bytes(bad_code),
        "mixed_obs": bytes(mixed),
        "bad_count": bytes(count),
        "dtr3_header_only": q[:37],
        "dtr3_map_cut": q[:45],
        "dtr1_truncated": d1[: len(d1) // 2],
        "dtr1_trailing": d1 + b"x",
        "garbage": b"garbage!" * 4,
        "empty": b"",
    }


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_header_peeks_and_parse_failures_match_the_reference(name):
    data = _corruptions()[name]
    assert tser.peek_rollout_actor_id(data) == jser.peek_rollout_actor_id(data)
    assert tser.peek_rollout_trace(data) == jser.peek_rollout_trace(data)
    assert tser.wire_obs_is_bf16(data) == jser.wire_obs_is_bf16(data)
    if data[:4] == b"DTR3":
        assert tser.check_dtr3_dtype_map(data) == jser.check_dtr3_dtype_map(data)
    try:
        jser.deserialize_rollout(data)
        want = None
    except ValueError as e:
        want = type(e).__name__
    if want is None:
        tser.deserialize_rollout(data)
    else:
        with pytest.raises(ValueError) as info:
            tser.deserialize_rollout(data)
        assert type(info.value).__name__ == want  # WireDtypeError where the reference raises it
    if data[:4] == b"DTR1":
        assert tser.stamp_rollout_trace(data, 5, 1.5) == jser.stamp_rollout_trace(data, 5, 1.5)
    else:
        with pytest.raises(ValueError):
            tser.stamp_rollout_trace(data, 5, 1.5)


def test_dtw1_legacy_emit_is_byte_equal():
    named = [("params/a/kernel", np.arange(6, dtype=np.float32).reshape(2, 3)), ("params/b", np.float32(2.5) * np.ones(4, np.float32))]
    for legacy in (False, True):
        got = tser.serialize_weights(named, version=9, boot_epoch=0x1234, legacy_dtw1=legacy)
        assert got == jser.serialize_weights(named, version=9, boot_epoch=0x1234, legacy_dtw1=legacy)
    assert tser.deserialize_weights(tser.serialize_weights(named, 9, 0x1234, legacy_dtw1=True))[1:] == (9, 0)


# ------------------------------------------------------------------- broker


def _drive(broker_cls, reset, name, ops):
    """Run one op script against fresh handles of a broker class; returns
    every result (exceptions by class name)."""
    reset(name)
    handles = {}
    out = []
    for op in ops:
        kind, who = op[0], op[1]
        b = handles.get(who)
        if b is None:
            b = handles[who] = broker_cls(name, **op[3]) if len(op) > 3 else broker_cls(name)
        try:
            if kind == "pub":
                b.publish_experience(op[2])
                out.append(None)
            elif kind == "con":
                out.append(b.consume_experience(max_items=op[2], timeout=0.01))
            elif kind == "pubw":
                b.publish_weights(op[2])
                out.append(None)
            elif kind == "poll":
                out.append(b.poll_weights())
            elif kind == "depth":
                out.append(b.experience_depth())
        except Exception as e:  # BrokerShedError in both packages
            out.append(type(e).__name__)
    hub = next(iter(handles.values()))._hub
    return out, (hub.dropped, hub.shed_total, hub.shedding)


def test_memory_broker_matches_the_reference():
    shed = dict(shed_high=4, shed_low=2, maxlen=6)
    ops = [("pub", "a", b"f%d" % i, shed) for i in range(7)]  # sheds at depth 4
    ops += [("depth", "a", 0), ("con", "b", 3), ("depth", "a", 0)]  # depth 1: below low, admits again
    ops += [("pub", "a", b"g%d" % i) for i in range(8)]  # sheds again at 4
    ops += [("con", "b", 10), ("con", "b", 10)]
    ops += [("poll", "a", 0), ("pubw", "a", b"w1"), ("pubw", "a", b"w2"), ("poll", "b", 0), ("poll", "b", 0), ("poll", "c", 0)]
    ops += [("pubw", "a", b"w3"), ("poll", "b", 0), ("poll", "c", 0)]
    got = _drive(tmem.MemoryBroker, tmem.reset, "tt_broker", ops)
    want = _drive(jmem.MemoryBroker, jmem.reset, "tt_broker", ops)
    assert got == want
    assert "BrokerShedError" in got[0] and got[1][1] > 0
    # drop-oldest at maxlen without shedding
    ops2 = [("pub", "a", b"%d" % i, dict(maxlen=3)) for i in range(5)] + [("con", "a", 10)]
    assert _drive(tmem.MemoryBroker, tmem.reset, "tt_b2", ops2) == _drive(jmem.MemoryBroker, jmem.reset, "tt_b2", ops2)


def test_port_hubs_are_separate_from_the_reference_hubs():
    tmem.reset("tt_sep")
    jmem.reset("tt_sep")
    tbase.connect("mem://tt_sep").publish_experience(b"x")
    assert jmem.MemoryBroker("tt_sep").experience_depth() == 0
    assert tbase.connect("mem://tt_sep").experience_depth() == 1


@pytest.mark.parametrize("url", ["tcp://127.0.0.1:1", "amqp://guest@localhost/", "mem://a,mem://b", "tcp://h:1,tcp://h:2"])
def test_connect_refuses_unported_brokers(url, monkeypatch):
    """No scheme is refused any more. amqp:// is ported
    (tests/test_torch_rmq.py): it needs pika (the fake one here), and
    without it says so. tcp:// (tests/test_torch_tcp.py) dials at
    construction, so a dead address fails fast instead. A comma list
    builds the broker fabric (tests/test_torch_fabric.py), which dials no
    shard until it is used."""
    if url.startswith("tcp://") and "," not in url:
        with pytest.raises(ConnectionError):
            tbase.connect(url)
        return
    if "," in url:
        from dotaclient_tpu_torch.transport.fabric import FabricBroker

        fb = tbase.connect(url)
        assert isinstance(fb, FabricBroker) and fb.endpoints == url.split(",")
        fb.close()
        return
    from tests import fake_pika
    from dotaclient_tpu_torch.transport.rmq import RmqBroker

    if "pika" not in sys.modules:
        with pytest.raises(ImportError, match="pika"):
            tbase.connect(url)
    monkeypatch.setitem(sys.modules, "pika", fake_pika)
    fake_pika.reset()
    b = tbase.connect(url)
    b.publish_experience(b"x")
    assert isinstance(b, RmqBroker) and b.consume_experience(4, timeout=1.0) == [b"x"]
    fake_pika.reset()


def test_connect_mem_and_unknown_scheme():
    assert isinstance(tbase.connect("mem://tt_c"), tmem.MemoryBroker)
    with pytest.raises(ValueError, match="unknown broker url"):
        tbase.connect("ftp://x")


# --------------------------------------------------------------------- bf16


def _special_f32():
    bits = [
        0x7FC00000, 0xFFC00000, 0x7FA00000, 0xFFA00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,  # NaNs
        0x7F800000, 0xFF800000,  # ±inf
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x7F7F8001,  # overflow to inf / largest finite
        0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x00007FFF, 0x007FFFFF, 0x00800000, 0x80008000,  # denormals
        0x3F808000, 0x3F818000, 0x3F80C000, 0x3F80BFFF, 0xBF808000, 0xBF818000,  # ties and neighbours
        0x00000000, 0x80000000, 0x3F800000,
    ]
    return np.array(bits, np.uint32)


def test_explicit_bf16_rounding_equals_ml_dtypes_bitwise():
    r = np.random.RandomState(0)
    bits = np.concatenate([_special_f32(), r.randint(0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32)])
    x = bits.view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = tser.f32_to_bf16_bits(x)
    assert got.dtype == np.uint16 and np.array_equal(got, want)
    # widening back is exact
    w = tser.bf16_bits_to_f32(want)
    assert np.array_equal(w.view(np.uint32), want.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


def test_obs_casts_round_like_ml_dtypes_with_signed_nans():
    """The staging cast and the source cast both use the explicit rounding,
    negative NaNs included (torch's own CPU cast does not quiet them to
    sign | 0x7fc0)."""
    from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
    from dotaclient_tpu.parallel import train_step as jts
    from dotaclient_tpu.runtime.staging import cast_obs_to_compute_dtype as j_cast
    from dotaclient_tpu_torch.config import LearnerConfig
    from dotaclient_tpu_torch.ops import batch as tbatch

    x = np.resize(_special_f32().view(np.float32), (2, 3, JF.MAX_UNITS, JF.UNIT_FEATURES))
    jb = jts.make_train_batch(JLearnerConfig(batch_size=2, seq_len=2), 0)
    jb = jb._replace(obs=jb.obs._replace(unit_feats=x))
    tb = tbatch.make_train_batch(LearnerConfig(batch_size=2, seq_len=2), 0)
    tb = tb._replace(obs=tb.obs._replace(unit_feats=x))
    with np.errstate(invalid="ignore", over="ignore"):
        want = j_cast(JLearnerConfig(batch_size=2, seq_len=2), jb).obs.unit_feats.view(np.uint16)
    assert np.array_equal(tser.bf16_bits(cast_obs_to_compute_dtype(LearnerConfig(batch_size=2, seq_len=2), tb).obs.unit_feats), want)
    r = make_rollout(L=2, H=8)
    r = r._replace(obs=r.obs._replace(unit_feats=x[0]))
    with np.errstate(invalid="ignore", over="ignore"):
        jr = jser.cast_rollout_obs_bf16(r)
    tr = tser.cast_rollout_obs_bf16(to_port(r))
    assert np.array_equal(tser.bf16_bits(tr.obs.unit_feats), np.asarray(jr.obs.unit_feats).view(np.uint16))
    assert tser.serialize_rollout(tr) == jser.serialize_rollout(jr)
