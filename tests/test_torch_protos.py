"""The port's proto3 messages (dotaclient_tpu_torch/protos) against the
protoc-generated `google.protobuf` modules of the reference: the same wire
bytes for every message both ways, equal field values after a parse,
unknown fields skipped, and assignment rounding floats to the f32 upb
stores."""

from __future__ import annotations

import math
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dotaclient_tpu.protos import dotaservice_pb2 as jds
from dotaclient_tpu.protos import worldstate_pb2 as jws
from dotaclient_tpu_torch.protos import dotaservice as tds
from dotaclient_tpu_torch.protos import worldstate as tws
from dotaclient_tpu_torch.protos.message import DecodeError

# port class name → (port class, protobuf class)
MESSAGES = {
    "Ability": (tws.Ability, jws.Ability),
    "Unit": (tws.Unit, jws.Unit),
    "World": (tws.World, jws.World),
    "HeroPick": (tds.HeroPick, jds.HeroPick),
    "GameConfig": (tds.GameConfig, jds.GameConfig),
    "Action": (tds.Action, jds.Action),
    "Actions": (tds.Actions, jds.Actions),
    "ObserveRequest": (tds.ObserveRequest, jds.ObserveRequest),
    "Observation": (tds.Observation, jds.Observation),
    "Empty": (tds.Empty, jds.Empty),
}
_PB_BY_PORT = {port: pb for port, pb in MESSAGES.values()}

SETTINGS = settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])

_FLOATS = st.one_of(
    st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from([0.0, -0.0, 0.1, 1e40, -1e40, 3.4028235e38, 1e-45, -1e-46, math.inf, -math.inf, math.nan]),
)
_SCALARS = {
    "int32": st.one_of(st.integers(-(2**31), 2**31 - 1), st.sampled_from([0, -1, -(2**31), 2**31 - 1])),
    "enum": st.integers(-3, 20),
    "uint32": st.one_of(st.integers(0, 2**32 - 1), st.sampled_from([0, 2**32 - 1, 2**32 - 2, 2**31])),
    "uint64": st.one_of(st.integers(0, 2**64 - 1), st.sampled_from([0, 2**64 - 1, 2**63, 2**32])),
    "bool": st.booleans(),
    "float": _FLOATS,
    "string": st.text(max_size=12),
}


def _spec(cls, depth: int = 0):
    """A strategy of field specs for `cls`: a dict of field name → value,
    nested messages as dicts, repeated fields as lists (up to 40 ints)."""
    fields = {}
    for f in cls.FIELDS:
        if f.message:
            sub = _spec(f.kind, depth + 1)
            value = st.lists(sub, max_size=3 if depth == 0 else 2) if f.repeated else st.one_of(st.none(), sub)
        elif f.repeated:
            value = st.lists(_SCALARS[f.kind], max_size=40)
        else:
            value = _SCALARS[f.kind]
        fields[f.name] = value
    return st.fixed_dictionaries({}, optional=fields)


def _build(cls, spec, pb: bool):
    """The message of `spec`, in the port (pb False) or protobuf."""
    kw = {}
    for f in cls.FIELDS:
        if f.name not in spec:
            continue
        v = spec[f.name]
        if f.message:
            if f.repeated:
                v = [_build(f.kind, x, pb) for x in v]
            elif v is not None:
                v = _build(f.kind, v, pb)
            else:
                continue
        kw[f.name] = v
    return (_PB_BY_PORT[cls] if pb else cls)(**kw)


def _assert_same_values(port_msg, pb_msg):
    """Field by field, floats by their bits."""
    for f in type(port_msg).FIELDS:
        a, b = getattr(port_msg, f.name), getattr(pb_msg, f.name)
        if f.message and f.repeated:
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                _assert_same_values(x, y)
        elif f.message:
            assert port_msg.HasField(f.name) == pb_msg.HasField(f.name), f.name
            _assert_same_values(a, b)
        elif f.repeated:
            assert list(a) == list(b), f.name
        elif f.kind == "float":
            assert np.float32(a).tobytes() == np.float32(b).tobytes(), (f.name, a, b)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_serialize_equals_protobuf_both_ways(name):
    port_cls, pb_cls = MESSAGES[name]

    @SETTINGS
    @given(_spec(port_cls))
    def check(spec):
        ours, theirs = _build(port_cls, spec, False), _build(port_cls, spec, True)
        data = ours.SerializeToString()
        assert data == theirs.SerializeToString()
        assert pb_cls.FromString(data).SerializeToString() == data
        assert port_cls.FromString(theirs.SerializeToString()).SerializeToString() == data

    check()


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_parsing_protobuf_bytes_gives_equal_values(name):
    port_cls, pb_cls = MESSAGES[name]

    @SETTINGS
    @given(_spec(port_cls))
    def check(spec):
        theirs = _build(port_cls, spec, True)
        data = theirs.SerializeToString()
        _assert_same_values(port_cls.FromString(data), pb_cls.FromString(data))
        _assert_same_values(_build(port_cls, spec, False), theirs)

    check()


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


_UNKNOWN = st.lists(
    st.one_of(
        st.builds(lambda n, v: _varint((n << 3) | 0) + _varint(v), st.integers(40, 2000), st.integers(0, 2**64 - 1)),
        st.builds(lambda n, v: _varint((n << 3) | 1) + v, st.integers(40, 2000), st.binary(min_size=8, max_size=8)),
        st.builds(lambda n, v: _varint((n << 3) | 2) + _varint(len(v)) + v, st.integers(40, 2000), st.binary(max_size=9)),
        st.builds(lambda n, v: _varint((n << 3) | 5) + v, st.integers(40, 2000), st.binary(min_size=4, max_size=4)),
    ),
    min_size=1,
    max_size=4,
)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_unknown_fields_are_skipped(name):
    port_cls, pb_cls = MESSAGES[name]

    @SETTINGS
    @given(_spec(port_cls), _UNKNOWN, st.integers(0, 4))
    def check(spec, unknown, cut):
        data = _build(port_cls, spec, True).SerializeToString()
        k = min(cut, len(unknown))  # unknown fields before and after the known ones
        mixed = b"".join(unknown[:k]) + data + b"".join(unknown[k:])
        assert port_cls.FromString(mixed).SerializeToString() == data
        _assert_same_values(port_cls.FromString(mixed), pb_cls.FromString(mixed))

    check()


@SETTINGS
@given(_FLOATS)
def test_float_assignment_rounds_to_the_f32_upb_stores(v):
    for ours, theirs in ((tws.Unit(x=v).x, jws.Unit(x=v).x), (tds.Action(move_x=v).move_x, jds.Action(move_x=v).move_x)):
        assert np.float32(ours).tobytes() == np.float32(theirs).tobytes()
        assert struct.pack("<d", ours) == struct.pack("<d", theirs) or (math.isnan(ours) and math.isnan(theirs))
    u = tws.Unit()
    u.health = v
    assert u.SerializeToString() == jws.Unit(health=v).SerializeToString()


def test_the_value_semantics_the_fake_env_relies_on():
    assert tws.Unit(x=0.1).x == jws.Unit(x=0.1).x == 0.10000000149011612
    assert tds.Action(move_x=1e40).move_x == math.inf
    assert tws.Unit(x=-0.0).SerializeToString().hex() == "3500000080"
    assert tws.World(player_ids=[0, -1]).SerializeToString().hex() == "320b00ffffffffffffffffff01"
    assert tds.GameConfig(seed=2**64 - 1).seed == 2**64 - 1
    assert tws.Unit.FromString(jws.Unit(handle=2**32 - 1).SerializeToString()).handle == 2**32 - 1
    # fields in field-number order, whatever order they were set in
    u = tws.Unit()
    u.deaths, u.handle, u.x = 3, 7, 1.5
    assert u.SerializeToString() == jws.Unit(handle=7, x=1.5, deaths=3).SerializeToString()


def test_enum_constants_and_names_match():
    assert tws.Unit.UnitType.Name(tws.Unit.LANE_CREEP) == jws.Unit.UnitType.Name(jws.Unit.LANE_CREEP)
    for name in jws.Unit.UnitType.keys():
        assert getattr(tws.Unit, name) == getattr(jws.Unit, name) == tws.Unit.UnitType.Value(name)
    for name in jds.Action.Type.keys():
        assert getattr(tds.Action, name) == getattr(jds.Action, name)
    for name in jds.Observation.Status.keys():
        assert getattr(tds.Observation, name) == getattr(jds.Observation, name)


def test_bad_values_raise_as_protobuf_does():
    for kw, err in (({"level": 1.5}, TypeError), ({"handle": -1}, ValueError), ({"handle": 2**32}, ValueError),
                    ({"x": "1"}, TypeError), ({"team_id": 2**31}, ValueError), ({"name": 3}, TypeError)):
        with pytest.raises(err):
            tws.Unit(**kw)
        with pytest.raises(err):
            jws.Unit(**kw)
    with pytest.raises(ValueError):
        tws.Unit(bogus=1)
    with pytest.raises(AttributeError):
        tds.Observation().world_state = tws.World()
    with pytest.raises(DecodeError):
        tws.Unit.FromString(b"\x0a\x05ab")  # truncated length-delimited field
    with pytest.raises(DecodeError):
        tws.World.FromString(b"\x08")  # truncated varint


def test_message_fields_become_present_as_upb_marks_them():
    """A sub-message read and left alone is absent; a change through it,
    or CopyFrom into it, makes it present (written even when empty)."""
    for cls in (tds.Observation, jds.Observation):
        o = cls()
        _ = o.world_state.tick
        assert o.SerializeToString() == b"" and not o.HasField("world_state")
        o.world_state.tick = 0
        assert o.SerializeToString() == b"\x12\x00"
        o = cls()
        o.world_state.units.add()
        assert o.SerializeToString().hex() == "12022a00"
        o = cls()
        o.world_state.CopyFrom(tws.World() if cls is tds.Observation else jws.World())
        assert o.SerializeToString() == b"\x12\x00"


def test_repeated_fields_copy_and_extend_like_protobuf():
    ab = tws.Ability(slot=1)
    u = tws.Unit(abilities=[ab])
    ab.slot = 2
    assert u.abilities[0].slot == 1  # the constructor copied it
    w = tws.World()
    w.player_ids.extend(i for i in range(3))
    w.player_ids.append(-5)
    w.units.add(handle=4).abilities.add(level=2)
    assert w.SerializeToString() == jws.World(player_ids=[0, 1, 2, -5], units=[jws.Unit(
        handle=4, abilities=[jws.Ability(level=2)])]).SerializeToString()
    snap = tws.Unit()
    snap.CopyFrom(w.units[0])
    w.units[0].abilities[0].level = 9
    assert snap.abilities[0].level == 2 and snap == tws.Unit.FromString(snap.SerializeToString())
    with pytest.raises(TypeError):
        tws.Unit().CopyFrom(tws.World())


def test_event_messages_equal_tensorboards_protobuf():
    from tensorboard.compat.proto import event_pb2, summary_pb2

    from dotaclient_tpu_torch.protos.event import Event, Summary, SummaryValue

    for step, value, wall in ((0, 0.0, 0.0), (3, -1.5, 1.7e9), (-2, 1e40, 12.25), (2**40, float("nan"), -0.0)):
        ours = Event(wall_time=wall, step=step, summary=Summary(value=[SummaryValue(tag="loss", simple_value=value),
                                                                        SummaryValue(tag="", simple_value=0.0)]))
        theirs = event_pb2.Event(wall_time=wall, step=step, summary=summary_pb2.Summary(value=[
            summary_pb2.Summary.Value(tag="loss", simple_value=value), summary_pb2.Summary.Value(tag="", simple_value=0.0)]))
        assert ours.SerializeToString() == theirs.SerializeToString()
        assert Event.FromString(theirs.SerializeToString()).SerializeToString() == theirs.SerializeToString()
    assert Event(file_version="brain.Event:2").SerializeToString() == \
        event_pb2.Event(file_version="brain.Event:2").SerializeToString()


def test_metrics_logger_event_file_loads_in_tensorboard(tmp_path):
    """The learner's TensorBoard file, written without tensorboard or
    protobuf: tensorboard's own loader reads every scalar back, each
    record's checksums are TFRecord's."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto import event_pb2
    from tensorboard.compat.tensorflow_stub import pywrap_tensorflow

    from dotaclient_tpu_torch.runtime.metrics import MetricsLogger, masked_crc32c

    for data in (b"", b"a", bytes(range(256)) * 3):
        assert masked_crc32c(data) == pywrap_tensorflow.masked_crc32c(data)
    m = MetricsLogger(str(tmp_path))
    windows = [(10, {"loss": 0.5, "grad_norm": 0.0}), (20, {"loss": -1.25e-3, "env_steps_per_sec": 1e6})]
    for step, scalars in windows:
        m.log(step, scalars)
    m.close()
    (path,) = tmp_path.glob("events.out.tfevents.*")
    events = [event_pb2.Event.FromString(r) for r in RawEventFileLoader(str(path)).Load()]
    assert events[0].file_version == "brain.Event:2"
    got = [(e.step, {v.tag: v.simple_value for v in e.summary.value}) for e in events[1:]]
    assert got == [(s, {k: float(np.float32(v)) for k, v in d.items()}) for s, d in windows]
    raw, pos = path.read_bytes(), 0
    while pos < len(raw):
        (n,) = struct.unpack_from("<Q", raw, pos)
        assert struct.unpack_from("<I", raw, pos + 8)[0] == pywrap_tensorflow.masked_crc32c(raw[pos : pos + 8])
        body = raw[pos + 12 : pos + 12 + n]
        assert struct.unpack_from("<I", raw, pos + 12 + n)[0] == pywrap_tensorflow.masked_crc32c(body)
        pos += 16 + n
    assert pos == len(raw)
