"""The port's valve messages (dotaclient_tpu_torch/protos/valve_worldstate.py,
proto2, and valve_dotaservice.py, proto3) byte for byte against the
reference's protoc-generated `valve_*_pb2`: the goldens of
tests/test_valve_wire.py both ways, Hypothesis-drawn worlds, actions and
configs encoded equal and parsed by each side from the other's bytes, and
the proto2 semantics the adapter relies on (presence of a scalar set to
zero, `HasField` on set, unset and cleared scalars, the declared default,
a closed enum, oneof last-set-wins and `WhichOneof`). The proto3 messages
keep the bytes they had before the codec learned proto2."""

from __future__ import annotations

import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dotaclient_tpu.protos import dotaservice_pb2 as jds
from dotaclient_tpu.protos import valve_dotaservice_pb2 as rvds
from dotaclient_tpu.protos import valve_worldstate_pb2 as rvw
from dotaclient_tpu.protos import worldstate_pb2 as jws
from dotaclient_tpu_torch.protos import dotaservice as tds
from dotaclient_tpu_torch.protos import event as tev
from dotaclient_tpu_torch.protos import valve_dotaservice as vds
from dotaclient_tpu_torch.protos import valve_worldstate as vw
from dotaclient_tpu_torch.protos import worldstate as tws
from test_valve_wire import ACTIONS_GOLDEN_HEX, WORLD_GOLDEN_HEX, make_golden_actions, make_golden_world

W, RW = vw.CMsgBotWorldState, rvw.CMsgBotWorldState
RA = RW.Action

# port class → protobuf class, every message of both files
PB = {
    W: RW, W.Vector: RW.Vector, W.Player: RW.Player, W.Ability: RW.Ability, W.Modifier: RW.Modifier,
    W.TrackingProjectile: RW.TrackingProjectile, W.DroppedItem: RW.DroppedItem, W.RuneInfo: RW.RuneInfo,
    W.Unit: RW.Unit, W.Action: RA, W.Actions: RW.Actions,
    vds.HeroPick: rvds.HeroPick, vds.GameConfig: rvds.GameConfig, vds.Empty: rvds.Empty,
    vds.ObserveConfig: rvds.ObserveConfig, vds.Observation: rvds.Observation,
    vds.InitialObservation: rvds.InitialObservation, vds.Actions: rvds.Actions,
}
for _f in W.Action.FIELDS:
    if _f.oneof:
        PB[_f.kind] = getattr(RA, _f.kind.__name__)

SETTINGS = settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])

_FLOATS = st.one_of(
    st.floats(allow_nan=False, allow_infinity=True, width=32),
    st.sampled_from([0.0, -0.0, 0.1, 1e40, -1e40, 1e-45, math.inf, -math.inf, math.nan]),
)
_SCALARS = {
    "int32": st.one_of(st.integers(-(2**31), 2**31 - 1), st.sampled_from([0, -1, 2**31 - 1])),
    "enum": st.integers(-3, 50),  # proto3 enums are open
    "uint32": st.one_of(st.integers(0, 2**32 - 1), st.sampled_from([0, 2**32 - 1])),
    "uint64": st.one_of(st.integers(0, 2**64 - 1), st.sampled_from([0, 2**64 - 1])),
    "bool": st.booleans(),
    "float": _FLOATS,
    "string": st.text(max_size=8),
}


def _scalar(f):
    if f.enum is not None:  # a closed (proto2) enum: only its own values
        return st.sampled_from(sorted(f.enum._names))
    return _SCALARS[f.kind]


def _spec(cls, depth: int = 0):
    """Field name → value (nested messages as dicts, repeated fields as
    lists); at most one member of each oneof, under the key "oneof"."""
    fields, oneof = {}, []
    for f in cls.FIELDS:
        if f.message:
            if depth > 2:
                continue
            sub = _spec(f.kind, depth + 1)
            if f.oneof:
                oneof.append(st.tuples(st.just(f.name), sub))
                continue
            value = st.lists(sub, max_size=2 if depth == 0 else 1) if f.repeated else st.one_of(st.none(), sub)
        elif f.repeated:
            value = st.lists(_scalar(f), max_size=12)
        else:
            value = _scalar(f)
        fields[f.name] = value
    if oneof:
        fields["oneof"] = st.one_of(st.none(), *oneof)
    return st.fixed_dictionaries({}, optional=fields)


def _build(cls, spec, pb: bool):
    kw = {}
    for f in cls.FIELDS:
        v = spec.get(f.name)
        if f.oneof and spec.get("oneof") and spec["oneof"][0] == f.name:
            v = spec["oneof"][1]
        elif f.oneof or f.name not in spec:
            continue
        if f.message:
            if f.repeated:
                v = [_build(f.kind, x, pb) for x in v]
            elif v is not None:
                v = _build(f.kind, v, pb)
            else:
                continue
        kw[f.name] = v
    return (PB[cls] if pb else cls)(**kw)


def _assert_same_values(ours, theirs):
    """Field by field: presence, values (floats by their bits)."""
    for f in type(ours).FIELDS:
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.message and f.repeated:
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                _assert_same_values(x, y)
            continue
        if not f.repeated and (f.message or type(ours).SYNTAX == "proto2" or f.oneof):
            assert ours.HasField(f.name) == theirs.HasField(f.name), f.name
        if f.message:
            _assert_same_values(a, b)
        elif f.repeated:
            assert list(a) == list(b), f.name
        elif f.kind == "float":
            assert np.float32(a).tobytes() == np.float32(b).tobytes(), (f.name, a, b)
        else:
            assert a == b, (f.name, a, b)
    for group in type(ours)._ONEOFS:
        assert ours.WhichOneof(group) == theirs.WhichOneof(group)


# ------------------------------------------------------------- goldens


def _port_golden_world():
    w = W(team_id=2, game_time=5.0, dota_time=12.5, game_state=4)
    w.players.add(player_id=0, hero_id=11, is_alive=True, kills=1, deaths=2, team_id=2)
    u = w.units.add(handle=7, unit_type=W.HERO, name="npc", team_id=2, level=3, is_alive=True, health=500,
                    health_max=600, xp_needed_to_level=100, reliable_gold=25, unreliable_gold=50, last_hits=4,
                    denies=1)
    u.location.x = 1.0
    u.location.y = 2.0
    return w


def _port_golden_actions():
    a = W.Actions(dota_time=12.5)
    move = a.actions.add(actionType=W.Action.DOTA_UNIT_ORDER_MOVE_DIRECTLY, player=0)
    move.moveDirectly.location.x = -100.0
    move.moveDirectly.location.y = 250.0
    atk = a.actions.add(actionType=W.Action.DOTA_UNIT_ORDER_ATTACK_TARGET, player=0)
    atk.attackTarget.target = 7
    atk.attackTarget.once = True
    cast = a.actions.add(actionType=W.Action.DOTA_UNIT_ORDER_CAST_TARGET, player=0)
    cast.castTarget.abilitySlot = 0
    cast.castTarget.target = 7
    return a


@pytest.mark.parametrize("name", ["world", "actions"])
def test_goldens_encode_and_decode_both_ways(name):
    ours, theirs, hexed = {
        "world": (_port_golden_world(), make_golden_world(), WORLD_GOLDEN_HEX),
        "actions": (_port_golden_actions(), make_golden_actions(), ACTIONS_GOLDEN_HEX),
    }[name]
    data = bytes.fromhex(hexed)
    assert ours.SerializeToString() == theirs.SerializeToString() == data
    cls = type(ours)
    assert cls.FromString(data).SerializeToString() == data
    _assert_same_values(cls.FromString(data), PB[cls].FromString(data))
    assert PB[cls].FromString(ours.SerializeToString()) == theirs


def test_golden_decode_lands_in_the_named_fields():
    w = W.FromString(bytes.fromhex(WORLD_GOLDEN_HEX))
    assert w.team_id == 2 and w.game_state == 4 and w.dota_time == 12.5
    (p,) = w.players
    assert (p.hero_id, p.kills, p.deaths) == (11, 1, 2)
    (u,) = w.units
    assert u.unit_type == W.HERO and u.handle == 7 and u.name == "npc"
    assert u.health == 500 and u.xp_needed_to_level == 100 and (u.reliable_gold, u.unreliable_gold) == (25, 50)
    assert (u.location.x, u.location.y) == (1.0, 2.0) and not u.location.HasField("z")
    move, atk, cast = W.Actions.FromString(bytes.fromhex(ACTIONS_GOLDEN_HEX)).actions
    assert move.actionType == W.Action.DOTA_UNIT_ORDER_MOVE_DIRECTLY and move.moveDirectly.location.x == -100.0
    assert [x.WhichOneof("actionData") for x in (move, atk, cast)] == ["moveDirectly", "attackTarget", "castTarget"]
    assert atk.attackTarget.target == 7 and atk.attackTarget.once
    assert cast.castTarget.target == 7 and cast.castTarget.abilitySlot == 0 and cast.castTarget.HasField("abilitySlot")


# ---------------------------------------------------------- hypothesis


DRAWN = {"world": W, "unit": W.Unit, "action": W.Action, "actions": W.Actions, "valve_actions": vds.Actions,
         "config": vds.GameConfig, "observation": vds.Observation, "initial": vds.InitialObservation}


@pytest.mark.parametrize("name", sorted(DRAWN))
def test_drawn_messages_encode_equal_and_parse_both_ways(name):
    cls = DRAWN[name]

    @SETTINGS
    @given(_spec(cls))
    def check(spec):
        ours, theirs = _build(cls, spec, False), _build(cls, spec, True)
        data = ours.SerializeToString()
        assert data == theirs.SerializeToString()
        assert PB[cls].FromString(data).SerializeToString() == data
        assert cls.FromString(data).SerializeToString() == data
        _assert_same_values(cls.FromString(data), PB[cls].FromString(data))
        _assert_same_values(ours, theirs)

    check()


# -------------------------------------------------------------- proto2


def test_a_scalar_set_to_zero_is_written_and_present():
    for ours, theirs in ((W.Unit(health=0), RW.Unit(health=0)), (W.Vector(x=-0.0, y=0.0), RW.Vector(x=-0.0, y=0.0)),
                         (W.Player(is_alive=False, team_id=0), RW.Player(is_alive=False, team_id=0))):
        assert ours.SerializeToString() == theirs.SerializeToString() != b""
    u = W.Unit()
    u.health = 0
    u.name = ""
    assert u.HasField("health") and u.HasField("name") and u.SerializeToString() == b"\x1a\x00p\x00"
    assert RW.Unit(health=0, name="").SerializeToString() == u.SerializeToString()


def test_hasfield_on_set_unset_and_cleared_scalars():
    ours, theirs = W.Unit(), RW.Unit()
    for m in (ours, theirs):
        assert not m.HasField("player_id") and not m.HasField("xp_needed_to_level") and m.player_id == 0
        m.player_id = 0
        m.xp_needed_to_level = 7
        assert m.HasField("player_id") and m.HasField("xp_needed_to_level")
        m.ClearField("player_id")
        assert not m.HasField("player_id") and m.player_id == 0 and m.HasField("xp_needed_to_level")
    assert ours.SerializeToString() == theirs.SerializeToString()
    parsed = W.Unit.FromString(RW.Unit(player_id=0).SerializeToString())
    assert parsed.HasField("player_id") and not parsed.HasField("level")
    with pytest.raises(ValueError):
        W.Unit().HasField("abilities")  # repeated: no presence


def test_declared_default_and_closed_enum():
    ours, theirs = W.Action(), RA()
    assert ours.actionType == theirs.actionType == W.Action.DOTA_UNIT_ORDER_NONE
    assert not ours.HasField("actionType") and ours.SerializeToString() == b""
    ours.actionType = W.Action.DOTA_UNIT_ORDER_NONE
    theirs.actionType = RA.DOTA_UNIT_ORDER_NONE
    assert ours.HasField("actionType") and ours.SerializeToString() == theirs.SerializeToString() == b"\x08\x00"
    for bad in (29, 99, -1):
        with pytest.raises(ValueError):
            ours.actionType = bad
        with pytest.raises(ValueError):
            theirs.actionType = bad
    assert W.Action.Type.Value("ACTION_COURIER") == RA.Type.Value("ACTION_COURIER") == 43
    assert W.UnitType.Name(9) == RW.UnitType.Name(9) == "FORT"
    with pytest.raises(ValueError):
        vds.Hero.Value("NPC_DOTA_HERO_PUDGE")
    with pytest.raises(ValueError):
        rvds.Hero.Value("NPC_DOTA_HERO_PUDGE")
    assert vds.Hero.Value("NPC_DOTA_HERO_SNIPER") == rvds.NPC_DOTA_HERO_SNIPER == vds.NPC_DOTA_HERO_SNIPER


def test_oneof_last_set_wins_and_which_oneof():
    ours, theirs = W.Action(actionType=4), RA(actionType=4)
    for m in (ours, theirs):
        assert m.WhichOneof("actionData") is None and not m.HasField("actionData")
        m.moveDirectly.location.x = 1.0
        assert m.WhichOneof("actionData") == "moveDirectly"
        m.attackTarget.target = 3
        assert m.WhichOneof("actionData") == "attackTarget" and not m.HasField("moveDirectly")
        assert m.HasField("actionData")
    assert ours.SerializeToString() == theirs.SerializeToString()
    # a parse keeps the last member on the wire
    wire = RA(moveDirectly=RA.MoveToLocation()).SerializeToString() + RA(castTarget=RA.CastTarget(target=5)
                                                                        ).SerializeToString()
    parsed, ref = W.Action.FromString(wire), RA.FromString(wire)
    assert parsed.WhichOneof("actionData") == ref.WhichOneof("actionData") == "castTarget"
    assert parsed.castTarget.target == 5 and parsed.SerializeToString() == ref.SerializeToString()
    # clearing the group, and merging a member in, as protobuf does
    ours.ClearField("actionData")
    theirs.ClearField("actionData")
    assert ours.WhichOneof("actionData") is None and ours.SerializeToString() == theirs.SerializeToString()
    ours.MergeFrom(parsed)
    theirs.MergeFrom(ref)
    assert ours.WhichOneof("actionData") == "castTarget" and ours.SerializeToString() == theirs.SerializeToString()


def test_repeated_scalars_proto2_unpacked_proto3_packed():
    init = vds.InitialObservation(player_ids=[0, 1, -1])
    assert init.SerializeToString() == rvds.InitialObservation(player_ids=[0, 1, -1]).SerializeToString()
    assert init.SerializeToString()[:2] == b"\x12\x0c"  # one LEN record: packed
    unpacked = b"\x10\x00\x10\x01\x10\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01"
    assert vds.InitialObservation.FromString(unpacked).player_ids == [0, 1, -1]
    assert [f.packed for f in W.Unit.FIELDS if f.repeated and not f.message] == []
    assert vds.InitialObservation._BY_NAME["player_ids"].packed is True


# ---------------------------------------------------------- proto3 kept


def test_proto3_messages_keep_their_bytes():
    """Hex written by the codec before it learned proto2, and protobuf's
    bytes for the same env messages."""
    ev = tev.Event(wall_time=1718000000.25, step=7, file_version="brain.Event:2")
    ev2 = tev.Event(wall_time=2.5, step=-3)
    ev2.summary.value.add(tag="loss", simple_value=0.0)
    ev2.summary.value.add(tag="kl", simple_value=-1.5)
    assert ev.SerializeToString().hex() == "0900001060a699d94110071a0d627261696e2e4576656e743a32"
    assert ev2.SerializeToString().hex() == (
        "09000000000000044010fdffffffffffffffff012a180a0b0a046c6f737315000000000a090a026b6c150000c0bf")
    assert ev2.WhichOneof("what") == "summary" and ev.WhichOneof("what") == "file_version"
    worlds = []
    for ws_mod in (tws, jws):
        w = ws_mod.World(dota_time=-0.0, game_state=0, tick=3, team_id=2, player_ids=[0, -1, 5], winning_team=0)
        u = w.units.add(handle=9, unit_type=1, player_id=-1, x=0.0, health=1.5, is_alive=True)
        u.abilities.add(slot=0, cooldown_remaining=0.0, is_castable=False)
        worlds.append(w.SerializeToString())
    assert worlds[0] == worlds[1] and worlds[0].hex() == (
        "0d00000080180320022a1a0809100128ffffffffffffffffff01650000c03fa80101fa0100320c00ffffffffffffffffff0105")
    obs = []
    for ds_mod in (tds, jds):
        o = ds_mod.Observation(status=0, team_id=3)
        o.world_state.tick = 0
        obs.append(o.SerializeToString())
    assert obs[0] == obs[1] == bytes.fromhex("12001803")
    assert not tws.Unit(health=0.0).HasField("health") and tws.Unit(health=0.0).SerializeToString() == b""
