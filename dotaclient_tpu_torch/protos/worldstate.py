"""World-state messages (dotaclient_tpu/protos/worldstate.proto): Ability,
Unit with its UnitType enum, World. Same field numbers and wire bytes as
the protoc-generated `worldstate_pb2`; package `dotaclient_tpu` on the
wire."""

from __future__ import annotations

from dotaclient_tpu_torch.protos.message import EnumType, Field, Message


class Ability(Message):
    FIELDS = (
        Field(1, "ability_id", "int32"),
        Field(2, "slot", "int32"),
        Field(3, "level", "int32"),
        Field(4, "cooldown_remaining", "float"),
        Field(5, "mana_cost", "float"),
        Field(6, "is_castable", "bool"),
    )


_UNIT_TYPES = {
    "INVALID": 0, "HERO": 1, "CREEP_HERO": 2, "LANE_CREEP": 3, "JUNGLE_CREEP": 4, "ROSHAN": 5, "TOWER": 6,
    "BARRACKS": 7, "SHRINE": 8, "FORT": 9, "BUILDING": 10, "COURIER": 11, "WARD": 12,
}


class Unit(Message):
    UnitType = EnumType("UnitType", _UNIT_TYPES)
    INVALID, HERO, CREEP_HERO, LANE_CREEP, JUNGLE_CREEP, ROSHAN, TOWER, BARRACKS, SHRINE, FORT, BUILDING, \
        COURIER, WARD = range(13)
    FIELDS = (
        Field(1, "handle", "uint32"),
        Field(2, "unit_type", "enum"),
        Field(3, "team_id", "int32"),
        Field(4, "name", "string"),
        Field(5, "player_id", "int32"),
        Field(6, "x", "float"),
        Field(7, "y", "float"),
        Field(8, "z", "float"),
        Field(9, "facing", "float"),
        Field(10, "speed", "float"),
        Field(11, "level", "int32"),
        Field(12, "health", "float"),
        Field(13, "health_max", "float"),
        Field(14, "health_regen", "float"),
        Field(15, "mana", "float"),
        Field(16, "mana_max", "float"),
        Field(17, "attack_damage", "float"),
        Field(18, "attack_range", "float"),
        Field(19, "attack_speed", "float"),
        Field(20, "armor", "float"),
        Field(21, "is_alive", "bool"),
        Field(22, "is_attacking", "bool"),
        Field(23, "attack_target_handle", "uint32"),
        Field(24, "gold", "int32"),
        Field(25, "xp", "int32"),
        Field(26, "xp_needed_to_level", "int32"),
        Field(27, "last_hits", "int32"),
        Field(28, "denies", "int32"),
        Field(29, "kills", "int32"),
        Field(30, "deaths", "int32"),
        Field(31, "abilities", Ability, repeated=True),
    )


class World(Message):
    """One observation tick bundle as the environment server emits it;
    `player_ids` are the players on `team_id` it is for, `winning_team`
    is set once the game has ended."""

    FIELDS = (
        Field(1, "dota_time", "float"),
        Field(2, "game_state", "int32"),
        Field(3, "tick", "uint32"),
        Field(4, "team_id", "int32"),
        Field(5, "units", Unit, repeated=True),
        Field(6, "player_ids", "int32", repeated=True),
        Field(7, "winning_team", "int32"),
    )
