"""Environment-API messages (dotaclient_tpu/protos/dotaservice.proto):
HeroPick, GameConfig, Action with its Type enum, Actions, ObserveRequest,
Observation with its Status enum, Empty. Same field numbers and wire
bytes as the protoc-generated `dotaservice_pb2`."""

from __future__ import annotations

from dotaclient_tpu_torch.protos.message import EnumType, Field, Message
from dotaclient_tpu_torch.protos.worldstate import World


class HeroPick(Message):
    """`control_mode`: 0 scripted bot, 1 external agent, 2 hard scripted."""

    FIELDS = (
        Field(1, "team_id", "int32"),
        Field(2, "hero_name", "string"),
        Field(3, "control_mode", "int32"),
    )


class GameConfig(Message):
    """`seed` drives a fake env's randomness; `max_dota_time` <= 0 means
    no limit."""

    FIELDS = (
        Field(1, "host_timescale", "float"),
        Field(2, "ticks_per_observation", "int32"),
        Field(3, "host_mode", "int32"),
        Field(4, "game_mode", "int32"),
        Field(5, "hero_picks", HeroPick, repeated=True),
        Field(6, "seed", "uint64"),
        Field(7, "max_dota_time", "float"),
    )


class Action(Message):
    Type = EnumType("Type", {"NOOP": 0, "MOVE": 1, "ATTACK": 2, "CAST": 3})
    NOOP, MOVE, ATTACK, CAST = range(4)
    FIELDS = (
        Field(1, "type", "enum"),
        Field(2, "player_id", "int32"),
        Field(3, "move_x", "float"),  # absolute map target of MOVE
        Field(4, "move_y", "float"),
        Field(5, "target_handle", "uint32"),  # unit of ATTACK / targeted CAST
        Field(6, "ability_slot", "int32"),
    )


class Actions(Message):
    FIELDS = (
        Field(1, "actions", Action, repeated=True),
        Field(2, "dota_time", "float"),
        Field(3, "team_id", "int32"),
    )


class ObserveRequest(Message):
    FIELDS = (Field(1, "team_id", "int32"),)


class Observation(Message):
    Status = EnumType("Status", {"OK": 0, "EPISODE_DONE": 1, "RESOURCE_EXHAUSTED": 2})
    OK, EPISODE_DONE, RESOURCE_EXHAUSTED = range(3)
    FIELDS = (
        Field(1, "status", "enum"),
        Field(2, "world_state", World),
        Field(3, "team_id", "int32"),
    )


class Empty(Message):
    FIELDS = ()
