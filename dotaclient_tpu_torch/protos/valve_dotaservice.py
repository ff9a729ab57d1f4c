"""A real dotaservice's gRPC messages (own copy of
dotaclient_tpu/protos/valve_dotaservice.proto, proto3, `package
dotaservice`): the Team, Hero, HeroControlMode, HostMode and Status enums,
HeroPick, GameConfig, Empty, ObserveConfig, Observation,
InitialObservation and Actions. Same field numbers and wire bytes as the
protoc-generated `valve_dotaservice_pb2`; the worldstate and its orders
are protos/valve_worldstate.py's."""

from __future__ import annotations

from dotaclient_tpu_torch.protos.message import EnumType, Field, Message
from dotaclient_tpu_torch.protos.valve_worldstate import Action, CMsgBotWorldState

Team = EnumType("Team", {"TEAM_UNDEFINED": 0, "TEAM_RADIANT": 2, "TEAM_DIRE": 3})
# Valve hero ids (the reference-era 1v1 pool and the hero-pool heroes)
Hero = EnumType("Hero", {
    "NPC_DOTA_HERO_NONE": 0, "NPC_DOTA_HERO_ANTIMAGE": 1, "NPC_DOTA_HERO_AXE": 2, "NPC_DOTA_HERO_BLOODSEEKER": 4,
    "NPC_DOTA_HERO_DROW_RANGER": 6, "NPC_DOTA_HERO_NEVERMORE": 11, "NPC_DOTA_HERO_SVEN": 18,
    "NPC_DOTA_HERO_LINA": 25, "NPC_DOTA_HERO_SNIPER": 35, "NPC_DOTA_HERO_VIPER": 47,
})
HeroControlMode = EnumType("HeroControlMode", {
    "HERO_CONTROL_MODE_IDLE": 0, "HERO_CONTROL_MODE_DEFAULT": 1, "HERO_CONTROL_MODE_CONTROLLED": 2,
})
HostMode = EnumType("HostMode", {"HOST_MODE_DEDICATED": 0, "HOST_MODE_GUI": 1, "HOST_MODE_GUI_MENU": 2})
Status = EnumType("Status", {"OK": 0, "RESOURCE_EXHAUSTED": 1, "FAILED_PRECONDITION": 2})

# the enums' values at module level, as protoc puts a file's top-level enums
for _enum in (Team, Hero, HeroControlMode, HostMode, Status):
    globals().update(_enum._values)


class HeroPick(Message):
    """`bot_difficulty` is the framework's extension: a DEFAULT-mode hero's
    scripted difficulty, so the hard bot survives the dialect."""

    FIELDS = (
        Field(1, "team_id", "enum"),
        Field(2, "hero_id", "enum"),
        Field(3, "control_mode", "enum"),
        Field(4, "bot_difficulty", "int32"),
    )


class GameConfig(Message):
    """`max_dota_time` and `seed` are the framework's extensions (a stock
    dotaservice skips them): the episode horizon and the env's seed."""

    FIELDS = (
        Field(1, "host_timescale", "float"),
        Field(2, "ticks_per_observation", "uint32"),
        Field(3, "host_mode", "enum"),
        Field(4, "game_mode", "uint32"),
        Field(5, "hero_picks", HeroPick, repeated=True),
        Field(6, "max_dota_time", "float"),
        Field(7, "seed", "uint64"),
    )


class Empty(Message):
    FIELDS = ()


class ObserveConfig(Message):
    FIELDS = (Field(1, "team_id", "enum"),)


class Observation(Message):
    FIELDS = (
        Field(1, "status", "enum"),
        Field(2, "world_state", CMsgBotWorldState),
        Field(3, "team_id", "enum"),
    )


class InitialObservation(Message):
    FIELDS = (
        Field(1, "world_state", CMsgBotWorldState),
        Field(2, "player_ids", "int32", repeated=True),
    )


class Actions(Message):
    FIELDS = (
        Field(1, "dota_time", "float"),
        Field(2, "actions", Action, repeated=True),
        Field(3, "team_id", "enum"),
    )
