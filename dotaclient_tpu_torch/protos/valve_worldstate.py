"""Valve's bot worldstate (own copy of
dotaclient_tpu/protos/valve_worldstate.proto, proto2, `package valve`):
`CMsgBotWorldState` with its nested messages and enums, the schema a real
dotaservice emits. Same field numbers and wire bytes as the
protoc-generated `valve_worldstate_pb2`; the numbering is that file's
transcription, whose provenance it states."""

from __future__ import annotations

from dotaclient_tpu_torch.protos.message import EnumType, Field, Message


def _export(cls, enum: EnumType) -> None:
    """Each constant of `enum` as an attribute of `cls`, as protoc's
    classes carry their nested enums' values."""
    for name, value in enum._values.items():
        setattr(cls, name, value)


class _Proto2(Message):
    SYNTAX = "proto2"


class Vector(_Proto2):
    FIELDS = (
        Field(1, "x", "float"),
        Field(2, "y", "float"),
        Field(3, "z", "float"),
    )


UnitType = EnumType("UnitType", {
    "INVALID": 0, "HERO": 1, "CREEP_HERO": 2, "LANE_CREEP": 3, "JUNGLE_CREEP": 4, "ROSHAN": 5, "TOWER": 6,
    "BARRACKS": 7, "SHRINE": 8, "FORT": 9, "BUILDING": 10, "COURIER": 11, "WARD": 12,
})


class Player(_Proto2):
    FIELDS = (
        Field(1, "player_id", "int32"),
        Field(2, "hero_id", "int32"),
        Field(3, "is_alive", "bool"),
        Field(4, "respawn_time", "float"),
        Field(5, "kills", "int32"),
        Field(6, "deaths", "int32"),
        Field(7, "team_id", "int32"),
    )


class Ability(_Proto2):
    FIELDS = (
        Field(1, "handle", "int32"),
        Field(2, "ability_id", "int32"),
        Field(3, "slot", "int32"),
        Field(4, "caster_handle", "int32"),
        Field(5, "level", "int32"),
        Field(6, "is_activated", "bool"),
        Field(7, "is_toggled", "bool"),
        Field(8, "is_in_ability_phase", "bool"),
        Field(9, "is_channeling", "bool"),
        Field(10, "is_stolen", "bool"),
        Field(11, "is_fully_castable", "bool"),
        Field(12, "cooldown_remaining", "float"),
        Field(13, "charges", "int32"),
        Field(14, "secondary_charges", "int32"),
        Field(15, "is_combined_locked", "bool"),
    )


class Modifier(_Proto2):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "stack_count", "int32"),
        Field(3, "remaining_duration", "float"),
        Field(4, "ability_handle", "int32"),
        Field(5, "ability_id", "int32"),
    )


class TrackingProjectile(_Proto2):
    FIELDS = (
        Field(1, "location", Vector),
        Field(2, "velocity", Vector),
        Field(3, "is_dodgeable", "bool"),
        Field(4, "is_attack", "bool"),
        Field(5, "caster_handle", "int32"),
        Field(6, "caster_unit_type", "int32"),
        Field(7, "ability_id", "int32"),
    )


class DroppedItem(_Proto2):
    FIELDS = (
        Field(1, "item_id", "int32"),
        Field(2, "location", Vector),
    )


class RuneInfo(_Proto2):
    FIELDS = (
        Field(1, "type", "int32"),
        Field(2, "location", Vector),
        Field(3, "status", "int32"),
        Field(4, "time_since_seen", "float"),
    )


_UNIT_SCALARS = (
    # (number, name, kind) of Unit's singular scalars, in field order
    (1, "handle", "uint32"), (3, "name", "string"), (4, "team_id", "int32"), (5, "level", "int32"),
    (7, "is_alive", "bool"), (8, "player_id", "int32"), (9, "bounding_radius", "float"), (10, "facing", "float"),
    (11, "ground_height", "float"), (12, "vision_range_daytime", "int32"), (13, "vision_range_nighttime", "int32"),
    (14, "health", "int32"), (15, "health_max", "int32"), (16, "health_regen", "float"), (17, "mana", "float"),
    (18, "mana_max", "float"), (19, "mana_regen", "float"), (20, "base_movement_speed", "int32"),
    (21, "current_movement_speed", "int32"), (22, "anim_activity", "int32"), (23, "anim_cycle", "float"),
    (24, "base_damage", "int32"), (25, "base_damage_variance", "int32"), (26, "attack_damage", "int32"),
    (27, "attack_range", "float"), (28, "attack_speed", "float"), (29, "attack_anim_point", "float"),
    (30, "attack_acquisition_range", "int32"), (31, "attack_projectile_speed", "int32"),
    (32, "attack_target_handle", "int32"), (33, "armor", "float"), (34, "magic_resist", "float"),
    (35, "evasion", "float"), (36, "xp_needed_to_level", "int32"), (37, "ability_points", "int32"),
    (38, "reliable_gold", "int32"), (39, "unreliable_gold", "int32"), (40, "last_hits", "int32"),
    (41, "denies", "int32"), (42, "net_worth", "int32"), (43, "strength", "int32"), (44, "agility", "int32"),
    (45, "intelligence", "int32"), (46, "primary_attribute", "int32"), (47, "is_illusion", "bool"),
    (48, "respawn_time", "float"), (49, "buyback_cost", "int32"), (50, "buyback_cooldown", "float"),
    (51, "spell_amplification", "float"), (56, "action_type", "int32"), (57, "ability_target_handle", "int32"),
    (58, "ability_target_name", "string"), (59, "is_using_ability", "bool"),
)


class Unit(_Proto2):
    FIELDS = tuple(Field(n, name, kind) for n, name, kind in _UNIT_SCALARS) + (
        Field(2, "unit_type", "enum", enum=UnitType),
        Field(6, "location", Vector),
        Field(52, "abilities", Ability, repeated=True),
        Field(53, "items", Ability, repeated=True),
        Field(54, "modifiers", Modifier, repeated=True),
        Field(55, "incoming_tracking_projectiles", TrackingProjectile, repeated=True),
    )


ActionType = EnumType("Type", {
    "DOTA_UNIT_ORDER_NONE": 0, "DOTA_UNIT_ORDER_MOVE_TO_POSITION": 1, "DOTA_UNIT_ORDER_MOVE_TO_TARGET": 2,
    "DOTA_UNIT_ORDER_ATTACK_MOVE": 3, "DOTA_UNIT_ORDER_ATTACK_TARGET": 4, "DOTA_UNIT_ORDER_CAST_POSITION": 5,
    "DOTA_UNIT_ORDER_CAST_TARGET": 6, "DOTA_UNIT_ORDER_CAST_TARGET_TREE": 7, "DOTA_UNIT_ORDER_CAST_NO_TARGET": 8,
    "DOTA_UNIT_ORDER_CAST_TOGGLE": 9, "DOTA_UNIT_ORDER_HOLD_POSITION": 10, "DOTA_UNIT_ORDER_TRAIN_ABILITY": 11,
    "DOTA_UNIT_ORDER_DROP_ITEM": 12, "DOTA_UNIT_ORDER_GIVE_ITEM": 13, "DOTA_UNIT_ORDER_PICKUP_ITEM": 14,
    "DOTA_UNIT_ORDER_PICKUP_RUNE": 15, "DOTA_UNIT_ORDER_PURCHASE_ITEM": 16, "DOTA_UNIT_ORDER_SELL_ITEM": 17,
    "DOTA_UNIT_ORDER_DISASSEMBLE_ITEM": 18, "DOTA_UNIT_ORDER_MOVE_ITEM": 19, "DOTA_UNIT_ORDER_CAST_TOGGLE_AUTO": 20,
    "DOTA_UNIT_ORDER_STOP": 21, "DOTA_UNIT_ORDER_TAUNT": 22, "DOTA_UNIT_ORDER_BUYBACK": 23,
    "DOTA_UNIT_ORDER_GLYPH": 24, "DOTA_UNIT_ORDER_EJECT_ITEM_FROM_STASH": 25, "DOTA_UNIT_ORDER_CAST_RUNE": 26,
    "DOTA_UNIT_ORDER_PING_ABILITY": 27, "DOTA_UNIT_ORDER_MOVE_DIRECTLY": 28, "ACTION_CHAT": 40,
    "ACTION_SWAP_ITEMS": 41, "ACTION_USE_SHRINE": 42, "ACTION_COURIER": 43,
})


def _order(name: str, *fields) -> type:
    """One of Action's order payloads (MoveToLocation, CastTarget, ...)."""
    return type(name, (_Proto2,), {"FIELDS": tuple(Field(n, f, kind) for n, f, kind in fields)})


MoveToLocation = _order("MoveToLocation", (1, "location", Vector))
MoveToTarget = _order("MoveToTarget", (1, "target", "int32"))
AttackMove = _order("AttackMove", (1, "location", Vector))
AttackTarget = _order("AttackTarget", (1, "target", "int32"), (2, "once", "bool"))
CastLocation = _order("CastLocation", (1, "abilitySlot", "int32"), (2, "location", Vector))
CastTarget = _order("CastTarget", (1, "abilitySlot", "int32"), (2, "target", "int32"))
CastTree = _order("CastTree", (1, "abilitySlot", "int32"), (2, "tree", "int32"))
Cast = _order("Cast", (1, "abilitySlot", "int32"))
TrainAbility = _order("TrainAbility", (1, "ability", "string"))
PurchaseItem = _order("PurchaseItem", (1, "item", "int32"), (2, "item_name", "string"))
SellItem = _order("SellItem", (1, "item", "int32"), (2, "slot", "int32"))
SwapItems = _order("SwapItems", (1, "slot_a", "int32"), (2, "slot_b", "int32"))
DropItem = _order("DropItem", (1, "slot", "int32"), (2, "location", Vector))
PickUpItem = _order("PickUpItem", (1, "itemId", "int32"))
Courier = _order("Courier", (1, "unit", "int32"), (2, "courier", "int32"), (3, "action", "int32"))
Chat = _order("Chat", (1, "message", "string"), (2, "to_allchat", "bool"))

# Action.actionData's members: (number, field name, payload class)
_ACTION_DATA = (
    (5, "moveToLocation", MoveToLocation), (6, "moveToTarget", MoveToTarget), (7, "attackMove", AttackMove),
    (8, "attackTarget", AttackTarget), (9, "castLocation", CastLocation), (10, "castTarget", CastTarget),
    (11, "castTree", CastTree), (12, "cast", Cast), (13, "trainAbility", TrainAbility),
    (14, "purchaseItem", PurchaseItem), (15, "sellItem", SellItem), (16, "swapItems", SwapItems),
    (17, "dropItem", DropItem), (18, "pickUpItem", PickUpItem), (19, "courier", Courier), (20, "chat", Chat),
    (21, "moveDirectly", MoveToLocation),
)


class Action(_Proto2):
    """A remote bot-control order: its type, the player, and one payload
    of the `actionData` oneof."""

    Type = ActionType
    FIELDS = (
        Field(1, "actionType", "enum", enum=ActionType, default=ActionType.DOTA_UNIT_ORDER_NONE),
        Field(2, "player", "int32"),
        Field(3, "actionID", "int32"),
        Field(4, "actionDelay", "float"),
    ) + tuple(Field(n, name, kind, oneof="actionData") for n, name, kind in _ACTION_DATA)


for _n, _name, _cls in _ACTION_DATA:
    setattr(Action, _cls.__name__, _cls)
_export(Action, ActionType)


class Actions(_Proto2):
    FIELDS = (
        Field(1, "dota_time", "float"),
        Field(2, "actions", Action, repeated=True),
        Field(3, "extraData", "int32"),
    )


class CMsgBotWorldState(_Proto2):
    UnitType = UnitType
    Vector, Player, Ability, Modifier = Vector, Player, Ability, Modifier
    TrackingProjectile, DroppedItem, RuneInfo, Unit = TrackingProjectile, DroppedItem, RuneInfo, Unit
    Action, Actions = Action, Actions
    FIELDS = (
        Field(1, "team_id", "uint32"),
        Field(2, "game_time", "float"),
        Field(3, "dota_time", "float"),
        Field(4, "game_state", "uint32"),
        Field(5, "hero_pick_state", "uint32"),
        Field(6, "time_of_day", "float"),
        Field(7, "glyph_cooldown", "float"),
        Field(8, "glyph_cooldown_enemy", "float"),
        Field(10, "players", Player, repeated=True),
        Field(11, "units", Unit, repeated=True),
        Field(12, "dropped_items", DroppedItem, repeated=True),
        Field(13, "rune_infos", RuneInfo, repeated=True),
    )


_export(CMsgBotWorldState, UnitType)
