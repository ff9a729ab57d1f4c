"""A proto2 / proto3 message base and codec in pure Python: the subset of
`google.protobuf`'s message surface and wire format that the env messages
(protos/worldstate.py, protos/dotaservice.py), the valve dialect's
(protos/valve_worldstate.py, proto2, and protos/valve_dotaservice.py) and
the TensorBoard event records (protos/event.py) use, with its value
semantics, so the port needs neither `protobuf` nor `grpc`.

Semantics kept from the upb runtime:
- a float field stores its value rounded to f32 on assignment (an
  overflow becomes ±inf), so a value read back is the value the wire
  carries;
- int32 / int64 / uint32 / uint64 fields take integers only (TypeError
  for a float), in range (ValueError otherwise); a negative int32 is
  written as the 10-byte varint of its 64-bit two's complement;
- proto3 (`SYNTAX = "proto3"`, the default): implicit presence, a scalar
  is written when it differs from its default (a float when its bits do,
  so -0.0 is written); repeated scalars are written packed;
- proto2 (`SYNTAX = "proto2"`): every singular field has presence, so a
  scalar set to its default is written and `HasField` tells set from
  unset; a field reads its declared default (`Field(..., default=)`)
  until set; repeated scalars are written unpacked unless the field says
  `packed=True`; an enum field with its `EnumType` is closed (ValueError
  on assigning a value it lacks; a parse drops such a value);
- a repeated field is written when it is not empty; a singular message
  field when it was set or any change was made through it;
- oneof members (`Field(..., oneof="group")`) have presence in either
  syntax; setting one clears the others of its group, a parse keeps the
  last one on the wire, `WhichOneof(group)` names the one set;
- repeated scalars are read packed or not;
- fields are written in field-number order; a parse skips unknown fields
  and merges a singular message field that occurs twice.
"""

from __future__ import annotations

import math
import operator
import struct
from typing import Dict, Optional, Tuple

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")
_U64 = (1 << 64) - 1

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5

# scalar kinds → (wire type, default)
_KINDS = {
    "int32": (VARINT, 0),
    "int64": (VARINT, 0),
    "uint32": (VARINT, 0),
    "uint64": (VARINT, 0),
    "bool": (VARINT, False),
    "enum": (VARINT, 0),
    "float": (I32, 0.0),
    "double": (I64, 0.0),
    "string": (LEN, ""),
}
_RANGES = {"int32": (-(1 << 31), 1 << 31), "enum": (-(1 << 31), 1 << 31), "uint32": (0, 1 << 32),
           "uint64": (0, 1 << 64), "int64": (-(1 << 63), 1 << 63)}


class DecodeError(ValueError):
    """Bytes that are not a well-formed encoding of the message."""


class EnumType:
    """A proto enum's names and values: `Name(value)`, `Value(name)`,
    and each constant as an attribute."""

    def __init__(self, name: str, values: Dict[str, int]):
        self._name = name
        self._values = dict(values)
        self._names = {v: k for k, v in values.items()}
        for k, v in values.items():
            setattr(self, k, v)

    def Name(self, value: int) -> str:
        try:
            return self._names[value]
        except KeyError:
            raise ValueError(f"enum {self._name} has no name for value {value}") from None

    def Value(self, name: str) -> int:
        try:
            return self._values[name]
        except KeyError:
            raise ValueError(f"enum {self._name} has no value named {name!r}") from None


def _f32(x) -> float:
    if isinstance(x, (str, bytes)):
        raise TypeError(f"must be real number, not {type(x).__name__}")
    x = float(x)
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:  # the C cast upb does gives ±inf
        return math.copysign(math.inf, x)


def _f64(x) -> float:
    if isinstance(x, (str, bytes)):
        raise TypeError(f"must be real number, not {type(x).__name__}")
    return float(x)


def _coercer(kind: str):
    if kind == "float":
        return _f32
    if kind == "double":
        return _f64
    if kind == "bool":
        return bool
    if kind == "string":
        def to_str(x):
            if not isinstance(x, str):
                raise TypeError(f"expected str, got {type(x).__name__}")
            return x
        return to_str
    lo, hi = _RANGES[kind]

    def to_int(x):
        v = operator.index(x)
        if not lo <= v < hi:
            raise ValueError(f"Value out of range: {v}")
        return v
    return to_int


class Field:
    """One field of a message: number, name, kind (a scalar kind or a
    message class), whether it is repeated, its oneof group, its declared
    default, whether a repeated scalar is packed (None: the syntax's rule)
    and, for a closed (proto2) enum, its EnumType. The message class
    settles presence, packing and the tag (`_settle`)."""

    __slots__ = ("number", "name", "kind", "repeated", "oneof", "default", "packed", "enum", "explicit", "message",
                 "coerce", "key")

    def __init__(self, number: int, name: str, kind, repeated: bool = False, oneof: Optional[str] = None,
                 default=None, packed: Optional[bool] = None, enum: Optional["EnumType"] = None):
        self.number = number
        self.name = name
        self.kind = kind
        self.repeated = repeated
        self.oneof = oneof
        self.message = not isinstance(kind, str)
        self.default = _KINDS[kind][1] if default is None and not self.message else default
        self.packed = packed
        self.enum = enum
        self.explicit = False
        self.coerce = None
        self.key = b""

    def _settle(self, syntax: str) -> None:
        """Presence, packing, coercion and tag under the message's syntax."""
        proto2 = syntax == "proto2"
        scalar = not self.message
        # explicit presence: written whenever set, even to its default
        self.explicit = scalar and not self.repeated and (proto2 or self.oneof is not None)
        if self.repeated and scalar and self.kind != "string" and self.packed is None:
            self.packed = not proto2
        if not (proto2 and scalar):
            self.enum = None  # proto3 enums are open
        if scalar:
            self.coerce = _coercer(self.kind)
            if self.enum is not None:
                self.coerce = _closed(self.coerce, self.enum)
        wire = LEN if (self.message or self.packed) else _KINDS[self.kind][0]
        self.key = _varint_bytes((self.number << 3) | wire)


def _closed(coerce, enum: "EnumType"):
    def to_member(x):
        v = coerce(x)
        if v not in enum._names:
            raise ValueError(f"Unknown enum value: {v}")
        return v
    return to_member


class _Lazy:
    """Class attribute of a repeated or singular message field: the
    container is made on first read and kept in the instance's __dict__
    (which then shadows this non-data descriptor)."""

    def __init__(self, field: Field):
        self.field = field

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        f = self.field
        if f.repeated:
            value = Repeated(obj, f)
        else:
            value = f.kind()
            value._hook = (obj, f.name)
        obj.__dict__[f.name] = value
        return value


class Repeated:
    """A repeated field: a list that coerces what goes in (scalars) or
    copies it (messages), and marks its owner changed."""

    __slots__ = ("_owner", "_field", "_items")

    def __init__(self, owner, field: Field):
        self._owner = owner
        self._field = field
        self._items = []

    def _in(self, value):
        f = self._field
        if f.message:
            if not isinstance(value, f.kind):
                raise TypeError(f"expected {f.kind.__name__}, got {type(value).__name__}")
            copy = f.kind()
            copy.CopyFrom(value)
            return copy
        return f.coerce(value)

    def add(self, **kw):
        msg = self._field.kind(**kw)
        self._items.append(msg)
        self._owner._touch()
        return msg

    def append(self, value) -> None:
        self._items.append(self._in(value))
        self._owner._touch()

    def extend(self, values) -> None:
        self._items.extend([self._in(v) for v in values])
        self._owner._touch()

    def __getitem__(self, i):
        return self._items[i]

    def __delitem__(self, i) -> None:
        del self._items[i]
        self._owner._touch()

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other) -> bool:
        if isinstance(other, Repeated):
            other = other._items
        return self._items == list(other)

    def __repr__(self) -> str:
        return repr(self._items)


def _varint_bytes(n: int) -> bytes:
    out = bytearray()
    _put_varint(out, n)
    return bytes(out)


def _put_varint(out: bytearray, n: int) -> None:
    n &= _U64
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _put_scalar(out: bytearray, kind: str, v) -> None:
    """One scalar's value bytes (its tag written by the caller)."""
    if kind == "float":
        out += _F32.pack(v)
    elif kind == "double":
        out += _F64.pack(v)
    elif kind == "string":
        raw = v.encode("utf-8")
        _put_varint(out, len(raw))
        out += raw
    else:
        _put_varint(out, int(v))


def _get_varint(data, pos: int, end: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= end or shift > 63:
            raise DecodeError("truncated or overlong varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n & _U64, pos
        shift += 7


def _signed32(n: int) -> int:
    n &= 0xFFFFFFFF
    return n - (1 << 32) if n & 0x80000000 else n


def _from_varint(kind: str, n: int):
    if kind in ("int32", "enum"):
        return _signed32(n)
    if kind == "int64":
        return n - (1 << 64) if n >> 63 else n
    if kind == "uint32":
        return n & 0xFFFFFFFF
    if kind == "bool":
        return n != 0
    return n  # uint64


def _skip(data, pos: int, end: int, wire: int) -> int:
    if wire == VARINT:
        return _get_varint(data, pos, end)[1]
    if wire == I64:
        pos += 8
    elif wire == I32:
        pos += 4
    elif wire == LEN:
        n, pos = _get_varint(data, pos, end)
        pos += n
    else:
        raise DecodeError(f"unsupported wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


class Message:
    """Base of the port's messages. A subclass lists `FIELDS` (Field
    objects) and its `SYNTAX`; `__init_subclass__` installs each scalar's
    default as a class attribute and a lazy container for each repeated or
    message field, so an instance's __dict__ holds only what was set."""

    SYNTAX = "proto3"
    FIELDS: Tuple[Field, ...] = ()
    _hook = None  # (parent, field name) while a lazily made child is unchanged

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.FIELDS = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        cls._ONEOFS = {}
        for f in cls.FIELDS:
            f._settle(cls.SYNTAX)
            setattr(cls, f.name, _Lazy(f) if (f.repeated or f.message) else f.default)
            if f.oneof is not None:
                cls._ONEOFS.setdefault(f.oneof, []).append(f.name)

    def __init__(self, **kw):
        for name, value in kw.items():
            f = self._BY_NAME.get(name)
            if f is None:
                raise ValueError(f"Protocol message {type(self).__name__} has no {name!r} field.")
            if f.repeated:
                getattr(self, name).extend(value)
            elif f.message:
                if value is not None:
                    self._child(f).CopyFrom(value)
                    self._present(f)
            else:
                self.__dict__[name] = f.coerce(value)
                self._present(f)

    def __setattr__(self, name, value) -> None:
        f = self._BY_NAME.get(name)
        if f is None:
            if name == "_hook":
                object.__setattr__(self, name, value)
                return
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.repeated or f.message:
            raise AttributeError(f"Assignment not allowed to field {name!r} in protocol message object.")
        self.__dict__[name] = f.coerce(value)
        self._present(f)
        self._touch()

    # --------------------------------------------------------------- state

    def _present(self, f: Field) -> None:
        """Field f was set: a message field becomes present, and the other
        members of its oneof are cleared."""
        d = self.__dict__
        if f.message:
            d.setdefault("_has", set()).add(f.name)
        if f.oneof is not None:
            for other in self._ONEOFS[f.oneof]:
                if other != f.name:
                    d.pop(other, None)
                    d.get("_has", set()).discard(other)

    def _touch(self) -> None:
        """A change was made: a lazily made child becomes present in its
        parent (and so on up)."""
        hook = self.__dict__.pop("_hook", None)
        if hook is not None:
            parent, name = hook
            parent._present(parent._BY_NAME[name])
            parent._touch()

    def _child(self, f: Field) -> "Message":
        child = self.__dict__.get(f.name)
        if child is None:
            child = f.kind()
            self.__dict__[f.name] = child
        return child

    def _is_set(self, f: Field) -> bool:
        if f.message:
            return f.name in self.__dict__.get("_has", ())
        if f.explicit:
            return f.name in self.__dict__
        return self._wants(f, self.__dict__.get(f.name, f.default))

    def HasField(self, name: str) -> bool:
        """A singular field's presence (a proto3 scalar outside a oneof:
        whether it differs from its default), or whether a oneof group
        has a member set."""
        if name in self._ONEOFS:
            return self.WhichOneof(name) is not None
        f = self._BY_NAME.get(name)
        if f is None or f.repeated:
            raise ValueError(f"Protocol message {type(self).__name__} has no singular {name!r} field.")
        return self._is_set(f)

    def WhichOneof(self, group: str) -> Optional[str]:
        """The name of the member of oneof `group` that is set, or None."""
        try:
            names = self._ONEOFS[group]
        except KeyError:
            raise ValueError(f"Protocol message {type(self).__name__} has no oneof {group!r}.") from None
        for name in names:
            if self._is_set(self._BY_NAME[name]):
                return name
        return None

    def ClearField(self, name: str) -> None:
        """Unset a field (or a oneof group's member): it reads its default
        and is not written."""
        if name in self._ONEOFS:
            name = self.WhichOneof(name)
            if name is None:
                return
        if name not in self._BY_NAME:
            raise ValueError(f"Protocol message {type(self).__name__} has no {name!r} field.")
        self.__dict__.pop(name, None)
        self.__dict__.get("_has", set()).discard(name)

    def Clear(self) -> None:
        hook = self.__dict__.get("_hook")
        self.__dict__.clear()
        if hook is not None:
            self.__dict__["_hook"] = hook
        self._touch()

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"Parameter to CopyFrom() must be instance of same class: expected "
                            f"{type(self).__name__} got {type(other).__name__}.")
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    def MergeFrom(self, other: "Message") -> None:
        """Set scalars overwrite, repeated fields append, message fields
        merge; a oneof member set in `other` replaces this one's."""
        d, od = self.__dict__, other.__dict__
        for f in self.FIELDS:
            if f.name not in od:
                continue
            if f.repeated:
                items = getattr(self, f.name)
                items.extend(od[f.name])
            elif f.message:
                if f.name in od.get("_has", ()):
                    self._child(f).MergeFrom(od[f.name])
                    self._present(f)
            elif f.explicit or self._wants(f, od[f.name]):
                d[f.name] = od[f.name]
                self._present(f)
        self._touch()

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = self.__dict__.get(f.name)
            if v is None:
                continue
            if f.repeated and not len(v):
                continue
            if f.message and not f.repeated and f.name not in self.__dict__.get("_has", ()):
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -------------------------------------------------------------- encode

    @staticmethod
    def _wants(f: Field, v) -> bool:
        """Implicit presence: a scalar is written when it is not its
        default; a float when its bits are not zero."""
        if f.kind in ("float", "double"):
            return v != 0.0 or math.copysign(1.0, v) < 0
        return bool(v)

    def _encode(self, out: bytearray) -> None:
        d = self.__dict__
        for f in self.FIELDS:
            v = d.get(f.name)
            if v is None:
                continue
            if f.repeated:
                if not len(v):
                    continue
                if f.message:
                    for m in v:
                        body = bytearray()
                        m._encode(body)
                        out += f.key
                        _put_varint(out, len(body))
                        out += body
                elif not f.packed:  # strings, and proto2's unpacked scalars
                    for x in v:
                        out += f.key
                        _put_scalar(out, f.kind, x)
                elif f.kind in ("float", "double"):
                    fmt = _F32 if f.kind == "float" else _F64
                    out += f.key
                    _put_varint(out, fmt.size * len(v))
                    for x in v:
                        out += fmt.pack(x)
                else:  # packed varints
                    body = bytearray()
                    for x in v:
                        _put_varint(body, int(x))
                    out += f.key
                    _put_varint(out, len(body))
                    out += body
            elif f.message:
                if f.name not in d.get("_has", ()):
                    continue
                body = bytearray()
                v._encode(body)
                out += f.key
                _put_varint(out, len(body))
                out += body
            elif f.explicit or self._wants(f, v):
                out += f.key
                _put_scalar(out, f.kind, v)

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    # -------------------------------------------------------------- decode

    def _decode(self, data, pos: int, end: int) -> None:
        d = self.__dict__
        by_number = self._BY_NUMBER
        while pos < end:
            tag, pos = _get_varint(data, pos, end)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if f is None:
                pos = _skip(data, pos, end, wire)
                continue
            if f.message:
                if wire != LEN:
                    pos = _skip(data, pos, end, wire)
                    continue
                n, pos = _get_varint(data, pos, end)
                if pos + n > end:
                    raise DecodeError("truncated message field")
                if f.repeated:
                    child = f.kind()
                    child._decode(data, pos, pos + n)
                    getattr(self, f.name)._items.append(child)
                else:
                    if f.oneof is not None and f.name not in d.get("_has", ()):
                        d.pop(f.name, None)  # a member not set: the parse starts it afresh
                    self._child(f)._decode(data, pos, pos + n)
                    self._present(f)
                pos += n
                continue
            kind = f.kind
            want = _KINDS[kind][0]
            if f.repeated and wire == LEN and want != LEN:  # packed
                n, pos = _get_varint(data, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated packed field")
                items = getattr(self, f.name)._items
                while pos < stop:
                    if want in (I32, I64):
                        fmt = _F32 if want == I32 else _F64
                        items.append(fmt.unpack_from(data, pos)[0])
                        pos += fmt.size
                    else:
                        x, pos = _get_varint(data, pos, stop)
                        items.append(_from_varint(kind, x))
                if pos != stop:
                    raise DecodeError("packed field overruns its length")
                continue
            if wire != want:
                pos = _skip(data, pos, end, wire)
                continue
            if want == VARINT:
                x, pos = _get_varint(data, pos, end)
                value = _from_varint(kind, x)
            elif want in (I32, I64):
                fmt = _F32 if want == I32 else _F64
                if pos + fmt.size > end:
                    raise DecodeError("truncated fixed-width field")
                value = fmt.unpack_from(data, pos)[0]
                pos += fmt.size
            else:
                n, pos = _get_varint(data, pos, end)
                if pos + n > end:
                    raise DecodeError("truncated string")
                try:
                    value = bytes(data[pos:pos + n]).decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"field {f.name}: invalid UTF-8") from e
                pos += n
            if f.enum is not None and value not in f.enum._names:
                continue  # a closed enum drops a value it lacks
            if f.repeated:
                getattr(self, f.name)._items.append(value)
            else:
                d[f.name] = value
                if f.oneof is not None:
                    self._present(f)
        if pos != end:
            raise DecodeError("field overruns the message")

    @classmethod
    def FromString(cls, data: bytes):
        msg = cls()
        msg._decode(memoryview(data), 0, len(data))
        return msg
