"""Mini wire module for the WIRE001 fixture: the exact extraction
surface of the real transport/serialize.py (struct formats, wire-code
constants, the _canonical_codes list algebra). Never imported."""

import struct

_HDR = struct.Struct("<4sIHHBIf")
_HDR2 = struct.Struct("<4sIHHBIfQd")

_FLAG_AUX = 1

_WIRE_F32, _WIRE_I32, _WIRE_U8, _WIRE_BF16 = 0, 1, 2, 3


def _canonical_codes(flags, obs_code):
    codes = [obs_code] * 3 + [_WIRE_U8] * 3 + [_WIRE_I32] * 4 + [_WIRE_F32] * 6
    if flags & _FLAG_AUX:
        codes += [_WIRE_F32] * 3
    return bytes(codes)
