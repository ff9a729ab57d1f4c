"""Inference-service wire protocol (own copy of
dotaclient_tpu/serve/wire.py; every message is byte for byte the
reference's, so the reference's clients step the port's server).

Framing is the tcp broker's (transport/tcp.py): every message is
`u32 payload_len | u8 type | payload`, little-endian throughout.

  0x01 S_STEP   one policy-step request            → 0x81 R_STEP
  0x02 S_STATS  no payload                         → 0x82 R_STATS (JSON)
  0x03 S_INFO   session establishment              → 0x83 R_INFO  (JSON)
  0x04 S_RESUME session-continuity handshake       → 0x84 R_RESUME

S_INFO payload: empty (model 0, the live hot-swapped tree) or u32
model_id (binds the connection's sessions to frozen serve slot
model_id; out of range is answered with a "model_error" key).

S_STEP payload:
  u64    client_key  — names the client's server-resident LSTM carry
                       (scoped per connection)
  u8     flags       — bit0 EPISODE_START (reset the carry to zeros
                       first), bit1 WANT_CARRY (return the post-step
                       (c, h)), bit2 REPLAY (a resumed client re-driving
                       a buffered obs; metered, stepped normally)
  u8     obs_code    — 0 = f32 obs, 3 = bf16 obs (the DTR3 codes)
  u8[8]  rng         — the client's jax PRNGKey (u32 x 2); the server
                       samples with it and returns it advanced
  bytes  obs         — transport/serialize.py single-observation frame

R_STEP payload:
  u64    client_key  — echo
  u8     status      — 0 OK; 1 UNKNOWN_CLIENT (no resident carry and no
                       EPISODE_START); 2 BAD_REQUEST. Non-OK ends here.
  u32    version     — param version of the tick that served the row
  u64    tick        — serving tick ordinal
  u8[8]  rng'        — the advanced PRNGKey
  i32[4] action      — (type, move_x, move_y, target)
  f32    logp, value
  u8     has_carry
  f32[H] c, f32[H] h — present iff has_carry (H = lstm_hidden)

S_RESUME payload: u64 client_key, u32 boundary_step, u64 carry_hash.
R_RESUME payload: u64 client_key, u8 status, u32 version, u32
episode_step. A server armed with a carry store
(`--serve.handoff_endpoint`, serve/handoff.py) restores the named
boundary's carry from it as the session's resident carry and answers OK;
a miss, a fingerprint mismatch or a server with no store answers
UNKNOWN_CLIENT, and the client abandons that episode.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.transport.serialize import (
    _WIRE_BF16,
    _WIRE_F32,
    deserialize_obs,
    obs_wire_nbytes,
    serialize_obs,
)

_LEN = struct.Struct("<I")
_TYPE = struct.Struct("<B")

S_STEP, S_STATS, S_INFO, S_RESUME = 0x01, 0x02, 0x03, 0x04
R_STEP, R_STATS, R_INFO, R_RESUME = 0x81, 0x82, 0x83, 0x84

FLAG_EPISODE_START = 1
FLAG_WANT_CARRY = 2
FLAG_REPLAY = 4

OK, UNKNOWN_CLIENT, BAD_REQUEST = 0, 1, 2

OBS_F32, OBS_BF16 = _WIRE_F32, _WIRE_BF16

MAX_FRAME = 16 * 1024 * 1024  # a step request/reply is a few KB

_REQ_HEAD = struct.Struct("<QBB8s")
_RESP_HEAD = struct.Struct("<QB")
_RESP_BODY = struct.Struct("<IQ8s4iffB")
_INFO_REQ = struct.Struct("<I")
_RESUME_REQ = struct.Struct("<QIQ")
_RESUME_RESP = struct.Struct("<QBII")

# (client_key, model_id) → the carry store's u64 key: client keys in the
# low 48 bits, the model id in the high 16 (model 0 is the bare key).
MODEL_KEY_SHIFT = 48
MAX_CLIENT_KEY = (1 << MODEL_KEY_SHIFT) - 1
MAX_MODEL_ID = (1 << (64 - MODEL_KEY_SHIFT)) - 1


class StepRequest(NamedTuple):
    client_key: int
    episode_start: bool
    want_carry: bool
    obs_bf16: bool
    rng: np.ndarray  # u32 [2]
    obs: F.Observation
    replay: bool = False


class ResumeRequest(NamedTuple):
    client_key: int
    boundary_step: int
    carry_hash: int = 0


class ResumeResponse(NamedTuple):
    client_key: int
    status: int
    version: int = 0
    episode_step: int = 0


class StepResponse(NamedTuple):
    client_key: int
    status: int
    version: int = 0
    tick: int = 0
    rng: Optional[np.ndarray] = None  # u32 [2]
    action: Optional[np.ndarray] = None  # i32 [4] (type, move_x, move_y, target)
    logp: float = 0.0
    value: float = 0.0
    carry: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (c, h) each f32 [H]


def frame(mtype: int, payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + _TYPE.pack(mtype) + payload


def encode_info_request(model_id: int = 0) -> bytes:
    """S_INFO payload: empty for model 0, else one u32."""
    if model_id == 0:
        return b""
    if not 0 <= model_id <= MAX_MODEL_ID:
        raise ValueError(f"model id {model_id} out of range [0, {MAX_MODEL_ID}]")
    return _INFO_REQ.pack(model_id)


def decode_info_request(payload: bytes) -> int:
    """Model id from an S_INFO payload (empty = 0)."""
    if not payload:
        return 0
    if len(payload) != _INFO_REQ.size:
        raise ValueError(f"info request size {len(payload)} != {_INFO_REQ.size}")
    return _INFO_REQ.unpack(payload)[0]


def compose_store_key(client_key: int, model_id: int) -> int:
    """(client_key, model_id) → the carry store's u64 key."""
    if not 0 <= client_key <= MAX_CLIENT_KEY:
        raise ValueError(
            f"client_key {client_key} exceeds {MODEL_KEY_SHIFT} bits — cannot compose a per-model store key"
        )
    if not 0 <= model_id <= MAX_MODEL_ID:
        raise ValueError(f"model id {model_id} out of range [0, {MAX_MODEL_ID}]")
    return (model_id << MODEL_KEY_SHIFT) | client_key


def encode_step_request(client_key: int, obs: F.Observation, rng, episode_start: bool = False,
                        want_carry: bool = False, obs_bf16: bool = False, replay: bool = False) -> bytes:
    flags = (
        (FLAG_EPISODE_START if episode_start else 0)
        | (FLAG_WANT_CARRY if want_carry else 0)
        | (FLAG_REPLAY if replay else 0)
    )
    code = OBS_BF16 if obs_bf16 else OBS_F32
    rng_b = np.ascontiguousarray(np.asarray(rng), np.uint32).tobytes()
    return _REQ_HEAD.pack(client_key, flags, code, rng_b) + serialize_obs(obs, obs_bf16)


def decode_step_request(payload: bytes) -> StepRequest:
    if len(payload) < _REQ_HEAD.size:
        raise ValueError("truncated step request")
    client_key, flags, code, rng_b = _REQ_HEAD.unpack_from(payload)
    if code not in (OBS_F32, OBS_BF16):
        raise ValueError(f"unknown obs wire dtype code {code}")
    obs_bf16 = code == OBS_BF16
    expect = _REQ_HEAD.size + obs_wire_nbytes(obs_bf16)
    if len(payload) != expect:
        raise ValueError(f"step request size {len(payload)} != {expect}")
    obs, _ = deserialize_obs(payload, _REQ_HEAD.size, obs_bf16)
    return StepRequest(
        client_key=client_key,
        episode_start=bool(flags & FLAG_EPISODE_START),
        want_carry=bool(flags & FLAG_WANT_CARRY),
        obs_bf16=obs_bf16,
        rng=np.frombuffer(rng_b, np.uint32),
        obs=obs,
        replay=bool(flags & FLAG_REPLAY),
    )


def encode_resume_request(client_key: int, boundary_step: int, carry_hash: int = 0) -> bytes:
    return _RESUME_REQ.pack(client_key, boundary_step, carry_hash)


def decode_resume_request(payload: bytes) -> ResumeRequest:
    if len(payload) != _RESUME_REQ.size:
        raise ValueError(f"resume request size {len(payload)} != {_RESUME_REQ.size}")
    key, boundary, carry_hash = _RESUME_REQ.unpack(payload)
    return ResumeRequest(client_key=key, boundary_step=boundary, carry_hash=carry_hash)


def encode_resume_response(r: ResumeResponse) -> bytes:
    return _RESUME_RESP.pack(r.client_key, r.status, r.version, r.episode_step)


def decode_resume_response(payload: bytes) -> ResumeResponse:
    if len(payload) != _RESUME_RESP.size:
        raise ValueError(f"resume response size {len(payload)} != {_RESUME_RESP.size}")
    key, status, version, episode_step = _RESUME_RESP.unpack(payload)
    return ResumeResponse(client_key=key, status=status, version=version, episode_step=episode_step)


def encode_step_response(r: StepResponse) -> bytes:
    head = _RESP_HEAD.pack(r.client_key, r.status)
    if r.status != OK:
        return head
    rng_b = np.ascontiguousarray(r.rng, np.uint32).tobytes()
    a = [int(x) for x in r.action]
    body = _RESP_BODY.pack(r.version, r.tick, rng_b, a[0], a[1], a[2], a[3], float(r.logp), float(r.value),
                           1 if r.carry is not None else 0)
    if r.carry is not None:
        c, h = r.carry
        body += np.ascontiguousarray(c, np.float32).tobytes()
        body += np.ascontiguousarray(h, np.float32).tobytes()
    return head + body


def decode_step_response(payload: bytes, lstm_hidden: int) -> StepResponse:
    if len(payload) < _RESP_HEAD.size:
        raise ValueError("truncated step response")
    client_key, status = _RESP_HEAD.unpack_from(payload)
    if status != OK:
        return StepResponse(client_key=client_key, status=status)
    off = _RESP_HEAD.size
    version, tick, rng_b, a0, a1, a2, a3, logp, value, has_carry = _RESP_BODY.unpack_from(payload, off)
    off += _RESP_BODY.size
    carry = None
    if has_carry:
        n = lstm_hidden * 4
        if len(payload) < off + 2 * n:
            raise ValueError("truncated carry in step response")
        c = np.frombuffer(payload, np.float32, count=lstm_hidden, offset=off)
        h = np.frombuffer(payload, np.float32, count=lstm_hidden, offset=off + n)
        carry = (c, h)
    return StepResponse(
        client_key=client_key,
        status=status,
        version=version,
        tick=tick,
        rng=np.frombuffer(rng_b, np.uint32),
        action=np.asarray([a0, a1, a2, a3], np.int32),
        logp=logp,
        value=value,
        carry=carry,
    )


async def read_frame(reader) -> Tuple[int, bytes]:
    """(type, payload) from an asyncio StreamReader; raises
    IncompleteReadError on EOF."""
    hdr = await reader.readexactly(_LEN.size + _TYPE.size)
    (n,) = _LEN.unpack_from(hdr)
    (mtype,) = _TYPE.unpack_from(hdr, _LEN.size)
    if n > MAX_FRAME:
        raise ValueError("frame too large")
    payload = await reader.readexactly(n) if n else b""
    return mtype, payload
