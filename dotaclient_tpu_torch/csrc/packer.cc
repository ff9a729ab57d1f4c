// Native host packer: rollout wire frames -> padded [B, T] batch rows.
//
// The port's own copy of the reference learner's C++ packer (the JAX
// package's native/packer.cc): host code, not a device kernel. The staging
// buffer (runtime/staging.py) parses every frame of an ingest drain with
// one dt_frame_headers call and packs a whole batch with one dt_pack_batch
// call, each field a bounds-checked memcpy from the frame into its [b, :L]
// slice of the single [B, row_bytes] transfer buffer (parallel/fused_io.py
// RowLayout views, passed as per-output row strides). ctypes releases the
// GIL around each call, so packing overlaps the learner's device step.
//
// C ABI only; built with g++ at first use and loaded with ctypes
// (dotaclient_tpu_torch/native/__init__.py). The caller owns every buffer;
// padding rows stay as Python initialized them (NOOP-legal action masks).
//
// Frame layouts (transport/serialize.py, little-endian):
//   DTR1: magic 'DTR1' | u32 version | u16 L | u16 H | u8 flags
//         | u32 actor_id | f32 episode_return | arrays in fixed order
//         (shapes derive from L/H and the schema dims passed in by the
//         caller).
//   DTR3 (quantized wire): magic 'DTR3' | the same fixed fields | u64
//         trace_id | f64 birth_time | u8 n_dtypes | u8[n] dtype-map |
//         arrays in their WIRE dtypes. This build accepts exactly the
//         canonical map with the three float obs leaves uniformly f32
//         or uniformly bf16 (codes 0/3), the same accept set as the
//         python parser. bf16 wire -> bf16 batch is a strided memcpy.
//   (DTR2 never reaches this code: the staging intake normalizes traced
//   frames to byte-identical DTR1 first.)

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kHeaderBytes = 21;
constexpr int64_t kTraceExtBytes = 16;  // u64 trace_id + f64 birth_time
constexpr uint8_t kFlagAux = 1;
// DTR3 dtype-map codes (transport/serialize.py _WIRE_*).
constexpr uint8_t kWireF32 = 0, kWireI32 = 1, kWireU8 = 2, kWireBf16 = 3;

// f32 -> bf16 with round-to-nearest-even, the exact semantics of
// numpy.astype(ml_dtypes.bfloat16) and of transport/serialize.py
// f32_to_bf16_bits, so converting during the pack copy is bitwise the
// python path's cast.
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u) {
    // NaN: canonicalize to sign | 0x7fc0, exactly what ml_dtypes (Eigen)
    // does: payload bits are dropped (0x7fa00000 -> 0x7fc0,
    // 0xffa00000 -> 0xffc0).
    return static_cast<uint16_t>(((x >> 16) & 0x8000u) | 0x7fc0u);
  }
  const uint32_t rounding_bias = 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>((x + rounding_bias) >> 16);
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok;

  void copy(void* dst, int64_t n) {
    if (!ok || p + n > end) {
      ok = false;
      return;
    }
    std::memcpy(dst, p, n);
    p += n;
  }
  // Read n_floats f32 from the frame, write bf16 (obs compute-dtype
  // staging fused into the pack copy).
  void copy_f32_to_bf16(uint16_t* dst, int64_t n_floats) {
    if (!ok || p + n_floats * 4 > end) {
      ok = false;
      return;
    }
    for (int64_t i = 0; i < n_floats; ++i) {
      float f;
      std::memcpy(&f, p + i * 4, 4);
      dst[i] = f32_to_bf16(f);
    }
    p += n_floats * 4;
  }
  // Read n bf16 from the frame, write f32. The widening is exact (pad
  // 16 zero mantissa bits) — a bf16-wire frame consumed by an f32-batch
  // config (compute dtype f32, or staging cast off) loses nothing
  // beyond what the producer's cast already rounded away.
  void copy_bf16_to_f32(float* dst, int64_t n) {
    if (!ok || p + n * 2 > end) {
      ok = false;
      return;
    }
    for (int64_t i = 0; i < n; ++i) {
      uint16_t b;
      std::memcpy(&b, p + i * 2, 2);
      const uint32_t x = static_cast<uint32_t>(b) << 16;
      std::memcpy(dst + i, &x, 4);
    }
    p += n * 2;
  }
  // Dispatch for float OBS fields: dst_f32 points at f32 storage when
  // obs_bf16 == 0, at bf16 (u16) storage when 1; `off` is in ELEMENTS;
  // wire_bf16 is the FRAME's obs dtype (DTR3 dtype-map). The matched
  // cases are memcpys; the mixed cases convert one direction each.
  void copy_obs(float* dst_f32, int64_t off, int64_t n_floats, int64_t obs_bf16,
                int64_t wire_bf16) {
    if (wire_bf16) {
      if (obs_bf16) {
        copy(reinterpret_cast<uint16_t*>(dst_f32) + off, n_floats * 2);
      } else {
        copy_bf16_to_f32(dst_f32 + off, n_floats);
      }
    } else if (obs_bf16) {
      copy_f32_to_bf16(reinterpret_cast<uint16_t*>(dst_f32) + off, n_floats);
    } else {
      copy(dst_f32 + off, n_floats * 4);
    }
  }
  // Masks land in numpy bool arrays: normalize every byte to 0/1 (the
  // python path's astype(bool) does the same; raw !=1 bytes from an
  // untrusted peer must not create invalid bool storage).
  void copy_bool(uint8_t* dst, int64_t n) {
    if (!ok || p + n > end) {
      ok = false;
      return;
    }
    for (int64_t i = 0; i < n; ++i) dst[i] = p[i] ? 1 : 0;
    p += n;
  }
  void skip(int64_t n) {
    if (!ok || p + n > end) {
      ok = false;
      return;
    }
    p += n;
  }
};

// Parsed frame header + derived fields. ONE implementation of the
// header layout and total-size formula, shared by all three entry
// points (a format change missed in one of three copies would silently
// drop every frame).
struct Header {
  uint32_t version;
  uint32_t actor_id;
  int64_t L;
  int64_t H;
  int64_t flags;
  float ep_ret;
  float last_done;
  int64_t wire_obs_bf16;  // DTR3 map says the float obs travel as bf16
  int64_t body_off;       // where the arrays start (header + extensions)
};

bool parse_header(const uint8_t* p, int64_t len,
                  int64_t G, int64_t HF, int64_t U, int64_t UF, int64_t A,
                  Header* h) {
  if (len < kHeaderBytes) return false;
  const bool dtr3 = std::memcmp(p, "DTR3", 4) == 0;
  if (!dtr3 && std::memcmp(p, "DTR1", 4) != 0) return false;
  uint16_t L16, H16;
  std::memcpy(&h->version, p + 4, 4);
  std::memcpy(&L16, p + 8, 2);
  std::memcpy(&H16, p + 10, 2);
  h->flags = p[12];
  std::memcpy(&h->actor_id, p + 13, 4);
  std::memcpy(&h->ep_ret, p + 17, 4);
  h->L = L16;
  h->H = H16;
  const int64_t T1 = h->L + 1;
  const bool aux = (h->flags & kFlagAux) != 0;
  h->wire_obs_bf16 = 0;
  int64_t body = kHeaderBytes;
  if (dtr3) {
    // Trace extension (values irrelevant to packing) + dtype-map. The
    // map must be EXACTLY the canonical layout, obs leaves uniformly
    // f32 or bf16 — same accept set as transport/serialize.py
    // check_dtr3_dtype_map, so python and native quarantine identically.
    body += kTraceExtBytes;
    if (len < body + 1) return false;
    const int64_t n_map = aux ? 19 : 16;
    if (p[body] != n_map) return false;
    body += 1;
    if (len < body + n_map) return false;
    const uint8_t* m = p + body;
    const uint8_t oc = m[0];
    if (oc != kWireF32 && oc != kWireBf16) return false;
    for (int64_t i = 1; i < 3; ++i)
      if (m[i] != oc) return false;
    for (int64_t i = 3; i < 6; ++i)
      if (m[i] != kWireU8) return false;
    for (int64_t i = 6; i < 10; ++i)
      if (m[i] != kWireI32) return false;
    for (int64_t i = 10; i < n_map; ++i)
      if (m[i] != kWireF32) return false;
    h->wire_obs_bf16 = (oc == kWireBf16) ? 1 : 0;
    body += n_map;
  }
  h->body_off = body;
  const int64_t obs_sz = h->wire_obs_bf16 ? 2 : 4;
  const int64_t expect = body + T1 * (G + HF + U * UF) * obs_sz +
                         T1 * (2 * U + A) + h->L * 8 * 4 + h->H * 2 * 4 +
                         (aux ? h->L * 3 * 4 : 0);
  if (len != expect) return false;
  // last element of the dones array (episode-end marker for stats)
  h->last_done = 0.0f;
  if (h->L > 0) {
    const int64_t dones_off = body + T1 * (G + HF + U * UF) * obs_sz +
                              T1 * (2 * U + A) + h->L * 7 * 4;
    std::memcpy(&h->last_done, p + dones_off + (h->L - 1) * 4, 4);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success, -(b+1) if frame b is malformed or inconsistent
// with (T, H, schema dims). On error the outputs may be partially
// written; the caller discards the batch.
//
// `row_strides` (nullable): per-output distance IN ELEMENTS between
// consecutive batch rows, in the exact order of the 20 array outputs
// below (global_f..aux_nw). NULL means every output is a dense
// C-contiguous [n, ...] array (stride = the row's own element count).
// Non-NULL is the fused-H2D path: each output is a column block of the
// [n, row_bytes] transfer buffer (parallel/fused_io.py), so the pack
// writes the device-transfer layout directly. Within a row a block is
// contiguous either way; only the row-to-row stride differs.
//
// `row_offset`: first batch row this call writes; frame b lands at
// output row (row_offset + b). Each row's bytes depend only on its own
// frame, so disjoint row ranges may be packed by concurrent calls (the
// sharded pack of staging.pack_workers > 1: one call per row shard of a
// ring slot, any split bitwise one row_offset 0 call). The per-frame
// metadata outputs (versions/actor_ids/ep_returns) are indexed by b.
int64_t dt_pack_batch(
    const uint8_t** frames, const int64_t* frame_lens, int64_t n,
    int64_t row_offset,
    int64_t T, int64_t H, int64_t want_aux,
    // When 1, the three float obs outputs are bf16 (uint16) storage;
    // f32-wire frames convert f32->bf16 in the copy loop (RNE, bitwise
    // equal to the python cast pass) and bf16-wire (DTR3) frames copy
    // straight through — the cast-free fast path. Non-obs floats are
    // always f32 on every wire.
    int64_t obs_bf16,
    // schema dims: global, hero, units, unit-features, action-types
    int64_t G, int64_t HF, int64_t U, int64_t UF, int64_t A,
    const int64_t* row_strides,
    // batch outputs (leading dim n; see row_strides):
    float* global_f,   // [n, T+1, G] (f32 or bf16, see obs_bf16)
    float* hero_f,     // [n, T+1, HF] (f32 or bf16)
    float* unit_f,     // [n, T+1, U, UF] (f32 or bf16)
    uint8_t* unit_m,   // [n, T+1, U]
    uint8_t* target_m, // [n, T+1, U]
    uint8_t* action_m, // [n, T+1, A]
    int32_t* act_type, int32_t* act_mx, int32_t* act_my, int32_t* act_tg,  // [n, T]
    float* logp, float* value, float* rewards, float* dones, float* mask,  // [n, T]
    float* init_c, float* init_h,  // [n, H]
    float* aux_win, float* aux_lh, float* aux_nw,  // [n, T] or nullptr
    // per-frame metadata:
    uint32_t* versions, uint32_t* actor_ids, float* ep_returns) {
  const int64_t T1o = T + 1;  // output time rows per sequence
  const int64_t dense[20] = {
      T1o * G, T1o * HF, T1o * U * UF,       // global_f, hero_f, unit_f
      T1o * U, T1o * U, T1o * A,             // unit_m, target_m, action_m
      T, T, T, T,                            // act_type, act_mx, act_my, act_tg
      T, T, T, T, T,                         // logp, value, rewards, dones, mask
      H, H,                                  // init_c, init_h
      T, T, T};                              // aux_win, aux_lh, aux_nw
  const int64_t* st = row_strides != nullptr ? row_strides : dense;
  for (int64_t b = 0; b < n; ++b) {
    const uint8_t* p = frames[b];
    const int64_t len = frame_lens[b];
    Header hdr;
    if (!parse_header(p, len, G, HF, U, UF, A, &hdr)) return -(b + 1);
    const int64_t L = hdr.L;
    if (L > T || hdr.H != H) return -(b + 1);
    const bool frame_aux = (hdr.flags & kFlagAux) != 0;
    const int64_t T1 = L + 1;
    const int64_t row = row_offset + b;  // output batch row for frame b

    Reader r{p + hdr.body_off, p + len, true};
    r.copy_obs(global_f, row * st[0], T1 * G, obs_bf16, hdr.wire_obs_bf16);
    r.copy_obs(hero_f, row * st[1], T1 * HF, obs_bf16, hdr.wire_obs_bf16);
    r.copy_obs(unit_f, row * st[2], T1 * U * UF, obs_bf16, hdr.wire_obs_bf16);
    r.copy_bool(unit_m + row * st[3], T1 * U);
    r.copy_bool(target_m + row * st[4], T1 * U);
    r.copy_bool(action_m + row * st[5], T1 * A);
    r.copy(act_type + row * st[6], L * 4);
    r.copy(act_mx + row * st[7], L * 4);
    r.copy(act_my + row * st[8], L * 4);
    r.copy(act_tg + row * st[9], L * 4);
    r.copy(logp + row * st[10], L * 4);
    r.copy(value + row * st[11], L * 4);
    r.copy(rewards + row * st[12], L * 4);
    r.copy(dones + row * st[13], L * 4);
    r.copy(init_c + row * st[15], H * 4);
    r.copy(init_h + row * st[16], H * 4);
    if (frame_aux) {
      if (want_aux && aux_win != nullptr) {
        r.copy(aux_win + row * st[17], L * 4);
        r.copy(aux_lh + row * st[18], L * 4);
        r.copy(aux_nw + row * st[19], L * 4);
      } else {
        r.skip(L * 3 * 4);
      }
    }
    if (!r.ok) return -(b + 1);

    float* m = mask + row * st[14];
    for (int64_t t = 0; t < L; ++t) m[t] = 1.0f;
    versions[b] = hdr.version;
    actor_ids[b] = hdr.actor_id;
    ep_returns[b] = hdr.ep_ret;
  }
  return 0;
}

// Batched header peek: one call validates and parses ALL frames of an
// ingest drain, writing parallel arrays (ok[b]=0 marks a malformed
// frame; its other outputs are unspecified): one ctypes crossing per
// drain instead of one per frame. Returns the number of well-formed
// frames.
int64_t dt_frame_headers(
    const uint8_t** frames, const int64_t* frame_lens, int64_t n,
    int64_t G, int64_t HF, int64_t U, int64_t UF, int64_t A,
    int64_t* versions, int64_t* Ls, int64_t* Hs, int64_t* flags_out,
    int64_t* actor_ids, float* ep_rets, float* last_dones, uint8_t* ok) {
  int64_t n_ok = 0;
  for (int64_t b = 0; b < n; ++b) {
    ok[b] = 0;
    Header hdr;
    if (!parse_header(frames[b], frame_lens[b], G, HF, U, UF, A, &hdr)) continue;
    versions[b] = hdr.version;
    Ls[b] = hdr.L;
    Hs[b] = hdr.H;
    flags_out[b] = hdr.flags;
    actor_ids[b] = hdr.actor_id;
    ep_rets[b] = hdr.ep_ret;
    last_dones[b] = hdr.last_done;
    ok[b] = 1;
    ++n_ok;
  }
  return n_ok;
}

// Header peek for the ingest filter: writes {version, L, H, flags,
// actor_id} and returns the episode_return via *ep_ret. Returns 0 if the
// header is well-formed and the total size matches, else -1.
int64_t dt_frame_header(
    const uint8_t* p, int64_t len,
    int64_t G, int64_t HF, int64_t U, int64_t UF, int64_t A,
    int64_t* version, int64_t* L_out, int64_t* H_out, int64_t* flags_out,
    int64_t* actor_id, float* ep_ret, float* last_done) {
  Header hdr;
  if (!parse_header(p, len, G, HF, U, UF, A, &hdr)) return -1;
  *version = hdr.version;
  *L_out = hdr.L;
  *H_out = hdr.H;
  *flags_out = hdr.flags;
  *actor_id = hdr.actor_id;
  *ep_ret = hdr.ep_ret;
  *last_done = hdr.last_done;
  return 0;
}

}  // extern "C"
