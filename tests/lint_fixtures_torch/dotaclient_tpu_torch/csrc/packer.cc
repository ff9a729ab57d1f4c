// Mini packer for the WIRE001 fixture: the extraction surface of the
// real csrc/packer.cc, with a DELIBERATE dtype-map drift — kWireBf16
// is 4 here while serialize.py says 3 (the fixture corpus's WIRE001
// must fire on this). Never compiled.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kHeaderBytes = 21;
constexpr int64_t kTraceExtBytes = 16;
constexpr uint8_t kFlagAux = 1;
constexpr uint8_t kWireF32 = 0, kWireI32 = 1, kWireU8 = 2, kWireBf16 = 4;

bool parse_header(const uint8_t* p, int64_t len, int64_t* body_out) {
  const bool aux = (p[12] & kFlagAux) != 0;
  int64_t body = kHeaderBytes + kTraceExtBytes;
  const int64_t n_map = aux ? 19 : 16;
  if (p[body] != n_map) return false;
  body += 1;
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
  *body_out = body + n_map;
  return true;
}

}  // namespace
