// Backward-bitstream reads of the lane decoders (csrc/huf_lanes.cu,
// csrc/fse_lanes.cu): the reference's _read_at / _read_wide
// (libzseek_tpu/ops/zstd_decode.py:380-397, :556-574) on a bank of
// streams, one (SB,) uint8 row each, SB a multiple of 4, zero-padded.
#pragma once

#include <cstdint>

namespace lanebits {

// LE32 window starting at byte q of the row (q clamped to SB - 1, zero
// past the row's end), as the reference's _win32 windows
__device__ __forceinline__ uint32_t win_at(const uint8_t* row, int SB,
                                           int q) {
  q = min(q, SB - 1);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int wi = q >> 2;
  const int sh = (q & 3) * 8;
  const uint32_t lo = __ldg(w + wi);
  const uint32_t hi = (wi + 1) < (SB >> 2) ? __ldg(w + wi + 1) : 0u;
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}

// bits [start, start + nb) of the stream; bits below position 0 read as
// (w << min(-start, 31)) & mask; nb >= 32 masks all 32 bits (XLA's
// shift of 1 by >= 32 is 0, so its mask is all ones)
__device__ __forceinline__ uint32_t read_at(const uint8_t* row, int SB,
                                            int start, int nb) {
  const int s0 = max(start, 0);
  const uint32_t w = win_at(row, SB, s0 >> 3) >> (s0 & 7);
  const uint32_t mask = nb >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
  if (start >= 0) return w & mask;
  const int under = start < -31 ? 31 : -start;
  return (w << under) & mask;
}

// an offset's extra bits (up to 31): two reads of <= 16 bits
__device__ __forceinline__ uint32_t read_wide(const uint8_t* row, int SB,
                                              int start, int nb) {
  const int lo_nb = min(nb, 16);
  return read_at(row, SB, start, lo_nb) |
         (read_at(row, SB, start + 16, nb - lo_nb) << 16);
}

}  // namespace lanebits
