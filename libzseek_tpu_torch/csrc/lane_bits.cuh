// Backward-bitstream reads of the lane decoders (csrc/huf_lanes.cu,
// csrc/fse_lanes.cu): the reference's _read_at / _read_wide
// (libzseek_tpu/ops/zstd_decode.py:380-397, :556-574) on a bank of
// streams, one (SB,) uint8 row each, SB a multiple of 4, zero-padded.
// Below them, the windowed FSE sequence step shared by the sequence lanes
// and K4's transcode row walk (csrc/decode.cu): staged table entries with
// ctab folded in, and a sequence's six fields by 64-bit shifts out of the
// 128 stream bits below its position (numpy mirror: testing/seq_mirror.py).
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

// ---------------------------------------------------------------------------
// the windowed sequence step

constexpr int FSE_TAB = 512;            // entries of one FSE table
// ctab layout (ops/decode.py CTAB): LL bits | LL base | ML bits | ML base
constexpr int N_LL = 36;
constexpr int N_ML = 53;
constexpr int C_LL_BITS = 0;
constexpr int C_LL_BASE = N_LL;
constexpr int C_ML_BITS = 2 * N_LL;
constexpr int C_ML_BASE = 2 * N_LL + N_ML;
constexpr int N_CTAB = 2 * N_LL + 2 * N_ML;
constexpr int PAD = 4;                  // zero words around staged ones
constexpr int NARROW_NB = 11;           // the widest state read it serves
constexpr uint32_t WIDE = 1u << 31;     // entry flag: the window cannot serve
constexpr int STAGE_UNROLL = 8;

// the folded half of table k's entry e (LL k = 0, OF k = 1, ML k = 2):
// ctab's baseline | extra-bit count << 24 (OF: its code is its count),
// WIDE where a windowed step could not read it
__device__ __forceinline__ uint32_t fold(const int* ct, int k, int e) {
  const int c = e & 255;
  bool wide = ((e >> 8) & 255) > NARROW_NB;
  uint32_t y = 0;
  if (k == 1) {
    wide |= c > 31;
  } else if (k == 0) {
    const int cc = min(c, N_LL - 1);
    y = (uint32_t)ct[C_LL_BASE + cc] | ((uint32_t)ct[C_LL_BITS + cc] << 24);
  } else {
    const int cc = min(c, N_ML - 1);
    y = (uint32_t)ct[C_ML_BASE + cc] | ((uint32_t)ct[C_ML_BITS + cc] << 24);
  }
  return wide ? (y | WIDE) : y;
}

// stage table triple tid3 of tabs (index clamped to [0, last]) into sh (3
// * 512 uint2: the raw entry, its folded half) by the block's threads,
// STAGE_UNROLL loads a thread in flight before any store
__device__ __forceinline__ void stage_tables(uint2* sh, const int* tabs,
                                             long long last, const int* ct,
                                             const int* tid3) {
  for (int i0 = threadIdx.x; i0 < 3 * FSE_TAB;
       i0 += blockDim.x * STAGE_UNROLL) {
    int e[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      e[u] = 0;
      if (i < 3 * FSE_TAB) {
        const int k = i / FSE_TAB;
        long long j = (long long)tid3[k] * FSE_TAB + (i - k * FSE_TAB);
        j = j < 0 ? 0 : (j > last ? last : j);
        e[u] = __ldg(tabs + j);
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < 3 * FSE_TAB)
        sh[i] = make_uint2((uint32_t)e[u], fold(ct, i / FSE_TAB, e[u]));
    }
  }
}

// stream words: staged in shared memory (words [0, n) at w[PAD ...],
// PAD zero words on either side), or read from the row in global memory
// (zeros outside the row's nw words)
struct SmemWords {
  const uint32_t* w;
  int n;
  __device__ __forceinline__ uint32_t at(int i) const {
    return w[min(max(i, -PAD), n + PAD - 1) + PAD];
  }
};

struct GmemWords {
  const uint32_t* w;
  int nw;
  __device__ __forceinline__ uint32_t at(int i) const {
    return (unsigned)i < (unsigned)nw ? __ldg(w + i) : 0u;
  }
};

// the 128 bits below position p, as two 64-bit values: X = bits
// [p - 64, p), Y = bits [p - 128, p - 64), from the five words from
// floor32(p - 128)
template <class Words>
__device__ __forceinline__ void window(const Words& src, int p,
                                       unsigned long long& X,
                                       unsigned long long& Y) {
  const int q = p - 2 * 64;
  const int j = q >> 5;      // floor
  const int sh = q & 31;
  const uint32_t w0 = src.at(j), w1 = src.at(j + 1), w2 = src.at(j + 2),
                 w3 = src.at(j + 3), w4 = src.at(j + 4);
  Y = ((unsigned long long)__funnelshift_r(w1, w2, sh) << 32) |
      __funnelshift_r(w0, w1, sh);
  X = ((unsigned long long)__funnelshift_r(w3, w4, sh) << 32) |
      __funnelshift_r(w2, w3, sh);
}

// the nb <= 31 bits that end d <= 64 bits below the top of V, given V1
// = V >> 1 (so that d = 0 shifts by 63, not 64)
__device__ __forceinline__ uint32_t top(unsigned long long V1, int d,
                                        int nb) {
  return (uint32_t)(V1 >> (63 - d)) & ~(0xFFFFFFFFu << nb);
}

// a windowed step's six fields from the 128 bits below pos (X, Y as
// window gives them): the OF, ML and LL extra bits (ofc, mlb, llb wide,
// read downward from pos), then the LL, ML and OF state bits (nll, nml,
// nof) below them.  Needs ofc + mlb + llb <= 63 and nll + nml + nof <=
// 33: the states then lie in Z, the 64 bits below p3 = pos - d3.
__device__ __forceinline__ void window_fields(
    unsigned long long X, unsigned long long Y, int ofc, int mlb, int llb,
    int nll, int nml, int nof, uint32_t& xo, uint32_t& xm, uint32_t& xl,
    uint32_t& yl, uint32_t& ym, uint32_t& yo) {
  const int d1 = ofc, d2 = d1 + mlb, d3 = d2 + llb;
  const int e1 = nll, e2 = e1 + nml, e3 = e2 + nof;
  const unsigned long long X1 = X >> 1;
  xo = top(X1, d1, ofc);
  xm = top(X1, d2, mlb);
  xl = top(X1, d3, llb);
  const unsigned long long Z1 = ((X << d3) | ((Y >> 1) >> (63 - d3))) >> 1;
  yl = top(Z1, e1, nll);
  ym = top(Z1, e2, nml);
  yo = top(Z1, e3, nof);
}

}  // namespace lanebits
