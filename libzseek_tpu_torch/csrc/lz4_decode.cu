// LZ4 frame decode on the card.
//
// Replaces the XLA decoder libzseek_tpu/ops/lz4_decode.py
// lz4_decode_frames (:110), not a Pallas kernel: there the token stream
// is a while_loop over sequences vectorised over blocks, and execution is
// a literal scatter plus pointer-doubling copy resolution.  In torch ops
// on the card that loop would be thousands of tiny launches with a host
// sync per step.
//
// Here one warp walks one frame: its blocks in order, each block's
// tokens in order, all 32 lanes reading the same header bytes (uniform
// control flow) and copying together, straight into the frame's output
// row.  Literals go in rounds of 32 bytes; a match with offset < 32
// repeats the last `off` bytes (dst[j] = dst[j % off - off]), one with
// offset >= 32 goes in rounds of 32, each reading bytes an earlier round
// or sequence wrote.  Linked frames may reach back to the frame's first
// byte, independent frames only to their block's start.  Uncompressed
// blocks are copied.
//
// Flags follow the reference exactly: a block is bad on a truncated or
// overrunning sequence, offset 0, an offset past the block start
// (independent frames), or more than max_seqs sequences; the block stops
// there (its output ends before the bad sequence) and the frame's later
// blocks still decode, so out_lens is the reference's.  A match that
// starts inside the row and before the frame start makes the frame bad
// and is not copied.  Loads of header bytes past the padded block row
// are clamped to its last byte, as the reference's gathers are.  Nothing
// is written past F; the wrapper zero-fills the output.
//
// What bounds it: the token walk is a serial chain of dependent byte
// loads, one warp per frame, so a launch lasts as long as its longest
// frame; the copies are coalesced 32-byte rounds.  The bound is the bytes
// moved (compressed bytes in, decompressed bytes out).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Blk {
  const uint8_t* row;  // the block's padded row of M bytes
  int M;
};

__device__ __forceinline__ int g(const Blk& b, int i) {
  i = i < 0 ? 0 : (i > b.M - 1 ? b.M - 1 : i);
  return b.row[i];
}

// number of consecutive 0xFF bytes from position i (clamped) to the row end
__device__ __forceinline__ int ff_run(const Blk& b, int i) {
  i = i < 0 ? 0 : (i > b.M - 1 ? b.M - 1 : i);
  int n = 0;
  while (i + n < b.M && b.row[i + n] == 0xFF) ++n;
  return n;
}

// copy n bytes of the frame's compressed rows from flat index `src` to
// out[dst..]: bytes past the frame's rows stay 0, bytes past F are dropped
__device__ __forceinline__ void warp_lits(uint8_t* out, long long dst,
                                          const uint8_t* comp_f,
                                          long long src, long long n,
                                          long long KM, long long F,
                                          int lane) {
  for (long long j = lane; j < n; j += 32) {
    long long d = dst + j, s = src + j;
    if (d < F && s < KM) out[d] = comp_f[s];
  }
  __threadfence_block();
  __syncwarp();
}

// out[dst + j] = out[dst + j - off] for j < ml, positions < F only
__device__ __forceinline__ void warp_match(uint8_t* out, long long dst,
                                           int off, long long ml,
                                           long long F, int lane) {
  long long n = F - dst < ml ? F - dst : ml;
  if (n <= 0) return;
  uint8_t* d = out + dst;
  if (off >= n) {
    for (long long j = lane; j < n; j += 32) d[j] = d[j - off];
  } else if (off >= 32) {
    for (long long j0 = 0; j0 < n; j0 += 32) {
      const long long j = j0 + lane;
      if (j < n) d[j] = d[j - off];
      __threadfence_block();
      __syncwarp();
    }
  } else {
    for (long long j = lane; j < n; j += 32) d[j] = d[j % off - off];
  }
  __threadfence_block();
  __syncwarp();
}

__global__ void lz4_decode_kernel(const uint8_t* __restrict__ comp,
                                  const int* __restrict__ clens,
                                  const uint8_t* __restrict__ unc, int K,
                                  int M, long long F, int max_seqs,
                                  int linked, uint8_t* out, int* out_lens,
                                  uint8_t* ok) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const long long KM = (long long)K * M;
  const uint8_t* comp_f = comp + (size_t)b * KM;
  uint8_t* fo = out + (size_t)b * F;
  long long base = 0;  // the frame's bytes so far
  bool bad = false;
  for (int k = 0; k < K; ++k) {
    const int clen = clens[b * K + k];
    const long long kb = (long long)k * M;
    if (unc[b * K + k]) {
      warp_lits(fo, base, comp_f, kb, clen, KM, F, lane);
      base += clen;
      continue;
    }
    Blk B{comp_f + kb, M};
    int ip = 0;
    long long op = 0;   // block-local output position
    for (int s = 0; clen > 0; ++s) {
      if (s == max_seqs) {
        bad = true;     // ran out of sequence budget mid-block
        break;
      }
      const int token = g(B, ip);
      int ll = token >> 4, ll_extbytes = 0;
      if (ll == 15) {
        const int ffr = ff_run(B, ip + 1);
        ll_extbytes = ffr + 1;
        ll = 15 + 255 * ffr + g(B, ip + 1 + ffr);
      }
      const int src = ip + 1 + ll_extbytes;
      const int lit_end = src + ll;
      const bool is_last = lit_end >= clen;
      const int off = g(B, lit_end) | (g(B, lit_end + 1) << 8);
      int ml = (token & 15) + 4, ml_extbytes = 0;
      if ((token & 15) == 15) {
        const int ffr2 = ff_run(B, lit_end + 2);
        ml_extbytes = ffr2 + 1;
        ml = 19 + 255 * ffr2 + g(B, lit_end + 2 + ffr2);
      }
      const long long match_dst = op + ll;
      bool overrun = lit_end > clen ||
                     (!is_last && (lit_end + 2 + ml_extbytes > clen ||
                                   off == 0));
      if (!linked) overrun = overrun || (!is_last && off > match_dst);
      if (overrun) {
        bad = true;
        break;
      }
      warp_lits(fo, base + op, comp_f, kb + src, ll, KM, F, lane);
      if (is_last) {
        op += ll;
        break;
      }
      const long long mdst = base + match_dst;
      if (mdst < F && mdst - off < 0) bad = true;   // before the frame
      else warp_match(fo, mdst, off, ml, F, lane);
      op = match_dst + ml;
      ip = lit_end + 2 + ml_extbytes;
    }
    base += op;
  }
  if (lane == 0) {
    out_lens[b] = (int)base;
    ok[b] = bad ? 0 : 1;
  }
}

}  // namespace

extern "C" int zk_lz4_decode(const void* comp, const void* clens,
                             const void* unc, int B, int K, int M, int F,
                             int max_seqs, int linked, void* out,
                             void* out_lens, void* ok, void* stream) {
  if (B > 0)
    lz4_decode_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clens, (const uint8_t*)unc, K, M,
        (long long)F, max_seqs, linked, (uint8_t*)out, (int*)out_lens,
        (uint8_t*)ok);
  return (int)cudaGetLastError();
}
