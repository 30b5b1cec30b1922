// K7: per-block zstd-fast hash parse.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_match.py
// _parse_kernel_smem (pallas_call at :154, wrapper hash_parse_blocks_smem
// :122) in its zstd arm (start_ip = 0, end_margin = 0, min_ref = 0):
// zstd-fast's greedy single-probe parse of each block on its own, with a
// 2^16-entry table of positions reset for every block, the miss
// accelerator 1 + (miss >> 6), word-at-a-time extension and probing up to
// blen - 12.  Outputs per row: ll, ml, offv = offset + 3 for each
// sequence, n_seq and cover_end (the last anchor).
//
// On the TPU the grid steps run in order, one block per step, each
// starting from a cleared table.  The rows are independent, so here one
// CUDA block parses one row and every row of the batch runs at once.
//
// The table lives in shared memory: a 2^16-entry int32 table (256 KiB) does
// not fit a block's 227 KB, but positions are below 2^17, so each entry
// stores pos + 1 (0 = empty) in 17 bits, the low 16 in a uint16 array and
// the high bit in a 2^16-bit bitmap: 136 KiB, cleared by the whole block.
// The walk then runs on warp 0: lane 0 reads and writes the table and
// broadcasts the candidate, the 32 lanes compare 32 words of an extension
// at once (a ballot finds the first unequal word, as the word-by-word loop
// would), and every other decision is taken by all lanes alike.  Bytes are
// read from the uint8 rows directly; the TPU's packed int32 words are gone.
//
// What bounds it: the probe walk is a dependent chain per row (hash,
// shared-memory table, global loads of the 4 bytes at ip and at the
// candidate), at L1/L2 latency; the batch's slowest row sets the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PRIME = 2654435761u;
constexpr int HASH_LOG = 16;
constexpr int TAB_SIZE = 1 << HASH_LOG;
constexpr int SMEM_BYTES = TAB_SIZE * 2 + TAB_SIZE / 8;
constexpr unsigned FULL = 0xffffffffu;

// the 4 bytes at position i of a row, little-endian (i <= N - 4)
__device__ __forceinline__ uint32_t w32(const uint32_t* xw, int i) {
  int q = i >> 2;
  int sh = (i & 3) * 8;
  uint32_t lo = xw[q];
  return sh ? __funnelshift_r(lo, xw[q + 1], sh) : lo;
}

__global__ void hash_parse_kernel(const uint8_t* __restrict__ x,
                                  const int* __restrict__ lens, int N,
                                  int cap, int max_offset, int* ll, int* ml,
                                  int* offv, int* nn) {
  extern __shared__ uint32_t smem[];
  uint16_t* tlo = reinterpret_cast<uint16_t*>(smem);
  uint32_t* thi = smem + TAB_SIZE / 2;
  for (int i = threadIdx.x; i < SMEM_BYTES / 4; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const uint8_t* xb = x + (size_t)r * N;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xb);
  int* rll = ll + (size_t)r * cap;
  int* rml = ml + (size_t)r * cap;
  int* roff = offv + (size_t)r * cap;
  const int blen = lens[r];
  const int limit = blen - 12;
  int ip = 0, anchor = 0, cnt = 0, miss = 0;
  while (ip < limit) {
    const uint32_t w = w32(xw, ip);
    int cand = 0;
    if (lane == 0) {
      const int h = (int)((w * PRIME) >> (32 - HASH_LOG));
      const uint32_t bit = 1u << (h & 31);
      cand = (int)(tlo[h] | (((thi[h >> 5] & bit) != 0) << 16)) - 1;
      const int e = ip + 1;
      tlo[h] = (uint16_t)e;
      thi[h >> 5] = (e >> 16) ? (thi[h >> 5] | bit) : (thi[h >> 5] & ~bit);
    }
    cand = __shfl_sync(FULL, cand, 0);
    const bool good = cand >= 0 && ip - cand <= max_offset && cnt < cap &&
                      w32(xw, cand) == w;
    if (!good) {
      ip += 1 + (miss >> 6);
      miss += 1;
      continue;
    }
    // extension: words while ip + l + 4 <= blen, 32 per round, then up to
    // three bytes
    const int R = blen - ip;
    int l = 4;
    while (true) {
      const int p = l + 4 * lane;
      const bool ok = p + 4 <= R && w32(xw, ip + p) == w32(xw, cand + p);
      const unsigned bal = __ballot_sync(FULL, ok);
      if (bal == FULL) {
        l += 128;
        continue;
      }
      l += 4 * (__ffs(~bal) - 1);
      break;
    }
    for (int t = 0; t < 3 && l < R && xb[ip + l] == xb[cand + l]; ++t) ++l;
    if (lane == 0) {
      rll[cnt] = ip - anchor;
      rml[cnt] = l;
      roff[cnt] = ip - cand + 3;
    }
    cnt += 1;
    ip += l;
    anchor = ip;
    miss = 0;
  }
  if (lane == 0) {
    nn[2 * r] = cnt;
    nn[2 * r + 1] = anchor;
  }
}

}  // namespace

extern "C" int zk_hash_parse(const void* x, const void* lens, int B, int N,
                             int cap, int max_offset, void* ll, void* ml,
                             void* offv, void* nn, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hash_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    hash_parse_kernel<<<B, 256, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int*)lens, N, cap, max_offset, (int*)ll,
        (int*)ml, (int*)offv, (int*)nn);
  return (int)cudaGetLastError();
}
