// K6: executes each block's decoded sequences into the frame's bytes.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_match.py
// _exec_kernel_smem (:954; wrapper execute_blocks_smem :1066, pallas_call
// at :1090).  It takes the reference's rows (a block's literal bytes, its
// ll / ml / off sequences with a trailing literals-only pseudo-sequence,
// meta = (n_seq, content, d_off)) plus the chain layout of K4: the first
// row of each frame, rows frame-major, and each frame's byte offset in one
// flat uint8 output.
//
// The TPU runs its grid in order and keeps the frame's recent output in a
// 256 KiB ring that persists from block to block.  There is no ring here:
// every byte lands at its place in the flat output, frame_off + d_off.
//
// Failure: ok = 0 for a block whose sequence leaves its literal row or
// its content, whose match reaches before the frame's first byte, or
// whose sequences do not end at d_off + content; the sequences before
// the failing one are written, and the rest of its chain is skipped.
// Every write stays inside the block's bytes of its frame.
//
// The first version walked each frame on one warp, a byte a lane, with a
// fence after every copy: 2.7 M cycles for a 1 MiB frame of literals (a
// level-3 text frame is one literal run a block), 1.4 ms for 8 frames on
// an H100.  This version runs in phases, as K4's execute arm does:
//  1. row_kernel, a CUDA block a row: prefix sums of ll and ll + ml give
//     each sequence its literal position and its output end; the serial
//     walk's checks then run per sequence and the row's first failing
//     sequence is found by atomicMin.  Each row's checks are its own
//     (d_off comes from meta, not from the rows before it).
//  2. frame_kernel, a thread a frame: the chain's verdicts in order (the
//     rows before the first failing row pass, the failing row writes its
//     sequences before the failure, later rows nothing), and whether the
//     executed rows tile the frame in order (each starts at or after the
//     end of the one before).  Where they do not (damaged meta: a row
//     that overlaps an earlier one), resolution by pointer doubling could
//     read a byte that a later row writes, where the serial walk read the
//     earlier value, so the frame goes to the serial arm (step 5).
//  3. scatter_kernel: every executed byte of every tiled frame, 4 bytes
//     a thread (a group inside the row stored whole: 4 bytes of out, 16
//     of srcs): a literal byte from its row, a match byte's source index
//     into srcs (folded back before the match start where off < ml: dst
//     - off + j % off).
//  4. pointer doubling resolves the chains of sources and copies from
//     their roots (csrc/pointer_doubling.cuh, shared with K4 and the LZ4
//     decoder), over the flat output as one segment.
//  5. exec_kernel, the first version's one-warp walk, for the frames that
//     step 2 sends it (their count accumulates in n_serial).
//
// Bound: the bytes moved (literals and sequences in, the frame's bytes
// out) over the card's memory rate.  What bounds this version: its
// launches (the host's), and where sequences have matches the 4 bytes of
// srcs an output byte, set, written, read by each round and the finish.

#include <cstdint>
#include <cuda_runtime.h>

#include "pointer_doubling.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_SPLIT = 32;   // CUDA blocks a row
constexpr int NO_FAIL = 0x7FFFFFFF;
// a row's summary (int32, RI_W a row): row_kernel writes HDR .. SUMOK,
// frame_kernel NEXEC .. EXT
constexpr int RI_HDR = 0;     // n_seq, content and d_off in range
constexpr int RI_FAIL = 1;    // first failing sequence, or NO_FAIL
constexpr int RI_SUMOK = 2;   // the sequences' bytes add up to content
constexpr int RI_NEXEC = 3;   // sequences executed by the scatter
constexpr int RI_FOFF = 4;    // the frame's offset in the output
constexpr int RI_EXT = 5;     // bytes they write from d_off on
constexpr int RI_W = 8;

__device__ __forceinline__ int clampi(long long v) {
  return (int)max(min(v, 0x7FFFFFFFLL), -0x7FFFFFFFLL);
}

// Phase 1: grid BL, ROW_THREADS threads.  cum[r][j] = the output bytes of
// sequences 0..j (row-relative), lpos[r][j] = the literals before j.
__global__ void __launch_bounds__(ROW_THREADS) row_kernel(
    const int* __restrict__ lla, const int* __restrict__ mla,
    const int* __restrict__ offa, int S, int LW,
    const int* __restrict__ meta, int* __restrict__ cum,
    int* __restrict__ lpos, int* __restrict__ rinfo) {
  __shared__ long long wa[ROW_THREADS / 32], wam[ROW_THREADS / 32];
  __shared__ long long carry_a, carry_am;
  __shared__ int fail;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_seq = meta[3 * r];
  const int content = meta[3 * r + 1];
  const int d_off = meta[3 * r + 2];
  int* ri = rinfo + (size_t)r * RI_W;
  if (!(n_seq >= 0 && n_seq <= S && d_off >= 0 && content >= 0)) {
    if (tid == 0) {
      ri[RI_HDR] = 0;
      ri[RI_FAIL] = 0;
      ri[RI_SUMOK] = 0;
    }
    return;
  }
  if (tid == 0) {
    fail = NO_FAIL;
    carry_a = carry_am = 0;
  }
  __syncthreads();
  const long long end = (long long)d_off + content;
  const int* ll = lla + (size_t)r * S;
  const int* ml = mla + (size_t)r * S;
  const int* of = offa + (size_t)r * S;
  int* rc = cum + (size_t)r * S;
  int* rl = lpos + (size_t)r * S;
  for (int base = 0; base < n_seq; base += ROW_THREADS) {
    const int j = base + tid;
    int a = 0, m = 0, o = 0;
    if (j < n_seq) {
      a = ll[j];
      m = ml[j];
      o = of[j];
    }
    long long sa = a, sam = (long long)a + m;   // inclusive, in the warp
    for (int d = 1; d < 32; d <<= 1) {
      const long long ua = __shfl_up_sync(0xFFFFFFFFu, sa, d);
      const long long uam = __shfl_up_sync(0xFFFFFFFFu, sam, d);
      if (lane >= d) {
        sa += ua;
        sam += uam;
      }
    }
    if (lane == 31) {
      wa[warp] = sa;
      wam[warp] = sam;
    }
    __syncthreads();
    long long pa = carry_a + sa - a, pam = carry_am + sam - a - m;
    long long ta = 0, tam = 0;
    for (int w = 0; w < ROW_THREADS / 32; ++w) {
      if (w < warp) {
        pa += wa[w];
        pam += wam[w];
      }
      ta += wa[w];
      tam += wam[w];
    }
    if (j < n_seq) {
      const long long op = d_off + pam;   // the sequence's frame position
      if (a < 0 || m < 0 || pa + a > LW || op + a + m > end ||
          (m > 0 && (o < 1 || o > op + a)))
        atomicMin(&fail, j);
      rc[j] = clampi(pam + a + m);
      rl[j] = clampi(pa);
    }
    __syncthreads();
    if (tid == 0) {
      carry_a += ta;
      carry_am += tam;
    }
    __syncthreads();
    if (fail != NO_FAIL) break;
  }
  if (tid == 0) {
    ri[RI_HDR] = 1;
    ri[RI_FAIL] = fail;
    ri[RI_SUMOK] = carry_am == content;
  }
}

// Phase 2: a thread a frame, its rows in chain order.
__global__ void frame_kernel(int F, int S, const int* __restrict__ meta,
                             const int* __restrict__ chain,
                             const long long* __restrict__ frame_off,
                             const int* __restrict__ cum,
                             int* __restrict__ rinfo, int* __restrict__ ok,
                             int* __restrict__ serial, int* n_serial) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long fsize = frame_off[f + 1] - frame_off[f];
  bool dead = false, tiles = true;
  long long prev_end = 0;
  for (int r = chain[f]; r < chain[f + 1]; ++r) {
    int* ri = rinfo + (size_t)r * RI_W;
    ri[RI_NEXEC] = 0;
    ri[RI_EXT] = 0;
    ri[RI_FOFF] = (int)frame_off[f];
    if (dead) {
      ok[r] = 0;
      continue;
    }
    const int n_seq = meta[3 * r];
    const long long d_off = meta[3 * r + 2];
    const long long end = d_off + meta[3 * r + 1];
    if (!ri[RI_HDR] || end > fsize) {
      ok[r] = 0;
      dead = true;
      continue;
    }
    const int fl = ri[RI_FAIL];
    const int nx = fl == NO_FAIL ? n_seq : fl;
    const bool good = fl == NO_FAIL && ri[RI_SUMOK];
    if (d_off < prev_end) tiles = false;
    prev_end = end;
    ri[RI_NEXEC] = nx;
    ri[RI_EXT] = nx > 0 ? cum[(size_t)r * S + nx - 1] : 0;
    ok[r] = good ? 1 : 0;
    dead = !good;
  }
  serial[f] = tiles ? 0 : 1;
  if (!tiles) {
    atomicAdd(n_serial, 1);
    for (int r = chain[f]; r < chain[f + 1]; ++r)
      rinfo[(size_t)r * RI_W + RI_NEXEC] = 0;
  }
}

// Phase 3: grid (SCATTER_SPLIT, BL).  Group g is the output's flat bytes
// [4g, 4g + 4); a thread takes the groups of its row's executed bytes
// [A, A + ext), A = frame_off + d_off, and stores a group that lies inside
// them whole (4 bytes of out, 16 of srcs: a warp's stores are contiguous)
__global__ void __launch_bounds__(SCATTER_THREADS) scatter_kernel(
    const uint8_t* __restrict__ lit, int LW, const int* __restrict__ lla,
    const int* __restrict__ mla, const int* __restrict__ offa, int S,
    const int* __restrict__ meta, const int* __restrict__ cum,
    const int* __restrict__ lpos, const int* __restrict__ rinfo,
    uint8_t* __restrict__ out, int* __restrict__ srcs) {
  const int r = blockIdx.y;
  const int* ri = rinfo + (size_t)r * RI_W;
  const int nx = ri[RI_NEXEC], ext = ri[RI_EXT];
  if (nx == 0 || ext <= 0) return;
  const long long A = (long long)ri[RI_FOFF] + meta[3 * r + 2];
  const int* ll = lla + (size_t)r * S;
  const int* ml = mla + (size_t)r * S;
  const int* of = offa + (size_t)r * S;
  const int* rc = cum + (size_t)r * S;
  const int* rl = lpos + (size_t)r * S;
  const uint8_t* row = lit + (size_t)r * LW;
  const long long g1 = (A + ext - 1) >> 2;
  for (long long g = (A >> 2) + blockIdx.x * SCATTER_THREADS + threadIdx.x;
       g <= g1; g += gridDim.x * SCATTER_THREADS) {
    const long long f0 = g << 2;
    int i = (int)max(f0 - A, 0LL);
    const int iend = (int)min(f0 + 4 - A, (long long)ext);
    int lo = 0, hi = nx - 1;   // the first sequence ending past byte i
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rc[mid] > i)
        hi = mid;
      else
        lo = mid + 1;
    }
    int j = lo;
    int e = rc[j], a = ll[j], m = ml[j], o = of[j], lp = rl[j];
    uint32_t v = 0;
    int sv[4] = {-1, -1, -1, -1};
    const bool whole = f0 >= A && f0 + 4 <= A + ext;
    for (; i < iend; ++i) {
      while (e <= i) {
        ++j;
        e = rc[j];
        a = ll[j];
        m = ml[j];
        o = of[j];
        lp = rl[j];
      }
      const int t = i - (e - a - m);
      const int k = (int)(A + i - f0);   // the byte's place in the group
      if (t < a) {
        const uint32_t b = row[lp + t];
        if (whole)
          v |= b << (8 * k);
        else
          out[A + i] = (uint8_t)b;
      } else {   // srcs is null only where no sequence has a match
        const int mt = t - a;
        const int src = (int)(A + e - m - o + (o < m ? mt % o : mt));
        if (whole)
          sv[k] = src;
        else
          srcs[A + i] = src;
      }
    }
    if (whole) {
      *reinterpret_cast<uint32_t*>(out + f0) = v;
      if (srcs)
        *reinterpret_cast<int4*>(srcs + f0) =
            make_int4(sv[0], sv[1], sv[2], sv[3]);
    }
  }
}

// Phase 5, the serial arm: one warp walks a frame's blocks in order,
// copying a byte a lane; a match whose source overlaps it (off < ml) in
// rounds of 32 bytes (off >= 32) or by repeating its off bytes.
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  for (int j = lane; j < n; j += 32) dst[j] = src[j];
  __threadfence_block();
  __syncwarp();
}

__device__ __forceinline__ void warp_match(uint8_t* dst, int off, int ml,
                                           int lane) {
  if (off >= ml) {
    for (int j = lane; j < ml; j += 32) dst[j] = dst[j - off];
  } else if (off >= 32) {
    for (int j0 = 0; j0 < ml; j0 += 32) {
      const int j = j0 + lane;
      if (j < ml) dst[j] = dst[j - off];
      __threadfence_block();
      __syncwarp();
    }
  } else {
    for (int j = lane; j < ml; j += 32) dst[j] = dst[j % off - off];
  }
  __threadfence_block();
  __syncwarp();
}

__global__ void exec_kernel(const uint8_t* __restrict__ lit, int LW,
                            const int* __restrict__ lla,
                            const int* __restrict__ mla,
                            const int* __restrict__ offa, int S,
                            const int* __restrict__ meta,
                            const int* __restrict__ chain,
                            const long long* __restrict__ frame_off,
                            const int* __restrict__ serial, uint8_t* out,
                            int* __restrict__ ok) {
  const int f = blockIdx.x;
  if (!serial[f]) return;
  const int lane = threadIdx.x;
  uint8_t* fout = out + frame_off[f];
  const long long fsize = frame_off[f + 1] - frame_off[f];
  bool failed = false;
  for (int r = chain[f]; r < chain[f + 1]; ++r) {
    if (failed) {
      if (lane == 0) ok[r] = 0;
      continue;
    }
    const int n_seq = meta[3 * r];
    const int content = meta[3 * r + 1];
    const int d_off = meta[3 * r + 2];
    const long long end = (long long)d_off + content;
    bool good = n_seq >= 0 && n_seq <= S && d_off >= 0 && content >= 0 &&
                end <= fsize;
    long long op = d_off;
    int lp = 0;
    const uint8_t* row = lit + (size_t)r * LW;
    const int* ll = lla + (size_t)r * S;
    const int* ml = mla + (size_t)r * S;
    const int* of = offa + (size_t)r * S;
    for (int j = 0; good && j < n_seq; ++j) {
      const int a = ll[j], m = ml[j], o = of[j];
      if (a < 0 || m < 0 || (long long)lp + a > LW ||
          op + a + m > end || (m > 0 && (o < 1 || o > op + a))) {
        good = false;
        break;
      }
      warp_copy(fout + op, row + lp, a, lane);
      warp_match(fout + op + a, o, m, lane);
      op += a + m;
      lp += a;
    }
    if (good && op != end) good = false;
    if (lane == 0) ok[r] = good ? 1 : 0;
    failed = !good;
  }
}

}  // namespace

// scratch (the wrapper's): cum, lpos (BL, S) int32; rinfo (BL, RI_W)
// int32; serial (F) int32; srcs (out_size) int32; changed (rounds)
// int32, zeroed here; n_serial: a running count of frames on the serial
// arm (not reset).  rounds: the doubling rounds, ceil(log2) of the most
// matches in a frame (a chain of sources steps back through matches of
// its frame); 0 where no sequence has a match (srcs is then unused)
extern "C" int zk_exec_blocks(const void* lit, const void* ll, const void* ml,
                              const void* off, const void* meta,
                              const void* chain, const void* frame_off,
                              int LW, int S, int F, int BL, int out_size,
                              int rounds, void* out, void* ok, void* cum,
                              void* lpos, void* rinfo, void* serial,
                              void* srcs, void* changed, void* n_serial,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 0) return (int)cudaGetLastError();
  cudaError_t e;
  if (BL > 0) {
    row_kernel<<<BL, ROW_THREADS, 0, s>>>(
        (const int*)ll, (const int*)ml, (const int*)off, S, LW,
        (const int*)meta, (int*)cum, (int*)lpos, (int*)rinfo);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  frame_kernel<<<(F + 127) / 128, 128, 0, s>>>(
      F, S, (const int*)meta, (const int*)chain,
      (const long long*)frame_off, (const int*)cum, (int*)rinfo, (int*)ok,
      (int*)serial, (int*)n_serial);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (BL > 0 && out_size > 0) {
    if (rounds > 0) {
      e = cudaMemsetAsync(srcs, 0xFF, (size_t)out_size * 4, s);
      if (e != cudaSuccess) return (int)e;
      e = cudaMemsetAsync(changed, 0, (size_t)rounds * 4, s);
      if (e != cudaSuccess) return (int)e;
    }
    scatter_kernel<<<dim3(SCATTER_SPLIT, BL), SCATTER_THREADS, 0, s>>>(
        (const uint8_t*)lit, LW, (const int*)ll, (const int*)ml,
        (const int*)off, S, (const int*)meta, (const int*)cum,
        (const int*)lpos, (const int*)rinfo, (uint8_t*)out,
        rounds > 0 ? (int*)srcs : nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (rounds > 0) {
      e = pd::resolve((int*)srcs, 0, nullptr, out_size, out_size, 1,
                      (int*)changed, rounds, (uint8_t*)out, s);
      if (e != cudaSuccess) return (int)e;
    }
  }
  exec_kernel<<<F, 32, 0, s>>>(
      (const uint8_t*)lit, LW, (const int*)ll, (const int*)ml,
      (const int*)off, S, (const int*)meta, (const int*)chain,
      (const long long*)frame_off, (const int*)serial, (uint8_t*)out,
      (int*)ok);
  return (int)cudaGetLastError();
}
