// FSE sequence lane decoder of the lane decode route.
//
// Replaces two XLA while_loops of libzseek_tpu/ops/zstd_decode.py (not
// TPU kernels): fse_decode_seq_lanes (:443), one lane per block's
// sequence stream with tagged repcodes that the host resolves later
// (_resolve_tags, :762), and fse_decode_anchored (:620), one lane per
// 128-sequence chunk from the Writer's (bit position, states, rep1)
// checkpoints (format/hints.py).  As torch ops each step would be dozens
// of tiny launches and a host sync, so the walk is one kernel.
//
// One thread per lane walks the 3-state tANS stream backward: table
// entries (sym | nb << 8 | base << 16) from tabs (T, 512), extra bits OF
// then ML then LL (up to 31 offset bits through read_wide, ofv = (1 <<
// min(ofc, 30)) + extra in int32), the repcode step, then the state
// updates LL, ML, OF except after the lane's last sequence.
//   tagged = 1 (pass B): the initial states are read from the top of the
//     stream (log 0, an RLE table: state 0) and the repcodes start as the
//     tags -(k << 20); the full three-rep rule runs on them; ok = exact
//     consumption.
//   tagged = 0 (pass B'): states and rep1 come from the checkpoint, and
//     off = ofv - 3 or rep1 (the encoder emits no other repcode); ok =
//     pos >= 0.
//
// Bound: per sequence a chain of three table loads and six stream reads,
// latency-bound per lane; the anchored pass supplies the lanes.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_bits.cuh"

namespace {

constexpr int FSE_TAB = 512;
constexpr int REP_TAG = 1 << 20;
// ctab layout (ops/decode.py CTAB): LL bits | LL base | ML bits | ML base
constexpr int N_LL = 36;
constexpr int N_ML = 53;
constexpr int C_LL_BITS = 0;
constexpr int C_LL_BASE = N_LL;
constexpr int C_ML_BITS = 2 * N_LL;
constexpr int C_ML_BASE = 2 * N_LL + N_ML;

__device__ __forceinline__ int entry(const int* tabs, long long last,
                                     long long base, int state) {
  long long k = base + state;
  k = k < 0 ? 0 : (k > last ? last : k);
  return __ldg(tabs + k);
}

__global__ void fse_lanes_kernel(
    const uint8_t* __restrict__ bank, int SB, int NS,
    const int* __restrict__ sid, const int* __restrict__ bits,
    const int* __restrict__ n, const int* __restrict__ states,
    const int* __restrict__ rep1, const int* __restrict__ tids,
    const int* __restrict__ tls, const int* __restrict__ tabs, int T,
    const int* __restrict__ ctab, int L, int cap, int tagged,
    int* __restrict__ ll_out, int* __restrict__ ml_out,
    int* __restrict__ off_out, int* __restrict__ rep_out,
    uint8_t* __restrict__ ok) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  using lanebits::read_at;
  using lanebits::read_wide;
  const int s = min(max(sid[l], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const long long last = (long long)T * FSE_TAB - 1;
  const long long b_ll = (long long)tids[3 * l] * FSE_TAB;
  const long long b_of = (long long)tids[3 * l + 1] * FSE_TAB;
  const long long b_ml = (long long)tids[3 * l + 2] * FSE_TAB;
  int pos = bits[l];
  int s_ll, s_of, s_ml, r1, r2, r3;
  if (tagged) {
    const int tl_ll = tls[3 * l], tl_of = tls[3 * l + 1],
              tl_ml = tls[3 * l + 2];
    s_ll = (int)read_at(row, SB, pos - tl_ll, tl_ll);
    pos -= tl_ll;
    s_of = (int)read_at(row, SB, pos - tl_of, tl_of);
    pos -= tl_of;
    s_ml = (int)read_at(row, SB, pos - tl_ml, tl_ml);
    pos -= tl_ml;
    r1 = -REP_TAG;
    r2 = -2 * REP_TAG;
    r3 = -3 * REP_TAG;
  } else {
    s_ll = states[3 * l];
    s_of = states[3 * l + 1];
    s_ml = states[3 * l + 2];
    r1 = rep1[l];
    r2 = 0;
    r3 = 0;
  }
  const int cnt = min(n[l], cap);
  int* lo = ll_out + (size_t)l * cap;
  int* mo = ml_out + (size_t)l * cap;
  int* oo = off_out + (size_t)l * cap;
  for (int t = 0; t < cnt; ++t) {
    const int e_ll = entry(tabs, last, b_ll, s_ll);
    const int e_of = entry(tabs, last, b_of, s_of);
    const int e_ml = entry(tabs, last, b_ml, s_ml);
    const int ofc = e_of & 255;
    const int mlc = min(e_ml & 255, N_ML - 1);
    const int llc = min(e_ll & 255, N_LL - 1);
    const uint32_t of_extra = read_wide(row, SB, pos - ofc, ofc);
    pos -= ofc;
    const int ofv = (int)((1u << min(ofc, 30)) + of_extra);
    const int mlb = __ldg(ctab + C_ML_BITS + mlc);
    const int ml = __ldg(ctab + C_ML_BASE + mlc) +
                   (int)read_at(row, SB, pos - mlb, mlb);
    pos -= mlb;
    const int llb = __ldg(ctab + C_LL_BITS + llc);
    const int ll = __ldg(ctab + C_LL_BASE + llc) +
                   (int)read_at(row, SB, pos - llb, llb);
    pos -= llb;
    int off;
    if (tagged) {
      const int idx = (int)((uint32_t)ofv + (ll == 0 ? 1u : 0u));
      int n_r2, n_r3;
      if (ofv > 3) {
        off = ofv - 3;
        n_r2 = r1;
        n_r3 = r2;
      } else if (idx == 1) {
        off = r1;
        n_r2 = r2;
        n_r3 = r3;
      } else if (idx == 2) {
        off = r2;
        n_r2 = r1;
        n_r3 = r3;
      } else if (idx == 3) {
        off = r3;
        n_r2 = r1;
        n_r3 = r2;
      } else {
        off = r1 - 1;
        n_r2 = r1;
        n_r3 = r2;
      }
      r2 = n_r2;
      r3 = n_r3;
    } else {
      off = ofv > 3 ? ofv - 3 : r1;
    }
    r1 = off;
    if (t < n[l] - 1) {
      const int nb_ll = (e_ll >> 8) & 255;
      const int ns_ll = (e_ll >> 16) + (int)read_at(row, SB, pos - nb_ll,
                                                    nb_ll);
      pos -= nb_ll;
      const int nb_ml = (e_ml >> 8) & 255;
      const int ns_ml = (e_ml >> 16) + (int)read_at(row, SB, pos - nb_ml,
                                                    nb_ml);
      pos -= nb_ml;
      const int nb_of = (e_of >> 8) & 255;
      const int ns_of = (e_of >> 16) + (int)read_at(row, SB, pos - nb_of,
                                                    nb_of);
      pos -= nb_of;
      s_ll = ns_ll;
      s_ml = ns_ml;
      s_of = ns_of;
    }
    lo[t] = ll;
    mo[t] = ml;
    oo[t] = off;
  }
  rep_out[3 * l] = r1;
  rep_out[3 * l + 1] = r2;
  rep_out[3 * l + 2] = r3;
  ok[l] = tagged ? (pos == 0) : (pos >= 0);
}

}  // namespace

extern "C" int zk_fse_lanes(const void* bank, const void* sid,
                            const void* bits, const void* n,
                            const void* states, const void* rep1,
                            const void* tids, const void* tls,
                            const void* tabs, const void* ctab, int SB,
                            int NS, int T, int L, int cap, int tagged,
                            void* ll, void* ml, void* off, void* rep,
                            void* ok, void* stream) {
  const int threads = 128;
  fse_lanes_kernel<<<(L + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
      (const int*)n, (const int*)states, (const int*)rep1, (const int*)tids,
      (const int*)tls, (const int*)tabs, T, (const int*)ctab, L, cap, tagged,
      (int*)ll, (int*)ml, (int*)off, (int*)rep, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
