// K3: the 4-stream Huffman literal payload of literal-heavy rows, from the
// parse's coverage bitmask.
//
// Replaces the TPU kernel libzseek_tpu/ops/vector_entropy.py _place_kernel
// (pallas_call at :135, wrappers _place :133 / vector_literals :439) with
// its XLA prep (_vector_prep :210) and post (_vector_post :417).  The TPU
// builds each output word from one-hot matrix products over 1024-byte
// windows and repairs stream-boundary bytes and sentinels in a sparse pass
// afterwards; its prep ranks the literals, looks up their codes and takes
// suffix sums of the code lengths a stream.  As PyTorch ops that prep is
// ~20 passes over (B, 131072) int64 tensors, 20 times the placement.
//
// Here the whole call is two kernels around csrc/huf_place.cuh, the
// placement K2's literal half shares; only the source of a literal's byte
// differs (MaskSrc):
//   * vec_tables_kernel (a block of 1024 threads a row): each mask word cut
//     to the row's length (all zero on a row K3 does not take), the rank of
//     each word by a block scan of their popcounts (the row's literal count
//     is the total), then each chunk's code-length sum (phase 1);
//   * vec_place_kernel (a block a chunk): the placement (phase 2).  A row
//     K3 does not take has no literals, so only its four sentinel bits and
//     sizes are written, as the reference gives them;
//   * vec_fixup_kernel: the chunks' shared edge words.  No global atomic.
// The words are zeroed and the anchors set to -1 by memsets first.  Bound:
// the bytes (the zeroed words); on literal rows, the lookups a literal.

#include <cstdint>
#include <cuda_runtime.h>

#include "huf_place.cuh"

namespace {

__global__ void __launch_bounds__(1024)
vec_tables_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ mask,
                  const int* __restrict__ codes, const int* __restrict__ lens,
                  const uint8_t* __restrict__ vec, int N, int* rank, int* lcs,
                  int* cbits, int* parts) {
  __shared__ int ws[32];
  __shared__ int cs[256];
  const int b = blockIdx.x, nw = N >> 5;
  const hp::Slots SL = hp::slots(N, true);
  for (int i = threadIdx.x; i < 4 * SL.nch; i += blockDim.x)
    parts[(size_t)b * 4 * SL.nch + i] = -1;
  int* rk = rank + (size_t)b * nw;
  hp::MaskSrc src{rk, mask + (size_t)b * nw, x + (size_t)b * N, nw, lens[b],
                  vec[b] != 0};
  const int per = (nw + blockDim.x - 1) / blockDim.x;
  const int w0 = min(nw, (int)threadIdx.x * per), w1 = min(nw, w0 + per);
  int cnt = 0;
  for (int w = w0; w < w1; ++w) cnt += __popc(src.word(w));
  int lc;
  int r = hp::block_incl(cnt, ws, &lc) - cnt;
  for (int w = w0; w < w1; ++w) {
    rk[w] = r;
    r += __popc(src.word(w));
  }
  if (threadIdx.x == 0) lcs[b] = lc;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cs[i] = codes[256 * b + i];
  __syncthreads();
  hp::chunk_sums(src, cs, hp::lay(lc, false), SL, cbits + (size_t)b * SL.nch,
                 ws);
}

__global__ void __launch_bounds__(hp::THREADS)
vec_place_kernel(const uint8_t* __restrict__ x,
                 const uint32_t* __restrict__ mask,
                 const int* __restrict__ codes, const int* __restrict__ lens,
                 const uint8_t* __restrict__ vec, int N, int LITW, int LMAXA,
                 const int* __restrict__ rank, const int* __restrict__ lcs,
                 const int* __restrict__ cbits, int* parts, uint32_t* out,
                 int* sizes, int* lanch) {
  __shared__ int ws[32];
  __shared__ int cs[256];
  const hp::Slots SL = hp::slots(N, true);
  const int b = blockIdx.x / SL.nch, j = blockIdx.x % SL.nch, nw = N >> 5;
  int s, c;
  hp::slot_sc(SL, j, s, c);
  const hp::Lay L = hp::lay(lcs[b], false);
  if (s >= L.streams() || c >= L.cps(SL) ||
      (c > 0 && c * hp::CHUNK >= L.count(s)))
    return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cs[i] = codes[256 * b + i];
  __syncthreads();
  hp::MaskSrc src{rank + (size_t)b * nw, mask + (size_t)b * nw,
                  x + (size_t)b * N, nw, lens[b], vec[b] != 0};
  hp::place_chunk(src, cs, L, SL, s, c, cbits + (size_t)b * SL.nch,
                  out + (size_t)b * LITW, parts + (size_t)blockIdx.x * 4,
                  sizes + 4 * b, lanch + (size_t)b * 4 * LMAXA, LMAXA, ws);
}

// the chunks' shared edge words, a block a row
__global__ void vec_fixup_kernel(const int* __restrict__ parts, int N,
                                 int LITW, uint32_t* out) {
  const int nch = hp::slots(N, true).nch;
  hp::fixup_row(parts + (size_t)blockIdx.x * 4 * nch, nch,
                out + (size_t)blockIdx.x * LITW);
}

// the scratch, in int32 words: the word ranks (B, N / 32), the literal
// counts (B), the chunk sums (B, nch), the chunks' edge words (B, nch, 4);
// K3 takes 4-stream rows only, so a row has 4 * cps4 chunk slots
struct Scratch {
  size_t rank, lcs, cbits, parts, words;
};

Scratch scratch_layout(int B, int N) {
  const size_t b = B, nch = hp::slots(N, true).nch;
  Scratch L;
  L.rank = 0;
  L.lcs = b * (N >> 5);
  L.cbits = L.lcs + b;
  L.parts = L.cbits + b * nch;
  L.words = L.parts + b * nch * 4;
  return L;
}

}  // namespace

// the int32 words of scratch zk_vector_literals needs
extern "C" long long zk_vector_scratch(int B, int N) {
  return (long long)scratch_layout(B, N).words;
}

// vec: one byte a row (a bool tensor), nonzero for a row K3 takes
extern "C" int zk_vector_literals(const void* x, const void* mask,
                                  const void* codes, const void* lens,
                                  const void* vec, int B, int N, int LITW,
                                  int LMAXA, void* scratch, void* out,
                                  void* sizes, void* lanch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = cudaMemsetAsync(out, 0, (size_t)B * LITW * 4, st)) ||
      (e = cudaMemsetAsync(lanch, 0xFF, (size_t)B * 4 * LMAXA * 4, st)))
    return (int)e;
  if (B == 0) return 0;
  const Scratch L = scratch_layout(B, N);
  int* tmp = (int*)scratch;
  int *rank = tmp + L.rank, *lcs = tmp + L.lcs, *cbits = tmp + L.cbits,
      *parts = tmp + L.parts;
  vec_tables_kernel<<<B, 1024, 0, st>>>(
      (const uint8_t*)x, (const uint32_t*)mask, (const int*)codes,
      (const int*)lens, (const uint8_t*)vec, N, rank, lcs, cbits, parts);
  if ((e = cudaGetLastError())) return (int)e;
  const int nch = hp::slots(N, true).nch;
  vec_place_kernel<<<B * nch, hp::THREADS, 0, st>>>(
      (const uint8_t*)x, (const uint32_t*)mask, (const int*)codes,
      (const int*)lens, (const uint8_t*)vec, N, LITW, LMAXA, rank, lcs, cbits,
      parts, (uint32_t*)out, (int*)sizes, (int*)lanch);
  if ((e = cudaGetLastError())) return (int)e;
  vec_fixup_kernel<<<B, 128, 0, st>>>(parts, N, LITW, (uint32_t*)out);
  return (int)cudaGetLastError();
}
