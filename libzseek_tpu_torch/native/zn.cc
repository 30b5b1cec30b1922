// Native host library of libzseek_tpu_torch.
//
// Copy of the entry points of libzseek_tpu/native/zn.cc that the port
// calls, with the helpers they need:
//
//   * zn_ldm_scan: the long-distance match pre-pass of the write path
//     (whole-block matches beyond the linked parse's window); it changes
//     the archive bytes, so the codec requires this library;
//   * zn_huf_tree_batch: Huffman tree-description serialization (direct
//     4-bit weights or FSE-compressed weights, whichever is smaller,
//     RFC 8878 §4.2.1.2) from the weights the device plan builds;
//   * zn_huf_build_batch: per-block literal Huffman tables on the host
//     (length-limited package-merge, canonical values, serialization),
//     the hash-parser path's table decisions;
//   * zn_gate_entropy: the hash parser's gate entropy, bit for bit as the
//     reference's XLA code computes it on the CPU (not in the reference's
//     native library: the reference computes it on its device);
//   * zn_xxh64: XXH64, the seek table's per-frame checksum;
//   * zn_seektable_serialize, zn_seektable_parse: the seek table's
//     skippable frame (no checksums) and its cumulative offsets;
//   * zn_lz4_decode: one LZ4 block into a frame buffer, the LZ4 codec's
//     host decode route;
//   * zn_zir_execute: one transcoded zstd block (literal bytes and the
//     packed sequence tokens K4's transcode arm emits) into its frame's
//     buffer, the transcode decode route's host executor;
//   * zn_huf_decode_batch: Huffman literal streams on the host, the
//     transcode route's host-literal arm; repaired against the original
//     (see its comment).
//
// A plain C ABI consumed through ctypes.  libzseek_tpu_torch/native/
// __init__.py compiles this file with `c++ -O2 -std=c++17 -shared -fPIC
// -ffp-contract=off` at first use into build/torch_native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// bit writer (LSB-first, BIT_addBits/BIT_closeCStream semantics)
// ---------------------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;
  void add(uint32_t v, int nb) {
    acc |= (uint64_t)(v & ((1u << nb) - 1)) << nacc;
    nacc += nb;
    while (nacc >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  void close_with_sentinel() {
    acc |= (uint64_t)1 << nacc;
    nacc += 1;
    while (nacc > 0) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  void flush_partial() {  // byte-align without sentinel
    if (nacc) {
      out.push_back((uint8_t)acc);
      acc = 0;
      nacc = 0;
    }
  }
};

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// package-merge length-limited Huffman (exact optimal under max_bits)
// ---------------------------------------------------------------------------
void package_merge(const uint32_t* hist, int n_sym, int max_bits,
                   int32_t* lengths /*256*/) {
  std::memset(lengths, 0, 256 * sizeof(int32_t));
  std::vector<int> syms;
  for (int s = 0; s < n_sym; ++s)
    if (hist[s]) syms.push_back(s);
  int n = (int)syms.size();
  if (n == 0) return;
  if (n == 1) {
    lengths[syms[0]] = 1;
    return;
  }
  // item = (weight, per-symbol multiplicity)
  struct Item {
    uint64_t w;
    std::vector<uint16_t> cnt;
  };
  auto cmp = [](const Item& a, const Item& b) { return a.w < b.w; };
  std::vector<Item> base(n);
  for (int i = 0; i < n; ++i) {
    base[i].w = hist[syms[i]];
    base[i].cnt.assign(n, 0);
    base[i].cnt[i] = 1;
  }
  std::sort(base.begin(), base.end(), cmp);
  // list_1 = base; list_j = merge(base, package(list_{j-1})); take the
  // 2n-2 cheapest items of list_max_bits (max_bits - 1 package steps)
  std::vector<Item> lst(base);
  for (int it = 0; it < max_bits - 1; ++it) {
    std::vector<Item> packaged;
    for (size_t k = 0; k + 1 < lst.size(); k += 2) {
      Item x;
      x.w = lst[k].w + lst[k + 1].w;
      x.cnt.assign(n, 0);
      for (int i = 0; i < n; ++i)
        x.cnt[i] = lst[k].cnt[i] + lst[k + 1].cnt[i];
      packaged.push_back(std::move(x));
    }
    std::vector<Item> merged;
    merged.reserve(packaged.size() + base.size());
    std::merge(packaged.begin(), packaged.end(), base.begin(), base.end(),
               std::back_inserter(merged), cmp);
    lst = std::move(merged);
  }
  int take = std::min<int>(2 * (n - 1), (int)lst.size());
  std::vector<uint32_t> lcount(n, 0);
  for (int k = 0; k < take; ++k)
    for (int i = 0; i < n; ++i) lcount[i] += lst[k].cnt[i];
  for (int i = 0; i < n; ++i) lengths[syms[i]] = (int32_t)lcount[i];
}

// zstd canonical code values: longest first, symbol order within a length
void canonical_codes(const int32_t* lengths, int32_t* codes /*256*/,
                     int* max_used_out) {
  int max_used = 0;
  for (int s = 0; s < 256; ++s) max_used = std::max(max_used, (int)lengths[s]);
  std::vector<int> nb_per_rank(max_used + 2, 0);
  for (int s = 0; s < 256; ++s)
    if (lengths[s] > 0) nb_per_rank[lengths[s]]++;
  std::vector<int64_t> val_per_rank(max_used + 2, 0);
  int64_t mn = 0;
  for (int nb = max_used; nb > 0; --nb) {
    val_per_rank[nb] = mn;
    mn += nb_per_rank[nb];
    mn >>= 1;
  }
  std::vector<int64_t> cursor(val_per_rank);
  for (int s = 0; s < 256; ++s) {
    codes[s] = lengths[s] > 0 ? (int32_t)cursor[lengths[s]]++ : 0;
  }
  *max_used_out = max_used;
}

// ---------------------------------------------------------------------------
// the hash parser's gate entropy, float for float as the reference computes
// it under XLA on the CPU
// ---------------------------------------------------------------------------
// XLA's CPU backend lowers a float32 log to the Cephes polynomial below and
// lets LLVM fuse its multiply-adds (TargetOptions AllowFPOpFusion = Fast);
// fmaf here stands for each fused pair, and every other step is one
// rounded float operation (this file is built with -ffp-contract=off).
float xla_logf(float in) {
  const float P0 = 0x1.204376p-4f, P1 = -0x1.d7a370p-4f,
              P2 = 0x1.de4a34p-4f, P3 = -0x1.fcba9ep-4f,
              P4 = 0x1.23d37ep-3f, P5 = -0x1.555ca0p-3f,
              P6 = 0x1.999d58p-3f, P7 = -0x1.fffff8p-3f,
              P8 = 0x1.555554p-2f, Q1 = -0x1.bd0106p-13f,
              Q2 = 0x1.63p-1f, SQRTHF = 0x1.6a09e6p-1f;
  const float MIN_NORM = 0x1p-126f;
  float x = MIN_NORM >= in ? MIN_NORM : in;
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  float e = 1.0f + (float)((int32_t)(bits >> 23) - 127);
  uint32_t mbits = (bits & 0x807fffffu) | 0x3f000000u;  // mantissa in [.5, 1)
  float m;
  std::memcpy(&m, &mbits, 4);
  bool low = m < SQRTHF;
  float t = (m - 1.0f) + (low ? m : 0.0f);
  e = e - (low ? 1.0f : 0.0f);
  float t2 = t * t, t3 = t2 * t;
  float y = std::fmaf(t, P0, P1), y1 = std::fmaf(t, P3, P4),
        y2 = std::fmaf(t, P6, P7);
  y = std::fmaf(y, t, P2);
  y1 = std::fmaf(y1, t, P5);
  y2 = std::fmaf(y2, t, P8);
  y = std::fmaf(y, t3, y1);
  y = std::fmaf(y, t3, y2);
  y = std::fmaf(y, t3, Q1 * e);
  float s = std::fmaf(-0.5f, t2, t) + y;
  return std::fmaf(Q2, e, s);
}

// ---------------------------------------------------------------------------
// FSE (RFC 8878 §4.1): normalization, table build, ncount serialization
// ---------------------------------------------------------------------------
bool normalize_counts(const uint32_t* counts, int n, int table_log,
                      uint64_t total, int32_t* norm) {
  int table_size = 1 << table_log;
  if (total == 0) return false;
  int64_t ssum = 0, n_low = 0;
  for (int i = 0; i < n; ++i) {
    if (!counts[i]) {
      norm[i] = 0;
      continue;
    }
    double scaled = (double)counts[i] * table_size / (double)total;
    int64_t v = std::max<int64_t>(1, (int64_t)(scaled + 0.5));
    bool low = (uint64_t)counts[i] * 3 < (total * 2) / table_size + 1;
    norm[i] = (low && v <= 1) ? -1 : (int32_t)v;
    if (norm[i] > 0) ssum += norm[i];
    else n_low++;
  }
  int64_t diff = table_size - (ssum + n_low);
  if (diff != 0) {
    // adjust the largest entry
    int best = -1;
    for (int i = 0; i < n; ++i)
      if (norm[i] > 0 && (best < 0 || norm[i] > norm[best])) best = i;
    if (best < 0 || norm[best] + diff < 1) return false;
    norm[best] += (int32_t)diff;
  }
  return true;
}

struct FseEnc {
  int table_log;
  std::vector<int32_t> state_table, delta_nb, delta_fs;
};

bool spread_symbols(const int32_t* norm, int n, int table_log,
                    std::vector<int32_t>& table) {
  int table_size = 1 << table_log;
  table.assign(table_size, 0);
  int high = table_size - 1;
  for (int s = 0; s < n; ++s)
    if (norm[s] == -1) table[high--] = s;
  int step = (table_size >> 1) + (table_size >> 3) + 3;
  int mask = table_size - 1;
  int pos = 0;
  for (int s = 0; s < n; ++s) {
    for (int c = 0; c < norm[s]; ++c) {
      table[pos] = s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  return pos == 0;
}

bool build_fse_enc(const int32_t* norm, int n, int table_log, FseEnc& et) {
  int table_size = 1 << table_log;
  std::vector<int32_t> spread;
  if (!spread_symbols(norm, n, table_log, spread)) return false;
  std::vector<int32_t> cumul(n + 1, 0);
  int acc = 0;
  for (int s = 0; s < n; ++s) {
    cumul[s] = acc;
    acc += norm[s] == -1 ? 1 : std::max(0, (int)norm[s]);
  }
  cumul[n] = acc;
  et.table_log = table_log;
  et.state_table.assign(table_size, 0);
  std::vector<int32_t> cursor(cumul);
  for (int u = 0; u < table_size; ++u)
    et.state_table[cursor[spread[u]]++] = table_size + u;
  et.delta_nb.assign(n, 0);
  et.delta_fs.assign(n, 0);
  int total = 0;
  for (int s = 0; s < n; ++s) {
    int c = norm[s];
    if (c == 0) {
      et.delta_nb[s] = ((table_log + 1) << 16) - table_size;
      et.delta_fs[s] = 0;
    } else if (c == -1 || c == 1) {
      et.delta_nb[s] = (table_log << 16) - table_size;
      et.delta_fs[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = table_log - highbit(c - 1);
      int min_state_plus = c << max_bits_out;
      et.delta_nb[s] = (max_bits_out << 16) - min_state_plus;
      et.delta_fs[s] = total - c;
      total += c;
    }
  }
  return true;
}

int fse_init_state(const FseEnc& et, int sym) {
  int nb = (et.delta_nb[sym] + (1 << 15)) >> 16;
  int v = (nb << 16) - et.delta_nb[sym];
  return et.state_table[(v >> nb) + et.delta_fs[sym]];
}

void write_ncount(const int32_t* norm, int n, int table_log, BitWriter& bw) {
  bw.add(table_log - 5, 4);
  int remaining = (1 << table_log) + 1;
  int i = 0;
  while (remaining > 1 && i < n) {
    int c = norm[i++];
    int threshold = 1 << highbit(remaining);
    int nb = highbit(remaining) + 1;
    int mx = (1 << nb) - 1 - remaining;
    int value = c + 1;
    if (value >= threshold) value += mx;
    bw.add(value, value < mx ? nb - 1 : nb);
    remaining -= c == -1 ? 1 : (c < 0 ? -c : c);
    if (c == 0) {
      int zeros = 0;
      while (i + zeros < n && norm[i + zeros] == 0) zeros++;
      while (zeros >= 3) {
        bw.add(3, 2);
        zeros -= 3;
        i += 3;
      }
      bw.add(zeros, 2);
      i += zeros;
    }
  }
}

// FSE-compressed huffman weights (2 interleaved states, encoded backward)
bool write_weights_fse(const uint8_t* weights, int n,
                       std::vector<uint8_t>& out) {
  if (n < 2) return false;
  uint32_t counts[16] = {0};
  int max_sym = 0;
  for (int i = 0; i < n; ++i) {
    counts[weights[i]]++;
    max_sym = std::max(max_sym, (int)weights[i]);
  }
  int nz = 0;
  for (int v = 0; v <= max_sym; ++v) nz += counts[v] != 0;
  if (nz < 2) return false;
  int table_log = std::min(6, std::max(1, highbit((uint32_t)std::max(2, n)) +
                                              ((n & (n - 1)) ? 1 : 0)));
  int32_t norm[16];
  if (!normalize_counts(counts, max_sym + 1, table_log, n, norm)) return false;
  FseEnc et;
  if (!build_fse_enc(norm, max_sym + 1, table_log, et)) return false;
  BitWriter desc;
  write_ncount(norm, max_sym + 1, table_log, desc);
  desc.flush_partial();
  BitWriter bw;
  // symbol k decodes from state1 iff k is even; encoding runs backward from
  // k = n-3, so the state inits and starting turn depend on n's parity
  int s1, s2, turn;
  if (n % 2) {
    s1 = fse_init_state(et, weights[n - 1]);
    s2 = fse_init_state(et, weights[n - 2]);
    turn = 0;
  } else {
    s2 = fse_init_state(et, weights[n - 1]);
    s1 = fse_init_state(et, weights[n - 2]);
    turn = 1;
  }
  for (int i = n - 3; i >= 0; --i) {
    int sym = weights[i];
    int& st = turn == 0 ? s1 : s2;
    int nb = (st + et.delta_nb[sym]) >> 16;
    bw.add(st & ((1 << nb) - 1), nb);
    st = et.state_table[(st >> nb) + et.delta_fs[sym]];
    turn ^= 1;
  }
  int ts = 1 << table_log;
  bw.add(s2 >= ts ? s2 - ts : s2, table_log);
  bw.add(s1 >= ts ? s1 - ts : s1, table_log);
  bw.close_with_sentinel();
  size_t total = desc.out.size() + bw.out.size();
  if (total >= 128) return false;
  out.clear();
  out.push_back((uint8_t)total);
  out.insert(out.end(), desc.out.begin(), desc.out.end());
  out.insert(out.end(), bw.out.begin(), bw.out.end());
  return true;
}

}  // namespace

extern "C" {

// Build the zstd literal Huffman table for one histogram.
//   hist: uint32[256]; lengths, codes: int32[256] out (0 = unused,
//   canonical values); tree: uint8[200] out, the serialized description;
//   tree_len: out.
// Returns max_bits (> 0), 0 if the table is degenerate (< 2 symbols), -1
// if the description cannot be serialized.
int zn_huf_build(const uint32_t* hist, int32_t* lengths, int32_t* codes,
                 uint8_t* tree, int32_t* tree_len) {
  package_merge(hist, 256, 11, lengths);
  int n_used = 0, last = -1;
  for (int s = 0; s < 256; ++s)
    if (lengths[s] > 0) {
      n_used++;
      last = s;
    }
  if (n_used < 2) return 0;
  int max_bits = 0;
  canonical_codes(lengths, codes, &max_bits);
  // weights: maxBits + 1 - length, last symbol implied
  std::vector<uint8_t> weights(last);
  for (int s = 0; s < last; ++s)
    weights[s] = lengths[s] > 0 ? (uint8_t)(max_bits + 1 - lengths[s]) : 0;
  std::vector<uint8_t> fsec;
  bool have_fse = write_weights_fse(weights.data(), (int)weights.size(), fsec);
  // direct: header 127+num, 4-bit nibbles
  std::vector<uint8_t> direct;
  if ((int)weights.size() <= 127) {
    direct.push_back((uint8_t)(127 + weights.size()));
    for (size_t i = 0; i < weights.size(); i += 2) {
      uint8_t hi = weights[i] << 4;
      uint8_t lo = i + 1 < weights.size() ? weights[i + 1] : 0;
      direct.push_back(hi | lo);
    }
  }
  const std::vector<uint8_t>* best = nullptr;
  if (have_fse && (!direct.size() || fsec.size() < direct.size()))
    best = &fsec;
  else if (direct.size())
    best = &direct;
  if (!best) return -1;
  if (best->size() > 200) return -1;
  std::memcpy(tree, best->data(), best->size());
  *tree_len = (int32_t)best->size();
  return max_bits;
}

// Batched variant: nh histograms in a row-major (nh, 256) array.
// outputs: lengths/codes (nh, 256), trees (nh, 200), tree_lens (nh),
// max_bits (nh).  The hash-parser path's per-block literal tables.
void zn_huf_build_batch(const uint32_t* hists, int nh, int32_t* lengths,
                        int32_t* codes, uint8_t* trees, int32_t* tree_lens,
                        int32_t* max_bits) {
  for (int i = 0; i < nh; ++i) {
    max_bits[i] = zn_huf_build(hists + 256 * i, lengths + 256 * i,
                               codes + 256 * i, trees + 200 * i,
                               tree_lens + i);
  }
}

// The hash parser's gate entropy per row of nh (nh, 256) int32 byte
// histograms: H = -sum p log2 p over p = count / max(total, 1), clipped to
// [1, 8], in XLA's order of operations: log2 as log times 1.44269502f,
// the 256 terms summed as eight sequential windows of 32, and the window
// sums summed in order.
void zn_gate_entropy(const int32_t* hists, int nh, float* out) {
  const float LOG2E = 0x1.715476p+0f, TINY = 0x1.12e0bep-30f;  // 1e-9f
  for (int i = 0; i < nh; ++i) {
    const int32_t* h = hists + 256 * i;
    int32_t total = 0;
    for (int s = 0; s < 256; ++s) total += h[s];
    float denom = std::max((float)total, 1.0f);
    float acc = 0.0f;
    for (int w = 0; w < 8; ++w) {
      float win = 0.0f;
      for (int s = 32 * w; s < 32 * w + 32; ++s) {
        float p = (float)h[s] / denom;
        float term = 0.0f;
        if (p > 0.0f) term = p * (xla_logf(std::max(p, TINY)) * LOG2E);
        win = win + term;
      }
      acc = acc + win;
    }
    out[i] = std::min(std::max(-acc, 1.0f), 8.0f);
  }
}

// Serialize tree descriptions from device-built weight tables (the
// Huffman tables themselves are constructed on the GPU by
// ops/huffman_plan.py; only the header bytes are host work).
//   weights: (nh, 256) uint8, zstd convention (0 = unused,
//            maxBits + 1 - length otherwise; Kraft-exact by construction)
//   trees: (nh, 200) uint8 out; tree_lens: (nh,) out (0 = unserializable,
//          caller stores the block raw)
void zn_huf_tree_batch(const uint8_t* weights, int nh, uint8_t* trees,
                       int32_t* tree_lens) {
  for (int i = 0; i < nh; ++i) {
    const uint8_t* w = weights + 256 * i;
    uint8_t* tree = trees + 200 * i;
    tree_lens[i] = 0;
    int last = -1;
    for (int s = 0; s < 256; ++s)
      if (w[s] > 0) last = s;
    if (last < 1) continue;  // < 2 used symbols: no huffman section
    // serialized weights exclude the last used symbol (implied)
    std::vector<uint8_t> fsec;
    bool have_fse = write_weights_fse(w, last, fsec);
    std::vector<uint8_t> direct;
    if (last <= 127) {
      direct.push_back((uint8_t)(127 + last));
      for (int s = 0; s < last; s += 2) {
        uint8_t hi = (uint8_t)(w[s] << 4);
        uint8_t lo = s + 1 < last ? w[s + 1] : 0;
        direct.push_back(hi | lo);
      }
    }
    const std::vector<uint8_t>* best = nullptr;
    if (have_fse && (!direct.size() || fsec.size() < direct.size()))
      best = &fsec;
    else if (direct.size())
      best = &direct;
    if (!best || best->size() > 200) continue;
    std::memcpy(tree, best->data(), best->size());
    tree_lens[i] = (int32_t)best->size();
  }
}

// ---------------------------------------------------------------------------
// zstd seekable seek table (the reference library's seek_table.c layout)
// ---------------------------------------------------------------------------

// Serialize: entries (n, 2) uint32 row-major (c_size, d_size) -> out buffer.
// Returns bytes written.  out must hold 8 + 8n + 9 bytes (no checksums).
int64_t zn_seektable_serialize(const uint32_t* entries, int64_t n,
                               uint8_t* out) {
  uint8_t* p = out;
  uint32_t magic = 0x184D2A5E;
  uint32_t frame_size = (uint32_t)(n * 8 + 9);
  std::memcpy(p, &magic, 4);
  p += 4;
  std::memcpy(p, &frame_size, 4);
  p += 4;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, entries + 2 * i, 8);
    p += 8;
  }
  uint32_t nf = (uint32_t)n;
  std::memcpy(p, &nf, 4);
  p += 4;
  *p++ = 0;  // seek-table descriptor: no checksums
  uint32_t foot = 0x8F92EAB1;
  std::memcpy(p, &foot, 4);
  p += 4;
  return p - out;
}

// Parse: buf = last (9 + 8n [+4n]) bytes ending at the footer.  Fills
// cum (n+1, 2) int64 cumulative (c_off, d_off) pairs.  Returns n or -1.
int64_t zn_seektable_parse(const uint8_t* table_frame, int64_t frame_bytes,
                           int64_t* cum) {
  if (frame_bytes < 17) return -1;
  const uint8_t* foot = table_frame + frame_bytes - 9;
  uint32_t magic;
  std::memcpy(&magic, foot + 5, 4);
  if (magic != 0x8F92EAB1) return -1;
  uint32_t nf;
  std::memcpy(&nf, foot, 4);
  uint8_t desc = foot[4];
  if (desc & 0x7C) return -1;  // reserved bits
  int entry = (desc & 0x80) ? 12 : 8;
  if (frame_bytes < 8 + (int64_t)entry * nf + 9) return -1;
  const uint8_t* e = table_frame + 8;
  int64_t c = 0, d = 0;
  for (uint32_t i = 0; i < nf; ++i) {
    cum[2 * i] = c;
    cum[2 * i + 1] = d;
    uint32_t cs, ds;
    std::memcpy(&cs, e, 4);
    std::memcpy(&ds, e + 4, 4);
    e += entry;
    c += cs;
    d += ds;
  }
  cum[2 * nf] = c;
  cum[2 * nf + 1] = d;
  return nf;
}

// XXH64 (zstd seekable per-frame checksum = low 32 bits over the
// uncompressed frame; also zstd's optional content checksum)
uint64_t zn_xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                 P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                 P5 = 0x27D4EB2F165667C5ULL;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t lane) {
    return rotl(acc + lane * P2, 31) * P1;
  };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* lim = end - 32;
    do {
      v1 = round(v1, rd64(p));
      v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16));
      v4 = round(v4, rd64(p + 24));
      p += 32;
    } while (p <= lim);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = (h ^ round(0, v1)) * P1 + P4;
    h = (h ^ round(0, v2)) * P1 + P4;
    h = (h ^ round(0, v3)) * P1 + P4;
    h = (h ^ round(0, v4)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h = rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h = rotl(h ^ ((uint64_t)v * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ ((uint64_t)*p * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// LZ4 block decode into a frame buffer (linked-block window: matches may
// reach back to byte `lo` of `out`, i.e. the frame start for linked
// frames or the block start for independent ones).  LZ4 has no entropy
// stage: decode is token-driven memcpy of bytes the host already holds.
// Returns the decompressed size or -1 on corrupt input.
int64_t zn_lz4_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t out_cap, int64_t base, int64_t lo) {
  int64_t ip = 0, op = base;
  while (ip < n) {
    uint8_t tok = src[ip++];
    int64_t ll = tok >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ll += b;
      } while (b == 255);
    }
    if (ip + ll > n || op + ll > out_cap) return -1;
    std::memcpy(out + op, src + ip, (size_t)ll);
    ip += ll;
    op += ll;
    if (ip >= n) break;  // final literal run
    if (ip + 2 > n) return -1;
    int64_t off = src[ip] | ((int64_t)src[ip + 1] << 8);
    ip += 2;
    if (off < 1 || off > op - lo) return -1;
    int64_t ml = (tok & 15) + 4;
    if ((tok & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    if (op + ml > out_cap) return -1;
    int64_t seed = off < ml ? off : ml;
    std::memcpy(out + op, out + op - off, (size_t)seed);
    int64_t c = seed;
    while (c < ml) {
      int64_t k = c < ml - c ? c : ml - c;
      std::memcpy(out + op + c, out + op, (size_t)k);
      c += k;
    }
    op += ml;
  }
  return op - base;
}

// ---------------------------------------------------------------------------
// Long-distance match scan (the zstd --long / LDM analog).  The linked
// device parse (K1) sees only [previous block | block] (256 KiB); this host pass
// finds WHOLE-BLOCK matches at larger distances within a batch: rolling
// 32-byte window hashes at stride 8 feed a last-occurrence table, then
// per-block candidate distances are verified with exact memcmp — a hit
// means block b is byte-identical to the bytes `dist` before it.
// Covered blocks compress to a single long-match sequence and skip the
// device parse entirely.  x = the batch's blocks concatenated at bsize
// stride; frame_base[b] = byte offset of b's frame start (-1 = exclude).
// Returns the number of covered blocks.
int64_t zn_ldm_scan(const uint8_t* x, int64_t nblocks, int64_t bsize,
                    const int64_t* frame_base, const int32_t* lens,
                    int64_t min_dist, int64_t* out_dist) {
  const int LOG = 20;
  const uint64_t MUL = 0x9E3779B185EBCA87ull;
  std::vector<int64_t> table((size_t)1 << LOG, -1);
  // second, always-overwrite table: surfaces SMALL distances (below
  // min_dist) for whole-block coverage of short-period content.  The
  // device parse would find those matches itself, but each one costs a
  // ~block-length scalar extend on the core; covering the block here
  // (and skipping its parse) emits the identical single sequence free.
  std::vector<int64_t> table2((size_t)1 << LOG, -1);
  const int CAND = 4;
  std::vector<int64_t> cand((size_t)nblocks * CAND, 0);
  std::vector<int64_t> cand2((size_t)nblocks, 0);
  // rolling polynomial hash over a 32-byte window; CONTENT-DEFINED
  // anchors (hash-selected 1-in-64 positions) so repeated content anchors
  // at the same content offsets regardless of block alignment — a fixed
  // sampling stride could only ever find distances divisible by it
  const uint64_t C = 6364136223846793005ull;
  uint64_t C32 = 1;
  for (int i = 0; i < 32; ++i) C32 *= C;
  for (int64_t b = 0; b < nblocks; ++b) {
    out_dist[b] = 0;
    int64_t base = b * bsize;
    int64_t len = lens[b];
    if (len < 32) continue;
    uint64_t h = 0;
    for (int k = 0; k < 32; ++k) h = h * C + x[base + k];
    for (int64_t off = 0; off + 32 <= len; ++off) {
      int64_t p = base + off;
      uint64_t mixed = h * MUL;
      if ((mixed >> 58) == 0) {  // anchor (rate 1/64)
        size_t bucket = (size_t)(mixed >> 30) & (((size_t)1 << LOG) - 1);
        int64_t c = table[bucket];
        // age-gated overwrite: keep an entry until it is >= min_dist old,
        // otherwise content with a repeat period below min_dist keeps
        // refreshing the bucket and multi-period distances (the ones the
        // block parse cannot see) never surface
        if (c < 0 || p - c >= min_dist) table[bucket] = p;
        int64_t c2 = table2[bucket];
        table2[bucket] = p;
        if (c2 >= 0 && frame_base[b] >= 0 && cand2[b] == 0) {
          int64_t d2 = p - c2;
          if (d2 >= 1 && d2 < min_dist && c2 >= frame_base[b])
            cand2[b] = d2;
        }
        if (c >= 0 && frame_base[b] >= 0) {
          int64_t d = p - c;
          if (d >= min_dist && d <= ((int64_t)1 << 28) - 1 &&
              c >= frame_base[b]) {
            for (int k = 0; k < CAND; ++k) {
              if (cand[b * CAND + k] == d) break;
              if (cand[b * CAND + k] == 0) {
                cand[b * CAND + k] = d;
                break;
              }
            }
          }
        }
      }
      if (off + 33 <= len) h = h * C + x[p + 32] - C32 * x[p];
    }
  }
  // verify: out_dist is (nblocks, 3) rows [dist, span_start, span_end).
  // Full-block hits get [d, 0, bsize); otherwise the longest contiguous
  // matching run at distance d is accepted when it covers >= 1/4 of the
  // block (partial coverage: the boundary blocks of unaligned repeat
  // periods), with the head/tail bytes left as literals.
  int64_t hits = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    out_dist[3 * b] = 0;
    out_dist[3 * b + 1] = 0;
    out_dist[3 * b + 2] = 0;
    if (frame_base[b] < 0) continue;
    int64_t base = b * bsize;
    int64_t blen = lens[b];
    int64_t best_len = bsize / 4, best_d = 0, best_s = 0, best_e = 0;
    // small-distance whole-block coverage (short-period content): the
    // parse would emit the same single sequence, at ~block-length scalar
    // extend cost on the device.  Also applies to a frame's shorter
    // FINAL block (lens < bsize), which the distance-gated path below
    // never covers.
    if (cand2[b] > 0 && blen >= 512) {
      int64_t d = cand2[b];
      int64_t lo = frame_base[b] + d - base;
      if (lo <= 0 && std::memcmp(x + base, x + base - d, 256) == 0 &&
          std::memcmp(x + base, x + base - d, (size_t)blen) == 0) {
        out_dist[3 * b] = d;
        out_dist[3 * b + 1] = 0;
        out_dist[3 * b + 2] = blen;
        ++hits;
        continue;
      }
    }
    if (blen != bsize) continue;
    for (int k = 0; k < CAND && cand[b * CAND + k]; ++k) {
      int64_t d = cand[b * CAND + k];
      int64_t lo = frame_base[b] + d - base;  // first in-frame src posn
      if (lo < 0) lo = 0;
      if (lo >= bsize) continue;
      if (lo == 0 && std::memcmp(x + base, x + base - d, 256) == 0 &&
          std::memcmp(x + base, x + base - d, (size_t)bsize) == 0) {
        best_d = d;
        best_s = 0;
        best_e = bsize;
        break;
      }
      // PARTIAL spans only for distances beyond the block parse's whole
      // window (prev block + current = 2*bsize): closer matches are
      // found fine-grained by the parse itself, and replacing its output
      // with span-head/tail literals would LOSE ratio
      if (d < 2 * bsize) continue;
      // longest matching run [s, e) at distance d
      int64_t run = 0;
      for (int64_t i = lo; i < bsize; ++i) {
        if (x[base + i] == x[base + i - d]) {
          ++run;
          if (run > best_len) {
            best_len = run;
            best_d = d;
            best_s = i + 1 - run;
            best_e = i + 1;
          }
        } else {
          run = 0;
        }
      }
    }
    if (best_d) {
      out_dist[3 * b] = best_d;
      out_dist[3 * b + 1] = best_s;
      out_dist[3 * b + 2] = best_e;
      ++hits;
    }
  }
  return hits;
}

// ---------------------------------------------------------------------------
// Transcoded block execution (copy of libzseek_tpu/native/zn.cc
// zn_zir_execute :574): expand the literal bytes and packed sequence
// tokens of K4's transcode arm (ops/decode.py transcode_blocks) into the
// block's decompressed bytes.  The card does the entropy half (FSE, and
// Huffman unless the literals decode here); this is the memory-speed LZ
// copy half.
//
// Token packing (2 uint32 words per sequence):
//   w0 = ll | (ml_lo14 << 18)      w1 = off | (ml_hi4 << 28)
//
// out is the whole frame buffer (match offsets may reach back into earlier
// blocks); base = this block's offset within the frame.  Returns the
// block's decompressed size, or -1 on any bounds violation.
int64_t zn_zir_execute(const uint8_t* lits, int64_t lit_n,
                       const uint32_t* toks, int64_t n_seq,
                       uint8_t* out, int64_t out_cap, int64_t base) {
  int64_t op = base, lp = 0;
  for (int64_t i = 0; i < n_seq; ++i) {
    uint32_t w0 = toks[2 * i], w1 = toks[2 * i + 1];
    int64_t ll = w0 & 0x3FFFF;
    int64_t ml = ((w0 >> 18) & 0x3FFF) | ((int64_t)(w1 >> 28) << 14);
    int64_t off = w1 & 0x0FFFFFFF;
    if (lp + ll > lit_n || op + ll + ml > out_cap) return -1;
    std::memcpy(out + op, lits + lp, (size_t)ll);
    op += ll;
    lp += ll;
    if (off < 1 || off > op) return -1;
    uint8_t* d = out + op;
    // overlap-safe periodic copy: seed one period (non-overlapping since
    // src + off == d), then double the valid region
    int64_t seed = off < ml ? off : ml;
    std::memcpy(d, d - off, (size_t)seed);
    int64_t copied = seed;
    while (copied < ml) {
      int64_t c = copied < ml - copied ? copied : ml - copied;
      std::memcpy(d + copied, d, (size_t)c);
      copied += c;
    }
    op += ml;
  }
  int64_t trail = lit_n - lp;
  if (trail < 0 || op + trail > out_cap) return -1;
  std::memcpy(out + op, lits + lp, (size_t)trail);
  op += trail;
  return op - base;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host Huffman literal decode (copy of libzseek_tpu/native/zn.cc
// zn_huf_decode_batch :897 and its helpers :824-895): the transcode
// route ships no literal stream to the card; the host expands them.

namespace {

struct HufBitRead {
  const uint8_t* start;
  const uint8_t* ptr;
  uint64_t container;
  unsigned consumed;
  unsigned end;   // consumed at the stream's first bit once ptr == start
};

int huf_br_init(HufBitRead* br, const uint8_t* src, int64_t n) {
  if (n < 1 || src[n - 1] == 0) return -1;
  br->start = src;
  if (n >= 8) {
    br->ptr = src + n - 8;
    uint64_t c = 0;
    std::memcpy(&c, br->ptr, 8);
    br->container = c;
    br->end = 64;
  } else {
    br->ptr = src;
    uint64_t c = 0;
    std::memcpy(&c, src, (size_t)n);
    br->container = c << (8 * (8 - n));   // last byte lands on top
    br->end = (unsigned)(8 * n);
  }
  br->consumed = 8 - highbit(src[n - 1]);  // padding + sentinel
  return 0;
}

// bits not yet consumed (negative once a symbol read past the start)
inline int64_t huf_br_left(const HufBitRead* br) {
  return (int64_t)br->end - br->consumed + 8 * (br->ptr - br->start);
}

inline uint32_t huf_br_peek(const HufBitRead* br, unsigned nbits) {
  return (uint32_t)((br->container << br->consumed) >> (64 - nbits));
}

inline void huf_br_reload(HufBitRead* br) {
  while (br->consumed >= 8 && br->ptr > br->start) {
    br->ptr--;
    br->container = (br->container << 8) | br->ptr[0];
    br->consumed -= 8;
  }
}

int huf_dtable_from_weights(const int32_t* w, int32_t* dt, int* tl_out) {
  uint32_t total = 0;
  int32_t lengths[256];
  int32_t codes[256];
  for (int s2 = 0; s2 < 256; ++s2)
    if (w[s2] > 0) total += 1u << (w[s2] - 1);
  if (!total || (total & (total - 1))) return -1;
  int tl = highbit(total);
  if (tl < 1 || tl > 12) return -1;
  for (int s2 = 0; s2 < 256; ++s2)
    lengths[s2] = w[s2] > 0 ? tl + 1 - w[s2] : 0;
  int max_used = 0;
  canonical_codes(lengths, codes, &max_used);
  std::fill(dt, dt + (1 << tl), 0);
  for (int s2 = 0; s2 < 256; ++s2) {
    int l = lengths[s2];
    if (l > 0) {
      int64_t start2 = (int64_t)codes[s2] << (tl - l);
      int64_t span = (int64_t)1 << (tl - l);
      int32_t e = (l << 8) | s2;
      for (int64_t k = 0; k < span; ++k) dt[start2 + k] = e;
    }
  }
  *tl_out = tl;
  return tl;
}

}  // namespace

extern "C" {

// lane_meta: 4 int64 per lane = (stream offset, stream bytes, n_out,
// table id); weights: (ntabs, 256) int32 zstd weights (implied-last
// resolved); out_off: per-lane output byte offsets.  Returns decoded
// lanes, or a negative lane index - 1 on the first malformed lane.
//
// Repaired against the original (ADVICE.md r5): it peeked with
// `consumed` at 64 (a shift by the type's width, undefined) before its
// "ran dry" check, and it decoded a table entry of code length 0 (the
// table of a single-symbol weight set) without consuming a bit.  Here
// the bits left are checked before every peek (so `consumed` < 64 when
// it shifts), an entry of length 0 rejects the lane, and a lane must end
// on its stream's first bit, as libzstd's end-of-stream check demands
// (the fused route's K4 holds every stream to exact consumption too).
int64_t zn_huf_decode_batch(const uint8_t* streams,
                            const int64_t* lane_meta, int64_t nlanes,
                            const int32_t* weights, int64_t ntabs,
                            uint8_t* out, const int64_t* out_off) {
  std::vector<int32_t> dts((size_t)ntabs << 12);
  std::vector<int> tls((size_t)ntabs, -2);
  for (int64_t ln = 0; ln < nlanes; ++ln) {
    const int64_t off = lane_meta[4 * ln];
    const int64_t nbytes = lane_meta[4 * ln + 1];
    const int64_t n_out = lane_meta[4 * ln + 2];
    const int64_t tid = lane_meta[4 * ln + 3];
    if (tid < 0 || tid >= ntabs) return -ln - 1;
    if (tls[tid] == -2) {
      int tl = 0;
      if (huf_dtable_from_weights(weights + 256 * tid,
                                  dts.data() + ((size_t)tid << 12),
                                  &tl) < 0) {
        tls[tid] = -1;
      } else {
        tls[tid] = tl;
      }
    }
    const int tl = tls[tid];
    if (tl < 0) return -ln - 1;
    const int32_t* dt = dts.data() + ((size_t)tid << 12);
    HufBitRead br;
    if (huf_br_init(&br, streams + off, nbytes) < 0) return -ln - 1;
    uint8_t* o = out + out_off[ln];
    for (int64_t i = 0; i < n_out; ++i) {
      huf_br_reload(&br);
      if (huf_br_left(&br) <= 0) return -ln - 1;  // ran dry
      const int32_t e = dt[huf_br_peek(&br, (unsigned)tl)];
      if ((e >> 8) == 0) return -ln - 1;          // code length 0
      o[i] = (uint8_t)(e & 0xFF);
      br.consumed += (unsigned)(e >> 8);
    }
    if (huf_br_left(&br) != 0) return -ln - 1;    // not consumed exactly
  }
  return nlanes;
}

}  // extern "C"
