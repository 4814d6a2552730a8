// Native host-side I/O runtime: FASTQ -> fixed-shape device batch encoder.
//
// The TPU engine consumes (B, L) uint8 base-code arrays plus per-read k-mer
// counts and per-kmer-index quality bytes (see io/fastq.py). Python-level
// parsing tops out well below device throughput, so this C++ path does the
// byte scanning and 2-bit encoding; Python keeps orchestration. The
// counterpart of the reference's fgets loop (src/qv.cc:760-763), built for
// batch feeding instead of one-read-at-a-time.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// base -> code table: A/a=0 C/c=1 G/g=2 T/t=3 N/n=4 other=7
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    std::memset(t, 7, sizeof(t));
    t[(unsigned)'A'] = 0; t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = 1; t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = 2; t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = 3; t[(unsigned)'t'] = 3;
    t[(unsigned)'N'] = 4; t[(unsigned)'n'] = 4;
  }
};
const CodeTable kCodes;

inline const char* find_nl(const char* p, const char* end) {
  const void* nl = std::memchr(p, '\n', end - p);
  return nl ? static_cast<const char*>(nl) : end;
}

}  // namespace

extern "C" {

// Parse up to `batch` COMPLETE FASTQ records from buf[*cursor:len].
// Outputs (caller-allocated):
//   codes:   batch*L uint8, prefilled is NOT required (fully written)
//   n_kmers: batch int32
//   qual:    batch*K uint8
// Returns number of reads parsed; advances *cursor past them. A record
// whose four lines are not all newline-terminated inside the buffer is
// NOT consumed (cursor stays at its '@' line), so callers can stream the
// file in bounded windows and carry the incomplete tail into the next
// window (native.fastq_batches).
// max_slen (in/out): running maximum raw sequence length seen, so callers
// can detect reads longer than the configured L (silent truncation would
// diverge from the reference, which handles reads up to 1023 bases --
// BUF_SIZE at src/qv.cc:700).
// qlen_mismatch (in/out): count of records whose quality-line length
// differs from the sequence length (spec violation; quality is indexed by
// k-mer slot, qv.cc:836, so a short line silently mis-gates the neighbor
// search -- callers surface a warning). A trailing '\r' is stripped from
// sequence and quality lines, so CRLF FASTQs parse identically to LF ones
// (the reference would silently drop every read of a CRLF file as
// containing a non-ACGT base).
int64_t vgt_fastq_batch(const char* buf, int64_t len, int64_t* cursor,
                        int64_t batch, int64_t L, int64_t K,
                        uint8_t* codes, int32_t* n_kmers, uint8_t* qual,
                        int64_t* max_slen, int64_t* qlen_mismatch) {
  const char* p = buf + *cursor;
  const char* end = buf + len;
  int64_t filled = 0;
  while (filled < batch && p < end) {
    const char* rec = p;
    // @id line
    const char* nl = find_nl(p, end);
    if (nl == end) break;
    p = nl + 1;
    // sequence line
    const char* seq = p;
    nl = find_nl(p, end);
    int64_t slen = nl - seq;
    if (nl == end) { p = rec; break; }
    if (slen > 0 && seq[slen - 1] == '\r') --slen;
    p = nl + 1;
    // + line
    nl = find_nl(p, end);
    if (nl == end) { p = rec; break; }
    p = nl + 1;
    // quality line
    const char* q = p;
    nl = find_nl(p, end);
    int64_t qlen = nl - q;
    if (nl == end) { p = rec; break; }
    if (qlen > 0 && q[qlen - 1] == '\r') --qlen;
    p = nl + 1;

    if (qlen != slen) ++*qlen_mismatch;
    if (slen > *max_slen) *max_slen = slen;
    uint8_t* crow = codes + filled * L;
    int64_t ln = slen < L ? slen : L;
    for (int64_t i = 0; i < ln; ++i)
      crow[i] = kCodes.t[(unsigned char)seq[i]];
    if (ln < L) std::memset(crow + ln, 4, L - ln);
    int64_t k = ln / 32;
    if (k > K) k = K;
    n_kmers[filled] = (int32_t)k;
    uint8_t* qrow = qual + filled * K;
    int64_t nq = qlen < K ? qlen : K;
    for (int64_t i = 0; i < nq; ++i) qrow[i] = (uint8_t)q[i];
    if (nq < K) std::memset(qrow + nq, 0, K - nq);
    ++filled;
  }
  *cursor = p - buf;
  return filled;
}

// Batch k-mer pre-encoder: (B, L) uint8 base codes -> per-slot kmer words
// (hi, lo) plus validity, exactly mirroring the device-side encode
// (engine/batch.py encode_batch; reference semantics src/qv.cc:810-828:
// a non-ACGT base anywhere in the read's in-use windows drops the whole
// read in that orientation). Shipping the packed words instead of raw
// codes cuts per-batch host->device transfer ~3.6x, which matters on a
// tunneled/high-latency dispatch link.
void vgt_encode_batch(const uint8_t* codes, const int32_t* n_kmers,
                      int64_t B, int64_t L, int64_t K,
                      uint32_t* hi, uint32_t* lo, uint8_t* kvalid,
                      uint8_t* read_ok) {
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* row = codes + b * L;
    int nk = n_kmers[b];
    if (nk > K) nk = (int)K;
    int ok = 1;
    for (int64_t k = 0; k < K; ++k) {
      const uint8_t* w = row + k * 32;
      uint32_t l = 0, h = 0;
      int bad = 0;
      for (int i = 0; i < 16; ++i) {
        uint8_t c = w[i];
        bad |= (c > 3);
        l |= (uint32_t)(c > 3 ? 0 : c) << (2 * i);
      }
      for (int i = 0; i < 16; ++i) {
        uint8_t c = w[16 + i];
        bad |= (c > 3);
        h |= (uint32_t)(c > 3 ? 0 : c) << (2 * i);
      }
      hi[b * K + k] = h;
      lo[b * K + k] = l;
      if (bad && k < nk) ok = 0;
      kvalid[b * K + k] = (k < nk);
    }
    read_ok[b] = (uint8_t)ok;
    if (!ok)
      for (int64_t k = 0; k < K; ++k) kvalid[b * K + k] = 0;
  }
}

// Reverse-complement retry compaction: gather the selected reads, reverse-
// complement their in-use bases (reference semantics src/qv.cc:787-806:
// length = n_kmers*32; the quality string is NOT reversed), pad the tail
// with 4. Replaces a chain of numpy mask/gather/where ops that cost
// ~20 ms/batch on the host dispatch loop's critical path.
void vgt_revcomp_select(const uint8_t* codes, const int32_t* n_kmers,
                        const uint8_t* qual, int64_t L, int64_t K,
                        const int32_t* sel, int64_t n_sel,
                        uint8_t* out_codes, int32_t* out_nk,
                        uint8_t* out_qual) {
  for (int64_t s = 0; s < n_sel; ++s) {
    int64_t b = sel[s];
    const uint8_t* row = codes + b * L;
    uint8_t* orow = out_codes + s * L;
    int64_t len = (int64_t)n_kmers[b] * 32;
    if (len > L) len = L;
    for (int64_t i = 0; i < len; ++i) {
      uint8_t c = row[len - 1 - i];
      orow[i] = c < 4 ? (uint8_t)(3 - c) : c;
    }
    if (len < L) std::memset(orow + len, 4, L - len);
    out_nk[s] = n_kmers[b];
    std::memcpy(out_qual + s * K, qual + b * K, K);
  }
}

// Rolling 32-mer extraction for index build: writes one uint64 per window
// and a validity byte (window free of non-ACGT). codes: n uint8.
// Returns number of windows (n-31) or 0.
int64_t vgt_rolling_kmers(const uint8_t* codes, int64_t n,
                          uint64_t* kmers, uint8_t* valid) {
  if (n < 32) return 0;
  int64_t nw = n - 31;
  uint64_t k = 0;
  int bad = 0;  // count of invalid bases in current window
  for (int64_t i = 0; i < 31; ++i) {
    uint8_t c = codes[i];
    if (c > 3) { bad++; c = 0; }
    k |= (uint64_t)(c & 3) << (2 * i);
  }
  // window w covers [w, w+31]
  for (int64_t w = 0; w < nw; ++w) {
    uint8_t c = codes[w + 31];
    int in_bad = (c > 3);
    bad += in_bad;
    k |= (uint64_t)(c & 3) << 62;
    kmers[w] = k;
    valid[w] = (bad == 0);
    // slide: drop base w
    uint8_t drop_bad = (codes[w] > 3);
    bad -= drop_bad;
    k >>= 2;
  }
  return nw;
}

// Set bits in an LSB-first uint64 bitmap. numpy's bitwise_or.at tops out
// around ~10M updates/s; this runs at memory speed, which matters when
// inserting ~3G whole-genome k-mers into the 9.6 Gbit reference filter.
void vgt_bf_set_bits(uint64_t* words, const uint64_t* bit_idx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = bit_idx[i];
    words[b >> 6] |= (uint64_t)1 << (b & 63);
  }
}

// Test bits (1 byte out per index).
void vgt_bf_test_bits(const uint64_t* words, const uint64_t* bit_idx,
                      int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = bit_idx[i];
    out[i] = (words[b >> 6] >> (b & 63)) & 1;
  }
}

// Reduce precomputed 64-bit hash values modulo the filter size and set the
// bits, in one pass (numpy's u64 modulo is a scalar fallback; this is the
// index build's hot loop at whole-genome scale).
void vgt_bf_mod_set(uint64_t* words, const uint64_t* hashes, int64_t n,
                    uint64_t mod) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = hashes[i] % mod;
    words[b >> 6] |= (uint64_t)1 << (b & 63);
  }
}

// Bucketized hash-table build (layout of engine/hashtable.py): sequential
// insertion with linear probing over `slots`-wide buckets; one contiguous
// (nb, slots*4) uint32 row per bucket. Returns the lookup chain bound
// (max displacement + 1). `table` must be zeroed, `cap` a zeroed (nb,)
// uint8 scratch. Replaces the numpy round-based placement (80 s at 48M
// keys) with a single pass at memory speed.
static inline uint32_t vgt_hash32(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  return (x >> 16) ^ x;
}

int64_t vgt_ht_build(const uint32_t* hi, const uint32_t* lo,
                     const uint32_t* pos, const uint8_t* flag,
                     const uint8_t* info, int64_t n, int64_t nb,
                     int64_t slots, uint32_t* table, uint8_t* cap) {
  uint64_t maxd = 0;
  const uint32_t kMix = 0x9E3779B9u;
  const uint32_t mask = (uint32_t)(nb - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = vgt_hash32(lo[i]) ^ (vgt_hash32(hi[i]) * kMix);
    int64_t b = (int64_t)(h & mask);
    uint64_t d = 0;
    while (cap[b] >= slots) { b = (b + 1) & mask; ++d; }
    int64_t col = cap[b]++;
    // FIELD-BLOCKED row: [hi x slots | lo x slots | pos x slots |
    // meta x slots] -- field extraction on device is a contiguous lane
    // slice of the gathered row instead of a strided (slots, 4) reshape,
    // which XLA lowered as a whole-result relayout copy per lookup
    uint32_t* row = table + b * slots * 4;
    row[col] = hi[i];
    row[slots + col] = lo[i];
    row[2 * slots + col] = pos[i];
    uint32_t meta = 0x80000000u | (uint32_t)flag[i];
    if (info) meta |= ((uint32_t)info[i]) << 16;
    row[3 * slots + col] = meta;
    if (d > maxd) maxd = d;
  }
  return (int64_t)maxd + 1;
}

// Stable LSD radix argsort of u64 keys: 4 passes of 16 bits, each pass a
// threaded histogram + stable scatter of (key, index) pairs. The index
// build's dictionary sort (dictgen.c:53-61 uses glibc qsort) is the
// dominant host cost at whole-genome scale; numpy's stable argsort runs
// ~16 s at 48M keys, this runs at memory speed. Indices are u32 (the
// reference's own 2^32-rows-per-dict limit, qv.cc:523-526).
// Returns 0 on success, -1 on allocation failure.
int64_t vgt_radix_argsort_u64(const uint64_t* keys, int64_t n,
                              uint32_t* idx_out) {
  if (n <= 0) return 0;
  const int kBits = 16, kBins = 1 << kBits;
  uint64_t* ka = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint64_t* kb = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint32_t* ib = static_cast<uint32_t*>(std::malloc(n * sizeof(uint32_t)));
  if (!ka || !kb || !ib) {
    std::free(ka); std::free(kb); std::free(ib);
    return -1;
  }
  std::memcpy(ka, keys, n * sizeof(uint64_t));
  for (int64_t i = 0; i < n; ++i) idx_out[i] = (uint32_t)i;

  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)(hw ? hw : 1);
  if ((int64_t)T > n / (1 << 16) + 1) T = (int)(n / (1 << 16) + 1);
  if (T < 1) T = 1;
  std::vector<int64_t> bounds(T + 1);
  for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> hist((size_t)T);

  uint64_t* src_k = ka; uint64_t* dst_k = kb;
  uint32_t* src_i = idx_out; uint32_t* dst_i = ib;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * kBits;
    // phase 1: per-thread digit histograms
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& h = hist[t];
        h.assign(kBins, 0);
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
          ++h[(src_k[i] >> shift) & (kBins - 1)];
      });
    }
    for (auto& x : th) x.join();
    // single-digit pass: nothing moves, skip the scatter
    int nz = 0, last = -1;
    {
      std::vector<int64_t> tot(kBins, 0);
      for (int t = 0; t < T; ++t)
        for (int b = 0; b < kBins; ++b) tot[b] += hist[t][b];
      for (int b = 0; b < kBins && nz < 2; ++b)
        if (tot[b]) { ++nz; last = b; }
      (void)last;
      if (nz < 2) continue;
      // bin-major, thread-minor exclusive offsets (stability)
      int64_t run = 0;
      for (int b = 0; b < kBins; ++b)
        for (int t = 0; t < T; ++t) {
          int64_t c = hist[t][b];
          hist[t][b] = run;
          run += c;
        }
    }
    // phase 2: stable scatter
    th.clear();
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& off = hist[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
          int64_t d = (int64_t)((src_k[i] >> shift) & (kBins - 1));
          int64_t o = off[d]++;
          dst_k[o] = src_k[i];
          dst_i[o] = src_i[i];
        }
      });
    }
    for (auto& x : th) x.join();
    std::swap(src_k, dst_k);
    std::swap(src_i, dst_i);
  }
  if (src_i != idx_out)
    std::memcpy(idx_out, src_i, n * sizeof(uint32_t));
  std::free(ka); std::free(kb); std::free(ib);
  return 0;
}

// In-place stable key-value radix sort: sorts keys[0..n) ascending and
// carries vals along. Peak extra memory = ONE key buffer + ONE val buffer
// (n*12 B), vs argsort's n*36 B of temporaries PLUS the caller's two
// fancy-index applications -- the difference OOM'd the 3 Gb whole-genome
// index build (3G k-mers) on a 125 GB host twice.
int64_t vgt_radix_sort_kv_u64u32(uint64_t* keys, uint32_t* vals,
                                 int64_t n) {
  if (n <= 0) return 0;
  const int kBits = 16, kBins = 1 << kBits;
  uint64_t* kb = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint32_t* vb = static_cast<uint32_t*>(std::malloc(n * sizeof(uint32_t)));
  if (!kb || !vb) { std::free(kb); std::free(vb); return -1; }

  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)(hw ? hw : 1);
  if ((int64_t)T > n / (1 << 16) + 1) T = (int)(n / (1 << 16) + 1);
  if (T < 1) T = 1;
  std::vector<int64_t> bounds(T + 1);
  for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> hist((size_t)T);

  uint64_t* src_k = keys; uint64_t* dst_k = kb;
  uint32_t* src_v = vals; uint32_t* dst_v = vb;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * kBits;
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& h = hist[t];
        h.assign(kBins, 0);
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
          ++h[(src_k[i] >> shift) & (kBins - 1)];
      });
    }
    for (auto& x : th) x.join();
    int nz = 0;
    {
      std::vector<int64_t> tot(kBins, 0);
      for (int t = 0; t < T; ++t)
        for (int b = 0; b < kBins; ++b) tot[b] += hist[t][b];
      for (int b = 0; b < kBins && nz < 2; ++b)
        if (tot[b]) ++nz;
      if (nz < 2) continue;  // single digit: nothing moves
      int64_t run = 0;
      for (int b = 0; b < kBins; ++b)
        for (int t = 0; t < T; ++t) {
          int64_t c = hist[t][b];
          hist[t][b] = run;
          run += c;
        }
    }
    th.clear();
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& off = hist[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
          int64_t d = (int64_t)((src_k[i] >> shift) & (kBins - 1));
          int64_t o = off[d]++;
          dst_k[o] = src_k[i];
          dst_v[o] = src_v[i];
        }
      });
    }
    for (auto& x : th) x.join();
    std::swap(src_k, dst_k);
    std::swap(src_v, dst_v);
  }
  if (src_k != keys) {
    std::memcpy(keys, src_k, n * sizeof(uint64_t));
    std::memcpy(vals, src_v, n * sizeof(uint32_t));
  }
  std::free(kb); std::free(vb);
  return 0;
}

}  // extern "C"

namespace {

// a line's slack in the output: the headers put before it, or the
// columns a row gains
const int64_t kLineSlack = 256;

struct Span {
  const char* p;
  int64_t n;
};

inline bool span_eq(Span a, const char* s, int64_t n) {
  return a.n == n && std::memcmp(a.p, s, n) == 0;
}

inline bool contains(const char* s, int64_t n, const char* pat) {
  int64_t m = (int64_t)std::strlen(pat);
  for (int64_t i = 0; i + m <= n; ++i)
    if (std::memcmp(s + i, pat, m) == 0) return true;
  return false;
}

void split(const char* s, int64_t n, char sep, std::vector<Span>* out) {
  out->clear();
  const char* end = s + n;
  for (;;) {
    const char* q = static_cast<const char*>(std::memchr(s, sep, end - s));
    if (!q) { out->push_back({s, end - s}); return; }
    out->push_back({s, q - s});
    s = q + 1;
  }
}

// 0x80 in each byte of x that is zero (exact as to whether any is)
inline uint64_t zero_bytes(uint64_t x) {
  return (x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull;
}

// The end of the line at p: the first '\n' or '\r', or `end`; sets
// *high when a byte on the way is not ASCII.
inline const char* line_end(const char* p, const char* end, bool* high) {
  while (end - p >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    if ((w & 0x8080808080808080ull) |
        zero_bytes(w ^ 0x0a0a0a0a0a0a0a0aull) |
        zero_bytes(w ^ 0x0d0d0d0d0d0d0d0dull))
      break;
    p += 8;
  }
  for (; p < end && *p != '\n' && *p != '\r'; ++p)
    if (*p & 0x80) *high = true;
  return p;
}

int write_int(char* buf, int32_t v) {
  char tmp[12];
  int n = 0;
  int64_t x = v;
  bool neg = x < 0;
  if (neg) x = -x;
  do { tmp[n++] = (char)('0' + x % 10); x /= 10; } while (x);
  int k = 0;
  if (neg) buf[k++] = '-';
  while (n) buf[k++] = tmp[--n];
  return k;
}

struct Key {
  int32_t id;
  int64_t pos;
  bool operator<(const Key& o) const {
    return id != o.id ? id < o.id : pos < o.pos;
  }
  bool operator==(const Key& o) const { return id == o.id && pos == o.pos; }
};

// (name id, local position) -> the last table row with that key: the
// keys sorted once (a table in site order already is, but for the rows
// past the last chromosome's end), then a cursor that a VCF in the same
// order walks forward; a line out of that order moves it by a binary
// search.
class CallMap {
 public:
  CallMap(const int32_t* id, const int64_t* pos, int64_t n) {
    std::vector<std::pair<Key, int64_t>> kv((size_t)n);
    bool sorted = true;
    for (int64_t r = 0; r < n; ++r) {
      kv[r] = {{id[r], pos[r]}, r};
      if (r && kv[r].first < kv[r - 1].first) sorted = false;
    }
    if (!sorted)
      std::stable_sort(kv.begin(), kv.end(),
                       [](const std::pair<Key, int64_t>& a,
                          const std::pair<Key, int64_t>& b) {
                         return a.first < b.first;
                       });
    for (size_t i = 0; i < kv.size(); ++i) {
      if (i + 1 < kv.size() && kv[i + 1].first == kv[i].first) continue;
      keys_.push_back(kv[i].first);   // the last of equal keys
      rows_.push_back(kv[i].second);
    }
  }
  int64_t find(Key k) {
    const int64_t n = (int64_t)keys_.size();
    if (cur_ < n && keys_[cur_] < k) {
      int64_t step = 0;
      while (cur_ < n && keys_[cur_] < k && step++ < 8) ++cur_;
      if (cur_ < n && keys_[cur_] < k)
        cur_ = std::lower_bound(keys_.begin() + cur_, keys_.end(), k) -
               keys_.begin();
    } else if (cur_ >= n || k < keys_[cur_]) {
      cur_ = std::lower_bound(keys_.begin(), keys_.end(), k) - keys_.begin();
    }
    return cur_ < n && keys_[cur_] == k ? rows_[cur_] : -1;
  }

 private:
  std::vector<Key> keys_;
  std::vector<int64_t> rows_;
  int64_t cur_ = 0;
};

const char kGtHeader[] =
    "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"Genotype\">\n";
const char kGqHeader[] =
    "##FORMAT=<ID=GQ,Number=1,Type=Integer,"
    "Description=\"Genotype Quality\">\n";

}  // namespace

extern "C" {

// VCF rewrite (io/vcf_writer.py): the input VCF's bytes in, the output's
// bytes out, in one pass, equal byte for byte to the Python loop there
// (the reference's rewrite, src/qv.cc:1628-1747) for every input it
// accepts. The calls come as a table: row r is (name id chrom[r], local
// position pos[r]) with genotype character gchar[r] and GQ gq[r]; a later
// row replaces an earlier one of the same key, as in the loop's dict.
// `names` holds the chromosome names back to back (name i is
// names[name_off[i] .. name_off[i + 1])); chrom[] indexes the first of
// equal names. A row matches a data line whose CHROM ("chr" put before it
// unless it starts with 'c') + '$' + POS is the loop's key
// name + '$' + decimal local position; the split is at the key's last '$',
// since a decimal has none. Lines end at "\n", "\r\n" or a lone '\r' (the
// loop reads in text mode). Returns the bytes written; -1 where the pass
// declines (a byte that is not ASCII, or a shape on which the loop
// raises: the loop then runs and raises as it did); -2 where `cap` is too
// small (len + kLineSlack a line always suffices).
int64_t vgt_vcf_rewrite(const char* in, int64_t n_in, const char* names,
                        const int64_t* name_off, int64_t n_names,
                        const int32_t* chrom, const int64_t* pos,
                        const uint8_t* gchar, const int32_t* gq,
                        int64_t n_rows, char* out, int64_t cap) {
  std::unordered_map<std::string, int32_t> name_id;
  for (int64_t i = 0; i < n_names; ++i)
    name_id.emplace(std::string(names + name_off[i],
                                name_off[i + 1] - name_off[i]),
                    (int32_t)i);
  CallMap calls(chrom, pos, n_rows);

  bool has_gt = false, has_gq = false, head_has_gt_col = true;
  int64_t gt_index = -1, gq_index = -1;
  std::string key, last_key;
  int32_t last_id = -1;   // name id of last_key, -1 for none
  std::vector<Span> cols, fmt, info;
  char gq_buf[16];
  const char* p = in;
  const char* const end = in + n_in;
  char* o = out;
  char* const o_end = out + cap;
  auto put = [&o](const char* s, int64_t n) {
    std::memcpy(o, s, n);
    o += n;
  };
  auto join = [&](const std::vector<Span>& f) {
    for (size_t i = 0; i < f.size(); ++i) {
      if (i) *o++ = ':';
      put(f[i].p, f[i].n);
    }
  };

  while (p < end) {
    bool high = false;
    const char* q = line_end(p, end, &high);
    if (high) return -1;
    const char* line = p;
    const int64_t len = q - p;
    p = q == end ? end
                 : q + (*q == '\r' && q + 1 < end && q[1] == '\n' ? 2 : 1);
    if (len == 0) continue;
    if (o_end - o < len + kLineSlack) return -2;

    if (line[0] == '#' && len > 1 && line[1] == '#') {
      put(line, len);
      *o++ = '\n';
      if (contains(line, len, "ID=GT,"))
        has_gt = true;
      else if (contains(line, len, "ID=GQ,"))
        has_gq = true;
      continue;
    }
    if (line[0] == '#') {
      if (!has_gt) { put(kGtHeader, sizeof(kGtHeader) - 1); gt_index = 0; }
      if (!has_gq) { put(kGqHeader, sizeof(kGqHeader) - 1); gq_index = 1; }
      put(line, len);
      int64_t tabs = 0;
      for (int64_t i = 0; i < len; ++i) tabs += line[i] == '\t';
      if (tabs + 1 < 10) {
        head_has_gt_col = false;
        put("\tFORMAT\tDONOR", 13);
      }
      *o++ = '\n';
      continue;
    }

    // a data row: its key, CHROM + '$' + POS, split at its last '$'
    const char* line_stop = line + len;
    const char* t1 = static_cast<const char*>(std::memchr(line, '\t', len));
    if (!t1) return -1;
    const char* t2 = static_cast<const char*>(
        std::memchr(t1 + 1, '\t', line_stop - t1 - 1));
    const Span col1 = {t1 + 1, (t2 ? t2 : line_stop) - t1 - 1};
    key.clear();
    if (line[0] != 'c') key.append("chr");
    key.append(line, t1 - line);
    Span digits = col1;
    for (int64_t i = col1.n - 1; i >= 0; --i)
      if (col1.p[i] == '$') {
        key.push_back('$');
        key.append(col1.p, i);
        digits = {col1.p + i + 1, col1.n - i - 1};
        break;
      }
    // the local position as Python's str() writes it: 1 to 18 digits,
    // no leading zero (genome offsets lie far below 10^18)
    if (digits.n < 1 || digits.n > 18 || (digits.n > 1 && digits.p[0] == '0'))
      continue;
    int64_t local = 0;
    bool bad = false;
    for (int64_t i = 0; i < digits.n; ++i) {
      unsigned d = (unsigned)(digits.p[i] - '0');
      bad |= d > 9;
      local = local * 10 + d;
    }
    if (bad) continue;
    if (key != last_key) {
      auto it = name_id.find(key);
      last_id = it == name_id.end() ? -1 : it->second;
      last_key = key;
    }
    if (last_id < 0) continue;
    const int64_t r = calls.find({last_id, local});
    if (r < 0) continue;  // uncalled SNPs are omitted (src/qv.cc:1674-1676)

    const char* gts = gchar[r] == '1' ? "0/1" : gchar[r] == '2' ? "1/1"
                                                                : "0/0";
    const int gq_len = write_int(gq_buf, gq[r]);
    split(line, len, '\t', &cols);
    fmt.clear();
    info.clear();
    if (head_has_gt_col && cols.size() > 9) {
      split(cols[8].p, cols[8].n, ':', &fmt);
      split(cols[9].p, cols[9].n, ':', &info);
    }
    if (has_gt && gt_index == -1) {
      for (size_t i = 0; i < fmt.size() && gt_index < 0; ++i)
        if (span_eq(fmt[i], "GT", 2)) gt_index = (int64_t)i;
      if (gt_index < 0) return -1;
    }
    if (has_gq && gq_index == -1) {
      for (size_t i = 0; i < fmt.size() && gq_index < 0; ++i)
        if (span_eq(fmt[i], "GQ", 2)) gq_index = (int64_t)i;
      if (gq_index < 0) return -1;
    }
    if (has_gt) {
      if (gt_index >= (int64_t)info.size()) return -1;
      info[gt_index] = {gts, 3};
    } else {
      fmt.push_back({"GT", 2});
      info.push_back({gts, 3});
    }
    if (has_gq) {
      if (gq_index >= (int64_t)info.size()) return -1;
      info[gq_index] = {gq_buf, gq_len};
    } else {
      fmt.push_back({"GQ", 2});
      info.push_back({gq_buf, gq_len});
    }
    if (head_has_gt_col) {
      if (cols.size() < 10) return -1;
      put(line, cols[8].p - line);
      join(fmt);
      *o++ = '\t';
      join(info);
      const char* rest = cols[9].p + cols[9].n;
      put(rest, line_stop - rest);
    } else {
      put(line, len);
      *o++ = '\t';
      join(fmt);
      *o++ = '\t';
      join(info);
    }
    *o++ = '\n';
  }
  return o - out;
}

}  // extern "C"
