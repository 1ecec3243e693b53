// Native FASTX ingest: parse + nucleotide-encode in one pass over a buffer.
//
// TPU-native replacement for the host-side hot path the reference delegates
// to the needletail crate (reference lib.rs:143-144, 221; cluster.rs:28).
// The device never waits on per-record Python work: this parser emits, in
// one scan over the (already gunzipped) file bytes,
//
//   - record id strings (concatenated + offsets),
//   - raw sequence bytes (concatenated + offsets, FASTA line wraps removed),
//   - encoded channel indices (same offsets) via the reference's byte LUT
//     semantics (lib.rs:167-184: A/C/G/T/U case-insensitive, all IUPAC
//     degenerates and '-' -> N, anything else invalid),
//
// with the first-invalid-byte position reported so Python can raise the
// reference's exact error text (lib.rs:38-42).
//
// API is two-pass so the caller owns every allocation (numpy buffers over
// ctypes): fastx_scan sizes the outputs, fastx_fill writes them.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t INVALID = 255;

struct Lut {
  uint8_t v[256];
  constexpr Lut() : v() {
    for (int i = 0; i < 256; ++i) v[i] = INVALID;
    auto set = [&](const char* s, uint8_t c) {
      for (const char* p = s; *p; ++p) v[(uint8_t)*p] = c;
    };
    set("Aa", 0);
    set("Cc", 1);
    set("Gg", 2);
    set("TtUu", 3);
    set("NWSMKRYBDHV-nwsmkrybdhv", 4);
  }
};

constexpr Lut kLut{};

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
  const void* q = memchr(p, '\n', (size_t)(end - p));
  return q ? (const uint8_t*)q : end;
}

inline int64_t line_len(const uint8_t* p, const uint8_t* nl) {
  int64_t n = nl - p;
  if (n > 0 && p[n - 1] == '\r') --n;
  return n;
}

}  // namespace

extern "C" {

// Error codes shared by scan/fill.
enum {
  FASTX_OK = 0,
  FASTX_EMPTY = 1,
  FASTX_BAD_LEADING = 2,
  FASTX_BAD_FASTQ = 3,
  FASTX_SEQ_BEFORE_HEADER = 4,
  FASTX_BAD_BASE = 5,  // fill only (encode=1)
};

// Pass 1: count records and total id/sequence bytes.
// format_out: 0 = FASTA, 1 = FASTQ.
int32_t fastx_scan(const uint8_t* buf, int64_t n, int64_t* n_records,
                   int64_t* total_seq, int64_t* total_id,
                   int32_t* format_out) {
  *n_records = 0;
  *total_seq = 0;
  *total_id = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  if (p == end) return FASTX_EMPTY;
  if (*p == '>') {
    *format_out = 0;
    bool in_record = false;
    while (p < end) {
      const uint8_t* nl = find_nl(p, end);
      int64_t len = line_len(p, nl);
      if (len > 0 && *p == '>') {
        ++*n_records;
        *total_id += len - 1;
        in_record = true;
      } else if (len > 0) {
        if (!in_record) return FASTX_SEQ_BEFORE_HEADER;
        *total_seq += len;
      }
      p = nl + 1;
    }
    return FASTX_OK;
  }
  if (*p == '@') {
    *format_out = 1;
    while (p < end) {
      const uint8_t* nl = find_nl(p, end);
      int64_t hlen = line_len(p, nl);
      if (hlen == 0) {  // tolerate blank separator lines
        p = nl + 1;
        continue;
      }
      if (*p != '@') return FASTX_BAD_FASTQ;
      ++*n_records;
      *total_id += hlen - 1;
      p = nl + 1;
      if (p >= end) return FASTX_BAD_FASTQ;
      const uint8_t* snl = find_nl(p, end);
      *total_seq += line_len(p, snl);
      p = snl + 1;
      if (p >= end || *p != '+') return FASTX_BAD_FASTQ;
      p = find_nl(p, end) + 1;  // '+' line
      if (p >= end) return FASTX_BAD_FASTQ;
      p = find_nl(p, end) + 1;  // quality line
    }
    return FASTX_OK;
  }
  return FASTX_BAD_LEADING;
}

// Pass 2: fill caller-allocated buffers (sized from fastx_scan).
//   ids        [total_id]      concatenated header strings (after >/@)
//   id_offs    [n_records+1]
//   seqs       [total_seq]     raw sequence bytes (wraps removed)
//   seq_offs   [n_records+1]
//   codes      [total_seq]     channel indices 0..4 (only when encode != 0)
// On FASTX_BAD_BASE: bad_record/bad_pos/bad_byte identify the reference
// panic parameters (byte value, record, position within the sequence).
int32_t fastx_fill(const uint8_t* buf, int64_t n, uint8_t* ids,
                   int64_t* id_offs, uint8_t* seqs, int64_t* seq_offs,
                   uint8_t* codes, int32_t encode, int64_t* bad_record,
                   int64_t* bad_pos, int32_t* bad_byte) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  int64_t rec = -1;
  int64_t idp = 0, sp = 0;
  int32_t err = FASTX_OK;
  *bad_record = -1;

  auto encode_span = [&](const uint8_t* s, int64_t len) {
    memcpy(seqs + sp, s, (size_t)len);
    if (encode) {
      int64_t seq_start = seq_offs[rec];
      for (int64_t i = 0; i < len; ++i) {
        uint8_t c = kLut.v[s[i]];
        codes[sp + i] = c;
        if (c == INVALID && err == FASTX_OK) {
          err = FASTX_BAD_BASE;
          *bad_record = rec;
          *bad_pos = (sp + i) - seq_start;
          *bad_byte = s[i];
        }
      }
    }
    sp += len;
  };

  if (p < end && *p == '>') {
    while (p < end) {
      const uint8_t* nl = find_nl(p, end);
      int64_t len = line_len(p, nl);
      if (len > 0 && *p == '>') {
        ++rec;
        id_offs[rec] = idp;
        seq_offs[rec] = sp;
        memcpy(ids + idp, p + 1, (size_t)(len - 1));
        idp += len - 1;
      } else if (len > 0) {
        encode_span(p, len);
      }
      p = nl + 1;
    }
  } else if (p < end && *p == '@') {
    while (p < end) {
      const uint8_t* nl = find_nl(p, end);
      int64_t hlen = line_len(p, nl);
      if (hlen == 0) {
        p = nl + 1;
        continue;
      }
      ++rec;
      id_offs[rec] = idp;
      seq_offs[rec] = sp;
      memcpy(ids + idp, p + 1, (size_t)(hlen - 1));
      idp += hlen - 1;
      p = nl + 1;
      const uint8_t* snl = find_nl(p, end);
      encode_span(p, line_len(p, snl));
      p = snl + 1;
      p = find_nl(p, end) + 1;
      p = find_nl(p, end) + 1;
    }
  }
  id_offs[rec + 1] = idp;
  seq_offs[rec + 1] = sp;
  return err;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Postcard varint codec for the window stream. The reference db body is a
// flat run of n windows, each `varint(wps)` then wps LEB128-varint u64
// words (reference lib.rs:160-162 serde of WindowSet under postcard
// rules). Vectorized numpy decoding goes superlinear past ~1M rows
// (temp-array thrash); this single-pass C++ codec runs at memory speed.

extern "C" {

// Encode n windows of wps words each; out must hold n*(10*wps+10) bytes.
// Returns bytes written.
int64_t postcard_encode_windows(const uint64_t* words, int64_t n,
                                int64_t wps, uint8_t* out) {
  uint8_t* p = out;
  auto put_varint = [&p](uint64_t v) {
    while (v >= 0x80) {
      *p++ = (uint8_t)(v & 0x7F) | 0x80;
      v >>= 7;
    }
    *p++ = (uint8_t)v;
  };
  for (int64_t i = 0; i < n; ++i) {
    put_varint((uint64_t)wps);
    for (int64_t j = 0; j < wps; ++j) put_varint(words[i * wps + j]);
  }
  return p - out;
}

// Encode straight from channel indices (0..4): packs 12 bases/u64 with
// 5-bit one-hot codes (reference lib.rs:31-46) and varint-encodes, no
// intermediate word matrix. out must hold n*(10*wps+10) bytes.
int64_t postcard_encode_codes(const uint8_t* codes, int64_t n, int64_t L,
                              uint8_t* out) {
  const int64_t wps = (L + 11) / 12;
  uint8_t* p = out;
  auto put_varint = [&p](uint64_t v) {
    while (v >= 0x80) {
      *p++ = (uint8_t)(v & 0x7F) | 0x80;
      v >>= 7;
    }
    *p++ = (uint8_t)v;
  };
  for (int64_t i = 0; i < n; ++i) {
    put_varint((uint64_t)wps);
    const uint8_t* row = codes + i * L;
    for (int64_t w = 0; w < wps; ++w) {
      uint64_t word = 0;
      const int64_t base0 = w * 12;
      const int64_t hi = (base0 + 12 < L) ? base0 + 12 : L;
      for (int64_t b = base0; b < hi; ++b) {
        // channel c -> 5-bit one-hot code 0b10000 >> c (lib.rs:171-180)
        word |= (uint64_t)(0b10000u >> row[b]) << (5 * (b - base0));
      }
      put_varint(word);
    }
  }
  return p - out;
}

// Packed u64 words -> channel indices (the trailing-length-aware unpack;
// numpy's version materializes a [n, wps, 12] u64 temporary). Returns 0,
// or -2 with *bad_code set on an invalid 5-bit group (reference decode
// panic, lib.rs:126-129).
int32_t unpack_words_codes(const uint64_t* words, int64_t n, int64_t wps,
                           int64_t L, uint8_t* codes_out, int32_t* bad_code) {
  uint8_t code_to_chan[32];
  memset(code_to_chan, 0xFF, sizeof(code_to_chan));
  for (int c = 0; c < 5; ++c) code_to_chan[0b10000u >> c] = (uint8_t)c;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t* row = words + i * wps;
    uint8_t* out = codes_out + i * L;
    for (int64_t b = 0; b < L; ++b) {
      uint8_t g = (uint8_t)((row[b / 12] >> (5 * (b % 12))) & 31);
      uint8_t chan = code_to_chan[g];
      if (chan == 0xFF) {
        *bad_code = g;
        return -2;
      }
      out[b] = chan;
    }
  }
  return 0;
}

// Decode n windows of wps words each from buf (starting at offset 0).
// Returns bytes consumed; -1 on a per-window word-count mismatch; -3 on
// a truncated stream (distinct so callers keep the reference's
// end-of-buffer error text).
int64_t postcard_decode_windows(const uint8_t* buf, int64_t len, int64_t n,
                                int64_t wps, uint64_t* words_out) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  auto get_varint = [&p, end](uint64_t* v) -> bool {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        *v = acc;
        return true;
      }
      shift += 7;
      if (shift > 63) return false;  // overlong varint: caller sees p past 10 bytes
    }
    return false;
  };
  // Distinguish truncation (-3) from an overlong varint (-4) so Python
  // raises the same error text as the numpy fallback for each case.
  // get_varint stops after consuming exactly 10 bytes (shift > 63), so
  // overlong means >= 10 consumed, never > 10.
  auto classify = [&](const uint8_t* start) -> int64_t {
    return (p - start) >= 10 ? -4 : -3;
  };
  for (int64_t i = 0; i < n; ++i) {
    uint64_t w;
    const uint8_t* s0 = p;
    if (!get_varint(&w)) return classify(s0);
    if ((int64_t)w != wps) return -1;
    for (int64_t j = 0; j < wps; ++j) {
      const uint8_t* s1 = p;
      if (!get_varint(&words_out[i * wps + j])) return classify(s1);
    }
  }
  return p - buf;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TSV hit formatter: the reference prints one line per hit
// ("{qnum}\t{subject}\t{dist}\t{decoded}", lib.rs:292,310) from a hot
// host-side loop. Bulk-format n hits into a caller-sized buffer.

namespace {

inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

}  // namespace

extern "C" {

// Upper bound on bytes needed (caller allocates once).
int64_t tsv_format_bound(int64_t n, int64_t seq_len) {
  return n * (20 + 1 + 20 + 1 + 20 + 1 + seq_len + 1);
}

// rows: qnum[i] (int64), subj[i] (int32), dist[i] (int32),
// decoded: seq_len bytes per distinct subject at decoded + subj[i]*seq_len?
// No — caller passes per-hit string offsets into a decoded blob:
//   str_off[i] .. str_off[i] + seq_len  (seq_len uniform per db)
// Returns bytes written.
int64_t tsv_format(const int64_t* qnum, const int32_t* subj,
                   const int32_t* dist, const uint8_t* decoded,
                   const int64_t* str_off, int64_t seq_len, int64_t n,
                   char* out) {
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    p = put_u64(p, (uint64_t)qnum[i]);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)subj[i]);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)dist[i]);
    *p++ = '\t';
    memcpy(p, decoded + str_off[i], (size_t)seq_len);
    p += seq_len;
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"

// Multithreaded formatter: the single-threaded loop above tops out at
// ~2.2M lines/s — the measured ceiling that made K-mode's extraction and
// the emitter mutually-excusing bottlenecks. Lines are independent, so:
// pass 1 computes each line's EXACT byte length (digit counts), a prefix
// sum gives every row's output offset, then threads fill disjoint gapless
// ranges of the single output buffer in place — no per-thread buffers, no
// join copy. Replaces the reference's per-hit println loop (lib.rs:292).

namespace {

inline int u64_digits(uint64_t v) {
  int d = 1;
  while (v >= 10) {
    v /= 10;
    ++d;
  }
  return d;
}

}  // namespace

extern "C" {

int64_t tsv_format_mt(const int64_t* qnum, const int32_t* subj,
                      const int32_t* dist, const uint8_t* decoded,
                      const int64_t* str_off, int64_t seq_len, int64_t n,
                      char* out) {
  if (n <= 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? (int64_t)hw : 4;
  if (nt > 16) nt = 16;
  if (nt > n / 65536) nt = n / 65536 ? n / 65536 : 1;  // small batches: 1 thread
  if (nt <= 1) return tsv_format(qnum, subj, dist, decoded, str_off,
                                 seq_len, n, out);
  std::vector<int64_t> offs((size_t)n + 1);
  {
    // The offset pass itself parallelizes: per-range local sums, then a
    // serial carry fix-up over nt partials.
    std::vector<int64_t> partial((size_t)nt, 0);
    int64_t step = (n + nt - 1) / nt;
    auto sum_range = [&](int64_t t) {
      int64_t i0 = t * step, i1 = std::min(n, i0 + step);
      int64_t acc = 0;
      for (int64_t i = i0; i < i1; ++i) {
        offs[i] = acc;
        acc += u64_digits((uint64_t)qnum[i]) + u64_digits((uint64_t)subj[i]) +
               u64_digits((uint64_t)dist[i]) + seq_len + 4;
      }
      partial[(size_t)t] = acc;
    };
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; ++t) ts.emplace_back(sum_range, t);
    for (auto& th : ts) th.join();
    int64_t carry = 0;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t i0 = t * step, i1 = std::min(n, i0 + step);
      if (carry)
        for (int64_t i = i0; i < i1; ++i) offs[i] += carry;
      carry += partial[(size_t)t];
    }
    offs[n] = carry;
  }
  auto fill = [&](int64_t i0, int64_t i1) {
    char* p = out + offs[i0];
    for (int64_t i = i0; i < i1; ++i) {
      p = put_u64(p, (uint64_t)qnum[i]);
      *p++ = '\t';
      p = put_u64(p, (uint64_t)subj[i]);
      *p++ = '\t';
      p = put_u64(p, (uint64_t)dist[i]);
      *p++ = '\t';
      memcpy(p, decoded + str_off[i], (size_t)seq_len);
      p += seq_len;
      *p++ = '\n';
    }
  };
  std::vector<std::thread> ts;
  int64_t step = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t i0 = t * step, i1 = std::min(n, i0 + step);
    if (i0 >= i1) break;
    ts.emplace_back(fill, i0, i1);
  }
  for (auto& th : ts) th.join();
  return offs[n];
}

// Decode-fused variant: takes the db's CHANNEL CODES directly and
// decodes each hit's subject row through a 256-byte LUT inside the
// fill threads — eliminating the numpy decoded-blob gather that
// measured 52% of the emit path (440 ms of an 842 ms 2M-line emit;
// docs/PERFORMANCE.md round 5). The LUT is 256-wide so a corrupted
// code byte can never read out of bounds.
int64_t tsv_format_codes_mt(const int64_t* qnum, const int32_t* subj,
                            const int32_t* dist, const uint8_t* db_codes,
                            const uint8_t* lut256, int64_t seq_len,
                            int64_t n, char* out) {
  if (n <= 0) return 0;
  std::vector<int64_t> offs((size_t)n + 1);
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? (int64_t)hw : 4;
  if (nt > 16) nt = 16;
  int64_t by_rows = n / 16384;  // decode work per row is heavier than
  if (nt > by_rows) nt = by_rows ? by_rows : 1;  // plain formatting
  int64_t step = (n + nt - 1) / nt;
  {
    std::vector<int64_t> partial((size_t)nt, 0);
    auto sum_range = [&](int64_t t) {
      int64_t i0 = t * step, i1 = std::min(n, i0 + step);
      int64_t acc = 0;
      for (int64_t i = i0; i < i1; ++i) {
        offs[i] = acc;
        acc += u64_digits((uint64_t)qnum[i]) + u64_digits((uint64_t)subj[i]) +
               u64_digits((uint64_t)dist[i]) + seq_len + 4;
      }
      partial[(size_t)t] = acc;
    };
    if (nt <= 1) {
      sum_range(0);
    } else {
      std::vector<std::thread> ts;
      for (int64_t t = 0; t < nt; ++t) ts.emplace_back(sum_range, t);
      for (auto& th : ts) th.join();
    }
    int64_t carry = 0;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t i0 = t * step, i1 = std::min(n, i0 + step);
      if (carry)
        for (int64_t i = i0; i < i1; ++i) offs[i] += carry;
      carry += partial[(size_t)t];
    }
    offs[n] = carry;
  }
  auto fill = [&](int64_t i0, int64_t i1) {
    char* p = out + offs[i0];
    for (int64_t i = i0; i < i1; ++i) {
      p = put_u64(p, (uint64_t)qnum[i]);
      *p++ = '\t';
      p = put_u64(p, (uint64_t)subj[i]);
      *p++ = '\t';
      p = put_u64(p, (uint64_t)dist[i]);
      *p++ = '\t';
      const uint8_t* row = db_codes + (int64_t)subj[i] * seq_len;
      for (int64_t b = 0; b < seq_len; ++b) p[b] = (char)lut256[row[b]];
      p += seq_len;
      *p++ = '\n';
    }
  };
  if (nt <= 1) {
    fill(0, n);
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t i0 = t * step, i1 = std::min(n, i0 + step);
      if (i0 >= i1) break;
      ts.emplace_back(fill, i0, i1);
    }
    for (auto& th : ts) th.join();
  }
  return offs[n];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact-duplicate set for the cluster op (reference cluster.rs:46-48 dedups
// on the packed encoding with a HashSet<Vec<u64>>; channel-index rows are a
// bijection of that for valid sequences). One call filters a whole batch:
// no per-record Python.

#include <string>
#include <unordered_set>

namespace {

struct DedupSet {
  std::unordered_set<std::string> seen;
};

}  // namespace

extern "C" {

void* dedup_new() { return new DedupSet(); }

void dedup_free(void* h) { delete static_cast<DedupSet*>(h); }

// codes: n rows of len channel bytes. keep[i] = 1 iff row i is the first
// occurrence EVER seen by this set (inserted as a side effect, so the
// in-batch order matches the reference's streaming semantics). Returns the
// number kept.
int64_t dedup_filter(void* h, const uint8_t* codes, int64_t n, int64_t len,
                     uint8_t* keep) {
  auto& seen = static_cast<DedupSet*>(h)->seen;
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto res = seen.emplace(reinterpret_cast<const char*>(codes + i * len),
                            (size_t)len);
    keep[i] = res.second ? 1 : 0;
    kept += res.second;
  }
  return kept;
}

}  // extern "C"

// Cross Hamming block over channel-code rows: out[i*m + j] = number of
// positions where a-row i differs from b-row j (uint8 equality — exactly
// the device one-hot dot semantics: a column matches iff the channel
// indices are equal). The cluster engine's intra-batch resolution needs
// [batch, fails] blocks of this; the numpy 5-channel float32 matmul form
// measured 13.7 s at [16384, 4000] x 60 bp (five skinny memory-bound
// matmuls) where this byte loop auto-vectorizes to well under a second.
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

static inline int32_t row_mismatches(const uint8_t* ai, const uint8_t* bj,
                                     int64_t len) {
  int32_t d = 0;
  int64_t l = 0;
#if defined(__SSE2__)
  // cmpeq -> 0xFF per match; SAD against 0xFF counts matches * 255?? no:
  // count MISMATCHES: mism = ~cmpeq; (mism & 0x01) summed via psadbw.
  __m128i ones = _mm_set1_epi8(1);
  __m128i acc = _mm_setzero_si128();
  for (; l + 16 <= len; l += 16) {
    __m128i va = _mm_loadu_si128((const __m128i*)(ai + l));
    __m128i vb = _mm_loadu_si128((const __m128i*)(bj + l));
    __m128i eq = _mm_cmpeq_epi8(va, vb);
    __m128i mism = _mm_andnot_si128(eq, ones);  // 1 per mismatching byte
    acc = _mm_add_epi64(acc, _mm_sad_epu8(mism, _mm_setzero_si128()));
  }
  d = (int32_t)(_mm_cvtsi128_si64(acc) +
                _mm_cvtsi128_si64(_mm_unpackhi_epi64(acc, acc)));
#endif
  for (; l < len; ++l) d += (ai[l] != bj[l]);
  return d;
}

extern "C" void cross_hamming(const uint8_t* a, int64_t n, const uint8_t* b,
                              int64_t m, int64_t len, int32_t* out) {
  auto work = [=](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const uint8_t* ai = a + i * len;
      int32_t* oi = out + i * m;
      for (int64_t j = 0; j < m; ++j)
        oi[j] = row_mismatches(ai, b + j * len, len);
    }
  };
  int64_t total = n * m;
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? (int64_t)hw : 4;
  if (nt > n) nt = n;
  if (total < (int64_t)1 << 22 || nt <= 1) {  // small blocks: no threads
    work(0, n);
    return;
  }
  if (nt > 16) nt = 16;
  std::vector<std::thread> ts;
  int64_t step = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t i0 = t * step, i1 = std::min(n, i0 + step);
    if (i0 >= i1) break;
    ts.emplace_back(work, i0, i1);
  }
  for (auto& th : ts) th.join();
}
