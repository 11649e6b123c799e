// textblaster_tpu_torch native host runtime.
//
// The reference's entire runtime is native (Rust; SURVEY.md §2 "the entire
// codebase is the native component").  This library is the PyTorch
// package's native host-side core: the pieces that sit between storage and
// the device program and that must run at memory bandwidth, not interpreter
// speed —
//
//   * UTF-8 → packed codepoint-tensor decoding (the host→HBM feed;
//     reference analogue: the producer's serialize loop,
//     src/producer_logic.rs:48-98),
//   * UAX#29-lite word segmentation over codepoint arrays (reference
//     analogue: ICU4X segmentation, src/utils/text.rs:103-181),
//   * n-gram duplicate scans (src/utils/text.rs:197-259),
//   * byte-level BPE token counting (reference analogue: HF tokenizers'
//     native core behind src/pipeline/token/token_counter.rs:8-43).
//
// Semantics deliberately mirror textblaster_tpu_torch/utils/text.py — that
// file is the single source of truth for segmentation rules; this is the
// compiled fast path, and tests assert bit-identical outputs between the two.
//
// C ABI only (loaded via ctypes): no Python.h dependency, buffers are
// caller-allocated numpy arrays.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Char-class bit flags — must match textblaster_tpu_torch/utils/chartables.py.
constexpr uint8_t kAlnum = 1 << 0;
constexpr uint8_t kAlpha = 1 << 1;
constexpr uint8_t kDigit = 1 << 2;
constexpr uint8_t kWs = 1 << 3;
constexpr uint8_t kPunct = 1 << 4;
constexpr uint8_t kExtend = 1 << 7;  // UAX#29 WB4 attachers (chartables.EXTEND)

// UAX#29 word-joining characters — mirrors _MID_LETTER/_MID_NUM/_MID_NUM_LET
// in textblaster_tpu_torch/utils/text.py (UAX#29-lite rule set).
inline bool is_mid_letter(uint32_t cp) {
  switch (cp) {
    case 0x003a: case 0x00b7: case 0x05f4: case 0x2027: case 0xfe13:
    case 0xfe55: case 0xff1a:  // MidLetter
    case 0x002e: case 0x0027: case 0x2019: case 0x2024: case 0xfe52:
    case 0xff07: case 0xff0e:  // MidNumLet
      return true;
    default:
      return false;
  }
}

inline bool is_mid_num(uint32_t cp) {
  switch (cp) {
    case 0x002c: case 0x003b: case 0x037e: case 0x0589: case 0x066c:
    case 0xfe10: case 0xfe14: case 0xff0c: case 0xff1b:  // MidNum
    case 0x002e: case 0x0027: case 0x2019: case 0x2024: case 0xfe52:
    case 0xff07: case 0xff0e:  // MidNumLet
      return true;
    default:
      return false;
  }
}

inline bool is_mid_any(uint32_t cp) { return is_mid_letter(cp) || is_mid_num(cp); }

inline int utf8_width(uint32_t cp) {
  if (cp < 0x80) return 1;
  if (cp < 0x800) return 2;
  if (cp < 0x10000) return 3;
  return 4;
}

// Decode one UTF-8 sequence at p (end e); invalid bytes decode as U+FFFD one
// byte at a time (Python str round-trips never produce invalid input; this is
// belt-and-braces for raw Arrow buffers).
inline const uint8_t* utf8_next(const uint8_t* p, const uint8_t* e, uint32_t* out) {
  uint8_t b0 = *p;
  if (b0 < 0x80) {
    *out = b0;
    return p + 1;
  }
  int n;
  uint32_t cp;
  if ((b0 & 0xe0) == 0xc0) {
    n = 1;
    cp = b0 & 0x1f;
  } else if ((b0 & 0xf0) == 0xe0) {
    n = 2;
    cp = b0 & 0x0f;
  } else if ((b0 & 0xf8) == 0xf0) {
    n = 3;
    cp = b0 & 0x07;
  } else {
    *out = 0xfffd;
    return p + 1;
  }
  const uint8_t* q = p + 1;
  for (int i = 0; i < n; ++i) {
    if (q >= e || (*q & 0xc0) != 0x80) {
      *out = 0xfffd;
      return p + 1;
    }
    cp = (cp << 6) | (*q & 0x3f);
    ++q;
  }
  *out = cp;
  return q;
}

// FNV-1a over a range of 32-bit values.
inline uint64_t fnv1a_step(uint64_t h, uint32_t v) {
  for (int i = 0; i < 4; ++i) {
    h ^= (v >> (8 * i)) & 0xff;
    h *= 0x100000001b3ULL;
  }
  return h;
}
constexpr uint64_t kFnvInit = 0xcbf29ce484222325ULL;

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Batch UTF-8 decode + pack.
//
// Document i is bytes[offsets[i] .. offsets[i+1]) (Arrow string-array layout;
// parquet_reader.rs:159-179 analogue without the per-row Rust String).  Row i
// of out_cps (stride row_stride int32s) receives its codepoints zero-padded;
// out_lengths[i] = codepoint count, or the negative count if the document
// exceeds max_len (row untouched — caller routes it to the host-fallback
// path, SURVEY.md §5 "ragged data on fixed shapes").
void tb_pack_utf8(const uint8_t* bytes, const int64_t* offsets, int64_t n_docs,
                  int32_t* out_cps, int32_t* out_lengths, int64_t max_len,
                  int64_t row_stride) {
  for (int64_t i = 0; i < n_docs; ++i) {
    const uint8_t* p = bytes + offsets[i];
    const uint8_t* e = bytes + offsets[i + 1];
    int32_t* row = out_cps + i * row_stride;
    int64_t n = 0;
    uint32_t cp;
    bool overflow = false;
    while (p < e) {
      p = utf8_next(p, e, &cp);
      if (n < max_len) {
        row[n] = static_cast<int32_t>(cp);
      } else {
        overflow = true;
      }
      ++n;
    }
    if (overflow) {
      std::memset(row, 0, sizeof(int32_t) * static_cast<size_t>(max_len));
      out_lengths[i] = static_cast<int32_t>(-n);
    } else {
      out_lengths[i] = static_cast<int32_t>(n);
    }
  }
}

// Codepoint counts only (for length-bucketing before any decode).
void tb_utf8_lengths(const uint8_t* bytes, const int64_t* offsets,
                     int64_t n_docs, int32_t* out) {
  for (int64_t i = 0; i < n_docs; ++i) {
    const uint8_t* p = bytes + offsets[i];
    const uint8_t* e = bytes + offsets[i + 1];
    int64_t n = 0;
    // Count = bytes that are not UTF-8 continuation bytes.
    while (p < e) {
      n += ((*p & 0xc0) != 0x80);
      ++p;
    }
    out[i] = static_cast<int32_t>(n);
  }
}

// ---------------------------------------------------------------------------
// UAX#29-lite word segmentation (mirror of utils/text.py word_spans; the
// reference's rule source is ICU4X WordSegmenter, src/utils/text.rs:103-181).
//
// cps/cls: codepoints and their chartables classification.  Writes (start,
// end) pairs into out_spans; returns the span count, or -1 if more than
// max_spans words were found (caller falls back to Python).
int64_t tb_word_spans(const int32_t* cps, int64_t n, const uint8_t* cls,
                      int32_t* out_spans, int64_t max_spans) {
  std::vector<uint8_t> word(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    word[i] = ((cls[i] & kAlnum) != 0) || (cps[i] == '_');
  }
  if (n >= 3) {
    for (int64_t i = 1; i + 1 < n; ++i) {
      if (word[i]) continue;
      uint32_t cp = static_cast<uint32_t>(cps[i]);
      if (!is_mid_any(cp)) continue;
      bool letter_ok = is_mid_letter(cp) && (cls[i - 1] & kAlpha) &&
                       (cls[i + 1] & kAlpha);
      bool num_ok = is_mid_num(cp) && (cls[i - 1] & kDigit) &&
                    (cls[i + 1] & kDigit);
      if (letter_ok || num_ok) word[i] = 2;  // joined, not a run starter class
    }
  }
  // UAX#29 WB4 (lite): Extend/Format chars inherit the wordness of the
  // nearest preceding non-Extend char (utils.text._attach_extend twin).
  // Left-to-right, so marks chain through a run of Extends.
  for (int64_t i = 1; i < n; ++i) {
    if ((cls[i] & kExtend) != 0 && !word[i]) {
      word[i] = word[i - 1] ? 1 : 0;
    }
  }
  int64_t count = 0;
  int64_t i = 0;
  while (i < n) {
    if (word[i]) {
      int64_t j = i;
      bool non_punct = false;
      while (j < n && word[j]) {
        if ((cls[j] & kPunct) == 0) non_punct = true;
        ++j;
      }
      // Reject punctuation-only segments (text.rs:139-157 parity).
      if (non_punct) {
        if (count >= max_spans) return -1;
        out_spans[2 * count] = static_cast<int32_t>(i);
        out_spans[2 * count + 1] = static_cast<int32_t>(j);
        ++count;
      }
      i = j;
    } else {
      // Standalone symbol "word": not whitespace, not reference punctuation.
      // ZWSP (WordBreak=Other, not word-like) and bare Extend chars produce
      // no token; a trailing Extend run attaches to the symbol (WB4) —
      // mirror of utils.text.word_spans.
      if ((cls[i] & kWs) == 0 && (cls[i] & kPunct) == 0 &&
          (cls[i] & kExtend) == 0 && static_cast<uint32_t>(cps[i]) != 0x200B) {
        int64_t j = i + 1;
        while (j < n && (cls[j] & kExtend) != 0 && !word[j]) ++j;
        if (count >= max_spans) return -1;
        out_spans[2 * count] = static_cast<int32_t>(i);
        out_spans[2 * count + 1] = static_cast<int32_t>(j);
        ++count;
        i = j;
      } else {
        ++i;
      }
    }
  }
  return count;
}

namespace {

// Concatenated-gram helpers shared by the duplicate scans.  A "gram" is the
// word sequence spans[idx..idx+n) either concatenated directly
// (find_all_duplicate, text.rs:250) or space-joined (get_n_grams,
// text.rs:184-194).  Grams are compared by flattened codepoint content —
// hashing is only a prefilter, equality is always verified, so results are
// exact (the Rust uses real HashMaps over Strings; same observable effect).

struct GramView {
  const int32_t* cps;
  const int32_t* spans;  // flat (start,end) pairs
  int64_t idx;           // first word
  int64_t n;             // word count
  bool joined;           // true: words separated by a virtual ' '
};

inline uint64_t gram_hash(const GramView& g) {
  uint64_t h = kFnvInit;
  for (int64_t w = 0; w < g.n; ++w) {
    if (g.joined && w > 0) h = fnv1a_step(h, ' ');
    int32_t s = g.spans[2 * (g.idx + w)];
    int32_t e = g.spans[2 * (g.idx + w) + 1];
    for (int32_t k = s; k < e; ++k) h = fnv1a_step(h, static_cast<uint32_t>(g.cps[k]));
  }
  return h;
}

inline int64_t gram_bytes(const GramView& g) {
  int64_t b = g.joined ? (g.n - 1) : 0;  // ' ' is 1 UTF-8 byte
  for (int64_t w = 0; w < g.n; ++w) {
    int32_t s = g.spans[2 * (g.idx + w)];
    int32_t e = g.spans[2 * (g.idx + w) + 1];
    for (int32_t k = s; k < e; ++k) b += utf8_width(static_cast<uint32_t>(g.cps[k]));
  }
  return b;
}

// Character-stream equality of two grams (concatenation equality, which is
// NOT word-wise equality when joined == false).
inline bool gram_eq(const GramView& a, const GramView& b) {
  int64_t wa = 0, wb = 0;
  int32_t ka = 0, kb = 0;
  bool space_a = false, space_b = false;
  // Position ka within word wa (or virtual space when space_a).
  auto advance = [](const GramView& g, int64_t& w, int32_t& k, bool& in_space,
                    int32_t& out_cp) -> bool {
    while (w < g.n) {
      if (in_space) {
        in_space = false;
        out_cp = ' ';
        return true;
      }
      int32_t s = g.spans[2 * (g.idx + w)];
      int32_t e = g.spans[2 * (g.idx + w) + 1];
      if (s + k < e) {
        out_cp = g.cps[s + k];
        ++k;
        return true;
      }
      ++w;
      k = 0;
      if (g.joined && w < g.n) in_space = true;
    }
    return false;
  };
  for (;;) {
    int32_t ca = 0, cb = 0;
    bool ha = advance(a, wa, ka, space_a, ca);
    bool hb = advance(b, wb, kb, space_b, cb);
    if (ha != hb) return false;
    if (!ha) return true;
    if (ca != cb) return false;
  }
}

}  // namespace

// find_all_duplicate (text.rs:241-259): total UTF-8 bytes of non-overlapping
// repeated n-grams (words concatenated without separator), advancing by n on
// a hit and by 1 otherwise.
int64_t tb_dup_ngram_bytes(const int32_t* cps, const int32_t* spans,
                           int64_t n_spans, int64_t n) {
  if (n <= 0 || n_spans < n) return 0;
  std::unordered_map<uint64_t, std::vector<int64_t>> seen;
  seen.reserve(static_cast<size_t>(n_spans));
  int64_t rep = 0;
  int64_t idx = 0;
  while (idx + n <= n_spans) {
    GramView g{cps, spans, idx, n, false};
    uint64_t h = gram_hash(g);
    auto it = seen.find(h);
    bool dup = false;
    if (it != seen.end()) {
      for (int64_t prev : it->second) {
        GramView p{cps, spans, prev, n, false};
        if (gram_eq(g, p)) {
          dup = true;
          break;
        }
      }
    }
    if (dup) {
      rep += gram_bytes(g);
      idx += n;
    } else {
      seen[h].push_back(idx);
      idx += 1;
    }
  }
  return rep;
}

// find_top_duplicate over space-joined n-grams (text.rs:211-238): byte length
// × count of the most frequent n-gram, ties broken by the larger byte
// contribution; 0 when nothing repeats.
int64_t tb_top_ngram_bytes(const int32_t* cps, const int32_t* spans,
                           int64_t n_spans, int64_t n) {
  if (n <= 0 || n_spans < n) return 0;
  struct Entry {
    int64_t first;
    int64_t count;
  };
  std::unordered_map<uint64_t, std::vector<Entry>> table;
  table.reserve(static_cast<size_t>(n_spans));
  int64_t max_count = 0;
  for (int64_t idx = 0; idx + n <= n_spans; ++idx) {
    GramView g{cps, spans, idx, n, true};
    uint64_t h = gram_hash(g);
    auto& bucket = table[h];
    bool found = false;
    for (auto& e : bucket) {
      GramView p{cps, spans, e.first, n, true};
      if (gram_eq(g, p)) {
        ++e.count;
        if (e.count > max_count) max_count = e.count;
        found = true;
        break;
      }
    }
    if (!found) {
      bucket.push_back({idx, 1});
      if (max_count < 1) max_count = 1;
    }
  }
  if (max_count <= 1) return 0;
  int64_t best = 0;
  for (auto& kv : table) {
    for (auto& e : kv.second) {
      if (e.count == max_count) {
        GramView g{cps, spans, e.first, n, true};
        int64_t v = gram_bytes(g) * max_count;
        if (v > best) best = v;
      }
    }
  }
  return best;
}

// find_duplicates (text.rs:197-208) over arbitrary item spans (lines or
// paragraphs): *out_elems = duplicate item count, returns total UTF-8 bytes
// of the duplicates.
int64_t tb_dup_items(const int32_t* cps, const int32_t* spans, int64_t n_items,
                     int64_t* out_elems) {
  std::unordered_map<uint64_t, std::vector<int64_t>> seen;
  seen.reserve(static_cast<size_t>(n_items));
  int64_t dup_elems = 0;
  int64_t dup_bytes = 0;
  for (int64_t i = 0; i < n_items; ++i) {
    GramView g{cps, spans, i, 1, false};
    uint64_t h = gram_hash(g);
    auto& bucket = seen[h];
    bool dup = false;
    for (int64_t prev : bucket) {
      GramView p{cps, spans, prev, 1, false};
      if (gram_eq(g, p)) {
        dup = true;
        break;
      }
    }
    if (dup) {
      ++dup_elems;
      dup_bytes += gram_bytes(g);
    } else {
      bucket.push_back(i);
    }
  }
  *out_elems = dup_elems;
  return dup_bytes;
}

// ---------------------------------------------------------------------------
// Byte-level BPE token counting (reference analogue: the HF tokenizers
// native core behind token_counter.rs:8-43).  GPT-2-family tokenizers:
// byte→unicode remap, GPT-2 pre-tokenization, greedy rank-ordered merges.

namespace {

struct Bpe {
  // Tokens live in the byte→unicode *mapped* space, stored as UTF-8 strings.
  std::unordered_map<std::string, int32_t> token_ids;
  std::vector<std::string> tokens;
  // (left_id << 32 | right_id) -> (rank << 32 | merged_id)
  std::unordered_map<uint64_t, uint64_t> merges;
  int32_t byte_token[256];       // token id of each raw byte's mapped char
  const uint8_t* cls_table = nullptr;  // chartables classification
  int64_t cls_len = 0;

  int32_t intern(const std::string& s) {
    auto it = token_ids.find(s);
    if (it != token_ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(tokens.size());
    token_ids.emplace(s, id);
    tokens.push_back(s);
    return id;
  }

  uint8_t cls(uint32_t cp) const {
    if (cls_table == nullptr) return 0;
    int64_t i = static_cast<int64_t>(cp);
    if (i >= cls_len) i = cls_len - 1;
    return cls_table[i];
  }
};

inline void append_utf8(std::string* s, uint32_t cp) {
  if (cp < 0x80) {
    s->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    s->push_back(static_cast<char>(0xc0 | (cp >> 6)));
    s->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  } else if (cp < 0x10000) {
    s->push_back(static_cast<char>(0xe0 | (cp >> 12)));
    s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3f)));
    s->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  } else {
    s->push_back(static_cast<char>(0xf0 | (cp >> 18)));
    s->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3f)));
    s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3f)));
    s->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  }
}

// GPT-2's byte→unicode bijection: printable latin-1 ranges map to themselves,
// everything else to 0x100, 0x101, ... in raw-byte order.
void build_byte_map(uint32_t out[256]) {
  bool direct[256] = {false};
  for (int b = 33; b <= 126; ++b) direct[b] = true;
  for (int b = 161; b <= 172; ++b) direct[b] = true;
  for (int b = 174; b <= 255; ++b) direct[b] = true;
  uint32_t next = 256;
  for (int b = 0; b < 256; ++b) {
    if (direct[b]) {
      out[b] = static_cast<uint32_t>(b);
    } else {
      out[b] = next++;
    }
  }
}

// Greedy BPE merge of a mapped-space symbol sequence; returns token count.
int64_t bpe_merge_count(const Bpe* bpe, std::vector<int32_t>* parts) {
  while (parts->size() >= 2) {
    int64_t best_pos = -1;
    uint64_t best_rank = ~0ULL;
    int32_t best_merged = -1;
    for (size_t i = 0; i + 1 < parts->size(); ++i) {
      uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>((*parts)[i])) << 32) |
                     static_cast<uint32_t>((*parts)[i + 1]);
      auto it = bpe->merges.find(key);
      if (it != bpe->merges.end()) {
        uint64_t rank = it->second >> 32;
        if (rank < best_rank) {
          best_rank = rank;
          best_pos = static_cast<int64_t>(i);
          best_merged = static_cast<int32_t>(it->second & 0xffffffffULL);
        }
      }
    }
    if (best_pos < 0) break;
    (*parts)[best_pos] = best_merged;
    parts->erase(parts->begin() + best_pos + 1);
  }
  return static_cast<int64_t>(parts->size());
}

}  // namespace

// Build a BPE from the contents of a merges.txt (GPT-2 format: optional
// "#version" header line, then "left right" per line, rank = line order).
void* tb_bpe_new(const uint8_t* merges_blob, int64_t merges_len) {
  Bpe* bpe = new Bpe();
  uint32_t byte_map[256];
  build_byte_map(byte_map);
  for (int b = 0; b < 256; ++b) {
    std::string s;
    append_utf8(&s, byte_map[b]);
    bpe->byte_token[b] = bpe->intern(s);
  }
  const char* p = reinterpret_cast<const char*>(merges_blob);
  const char* end = p + merges_len;
  uint64_t rank = 0;
  bool first_line = true;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    size_t len = static_cast<size_t>(line_end - p);
    while (len > 0 && (p[len - 1] == '\r' || p[len - 1] == ' ')) --len;
    std::string line(p, len);
    p = nl ? nl + 1 : end;
    if (first_line) {
      first_line = false;
      if (line.rfind("#version", 0) == 0) continue;
    }
    if (line.empty() || line[0] == '#') continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    std::string left = line.substr(0, sp);
    std::string right = line.substr(sp + 1);
    int32_t l = bpe->intern(left);
    int32_t r = bpe->intern(right);
    int32_t m = bpe->intern(left + right);
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
                   static_cast<uint32_t>(r);
    bpe->merges.emplace(key, (rank << 32) | static_cast<uint32_t>(m));
    ++rank;
  }
  return bpe;
}

void tb_bpe_set_table(void* handle, const uint8_t* cls_table, int64_t table_len) {
  Bpe* bpe = static_cast<Bpe*>(handle);
  bpe->cls_table = cls_table;
  bpe->cls_len = table_len;
}

void tb_bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

// Count BPE tokens of a UTF-8 text: GPT-2 pre-tokenization (contractions,
// " ?letters", " ?numbers", " ?other", whitespace runs with the
// keep-last-space-for-next-token rule), then greedy merges per pre-token.
// Letter/number/whitespace classes come from the chartables table
// (\p{L}≈isalpha, \p{N}≈isdigit, \s≈isspace — documented approximation).
int64_t tb_bpe_count(void* handle, const uint8_t* utf8, int64_t len) {
  Bpe* bpe = static_cast<Bpe*>(handle);
  // Decode once, remembering each codepoint's byte span.
  std::vector<uint32_t> cps;
  std::vector<int32_t> byte_off;  // start byte of each cp; +1 sentinel
  cps.reserve(static_cast<size_t>(len));
  const uint8_t* p = utf8;
  const uint8_t* e = utf8 + len;
  while (p < e) {
    uint32_t cp;
    byte_off.push_back(static_cast<int32_t>(p - utf8));
    p = utf8_next(p, e, &cp);
    cps.push_back(cp);
  }
  byte_off.push_back(static_cast<int32_t>(len));
  int64_t n = static_cast<int64_t>(cps.size());

  auto is_alpha = [&](int64_t i) { return (bpe->cls(cps[i]) & kAlpha) != 0; };
  auto is_digit = [&](int64_t i) { return (bpe->cls(cps[i]) & kDigit) != 0; };
  auto is_space = [&](int64_t i) { return (bpe->cls(cps[i]) & kWs) != 0; };

  int64_t total = 0;
  std::vector<int32_t> parts;
  auto flush = [&](int64_t cp_start, int64_t cp_end) {
    // Map raw bytes [byte_off[cp_start], byte_off[cp_end]) through the byte
    // tokens and merge.
    parts.clear();
    for (int32_t b = byte_off[cp_start]; b < byte_off[cp_end]; ++b) {
      parts.push_back(bpe->byte_token[utf8[b]]);
    }
    total += bpe_merge_count(bpe, &parts);
  };

  int64_t i = 0;
  while (i < n) {
    // Contractions: 's 't 're 've 'm 'll 'd (case-sensitive, ASCII).
    if (cps[i] == '\'' && i + 1 < n) {
      uint32_t c1 = cps[i + 1];
      uint32_t c2 = (i + 2 < n) ? cps[i + 2] : 0;
      int64_t clen = 0;
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') clen = 2;
      if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
          (c1 == 'l' && c2 == 'l'))
        clen = 3;
      if (clen > 0) {
        flush(i, i + clen);
        i += clen;
        continue;
      }
    }
    // " ?\p{L}+" / " ?\p{N}+" / " ?[^\s\p{L}\p{N}]+"
    int64_t start = i;
    int64_t j = (cps[i] == ' ' && i + 1 < n) ? i + 1 : i;
    if (j < n && is_alpha(j)) {
      while (j < n && is_alpha(j)) ++j;
      flush(start, j);
      i = j;
      continue;
    }
    if (j < n && is_digit(j)) {
      while (j < n && is_digit(j)) ++j;
      flush(start, j);
      i = j;
      continue;
    }
    if (j < n && !is_space(j) && !is_alpha(j) && !is_digit(j)) {
      while (j < n && !is_space(j) && !is_alpha(j) && !is_digit(j)) ++j;
      flush(start, j);
      i = j;
      continue;
    }
    // Whitespace runs: "\s+(?!\S)" then "\s+".  A run followed by a
    // non-space token donates its final char to that token only when it is
    // a literal ' ' (handled by the " ?" above on the next iteration).
    if (is_space(i)) {
      int64_t k = i;
      while (k < n && is_space(k)) ++k;
      // "\s+(?!\S)" backtracks one char when the run abuts a non-space
      // token (that char is then taken by the next token's " ?" when it is
      // a literal space, or stands alone via "\s+").
      int64_t run_end = (k < n && k - i >= 2) ? k - 1 : k;
      flush(i, run_end);
      i = run_end;
      continue;
    }
    // Unreachable fallback: single char token.
    flush(i, i + 1);
    ++i;
  }
  return total;
}

}  // extern "C"
