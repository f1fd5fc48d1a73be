// Native CSV tokenizer — the water/parser hot loop, on the host. The
// PyTorch port's own copy of the reference package's tokenizer (the same
// code, so both packages tokenize a file alike), built at first use by
// h2o3_tpu_torch/native/__init__.py.
//
// Reference behavior being reproduced (not copied — the reference is Java):
//   - water/parser/CsvParser.java: per-byte tokenizer with quote handling
//   - water/parser/ParseDataset.java:253: chunk-parallel parse, each worker
//     tokenizes its byte range starting at the first line break past its
//     offset (cross-chunk line stitching)
//   - water/parser/ParseDataset.java:356-440: per-worker categorical
//     interning followed by global domain unification + code renumbering
//   - water/parser/ParseSetup.java: type guessing (numeric unless some
//     non-missing field fails numeric parse)
//
// Two passes over the buffer: pass 1 infers column types + row count
// (no allocation per field), pass 2 fills typed columns. Threads own
// contiguous row blocks; categorical levels intern into per-thread maps
// merged into one sorted global domain (lexicographic, the order of the
// reference's interning).
//
// C ABI (ctypes-consumed; see native/__init__.py):
//   csv_parse(data, len, sep, header, nthreads) -> handle
//   csv_nrows/csv_ncols/csv_colname/csv_coltype
//   csv_numeric (double out, NaN=NA) / csv_codes (int32 out, -1=NA)
//   csv_card/csv_level, csv_free

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Field { const char* p; long n; };

static inline bool is_na_token(const char* p, long n) {
  if (n == 0) return true;
  if (n == 2 && (memcmp(p, "NA", 2) == 0 || memcmp(p, "na", 2) == 0))
    return true;
  if (n == 3 && (memcmp(p, "nan", 3) == 0 || memcmp(p, "NaN", 3) == 0 ||
                 memcmp(p, "NAN", 3) == 0)) return true;
  if (n == 4 && (memcmp(p, "null", 4) == 0 || memcmp(p, "NULL", 4) == 0))
    return true;
  return false;
}

static bool parse_double_slow(const char* p, long n, double* out) {
  // strtod needs NUL-termination; fields are short, copy to stack
  char buf[64];
  if (n <= 0 || n >= 63) return false;
  memcpy(buf, p, n);
  buf[n] = 0;
  char* end = nullptr;
  double v = strtod(buf, &end);
  while (end && *end == ' ') end++;
  if (end != buf + n) return false;
  *out = v;
  return true;
}

static const double kPow10[19] = {
  1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
  1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18};

static inline bool parse_double(const char* p, long n, double* out) {
  // fast path for the overwhelmingly common [+-]ddd[.ddd] form — strtod
  // plus the stack copy costs ~2x the whole tokenize loop on a 1-core
  // host; exponents/hex/inf fall back to strtod
  if (n <= 0) return false;
  const char* start = p;
  const char* e = p + n;
  bool neg = false;
  if (*p == '-' || *p == '+') { neg = (*p == '-'); p++; }
  if (p == e) return false;
  unsigned long long ip = 0;
  int digits = 0;
  while (p < e && *p >= '0' && *p <= '9') {
    ip = ip * 10u + (unsigned)(*p - '0');
    p++; digits++;
  }
  long frac_digits = 0;
  if (p < e && *p == '.') {
    p++;
    while (p < e && *p >= '0' && *p <= '9') {
      ip = ip * 10u + (unsigned)(*p - '0');
      p++; digits++; frac_digits++;
    }
  }
  // 15-digit cutoff: the integer fits a double exactly and the single
  // divide rounds once, matching correctly-rounded strtod; 16-17 digit
  // values would round twice (integer conversion + divide) and can be
  // 1 ulp off, so they take the slow path
  if (p != e || digits == 0 || digits > 15)
    return parse_double_slow(start, n, out);
  double v = (double)ip;
  if (frac_digits) v /= kPow10[frac_digits];
  *out = neg ? -v : v;
  return true;
}

// Advance over one line from `p` (< limit), invoking cb(field_idx, ptr, len)
// per field. Returns pointer past the line terminator. Handles quoted
// fields with "" escapes; embedded newlines inside quotes are honored.
// dispatch table shared by every scan_line call (one core, one sep per
// parse): building a 256-entry table per LINE dominated short-row files
struct SpecialTable {
  bool special[256] = {};
  explicit SpecialTable(char sep) {
    special[(unsigned char)sep] = special['\n'] = special['\r'] =
        special['"'] = true;
  }
};

// cb(col, ptr, len, quoted): `quoted` distinguishes a quoted empty field
// ("" = empty STRING token, CsvParser.java addStrCol path) from a bare
// empty field (missing, addInvalidCol path)
template <typename F>
static const char* scan_line(const char* p, const char* limit, char sep,
                             const bool* special, F&& cb) {
  int col = 0;
  const char* fstart = p;
  bool quoted = false;
  const char* qstart = nullptr;
  std::string unq;  // only used when a quoted field has "" escapes
  bool has_esc = false;

  while (p < limit) {
    if (!quoted) {
      while (p < limit && !special[(unsigned char)*p]) p++;
      if (p >= limit) break;
    }
    char c = *p;
    if (quoted) {
      if (c == '"') {
        if (p + 1 < limit && p[1] == '"') { has_esc = true; p += 2; continue; }
        quoted = false;
      }
      p++;
      continue;
    }
    if (c == '"' && p == fstart) { quoted = true; qstart = p + 1; p++; continue; }
    if (c == sep || c == '\n' || c == '\r') {
      const char* fp = fstart;
      long fn = p - fstart;
      if (qstart) {  // strip quotes
        fp = qstart;
        fn = (p - 1) - qstart;           // closing quote
        if (fn < 0) fn = 0;
        if (has_esc) {                   // collapse "" -> "
          unq.clear();
          for (long i = 0; i < fn; i++) {
            unq.push_back(fp[i]);
            if (fp[i] == '"' && i + 1 < fn && fp[i + 1] == '"') i++;
          }
          fp = unq.data();
          fn = (long)unq.size();
        }
      }
      cb(col++, fp, fn, qstart != nullptr);
      if (c == sep) { p++; fstart = p; qstart = nullptr; has_esc = false; continue; }
      // line end
      if (c == '\r' && p + 1 < limit && p[1] == '\n') p++;
      return p + 1;
    }
    p++;
  }
  // final line without terminator (same quote/escape handling as above)
  const char* fp = qstart ? qstart : fstart;
  long fn = qstart ? (p - 1) - qstart : p - fstart;
  if (fn < 0) fn = 0;
  if (qstart && has_esc) {
    unq.clear();
    for (long i = 0; i < fn; i++) {
      unq.push_back(fp[i]);
      if (fp[i] == '"' && i + 1 < fn && fp[i + 1] == '"') i++;
    }
    fp = unq.data();
    fn = (long)unq.size();
  }
  cb(col++, fp, fn, qstart != nullptr);
  return p;
}

// first line start at/after `off` (0 stays 0); only safe for bodies with
// no '"' at all — quoted bodies go through next_record_start below
static const char* next_line_start(const char* base, const char* limit,
                                   long off) {
  if (off <= 0) return base;
  const char* p = base + off;
  while (p < limit && *p != '\n') p++;
  return p < limit ? p + 1 : limit;
}

// quote-parity-aware record start: first newline at/after `off` whose
// running double-quote parity (seeded with the parity of [base, base+off))
// is even, i.e. outside any RFC4180-quoted field — so a quoted field with
// an embedded newline or separator never straddles a worker boundary.
// "" escapes toggle parity twice and cancel out.
static const char* next_record_start(const char* base, const char* limit,
                                     long off, long parity) {
  if (off <= 0) return base;
  const char* p = base + off;
  while (p < limit) {
    if (*p == '"') parity ^= 1;
    else if (*p == '\n' && (parity & 1) == 0) return p + 1;
    p++;
  }
  return limit;
}

struct ColData {
  std::string name;
  int type = 0;                     // 0 numeric, 1 categorical
  std::vector<double> nums;
  std::vector<int> codes;           // global codes after merge
  std::vector<std::string> domain;  // sorted global domain
};

// Open-addressing intern map keyed by raw bytes: the std::unordered_map
// path constructed a std::string (malloc) per FIELD, which dominated
// pass 2 on categorical columns. Probes compare bytes against the
// owned level strings; allocation happens only on a NEW level.
struct InternMap {
  std::vector<int> slots;            // level index + 1; 0 = empty
  std::vector<std::string> levels;
  size_t mask = 0;

  void init(size_t cap = 64) {
    size_t n = 64;
    while (n < cap * 2) n <<= 1;
    slots.assign(n, 0);
    mask = n - 1;
  }
  static inline uint64_t hash_bytes(const char* p, long n) {
    uint64_t h = 1469598103934665603ull;               // FNV-1a
    for (long i = 0; i < n; i++) { h ^= (unsigned char)p[i]; h *= 1099511628211ull; }
    return h;
  }
  void grow() {
    std::vector<int> old = std::move(slots);
    slots.assign(old.size() * 2, 0);
    mask = slots.size() - 1;
    for (int v : old) {
      if (!v) continue;
      const std::string& s = levels[(size_t)(v - 1)];
      size_t i = hash_bytes(s.data(), (long)s.size()) & mask;
      while (slots[i]) i = (i + 1) & mask;
      slots[i] = v;
    }
  }
  inline int intern(const char* p, long n) {
    if (slots.empty()) init();
    size_t i = hash_bytes(p, n) & mask;
    while (true) {
      int v = slots[i];
      if (!v) {
        int code = (int)levels.size();
        levels.emplace_back(p, (size_t)n);
        slots[i] = code + 1;
        if (levels.size() * 2 > slots.size()) grow();
        return code;
      }
      const std::string& s = levels[(size_t)(v - 1)];
      if ((long)s.size() == n && memcmp(s.data(), p, (size_t)n) == 0)
        return v - 1;
      i = (i + 1) & mask;
    }
  }
};

struct Parsed {
  long nrows = 0;
  std::vector<ColData> cols;
};

struct ThreadChunk {
  const char* begin;
  const char* end;
  long nrows = 0;                    // estimate in sampled mode
  // pass-2 storage
  std::vector<std::vector<double>> nums;           // [ncols][rows]
  std::vector<std::vector<int>> local_codes;       // [ncols][rows]
  std::vector<InternMap> interns;                  // per col
  std::vector<char> col_is_str;                    // pass-1 flags
  std::vector<char> col_has_num;                   // saw a numeric token
  std::vector<char> col_has_qempty;                // saw a quoted ""
};

}  // namespace

extern "C" {

void* csv_parse(const char* data, long len, char sep, int header,
                int nthreads) {
  auto* out = new Parsed();
  const char* limit = data + len;
  const char* body = data;
  SpecialTable st(sep);

  // header row
  std::vector<std::string> names;
  if (header) {
    body = scan_line(data, limit, sep, st.special,
                     [&](int, const char* p, long n, bool) {
      names.emplace_back(p, (size_t)n);
    });
  }
  if (body >= limit) {  // empty body
    for (auto& nm : names) {
      out->cols.emplace_back();
      out->cols.back().name = nm;
    }
    return out;
  }

  if (nthreads < 1) nthreads = 1;
  long blen = limit - body;
  const bool has_quote = memchr(body, '"', (size_t)blen) != nullptr;
  std::vector<ThreadChunk> chunks((size_t)nthreads);
  std::vector<const char*> starts((size_t)nthreads + 1);
  starts[0] = body;
  starts[(size_t)nthreads] = limit;
  if (has_quote) {
    // quote parity at each naive boundary = prefix quote count (mod 2)
    std::vector<long> qpfx((size_t)nthreads + 1, 0);
    for (int t = 0; t < nthreads; t++) {
      const char* s = body + blen * t / nthreads;
      const char* e = body + blen * (t + 1) / nthreads;
      long c = 0;
      while (s < e) {
        const char* hit = (const char*)memchr(s, '"', (size_t)(e - s));
        if (!hit) break;
        c++;
        s = hit + 1;
      }
      qpfx[(size_t)t + 1] = qpfx[(size_t)t] + c;
    }
    for (int t = 1; t < nthreads; t++)
      starts[(size_t)t] = next_record_start(body, limit, blen * t / nthreads,
                                            qpfx[(size_t)t] & 1);
  } else {
    for (int t = 1; t < nthreads; t++)
      starts[(size_t)t] = next_line_start(body, limit, blen * t / nthreads);
  }
  for (int t = 0; t < nthreads; t++) {
    chunks[t].begin = starts[(size_t)t];
    chunks[t].end = starts[(size_t)t + 1];
  }

  size_t ncols_guess = names.size();
  if (!ncols_guess) {
    // count fields of first line
    size_t c = 0;
    scan_line(body, limit, sep, st.special,
              [&](int, const char*, long, bool) { c++; });
    ncols_guess = c;
  }
  const size_t NC = ncols_guess;

  // ---- pass 1: type inference (+ row counts on the full-scan path).
  // Small files scan everything. Large files infer from SAMPLE windows
  // only — the reference's ParseSetup.guessSetup likewise guesses from
  // sample chunks, and a later non-numeric token in a numeric-guessed
  // column degrades to NA exactly as the reference's parse does. This
  // halves the big-file wall time (the full pass 1 re-parsed every
  // field once just to learn the types).
  // quoted bodies always get the exact full scan: the sample windows are
  // aligned with the quote-blind next_line_start and could open inside a
  // quoted field, mis-typing columns
  const long FULL_SCAN_LIMIT = 4 << 20;
  const bool sampled = blen > FULL_SCAN_LIMIT && !has_quote;
  std::vector<std::thread> pool;
  std::vector<char> is_str(NC, 0), has_num(NC, 0), has_qe(NC, 0);
  long total_rows = 0;
  double est_row_bytes = 64.0;

  if (!sampled) {
    for (int t = 0; t < nthreads; t++) {
      pool.emplace_back([&, t]() {
        ThreadChunk& ch = chunks[t];
        ch.col_is_str.assign(NC, 0);
        ch.col_has_num.assign(NC, 0);
        ch.col_has_qempty.assign(NC, 0);
        const char* p = ch.begin;
        while (p < ch.end) {
          if (*p == '\n') { p++; continue; }                    // blank line
          if (*p == '\r' && p + 1 < ch.end && p[1] == '\n') { p += 2; continue; }
          p = scan_line(p, limit, sep, st.special,
                        [&](int col, const char* fp, long fn, bool q) {
            if ((size_t)col >= NC) return;
            if (fn == 0) {
              if (q) ch.col_has_qempty[col] = 1;  // quoted "": string token
              return;
            }
            if (ch.col_is_str[col] || is_na_token(fp, fn)) return;
            double v;
            if (!parse_double(fp, fn, &v)) ch.col_is_str[col] = 1;
            else ch.col_has_num[col] = 1;
          });
          ch.nrows++;
        }
      });
    }
    for (auto& th : pool) th.join();
    pool.clear();
    for (auto& ch : chunks) {
      total_rows += ch.nrows;
      for (size_t j = 0; j < NC; j++) {
        is_str[j] |= ch.col_is_str[j];
        has_num[j] |= ch.col_has_num[j];
        has_qe[j] |= ch.col_has_qempty[j];
      }
    }
  } else {
    // 8 windows of 256KB spread across the body, aligned to line starts
    const int NW = 8;
    const long WIN = 256 << 10;
    long sampled_rows = 0, sampled_bytes = 0;
    for (int wi = 0; wi < NW; wi++) {
      const char* wbeg = next_line_start(body, limit,
                                         (blen - WIN) * wi / (NW - 1));
      const char* wend = wbeg + WIN < limit ? wbeg + WIN : limit;
      const char* p = wbeg;
      while (p < wend) {
        if (*p == '\n') { p++; continue; }
        if (*p == '\r' && p + 1 < wend && p[1] == '\n') { p += 2; continue; }
        const char* line0 = p;
        p = scan_line(p, limit, sep, st.special,
                      [&](int col, const char* fp, long fn, bool q) {
          if ((size_t)col >= NC) return;
          if (fn == 0) {
            if (q) has_qe[col] = 1;
            return;
          }
          if (is_str[col] || is_na_token(fp, fn)) return;
          double v;
          if (!parse_double(fp, fn, &v)) is_str[col] = 1;
          else has_num[col] = 1;
        });
        sampled_rows++;
        sampled_bytes += (long)(p - line0);
      }
    }
    if (sampled_rows > 0)
      est_row_bytes = (double)sampled_bytes / (double)sampled_rows;
    for (auto& ch : chunks)
      ch.nrows = (long)((double)(ch.end - ch.begin) / est_row_bytes) + 16;
  }
  // a column whose only non-missing tokens are quoted "" is a string
  // column with the {""} domain (PreviewParseWriter.guessType: all-same-
  // string domain → T_CAT); any numeric token keeps it numeric
  // (nnums >= nstrings tie goes numeric) and "" degrades to NA there
  for (size_t j = 0; j < NC; j++)
    if (!is_str[j] && has_qe[j] && !has_num[j]) is_str[j] = 1;

  // ---- pass 2: typed fill with per-thread interning ----
  for (int t = 0; t < nthreads; t++) {
    pool.emplace_back([&, t]() {
      ThreadChunk& ch = chunks[t];
      ch.nums.assign(NC, {});
      ch.local_codes.assign(NC, {});
      ch.interns.assign(NC, {});
      for (size_t j = 0; j < NC; j++) {
        if (is_str[j]) ch.local_codes[j].reserve((size_t)ch.nrows);
        else ch.nums[j].reserve((size_t)ch.nrows);
      }
      const char* p = ch.begin;
      long filled = 0;
      while (p < ch.end) {
        if (*p == '\n') { p++; continue; }                      // blank line
        if (*p == '\r' && p + 1 < ch.end && p[1] == '\n') { p += 2; continue; }
        long before = filled;
        p = scan_line(p, limit, sep, st.special,
                      [&](int col, const char* fp, long fn, bool q) {
          if ((size_t)col >= NC) return;
          if (is_str[col]) {
            // quoted "" is the empty STRING, bare empty is missing
            if (is_na_token(fp, fn) && !(fn == 0 && q)) {
              ch.local_codes[col].push_back(-1);
              return;
            }
            ch.local_codes[col].push_back(ch.interns[col].intern(fp, fn));
          } else {
            double v;
            if (is_na_token(fp, fn) || !parse_double(fp, fn, &v))
              v = NAN;
            ch.nums[col].push_back(v);
          }
        });
        filled = before + 1;
        // short rows: pad missing trailing fields with NA
        for (size_t j = 0; j < NC; j++) {
          size_t want = (size_t)filled;
          if (is_str[j]) while (ch.local_codes[j].size() < want)
            ch.local_codes[j].push_back(-1);
          else while (ch.nums[j].size() < want)
            ch.nums[j].push_back(NAN);
        }
      }
      ch.nrows = filled;              // exact count (sampled mode needs it)
    });
  }
  for (auto& th : pool) th.join();

  // ---- merge: global sorted domains + code remap (the ParseDataset
  //      domain-unification step) ----
  total_rows = 0;
  for (auto& ch : chunks) total_rows += ch.nrows;
  out->nrows = total_rows;
  out->cols.resize(NC);
  for (size_t j = 0; j < NC; j++) {
    ColData& cd = out->cols[j];
    cd.name = j < names.size() ? names[j] : ("C" + std::to_string(j + 1));
    cd.type = is_str[j] ? 1 : 0;
    if (!is_str[j]) {
      cd.nums.reserve((size_t)total_rows);
      for (auto& ch : chunks)
        cd.nums.insert(cd.nums.end(), ch.nums[j].begin(), ch.nums[j].end());
    } else {
      std::vector<std::string> all;
      for (auto& ch : chunks)
        all.insert(all.end(), ch.interns[j].levels.begin(),
                   ch.interns[j].levels.end());
      std::sort(all.begin(), all.end());
      all.erase(std::unique(all.begin(), all.end()), all.end());
      std::unordered_map<std::string, int> global;
      global.reserve(all.size() * 2);
      for (size_t k = 0; k < all.size(); k++) global[all[k]] = (int)k;
      cd.domain = std::move(all);
      cd.codes.reserve((size_t)total_rows);
      for (auto& ch : chunks) {
        std::vector<int> remap(ch.interns[j].levels.size());
        for (size_t k = 0; k < remap.size(); k++)
          remap[k] = global[ch.interns[j].levels[k]];
        for (int c : ch.local_codes[j])
          cd.codes.push_back(c < 0 ? -1 : remap[(size_t)c]);
      }
    }
  }
  return out;
}

long csv_nrows(void* h) { return ((Parsed*)h)->nrows; }
int csv_ncols(void* h) { return (int)((Parsed*)h)->cols.size(); }
const char* csv_colname(void* h, int j) {
  return ((Parsed*)h)->cols[(size_t)j].name.c_str();
}
int csv_coltype(void* h, int j) { return ((Parsed*)h)->cols[(size_t)j].type; }
void csv_numeric(void* h, int j, double* outp) {
  auto& v = ((Parsed*)h)->cols[(size_t)j].nums;
  memcpy(outp, v.data(), v.size() * sizeof(double));
}
void csv_codes(void* h, int j, int* outp) {
  auto& v = ((Parsed*)h)->cols[(size_t)j].codes;
  memcpy(outp, v.data(), v.size() * sizeof(int));
}
int csv_card(void* h, int j) {
  return (int)((Parsed*)h)->cols[(size_t)j].domain.size();
}
const char* csv_level(void* h, int j, int k) {
  return ((Parsed*)h)->cols[(size_t)j].domain[(size_t)k].c_str();
}
void csv_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
