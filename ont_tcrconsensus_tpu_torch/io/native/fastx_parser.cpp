// Fast FASTQ/FASTA parser: the native host-IO component of the data plane.
//
// Decodes records straight into the dense uint8 code / Phred arrays the
// device batcher consumes, skipping Python string round-trips. Loaded via
// ctypes (io/native/__init__.py, which builds it at first use into
// build/torch_native/); the pure-Python parsers in io/fastx.py (strict) and
// io/validate.py (tolerant) have the same semantics and are the fallback
// where g++ or zlib is missing.
//
// Build: g++ -O3 -Wall -Wextra -shared -fPIC fastx_parser.cpp -lz -o libfastx.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Canonical malformation reasons. These exact strings are mirrored by the
// pure-Python tolerant parser (io/validate.py) — the differential ingest
// fuzzer asserts rejection-for-rejection agreement on them, so any edit
// here must be made in both places.
const char* kReasonGzip = "truncated or corrupt gzip stream";
const char* kReasonNotFastx = "not FASTA/FASTQ";
const char* kReasonBadHeader = "malformed FASTQ header";
const char* kReasonMissingPlus = "malformed FASTQ record (missing +)";
const char* kReasonLenMismatch = "FASTQ qual length != seq length";
const char* kReasonBadQual = "quality below Phred-33 '!'";
const char* kReasonTruncated = "truncated FASTQ record";

struct BadRec {
  int64_t offset;      // absolute decompressed byte offset of the bad region
  std::string reason;  // one of the kReason* strings above
  std::string raw;     // the raw bytes of the bad region (quarantine payload)
};

struct ParsedFile {
  // flat record storage
  std::vector<uint8_t> codes;      // dense codes, concatenated
  std::vector<uint8_t> quals;      // phred (0-based), concatenated; empty for FASTA
  std::vector<int64_t> offsets;    // per-record start into codes/quals (n+1 entries)
  std::vector<int32_t> lengths;    // per-record length
  std::string names;               // '\n'-joined full headers
  bool has_qual = false;
  std::string error;
  std::vector<BadRec> bad;         // tolerant mode: quarantined regions
};

void add_bad(ParsedFile* out, int64_t off, const char* reason,
             const std::string& data, size_t a, size_t b) {
  BadRec r;
  r.offset = off;
  r.reason = reason;
  r.raw = data.substr(a, b - a);
  out->bad.push_back(std::move(r));
}

// base -> dense code (A=0 C=1 G=2 T=3 N/other=4), matching ops/encode.py
const uint8_t* code_lut() {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 4, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = lut['U'] = lut['u'] = 3;
    init = true;
  }
  return lut;
}

// A truncated gzip stream makes gzread return 0 (like clean EOF) with the
// error only visible through gzerror (Z_BUF_ERROR "unexpected end of
// file") — checking the return value alone silently accepts truncated
// input (the ingest fuzzer caught exactly that in the original read_all).
bool gz_stream_bad(gzFile fh, int n) {
  if (n < 0) return true;
  int errnum = 0;
  gzerror(fh, &errnum);
  return errnum < 0;
}

bool read_all(const char* path, std::string* out, std::string* err) {
  gzFile fh = gzopen(path, "rb");  // transparently handles plain files too
  if (!fh) {
    *err = "cannot open file";
    return false;
  }
  char buf[1 << 16];
  int n;
  while ((n = gzread(fh, buf, sizeof(buf))) > 0) out->append(buf, n);
  bool ok = !gz_stream_bad(fh, n);
  if (!ok) *err = kReasonGzip;
  gzclose(fh);
  return ok;
}

// Tolerant whole-file read: a mid-stream gzip truncation/corruption keeps
// the decodable prefix and sets *gz_error instead of failing the file.
bool read_all_tol(const char* path, std::string* out, std::string* err,
                  bool* gz_error) {
  gzFile fh = gzopen(path, "rb");
  if (!fh) {
    *err = "cannot open file";
    return false;
  }
  char buf[1 << 16];
  int n;
  while ((n = gzread(fh, buf, sizeof(buf))) > 0) out->append(buf, n);
  *gz_error = gz_stream_bad(fh, n);
  gzclose(fh);
  return true;
}

// next line [start, end) exclusive of newline; returns false at EOF
bool next_line(const std::string& s, size_t* pos, size_t* start, size_t* end) {
  if (*pos >= s.size()) return false;
  *start = *pos;
  size_t nl = s.find('\n', *pos);
  if (nl == std::string::npos) {
    *end = s.size();
    *pos = s.size();
  } else {
    *end = nl;
    *pos = nl + 1;
  }
  if (*end > *start && s[*end - 1] == '\r') --*end;
  return true;
}

// next line, also reporting whether the line is TERMINATED (a '\n' was
// seen) — a streaming chunk may end mid-line, and an unterminated line is
// only trustworthy at EOF
bool next_line_t(const std::string& s, size_t* pos, size_t* start, size_t* end,
                 bool* terminated) {
  if (*pos >= s.size()) return false;
  *start = *pos;
  size_t nl = s.find('\n', *pos);
  if (nl == std::string::npos) {
    *end = s.size();
    *pos = s.size();
    *terminated = false;
  } else {
    *end = nl;
    *pos = nl + 1;
    *terminated = true;
  }
  if (*end > *start && s[*end - 1] == '\r') --*end;
  return true;
}

void emit_record(ParsedFile* out, const std::string& data, size_t ha, size_t hb,
                 const std::string& seq) {
  const uint8_t* lut = code_lut();
  for (char c : seq) out->codes.push_back(lut[(uint8_t)c]);
  out->lengths.push_back((int32_t)seq.size());
  out->offsets.push_back((int64_t)out->codes.size());
  out->names.append(data, ha, hb - ha);
  out->names += '\n';
}

// Incremental parse: consume COMPLETE records from data into out, set
// *consumed to the byte offset after the last fully-parsed record (the
// caller carries the tail into the next chunk). When at_eof, a trailing
// partial record is an error (FASTQ) or final record (FASTA) exactly like
// the whole-file parser.
bool parse_stream_buffer(const std::string& data, bool at_eof, char* kind_io,
                         ParsedFile* out, size_t* consumed) {
  const uint8_t* lut = code_lut();
  size_t pos = 0, a, b;
  bool term;
  *consumed = 0;
  out->offsets.push_back(0);
  // skip leading blank lines
  size_t scan = 0;
  bool any = false;
  while (next_line_t(data, &scan, &a, &b, &term)) {
    if (a == b) { *consumed = scan; continue; }
    any = true;
    break;
  }
  if (!any) { *consumed = data.size(); return true; }  // blanks only
  if (*kind_io == 0) {
    char kind = data[a];
    if (kind != '@' && kind != '>') {
      out->error = "not FASTA/FASTQ";
      return false;
    }
    *kind_io = kind;
  }
  out->has_qual = *kind_io == '@';
  pos = a;  // first record header start

  if (*kind_io == '>') {
    std::string seq;
    size_t ha = 0, hb = 0;
    size_t rec_start = pos;
    bool have = false;
    while (true) {
      size_t line_pos = pos;
      if (!next_line_t(data, &pos, &a, &b, &term)) break;
      if (a == b) continue;
      if (data[a] == '>') {
        if (have) {
          emit_record(out, data, ha, hb, seq);
          *consumed = line_pos;
        }
        rec_start = line_pos;
        if (!term && !at_eof) { have = false; break; }  // partial header
        ha = a + 1;
        hb = b;
        seq.clear();
        have = true;
      } else {
        if (!term && !at_eof) break;  // possibly split sequence line
        seq.append(data, a, b - a);
      }
    }
    if (at_eof) {
      if (have) emit_record(out, data, ha, hb, seq);
      *consumed = data.size();
    }
    // non-EOF: the record from rec_start onward stays in the carry (a
    // FASTA record is only known complete at the next header/EOF)
    (void)rec_start;
    return true;
  }

  // FASTQ: strict 4-line records, blank lines tolerated between records
  while (true) {
    size_t rec_start;
    bool got = false;
    while (next_line_t(data, &pos, &a, &b, &term)) {
      if (a == b) continue;
      rec_start = a;
      got = true;
      break;
    }
    if (!got) { *consumed = data.size(); break; }
    if (data[a] != '@') {
      out->error = "malformed FASTQ header";
      return false;
    }
    if (!term && !at_eof) { *consumed = rec_start; break; }
    size_t ha = a + 1, hb = b;
    size_t sa, sb, pa, pb, qa, qb;
    bool t2, t3, t4;
    if (!next_line_t(data, &pos, &sa, &sb, &t2) ||
        !next_line_t(data, &pos, &pa, &pb, &t3) ||
        !next_line_t(data, &pos, &qa, &qb, &t4)) {
      if (at_eof) {
        out->error = "truncated FASTQ record";
        return false;
      }
      *consumed = rec_start;
      break;
    }
    if (!at_eof && !t4) { *consumed = rec_start; break; }  // quals may grow
    if (pa == pb || data[pa] != '+') {
      out->error = "malformed FASTQ record (missing +)";
      return false;
    }
    size_t slen = sb - sa, qlen = qb - qa;
    if (slen != qlen) {
      out->error = "FASTQ qual length != seq length";
      return false;
    }
    for (size_t i = sa; i < sb; ++i) out->codes.push_back(lut[(uint8_t)data[i]]);
    for (size_t i = qa; i < qb; ++i) {
      uint8_t q = (uint8_t)data[i];
      if (q < 33) {
        out->error = "quality below Phred-33 '!'";
        return false;
      }
      out->quals.push_back(q - 33);
    }
    out->lengths.push_back((int32_t)slen);
    out->offsets.push_back((int64_t)out->codes.size());
    out->names.append(data, ha, hb - ha);
    out->names += '\n';
    *consumed = pos;
  }
  return true;
}

// --- tolerant (quarantine-mode) parsing ----------------------------------
//
// Instead of failing the whole buffer on the first malformed record, the
// tolerant parser records the bad region (offset + reason + raw bytes) and
// resynchronizes at the next plausible FASTQ record start. The resync
// candidate rule — a line starting with '@' whose line+2 starts with '+' —
// is what keeps a quality line that happens to begin with '@' from being
// mistaken for a header. The pure-Python twin in io/validate.py implements
// the SAME algorithm; the differential fuzzer pins them together.

// Find the next resync candidate at/after byte `from`. Returns true with
// *cand = candidate line start. On false: *incomplete=true means the scan
// hit possibly-growing data (!at_eof) and the caller must carry; false
// means no candidate exists up to EOF.
bool find_candidate(const std::string& data, size_t from, bool at_eof,
                    size_t* cand, bool* incomplete) {
  size_t pos = from, a, b;
  bool term;
  *incomplete = false;
  while (true) {
    size_t line_start = pos;
    if (!next_line_t(data, &pos, &a, &b, &term)) {
      *incomplete = !at_eof;
      return false;
    }
    if (!term && !at_eof) {  // line may still grow; first char of a
      // nonempty line is fixed, but its role depends on lines after it
      *incomplete = true;
      return false;
    }
    if (b > a && data[a] == '@') {
      size_t p2 = pos, a2, b2, a3, b3;
      bool t2, t3;
      if (!next_line_t(data, &p2, &a2, &b2, &t2)) {
        if (!at_eof) { *incomplete = true; return false; }
        continue;  // no seq line at EOF: not a candidate
      }
      if (!t2 && !at_eof) { *incomplete = true; return false; }
      if (!next_line_t(data, &p2, &a3, &b3, &t3)) {
        if (!at_eof) { *incomplete = true; return false; }
        continue;  // no plus line at EOF: not a candidate
      }
      if (a3 == b3 && !t3 && !at_eof) { *incomplete = true; return false; }
      if (b3 > a3 && data[a3] == '+') {
        *cand = line_start;
        return true;
      }
      // not a candidate; keep scanning from the line after the '@' line
    }
  }
}

// Tolerant incremental parse: complete records and fully-resolved bad
// regions are consumed; `*consumed` stops before anything whose extent is
// still ambiguous (the caller carries it into the next chunk). `base` is
// the absolute decompressed offset of data[0] (bad offsets are absolute).
bool parse_stream_tol(const std::string& data, bool at_eof, char* kind_io,
                      ParsedFile* out, size_t* consumed, int64_t base) {
  const uint8_t* lut = code_lut();
  size_t pos = 0, a, b;
  bool term;
  *consumed = 0;
  out->offsets.push_back(0);

  // kind detection: skip blanks, quarantine any leading junk before the
  // first line starting with '@' or '>'
  while (*kind_io == 0) {
    size_t line_start = pos;
    if (!next_line_t(data, &pos, &a, &b, &term)) {
      *consumed = data.size();  // empty / blanks only
      return true;
    }
    if (a == b) {
      if (!term && !at_eof) { *consumed = line_start; return true; }
      *consumed = pos;
      continue;
    }
    if (data[a] == '@' || data[a] == '>') {
      *kind_io = data[a];
      pos = line_start;  // reparse this line below
      break;
    }
    // junk prefix: scan for the first record-start line
    size_t scan = pos, ja, jb;
    bool jterm;
    size_t junk_end = 0;
    bool found = false;
    while (next_line_t(data, &scan, &ja, &jb, &jterm)) {
      size_t jstart = ja;
      if (ja == jb) continue;
      if (data[ja] == '@' || data[ja] == '>') {
        junk_end = jstart;
        found = true;
        break;
      }
      (void)jterm;
    }
    if (!found) {
      if (!at_eof) { *consumed = line_start; return true; }  // junk may grow
      add_bad(out, base + line_start, kReasonNotFastx, data, line_start,
              data.size());
      *consumed = data.size();
      return true;
    }
    add_bad(out, base + line_start, kReasonNotFastx, data, line_start,
            junk_end);
    *kind_io = data[junk_end];
    pos = junk_end;
    *consumed = junk_end;
    break;
  }
  out->has_qual = *kind_io == '@';

  if (*kind_io == '>') {
    // FASTA: the only malformation class is pre-kind junk (handled above)
    // — every non-'>' line is sequence, and a truncated final record is a
    // final record. Mirrors parse_stream_buffer's '>' branch.
    std::string seq;
    size_t ha = 0, hb = 0;
    bool have = false;
    while (true) {
      size_t line_pos = pos;
      if (!next_line_t(data, &pos, &a, &b, &term)) break;
      if (a == b) continue;
      if (data[a] == '>') {
        if (have) {
          emit_record(out, data, ha, hb, seq);
          *consumed = line_pos;
        }
        if (!term && !at_eof) { have = false; break; }  // partial header
        ha = a + 1;
        hb = b;
        seq.clear();
        have = true;
      } else {
        if (!term && !at_eof) break;  // possibly split sequence line
        seq.append(data, a, b - a);
      }
    }
    if (at_eof) {
      if (have) emit_record(out, data, ha, hb, seq);
      *consumed = data.size();
    }
    return true;
  }

  // FASTQ
  while (true) {
    size_t rec_start = 0;
    bool got = false;
    while (true) {
      size_t line_start = pos;
      if (!next_line_t(data, &pos, &a, &b, &term)) break;
      if (a == b) {
        if (!term && !at_eof) { *consumed = line_start; return true; }
        *consumed = pos;
        continue;
      }
      rec_start = line_start;
      got = true;
      break;
    }
    if (!got) { *consumed = data.size(); return true; }
    if (data[a] != '@') {
      size_t cand;
      bool inc;
      if (find_candidate(data, rec_start, at_eof, &cand, &inc)) {
        add_bad(out, base + rec_start, kReasonBadHeader, data, rec_start, cand);
        pos = cand;
        *consumed = cand;
        continue;
      }
      if (inc) { *consumed = rec_start; return true; }
      add_bad(out, base + rec_start, kReasonBadHeader, data, rec_start,
              data.size());
      *consumed = data.size();
      return true;
    }
    if (!term && !at_eof) { *consumed = rec_start; return true; }
    size_t ha = a + 1, hb = b;
    size_t sa, sb, pa, pb, qa, qb;
    bool t2, t3, t4;
    if (!next_line_t(data, &pos, &sa, &sb, &t2) ||
        !next_line_t(data, &pos, &pa, &pb, &t3) ||
        !next_line_t(data, &pos, &qa, &qb, &t4)) {
      if (at_eof) {
        add_bad(out, base + rec_start, kReasonTruncated, data, rec_start,
                data.size());
        *consumed = data.size();
        return true;
      }
      *consumed = rec_start;
      return true;
    }
    if (pa == pb || data[pa] != '+') {
      size_t cand;
      bool inc;
      if (find_candidate(data, sa, at_eof, &cand, &inc)) {
        add_bad(out, base + rec_start, kReasonMissingPlus, data, rec_start,
                cand);
        pos = cand;
        *consumed = cand;
        continue;
      }
      if (inc) { *consumed = rec_start; return true; }
      add_bad(out, base + rec_start, kReasonMissingPlus, data, rec_start,
              data.size());
      *consumed = data.size();
      return true;
    }
    if (!t4 && !at_eof) { *consumed = rec_start; return true; }  // quals may grow
    size_t rec_end = pos;
    if (sb - sa != qb - qa) {
      add_bad(out, base + rec_start, kReasonLenMismatch, data, rec_start,
              rec_end);
      *consumed = rec_end;
      continue;
    }
    bool badq = false;
    for (size_t i = qa; i < qb; ++i) {
      if ((uint8_t)data[i] < 33) { badq = true; break; }
    }
    if (badq) {
      add_bad(out, base + rec_start, kReasonBadQual, data, rec_start, rec_end);
      *consumed = rec_end;
      continue;
    }
    for (size_t i = sa; i < sb; ++i) out->codes.push_back(lut[(uint8_t)data[i]]);
    for (size_t i = qa; i < qb; ++i) out->quals.push_back((uint8_t)data[i] - 33);
    out->lengths.push_back((int32_t)(sb - sa));
    out->offsets.push_back((int64_t)out->codes.size());
    out->names.append(data, ha, hb - ha);
    out->names += '\n';
    *consumed = rec_end;
  }
}

bool parse_buffer(const std::string& data, ParsedFile* out) {
  const uint8_t* lut = code_lut();
  size_t pos = 0, a = 0, b = 0;
  out->offsets.push_back(0);
  // skip leading blank lines; an empty/blank-only buffer must return
  // BEFORE the data[a] kind probe below (a/b were read uninitialized on
  // empty input before — an out-of-bounds probe the ingest fuzzer caught)
  bool any = false;
  while (next_line(data, &pos, &a, &b)) {
    if (a == b) continue;
    any = true;
    break;
  }
  if (!any) return true;  // empty file / blank lines only
  char kind = data[a];
  if (kind != '@' && kind != '>') {
    out->error = "not FASTA/FASTQ";
    return false;
  }
  out->has_qual = kind == '@';
  // rewind to the first record line
  size_t first = a;
  pos = first;
  if (kind == '>') {
    std::string seq;
    std::string name;
    bool have = false;
    while (next_line(data, &pos, &a, &b)) {
      if (a == b) continue;
      if (data[a] == '>') {
        if (have) {
          for (char c : seq) out->codes.push_back(lut[(uint8_t)c]);
          out->lengths.push_back((int32_t)seq.size());
          out->offsets.push_back((int64_t)out->codes.size());
          out->names += name;
          out->names += '\n';
        }
        name.assign(data, a + 1, b - a - 1);
        seq.clear();
        have = true;
      } else {
        seq.append(data, a, b - a);
      }
    }
    if (have) {
      for (char c : seq) out->codes.push_back(lut[(uint8_t)c]);
      out->lengths.push_back((int32_t)seq.size());
      out->offsets.push_back((int64_t)out->codes.size());
      out->names += name;
      out->names += '\n';
    }
    return true;
  }
  // FASTQ: strict 4-line records, blank lines tolerated between records
  while (true) {
    // header
    bool got = false;
    while (next_line(data, &pos, &a, &b)) {
      if (a == b) continue;
      got = true;
      break;
    }
    if (!got) break;
    if (data[a] != '@') {
      out->error = "malformed FASTQ header";
      return false;
    }
    size_t ha = a + 1, hb = b;
    size_t sa, sb, pa, pb, qa, qb;
    if (!next_line(data, &pos, &sa, &sb) || !next_line(data, &pos, &pa, &pb) ||
        !next_line(data, &pos, &qa, &qb)) {
      out->error = "truncated FASTQ record";
      return false;
    }
    if (pa == pb || data[pa] != '+') {
      out->error = "malformed FASTQ record (missing +)";
      return false;
    }
    size_t slen = sb - sa, qlen = qb - qa;
    if (slen != qlen) {
      out->error = "FASTQ qual length != seq length";
      return false;
    }
    for (size_t i = sa; i < sb; ++i) out->codes.push_back(lut[(uint8_t)data[i]]);
    for (size_t i = qa; i < qb; ++i) {
      uint8_t q = (uint8_t)data[i];
      if (q < 33) {
        out->error = "quality below Phred-33 '!'";
        return false;
      }
      out->quals.push_back(q - 33);
    }
    out->lengths.push_back((int32_t)slen);
    out->offsets.push_back((int64_t)out->codes.size());
    out->names.append(data, ha, hb - ha);
    out->names += '\n';
  }
  return true;
}

}  // namespace

extern "C" {

// Opaque handle API: parse once, copy out, free.
void* fastx_parse(const char* path) {
  auto* out = new ParsedFile();
  std::string data;
  if (!read_all(path, &data, &out->error)) return out;
  if (!parse_buffer(data, out)) {
    out->codes.clear();
    out->quals.clear();
    out->lengths.clear();
    out->offsets.assign(1, 0);
    out->names.clear();
  }
  return out;
}

// Tolerant whole-file parse: malformed records become bad entries (offset +
// reason + raw bytes) instead of failing the file; a truncated/corrupt gzip
// stream parses the decodable prefix and records a gzip bad entry at its
// end. Only "cannot open file" still sets the handle error.
void* fastx_parse2(const char* path, int tolerant) {
  if (!tolerant) return fastx_parse(path);
  auto* out = new ParsedFile();
  std::string data;
  bool gz_error = false;
  if (!read_all_tol(path, &data, &out->error, &gz_error)) return out;
  char kind = 0;
  size_t consumed = 0;
  parse_stream_tol(data, /*at_eof=*/true, &kind, out, &consumed, 0);
  if (gz_error) {
    BadRec r;
    r.offset = (int64_t)data.size();
    r.reason = kReasonGzip;
    out->bad.push_back(std::move(r));
  }
  return out;
}

int64_t fastx_num_bad(void* h) { return (int64_t)((ParsedFile*)h)->bad.size(); }

int64_t fastx_bad_offset(void* h, int64_t i) {
  return ((ParsedFile*)h)->bad[i].offset;
}

const char* fastx_bad_reason(void* h, int64_t i) {
  return ((ParsedFile*)h)->bad[i].reason.c_str();
}

int64_t fastx_bad_raw_size(void* h, int64_t i) {
  return (int64_t)((ParsedFile*)h)->bad[i].raw.size();
}

void fastx_bad_raw_copy(void* h, int64_t i, char* buf) {
  const std::string& raw = ((ParsedFile*)h)->bad[i].raw;
  if (!raw.empty()) memcpy(buf, raw.data(), raw.size());
}

const char* fastx_error(void* h) {
  auto* p = (ParsedFile*)h;
  return p->error.empty() ? nullptr : p->error.c_str();
}

int64_t fastx_num_records(void* h) { return (int64_t)((ParsedFile*)h)->lengths.size(); }
int64_t fastx_total_bases(void* h) { return (int64_t)((ParsedFile*)h)->codes.size(); }
int64_t fastx_names_size(void* h) { return (int64_t)((ParsedFile*)h)->names.size(); }
int fastx_has_qual(void* h) { return ((ParsedFile*)h)->has_qual ? 1 : 0; }

void fastx_copy(void* h, uint8_t* codes, uint8_t* quals, int32_t* lengths,
                int64_t* offsets, char* names) {
  auto* p = (ParsedFile*)h;
  if (!p->codes.empty()) memcpy(codes, p->codes.data(), p->codes.size());
  if (quals && !p->quals.empty()) memcpy(quals, p->quals.data(), p->quals.size());
  if (!p->lengths.empty())
    memcpy(lengths, p->lengths.data(), p->lengths.size() * sizeof(int32_t));
  memcpy(offsets, p->offsets.data(), p->offsets.size() * sizeof(int64_t));
  if (!p->names.empty()) memcpy(names, p->names.data(), p->names.size());
}

void fastx_free(void* h) { delete (ParsedFile*)h; }

// --- streaming API: O(chunk) host memory for lane-scale files ------------
//
// fastx_open -> repeated fastx_next_chunk(target_bases) -> fastx_close.
// Each chunk is a ParsedFile handle consumed with the same accessors as
// fastx_parse; nullptr means clean EOF. A 100+ GB lane (SURVEY §7
// hard-part 5) streams through a fixed-size carry buffer instead of being
// materialized whole.

struct FastxStream {
  gzFile fh = nullptr;
  std::string carry;
  bool eof = false;
  char kind = 0;  // '@' or '>', discovered on first chunk
  std::string error;
  bool tolerant = false;
  bool gz_pending = false;  // tolerant: gzip error seen, event not yet emitted
  int64_t base = 0;         // absolute decompressed offset of carry[0]
};

void* fastx_open(const char* path) {
  auto* s = new FastxStream();
  s->fh = gzopen(path, "rb");
  if (!s->fh) s->error = "cannot open file";
  return s;
}

void* fastx_open2(const char* path, int tolerant) {
  auto* s = (FastxStream*)fastx_open(path);
  s->tolerant = tolerant != 0;
  return s;
}

const char* fastx_stream_error(void* h) {
  auto* s = (FastxStream*)h;
  return s->error.empty() ? nullptr : s->error.c_str();
}

void* fastx_next_chunk(void* h, int64_t target_bases) {
  auto* s = (FastxStream*)h;
  if (!s->error.empty()) return nullptr;
  if (s->eof && s->carry.empty() && !s->gz_pending) return nullptr;
  // FASTQ carries ~2 bytes per base (seq+qual) plus headers; aim the raw
  // buffer at ~2.5x the requested decoded bases. If no complete record
  // fits (one record larger than the buffer), double and retry — progress
  // is guaranteed, so the loop terminates.
  size_t want = (size_t)(target_bases > 0 ? target_bases : (16 << 20)) * 5 / 2;
  char buf[1 << 16];
  ParsedFile* out = nullptr;
  while (true) {
    while (!s->eof && s->carry.size() < want) {
      int n = gzread(s->fh, buf, sizeof(buf));
      if (n > 0) {
        s->carry.append(buf, n);
      } else if (!gz_stream_bad(s->fh, n)) {
        s->eof = true;
      } else if (s->tolerant) {
        // keep the decodable prefix; the gzip event is emitted with the
        // final chunk once the carry fully drains
        s->eof = true;
        s->gz_pending = true;
      } else {
        s->error = kReasonGzip;
        return nullptr;
      }
    }
    out = new ParsedFile();
    size_t consumed = 0;
    bool ok = s->tolerant
                  ? parse_stream_tol(s->carry, s->eof, &s->kind, out,
                                     &consumed, s->base)
                  : parse_stream_buffer(s->carry, s->eof, &s->kind, out,
                                        &consumed);
    if (!ok) {
      s->error = out->error;  // surface via the chunk handle too
      return out;
    }
    s->carry.erase(0, consumed);
    s->base += (int64_t)consumed;
    if (!out->lengths.empty() || !out->bad.empty() || s->eof) break;
    delete out;
    want *= 2;
  }
  if (!s->tolerant && out->lengths.empty() && s->eof && !s->carry.empty()) {
    // EOF but unconsumed bytes and no records: malformed tail
    out->error = "trailing unparseable data";
    s->error = out->error;
    return out;
  }
  if (s->gz_pending && s->eof && s->carry.empty()) {
    BadRec r;
    r.offset = s->base;
    r.reason = kReasonGzip;
    out->bad.push_back(std::move(r));
    s->gz_pending = false;
  }
  if (out->lengths.empty() && out->bad.empty() && s->eof) {
    delete out;
    return nullptr;
  }
  return out;
}

void fastx_close(void* h) {
  auto* s = (FastxStream*)h;
  if (s->fh) gzclose(s->fh);
  delete s;
}

}  // extern "C"
