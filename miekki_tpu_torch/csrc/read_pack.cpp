// Pack a FASTQ or FASTA read set into separator-joined rows in one pass
// (host code; built with the host C++ compiler by
// miekki_tpu_torch/io/read_pack.py, not by nvcc).
//
// rp_open(path, &err) opens a plain or gzip file (gzip by its magic bytes;
// concatenated members are one stream).  Each rp_next(h, chunk_bytes, k,
// flat, &rows, &text_bytes) reads the next chunk of whole records, about
// chunk_bytes of text unless one record is longer, and walks it once: each
// record is checked and its sequence encoded in place, to the front of the
// text (every byte it reads lies ahead of where it writes).  rp_fill(h, out,
// out_len, reads, bases) then lays the codes out in out, the chunk's stream:
//   record codes joined by k - 1 INVALID separators, INVALID to the end,
// rows * flat + k - 1 bytes, whose rows are out[r * flat, r * flat + flat +
// k - 1): rows = ceil((bases + (k - 1) * (records - 1)) / flat), 0 for a
// chunk with no bases.  reads[r] counts the records whose first base lies in
// row r's first flat bytes (a record with no bases at the very end counts in
// the last row), bases[r] the bases there.
//
// Records and errors are those of native/miekki_io.cpp's stream reader:
// the format is the first byte's ('@' FASTQ, '>' FASTA); A/C/G/T in either
// case encode as 0/1/2/3, every other byte as 4 (INVALID); one '\r' ending a
// sequence or quality line is dropped.  FASTQ: blank lines between records
// are skipped, each record is a '@' line, its sequence line, a '+' line and
// a quality line as long as the sequence.  FASTA: a '>' line starts a
// record, its other lines are joined.  Names are not kept.
//
// Return codes (rp_open's err, rp_next's result): the file cannot be opened
// or a read fails (-1), gzip data is corrupt or ends inside a member (-2),
// the file is empty or starts with another byte (-3), a FASTQ record is
// malformed (-4), memory runs out (-5).  rp_next returns 1 for a chunk
// (whose rows may be 0) and 0 at the file's end; rp_fill returns 0, or -1
// for a chunk with no rows or an out_len other than its stream's.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

namespace {

constexpr uint8_t kInvalid = 4;
constexpr size_t kReadStep = 1 << 20;

enum : int32_t {
  kErrOpen = -1,
  kErrGzip = -2,
  kErrFormat = -3,
  kErrFastq = -4,
  kErrAlloc = -5,
};

// A/C/G/T (either case) to 0/1/2/3, anything else to 4, without a table or
// a bit test so that the loop over a line vectorizes: b & 0xDF folds only
// a-z onto A-Z; (c >> 1) & 3 reads A C T G as 0 1 2 3, which x ^ (x >> 1)
// reorders, and a byte is a base only if it is the one of its x.
inline uint8_t encode_base(uint8_t b) {
  const uint8_t c = b & 0xDF;
  const uint8_t x = (c >> 1) & 3;
  const uint8_t base = static_cast<uint8_t>('A' + (x == 1) * ('C' - 'A') +
                                            (x == 2) * ('T' - 'A') + (x == 3) * ('G' - 'A'));
  return c == base ? static_cast<uint8_t>(x ^ (x >> 1)) : kInvalid;
}

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
  const void* nl = std::memchr(p, '\n', static_cast<size_t>(end - p));
  return nl ? static_cast<const uint8_t*>(nl) : end;
}

inline const uint8_t* strip_cr(const uint8_t* p, const uint8_t* e) {
  return e > p && e[-1] == '\r' ? e - 1 : e;
}

struct Pack {
  int fd = -1;
  bool gz = false;
  bool in_member = false;  // inflate is inside a gzip member
  bool eof = false;        // all text has been read
  z_stream zs{};
  std::vector<uint8_t> in;  // compressed bytes
  size_t in_pos = 0, in_len = 0;
  uint8_t* text = nullptr;  // text[0, size): the chunk, then what follows it
  size_t size = 0, cap = 0;
  size_t cut = 0;  // the chunk's text bytes; its codes are text[0, bases)
  int fmt = 0;     // '@' or '>' once seen
  uint64_t bases = 0;
  std::vector<uint64_t> lens;  // the chunk's record lengths
  uint64_t gap = 0, flat = 1, rows = 0;
};

bool reserve(Pack* p, size_t want) {
  if (want <= p->cap) return true;
  size_t cap = p->cap ? p->cap : kReadStep;
  while (cap < want) cap *= 2;
  void* t = std::realloc(p->text, cap);
  if (!t) return false;
  p->text = static_cast<uint8_t*>(t);
  p->cap = cap;
  return true;
}

// read(2) that retries on EINTR: bytes read, 0 at the end, -1 on a fault.
ssize_t read_some(int fd, uint8_t* dst, size_t n) {
  for (;;) {
    const ssize_t r = ::read(fd, dst, n);
    if (r >= 0 || errno != EINTR) return r;
  }
}

// Append text until size >= want or the file ends.  A read fault, or gzip
// data that is corrupt or ends inside a member, is an error, never a short
// stream.
int32_t refill(Pack* p, size_t want) {
  if (!reserve(p, want)) return kErrAlloc;
  while (p->size < want && !p->eof) {
    uint8_t* dst = p->text + p->size;
    const size_t room = want - p->size;
    if (!p->gz) {
      const ssize_t r = read_some(p->fd, dst, room);
      if (r < 0) return kErrOpen;
      p->eof = r == 0;
      p->size += static_cast<size_t>(r);
      continue;
    }
    if (p->in_pos == p->in_len) {
      const ssize_t r = read_some(p->fd, p->in.data(), p->in.size());
      if (r < 0) return kErrOpen;
      if (r == 0) {
        if (p->in_member) return kErrGzip;
        p->eof = true;
        continue;
      }
      p->in_pos = 0;
      p->in_len = static_cast<size_t>(r);
    }
    p->zs.next_in = p->in.data() + p->in_pos;
    p->zs.avail_in = static_cast<uInt>(p->in_len - p->in_pos);
    p->zs.next_out = dst;
    p->zs.avail_out = static_cast<uInt>(room < (1u << 30) ? room : (1u << 30));
    const uInt out_before = p->zs.avail_out;
    const int ret = inflate(&p->zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END && ret != Z_BUF_ERROR) return kErrGzip;
    p->in_pos = p->in_len - p->zs.avail_in;
    p->size += out_before - p->zs.avail_out;
    p->in_member = ret != Z_STREAM_END;  // a next member, if any, starts afresh
    if (ret == Z_STREAM_END && inflateReset2(&p->zs, 15 + 32) != Z_OK) return kErrGzip;
  }
  return 0;
}

// Encode text[a, e) to the codes' end (which lies at or before a) and add
// it to the last record.
inline void take(Pack* p, const uint8_t* a, const uint8_t* e) {
  uint8_t* dst = p->text + p->bases;
  const size_t n = static_cast<size_t>(e - a);
  for (size_t j = 0; j < n; ++j) dst[j] = encode_base(a[j]);
  p->bases += n;
  p->lens.back() += n;
}

// FASTQ records of text[0, n): the cut just past the last whole one.
// Without `eof` a record is whole once its four lines end in '\n'; at the
// file's end the rules are applied to what is there, as the stream reader
// does.
int32_t walk_fastq(Pack* p, size_t n, bool eof, size_t* cut) {
  const uint8_t* const text = p->text;
  const uint8_t* const end = text + n;
  const uint8_t* q = text;
  while (q < end) {
    const uint8_t* nl = find_nl(q, end);
    if (nl == end && !eof) break;
    if (nl == q) {  // a blank line
      q = nl + 1;
      *cut = static_cast<size_t>(q - text);
      continue;
    }
    if (*q != '@') return kErrFastq;
    if (end - nl <= 1) {  // no sequence line yet
      if (eof) return kErrFastq;
      break;
    }
    const uint8_t* s = nl + 1;
    const uint8_t* s_end = find_nl(s, end);
    if (end - s_end <= 1) {  // no '+' line yet
      if (eof) return kErrFastq;
      break;
    }
    const uint8_t* plus = s_end + 1;
    if (*plus != '+') return kErrFastq;
    const uint8_t* plus_end = find_nl(plus, end);
    if (plus_end == end) {
      if (eof) return kErrFastq;
      break;
    }
    const uint8_t* qual = plus_end + 1;
    const uint8_t* q_end = find_nl(qual, end);
    if (q_end == end && !eof) break;
    const uint8_t* seq_e = strip_cr(s, s_end);
    if (strip_cr(qual, q_end) - qual != seq_e - s) return kErrFastq;
    p->lens.push_back(0);
    take(p, s, seq_e);
    q = q_end < end ? q_end + 1 : end;
    *cut = static_cast<size_t>(q - text);
  }
  return 0;
}

// FASTA records of text[0, n): without `eof` the chunk ends before the last
// line that starts with '>' (at 0: no whole record yet).
int32_t walk_fasta(Pack* p, size_t n, bool eof, size_t* cut) {
  const uint8_t* const text = p->text;
  size_t m = n;
  if (!eof) {
    while (m > 1 && !(text[m - 1] == '>' && text[m - 2] == '\n')) --m;
    m = m > 1 ? m - 1 : 0;
  }
  const uint8_t* const end = text + m;
  const uint8_t* q = text;
  while (q < end) {
    const uint8_t* nl = find_nl(q, end);
    if (*q == '>') {
      p->lens.push_back(0);
    } else {  // a chunk starts with '>', so a record is open
      take(p, q, strip_cr(q, nl));
    }
    q = nl < end ? nl + 1 : end;
  }
  *cut = m;
  return 0;
}

}  // namespace

extern "C" {

void rp_close(void* h) {
  Pack* p = static_cast<Pack*>(h);
  if (p->gz) inflateEnd(&p->zs);
  if (p->fd >= 0) ::close(p->fd);
  std::free(p->text);
  delete p;
}

void* rp_open(const char* path, int32_t* err) {
  *err = 0;
  Pack* p = new (std::nothrow) Pack();
  if (!p || !reserve(p, kReadStep)) {
    delete p;
    *err = kErrAlloc;
    return nullptr;
  }
  p->fd = ::open(path, O_RDONLY | O_CLOEXEC);
  int32_t rc = p->fd < 0 ? kErrOpen : refill(p, 2);
  if (rc == 0 && p->size == 2 && p->text[0] == 0x1f && p->text[1] == 0x8b) {
    p->gz = true;  // inflate starts from the magic bytes
    p->in.assign(p->text, p->text + 2);
    p->in.resize(kReadStep);
    p->in_len = 2;
    p->size = 0;
    if (inflateInit2(&p->zs, 15 + 32) != Z_OK) {
      p->gz = false;
      rc = kErrGzip;
    }
  }
  if (rc) {
    rp_close(p);
    *err = rc;
    return nullptr;
  }
  return p;
}

int32_t rp_next(void* h, uint64_t chunk_bytes, int32_t k, int64_t flat, int64_t* rows,
                int64_t* text_bytes) {
  Pack* p = static_cast<Pack*>(h);
  *rows = 0;
  *text_bytes = 0;
  // the last chunk's text goes; what follows it (one partial record) stays
  std::memmove(p->text, p->text + p->cut, p->size - p->cut);
  p->size -= p->cut;
  p->cut = 0;
  p->rows = 0;
  p->gap = k > 1 ? static_cast<uint64_t>(k - 1) : 0;
  p->flat = static_cast<uint64_t>(flat);
  size_t want = chunk_bytes > p->size ? static_cast<size_t>(chunk_bytes) : p->size;
  for (;;) {
    p->bases = 0;
    p->lens.clear();
    const int32_t rc = refill(p, want);
    if (rc) return rc;
    if (p->fmt == 0) {
      if (p->size == 0) return kErrFormat;  // an empty file
      p->fmt = p->text[0];
      if (p->fmt != '@' && p->fmt != '>') return kErrFormat;
    }
    const int32_t wc = p->fmt == '@' ? walk_fastq(p, p->size, p->eof, &p->cut)
                                     : walk_fasta(p, p->size, p->eof, &p->cut);
    if (wc) return wc;
    if (p->cut > 0 || p->eof) break;
    want = p->size + (p->size > kReadStep ? p->size : kReadStep);  // a longer record
  }
  if (p->cut == 0) return 0;
  if (p->bases > 0) {
    const uint64_t stream = p->bases + p->gap * (p->lens.size() - 1);
    p->rows = (stream + p->flat - 1) / p->flat;
  }
  *rows = static_cast<int64_t>(p->rows);
  *text_bytes = static_cast<int64_t>(p->cut);
  return 1;
}

int32_t rp_fill(void* h, uint8_t* out, int64_t out_len, int64_t* reads, int64_t* bases) {
  Pack* p = static_cast<Pack*>(h);
  const uint64_t gap = p->gap, f = p->flat, rows = p->rows;
  if (rows == 0 || static_cast<uint64_t>(out_len) != rows * f + gap) return -1;
  std::memset(reads, 0, rows * sizeof(int64_t));
  std::memset(bases, 0, rows * sizeof(int64_t));
  const uint8_t* codes = p->text;
  uint64_t pos = 0, row = 0, row_end = f;  // row: the one holding pos
  for (size_t r = 0; r < p->lens.size(); ++r) {
    if (r) {
      std::memset(out + pos, kInvalid, gap);
      pos += gap;
    }
    // a record with no bases at the very end starts at rows * f
    while (pos >= row_end && row + 1 < rows) {
      ++row;
      row_end += f;
    }
    ++reads[row];
    const uint64_t n = p->lens[r];
    std::memcpy(out + pos, codes, n);
    codes += n;
    uint64_t a = pos;
    pos += n;
    while (pos > row_end) {  // the record's bases, row by row
      bases[row] += static_cast<int64_t>(row_end - a);
      a = row_end;
      ++row;
      row_end += f;
    }
    bases[row] += static_cast<int64_t>(pos - a);
  }
  std::memset(out + pos, kInvalid, static_cast<size_t>(out_len) - pos);
  return 0;
}

}  // extern "C"
