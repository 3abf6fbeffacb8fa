// Parse a plain FASTA file straight into a caller's buffer (host code; built
// with the host C++ compiler by miekki_tpu_torch/io/arena.py, not by nvcc).
//
// fa_parse_into(path, dst, cap, k) reads the whole file into dst and encodes
// it there in place, giving the bytes of
//   io.encode.pack_records(io.reader.read_genome_codes(path), k)
// as the native reader (native/miekki_io.cpp) reads a FASTA file: each
// record's sequence lines joined, one trailing '\r' of a line dropped, A/C/G/T
// in either case as 0/1/2/3 and every other byte as 4 (INVALID), and k - 1
// INVALID separators between consecutive records.  It allocates nothing.
//
// In place works because every header line and newline read makes room
// ahead of the write position.  Only the separators write more than they
// read; they are written lazily, just before the next sequence byte or at
// the end, and a file whose separators would overtake the bytes still to be
// read (many tiny records with short headers) is declined.
//
// Returns the number of codes written to dst, or a negative code: the file
// cannot be opened, is not a regular file or changed while read (-1), is
// larger than cap (-2), is not plain FASTA (-3: empty, gzip, or a first byte
// other than '>'), or its codes do not fit in place (-4).  A declined file
// is left to the general reader, which raises the errors users see.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint8_t kInvalid = 4;

struct Lut {
  uint8_t v[256];
  constexpr Lut() : v{} {
    for (int i = 0; i < 256; ++i) v[i] = kInvalid;
    v['A'] = v['a'] = 0;
    v['C'] = v['c'] = 1;
    v['G'] = v['g'] = 2;
    v['T'] = v['t'] = 3;
  }
};
constexpr Lut kLut;

enum : int64_t {
  kErrRead = -1,
  kErrCap = -2,
  kErrFormat = -3,
  kErrFit = -4,
};

int64_t read_into(const char* path, uint8_t* dst, uint64_t cap) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return kErrRead;
  struct stat st;
  if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)) {
    close(fd);
    return kErrRead;
  }
  const uint64_t size = static_cast<uint64_t>(st.st_size);
  if (size > cap) {
    close(fd);
    return kErrCap;
  }
  uint64_t got = 0;
  while (got < size) {
    ssize_t r = read(fd, dst + got, size - got);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) break;
    got += static_cast<uint64_t>(r);
  }
  close(fd);
  return got == size ? static_cast<int64_t>(size) : kErrRead;
}

}  // namespace

extern "C" int64_t fa_parse_into(const char* path, uint8_t* dst, uint64_t cap,
                                 int32_t k) {
  const int64_t size = read_into(path, dst, cap);
  if (size < 0) return size;
  if (size == 0 || dst[0] != '>') return kErrFormat;  // gzip starts 0x1f
  const uint8_t* p = dst;
  const uint8_t* const end = dst + size;
  uint8_t* w = dst;
  const uint64_t sep = k > 1 ? static_cast<uint64_t>(k - 1) : 0;
  uint64_t pending = 0;  // separators owed before the next sequence byte
  bool in_record = false;
  while (p < end) {
    const void* hit = std::memchr(p, '\n', static_cast<size_t>(end - p));
    const uint8_t* nl = hit ? static_cast<const uint8_t*>(hit) : end;
    if (*p == '>') {
      if (in_record) pending += sep;
      in_record = true;
    } else {
      const uint8_t* e = nl;
      if (e > p && e[-1] == '\r') --e;
      if (e > p) {
        if (pending) {
          if (pending > static_cast<uint64_t>(p - w)) return kErrFit;
          std::memset(w, kInvalid, pending);
          w += pending;
          pending = 0;
        }
        for (; p != e; ++p) *w++ = kLut.v[*p];  // w <= p: reads stay ahead
      }
    }
    if (nl == end) break;
    p = nl + 1;
  }
  if (pending) {
    if (pending > cap - static_cast<uint64_t>(w - dst)) return kErrFit;
    std::memset(w, kInvalid, pending);
    w += pending;
  }
  return w - dst;
}
