// Join pre-formatted TSV cells into row text (host code; built with the host
// C++ compiler by miekki_tpu_torch/io/tsv_join.py, not by nvcc).
//
// tj_join(ncols, nrows, data, offsets, ncells, index, out, capacity) writes
// nrows rows into out.  Column c holds ncells[c] distinct cells: cell i is
// the bytes data[c][offsets[c][i] .. offsets[c][i + 1]).  Row r is the cells
// index[0][r], ..., index[ncols - 1][r] joined by '\t' and ended by '\n'.
// The caller sizes out exactly from the cells' lengths; it allocates nothing.
//
// Returns the number of bytes written, or a negative code: a row would pass
// capacity (-1), or an index lies outside its column's cells (-2).

#include <cstdint>
#include <cstring>

extern "C" int64_t tj_join(int32_t ncols, int64_t nrows, const uint8_t* const* data,
                           const int64_t* const* offsets, const int64_t* ncells,
                           const int64_t* const* index, uint8_t* out, int64_t capacity) {
  uint8_t* p = out;
  const uint8_t* const end = out + capacity;
  for (int64_t r = 0; r < nrows; ++r) {
    for (int32_t c = 0; c < ncols; ++c) {
      const int64_t i = index[c][r];
      if (i < 0 || i >= ncells[c]) return -2;
      const int64_t a = offsets[c][i];
      const int64_t n = offsets[c][i + 1] - a;
      if (n >= end - p) return -1;  // the cell and its separator
      std::memcpy(p, data[c] + a, static_cast<size_t>(n));
      p += n;
      *p++ = c + 1 < ncols ? '\t' : '\n';
    }
  }
  return p - out;
}
