// Kernel K4: all-pairs bottom-s intersection counts of a compact sketch tile
// (32-bit fingerprint codes, one plane).
//
// Replaces miekki_tpu/ops/pallas_intersect.py:463 tile_counts_pallas32
// (bodies _tile_kernel32 :426 and _tile_kernel32_u2 :376; helpers
// _merge_any_width32 :337 and _counts_for_col32 :357).  Count semantics are
// miekki_tpu/ops/intersect.py:35 pair_counts_merge on codes; the plain torch
// version is miekki_tpu_torch/ops/intersect.py::tile_counts_compact_plain.
//
// Input contract (the wrapper documents it, the compact index guarantees
// it): each row of rows [ti, sp] and cols [tj, sp] holds strictly
// increasing code keys (uint32 code ^ 2^31 as int32) followed by INT32_MAX
// padding, and n_rows / n_cols give each row's count of codes.  Code keys
// compare as signed int32 exactly as the codes compare as uint32.
//
// For a pair (a = row i, b = col j):
//   inter_full  = |A ∩ B|
//   union_size  = min(|A| + |B| - inter_full, s)
//   shared_in_x = #{v in A ∩ B : distinct rank of v in A ∪ B < s}, where a
//                 common value at index ib of b has 0-based rank
//                 (#a < v) + ib - (#common values before it in b).
//
// Bound on the H100: operations.  A linear merge needs ~n_a + n_b 32-bit
// compares per pair, one int32 operation each, over ~33.5 TOP/s (half the
// 67 TFLOP/s float32 peak): at ti = tj = 512, s = 10,000 about 0.15 ms,
// half of K3's bound.  The bytes, (ti + tj)*sp*4 in and 3*ti*tj*4 out, take
// about 0.016 ms at 3.35 TB/s.
//
// Design: K3's (csrc/tile_counts.cu), on one 32-bit plane.  The TPU kernel
// runs a bitonic merge network per pair; here one block takes row i and
// COLS_PER_BLOCK columns.  Row i is staged in dynamic shared memory (40 KB
// at s = 10,000; rows too wide for shared memory are searched in device
// memory instead), every column value binary-searches it (#a < v and the
// match flag), a warp ballot plus per-warp totals give each match's count
// of earlier matches, and a second ballot counts the matches of rank < s.
// The binary search does ~log2(sp) times the merge's compares: the known
// cost of this first design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_BLOCK = 8;
constexpr size_t MAX_STAGED_BYTES = 227 * 1024 - 1024;  // of 232,448 per block

// #a[0, n) < v for sorted a.
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// grid: (ti, ceil(tj / COLS_PER_BLOCK)); block: THREADS; dynamic shared
// memory: sp * 4 bytes when staged, else 0.
__global__ void __launch_bounds__(THREADS)
tile_counts32_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                     const int32_t* __restrict__ n_rows, const int32_t* __restrict__ n_cols,
                     int32_t* __restrict__ shared_out, int32_t* __restrict__ union_out,
                     int32_t* __restrict__ inter_out, int tj, int sp, int s, int staged) {
  extern __shared__ int32_t row_smem[];
  __shared__ int warp_match[WARPS];
  __shared__ int warp_hit[WARPS];

  const int i = blockIdx.x;
  const int na = n_rows[i];
  const int32_t* a = rows + (size_t)i * sp;
  if (staged) {
    for (int t = threadIdx.x; t < na; t += THREADS) row_smem[t] = a[t];
    __syncthreads();
    a = row_smem;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  const int j_end = min(tj, (int)(blockIdx.y + 1) * COLS_PER_BLOCK);
  for (int j = blockIdx.y * COLS_PER_BLOCK; j < j_end; ++j) {
    const int nb = n_cols[j];
    const int32_t* b = cols + (size_t)j * sp;
    int matched = 0;  // common values in b[0, base)
    int in_x = 0;     // of those, the ones of rank < s
    for (int base = 0; base < nb; base += THREADS) {
      const int ib = base + threadIdx.x;
      bool match = false;
      int ia = 0;
      if (ib < nb) {
        const int32_t v = b[ib];
        ia = lower_bound(a, na, v);
        match = ia < na && a[ia] == v;
      }
      const unsigned m_bits = __ballot_sync(0xffffffffu, match);
      if (lane == 0) warp_match[warp] = __popc(m_bits);
      __syncthreads();
      int before = matched + __popc(m_bits & lanes_below);
      int total = matched;
      for (int q = 0; q < WARPS; ++q) {
        const int m = warp_match[q];
        before += q < warp ? m : 0;
        total += m;
      }
      const bool hit = match && ia + ib - before < s;
      const unsigned h_bits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hit[warp] = __popc(h_bits);
      __syncthreads();
      for (int q = 0; q < WARPS; ++q) in_x += warp_hit[q];
      matched = total;
    }
    if (threadIdx.x == 0) {
      const size_t o = (size_t)i * tj + j;
      const int uni = na + nb - matched;
      shared_out[o] = in_x;
      union_out[o] = uni < s ? uni : s;
      inter_out[o] = matched;
    }
  }
}

}  // namespace

// rows: int32 [ti, sp], cols: int32 [tj, sp], n_rows: int32 [ti],
// n_cols: int32 [tj] (device, contiguous); outputs int32 [ti, tj].
// Returns the CUDA error of the set-up or the launch (0 = launched).
extern "C" int miekki_tile_counts32(const int32_t* rows, const int32_t* cols,
                                    const int32_t* n_rows, const int32_t* n_cols,
                                    int32_t* shared_out, int32_t* union_out,
                                    int32_t* inter_out, int ti, int tj, int sp, int s,
                                    void* stream) {
  if (ti <= 0 || tj <= 0 || sp <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)sp * sizeof(int32_t);
  const int staged = bytes <= MAX_STAGED_BYTES;
  if (staged) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_counts32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(ti, (tj + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
  tile_counts32_kernel<<<grid, THREADS, staged ? bytes : 0, (cudaStream_t)stream>>>(
      rows, cols, n_rows, n_cols, shared_out, union_out, inter_out, tj, sp, s, staged);
  return (int)cudaGetLastError();
}
