// Kernel K3: all-pairs bottom-s intersection counts of a sketch tile.
//
// Replaces miekki_tpu/ops/pallas_intersect.py:265 tile_counts_pallas (bodies
// _tile_kernel :210 and _tile_kernel_u2 :143; helpers _bitonic_merge :40,
// _merge_any_width :58, _prefix_sum :105, _counts_for_col :115).  Count
// semantics are miekki_tpu/ops/intersect.py:35 pair_counts_merge; the plain
// torch version is miekki_tpu_torch/ops/intersect.py::tile_counts_plain.
//
// Input contract (the wrapper documents it, the index guarantees it): each
// row of rows [ti, sp] and cols [tj, sp] holds strictly increasing finite
// order keys (u64 ^ 2^63 as int64) followed by INT64_MAX padding, and
// n_rows / n_cols give each row's finite count.  Order keys compare as
// signed int64 exactly as the values compare as u64, so the kernel compares
// the keys themselves and never converts them.
//
// For a pair (a = row i, b = col j), with distinct values on each side:
//   inter_full  = |A ∩ B|
//   union_size  = min(|A| + |B| - inter_full, s)
//   shared_in_x = #{v in A ∩ B : distinct rank of v in A ∪ B < s}, where a
//                 common value at index ib of b has 0-based rank
//                 (#a < v) + ib - (#common values before it in b).
//
// Bound on the H100: operations.  A linear merge needs ~2*sp 64-bit
// compares per pair, each two int32 operations, so 4*sp operations per pair
// over ~33.5 TOP/s (half the 67 TFLOP/s float32 peak, the card's rate of
// plain int32 work); at ti = tj = 512, sp = 10,112 that is 0.32 ms.  The
// bytes, (ti + tj)*sp*8 in and 3*ti*tj*4 out, take 0.03 ms at 3.35 TB/s.
//
// Design: one block per (row i, COLS_PER_BLOCK columns).  Row i is staged
// in dynamic shared memory (81 KB at s = 10,000; rows too wide for shared
// memory are searched in device memory instead).  For each column, the
// block walks b in chunks of THREADS: every thread binary-searches its b
// value in row i (#a < v and the match flag), a warp ballot plus per-warp
// totals give each match's count of earlier matches, and a second ballot
// counts the matches whose rank is < s.  The binary search costs
// ~log2(sp) = 14 times the merge's compares: that gap to the bound is
// the known cost of this first design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_BLOCK = 8;
constexpr size_t MAX_STAGED_BYTES = 227 * 1024 - 1024;  // of 232,448 per block

// #a[0, n) < v for sorted a.
__device__ __forceinline__ int lower_bound(const int64_t* a, int n, int64_t v) {
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
// memory: sp * 8 bytes when staged, else 0.
__global__ void __launch_bounds__(THREADS)
tile_counts_kernel(const int64_t* __restrict__ rows, const int64_t* __restrict__ cols,
                   const int32_t* __restrict__ n_rows, const int32_t* __restrict__ n_cols,
                   int32_t* __restrict__ shared_out, int32_t* __restrict__ union_out,
                   int32_t* __restrict__ inter_out, int tj, int sp, int s, int staged) {
  extern __shared__ int64_t row_smem[];
  __shared__ int warp_match[WARPS];
  __shared__ int warp_hit[WARPS];

  const int i = blockIdx.x;
  const int na = n_rows[i];
  const int64_t* a = rows + (size_t)i * sp;
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
    const int64_t* b = cols + (size_t)j * sp;
    int matched = 0;  // common values in b[0, base)
    int in_x = 0;     // of those, the ones of rank < s
    for (int base = 0; base < nb; base += THREADS) {
      const int ib = base + threadIdx.x;
      bool match = false;
      int ia = 0;
      if (ib < nb) {
        const int64_t v = b[ib];
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

// rows: int64 [ti, sp], cols: int64 [tj, sp], n_rows: int32 [ti],
// n_cols: int32 [tj] (device, contiguous); outputs int32 [ti, tj].
// Returns the CUDA error of the set-up or the launch (0 = launched).
extern "C" int miekki_tile_counts(const int64_t* rows, const int64_t* cols,
                                  const int32_t* n_rows, const int32_t* n_cols,
                                  int32_t* shared_out, int32_t* union_out,
                                  int32_t* inter_out, int ti, int tj, int sp, int s,
                                  void* stream) {
  if (ti <= 0 || tj <= 0 || sp <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)sp * sizeof(int64_t);
  const int staged = bytes <= MAX_STAGED_BYTES;
  if (staged) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(ti, (tj + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
  tile_counts_kernel<<<grid, THREADS, staged ? bytes : 0, (cudaStream_t)stream>>>(
      rows, cols, n_rows, n_cols, shared_out, union_out, inter_out, tj, sp, s, staged);
  return (int)cudaGetLastError();
}
