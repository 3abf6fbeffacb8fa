// Kernels K3 and K4: all-pairs bottom-s intersection counts of a sketch tile,
// one merge kernel templated on the key: 64-bit order keys (K3) and 32-bit
// compact code keys (K4).
//
// Replaces miekki_tpu/ops/pallas_intersect.py:265 tile_counts_pallas (K3;
// bodies _tile_kernel :210 and _tile_kernel_u2 :143) and
// miekki_tpu/ops/pallas_intersect.py:463 tile_counts_pallas32 (K4).  Count
// semantics are miekki_tpu/ops/intersect.py:35 pair_counts_merge; the plain
// torch versions are miekki_tpu_torch/ops/intersect.py::tile_counts_plain
// and ::tile_counts_compact_plain.
//
// Input contract (the wrappers document it, the index guarantees it): each
// row of rows [ti, sp] and cols [tj, sp] holds strictly increasing finite
// keys followed by the key type's maximum (INF) as padding.  K3's keys are
// u64 ^ 2^63 as int64, K4's code ^ 2^31 as int32: signed order is value
// order, so the kernel compares the keys themselves.
//
// For a pair (a = row i, b = col j), with distinct values on each side:
//   inter_full  = |A ∩ B|
//   union_size  = min(|A| + |B| - inter_full, s)
//   shared_in_x = #{v in A ∩ B : #{u in A ∪ B : u < v} < s}
//
// Bound on the H100: operations.  A linear merge compares each key of a pair
// once: sum over pairs of (n_a + n_b) compares, two int32 operations each on
// 64-bit keys, one on 32-bit keys, over the card's int32 rate (132 SMs x 64
// INT32 lanes x the SM clock: ~16.7 TOP/s at 1,980 MHz).  At ti = tj = 512,
// s = 10,000 that is ~0.63 ms (K3) and ~0.31 ms (K4); the bytes, each row
// once and three int32 outputs, take ~0.03 ms at 3.35 TB/s.
//
// Design: one block of R x C = 32 x 32 threads owns 32 rows x 32 columns of
// the tile, one pair per thread; warp w holds the pairs of row w.  The
// block streams the keys of its 64 rows through shared memory in ascending
// value order, in steps (a "frontier" merge):
//   - a step holds the next CAP keys of every row (512 bytes per row: 64
//     int64 or 128 int32 keys), fetched with cp.async one step ahead into
//     the other half of a double buffer; keys past sp read as INF;
//   - the frontier F is the least of the rows' last staged keys; every key
//     <= F of every row is staged, and each row counts its staged keys <= F
//     with one binary search over CAP keys and puts an INF sentinel after
//     them;
//   - each thread merges its pair's two segments <= F two-pointer style, and
//     carries the pair's distinct union count, inter_full and shared_in_x in
//     registers to the next step; a common value counts into shared_in_x
//     when the carried union count plus its distinct rank within the step is
//     below s, so there is no second pass (only the step in which the union
//     count crosses s tracks ranks);
//   - cursors advance by the counts; the step whose F is INF is the last.
// 66 KB of shared memory and at most 32 registers a thread let two blocks
// share an SM, so one block's barriers overlap the other's merging.
// What this does about the costs of the first design (a binary search of
// every column value in a staged row, one block per row and 8 columns):
//   1. linear work: each key of a pair is compared O(1) times, not log2(sp);
//      a merge step is 10 SASS instructions on int32 keys, 12 on int64;
//   2. bank conflicts: the lanes of a warp read one row at nearby offsets
//      (distinct banks, or one broadcast word) and 32 columns whose stride,
//      CAP + 1 keys, puts equal offsets into different banks; a lane loads
//      only the side that advanced;
//   3. synchronisation: two block barriers (and one 64-thread barrier) per
//      step of ~CAP keys per row, not two per 256 values per column;
//   4. reuse: each key is fetched from L2 once per block (a little more,
//      since keys above F are fetched again next step), not once per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 32;             // tile rows per block
constexpr int C = 32;             // tile columns per block
constexpr int ROWS = R + C;       // staged rows
constexpr int THREADS = R * C;    // one pair per thread
constexpr int STAGE_BYTES = 512;  // staged bytes per row and step
static_assert(R == 32 && C == 32 && THREADS / 32 == C, "pair mapping needs 32 x 32");

template <typename K>
struct KeyInfo;
template <>
struct KeyInfo<int64_t> {
  static constexpr int64_t INF = INT64_MAX;
};
template <>
struct KeyInfo<int32_t> {
  static constexpr int32_t INF = INT32_MAX;
};

template <typename K>
constexpr int CAP = STAGE_BYTES / (int)sizeof(K);
template <typename K>
constexpr int STRIDE = CAP<K> + 1;  // odd: equal offsets of 32 rows hit 32 banks
template <typename K>
constexpr size_t SMEM_BYTES = 2 * ROWS * STRIDE<K> * sizeof(K);

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One merge step: the side(s) holding the smaller value advance and load
// their next key.  Written as predicated PTX: compiled from C++, the same
// step took ~17 instructions (duplicated compares, moves around selects).
__device__ __forceinline__ void advance(int32_t& va, int32_t& vb, unsigned& pa, unsigned& pb) {
  asm volatile(
      "{\n .reg .pred le, ge;\n"
      " setp.le.s32 le, %0, %1;\n"
      " setp.ge.s32 ge, %0, %1;\n"
      " @le add.u32 %2, %2, 4;\n"
      " @ge add.u32 %3, %3, 4;\n"
      " @le ld.shared.b32 %0, [%2];\n"
      " @ge ld.shared.b32 %1, [%3];\n"
      "}\n"
      : "+r"(va), "+r"(vb), "+r"(pa), "+r"(pb));
}
__device__ __forceinline__ void advance(int64_t& va, int64_t& vb, unsigned& pa, unsigned& pb) {
  asm volatile(
      "{\n .reg .pred le, ge;\n"
      " setp.le.s64 le, %0, %1;\n"
      " setp.ge.s64 ge, %0, %1;\n"
      " @le add.u32 %2, %2, 8;\n"
      " @ge add.u32 %3, %3, 8;\n"
      " @le ld.shared.b64 %0, [%2];\n"
      " @ge ld.shared.b64 %1, [%3];\n"
      "}\n"
      : "+l"(va), "+l"(vb), "+r"(pa), "+r"(pb));
}

// Stage the next CAP keys of each of the block's rows (src[r] from
// cursor[r]) into buf; positions past sp read INF.  Thread t copies key
// t % CAP of every (THREADS / CAP)-th row.
template <typename K>
__device__ __forceinline__ void stage(K* buf, const K* const* src, const int* cursor, int sp) {
  static_assert(THREADS % CAP<K> == 0, "a thread keeps one key offset");
  const int k = threadIdx.x % CAP<K>;
  for (int r = threadIdx.x / CAP<K>; r < ROWS; r += THREADS / CAP<K>) {
    const int pos = cursor[r] + k;
    K* dst = buf + r * STRIDE<K> + k;
    if (pos < sp) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                   "l"(src[r] + pos), "n"((int)sizeof(K)));
    } else {
      *dst = KeyInfo<K>::INF;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Merge one step's segments a[0, ca) and b[0, cb) (each followed by an INF
// sentinel) into the pair's carried counts.  `uni` is the distinct union
// count of the earlier steps; only a step in which it crosses s needs the
// rank of every common value.
template <typename K>
__device__ __forceinline__ void merge_step(const K* a, const K* b, int ca, int cb, int s,
                                           int& uni, int& inter, int& shared) {
  constexpr unsigned W = sizeof(K);
  const int end = ca + cb;
  unsigned pa = smem_addr(a), pb = smem_addr(b);  // cursors, as shared addresses
  const unsigned stop = pa + pb + end * W;        // both segments consumed
  K va = a[0], vb = b[0];
  int distinct = 0;  // iterations: one per distinct value of the step
  if (uni >= s || uni + end <= s) {
    for (; pa + pb < stop; ++distinct) advance(va, vb, pa, pb);
    if (uni < s) shared += end - distinct;
  } else {
    for (; pa + pb < stop; ++distinct) {  // uni + distinct: the value's rank
      shared += va == vb && uni + distinct < s;
      advance(va, vb, pa, pb);
    }
  }
  inter += end - distinct;
  uni += distinct;
}

// grid: (ceil(tj / C), ceil(ti / R)); block: THREADS; dynamic shared
// memory: SMEM_BYTES<K>.
template <typename K>
__global__ void __launch_bounds__(THREADS, 2)
tile_counts_kernel(const K* __restrict__ rows, const K* __restrict__ cols,
                   int32_t* __restrict__ shared_out, int32_t* __restrict__ union_out,
                   int32_t* __restrict__ inter_out, int ti, int tj, int sp, int s) {
  constexpr K INF = KeyInfo<K>::INF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* const bufs = reinterpret_cast<K*>(smem_raw);
  __shared__ const K* src[ROWS];
  __shared__ int cursor[ROWS];
  __shared__ int count[ROWS];
  __shared__ int last_step;

  const int row0 = blockIdx.y * R, col0 = blockIdx.x * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = warp, j = lane;  // a warp's pairs share row i

  if (threadIdx.x < ROWS) {  // rows past the tile's edge repeat its last row
    const int r = threadIdx.x;
    src[r] = r < R ? rows + (size_t)min(row0 + r, ti - 1) * sp
                   : cols + (size_t)min(col0 + r - R, tj - 1) * sp;
    cursor[r] = 0;
  }
  __syncthreads();
  stage(bufs, src, cursor, sp);

  int uni = 0, inter = 0, shared = 0;
  for (int cur = 0;; cur ^= 1) {
    K* const buf = bufs + cur * ROWS * STRIDE<K>;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x < ROWS) {  // warps 0 and 1: frontier, counts, cursors
      K f = kmin(buf[lane * STRIDE<K> + CAP<K> - 1], buf[(lane + 32) * STRIDE<K> + CAP<K> - 1]);
      for (int o = 16; o > 0; o >>= 1) f = kmin(f, __shfl_xor_sync(0xffffffffu, f, o));
      asm volatile("bar.sync 1, %0;\n" ::"n"(ROWS) : "memory");  // last keys read
      const K fc = f < INF ? f : INF - 1;  // INF is padding, never a key
      K* const row = buf + threadIdx.x * STRIDE<K>;
      int n = 0;  // keys <= fc among row[0, CAP)
      for (int step = CAP<K>; step > 0; step >>= 1)
        if (n + step <= CAP<K> && row[n + step - 1] <= fc) n += step;
      row[n] = INF;  // sentinel; slot CAP is the row's padding slot
      count[threadIdx.x] = n;
      cursor[threadIdx.x] += n;
      if (threadIdx.x == 0) last_step = f == INF;
    }
    __syncthreads();
    const bool last = last_step;
    if (!last) stage(bufs + (cur ^ 1) * ROWS * STRIDE<K>, src, cursor, sp);
    merge_step(buf + i * STRIDE<K>, buf + (R + j) * STRIDE<K>, count[i], count[R + j], s, uni,
               inter, shared);
    if (last) break;
  }

  const int gi = row0 + i, gj = col0 + j;
  if (gi < ti && gj < tj) {
    const size_t o = (size_t)gi * tj + gj;
    shared_out[o] = shared;
    union_out[o] = uni < s ? uni : s;
    inter_out[o] = inter;
  }
}

template <typename K>
int launch(const K* rows, const K* cols, int32_t* shared_out, int32_t* union_out,
           int32_t* inter_out, int ti, int tj, int sp, int s, void* stream) {
  if (ti <= 0 || tj <= 0 || sp <= 0 || s < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      tile_counts_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES<K>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tj + C - 1) / C, (ti + R - 1) / R);
  tile_counts_kernel<K><<<grid, THREADS, SMEM_BYTES<K>, (cudaStream_t)stream>>>(
      rows, cols, shared_out, union_out, inter_out, ti, tj, sp, s);
  return (int)cudaGetLastError();
}

template <typename K>
int info(int* smem_bytes, int* blocks_per_sm, int* threads_per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      tile_counts_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES<K>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, tile_counts_kernel<K>,
                                                      THREADS, SMEM_BYTES<K>);
  int device = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  *smem_bytes = (int)SMEM_BYTES<K>;
  return (int)e;
}

}  // namespace

// rows: [ti, sp], cols: [tj, sp] keys (device, contiguous); outputs int32
// [ti, tj].  Each returns the CUDA error of its set-up or launch (0 =
// launched).
extern "C" int miekki_tile_counts64(const int64_t* rows, const int64_t* cols,
                                    int32_t* shared_out, int32_t* union_out,
                                    int32_t* inter_out, int ti, int tj, int sp, int s,
                                    void* stream) {
  return launch(rows, cols, shared_out, union_out, inter_out, ti, tj, sp, s, stream);
}

extern "C" int miekki_tile_counts32(const int32_t* rows, const int32_t* cols,
                                    int32_t* shared_out, int32_t* union_out,
                                    int32_t* inter_out, int ti, int tj, int sp, int s,
                                    void* stream) {
  return launch(rows, cols, shared_out, union_out, inter_out, ti, tj, sp, s, stream);
}

// Dynamic shared memory per block, resident blocks per SM of the kernel for
// key_bytes = 8 (K3) or 4 (K4), and the SM's thread limit; returns a CUDA
// error (0 = success).
extern "C" int miekki_tile_counts_info(int key_bytes, int* smem_bytes, int* blocks_per_sm,
                                       int* threads_per_sm) {
  if (key_bytes == 8) return info<int64_t>(smem_bytes, blocks_per_sm, threads_per_sm);
  if (key_bytes == 4) return info<int32_t>(smem_bytes, blocks_per_sm, threads_per_sm);
  return (int)cudaErrorInvalidValue;
}
