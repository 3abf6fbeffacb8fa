// Kernel K2: canonical ntHash of every k-window, strict threshold, and
// `levels` rounds of "sort each 128-value group, keep its 32 smallest".
//
// Replaces miekki_tpu/ops/pallas_sketch.py:140 hash_reduce_pallas (body
// _sketch_kernel :115; helpers _group_sort :61, _take_groups :92,
// _finite_counts :107).  Plain torch version and spec of the output:
// miekki_tpu_torch/ops/fused_sketch.py::hash_reduce_plain.  Group layout: a
// level-1 group is windows [128 j, 128 j + 128) of a row, a level-l group
// is 4 consecutive level-(l-1) outputs; each row's output is its groups'
// 32 smallest in group order, INF-padded, written as int64 order keys
// (u64 ^ 2^63).  cnt[row] is the largest count of finite values of any
// group of the row at any level (0 when levels = 0).
//
// The invariant that frees the design: a group's output depends only on
// the multiset of its 128 values (equal u64 values cannot be told apart,
// and the output is sorted).  So any assignment of a group's windows to
// lanes, and any order in which its finite values are gathered, gives the
// same bits; only the membership of each group is fixed.
//
// Bound on the H100: operations.  A [R, W] call reads W bytes and writes
// 8 n / 4^levels bytes per row (at R = 1024, W = 8222, levels = 2: 12.6 MB,
// 0.004 ms at 3.35 TB/s); the hash, threshold and group count are ~30
// int32 operations per window (R n = 8.4 M windows: 0.015 ms at the
// 16.7 TOP/s of the INT32 lanes).
//
// Design: one block of 4 warps per span of 4,096 windows of a row.  The
// span's codes are staged in shared memory (an invalid code as 0x80), one
// pad byte per 32 so that the lanes' runs fall in different banks.  Each
// thread hashes a run of 32 consecutive windows: the first from a table of
// rotated seeds (one lookup per code), the other 31 by K1's O(1) roll (one
// lookup per window in a table of the 16 (outgoing, incoming) code pairs),
// and writes the thresholded values into its row of a shared buffer (rows
// of 33 values, so that the lanes' stores fall in different banks).  Four
// consecutive runs are one level-1 group, so a warp's 32 runs are 8 level-1
// groups and 2 level-2 groups, and levels 1-2 need no block barrier.  A
// warp reduces a group held as 4 values per lane: it counts the finite
// values with one ballot per register; none gives 32 INF; up to 32 are
// compacted to one per lane (slot = popcount of the finite values before
// it) and sorted by a 32-wide bitonic network cut at the least power of
// two >= the count; more (the cold first step, or an overflow) take the
// 128-value register network, which is exact.  A group's output
// overwrites a row the group consumed, and a consumed row is the
// compaction scratch.  Level 3 pairs two warps after one block barrier.
// Levels above 3 run a second kernel, one pass per level, on the
// candidates in device memory, through the same group reduction.  Each
// row's count is one atomicMax per warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RUN = 32;                 // consecutive windows hashed by a thread
constexpr int SPAN = THREADS * RUN;     // 4,096 windows per block
constexpr int GROUP_W = 128;            // values per sorted group
constexpr int GROUP_CAP = 32;           // kept per group per level
constexpr int PER_LANE = GROUP_W / 32;  // values per lane of a group
constexpr int MAX_K = 64;
constexpr int MAX_BLOCK_LEVELS = 3;
constexpr int CODES = SPAN + MAX_K;     // staged codes (SPAN + k - 1 used)
constexpr int CODES_PADDED = CODES + CODES / 32;
constexpr int ROW = RUN + 1;            // u64 per run in shared memory
constexpr int BAD = 0x80;               // staged form of an invalid code (hashes as A)
constexpr u64 SIGN = 1ull << 63;
constexpr u64 INF = ~0ull;

// ntHash v1 seeds (oracle/nthash.py), A C G T.
constexpr u64 SEED_A = 0x3C8BFBB395C60474ull;
constexpr u64 SEED_C = 0x3193C18562A02B4Cull;
constexpr u64 SEED_G = 0x20323ED082572324ull;
constexpr u64 SEED_T = 0x295549F54BE24456ull;

__device__ __forceinline__ u64 rol(u64 x, int r) {
  r &= 63;
  return (x << r) | (x >> ((64 - r) & 63));  // r == 0: x | x
}

__device__ __forceinline__ u64 seed_f(int c) {
  return c < 2 ? (c == 0 ? SEED_A : SEED_C) : (c == 2 ? SEED_G : SEED_T);
}

// seed of the complement base (3 - c)
__device__ __forceinline__ u64 seed_r(int c) {
  return c < 2 ? (c == 0 ? SEED_T : SEED_G) : (c == 2 ? SEED_C : SEED_A);
}

// Position of span code p in the padded staging buffer.
__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

// Order (a, b) ascending if `up`, descending otherwise.
__device__ __forceinline__ void compare_exchange(u64& a, u64& b, bool up) {
  const bool swap = up ? (a > b) : (a < b);
  const u64 t = a;
  a = swap ? b : a;
  b = swap ? t : b;
}

// Bitonic sort, ascending, of the warp's 128 values; element e = r * 32 +
// lane lives in register r of lane `lane` (registers are indexed with
// constants only, so they stay in registers).
__device__ __forceinline__ void warp_sort128(u64 (&v)[PER_LANE], int lane) {
#pragma unroll
  for (int size = 2; size <= GROUP_W; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 64) {  // partner in register r ^ 2 of the same lane
        compare_exchange(v[0], v[2], ((0 * 32 + lane) & size) == 0);
        compare_exchange(v[1], v[3], ((1 * 32 + lane) & size) == 0);
      } else if (j == 32) {  // partner in register r ^ 1
        compare_exchange(v[0], v[1], ((0 * 32 + lane) & size) == 0);
        compare_exchange(v[2], v[3], ((2 * 32 + lane) & size) == 0);
      } else {  // partner in lane ^ j, same register
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int r = 0; r < PER_LANE; ++r) {
          const u64 o = __shfl_xor_sync(0xffffffffu, v[r], j);
          const bool up = ((r * 32 + lane) & size) == 0;
          const u64 mn = v[r] < o ? v[r] : o;
          const u64 mx = v[r] < o ? o : v[r];
          v[r] = (up == lower) ? mn : mx;
        }
      }
    }
  }
}

// Bitonic sort, ascending, of one value per lane, with the stages cut at
// the least power of two P >= count: the finite values lie in lanes
// [0, count) and INF elsewhere, partners of a stage below P stay within
// P-aligned lanes, so lanes [0, P) end sorted and the rest stay INF.
__device__ __forceinline__ u64 warp_sort32(u64 x, int lane, int count) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    if (size >= 2 * count) break;
    const bool up = (lane & size) == 0;
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, x, j);
      const u64 mn = x < o ? x : o;
      const u64 mx = x < o ? o : x;
      x = (up == ((lane & j) == 0)) ? mn : mx;
    }
  }
  return x;
}

// Count, select and cut one group held by the warp (its 128 values in
// v[0..3] of the lanes, in any order): returns its count of finite values
// (warp-uniform); afterwards v[0] of lane i is its i-th smallest value.  Up
// to 32 finite values are compacted to one per lane through `scratch` (32
// values the warp may overwrite) and sorted 32 wide; more take the
// 128-value network.
__device__ __forceinline__ int reduce_group(u64 (&v)[PER_LANE], int lane, u64* scratch) {
  unsigned m[PER_LANE];
  int count = 0;
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) {
    m[r] = __ballot_sync(0xffffffffu, v[r] != INF);
    count += __popc(m[r]);
  }
  if (count == 0) {
    v[0] = INF;
  } else if (count <= GROUP_CAP) {
    const unsigned below = (1u << lane) - 1;
    int slot = 0;
#pragma unroll
    for (int r = 0; r < PER_LANE; ++r) {
      if (v[r] != INF) scratch[slot + __popc(m[r] & below)] = v[r];
      slot += __popc(m[r]);
    }
    __syncwarp();
    const u64 x = lane < count ? scratch[lane] : INF;
    __syncwarp();
    v[0] = warp_sort32(x, lane, count);
  } else {
    warp_sort128(v, lane);
  }
  return count;
}

// grid: (rows, ceil(n / SPAN)); block: THREADS.  lb in [0, 3] levels run
// here.  Row r's threshold is thr_keys[(r / thr_rows) * thr_stride].  out
// [rows, out_w] receives level lb's candidates (out_w = n / 4^lb).
__global__ void __launch_bounds__(THREADS)
hash_reduce_kernel(const uint8_t* __restrict__ codes, const int64_t* __restrict__ thr_keys,
                   int thr_rows, long long thr_stride, int64_t* __restrict__ out,
                   int32_t* __restrict__ cnt, int w, int n, int k, int lb, int out_w) {
  __shared__ uint8_t sc[CODES_PADDED];
  __shared__ ulonglong2 seed_tab[MAX_K * 4];  // [i * 4 + c]: code c at offset i of a window
  __shared__ ulonglong2 roll_tab[16];         // [co * 4 + ci]: code co leaves, ci enters
  __shared__ u64 runs[THREADS * ROW];         // thread t's window j at t * ROW + j

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row = blockIdx.x;
  const long long base = (long long)blockIdx.y * SPAN;  // first window
  const uint8_t* src = codes + (size_t)row * w;
  for (int i = t; i < SPAN + k - 1; i += THREADS) {
    const long long g = base + i;
    const int c = g < w ? src[g] : BAD;
    sc[padded(i)] = c < 4 ? c : BAD;
  }
  // F = XOR_i rol(seedF[c_i], k - 1 - i), R = XOR_i rol(seedR[c_i], i); the
  // roll is K1's: F' = rol(F, 1) ^ rol(seedF[co], k) ^ seedF[ci],
  // R' = ror(R, 1) ^ ror(seedR[co], 1) ^ rol(seedR[ci], k - 1).
  for (int e = t; e < 4 * k; e += THREADS) {
    const int i = e >> 2, c = e & 3;
    seed_tab[e] = make_ulonglong2(rol(seed_f(c), k - 1 - i), rol(seed_r(c), i));
  }
  if (t < 16) {
    const int co = t >> 2, ci = t & 3;
    roll_tab[t] = make_ulonglong2(rol(seed_f(co), k) ^ seed_f(ci),
                                  rol(seed_r(co), 63) ^ rol(seed_r(ci), k - 1));
  }
  __syncthreads();

  // hash my run: windows [32 t, 32 t + 32) of the span
  const u64 thr = (u64)thr_keys[(row / thr_rows) * thr_stride] ^ SIGN;
  const uint8_t* mine = sc + padded(t * RUN);  // my code i at mine[i + i / 32]
  u64* my_run = runs + t * ROW;
  u64 f = 0, r = 0;
  int bad = -1;  // last invalid code read, relative to my first window
  for (int i = 0; i < k; ++i) {
    const int c = mine[i + (i >> 5)];
    if (c & BAD) bad = i;
    const ulonglong2 s = seed_tab[i * 4 + (c & 3)];
    f ^= s.x;
    r ^= s.y;
  }
  {
    const u64 h = f < r ? f : r;
    my_run[0] = (bad < 0 && h < thr) ? h : INF;
  }
#pragma unroll
  for (int j = 1; j < RUN; ++j) {
    const int co = mine[j - 1];
    const int pin = j - 1 + k;  // the entering code
    const int ci = mine[pin + (pin >> 5)];
    if (ci & BAD) bad = pin;
    const ulonglong2 s = roll_tab[((co << 2) | ci) & 15];
    f = rol(f, 1) ^ s.x;
    r = rol(r, 63) ^ s.y;
    const u64 h = f < r ? f : r;
    my_run[j] = (bad < j && h < thr) ? h : INF;
  }
  __syncwarp();

  int64_t* dst = out + (size_t)row * out_w;
  u64* rows = runs + warp * 32 * ROW;  // the warp's 32 runs
  if (lb == 0) {  // thresholded hashes in window order
    for (int m = 0; m < 32; ++m) {
      const long long p = base + (warp * 32 + m) * RUN + lane;
      if (p < n) dst[p] = (int64_t)(rows[m * ROW + lane] ^ SIGN);
    }
    return;
  }

  // level 1: the warp's 8 groups of 4 runs; group g's output replaces its
  // run 4 g, run 4 g + 1 is its scratch
  int cmax = 0;
  for (int g = 0; g < 8; ++g) {
    u64 v[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) v[q] = rows[(4 * g + q) * ROW + lane];
    __syncwarp();
    cmax = max(cmax, reduce_group(v, lane, rows + (4 * g + 1) * ROW));
    if (lb == 1) {
      const long long o = (long long)blockIdx.y * (SPAN / 4) + (warp * 8 + g) * GROUP_CAP + lane;
      if (o < out_w) dst[o] = (int64_t)(v[0] ^ SIGN);
    } else {
      rows[4 * g * ROW + lane] = v[0];
    }
  }
  if (lb >= 2) {  // level 2: the warp's 2 groups, runs 16 j + 4 q
    __syncwarp();
    for (int j = 0; j < 2; ++j) {
      u64 v[PER_LANE];
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) v[q] = rows[(16 * j + 4 * q) * ROW + lane];
      __syncwarp();
      cmax = max(cmax, reduce_group(v, lane, rows + (16 * j + 1) * ROW));
      if (lb == 2) {
        const long long o = (long long)blockIdx.y * (SPAN / 16) + (warp * 2 + j) * GROUP_CAP + lane;
        if (o < out_w) dst[o] = (int64_t)(v[0] ^ SIGN);
      } else {
        rows[16 * j * ROW + lane] = v[0];
      }
    }
  }
  if (lb == 3) {  // level 3: warp G < 2 takes runs 64 G + 16 q of warps 2 G, 2 G + 1
    __syncthreads();
    if (warp < 2) {
      u64* pair = runs + 64 * warp * ROW;
      u64 v[PER_LANE];
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) v[q] = pair[16 * q * ROW + lane];
      __syncwarp();
      cmax = max(cmax, reduce_group(v, lane, pair + ROW));
      const long long o = (long long)blockIdx.y * (SPAN / 64) + warp * GROUP_CAP + lane;
      if (o < out_w) dst[o] = (int64_t)(v[0] ^ SIGN);
    }
  }
  if (lane == 0 && cmax > 0) atomicMax(cnt + row, cmax);
}

// One further level on candidates in device memory: in [rows, in_w] →
// out [rows, in_w / 4].  grid: (rows, ceil(in_w / GROUP_W / WARPS));
// block: THREADS, one warp per group.
__global__ void __launch_bounds__(THREADS)
group_reduce_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                    int32_t* __restrict__ cnt, int in_w) {
  __shared__ u64 scratch[WARPS][GROUP_CAP];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (g >= in_w / GROUP_W) return;  // whole warps only
  const int64_t* src = in + (size_t)row * in_w + (size_t)g * GROUP_W;
  u64 v[PER_LANE];
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) v[r] = (u64)src[r * 32 + lane] ^ SIGN;
  const int count = reduce_group(v, lane, scratch[threadIdx.x >> 5]);
  out[(size_t)row * (in_w / 4) + (size_t)g * GROUP_CAP + lane] = (int64_t)(v[0] ^ SIGN);
  if (lane == 0 && count > 0) atomicMax(cnt + row, count);
}

}  // namespace

// codes: uint8 [rows, w], contiguous; thr: int64 order keys, n_thr of them
// thr_stride elements apart, each the threshold of rows / n_thr consecutive
// rows; out: int64 [rows, (w - k + 1) / 4^levels], contiguous; cnt: int32
// [rows], zeroed here (all on the device).  levels in [0, 3]; the caller has
// checked that n = w - k + 1 is divisible by 4^levels * 32.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int miekki_hash_reduce(const uint8_t* codes, const int64_t* thr, int n_thr,
                                  long long thr_stride, int64_t* out, int32_t* cnt, int rows,
                                  int w, int k, int levels, void* stream) {
  const int n = w - k + 1;
  if (rows <= 0 || n <= 0 || k < 1 || k > MAX_K || levels < 0 ||
      levels > MAX_BLOCK_LEVELS || n_thr <= 0 || rows % n_thr)
    return (int)cudaErrorInvalidValue;
  const int out_w = n >> (2 * levels);
  const dim3 grid(rows, (n + SPAN - 1) / SPAN);
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)rows * sizeof(int32_t), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  hash_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      codes, thr, rows / n_thr, thr_stride, out, cnt, w, n, k, levels, out_w);
  return (int)cudaGetLastError();
}

// One level beyond the third: in int64 [rows, in_w] → out int64 [rows,
// in_w / 4], in_w divisible by 128; cnt as above.
extern "C" int miekki_group_reduce(const int64_t* in, int64_t* out, int32_t* cnt, int rows,
                                   int in_w, void* stream) {
  if (rows <= 0 || in_w <= 0 || in_w % GROUP_W) return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, (in_w / GROUP_W + WARPS - 1) / WARPS);
  group_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(in, out, cnt, in_w);
  return (int)cudaGetLastError();
}

// Threads per block and resident blocks per SM of the block kernel, and the
// SM's thread limit (registers and shared memory are in the ptxas log);
// returns a CUDA error (0 = success).
extern "C" int miekki_hash_reduce_info(int* threads_per_block, int* blocks_per_sm,
                                       int* threads_per_sm) {
  *threads_per_block = THREADS;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                                hash_reduce_kernel, THREADS, 0);
  int device = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  return (int)e;
}
