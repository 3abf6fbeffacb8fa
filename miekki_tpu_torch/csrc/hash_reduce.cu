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
// Bound on the H100: operations.  A [R, W] call reads W bytes and writes
// 8 n / 4^levels bytes per row (at R = 1024, W = 8222, levels = 2: 12.6 MB,
// 0.004 ms at 3.35 TB/s); the hash, threshold and group count are ~30
// int32 operations per window (R n = 8.4 M windows: 0.0075 ms at the
// ~33.5 TOP/s int32 rate, half the 67 TFLOP/s float32 peak).
//
// Design: one block of 4 warps per span of a row: 512 windows for
// levels <= 2, 2,048 for levels = 3.  The span's codes are staged in shared
// memory.  A warp owns one 128-window group at a time: each lane hashes 4
// consecutive windows (the first in full, 3 by K1's O(1) roll), applies
// the threshold, and the warp sorts the 128 values with a bitonic network
// held in registers (element r * 32 + lane in register r of each lane;
// partners below 32 apart by shuffle, 32 and 64 apart within the lane).
// After the sort, register 0 of lane i holds the i-th smallest: the 32
// kept values are one coalesced store.  A group with no finite value skips
// the sort.  Levels 2 and 3 run on the previous level's outputs in shared
// memory (ping-pong buffers); levels above 3 run a second kernel, one pass
// per level, on the candidates in device memory.  Each row's count is one
// atomicMax per warp.  The sorting network does ~10x the operations of
// the bound at a cold threshold: the known cost of this first design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int GROUP_W = 128;            // values per sorted group
constexpr int GROUP_CAP = 32;           // kept per group per level
constexpr int PER_LANE = GROUP_W / 32;  // values per lane of a group
constexpr int MAX_K = 64;
constexpr int MAX_BLOCK_LEVELS = 3;
constexpr int MAX_SPAN = GROUP_W << (2 * (MAX_BLOCK_LEVELS - 1));  // 2,048 windows
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

// Canonical hashes of the PER_LANE windows starting at sc[0], thresholded:
// v[j] = h(window j) if the window is valid and h < thr, else INF.  The
// recurrence is K1's (csrc/hash_windows.cu).
__device__ __forceinline__ void hash_windows4(const uint8_t* sc, int k, u64 thr,
                                              u64 (&v)[PER_LANE]) {
  u64 f = 0, r = 0;
  int bad = 0;
  for (int t = 0; t < k; ++t) {
    int c = sc[t];
    bad += c >= 4;
    c = c >= 4 ? 0 : c;
    f = rol(f, 1) ^ seed_f(c);
    r ^= rol(seed_r(c), t);
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    if (j > 0) {
      int co = sc[j - 1];
      int ci = sc[j - 1 + k];
      bad += (ci >= 4) - (co >= 4);
      co = co >= 4 ? 0 : co;
      ci = ci >= 4 ? 0 : ci;
      f = rol(f, 1) ^ rol(seed_f(co), k) ^ seed_f(ci);
      r = rol(r ^ seed_r(co), 63) ^ rol(seed_r(ci), k - 1);
    }
    const u64 h = f < r ? f : r;
    v[j] = (bad == 0 && h < thr) ? h : INF;
  }
}

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

// Count, sort and cut one group held by the warp: returns its count of
// finite values (warp-uniform); afterwards v[0] of lane i is its i-th
// smallest value.
__device__ __forceinline__ int reduce_group(u64 (&v)[PER_LANE], int lane) {
  int fin = 0;
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) fin += v[r] != INF;
  const int count = __reduce_add_sync(0xffffffffu, fin);
  if (count > 0) warp_sort128(v, lane);
  return count;
}

// grid: (rows, ceil(n / span)); block: THREADS.  lb in [0, 3] levels run
// here; span = 512 windows for lb <= 2, 2,048 for lb = 3.  out [rows,
// out_w] receives level lb's candidates (out_w = n / 4^lb).
__global__ void __launch_bounds__(THREADS)
hash_reduce_kernel(const uint8_t* __restrict__ codes, const int64_t* __restrict__ thr_keys,
                   int64_t* __restrict__ out, int32_t* __restrict__ cnt,
                   int w, int n, int k, int lb, int span, int out_w) {
  __shared__ uint8_t sc[MAX_SPAN + MAX_K];
  __shared__ u64 buf_a[MAX_SPAN / 4];
  __shared__ u64 buf_b[MAX_SPAN / 16];

  const int row = blockIdx.x;
  const long long base = (long long)blockIdx.y * span;  // first window
  const uint8_t* src = codes + (size_t)row * w;
  for (int i = threadIdx.x; i < span + k - 1; i += THREADS) {
    const long long g = base + i;
    sc[i] = g < w ? src[g] : 4;
  }
  __syncthreads();

  const u64 thr = (u64)thr_keys[row] ^ SIGN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t* dst = out + (size_t)row * out_w;
  int groups = span / GROUP_W;

  if (lb == 0) {  // thresholded hashes in window order
    for (int g = warp; g < groups; g += WARPS) {
      u64 v[PER_LANE];
      hash_windows4(sc + g * GROUP_W + lane * PER_LANE, k, thr, v);
      for (int j = 0; j < PER_LANE; ++j) {
        const long long p = base + g * GROUP_W + lane * PER_LANE + j;
        if (p < n) dst[p] = (int64_t)(v[j] ^ SIGN);
      }
    }
    return;
  }

  int cmax = 0;
  const long long out_base = (long long)blockIdx.y * (span >> (2 * lb));
  for (int g = warp; g < groups; g += WARPS) {  // level 1
    u64 v[PER_LANE];
    hash_windows4(sc + g * GROUP_W + lane * PER_LANE, k, thr, v);
    cmax = max(cmax, reduce_group(v, lane));
    if (lb == 1) {
      const long long o = out_base + g * GROUP_CAP + lane;
      if (o < out_w) dst[o] = (int64_t)(v[0] ^ SIGN);
    } else {
      buf_a[g * GROUP_CAP + lane] = v[0];
    }
  }
  u64* in_buf = buf_a;
  u64* next_buf = buf_b;
  for (int l = 2; l <= lb; ++l) {
    __syncthreads();
    groups >>= 2;
    for (int g = warp; g < groups; g += WARPS) {
      u64 v[PER_LANE];
#pragma unroll
      for (int r = 0; r < PER_LANE; ++r) v[r] = in_buf[g * GROUP_W + r * 32 + lane];
      cmax = max(cmax, reduce_group(v, lane));
      if (l == lb) {
        dst[out_base + g * GROUP_CAP + lane] = (int64_t)(v[0] ^ SIGN);
      } else {
        next_buf[g * GROUP_CAP + lane] = v[0];
      }
    }
    u64* t = in_buf;
    in_buf = next_buf;
    next_buf = t;
  }
  if (lane == 0 && cmax > 0) atomicMax(cnt + row, cmax);
}

// One further level on candidates in device memory: in [rows, in_w] →
// out [rows, in_w / 4].  grid: (rows, ceil(in_w / GROUP_W / WARPS));
// block: THREADS, one warp per group.
__global__ void __launch_bounds__(THREADS)
group_reduce_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                    int32_t* __restrict__ cnt, int in_w) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (g >= in_w / GROUP_W) return;  // whole warps only
  const int64_t* src = in + (size_t)row * in_w + (size_t)g * GROUP_W;
  u64 v[PER_LANE];
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) v[r] = (u64)src[r * 32 + lane] ^ SIGN;
  const int count = reduce_group(v, lane);
  out[(size_t)row * (in_w / 4) + (size_t)g * GROUP_CAP + lane] = (int64_t)(v[0] ^ SIGN);
  if (lane == 0 && count > 0) atomicMax(cnt + row, count);
}

}  // namespace

// codes: uint8 [rows, w]; thr: int64 order keys [rows]; out: int64 [rows,
// (w - k + 1) / 4^levels]; cnt: int32 [rows], zeroed by the caller (all on
// the device, contiguous).  levels in [0, 3]; the caller has checked that
// n = w - k + 1 is divisible by 4^levels * 32.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int miekki_hash_reduce(const uint8_t* codes, const int64_t* thr, int64_t* out,
                                  int32_t* cnt, int rows, int w, int k, int levels,
                                  void* stream) {
  const int n = w - k + 1;
  if (rows <= 0 || n <= 0 || k < 1 || k > MAX_K || levels < 0 ||
      levels > MAX_BLOCK_LEVELS)
    return (int)cudaErrorInvalidValue;
  const int span = levels <= 2 ? 4 * GROUP_W : MAX_SPAN;
  const int out_w = n >> (2 * levels);
  const dim3 grid(rows, (n + span - 1) / span);
  hash_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      codes, thr, out, cnt, w, n, k, levels, span, out_w);
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
