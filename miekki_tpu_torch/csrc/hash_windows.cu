// Kernel K1: canonical ntHash-v1 of every k-window of uint8 code rows,
// written as int64 order keys (u64 ^ 2^63; INT64_MAX = invalid window).
//
// Replaces miekki_tpu/ops/pallas_hash.py:42 hash_windows_pallas (body
// _hash_kernel at :34; the math is miekki_tpu/ops/hash.py:103
// hash_block_math).  Plain torch version and spec of the output:
// miekki_tpu_torch/ops/hash.py::hash_block_math.
//
// Bound on the H100: memory.  A [R, W] call reads each code once (1 B) and
// writes one 8 B key per window, R*W + 8*R*(W-k+1) bytes over 3.35 TB/s;
// at R = 1024, W = 8222 (the sketch path's step) that is 76 MB, 23 us.
// The arithmetic is ~20 integer operations per window, well under the
// card's integer rate, so only the bytes count.
//
// Design: the TPU kernel XORs whole planes in log2(k) doubling passes,
// because its vector unit has no cheap way to carry state along a row.
// Here each thread owns RUN consecutive windows: it hashes the first in
// full (k steps) and rolls the rest in O(1),
//   F' = rol(F, 1) ^ rol(seedF[c_out], k) ^ seedF[c_in]
//   R' = ror(R ^ seedR[c_out], 1) ^ rol(seedR[c_in], k - 1)
// with a running count of invalid codes (code >= 4) in the window.  A
// block stages its codes in shared memory with coalesced loads, and its
// keys in shared memory (padded by one slot per thread against bank
// conflicts), then stores them coalesced.  The canonical hash is the
// unsigned 64-bit min(F, R); the order-key sign flip happens at the store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RUN = 16;                  // windows per thread
constexpr int TILE = THREADS * RUN;      // windows per block
constexpr int MAX_K = 64;
constexpr uint64_t SIGN = 1ull << 63;
constexpr uint64_t INF = ~0ull;

// ntHash v1 seeds (oracle/nthash.py), A C G T.
constexpr uint64_t SEED_A = 0x3C8BFBB395C60474ull;
constexpr uint64_t SEED_C = 0x3193C18562A02B4Cull;
constexpr uint64_t SEED_G = 0x20323ED082572324ull;
constexpr uint64_t SEED_T = 0x295549F54BE24456ull;

__device__ __forceinline__ uint64_t rol(uint64_t x, int r) {
  r &= 63;
  return (x << r) | (x >> ((64 - r) & 63));  // r == 0: x | x
}

__device__ __forceinline__ uint64_t seed_f(int c) {
  return c < 2 ? (c == 0 ? SEED_A : SEED_C) : (c == 2 ? SEED_G : SEED_T);
}

// seed of the complement base (3 - c)
__device__ __forceinline__ uint64_t seed_r(int c) {
  return c < 2 ? (c == 0 ? SEED_T : SEED_G) : (c == 2 ? SEED_C : SEED_A);
}

// grid: (rows, ceil(n / TILE)); block: THREADS.
__global__ void __launch_bounds__(THREADS)
hash_windows_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ out,
                    int w, int n, int k) {
  __shared__ uint8_t sc[TILE + MAX_K];
  __shared__ uint64_t sk[THREADS * (RUN + 1)];

  const int row = blockIdx.x;
  const long long base = (long long)blockIdx.y * TILE;  // first window
  const uint8_t* src = codes + (size_t)row * w;
  for (int i = threadIdx.x; i < TILE + k - 1; i += THREADS) {
    const long long g = base + i;
    sc[i] = g < w ? src[g] : 4;
  }
  __syncthreads();

  const int p0 = threadIdx.x * RUN;
  uint64_t f = 0, r = 0;
  int bad = 0;
  for (int t = 0; t < k; ++t) {
    int c = sc[p0 + t];
    bad += c >= 4;
    c = c >= 4 ? 0 : c;
    f = rol(f, 1) ^ seed_f(c);
    r ^= rol(seed_r(c), t);
  }
  uint64_t* mine = sk + threadIdx.x * (RUN + 1);
  for (int j = 0; j < RUN; ++j) {
    if (j > 0) {
      int co = sc[p0 + j - 1];
      int ci = sc[p0 + j - 1 + k];
      bad += (ci >= 4) - (co >= 4);
      co = co >= 4 ? 0 : co;
      ci = ci >= 4 ? 0 : ci;
      f = rol(f, 1) ^ rol(seed_f(co), k) ^ seed_f(ci);
      r = rol(r ^ seed_r(co), 63) ^ rol(seed_r(ci), k - 1);
    }
    const uint64_t h = f < r ? f : r;
    mine[j] = bad ? INF : h;
  }
  __syncthreads();

  int64_t* dst = out + (size_t)row * n;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long g = base + i;
    if (g < n) dst[g] = (int64_t)(sk[i + i / RUN] ^ SIGN);
  }
}

}  // namespace

// codes: uint8 [rows, w] (device, contiguous); out: int64 [rows, w-k+1].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int miekki_hash_windows(const uint8_t* codes, int64_t* out, int rows,
                                   int w, int k, void* stream) {
  const int n = w - k + 1;
  if (rows <= 0 || n <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, (n + TILE - 1) / TILE);
  hash_windows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(codes, out, w, n, k);
  return (int)cudaGetLastError();
}
