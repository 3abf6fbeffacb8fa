// Kernel K1: canonical ntHash-v1 of every k-window of uint8 code rows,
// written as int64 order keys (u64 ^ 2^63; INT64_MAX = invalid window, a
// window that holds any code > 3).
//
// Replaces miekki_tpu/ops/pallas_hash.py:42 hash_windows_pallas (body
// _hash_kernel at :34; the math is miekki_tpu/ops/hash.py:103
// hash_block_math).  Plain torch version and spec of the output:
// miekki_tpu_torch/ops/hash.py::hash_windows.
//
// Bound on the H100: memory.  A [R, W] call reads each code once (1 B) and
// writes one 8 B key per window, R*W + 8*R*(W-k+1) bytes over 3.35 TB/s;
// at R = 1024, W = 8222 (the sketch path's step) that is 75.5 MB, 0.0225
// ms, nine tenths of it the store.  The roll is ~24 int32 operations per
// window (0.012 ms at the card's INT32 rate), so the kernel has to keep the
// store streaming while it hashes.
//
// Design: a persistent kernel.  The grid is the number of blocks that fit
// on the card at once; block b walks the work items (row, span of 4,096
// windows) b, b + grid, ...  Each of its 4 warps owns 1,024 windows of the
// item and runs on its own, with no block barrier after the tables are
// built:
//   load:  the warp copies its item's codes (1,024 + k - 1 of them) into
//          one of its two shared buffers with 16-byte cp.async, from the
//          16-byte boundary at or below the first code (rows are W bytes
//          wide, so they rarely start on one; the offset is carried).  The
//          next item's copy is issued before the current item is hashed.
//          Every 16-byte chunk copied holds at least one code of the item.
//   hash:  each lane hashes a run of 32 consecutive windows.  It reads its
//          codes as aligned words (funnel-shifted by the offset), seeds the
//          first window from a table of rotated seeds (one lookup per
//          code), and rolls the other 31 with one lookup each in a table of
//          the 16 (outgoing, incoming) code pairs:
//            F' = rol(F, 1) ^ rol(seedF[co], k) ^ seedF[ci]
//            R' = ror(R, 1) ^ ror(seedR[co], 1) ^ rol(seedR[ci], k - 1)
//          A window is valid while the last invalid code read lies before
//          it.  Keys go to the lane's row of a shared buffer (rows of 33,
//          so that the lanes' writes fall in different banks).
//   store: the warp writes its 1,024 contiguous keys with 16-byte
//          streaming stores (evict-first) as soon as its lanes have them.
//          Where a row's keys do not start on a 16-byte boundary (row * n
//          odd), the first key goes alone.
// The canonical hash is the unsigned 64-bit min(F, R).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RUN = 32;                    // consecutive windows hashed by a lane
constexpr int WARP_SPAN = 32 * RUN;        // 1,024 windows per warp and item
constexpr int SPAN = WARPS * WARP_SPAN;    // 4,096 windows per work item
constexpr int MAX_K = 64;
// a warp's code buffer: offset (< 16) + 1,024 + 63 codes in 16-byte
// chunks (1,104 B), and the words read past them by the last lane
constexpr int STAGE = 1120;
constexpr int ROW = RUN + 1;               // u64 per lane row in shared memory
constexpr int MAX_DEVICES = 64;
constexpr u64 SIGN = 1ull << 63;
constexpr u64 INF_KEY = ~0ull ^ SIGN;      // INT64_MAX

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A warp's share of a work item: windows [lo, lo + cnt) of row `row`
// (cnt <= 0: none).
struct Part {
  long long row, lo;
  int cnt;
};

__device__ __forceinline__ Part part_of(long long item, long long items, int spans, int n,
                                        int warp) {
  Part p{0, 0, 0};
  if (item < items) {
    p.row = item / spans;
    p.lo = (item - p.row * spans) * SPAN + warp * WARP_SPAN;
    p.cnt = (int)min((long long)WARP_SPAN, n - p.lo);
  }
  return p;
}

// Issue the copies of part p's codes [lo, lo + cnt + k - 1) into buf;
// returns the offset of its first code in buf.
__device__ __forceinline__ int stage(uint8_t* buf, const uint8_t* codes, const Part& p,
                                     int w, int k, int lane) {
  if (p.cnt <= 0) return 0;
  const uint8_t* src = codes + p.row * w + p.lo;
  const int off = (int)((uintptr_t)src & 15);
  const uint8_t* from = src - off;
  const int chunks = (off + p.cnt + k - 1 + 15) >> 4;
  for (int c = lane; c < chunks; c += 32) cp_async16(buf + 16 * c, from + 16 * c);
  return off;
}

// Codes [4 q, 4 q + 4) of a lane's run for q < Q, from the aligned words
// at `wp`, shifted down by `sh` bits (the byte offset of the run's first
// code, times 8).
template <int Q>
__device__ __forceinline__ void load_codes(uint32_t (&c)[Q], const uint32_t* wp, int sh) {
  uint32_t raw[Q + 1];
#pragma unroll
  for (int q = 0; q <= Q; ++q) raw[q] = wp[q];
#pragma unroll
  for (int q = 0; q < Q; ++q) c[q] = __funnelshift_r(raw[q], raw[q + 1], sh);
}

// Seed steps for codes [4 * Q0, 4 * Q0 + 32) of the window, those below k.
template <int Q0>
__device__ __forceinline__ void seed(const uint32_t (&c)[8], const ulonglong2* seed_tab, int k,
                                     u64& f, u64& r, int& bad) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int pos = 4 * Q0 + i;
    if (pos < k) {
      const uint32_t code = (c[i >> 2] >> (8 * (i & 3))) & 0xFF;
      if (code > 3) bad = pos;
      const ulonglong2 s = seed_tab[pos * 4 + (code & 3)];
      f ^= s.x;
      r ^= s.y;
    }
  }
}

__device__ __forceinline__ u64 key(u64 f, u64 r, bool valid) {
  return valid ? (f < r ? f : r) ^ SIGN : INF_KEY;
}

// Hash the 32 windows whose first code is byte `b` of `buf` into my_row.
__device__ __forceinline__ void hash_run(const uint8_t* buf, int b, int k,
                                         const ulonglong2* seed_tab, const ulonglong2* roll_tab,
                                         u64* my_row) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf);
  uint32_t o[8];  // codes 0..31: the outgoing code of windows 1..32, seeds
  load_codes(o, words + (b >> 2), 8 * (b & 3));
  u64 f = 0, r = 0;
  int bad = -1;  // position of the last invalid code read
  seed<0>(o, seed_tab, k, f, r, bad);
  if (k > 32) {
    uint32_t o2[8];  // codes 32..63
    load_codes(o2, words + (b >> 2) + 8, 8 * (b & 3));
    seed<8>(o2, seed_tab, k, f, r, bad);
  }
  my_row[0] = key(f, r, bad < 0);

  uint32_t in[8];  // codes k..k+31: the incoming code of windows 1..32
  load_codes(in, words + ((b + k) >> 2), 8 * ((b + k) & 3));
  uint32_t pair[8], inv[8];  // per byte: roll_tab byte offset; invalid bits
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    pair[q] = ((o[q] & 0x03030303u) << 6) | ((in[q] & 0x03030303u) << 4);
    inv[q] = in[q] & 0xFCFCFCFCu;
  }
  const char* roll = reinterpret_cast<const char*>(roll_tab);
#pragma unroll
  for (int j = 1; j < RUN; ++j) {
    const int q = (j - 1) >> 2, sh = 8 * ((j - 1) & 3);
    if ((inv[q] >> sh) & 0xFF) bad = j - 1 + k;
    const ulonglong2 s = *reinterpret_cast<const ulonglong2*>(roll + ((pair[q] >> sh) & 0xFF));
    f = rol(f, 1) ^ s.x;
    r = rol(r, 63) ^ s.y;
    my_row[j] = key(f, r, bad < j);
  }
}

// 16-byte store marked evict-first: the keys are not read again here.
__device__ __forceinline__ void store_pair(int64_t* dst, u64 a, u64 b) {
  asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};\n" ::"l"(dst), "l"(a), "l"(b) : "memory");
}

// Write keys [0, cnt) of the warp's rows to dst[0, cnt), 16 bytes a lane.
__device__ __forceinline__ void store_keys(const u64* rows, int64_t* dst, int cnt, int lane) {
  const int first = (int)(((uintptr_t)dst >> 3) & 1);  // first key on a 16-byte boundary
  if (first && lane == 0) dst[0] = (int64_t)rows[0];
  for (int x = first + 2 * lane; x < cnt; x += 64) {
    const u64 a = rows[(x >> 5) * ROW + (x & 31)];
    if (x + 1 < cnt) {
      const u64 b = rows[((x + 1) >> 5) * ROW + ((x + 1) & 31)];
      store_pair(dst + x, a, b);
    } else {
      dst[x] = (int64_t)a;
    }
  }
}

// grid: at most the resident block count; block: THREADS.  Work item
// i = row * spans + span covers windows [span * SPAN, span * SPAN + SPAN)
// of a row.
__global__ void __launch_bounds__(THREADS)
hash_windows_kernel(const uint8_t* __restrict__ codes, int64_t* __restrict__ out, int w, int n,
                    int k, int spans, long long items) {
  __shared__ __align__(16) uint8_t stage_buf[WARPS][2][STAGE];
  __shared__ ulonglong2 seed_tab[MAX_K * 4];  // [i * 4 + c]: code c at offset i of a window
  __shared__ ulonglong2 roll_tab[16];         // [co * 4 + ci]: code co leaves, ci enters
  __shared__ u64 runs[THREADS * ROW];         // lane t of warp v: row v * 32 + t

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  long long item = blockIdx.x;
  Part cur = part_of(item, items, spans, n, warp);
  int off = stage(stage_buf[warp][0], codes, cur, w, k, lane);
  cp_async_commit();

  // F = XOR_i rol(seedF[c_i], k - 1 - i), R = XOR_i rol(seedR[c_i], i)
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

  u64* rows = runs + warp * 32 * ROW;
  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    const Part next = part_of(item + gridDim.x, items, spans, n, warp);
    const int next_off = stage(stage_buf[warp][buf ^ 1], codes, next, w, k, lane);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    if (cur.cnt > 0) {
      hash_run(stage_buf[warp][buf], off + lane * RUN, k, seed_tab, roll_tab, rows + lane * ROW);
      __syncwarp();
      store_keys(rows, out + cur.row * n + cur.lo, cur.cnt, lane);
    }
    __syncwarp();  // this item's codes and keys are read before they are overwritten
    cur = next;
    off = next_off;
  }
}

// Resident blocks of the kernel on the current device (computed once per
// device).
cudaError_t resident_blocks(int* blocks_per_sm, int* sms) {
  static int cached[MAX_DEVICES][2];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < MAX_DEVICES && cached[device][0] > 0) {
    *blocks_per_sm = cached[device][0];
    *sms = cached[device][1];
    return cudaSuccess;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, hash_windows_kernel, THREADS,
                                                    0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && *blocks_per_sm <= 0) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess && device < MAX_DEVICES) {
    cached[device][1] = *sms;
    cached[device][0] = *blocks_per_sm;
  }
  return e;
}

}  // namespace

// codes: uint8 [rows, w] (device, contiguous, any alignment); out: int64
// [rows, w - k + 1] (device, contiguous).  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int miekki_hash_windows(const uint8_t* codes, int64_t* out, int rows, int w, int k,
                                   void* stream) {
  const int n = w - k + 1;
  if (rows <= 0 || n <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t e = resident_blocks(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const int spans = (n + SPAN - 1) / SPAN;
  const long long items = (long long)rows * spans;
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(items < resident ? items : resident);
  hash_windows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(codes, out, w, n, k, spans,
                                                                   items);
  return (int)cudaGetLastError();
}

// Threads per block, resident blocks per SM, the SM's thread limit and the
// SM count (the persistent grid is blocks per SM x SMs); registers and
// shared memory are in the ptxas log.  Returns a CUDA error (0 = success).
extern "C" int miekki_hash_windows_info(int* threads_per_block, int* blocks_per_sm,
                                        int* threads_per_sm, int* sms) {
  *threads_per_block = THREADS;
  cudaError_t e = resident_blocks(blocks_per_sm, sms);
  int device = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  return (int)e;
}
