// Hand-written Hopper (sm_90a) kernels for MergePipe's blockwise merge
// operators: AVG / TA (linear) and DARE; the ANALYZE sketch (per-block
// Σx², max|x|, Σx), whose design note is above sketch_kernel; and TIES on
// two routes: the whole merge in one thread-block-cluster launch (design
// note above ties_fused_kernel), or the pair of a grid-wide radix select
// of the trim thresholds (design note above ties_threshold_kernel) and a
// staged apply (design note above ties_kernel).
//
// Shapes (the executor's batched layout, all row-major and contiguous):
//   x0     (NB, W)     float32   base blocks
//   D      (NB, K, W)  float32   stacked expert deltas
//   thresh (NB, K)     float32   TIES trim thresholds (may be -inf)
//   masks  (NB, K, W)  uint8     DARE keep masks (0 / 1)
//   out    (NB, W)     float32
//
// Each C entry point takes device pointers, NB, K, W, the operator's
// scalars and a cudaStream_t (PyTorch's current stream), launches one
// kernel, and returns cudaGetLastError().  Nothing is allocated here and
// nothing synchronises: the Python wrapper (kernels/merge_block.py) owns
// the output tensor and checks the return code.
//
// Design of the linear and DARE kernels
// -------------------------------------
// What bounds them: HBM bytes.  Merging does under one operation per
// byte, so the least time is (bytes read + bytes written) / bandwidth.
// At the main path's largest window group (NB = 32, K = 4, W = 65,536,
// float32 inputs) the linear kernel moves 8.4 MB of x0 + 33.6 MB of D +
// 8.4 MB of output = 50.3 MB: about 15 us at the H100 SXM data sheet's
// 3.35 TB/s.  DARE adds 8.4 MB of masks.
//
// What the design does about it: every input byte is read from HBM once,
// every output byte is written once, and the K reduction stays in
// registers.  One thread owns 4 consecutive
// elements and moves them with 16-byte float4 loads when W % 4 == 0 and
// the pointers are 16-byte aligned (4-byte uchar4 loads for masks);
// otherwise one element with scalar loads.  The grid is
// ceil(W / (256 * V)) x NB.
//
// What the simple design gives up: no TMA, no cp.async pipeline, no
// persistent grid.  The card's latency hiding rests on many resident
// blocks alone.  That work belongs to later changes.
//
// Arithmetic: each kernel repeats the host numpy operator's float
// operations in the same order (core/operators.py), so its output is
// bit-identical to the stream engine's: the K sum starts from row 0 and
// adds rows in order, products and sums are rounded one by one
// (__fmul_rn / __fadd_rn forbid fused multiply-add), and TIES finishes
// in double precision, as numpy promotes its integer count there.  The
// Pallas kernels compute the same functions with other rounding, within
// 1e-5.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load_f(const float* __restrict__ p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_m(const uint8_t* __restrict__ p, bool (&r)[V]) {
  if constexpr (V == 4) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(p);
    r[0] = v.x != 0; r[1] = v.y != 0; r[2] = v.z != 0; r[3] = v.w != 0;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = p[i] != 0;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* __restrict__ p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r[i];
  }
}

__device__ __forceinline__ float sgn(float x) {
  // sign(+-0) = 0, as jnp.sign / np.sign
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// NaN propagation of the host's float32 arithmetic (x86 SSE: what numpy's
// operators, the stream engine and the CPU path run): an operation with a
// NaN operand returns its first NaN operand, quieted; an invalid one
// (inf - inf, 0 * inf) returns the default NaN 0xFFC00000.  The card's
// float32 arithmetic returns 0x7FFFFFFF for both, so without this a NaN
// output's sign (all the bf16 downcast keeps of a NaN) could differ from
// the stream engine's.  Every non-NaN result is the card's own, bit for
// bit.  (The TIES kernels' float64 epilogue keeps the operand's NaN.)
__device__ __forceinline__ float host_nan(float a, float b, float r) {
  if (a != a) return __int_as_float(__float_as_int(a) | 0x00400000);
  if (b != b) return __int_as_float(__float_as_int(b) | 0x00400000);
  return r != r ? __int_as_float(static_cast<int>(0xFFC00000u)) : r;
}
__device__ __forceinline__ float hadd(float a, float b) {
  return host_nan(a, b, __fadd_rn(a, b));
}
__device__ __forceinline__ float hmul(float a, float b) {
  return host_nan(a, b, __fmul_rn(a, b));
}
__device__ __forceinline__ float hdiv(float a, float b) {
  return host_nan(a, b, __fdiv_rn(a, b));
}

// ---------------------------------------------------------------- AVG / TA
// Replaces repro/kernels/merge_block.py::_linear_kernel
// (linear_merge_pallas).  out = x0 + (mul * sum_k D_k) / div:
// AVG passes mul = 1, div = K + 1; TA passes mul = lam, div = 1.  With
// kRows, row b divides by div_rows[b] instead of div: the whole-shard
// AVG, whose rows hold k_sel selected experts and zero rows for the rest
// (divisor k_sel + 1).  The pipelined path launches kRows = false, the
// code it always ran.
template <int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
linear_kernel(const float* __restrict__ x0, const float* __restrict__ D,
              float* __restrict__ out, int K, int64_t W, float mul, float div,
              const float* __restrict__ div_rows) {
  const int64_t b = blockIdx.y;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (w >= W) return;
  if (kRows) div = div_rows[b];
  const float* d = D + b * K * W + w;
  float acc[V], t[V];
  load_f<V>(d, acc);
  for (int k = 1; k < K; ++k) {
    load_f<V>(d + k * W, t);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = hadd(acc[i], t[i]);
  }
  load_f<V>(x0 + b * W + w, t);
#pragma unroll
  for (int i = 0; i < V; ++i)
    t[i] = hadd(t[i], hdiv(hmul(mul, acc[i]), div));
  store_f<V>(out + b * W + w, t);
}

// -------------------------------------------------------------------- DARE
// Replaces repro/kernels/merge_block.py::_dare_kernel (dare_merge_pallas).
// out = x0 + lam * sum_k(m_k ? D_k / density : 0).  The masks come from
// the host Philox generator, so plans stay repeatable bit for bit.
template <int V>
__global__ void __launch_bounds__(kThreads)
dare_kernel(const float* __restrict__ x0, const float* __restrict__ D,
            const uint8_t* __restrict__ masks, float* __restrict__ out,
            int K, int64_t W, float density, float lam) {
  const int64_t b = blockIdx.y;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (w >= W) return;
  const float* d = D + b * K * W + w;
  const uint8_t* m = masks + b * K * W + w;
  float acc[V], t[V];
  bool keep[V];
  for (int k = 0; k < K; ++k) {
    load_f<V>(d + k * W, t);
    load_m<V>(m + k * W, keep);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float r = keep[i] ? hdiv(t[i], density) : 0.0f;
      acc[i] = k == 0 ? r : hadd(acc[i], r);
    }
  }
  load_f<V>(x0 + b * W + w, t);
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = hadd(t[i], hmul(lam, acc[i]));
  store_f<V>(out + b * W + w, t);
}

// ---------------------------------------------------------------- SKETCH
// Replaces repro/kernels/merge_block.py::_sketch_kernel
// (sketch_blocks_pallas).  x (NB, W) float32 -> out (NB, 3) float32, per
// row [sum x^2, max |x|, sum x]: ANALYZE's block statistics (l2, absmax
// and mean follow on the host: sqrt, copy, divide by the true width).
//
// What bounds it: HBM bytes.  Three operations per 4-byte element, so
// the least time is (NB * W * 4 + NB * 12) bytes / 3.35 TB/s; at
// ANALYZE's largest launch (NB = 1,024 rows of W = 65,536, 256 MiB) that
// is about 80 us.
//
// Design: the Pallas kernel carries its partial sums across a sequential
// grid axis of width tiles; here one 256-thread CTA owns a whole row and
// loops over it, so nothing is carried between CTAs and no second pass
// is needed.  Each thread keeps float32 partials of the three sums in
// registers, reading 16-byte float4 words (a scalar head up to the first
// 16-byte boundary of the row and a scalar tail, so any W and any row
// offset work); then warp shuffles and an 8-entry shared-memory step
// reduce the CTA.  Max propagates NaN, as np.max and torch.amax do.
// What it gives up: one row per CTA (a row of a few hundred elements
// leaves most of the CTA idle), no bf16 input, no persistent grid.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Sketch {
  float sq = 0.0f, mx = 0.0f, sm = 0.0f;
  __device__ __forceinline__ void add(float v) {
    sq = fmaf(v, v, sq);
    mx = nanmax(mx, fabsf(v));
    sm += v;
  }
};

__global__ void __launch_bounds__(kThreads)
sketch_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t W) {
  __shared__ float s_part[3][kThreads / 32];
  const float* row = x + static_cast<int64_t>(blockIdx.x) * W;
  const int tid = threadIdx.x;
  // elements before the row's first 16-byte boundary (rows are 4-byte
  // aligned, so this is 0..3)
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4;
  if (head > W) head = W;
  const int64_t n4 = (W - head) / 4;
  Sketch s;
  if (tid < head) s.add(row[tid]);
  const float4* body = reinterpret_cast<const float4*>(row + head);
#pragma unroll 4
  for (int64_t i = tid; i < n4; i += kThreads) {
    const float4 v = body[i];
    s.add(v.x); s.add(v.y); s.add(v.z); s.add(v.w);
  }
  for (int64_t i = head + 4 * n4 + tid; i < W; i += kThreads) s.add(row[i]);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.sq += __shfl_xor_sync(0xffffffffu, s.sq, off);
    s.mx = nanmax(s.mx, __shfl_xor_sync(0xffffffffu, s.mx, off));
    s.sm += __shfl_xor_sync(0xffffffffu, s.sm, off);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_part[0][warp] = s.sq;
    s_part[1][warp] = s.mx;
    s_part[2][warp] = s.sm;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / 32;
    float sq = lane < kWarps ? s_part[0][lane] : 0.0f;
    float mx = lane < kWarps ? s_part[1][lane] : 0.0f;
    float sm = lane < kWarps ? s_part[2][lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
      mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      sm += __shfl_xor_sync(0xffffffffu, sm, off);
    }
    if (lane == 0) {
      float* o = out + static_cast<int64_t>(blockIdx.x) * 3;
      o[0] = sq;
      o[1] = mx;
      o[2] = sm;
    }
  }
}

// --------------------------------------------------------- TIES THRESHOLD
// Replaces the TIES trim threshold that the JAX package computes outside
// its Pallas kernel with an XLA sort (repro/kernels/ref.py:19-29,
// `ties_thresholds`) and the numpy operator with np.partition
// (core/operators.py:172-181): per (block, expert) row of D (NB, K, W)
// float32, the keep-th largest |x|, exactly — it is an element of the row.
//
// Radix select on the bits of |x| (the sign bit cleared as an integer, so
// a NaN keeps its payload, as np.abs does; the card's abs.f32 would
// canonicalise it): these uint32 keys order like the values (-0.0 becomes
// +0.0, +inf sits above every finite value, NaN above +inf, as
// np.partition puts NaN last), so the keep-th largest |x| is the keep-th
// largest key.  Three digits settle the key's 31 bits from the top: bits
// 30..20 (the exponent and the top three mantissa bits, 2,048 bins), then
// 19..10 and 9..0 (1,024 bins each).  After the radix top-k of Zhang et
// al., "Parallel Top-K Algorithms on GPU: A Comprehensive Study and New
// Methods" (SC '23): a grid-wide histogram per digit, and a compaction of
// the keys that remain candidates.
//
// What bounds it: HBM bytes (W * 4 per row read, 4 written), about one
// operation per byte.  At (NB, K, W) = (32, 4, 65,536) that is 33.6 MB,
// 10.0 us at the H100 SXM data sheet's 3.35 TB/s.
//
// Design: two variants of one schedule, picked by sel_plan below
// (mirrored by ties_threshold_plan in kernels/merge_block.py) from the
// shape alone.  A launch of at least kSelRowMinRows = 16 rows of at most
// kSelRowMaxW = 131,072 elements takes ties_threshold_row_kernel: one
// 1,024-thread CTA a row, the histograms and the candidate stage in
// shared memory, one launch, no scratch; its second read of a row follows
// the first on the same SM while the row is in L2.  Every other launch
// (few rows, or rows too wide to stage their candidates) is sliced, so
// the grid does not depend on the number of rows: each row is cut into
// `slices` slices of `len` elements (at most 16,384 elements, at least
// 1,024, and enough slices for about 264 CTAs, two an SM), one
// kSelThreads CTA a slice, rows x slices CTAs in a 1-D grid: 264 at (1,
// 4, 1,048,576) and 270 at (5, 3, 65,536), where one CTA a row gave 4 and
// 15.  Device time on an H100 80GB HBM3 at 700 W (tools/ablate_ties_pair.py's
// "row" and "sliced" builds; PERF.md): the row variant 0.0214 ms against
// the sliced one's 0.0325 at (4, 16, 65,536), 0.0305 against 0.0456 at
// (32, 4, ·), and 0.0192 against 0.0204 at 15 rows (5, 3, ·), where the
// limit keeps the sliced kernels (where below 16 rows the two cross is
// not measured yet).
// The sliced variant runs four launches: ties_threshold_clear_kernel
// zeroes the rows' headers and first histograms, then three passes:
//   1. ties_threshold_kernel reads its slice from HBM (16-byte loads,
//      kSelUnroll in flight a thread, a scalar head to the first 16-byte
//      boundary and a scalar tail, so any W and any storage offset work;
//      an L2 evict_last hint keeps the lines for the second read),
//      histograms the first digit in shared memory and adds the non-zero
//      bins to the row's histogram in global memory.  The last CTA of the
//      row to finish (an atomic ticket after __threadfence) scans the
//      2,048 bins from the top, fixes the first digit and the rank left
//      within its bucket, decides the row's path from the bucket's exact
//      count, zeroes the row's second histogram and resets the ticket.
//   2. ties_threshold_compact_kernel re-reads each slice (from L2 where the
//      launch fits: evict_first now, it is the row's last full read), and
//      on the compact path appends the keys in the bucket to a stage in
//      shared memory (a warp-wide scan of the lanes' counts and one shared
//      atomic a warp and step), histograms the second digit from the stage
//      (every lane busy), and copies the stage to the row's candidate
//      buffer with one global reservation a CTA.  Its last CTA scans the
//      1,024 bins and fixes the second digit.
//   3. ties_threshold_finish_kernel settles the last digit (bits 9..0),
//      spread over the row's slice CTAs and a last-CTA scan: on a compact
//      row each CTA takes a share of the candidates (a 1,048,576-wide
//      Gaussian row has ~50,000, a 65,536-wide one ~3,300); on a dense
//      row (its bucket holds more keys than the buffer: an all-zero row,
//      long runs of one value, adversarial rows) each CTA its slice of
//      the row again.
// Full-row reads, in both variants: two on the compact path (one from
// HBM), three on the dense path.  The candidate buffer holds cap =
// max(1,024, ceil(W / 8)) keys a row (at most W, rounded up to 4): 8,192
// at W = 65,536, 131,072 at W = 1,048,576 (a Gaussian row's bucket holds
// ~5% of it at trim 0.3).
// Scratch (32-bit words): rows x (8 header + 2,048 + 1,024 bins + cap),
// from the wrapper's torch.empty; only the headers and the first
// histograms are zeroed (the clear kernel: a named kernel rather than a
// cudaMemsetAsync, so a profile counts it with the threshold); the
// finish's global bins reuse the first histogram's words, which pass 2
// zeroes.  Counts are exact, so a compact row never overflows its buffer
// and the path is chosen without a race.  Why launches rather than one
// persistent kernel: a grid-wide barrier would need every CTA resident,
// and launch boundaries order the passes for free; the last-CTA scans
// keep it at one launch a pass.  Histogram updates are plain shared-memory atomics, one
// a key, except when a warp's 128 keys share a bin (an all-zero row),
// which adds 128 with one atomic.  Measured on the H100 (PERF.md, tools/
// ablate_ties_pair.py, sliced): the first read runs at about a device
// copy's rate, the second costs ~60% of it (the L2 holds only part of a
// 33.5 MB launch), and copies of the shared histogram, more loads in
// flight or more CTAs did not help.  What it gives up: the sliced
// variant's scans are serial per row and each pass pays a launch and a
// last-CTA tail; the row variant leaves SMs idle below 132 rows (it is
// faster all the same from 16 rows, measured).
constexpr int kSelThreads = 256;
// one CTA a row (ties_threshold_row_kernel) for launches of at least
// kSelRowMinRows rows of at most kSelRowMaxW elements
constexpr int kRowThreads = 1024;
constexpr long long kSelRowMinRows = 16;
constexpr long long kSelRowMaxW = 131072;
constexpr int kSelUnroll = 4;
constexpr int kSelKeys = 4 * kSelUnroll;  // keys a lane gets a step
constexpr long long kSelSliceMax = 16384;
constexpr long long kSelSliceMin = 1024;
constexpr long long kSelTargetCtas = 264;
constexpr long long kSelCandMin = 1024;
constexpr int kSelHdr = 8;       // header words a row (below)
constexpr int kBins1 = 2048;     // bits 30..20
constexpr int kBins2 = 1024;     // bits 19..10, and 9..0
// header words: the ticket, the prefix settled so far, the rank left from
// the top among the prefix's keys, candidates appended, the dense flag
enum { kTicket = 0, kPrefix = 1, kKrem = 2, kCount = 3, kDense = 4 };

struct SelPlan {
  long long slices, len, cap, ctas, scratch_bytes;
  bool row;  // one CTA a row (ties_threshold_row_kernel)
};

SelPlan sel_plan(long long rows, long long w) {
  long long cap = (w + 7) / 8;
  cap = cap > kSelCandMin ? cap : kSelCandMin;
  cap = cap < w ? cap : w;
  cap = (cap + 3) / 4 * 4;
  if (rows >= kSelRowMinRows && w <= kSelRowMaxW)
    return {1, (w + 3) / 4 * 4, cap, rows, 0, true};
  const long long want = (kSelTargetCtas + rows - 1) / rows;
  const long long most = (w + kSelSliceMin - 1) / kSelSliceMin;
  const long long least = (w + kSelSliceMax - 1) / kSelSliceMax;
  long long s = want < most ? want : most;
  s = s > least ? s : least;
  long long len = (w + s - 1) / s;
  len = (len + 3) / 4 * 4;
  s = (w + len - 1) / len;
  const long long words = rows * (kSelHdr + kBins1 + kBins2 + cap);
  return {s, len, cap, rows * s, words * 4, false};
}

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

// Add one to hist[byte of u] for every lane with `cand`; every lane of the
// warp calls it together.  (The fused kernel's 8-bit digits.)
__device__ __forceinline__ void hist_add(unsigned* hist, uint32_t u,
                                         bool cand, int shift) {
  const unsigned key = cand ? (u >> shift) & 0xFFu : 256u;
  const unsigned key0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == key0)) {  // one bin for the warp
    if (key0 < 256u && threadIdx.x % 32 == 0) atomicAdd(&hist[key0], 32u);
  } else if (cand) {
    atomicAdd(&hist[key], 1u);
  }
}

// Histogram 4 keys a lane (kNone: not a candidate) into h; every lane of
// the warp calls it together.  A warp whose 128 keys are one bin (an
// all-zero row, runs of equal values) adds 128 with one atomic; otherwise
// one atomic a candidate.  (Copies of h, one per few lanes, ran no faster
// on the H100.)
template <unsigned kNone>
__device__ __forceinline__ void hist_add4(unsigned* h, const unsigned (&key)[4]) {
  const unsigned k0 = __shfl_sync(0xffffffffu, key[0], 0);
  const bool same = key[0] == k0 && key[1] == k0 && key[2] == k0 && key[3] == k0;
  if (__all_sync(0xffffffffu, same)) {
    if (k0 < kNone && threadIdx.x % 32 == 0) atomicAdd(&h[k0], 128u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key[e] < kNone) atomicAdd(&h[key[e]], 1u);
  }
}

// How for_keys loads: plain; keeping the lines in L2 for a second read
// (evict_last: the first pass, so the second finds the row in L2 rather
// than behind other lines); or letting them go (evict_first: the last
// read of the row).
enum LoadMode { kPlain, kKeep, kLast };

template <LoadMode M>
__device__ __forceinline__ float4 load4(const float4* p, uint64_t pol) {
  float4 v;
  if constexpr (M == kKeep || M == kLast) {
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p), "l"(pol));
  } else {
    v = *p;
  }
  return v;
}

template <LoadMode M>
__device__ __forceinline__ uint64_t load_policy() {
  uint64_t pol = 0;
  if constexpr (M == kKeep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  if constexpr (M == kLast)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// Call f(u, in) for the keys of p[0, n): kSelKeys a lane a call, the lanes
// of a warp together (f may use warp votes; `in` is false for padding).
// The body runs as 16-byte loads (load4<M>), kSelUnroll issued before the
// first use; the scalar head (to p's first 16-byte boundary) and tail go
// to warp 0.
template <LoadMode M = kPlain, int kT = kSelThreads, class F>
__device__ __forceinline__ void for_keys(const float* __restrict__ p,
                                         int64_t n, F&& f) {
  const uint64_t pol = load_policy<M>();
  const int tid = threadIdx.x;
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  if (head > n) head = n;
  const int64_t n4 = (n - head) / 4;
  const int64_t tail0 = head + 4 * n4;                     // < 4 elements
  const int extra = static_cast<int>(head + (n - tail0));  // <= 6
  const float4* body = reinterpret_cast<const float4*>(p + head);
  uint32_t u[kSelKeys];
  bool in[kSelKeys];
  // a CTA-uniform trip count: every lane reaches each warp vote
  for (int64_t base = 0; base < n4; base += kT * kSelUnroll) {
    float4 x[kSelUnroll];
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      const int64_t i = base + j * kT + tid;
      x[j] = i < n4 ? load4<M>(body + i, pol) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      const bool ok = base + j * kT + tid < n4;
      u[4 * j] = abs_bits(x[j].x);
      u[4 * j + 1] = abs_bits(x[j].y);
      u[4 * j + 2] = abs_bits(x[j].z);
      u[4 * j + 3] = abs_bits(x[j].w);
#pragma unroll
      for (int e = 0; e < 4; ++e) in[4 * j + e] = ok;
    }
    f(u, in);
  }
  if (tid < 32) {  // the scalar head and tail, one a lane
#pragma unroll
    for (int e = 0; e < kSelKeys; ++e) {
      u[e] = 0u;
      in[e] = false;
    }
    in[0] = tid < extra;
    const int64_t j = tid < head ? tid : tail0 + (tid - head);
    if (in[0]) u[0] = abs_bits(p[j]);
    f(u, in);
  }
}

// hist_add4 over a step's kSelKeys keys of which digit(u) is the bin of
// the keys with `in` (kNone for the others).
template <unsigned kNone, class G>
__device__ __forceinline__ void hist_keys(unsigned* h, const uint32_t (&u)[kSelKeys],
                                          const bool (&in)[kSelKeys], G digit) {
#pragma unroll
  for (int q = 0; q < kSelUnroll; ++q) {
    unsigned key[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      key[e] = in[4 * q + e] ? digit(u[4 * q + e]) : kNone;
    hist_add4<kNone>(h, key);
  }
}

// The bin of a kT * B-bin histogram (read by get(i)) that holds
// rank krem from the top (1 <= krem <= the histogram's total); every
// thread of the CTA calls it.  Returns {bin, keys in the bins above it}.
// Thread t owns bins top - B t down to top - B t - B + 1; a CTA-wide
// inclusive scan of the threads' sums counts the keys above each thread's
// bins.
template <int B, int kT = kSelThreads, class G>
__device__ __forceinline__ uint2 select_bin(G get, unsigned krem) {
  __shared__ unsigned s_warp[kT / 32];
  __shared__ uint2 s_sel;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kTop = kT * B - 1;
  unsigned cnt[B], local = 0;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    cnt[j] = get(kTop - B * tid - j);
    local += cnt[j];
  }
  unsigned incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int i = 0; i < warp; ++i) incl += s_warp[i];
  const unsigned excl = incl - local;
  if (excl < krem && krem <= incl) {  // exactly one thread
    unsigned run = excl;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (run + cnt[j] >= krem) {
        s_sel = make_uint2(static_cast<unsigned>(kTop - B * tid - j), run);
        break;
      }
      run += cnt[j];
    }
  }
  __syncthreads();
  const uint2 r = s_sel;
  __syncthreads();  // s_warp and s_sel are rewritten by a later call
  return r;
}

// Whether this CTA is the last of the row's n to take its ticket, after
// its global atomics; the last one then sees every other CTA's (each
// fenced before its ticket).
__device__ __forceinline__ bool last_cta(unsigned* ticket, unsigned n) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == n - 1;
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

// Histogram the last digit (bits 9..0) of the keys that match the 21-bit
// prefix.
__device__ __forceinline__ void last_digit(unsigned* h, const uint32_t (&u)[kSelKeys],
                                           const bool (&in)[kSelKeys],
                                           unsigned prefix) {
  bool c[kSelKeys];
#pragma unroll
  for (int e = 0; e < kSelKeys; ++e) c[e] = in[e] && (u[e] >> 10) == (prefix >> 10);
  hist_keys<kBins2>(h, u, c, [](uint32_t v) { return v & 0x3FFu; });
}

// sel_plan's scratch: headers, first histograms (these two zeroed by
// ties_threshold_clear_kernel), second histograms, candidate buffers.
struct SelScratch {
  unsigned *hdr, *hist1, *hist2, *cand;
  __device__ SelScratch(unsigned* s, long long rows)
      : hdr(s), hist1(s + rows * kSelHdr),
        hist2(s + rows * (kSelHdr + kBins1)),
        cand(s + rows * (kSelHdr + kBins1 + kBins2)) {}
};

// Add a shared histogram's non-zero bins to the row's global one.
template <int N>
__device__ __forceinline__ void flush_hist(unsigned* g, const unsigned* h) {
  for (int i = threadIdx.x; i < N; i += kSelThreads)
    if (h[i]) atomicAdd(g + i, h[i]);
}

// Zero n4 16-byte words of the scratch (the rows' headers and first
// histograms: rows x (kSelHdr + kBins1) words, a multiple of 4).
__global__ void __launch_bounds__(kSelThreads)
ties_threshold_clear_kernel(uint4* scratch, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kSelThreads) + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kSelThreads)
    scratch[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ int64_t slice_len(int64_t W, int64_t s0, long long len) {
  return W - s0 < len ? W - s0 : len;
}

__global__ void __launch_bounds__(kSelThreads)
ties_threshold_kernel(const float* __restrict__ D, unsigned* scratch,
                      long long rows, int64_t W, long long slices,
                      long long len, long long cap, unsigned keep) {
  __shared__ unsigned h[kBins1];
  const SelScratch S(scratch, rows);
  const long long row = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int64_t s0 = sl * len;
  for (int i = threadIdx.x; i < kBins1; i += kSelThreads) h[i] = 0;
  __syncthreads();
  for_keys<kKeep>(D + row * W + s0, slice_len(W, s0, len),
           [&](const uint32_t (&u)[kSelKeys], const bool (&in)[kSelKeys]) {
             hist_keys<kBins1>(h, u, in, [](uint32_t v) { return v >> 20; });
           });
  __syncthreads();
  unsigned* hdr = S.hdr + row * kSelHdr;
  unsigned* g1 = S.hist1 + row * kBins1;
  flush_hist<kBins1>(g1, h);
  if (!last_cta(hdr + kTicket, static_cast<unsigned>(slices))) return;
  const uint2 sel = select_bin<kBins1 / kSelThreads>(
      [&](int i) { return __ldcg(g1 + i); }, keep);
  unsigned* g2 = S.hist2 + row * kBins2;
  for (int i = threadIdx.x; i < kBins2; i += kSelThreads) g2[i] = 0;
  if (threadIdx.x == 0) {
    hdr[kPrefix] = sel.x << 20;
    hdr[kKrem] = keep - sel.y;
    hdr[kCount] = 0;
    hdr[kDense] = __ldcg(g1 + sel.x) > static_cast<unsigned long long>(cap);
    hdr[kTicket] = 0;
  }
}

// Dynamic shared memory: the second digit's bins, then a stage of
// min(len, cap) candidates (a compact row's slice never holds more).  A
// compact row's CTA appends its candidates to the stage in the loop (a
// warp-wide scan of the lanes' counts and one shared atomic a warp and
// step) and histograms them from the stage after it, one atomic a
// candidate with every lane busy; a dense row's CTA histograms in the
// loop.
__global__ void __launch_bounds__(kSelThreads)
ties_threshold_compact_kernel(const float* __restrict__ D, unsigned* scratch,
                              long long rows, int64_t W,
                              long long slices, long long len, long long cap) {
  extern __shared__ __align__(16) unsigned smem_sel[];
  __shared__ unsigned s_n, s_base;
  unsigned* h = smem_sel;
  unsigned* stage = smem_sel + kBins2;
  const SelScratch S(scratch, rows);
  const long long row = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int64_t s0 = sl * len;
  unsigned* hdr = S.hdr + row * kSelHdr;
  const unsigned b1 = hdr[kPrefix] >> 20;
  const bool dense = hdr[kDense] != 0;
  for (int i = threadIdx.x; i < kBins2; i += kSelThreads) h[i] = 0;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  auto digit2 = [](uint32_t v) { return (v >> 10) & 0x3FFu; };
  for_keys<kLast>(D + row * W + s0, slice_len(W, s0, len),
           [&](const uint32_t (&u)[kSelKeys], const bool (&in)[kSelKeys]) {
    bool c[kSelKeys], any = false;
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < kSelKeys; ++e) {
      c[e] = in[e] && (u[e] >> 20) == b1;
      any |= c[e];
      m += c[e];
    }
    if (!__any_sync(0xffffffffu, any)) return;
    if (dense) {
      hist_keys<kBins2>(h, u, c, digit2);
      return;
    }
    unsigned incl = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    unsigned base = 0;
    if (lane == 31) base = atomicAdd(&s_n, incl);
    unsigned pos = __shfl_sync(0xffffffffu, base, 31) + incl - m;
#pragma unroll
    for (int e = 0; e < kSelKeys; ++e)
      if (c[e]) stage[pos++] = u[e];
  });
  __syncthreads();
  if (!dense) {
    for (unsigned i = threadIdx.x; i < s_n; i += kSelThreads)
      atomicAdd(&h[digit2(stage[i])], 1u);
    if (threadIdx.x == 0) s_base = s_n ? atomicAdd(hdr + kCount, s_n) : 0u;
    __syncthreads();
    unsigned* dst = S.cand + row * cap + s_base;
    for (unsigned i = threadIdx.x; i < s_n; i += kSelThreads) dst[i] = stage[i];
  }
  flush_hist<kBins2>(S.hist2 + row * kBins2, h);
  if (!last_cta(hdr + kTicket, static_cast<unsigned>(slices))) return;
  const unsigned* g2 = S.hist2 + row * kBins2;
  const unsigned krem = hdr[kKrem];
  const uint2 sel = select_bin<kBins2 / kSelThreads>(
      [&](int i) { return __ldcg(g2 + i); }, krem);
  const unsigned prefix = hdr[kPrefix] | sel.x << 10, krem3 = krem - sel.y;
  // the finish kernel's global bins: the first histogram's words
  unsigned* g3 = S.hist1 + row * kBins1;
  for (int i = threadIdx.x; i < kBins2; i += kSelThreads) g3[i] = 0;
  if (threadIdx.x == 0) {
    hdr[kPrefix] = prefix;
    hdr[kKrem] = krem3;
    hdr[kTicket] = 0;
  }
}

// The last digit: a dense row's slice CTAs over its slices of the row, a
// compact row's over shares of its candidates; then the row's last CTA
// scans its global bins.
__global__ void __launch_bounds__(kSelThreads)
ties_threshold_finish_kernel(const float* __restrict__ D, float* __restrict__ out,
                             unsigned* scratch, long long rows, int64_t W,
                             long long slices, long long len, long long cap) {
  __shared__ unsigned h[kBins2];
  const SelScratch S(scratch, rows);
  const long long row = blockIdx.x / slices, sl = blockIdx.x % slices;
  unsigned* hdr = S.hdr + row * kSelHdr;
  const bool dense = hdr[kDense] != 0;
  const unsigned count = hdr[kCount], prefix = hdr[kPrefix], krem = hdr[kKrem];
  for (int i = threadIdx.x; i < kBins2; i += kSelThreads) h[i] = 0;
  __syncthreads();
  auto add = [&](const uint32_t (&u)[kSelKeys], const bool (&in)[kSelKeys]) {
    last_digit(h, u, in, prefix);
  };
  if (dense) {
    const int64_t s0 = sl * len;
    for_keys<kLast>(D + row * W + s0, slice_len(W, s0, len), add);
  } else {  // a share of the candidates, a multiple of 4 (16-byte aligned)
    const long long share = (count + 4 * slices - 1) / (4 * slices) * 4;
    const long long c0 = sl * share < count ? sl * share : count;
    const long long n = count - c0 < share ? count - c0 : share;
    // the compacted keys have their sign bits clear, so for_keys's
    // abs_bits leaves them as they are
    for_keys(reinterpret_cast<const float*>(S.cand + row * cap + c0), n, add);
  }
  __syncthreads();
  unsigned* g3 = S.hist1 + row * kBins1;
  flush_hist<kBins2>(g3, h);
  if (!last_cta(hdr + kTicket, static_cast<unsigned>(slices))) return;
  const uint2 sel = select_bin<kBins2 / kSelThreads>(
      [&](int i) { return __ldcg(g3 + i); }, krem);
  if (threadIdx.x == 0) {
    out[row] = __uint_as_float(prefix | sel.x);
    hdr[kTicket] = 0;
  }
}

// The whole select for one row in one CTA of kRowThreads threads, for
// launches of many rows (design note above ties_threshold_kernel): the
// same digits and compaction, with the histograms and the candidate stage
// in shared memory, so no scratch, no clearing and no ticket; the second
// read of the row follows the first on the same SM while the row is in L2.
// Dynamic shared memory: the stage of cap candidates.
__global__ void __launch_bounds__(kRowThreads)
ties_threshold_row_kernel(const float* __restrict__ D, float* __restrict__ out,
                          int64_t W, long long cap, unsigned keep) {
  extern __shared__ __align__(16) unsigned stage[];
  __shared__ unsigned h[kBins1];  // the first digit; then the second, third
  __shared__ unsigned s_n;
  const float* row = D + static_cast<int64_t>(blockIdx.x) * W;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kBins1; i += kRowThreads) h[i] = 0;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for_keys<kKeep, kRowThreads>(row, W, [&](const uint32_t (&u)[kSelKeys],
                                           const bool (&in)[kSelKeys]) {
    hist_keys<kBins1>(h, u, in, [](uint32_t v) { return v >> 20; });
  });
  __syncthreads();
  uint2 sel = select_bin<kBins1 / kRowThreads, kRowThreads>(
      [&](int i) { return h[i]; }, keep);
  const unsigned b1 = sel.x;
  unsigned krem = keep - sel.y;
  const bool dense = h[b1] > static_cast<unsigned long long>(cap);
  __syncthreads();
  for (int i = threadIdx.x; i < kBins2; i += kRowThreads) h[i] = 0;
  __syncthreads();
  auto digit2 = [](uint32_t v) { return (v >> 10) & 0x3FFu; };
  for_keys<kLast, kRowThreads>(row, W, [&](const uint32_t (&u)[kSelKeys],
                                           const bool (&in)[kSelKeys]) {
    bool c[kSelKeys], any = false;
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < kSelKeys; ++e) {
      c[e] = in[e] && (u[e] >> 20) == b1;
      any |= c[e];
      m += c[e];
    }
    if (!__any_sync(0xffffffffu, any)) return;
    if (dense) {
      hist_keys<kBins2>(h, u, c, digit2);
      return;
    }
    unsigned incl = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    unsigned base = 0;
    if (lane == 31) base = atomicAdd(&s_n, incl);
    unsigned pos = __shfl_sync(0xffffffffu, base, 31) + incl - m;
#pragma unroll
    for (int e = 0; e < kSelKeys; ++e)
      if (c[e]) stage[pos++] = u[e];
  });
  __syncthreads();
  const unsigned n = s_n;
  if (!dense)
    for (unsigned i = threadIdx.x; i < n; i += kRowThreads)
      atomicAdd(&h[digit2(stage[i])], 1u);
  __syncthreads();
  sel = select_bin<kBins2 / kRowThreads, kRowThreads>(
      [&](int i) { return h[i]; }, krem);
  const unsigned prefix = b1 << 20 | sel.x << 10;
  krem -= sel.y;
  for (int i = threadIdx.x; i < kBins2; i += kRowThreads) h[i] = 0;
  __syncthreads();
  if (!dense) {
    for (unsigned i = threadIdx.x; i < n; i += kRowThreads) {
      const uint32_t u = stage[i];
      if (u >> 10 == prefix >> 10) atomicAdd(&h[u & 0x3FFu], 1u);
    }
  } else {
    for_keys<kLast, kRowThreads>(row, W, [&](const uint32_t (&u)[kSelKeys],
                                             const bool (&in)[kSelKeys]) {
      last_digit(h, u, in, prefix);
    });
  }
  __syncthreads();
  sel = select_bin<kBins2 / kRowThreads, kRowThreads>(
      [&](int i) { return h[i]; }, krem);
  if (threadIdx.x == 0) out[blockIdx.x] = __uint_as_float(prefix | sel.x);
}

// ------------------------------------------------------------ FUSED TIES
// Replaces repro/kernels/merge_block.py::_ties_kernel (ties_merge_pallas)
// together with the threshold the JAX package leaves to an XLA sort
// (repro/kernels/ref.py:19, `ties_thresholds`): the whole TIES merge of
// x0 (NB, W) and D (NB, K, W) in one launch, bit for bit what
// ties_threshold_kernel followed by ties_kernel computes (and so the numpy
// operator, core/operators.py:174-199).
//
// What bounds it: HBM bytes, (2 NB W + NB K W) * 4: at the merge's median
// launch (5, 3, 65,536) 6.6 MB, 2.0 us at 3.35 TB/s.  The pair reads D
// twice for the threshold (once from HBM) and once more for the apply,
// in two launches (one CTA a row) or five (sliced).
//
// Design: one thread block cluster per block b, C CTAs along W (C =
// ceil(W / kMinSlice) clamped to [1, 16]; 16 at W = 65,536, a non-portable
// cluster size).  CTA c owns the slice [c S, c S + S) of every row, S =
// ceil(W / C) rounded up to 4 elements, and stages the slices of the K
// rows into dynamic shared memory with one read of HBM: 1-D bulk copies
// (cp.async.bulk, one mbarrier per row, so the first radix pass
// histograms row 0 while the later rows land) when W % 4 == 0 and x0, D
// and out are 16-byte aligned; plain loads otherwise (a ragged W, a
// storage offset).  At K = 4, W = 65,536: 64 KiB of rows and 5 KiB of
// histograms, three 384-thread CTAs an SM.
//
// The trim threshold is the radix select of ties_threshold_kernel on the
// bits of |x| (sign cleared as an integer: NaN keeps its payload and sorts
// above +inf), run for the K rows at once from shared memory, with digits
// aligned to the float's fields: the exponent (bits 30..23, where the
// sign bit of |x| is always 0), then bits 22..15, 14..7 and 7..0 (bit 7
// twice: the prefix already fixes it, so it lands in one bin).  The
// exponent digit spreads a delta row's magnitudes over more bins than the
// top byte does, which eases same-bin atomics in the first pass.  Each
// pass: every CTA histograms its slices into K local 256-bin histograms
// (one atomic a candidate, or one for a warp whose 128 keys share a bin:
// all-zero rows, runs of equal values), adds the non-zero bins through
// distributed shared memory into the cluster's histograms of that pass,
// whose 8-bin groups are spread over the CTAs (group_owner), and meets the
// cluster barrier; then every CTA scans the K cluster histograms itself
// (one warp a row, each lane reading its 8 bins from their owner as two
// 16-byte words) and narrows its K prefixes.  One set of cluster
// histograms per pass, so no set is reset while another CTA may read it.
// A last cluster arrive after the fourth scan, waited for at the very end,
// keeps every CTA's shared memory alive until the others have read it.
// Summing at one leader CTA instead was several times slower on the H100:
// sixteen CTAs' scans all read one SM's shared memory.
//
// The apply then runs from the staged slices as ties_kernel does, with x0
// read from HBM: the election and the sign-matched sum in registers, the
// mean and x0 + lam mean in float64 rounded once to float32, one HBM write
// of out.  A count that is a power of two divides by multiplying with its
// reciprocal (exact); other counts keep __ddiv_rn.  keep >= W skips the
// select: the threshold is -inf.
//
// What it gives up: each pass pays a cluster barrier and a round of
// distributed shared memory, about as much as its histogram; the load
// and the passes of one CTA do not overlap (the SM's other CTAs cover
// that); a launch of more clusters than the card holds at once runs in
// waves (chip_smoke.py prints how many it holds), and the pair is then
// faster: ties_route in kernels/merge_block.py sends it launches of at
// most 6 experts and 48 rows whose slices fit in 227 KB (it mirrors
// fused_plan below; chip_smoke.py times both routes on each side of those
// lines, by the card's time and by wall time per call: past them the
// pair, with its one-CTA-a-row threshold, won by wall).
namespace cg = cooperative_groups;

constexpr int kFusedThreads = 384;  // three CTAs an SM (<= 56 registers)
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kMaxCluster = 16;
constexpr long long kMinSlice = 2048;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a CTA may use

// Byte offsets of the fused kernel's dynamic shared memory, for K rows of
// S staged elements in a cluster of C CTAs: K delta slices, K local
// 256-bin histograms, this CTA's share of the cluster histograms (4 passes
// x K rows x at most ceil(32 / C) groups of 8 bins, group_owner), K
// prefixes, K remaining ranks, K thresholds, K mbarriers.
struct FusedLayout {
  size_t hist, ghist, prefix, krem, thr, bars, total;
  __host__ __device__ FusedLayout(int k, long long s, int c) {
    hist = static_cast<size_t>(k) * s * 4;
    ghist = hist + static_cast<size_t>(k) * 256 * 4;
    prefix = ghist + static_cast<size_t>(4 * k) * groups_per_cta(c) * 8 * 4;
    krem = prefix + static_cast<size_t>(k) * 4;
    thr = krem + static_cast<size_t>(k) * 4;
    bars = (thr + static_cast<size_t>(k) * 4 + 7) / 8 * 8;
    total = bars + static_cast<size_t>(k) * 8;
  }
  // the most 8-bin groups of a row one CTA owns
  __host__ __device__ static int groups_per_cta(int c) { return (32 + c - 1) / c; }
};

// The cluster-wide count of 8-bin group g (0..31) of every row lives at
// CTA group_owner(g, C), as its group g - group_first(owner, C): the
// groups are spread evenly over the cluster, so the histogram sums and
// the scans' reads reach every CTA's shared memory rather than one.
__device__ __forceinline__ int group_owner(int g, int C) { return (g * C) >> 5; }
__device__ __forceinline__ int group_first(int c, int C) { return (32 * c + C - 1) / C; }

struct FusedPlan {
  int cluster;
  long long slice;
  size_t smem;
};

FusedPlan fused_plan(int k, long long w) {
  long long c = (w + kMinSlice - 1) / kMinSlice;
  c = c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
  long long s = (w + c - 1) / c;
  s = (s + 3) / 4 * 4;
  return {static_cast<int>(c), s, FusedLayout(k, s, static_cast<int>(c)).total};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// 1-D bulk copy global -> this CTA's shared memory; completes `bytes` of
// the mbarrier's transaction count.  16-byte aligned, size % 16 == 0.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// TIES apply for V consecutive staged elements at column i, given their
// base values xv.
template <int V>
__device__ __forceinline__ void ties_apply_staged(const float* sD, long long S,
                                                  int K, const float* thr,
                                                  int i, double lam,
                                                  const float (&xv)[V],
                                                  float (&o)[V]) {
  float el[V], t[V];
  for (int k = 0; k < K; ++k) {
    load_f<V>(sD + k * S + i, t);
    const float th = thr[k];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float dt = fabsf(t[e]) >= th ? t[e] : 0.0f;
      el[e] = k == 0 ? dt : __fadd_rn(el[e], dt);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) el[e] = sgn(el[e]);
  float num[V];
  int cnt[V];
  for (int k = 0; k < K; ++k) {
    load_f<V>(sD + k * S + i, t);
    const float th = thr[k];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const bool keep = fabsf(t[e]) >= th;
      const float dt = keep ? t[e] : 0.0f;
      const bool agree = keep && el[e] != 0.0f && sgn(dt) == el[e];
      const float a = agree ? dt : 0.0f;
      num[e] = k == 0 ? a : __fadd_rn(num[e], a);
      cnt[e] = (k == 0 ? 0 : cnt[e]) + (agree ? 1 : 0);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const double nd = static_cast<double>(num[e]);
    const int c = cnt[e] > 1 ? cnt[e] : 1;
    // 1 / 2^j is the double with exponent field 1023 - j: exact
    const double mean =
        (c & (c - 1)) == 0
            ? __dmul_rn(nd, __longlong_as_double(
                                static_cast<long long>(1023 - (__ffs(c) - 1)) << 52))
            : __ddiv_rn(nd, static_cast<double>(c));
    o[e] = __double2float_rn(
        __dadd_rn(static_cast<double>(xv[e]), __dmul_rn(lam, mean)));
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kFusedThreads, 3)
ties_fused_kernel(const float* __restrict__ x0, const float* __restrict__ D,
                  float* __restrict__ out, float* __restrict__ thresh,
                  int K, int64_t W, long long S, unsigned keep, double lam) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(gridDim.x);  // the cluster spans grid.x
  const FusedLayout L(K, S, C);
  float* sD = reinterpret_cast<float*>(smem);  // K row slices
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
  unsigned* ghist = reinterpret_cast<unsigned*>(smem + L.ghist);
  unsigned* s_prefix = reinterpret_cast<unsigned*>(smem + L.prefix);
  unsigned* s_krem = reinterpret_cast<unsigned*>(smem + L.krem);
  float* s_thr = reinterpret_cast<float*>(smem + L.thr);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int G8 = FusedLayout::groups_per_cta(C) * 8;  // owned bins a row

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t left = W - w0;
  const int n = static_cast<int>(left < 0 ? 0 : (left < S ? left : S));
  const bool select = keep < W;

  for (int i = tid; i < K * 256; i += kFusedThreads) hist[i] = 0;
  if (select)
    for (int i = tid; i < 4 * K * G8; i += kFusedThreads) ghist[i] = 0;
  for (int k = tid; k < K; k += kFusedThreads) {
    s_prefix[k] = 0;
    s_krem[k] = keep;
  }
  const float* drow = D + b * K * W + w0;
  if constexpr (kBulk) {
    if (tid == 0) {
      for (int k = 0; k < K; ++k) mbar_init(bars + k, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n) * 4;
      for (int k = 0; k < K; ++k) {
        mbar_expect_tx(bars + k, bytes);
        if (bytes) bulk_g2s(sD + k * S, drow + k * W, bytes, bars + k);
      }
    }
  } else {
    for (int k = 0; k < K; ++k)
      for (int i = tid; i < n; i += kFusedThreads) sD[k * S + i] = drow[k * W + i];
  }

  if (select) {
    cluster.sync();  // every CTA runs; every share of the histograms is zero
    const int n4 = n / 4, tail = n % 4;
    uint32_t pmask = 0;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = pass == 0 ? 23 : pass == 1 ? 15 : pass == 2 ? 7 : 0;
      for (int k = 0; k < K; ++k) {
        if constexpr (kBulk) {
          if (pass == 0) mbar_wait(bars + k, 0);
        }
        const uint32_t pre = s_prefix[k];
        unsigned* h = hist + k * 256;
        const float4* row = reinterpret_cast<const float4*>(sD + k * S);
        // a CTA-uniform trip count: every lane reaches each warp vote
        for (int base = 0; base < n4; base += kFusedThreads) {
          const int i = base + tid;
          const bool in = i < n4;
          const float4 x = in ? row[i] : make_float4(0.f, 0.f, 0.f, 0.f);
          const uint32_t u[4] = {abs_bits(x.x), abs_bits(x.y), abs_bits(x.z),
                                 abs_bits(x.w)};
          unsigned key[4];
          bool any = false;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool c = in && (u[e] & pmask) == pre;
            key[e] = c ? (u[e] >> shift) & 0xFFu : 256u;
            any |= c;
          }
          if (__any_sync(0xffffffffu, any)) hist_add4<256u>(h, key);
        }
        if (tail != 0 && warp == 0) {  // the slice's last n % 4, one a lane
          const bool in = lane < tail;
          const uint32_t u = in ? abs_bits(sD[k * S + 4 * n4 + lane]) : 0u;
          hist_add(h, u, in && (u & pmask) == pre, shift);
        }
      }
      __syncthreads();
      // this pass's histograms summed at their owners through distributed
      // shared memory; the local bins are zeroed for the next pass
      unsigned* gpass = ghist + pass * K * G8;
      for (int i = tid; i < K * 256; i += kFusedThreads) {
        const unsigned v = hist[i];
        if (v) {
          const int k = i / 256, g = i % 256 / 8, c = group_owner(g, C);
          atomicAdd(cluster.map_shared_rank(gpass, c) + k * G8 +
                        (g - group_first(c, C)) * 8 + i % 8,
                    v);
          hist[i] = 0;
        }
      }
      cluster.sync();
      for (int k = warp; k < K; k += kFusedWarps) {
        // lane l owns bins 255 - 8l down to 248 - 8l (group 31 - l, read
        // from its owner as two 16-byte words); an inclusive scan of the
        // lanes' sums counts the candidates above each lane's bins
        const int grp = 31 - lane, c = group_owner(grp, C);
        const uint4* g = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(gpass, c) + k * G8 + (grp - group_first(c, C)) * 8);
        const uint4 lo = g[0], hi = g[1];
        const unsigned cnt[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
        const unsigned krem = s_krem[k];
        unsigned local = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) local += cnt[j];
        unsigned incl = local;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        const unsigned excl = incl - local;
        if (excl < krem && krem <= incl) {  // exactly one lane
          unsigned run = excl;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (run + cnt[j] >= krem) {
              s_prefix[k] |= (255u - 8u * lane - j) << shift;
              s_krem[k] = krem - run;
              break;
            }
            run += cnt[j];
          }
        }
      }
      pmask |= 0xFFu << shift;
      __syncthreads();
    }
    // every remote read of this cluster's histograms is done
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  }

  for (int k = tid; k < K; k += kFusedThreads)
    s_thr[k] = __uint_as_float(select ? s_prefix[k] : 0xFF800000u);  // -inf
  if constexpr (kBulk) {
    for (int k = 0; k < K; ++k) mbar_wait(bars + k, 0);
  }
  __syncthreads();
  if (thresh != nullptr && blockIdx.x == 0)
    for (int k = tid; k < K; k += kFusedThreads) thresh[b * K + k] = s_thr[k];

  const float* xrow = x0 + b * W + w0;
  float* orow = out + b * W + w0;
  const int n4 = n / 4;
  for (int i = tid; i < n4; i += kFusedThreads) {
    float xv[4], o[4];
    if constexpr (kBulk) {
      load_f<4>(xrow + 4 * i, xv);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = xrow[4 * i + e];
    }
    ties_apply_staged<4>(sD, S, K, s_thr, 4 * i, lam, xv, o);
    if constexpr (kBulk) {
      store_f<4>(orow + 4 * i, o);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[4 * i + e] = o[e];
    }
  }
  for (int i = 4 * n4 + tid; i < n; i += kFusedThreads) {
    float xv[1] = {xrow[i]}, o[1];
    ties_apply_staged<1>(sD, S, K, s_thr, i, lam, xv, o);
    orow[i] = o[0];
  }
  if (select) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The launch configuration of a plan: grid (C, NB), clusters of C CTAs.
cudaLaunchConfig_t fused_launch_config(const FusedPlan& p, int nb,
                                       cudaStream_t s,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(p.cluster), static_cast<unsigned>(nb));
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of plan p the current device holds at once (0: it
// cannot place one, and a launch would be refused).  The kernel's
// attributes are set and the answer is kept per (device, cluster size,
// shared memory): the query costs far more host time than a launch.
template <bool kBulk>
cudaError_t fused_clusters(const FusedPlan& p, int* clusters) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, std::pair<cudaError_t, int>> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, p.cluster, p.smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(key);
  if (it == seen.end()) {
    e = cudaFuncSetAttribute(ties_fused_kernel<kBulk>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ties_fused_kernel<kBulk>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n = 0;
    if (e == cudaSuccess) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = fused_launch_config(p, 1, nullptr, &attr);
      e = cudaOccupancyMaxActiveClusters(&n, ties_fused_kernel<kBulk>, &cfg);
    }
    it = seen.emplace(key, std::make_pair(e, n)).first;
  }
  *clusters = it->second.second;
  return it->second.first;
}

template <bool kBulk>
int launch_fused(const float* x, const float* d, float* o, float* t, int nb,
                 int k, long long w, unsigned keep, double lam,
                 cudaStream_t s) {
  const FusedPlan p = fused_plan(k, w);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t e = fused_clusters<kBulk>(p, &clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fused_launch_config(p, nb, s, &attr);
  e = cudaLaunchKernelEx(&cfg, ties_fused_kernel<kBulk>, x, d, o, t, k,
                         static_cast<int64_t>(w), p.slice, keep, lam);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- TIES (pair)
// Replaces repro/kernels/merge_block.py::_ties_kernel (ties_merge_pallas)
// given the trim thresholds (ties_threshold_kernel above): keep |D| >=
// t[b,k]; elected = sign(sum of kept); mean of the kept entries whose
// sign equals a nonzero elected sign (count floored at 1); out = x0 + lam
// * mean, the float64 epilogue rounded once — ties_apply_staged, the
// fused kernel's apply, bit for bit.
//
// What bounds it: HBM bytes, (2 NB W + NB K W + NB K) * 4: at (32, 4,
// 65,536) 50.3 MB, 15.0 us at 3.35 TB/s.
//
// Design: both passes (the election, then the sign-matched sum) read D
// from shared memory, so each D element crosses HBM once at any K and no
// pass relies on L1.  Work item = (block b, tile of T columns); T is the
// largest power of two <= 4,096 with K T <= 6,144 floats (apply_tile:
// 1,024 at K = 4, 256 at K = 13 to 20, 128 at K = 32), so two stages of
// K x T floats (24 KiB each at most) fit four CTAs an SM; stages of 48
// KiB were 3–17% slower at four of five shapes timed on the H100 (tools/
// ablate_ties_pair.py): more, smaller items balance the grid.  A persistent
// grid of (SMs x resident CTAs) CTAs walks the items; each CTA keeps a
// two-stage ring: thread 0 issues the K rows' 1-D bulk copies
// (cp.async.bulk, one mbarrier a stage) of the item after next while the
// CTA computes this one, so the next tile's copies are in flight during
// this tile's math.  A thread owns V consecutive columns: V = 4 (16-byte
// shared loads, x0 and out as float4) where T >= 2 x kApplyThreads (some
// threads idle when T < 4 x kApplyThreads, still faster than V = 1 on the
// H100), else V = 1.  Where W % 4 != 0 or x0, D or out is off 16 bytes the CTA stages
// each tile with plain loads instead (no ring; V = 1).  K <= kApplyMaxK =
// 256 (the wrapper refuses more).  What it gives up: a register-resident
// variant for small K; at K > 12 each thread reads 4-byte words, and at
// K > 20 fewer columns a tile than threads leave threads idle.
constexpr int kApplyThreads = 256;
constexpr int kApplyMaxK = 256;
constexpr long long kApplyStageFloats = 6144;
constexpr long long kApplyTileMax = 4096;

long long apply_tile(int k) {
  long long t = kApplyTileMax;
  while (t > 32 && t * k > kApplyStageFloats) t /= 2;
  return t;
}

size_t apply_smem(int k, long long t) {
  return static_cast<size_t>(2) * k * t * 4 + 2 * sizeof(uint64_t);
}

template <bool kBulk, int V>
__global__ void __launch_bounds__(kApplyThreads)
ties_kernel(const float* __restrict__ x0, const float* __restrict__ D,
            const float* __restrict__ thresh, float* __restrict__ out,
            int K, int64_t W, long long T, long long tiles, long long items,
            double lam) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_thr[kApplyMaxK];
  float* sD = reinterpret_cast<float*>(smem);  // [2][K][T]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * static_cast<size_t>(K) * T * 4);
  const int tid = threadIdx.x;
  const long long stride = gridDim.x;

  // thread 0: the K row copies of `item` into stage s
  auto issue = [&](long long item, int s) {
    const int64_t b = item / tiles, t0 = item % tiles * T;
    const int64_t n = W - t0 < T ? W - t0 : T;
    const uint32_t bytes = static_cast<uint32_t>(n) * 4;
    mbar_expect_tx(bars + s, bytes * K);
    for (int k = 0; k < K; ++k)
      bulk_g2s(sD + (static_cast<int64_t>(s) * K + k) * T,
               D + (b * K + k) * W + t0, bytes, bars + s);
  };
  if constexpr (kBulk) {
    if (tid == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      issue(blockIdx.x, 0);
      if (blockIdx.x + stride < items) issue(blockIdx.x + stride, 1);
    }
  }
  int i = 0;
  for (long long item = blockIdx.x; item < items; item += stride, ++i) {
    const int s = i & 1;
    const int64_t b = item / tiles, t0 = item % tiles * T;
    const int n = static_cast<int>(W - t0 < T ? W - t0 : T);
    const float* sd = sD + static_cast<int64_t>(s) * K * T;
    for (int k = tid; k < K; k += kApplyThreads) s_thr[k] = thresh[b * K + k];
    if constexpr (kBulk) {
      mbar_wait(bars + s, (i >> 1) & 1);
    } else {
      float* st = sD + static_cast<int64_t>(s) * K * T;
      for (int k = 0; k < K; ++k)
        for (int j = tid; j < n; j += kApplyThreads)
          st[k * T + j] = D[(b * K + k) * W + t0 + j];
    }
    __syncthreads();
    const float* xrow = x0 + b * W + t0;
    float* orow = out + b * W + t0;
    for (int g = tid; g < n / V; g += kApplyThreads) {  // V = 4: n % 4 == 0
      float xv[V], o[V];
      load_f<V>(xrow + V * g, xv);
      ties_apply_staged<V>(sd, T, K, s_thr, V * g, lam, xv, o);
      store_f<V>(orow + V * g, o);
    }
    __syncthreads();  // stage s and s_thr are free
    if constexpr (kBulk) {
      if (tid == 0 && item + 2 * stride < items) issue(item + 2 * stride, s);
    }
  }
}

// How many CTAs of a ties_kernel variant with `smem` bytes of dynamic
// shared memory the current device holds at once (its attribute set
// once), kept per (device, variant, smem): the query costs more host time
// than a launch.
template <bool kBulk, int V>
cudaError_t apply_ctas(size_t smem, int* ctas) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, std::pair<cudaError_t, int>> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(std::make_pair(dev, smem));
  if (it == seen.end()) {
    // the limit less the static thresholds
    e = cudaFuncSetAttribute(ties_kernel<kBulk, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit - 4 * kApplyMaxK));
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ties_kernel<kBulk, V>, kApplyThreads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    it = seen.emplace(std::make_pair(dev, smem),
                      std::make_pair(e, per_sm * sms)).first;
  }
  *ctas = it->second.second;
  return it->second.first;
}

template <bool kBulk, int V>
int launch_apply(const float* x, const float* d, const float* t, float* o,
                 int nb, int k, long long w, double lam, cudaStream_t s) {
  const long long T = apply_tile(k);
  const size_t smem = apply_smem(k, T);
  int ctas = 0;
  cudaError_t e = apply_ctas<kBulk, V>(smem, &ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ctas < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long tiles = (w + T - 1) / T, items = nb * tiles;
  const long long grid = items < ctas ? items : ctas;
  ties_kernel<kBulk, V><<<static_cast<unsigned>(grid), kApplyThreads, smem, s>>>(
      x, d, t, o, k, static_cast<int64_t>(w), T, tiles, items, lam);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

dim3 grid_for(int nb, int64_t w, int v) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * v;
  return dim3(static_cast<unsigned>((w + per_block - 1) / per_block),
              static_cast<unsigned>(nb));
}

}  // namespace

extern "C" {

// div_rows: null, or nb floats (row b divides by div_rows[b], not div).
int mb_linear(const void* x0, const void* D, void* out, int nb, int k,
              long long w, float mul, float div, const void* div_rows,
              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  const auto* r = static_cast<const float*>(div_rows);
  auto* o = static_cast<float*>(out);
  const bool v4 = w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16);
  if (r == nullptr) {
    if (v4)
      linear_kernel<4, false><<<grid_for(nb, w, 4), kThreads, 0, s>>>(x, d, o, k, w, mul, div, r);
    else
      linear_kernel<1, false><<<grid_for(nb, w, 1), kThreads, 0, s>>>(x, d, o, k, w, mul, div, r);
  } else {
    if (v4)
      linear_kernel<4, true><<<grid_for(nb, w, 4), kThreads, 0, s>>>(x, d, o, k, w, mul, div, r);
    else
      linear_kernel<1, true><<<grid_for(nb, w, 1), kThreads, 0, s>>>(x, d, o, k, w, mul, div, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pair's apply (design note above ties_kernel): k <= kApplyMaxK.
int mb_ties(const void* x0, const void* D, const void* thresh, void* out,
            int nb, int k, long long w, double lam, void* stream) {
  if (nb <= 0 || k <= 0 || k > kApplyMaxK || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  const auto* t = static_cast<const float*>(thresh);
  auto* o = static_cast<float*>(out);
  if (w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16)) {
    if (apply_tile(k) >= 2 * kApplyThreads)
      return launch_apply<true, 4>(x, d, t, o, nb, k, w, lam, s);
    return launch_apply<true, 1>(x, d, t, o, nb, k, w, lam, s);
  }
  return launch_apply<false, 1>(x, d, t, o, nb, k, w, lam, s);
}

int mb_dare(const void* x0, const void* D, const void* masks, void* out,
            int nb, int k, long long w, float density, float lam, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  const auto* m = static_cast<const uint8_t*>(masks);
  auto* o = static_cast<float*>(out);
  if (w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16) &&
      aligned(masks, 4)) {
    dare_kernel<4><<<grid_for(nb, w, 4), kThreads, 0, s>>>(x, d, m, o, k, w, density, lam);
  } else {
    dare_kernel<1><<<grid_for(nb, w, 1), kThreads, 0, s>>>(x, d, m, o, k, w, density, lam);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows: NB * K rows of w floats; keep in [1, w).  scratch: at least
// sel_plan's scratch_bytes (mb_ties_threshold_plan), 16-byte aligned;
// null for one CTA a row.  One CTA a row, or the clear kernel and the
// three passes (design note above ties_threshold_kernel).
int mb_ties_threshold(const void* D, void* out, void* scratch,
                      long long scratch_bytes, long long rows, long long w,
                      int keep, void* stream) {
  if (rows <= 0 || w <= 1 || keep < 1 || keep >= w || !aligned(scratch, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const SelPlan p = sel_plan(rows, w);
  if (scratch_bytes < p.scratch_bytes || p.ctas > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  // the kernels whose dynamic shared memory may pass 48 KB, once a device
  static std::mutex mu;
  static std::map<int, cudaError_t> attr;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = attr.find(dev);
    if (it == attr.end()) {
      cudaError_t a = cudaFuncSetAttribute(
          ties_threshold_compact_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>((kBins2 + kSelSliceMax) * sizeof(unsigned)));
      if (a == cudaSuccess)
        a = cudaFuncSetAttribute(ties_threshold_row_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSelRowMaxW / 8 * 4));
      it = attr.emplace(dev, a).first;
    }
    if (it->second != cudaSuccess) return static_cast<int>(it->second);
  }
  if (p.row) {
    ties_threshold_row_kernel<<<static_cast<unsigned>(rows), kRowThreads,
                                static_cast<size_t>(p.cap) * 4, s>>>(
        static_cast<const float*>(D), static_cast<float*>(out), w, p.cap,
        static_cast<unsigned>(keep));
    return static_cast<int>(cudaGetLastError());
  }
  const auto* d = static_cast<const float*>(D);
  auto* sc = static_cast<unsigned*>(scratch);
  const size_t stage = static_cast<size_t>(p.len < p.cap ? p.len : p.cap);
  const size_t smem = (kBins2 + stage) * sizeof(unsigned);
  const long long n4 = rows * (kSelHdr + kBins1) / 4;
  const long long clear = (n4 + kSelThreads - 1) / kSelThreads;
  ties_threshold_clear_kernel<<<static_cast<unsigned>(
      clear < kSelTargetCtas ? clear : kSelTargetCtas), kSelThreads, 0, s>>>(
      static_cast<uint4*>(scratch), n4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto grid = static_cast<unsigned>(p.ctas);
  ties_threshold_kernel<<<grid, kSelThreads, 0, s>>>(
      d, sc, rows, w, p.slices, p.len, p.cap, static_cast<unsigned>(keep));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ties_threshold_compact_kernel<<<grid, kSelThreads, smem, s>>>(
      d, sc, rows, w, p.slices, p.len, p.cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ties_threshold_finish_kernel<<<grid, kSelThreads, 0, s>>>(
      d, static_cast<float*>(out), sc, rows, w, p.slices, p.len, p.cap);
  return static_cast<int>(cudaGetLastError());
}

// The threshold's launch plan for `rows` rows of width w: out[0] slices
// a row, out[1] elements a slice, out[2] CTAs a pass, out[3] threads a
// CTA, out[4] scratch bytes, out[5] candidate capacity a row, out[6] 1 for
// one CTA a row, else 0.
int mb_ties_threshold_plan(long long rows, long long w, long long* out) {
  if (rows <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SelPlan p = sel_plan(rows, w);
  out[0] = p.slices;
  out[1] = p.len;
  out[2] = p.ctas;
  out[3] = p.row ? kRowThreads : kSelThreads;
  out[4] = p.scratch_bytes;
  out[5] = p.cap;
  out[6] = p.row ? 1 : 0;
  return 0;
}

// The whole TIES merge in one cluster launch (design note above
// ties_fused_kernel).  thresh may be null; otherwise it receives the
// (NB, K) trim thresholds.  keep in [1, W] (keep == W: every entry kept).
// Returns cudaErrorInvalidValue where the slices do not fit shared memory
// (ties_route's "pair" shapes) and cudaErrorLaunchOutOfResources where the
// card cannot place one cluster.
int mb_ties_fused(const void* x0, const void* D, void* out, void* thresh,
                  int nb, int k, long long w, int keep, double lam,
                  void* stream) {
  if (nb <= 0 || k <= 0 || w <= 0 || keep < 1 || keep > w)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  auto* o = static_cast<float*>(out);
  auto* t = static_cast<float*>(thresh);
  const auto kp = static_cast<unsigned>(keep);
  if (w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16))
    return launch_fused<true>(x, d, o, t, nb, k, w, kp, lam, s);
  return launch_fused<false>(x, d, o, t, nb, k, w, kp, lam, s);
}

// The fused kernel's launch plan for K rows of width W: out[0] cluster
// size, out[1] elements per CTA slice, out[2] dynamic shared memory bytes,
// out[3] clusters the card holds at once (bulk-copy variant).
int mb_ties_fused_plan(int k, long long w, long long* out) {
  if (k <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const FusedPlan p = fused_plan(k, w);
  out[0] = p.cluster;
  out[1] = p.slice;
  out[2] = static_cast<long long>(p.smem);
  out[3] = 0;
  if (p.smem > kSmemLimit) return 0;
  int clusters = 0;
  const cudaError_t e = fused_clusters<true>(p, &clusters);
  out[3] = clusters;
  return static_cast<int>(e);
}

int mb_sketch(const void* x, void* out, int nb, long long w, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  sketch_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
