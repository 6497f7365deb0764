// Hand-written Hopper (sm_90a) kernels for MergePipe's blockwise merge
// operators: AVG / TA (linear), TIES and DARE; the TIES trim threshold
// (a radix select, design note above ties_threshold_kernel); the whole
// TIES merge in one thread-block-cluster launch (design note above
// ties_fused_kernel); and the ANALYZE sketch (per-block Σx², max|x|, Σx),
// whose design note is above sketch_kernel.
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
// Design, shared by the three kernels
// -----------------------------------
// What bounds them: HBM bytes.  Merging does under one operation per
// byte, so the least time is (bytes read + bytes written) / bandwidth.
// At the main path's largest window group (NB = 32, K = 4, W = 65,536,
// float32 inputs) the linear kernel moves 8.4 MB of x0 + 33.6 MB of D +
// 8.4 MB of output = 50.3 MB: about 15 us at the H100 SXM data sheet's
// 3.35 TB/s.  TIES adds NB*K thresholds, DARE 8.4 MB of masks.
//
// What the design does about it: every input byte is read from HBM once
// (TIES reads D twice, but the second pass hits L1/L2: a 256-thread
// block's K rows are 16 KB at K = 4), every output byte is written once,
// and the K reduction stays in registers.  One thread owns 4 consecutive
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
// AVG passes mul = 1, div = K + 1; TA passes mul = lam, div = 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
linear_kernel(const float* __restrict__ x0, const float* __restrict__ D,
              float* __restrict__ out, int K, int64_t W, float mul, float div) {
  const int64_t b = blockIdx.y;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (w >= W) return;
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

// -------------------------------------------------------------------- TIES
// Replaces repro/kernels/merge_block.py::_ties_kernel (ties_merge_pallas).
// keep |D| >= t[b,k]; elected = sign(sum of kept); mean of the kept
// entries whose sign equals a nonzero elected sign (count floored at 1);
// out = x0 + lam * mean.  The block's K thresholds are loaded once into
// shared memory.
template <int V>
__global__ void __launch_bounds__(kThreads)
ties_kernel(const float* __restrict__ x0, const float* __restrict__ D,
            const float* __restrict__ thresh, float* __restrict__ out,
            int K, int64_t W, double lam) {
  extern __shared__ float s_t[];
  const int64_t b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += kThreads) s_t[k] = thresh[b * K + k];
  __syncthreads();
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (w >= W) return;
  const float* d = D + b * K * W + w;

  float el[V], t[V];
  for (int k = 0; k < K; ++k) {
    load_f<V>(d + k * W, t);
    const float th = s_t[k];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float dt = fabsf(t[i]) >= th ? t[i] : 0.0f;
      el[i] = k == 0 ? dt : __fadd_rn(el[i], dt);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) el[i] = sgn(el[i]);

  float num[V];
  int cnt[V];
  for (int k = 0; k < K; ++k) {
    load_f<V>(d + k * W, t);
    const float th = s_t[k];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool keep = fabsf(t[i]) >= th;
      const float dt = keep ? t[i] : 0.0f;
      const bool agree = keep && el[i] != 0.0f && sgn(dt) == el[i];
      const float a = agree ? dt : 0.0f;
      num[i] = k == 0 ? a : __fadd_rn(num[i], a);
      cnt[i] = (k == 0 ? 0 : cnt[i]) + (agree ? 1 : 0);
    }
  }
  load_f<V>(x0 + b * W + w, t);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const double mean = __ddiv_rn(static_cast<double>(num[i]),
                                  static_cast<double>(cnt[i] > 1 ? cnt[i] : 1));
    t[i] = __double2float_rn(
        __dadd_rn(static_cast<double>(t[i]), __dmul_rn(lam, mean)));
  }
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
// canonicalise it): these uint32 patterns order like the values (-0.0
// becomes +0.0, +inf sits above every finite value, NaN above +inf, as
// np.partition puts NaN last), so the keep-th largest |x| is the keep-th
// largest key.  Four passes settle its bits 8 at a time from the top byte
// down.  Each pass histograms, into 256 bins in shared memory, the next
// byte of every element whose higher bytes equal the prefix settled so far
// (a warp whose elements are all out of the prefix skips the histogram);
// then one warp scans the bins from the top and picks the one holding
// rank `keep` from the top.  After the fourth pass the prefix is the
// threshold's bit pattern.
//
// What bounds it: HBM bytes (W * 4 per row read, 4 written), about one
// operation per byte.  Design: one CTA of kSelThreads threads per row; each
// thread issues kSelUnroll float4 loads before it histograms them, so
// enough bytes are in flight to cover the memory latency (a scalar head up
// to the row's first 16-byte boundary and a scalar tail, so any W and any
// row offset work).  The first pass reads the row from HBM; the later three
// re-read it and find it in L2 (a launch of the merge path holds at most
// 32 x 4 rows of 256 KiB, 32 MiB, under the 50 MB L2).  A register-resident
// row does not fit one SM: 65,536 floats are its whole register file.
// Histogram updates are plain shared-memory atomics, one a lane, except
// when a whole warp holds one byte (runs of equal values, such as an
// all-zero delta row), which adds 32 with one atomic.  Two designs tried
// on the H100 at (NB, K, W) = (9, 4, 65,536) ran slower: warp-aggregated
// atomics (one __match_any_sync per element), and a row split over a
// thread block cluster (histograms summed through distributed shared
// memory, two cluster barriers per pass).  What it gives up: a launch of
// few rows leaves most SMs idle.
constexpr int kSelThreads = 1024;
constexpr int kSelUnroll = 4;

// Add one to hist[byte of u] for every lane with `cand`; every lane of the
// warp calls it together.
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

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

__global__ void __launch_bounds__(kSelThreads)
ties_threshold_kernel(const float* __restrict__ D, float* __restrict__ out,
                      int64_t W, unsigned keep) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_bucket, s_above;
  const float* row = D + static_cast<int64_t>(blockIdx.x) * W;
  const int tid = threadIdx.x, lane = tid % 32;
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4;
  if (head > W) head = W;
  const int64_t n4 = (W - head) / 4;
  const int64_t tail0 = head + 4 * n4;       // tail: [tail0, W), < 4 elements
  const int extra = static_cast<int>(head + (W - tail0));  // <= 6
  const float4* body = reinterpret_cast<const float4*>(row + head);

  uint32_t prefix = 0, pmask = 0;
  unsigned krem = keep;  // rank from the top among the prefix's elements
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    // a CTA-uniform trip count: every lane reaches each warp vote
    for (int64_t base = 0; base < n4; base += kSelThreads * kSelUnroll) {
      float4 x[kSelUnroll];
#pragma unroll
      for (int j = 0; j < kSelUnroll; ++j) {
        const int64_t i = base + j * kSelThreads + tid;
        x[j] = i < n4 ? body[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kSelUnroll; ++j) {
        const bool in = base + j * kSelThreads + tid < n4;
        const uint32_t u[4] = {abs_bits(x[j].x), abs_bits(x[j].y),
                               abs_bits(x[j].z), abs_bits(x[j].w)};
        bool c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = in && (u[e] & pmask) == prefix;
        if (__any_sync(0xffffffffu, c[0] || c[1] || c[2] || c[3])) {
#pragma unroll
          for (int e = 0; e < 4; ++e) hist_add(hist, u[e], c[e], shift);
        }
      }
    }
    if (tid < 32) {  // the scalar head and tail, one a lane
      const bool in = tid < extra;
      const int64_t j = tid < head ? tid : tail0 + (tid - head);
      const uint32_t u = in ? abs_bits(row[j]) : 0u;
      hist_add(hist, u, in && (u & pmask) == prefix, shift);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 255 - 8l down to 248 - 8l; an inclusive scan of
      // the lanes' sums counts the candidates above each lane's bins
      unsigned cnt[8], local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - 8 * lane - j];
        local += cnt[j];
      }
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      const unsigned excl = incl - local;
      if (excl < krem && krem <= incl) {  // exactly one lane
        unsigned run = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + cnt[j] >= krem) {
            s_bucket = 255u - 8u * lane - j;
            s_above = run;
            break;
          }
          run += cnt[j];
        }
      }
    }
    __syncthreads();
    krem -= s_above;
    prefix |= s_bucket << shift;
    pmask |= 0xFFu << shift;
    __syncthreads();  // s_bucket, s_above and hist are rewritten next pass
  }
  if (tid == 0) out[blockIdx.x] = __uint_as_float(prefix);
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
// launch (5, 3, 65,536) 6.6 MB, 2.0 us at 3.35 TB/s.  The pair it
// replaces reads D from HBM once and three more times from L2 for the
// threshold, twice more for the apply, and launches twice; at that launch
// the threshold runs 15 CTAs on 132 SMs.
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
// faster: ties_route in kernels/merge_block.py sends it launches of up to
// 60 rows whose slices fit in 227 KB (it mirrors fused_plan below;
// chip_smoke.py times both routes on each side of that line).
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

// Histogram 4 keys a lane (256: not a candidate) into h; every lane of the
// warp calls it together.  A warp whose 128 keys are one bin (an all-zero
// row, runs of equal values) adds 128 with one atomic; otherwise one
// atomic a candidate.
__device__ __forceinline__ void hist_add4(unsigned* h, const unsigned (&key)[4]) {
  const unsigned k0 = __shfl_sync(0xffffffffu, key[0], 0);
  const bool same = key[0] == k0 && key[1] == k0 && key[2] == k0 && key[3] == k0;
  if (__all_sync(0xffffffffu, same)) {
    if (k0 < 256u && threadIdx.x % 32 == 0) atomicAdd(&h[k0], 128u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key[e] < 256u) atomicAdd(&h[key[e]], 1u);
  }
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
          if (__any_sync(0xffffffffu, any)) hist_add4(h, key);
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

int mb_linear(const void* x0, const void* D, void* out, int nb, int k,
              long long w, float mul, float div, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  auto* o = static_cast<float*>(out);
  if (w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16)) {
    linear_kernel<4><<<grid_for(nb, w, 4), kThreads, 0, s>>>(x, d, o, k, w, mul, div);
  } else {
    linear_kernel<1><<<grid_for(nb, w, 1), kThreads, 0, s>>>(x, d, o, k, w, mul, div);
  }
  return static_cast<int>(cudaGetLastError());
}

int mb_ties(const void* x0, const void* D, const void* thresh, void* out,
            int nb, int k, long long w, double lam, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x0);
  const auto* d = static_cast<const float*>(D);
  const auto* t = static_cast<const float*>(thresh);
  auto* o = static_cast<float*>(out);
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  if (w % 4 == 0 && aligned(x0, 16) && aligned(D, 16) && aligned(out, 16)) {
    ties_kernel<4><<<grid_for(nb, w, 4), kThreads, smem, s>>>(x, d, t, o, k, w, lam);
  } else {
    ties_kernel<1><<<grid_for(nb, w, 1), kThreads, smem, s>>>(x, d, t, o, k, w, lam);
  }
  return static_cast<int>(cudaGetLastError());
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

// rows: NB * K rows of w floats; keep in [1, w).  One CTA per row.
int mb_ties_threshold(const void* D, void* out, int rows, long long w,
                      int keep, void* stream) {
  if (rows <= 0 || w <= 1 || keep < 1 || keep >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  ties_threshold_kernel<<<static_cast<unsigned>(rows), kSelThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<float*>(out), w,
      static_cast<unsigned>(keep));
  return static_cast<int>(cudaGetLastError());
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
