// Hand-written Hopper (sm_90a) kernels for MergePipe's blockwise merge
// operators: AVG / TA (linear), TIES and DARE; the TIES trim threshold
// (a radix select, design note above ties_threshold_kernel); and the
// ANALYZE sketch (per-block Σx², max|x|, Σx), whose design note is above
// sketch_kernel.
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

#include <cuda_runtime.h>
#include <stdint.h>

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
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
  }
  load_f<V>(x0 + b * W + w, t);
#pragma unroll
  for (int i = 0; i < V; ++i)
    t[i] = __fadd_rn(t[i], __fdiv_rn(__fmul_rn(mul, acc[i]), div));
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
      const float r = keep[i] ? __fdiv_rn(t[i], density) : 0.0f;
      acc[i] = k == 0 ? r : __fadd_rn(acc[i], r);
    }
  }
  load_f<V>(x0 + b * W + w, t);
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = __fadd_rn(t[i], __fmul_rn(lam, acc[i]));
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

int mb_sketch(const void* x, void* out, int nb, long long w, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  sketch_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
