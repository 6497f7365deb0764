// Forward flash attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (`_fa_kernel`,
// src/repro/kernels/flash_attention.py:102) and computes what
// `repro.models.attention.flash_attention` computes (l. 92-196): a chunked
// online softmax over key tiles, GQA (kv head = q head / g, read in place),
// causal and sliding-window masks, `q_offset` for appended queries, and
// ragged Sq / Sk.  Numerics follow the reference: scores in float32 scaled
// by 1/sqrt(hd), masked scores -1e30, p = exp(s - m_new) * valid, output
// acc / max(l, 1e-30), so a fully masked row gives 0; `expf` is the
// accurate one (no fast math).
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o (B, Sq, H, hd), read
// and written through element strides (the last dimension has stride 1).
// No pad or transpose copy: the ragged q and k edges are masked here.
//
// Design.  One CTA of 256 threads owns one (b, h, 64-row q tile) and loops
// over 64-key tiles itself (the TPU kernel's sequential k grid axis becomes
// this loop).  The loop runs from the window's first reachable tile to the
// causal reach of the q tile (the `lo`/`hi` of attention.py:164-172), so
// fully masked tiles are never visited: the tile skip is a loop bound, not
// a predicate.  Skipping them is exact: such a tile leaves m, l and acc
// unchanged.  Q, K and V tiles are staged in shared memory as float32 (K
// rows padded to hd + 1 against bank conflicts); the running max m and sum l
// live in shared memory, the accumulator in registers, all float32.  Scores
// and P.V are float32 FMAs for both input types.
//
// What bounds it.  At the smoke's prefill shape, (B, Sq, Sk, H, Hkv, hd) =
// (1, 2048, 2048, 12, 2, 128) bf16 causal, the live causal half is about
// 12.9 GFLOP against about 15 MB of q, k, v and o: ~860 FLOP per byte, far
// above the card's ~295 bf16 FLOP per byte, so the bound is the tensor
// cores (13 us at 989 TFLOP/s).  This kernel does not reach it: it runs its
// products on the float32 FMA units (67 TFLOP/s peak), which keeps one code
// path exact enough for the float32 tolerance (2e-5), and each FMA needs a
// shared-memory load beside it.  Tensor-core products (mma.sync / wgmma)
// with TMA staging are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr float NEG = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;   // element strides over (b, s, h)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, sk, h, g, causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool attends(const Params& p, int qpos, int kpos) {
  bool valid = kpos < p.sk;
  if (p.causal) valid = valid && qpos >= kpos;
  if (p.window > 0) valid = valid && (qpos - kpos < p.window);
  return valid;
}

template <int HD>
constexpr int smem_floats() {
  return BQ * HD + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int KP = HD + 1;
  constexpr int PP = BK + 1;
  float* Qs = smem;                  // [BQ][HD]
  float* Ks = Qs + BQ * HD;          // [BK][KP]
  float* Vs = Ks + BK * KP;          // [BK][HD]
  float* Ps = Vs + BK * HD;          // [BQ][PP]  scores, then probabilities
  float* row_m = Ps + BQ * PP;       // [BQ]
  float* row_l = row_m + BQ;         // [BQ]
  float* row_alpha = row_l + BQ;     // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.h;
  const int head = blockIdx.y % p.h;
  const int kvh = head / p.g;
  const int rows = min(BQ, p.sq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + head * p.o_sh;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[i] = r < rows ? load_f32(q + (q0 + r) * p.q_ss + d) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    row_m[r] = NEG;
    row_l[r] = 0.f;
  }

  // the tiles this q tile can reach (attention.py:164-172)
  const int nk = (p.sk + BK - 1) / BK;
  const int qpos_lo = p.q_offset + q0;
  int hi = nk;
  if (p.causal) hi = min(nk, (qpos_lo + rows + BK - 1) / BK);
  int lo = 0;
  if (p.window > 0) {
    const int first = qpos_lo - p.window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  // scores: thread (sy, sx) owns rows sy*4 + i and keys sx + 16*j
  const int sy = tid / 16, sx = tid % 16;
  // P.V: thread (py, px) owns rows py*RPT + i and columns px + TX*j
  constexpr int TX = HD < 16 ? HD : 16;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BQ / TY;
  constexpr int CPT = HD / TX;
  const int py = tid / TX, px = tid % TX;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const bool in = k0 + c < p.sk;
      Ks[c * KP + d] = in ? load_f32(k + (k0 + c) * p.k_ss + d) : 0.f;
      Vs[c * HD + d] = in ? load_f32(v + (k0 + c) * p.v_ss + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(sy * 4 + i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(sx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j;
        Ps[r * PP + c] =
            attends(p, qpos_lo + r, k0 + c) ? s[i][j] * p.scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      const int qpos = qpos_lo + r;
      float* prow = Ps + r * PP + part * 16;
      const float m_prev = row_m[r];
      const float l_prev = row_l[r];
      float mx = NEG;
#pragma unroll
      for (int t = 0; t < 16; ++t) mx = fmaxf(mx, prow[t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int kpos = k0 + part * 16 + t;
        const float pv = expf(prow[t] - m_new) *
                         (attends(p, qpos, kpos) ? 1.f : 0.f);
        prow[t] = pv;
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane has read row_m / row_l
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_alpha[r] = alpha;
        row_l[r] = l_prev * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = row_alpha[py * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(py * RPT + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[c * HD + px + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // row_l is final

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = py * RPT + i;
    if (r < rows) {
      const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        store_f32(o + (q0 + r) * p.o_ss + px + TX * j, acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, batch_heads);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, int batch_heads,
                     cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(p, batch_heads, stream);
    case 16: return launch<T, 16>(p, batch_heads, stream);
    case 32: return launch<T, 32>(p, batch_heads, stream);
    case 64: return launch<T, 64>(p, batch_heads, stream);
    case 128: return launch<T, 128>(p, batch_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, s, h) of q, k, v, o in that order.
// dtype: 0 float32, 1 bfloat16.  Returns the CUDA status of the launch.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               const long long* strides, int batch, int sq, int sk, int h,
               int hkv, int hd, int causal, int window, int q_offset,
               float scale, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.g = h / hkv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, hd, batch * h, s)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, hd, batch * h, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
