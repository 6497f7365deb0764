// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// the gradient of the forward kernels of flash_attention.cu, on two routes
// (float32 FMAs: three kernels, `fa_backward`; tensor cores: four,
// `fa_backward_tc`, or at (24, 16) for heads of at most 256 queries and
// keys one, `fa_backward_narrow`; up to hd 128 with H == Hkv, on the
// caller's word, two, the dK / dV and dQ CTAs in one grid), templates over
// the forward's (hd, hdv) pairs.  Its own
// source so that nvcc builds it beside the forward, in parallel.

#include <cooperative_groups.h>

#include "flash_attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------- backward
// The gradient of both forward kernels, for the model's training step
// (kernels/flash_attention.py `FlashAttentionFn`).  The JAX package has no
// kernel here: it differentiates its jnp chunked attention
// (src/repro/models/attention.py:92) by XLA autodiff, and its Pallas
// kernel is forward only.  Given dO, q, k, v, the forward's o and its
// per-row lse = m + log(l) (natural units, float32), with
// P = exp(scale q.k - lse) on the attended pairs and 0 elsewhere:
//
//   D  = rowsum(dO o)                      fa_bwd_preprocess_kernel
//   dP = dO v^T,  dS = P (dP - D)
//   dV = P^T dO,  dK = scale dS^T q        fa_bwd_dkdv_kernel
//   dQ = scale dS k                        fa_bwd_dq_kernel
//
// Every kernel is a template over <HD, HDV> as the forward is: q, k, dq
// and dk are HD wide, v, o, dO and dv HDV wide (DeepSeek-V2's MLA: (192,
// 128), (24, 16) in its smoke config; RecurrentGemma: (256, 256)).  D sums
// over HDV, S = q.k^T over HD, dP = dO.v^T over HDV.
//
// Deterministic by construction: every output element is written by one
// CTA, which sums in a fixed order; no float atomics.  So two backward
// runs give the same bits, and a resumed training run the same state.
//
// fa_bwd_dkdv_kernel: one CTA of 256 threads per (b, query head, 64-key
// tile).  It loops over the query tiles the causal / window mask lets
// reach its keys (skipping a fully masked tile is exact), recomputing S
// and P from q, k and lse; dK and dV stay in registers for the whole loop.
// With g = H / Hkv > 1 it writes float32 partials of its query head and
// fa_bwd_gqa_reduce_kernel sums the g partials of each kv head in head
// order (the tensor-core route's reduction).  A CTA looping over the g
// heads instead summed 16 x 2,048 products into one float32 register at
// RecurrentGemma's (1, 3072, 16, 1) with window 2,048, and its dK and dV
// fell outside the float32 tolerance of the plain version (rtol 1e-4,
// atol 1e-5); per head the sums are 2,048 long, and the grid is 16 times
// wider (48 CTAs there otherwise).
// fa_bwd_dq_kernel: one CTA per (b, head, 64-row query tile), looping over
// the key tiles of the forward's reach; dQ stays in registers.  Tiles are
// staged in shared memory as float32 (rows padded to width + 1 against
// bank conflicts); the products are float32 FMAs, as in the forward's FMA
// kernel, for both dtypes.  Query tiles (dK / dV) and key tiles (dQ) are
// 64 rows up to hd 128; past it 32 (`fma_rows`), since four 64-row
// float32 tiles 257 wide (263 KB at (256, 256)) pass the 227 KiB an SM
// gives a CTA: with 32 the dK / dV kernel takes 214,272 bytes and the dQ
// kernel 206,336 there.  At (192, 128) 64-row tiles fit (198,656 bytes).
//
// What bounds it.  The backward's five products are 2 (3 hd + 2 hdv) FLOP
// per live (q, k) pair and head; at the training shape (4, 1024, 1024,
// 12, 2, 128) that is ~26 GFLOP per layer against ~31 MB of operands: far
// above the card's ~295 bf16 FLOP per byte, so the tensor cores bound it.
// This route does seven products (S and dP twice) on the 67 TFLOP/s CUDA
// cores, with one CTA per SM (~160-214 KiB of shared memory each), and
// the causal dK/dV CTAs are unbalanced (the first key tile sees every
// query tile).  These kernels are the FMA route (`fa_backward`: float32,
// and bfloat16 with hd 8); bfloat16 with hd >= 16 takes the tensor-core
// route below (`fa_backward_tc`, namespace bwd_tc).

namespace bwd {

constexpr int BQ = 64;        // query rows of a dQ CTA
constexpr int BK = 64;        // keys of a dK / dV CTA
constexpr int THREADS = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  float* delta;        // (B, H, Sq): rowsum(dO o)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;     // element strides over (b, s, h)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int sq, sk, h, g, causal, window;
  float scale;
};

__device__ __forceinline__ bool attends(const Params& p, int qpos, int kpos) {
  bool valid = kpos < p.sk;
  if (p.causal) valid = valid && qpos >= kpos;
  if (p.window > 0) valid = valid && (qpos - kpos < p.window);
  return valid;
}

// rows of the streamed tile of both kernels (query tiles of dK / dV, key
// tiles of dQ): 64, or 32 past hd 128 so that the tiles fit shared memory
template <int HD>
__host__ __device__ constexpr int fma_rows() {
  return HD > 128 ? 32 : 64;
}

// neighbouring lanes that split an accumulator's W columns: 16, W itself
// below 16, or 8 where 16 does not divide W (hd 24)
template <int W>
__host__ __device__ constexpr int lanes_x() {
  return W < 16 ? W : (W % 16 == 0 ? 16 : 8);
}

// D = rowsum(dO o) over o's hdv columns: one warp per row, 8 rows per CTA
// pass
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_preprocess_kernel(const Params p, int hdv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / p.h, head = bh % p.h;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + head * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + head * p.do_sh;
  const int r_end = min(p.sq, (blockIdx.x + 1) * BQ);
  for (int r = blockIdx.x * BQ + warp; r < r_end; r += THREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < hdv; d += 32)
      s = fmaf(load_f32(o + r * p.o_ss + d), load_f32(dout + r * p.do_ss + d),
               s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) p.delta[static_cast<long long>(bh) * p.sq + r] = s;
  }
}

// Stage rows [0, n) of a tile of R rows (row stride ss elements) into
// shared memory as float32 with row pitch W + 1; rows past n are zeros.
template <typename T, int W, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int n, int tid) {
  for (int i = tid; i < R * W; i += THREADS) {
    const int r = i / W, d = i % W;
    dst[r * (W + 1) + d] = r < n ? load_f32(src + r * ss + d) : 0.f;
  }
}

// S = A.B^T over HD and dP = C.E^T over HDV for one (16 RI x 16 CJ) tile
// pair: thread (sy, sx) owns rows sy*RI + i and columns sx + 16 j, as the
// forward's score loop does.  A and B rows have pitch HD + 1, C and E
// rows HDV + 1; the shared columns run in one loop, the wider operand's
// rest after it.
template <int HD, int HDV, int RI, int CJ>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             float (&s)[RI][CJ],
                                             float (&dp)[RI][CJ], int sy,
                                             int sx) {
  constexpr int HP = HD + 1, VP = HDV + 1;
  constexpr int LO = HD < HDV ? HD : HDV;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < LO; ++d) {
    float a[RI], bb[CJ], c[RI], e[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = A[(sy * RI + i) * HP + d];
      c[i] = C[(sy * RI + i) * VP + d];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      bb[j] = B[(sx + 16 * j) * HP + d];
      e[j] = E[(sx + 16 * j) * VP + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
#pragma unroll 4
  for (int d = LO; d < HD; ++d) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        s[i][j] = fmaf(A[(sy * RI + i) * HP + d], B[(sx + 16 * j) * HP + d],
                       s[i][j]);
  }
#pragma unroll 4
  for (int d = LO; d < HDV; ++d) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dp[i][j] = fmaf(C[(sy * RI + i) * VP + d], E[(sx + 16 * j) * VP + d],
                        dp[i][j]);
  }
}

template <int HD, int HDV>
constexpr int dkdv_smem_floats() {
  constexpr int QT = fma_rows<HD>();
  return (BK + QT) * (HD + 1) + (BK + QT) * (HDV + 1) + 2 * QT * (BK + 1) +
         2 * QT;
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const Params p, float* dk_part, float* dv_part) {
  extern __shared__ float smem[];
  constexpr int HP = HD + 1, VP = HDV + 1;
  constexpr int QT = fma_rows<HD>();  // query rows a tile
  constexpr int RI = QT / 16;         // score rows a thread
  constexpr int PP = BK + 1;          // padded row of a P / dS tile
  float* Ks = smem;                 // [BK][HP]
  float* Vs = Ks + BK * HP;         // [BK][VP]
  float* Qs = Vs + BK * VP;         // [QT][HP]
  float* dOs = Qs + QT * HP;        // [QT][VP]
  float* Ps = dOs + QT * VP;        // [QT][PP]
  float* dSs = Ps + QT * PP;        // [QT][PP]
  float* lse_s = dSs + QT * PP;     // [QT]
  float* D_s = lse_s + QT;          // [QT]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / p.h, head = blockIdx.y % p.h;
  const int kvh = head / p.g;
  const int keys = min(BK, p.sk - k0);

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + head * p.do_sh;
  stage<T, HD, BK>(Ks, k + k0 * p.k_ss, p.k_ss, keys, tid);
  stage<T, HDV, BK>(Vs, v + k0 * p.v_ss, p.v_ss, keys, tid);

  // the query tiles whose mask reaches keys [k0, k0 + keys)
  const int nq = (p.sq + QT - 1) / QT;
  const int qt_lo = p.causal ? min(nq, k0 / QT) : 0;
  int qt_hi = nq;
  if (p.window > 0) qt_hi = min(nq, (k0 + keys - 1 + p.window - 1) / QT + 1);

  const int sy = tid / 16, sx = tid % 16;
  // dK: thread (ky, kx) owns key rows ky*KR + i, columns kx + KX*j; dV
  // the same over HDV with (vy, vx)
  constexpr int KX = lanes_x<HD>(), KR = BK / (THREADS / KX), KC = HD / KX;
  constexpr int VX = lanes_x<HDV>(), VR = BK / (THREADS / VX), VC = HDV / VX;
  static_assert(HD % KX == 0 && HDV % VX == 0 && KR >= 1 && VR >= 1,
                "dK / dV thread layout");
  const int ky = tid / KX, kx = tid % KX, vy = tid / VX, vx = tid % VX;
  float dk[KR][KC], dv[VR][VC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < KC; ++j) dk[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < VR; ++i)
#pragma unroll
    for (int j = 0; j < VC; ++j) dv[i][j] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * QT;
    const int rows = min(QT, p.sq - q0);
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    stage<T, HD, QT>(Qs, q + q0 * p.q_ss, p.q_ss, rows, tid);
    stage<T, HDV, QT>(dOs, dout + q0 * p.do_ss, p.do_ss, rows, tid);
    for (int r = tid; r < QT; r += THREADS) {
      lse_s[r] = r < rows ? p.lse[bh * p.sq + q0 + r] : 0.f;
      D_s[r] = r < rows ? p.delta[bh * p.sq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[RI][4], dp[RI][4];
    two_products<HD, HDV, RI, 4>(Qs, Ks, dOs, Vs, s, dp, sy, sx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = sy * RI + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j;
        // a select, not a product: lse of a masked row may be -1e30
        const float pe = r < rows && attends(p, q0 + r, k0 + c)
                             ? expf(s[i][j] * p.scale - lse_s[r])
                             : 0.f;
        Ps[r * PP + c] = pe;
        dSs[r * PP + c] = pe * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 4
    for (int r = 0; r < QT; ++r) {
      float pv[VR], ds[KR];
#pragma unroll
      for (int i = 0; i < VR; ++i) pv[i] = Ps[r * PP + vy * VR + i];
#pragma unroll
      for (int i = 0; i < KR; ++i) ds[i] = dSs[r * PP + ky * KR + i];
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        const float dov = dOs[r * VP + vx + VX * j];
#pragma unroll
        for (int i = 0; i < VR; ++i) dv[i][j] = fmaf(pv[i], dov, dv[i][j]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float qv = Qs[r * HP + kx + KX * j];
#pragma unroll
        for (int i = 0; i < KR; ++i) dk[i][j] = fmaf(ds[i], qv, dk[i][j]);
      }
    }
  }

  // g = 1: this CTA owns the rows (the operands' dtype); else float32
  // partials of this query head, (B, Sk, H, hd) and (B, Sk, H, hdv)
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
  const long long prow = (static_cast<long long>(b) * p.sk + k0) * p.h + head;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int c = ky * KR + i;
    if (c < keys) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float x = dk[i][j] * p.scale;
        if (dk_part != nullptr)
          dk_part[(prow + static_cast<long long>(c) * p.h) * HD + kx +
                  KX * j] = x;
        else
          store_f32(dkp + (k0 + c) * p.dk_ss + kx + KX * j, x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VR; ++i) {
    const int c = vy * VR + i;
    if (c < keys) {
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        if (dv_part != nullptr)
          dv_part[(prow + static_cast<long long>(c) * p.h) * HDV + vx +
                  VX * j] = dv[i][j];
        else
          store_f32(dvp + (k0 + c) * p.dv_ss + vx + VX * j, dv[i][j]);
      }
    }
  }
}

// four float32 sums as four elements of T (16-byte or 8-byte stores)
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(tc::pack_bf16(x.x, x.y), tc::pack_bf16(x.z, x.w));
}

// dK, dV (in T) = the sums of the g query heads' float32 partials of each
// kv head, in head order: four columns of dK (those below hd) and four of
// dV (those below hdv) a thread.  Both routes' last step where H > Hkv;
// dk and dv are contiguous outputs of the wrapper (aligned vector stores)
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_gqa_reduce_kernel(const Params p, const float* dk_part,
                         const float* dv_part, int batch, int hd, int hdv) {
  const int hkv = p.h / p.g, d4n = (hd > hdv ? hd : hdv) / 4;
  const long long n4 = static_cast<long long>(batch) * p.sk * hkv * d4n;
  const long long i =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n4) return;
  const int d = static_cast<int>(i % d4n) * 4;
  long long rest = i / d4n;
  const int kvh = static_cast<int>(rest % hkv);
  rest /= hkv;
  const int s = static_cast<int>(rest % p.sk);
  const int b = static_cast<int>(rest / p.sk);
  // the partials' row of the kv head's first query head
  const long long row = (static_cast<long long>(b) * p.sk + s) * p.h +
                        static_cast<long long>(kvh) * p.g;
  if (d < hd) {
    float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int hq = 0; hq < p.g; ++hq) {
      const float4 a =
          *reinterpret_cast<const float4*>(dk_part + (row + hq) * hd + d);
      sk4.x += a.x; sk4.y += a.y; sk4.z += a.z; sk4.w += a.w;
    }
    store4(static_cast<T*>(p.dk) + b * p.dk_sb + s * p.dk_ss +
               kvh * p.dk_sh + d, sk4);
  }
  if (d < hdv) {
    float4 sv4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int hq = 0; hq < p.g; ++hq) {
      const float4 c =
          *reinterpret_cast<const float4*>(dv_part + (row + hq) * hdv + d);
      sv4.x += c.x; sv4.y += c.y; sv4.z += c.z; sv4.w += c.w;
    }
    store4(static_cast<T*>(p.dv) + b * p.dv_sb + s * p.dv_ss +
               kvh * p.dv_sh + d, sv4);
  }
}

// the reduction's launch: one thread a column quad of a key's kv head
template <typename T>
cudaError_t launch_reduce(const Params& p, int batch, int hd, int hdv,
                          const float* dk_part, const float* dv_part,
                          cudaStream_t stream) {
  const long long n4 = static_cast<long long>(batch) * p.sk * (p.h / p.g) *
                       ((hd > hdv ? hd : hdv) / 4);
  fa_bwd_gqa_reduce_kernel<T>
      <<<static_cast<unsigned>((n4 + THREADS - 1) / THREADS), THREADS, 0,
         stream>>>(p, dk_part, dv_part, batch, hd, hdv);
  return cudaGetLastError();
}

template <int HD, int HDV>
constexpr int dq_smem_floats() {
  constexpr int KT = fma_rows<HD>();
  return (BQ + KT) * (HD + 1) + (BQ + KT) * (HDV + 1) + BQ * (KT + 1) +
         2 * BQ;
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int HP = HD + 1, VP = HDV + 1;
  constexpr int KT = fma_rows<HD>();  // keys a tile
  constexpr int CJ = KT / 16;         // score columns a thread
  constexpr int PP = KT + 1;          // padded row of a dS tile
  float* Qs = smem;                 // [BQ][HP]
  float* dOs = Qs + BQ * HP;        // [BQ][VP]
  float* Ks = dOs + BQ * VP;        // [KT][HP]
  float* Vs = Ks + KT * HP;         // [KT][VP]
  float* dSs = Vs + KT * VP;        // [BQ][PP]
  float* lse_s = dSs + BQ * PP;     // [BQ]
  float* D_s = lse_s + BQ;          // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / p.h, head = blockIdx.y % p.h;
  const int kvh = head / p.g;
  const int rows = min(BQ, p.sq - q0);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + head * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage<T, HD, BQ>(Qs, q + q0 * p.q_ss, p.q_ss, rows, tid);
  stage<T, HDV, BQ>(dOs, dout + q0 * p.do_ss, p.do_ss, rows, tid);
  for (int r = tid; r < BQ; r += THREADS) {
    lse_s[r] = r < rows ? p.lse[bh * p.sq + q0 + r] : 0.f;
    D_s[r] = r < rows ? p.delta[bh * p.sq + q0 + r] : 0.f;
  }

  // the key tiles this query tile reaches (the forward's loop bounds)
  const int nk = (p.sk + KT - 1) / KT;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + rows + KT - 1) / KT);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    lo = first > 0 ? first / KT : 0;
  }

  const int sy = tid / 16, sx = tid % 16;
  // dQ: thread (qy, qx) owns rows qy*QR + i, columns qx + QX*j
  constexpr int QX = lanes_x<HD>(), QR = BQ / (THREADS / QX), QC = HD / QX;
  static_assert(HD % QX == 0 && QR >= 1, "dQ thread layout");
  const int qy = tid / QX, qx = tid % QX;
  float dq[QR][QC];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int j = 0; j < QC; ++j) dq[i][j] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    stage<T, HD, KT>(Ks, k + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
    stage<T, HDV, KT>(Vs, v + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
    __syncthreads();

    float s[4][CJ], dp[4][CJ];
    two_products<HD, HDV, 4, CJ>(Qs, Ks, dOs, Vs, s, dp, sy, sx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = sx + 16 * j;
        const float pe = r < rows && attends(p, q0 + r, k0 + c)
                             ? expf(s[i][j] * p.scale - lse_s[r])
                             : 0.f;
        dSs[r * PP + c] = pe * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int c = 0; c < KT; ++c) {
      float ds[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i) ds[i] = dSs[(qy * QR + i) * PP + c];
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const float kv = Ks[c * HP + qx + QX * j];
#pragma unroll
        for (int i = 0; i < QR; ++i) dq[i][j] = fmaf(ds[i], kv, dq[i][j]);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + head * p.dq_sh;
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int r = qy * QR + i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < QC; ++j)
        store_f32(dqp + (q0 + r) * p.dq_ss + qx + QX * j, dq[i][j] * p.scale);
    }
  }
}

template <typename T, int HD, int HDV>
cudaError_t launch(const Params& p, int batch, float* dk_part,
                   float* dv_part, cudaStream_t stream) {
  fa_bwd_preprocess_kernel<T><<<dim3((p.sq + BQ - 1) / BQ, batch * p.h),
                                THREADS, 0, stream>>>(p, HDV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_floats<HD, HDV>() * sizeof(float);
  auto dkdv = fa_bwd_dkdv_kernel<T, HD, HDV>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.sk + BK - 1) / BK, batch * p.h), THREADS, dkdv_bytes,
         stream>>>(p, p.g > 1 ? dk_part : nullptr,
                   p.g > 1 ? dv_part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.g > 1) {
    err = launch_reduce<T>(p, batch, HD, HDV, dk_part, dv_part, stream);
    if (err != cudaSuccess) return err;
  }

  constexpr int dq_bytes = dq_smem_floats<HD, HDV>() * sizeof(float);
  auto dqk = fa_bwd_dq_kernel<T, HD, HDV>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((p.sq + BQ - 1) / BQ, batch * p.h), THREADS, dq_bytes,
        stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, int hdv, int batch,
                     float* dk_part, float* dv_part, cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(8, 8):
      return launch<T, 8, 8>(p, batch, dk_part, dv_part, stream);
    case pair(16, 16):
      return launch<T, 16, 16>(p, batch, dk_part, dv_part, stream);
    case pair(24, 16):
      return launch<T, 24, 16>(p, batch, dk_part, dv_part, stream);
    case pair(32, 32):
      return launch<T, 32, 32>(p, batch, dk_part, dv_part, stream);
    case pair(64, 64):
      return launch<T, 64, 64>(p, batch, dk_part, dv_part, stream);
    case pair(128, 128):
      return launch<T, 128, 128>(p, batch, dk_part, dv_part, stream);
    case pair(192, 128):
      return launch<T, 192, 128>(p, batch, dk_part, dv_part, stream);
    case pair(256, 256):
      return launch<T, 256, 256>(p, batch, dk_part, dv_part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// ------------------------------------------- backward, tensor cores (bf16)
// The same gradient for bfloat16 operands at the tensor-core forward's
// (hd, hdv) pairs, (16, 16), (24, 16), (32, 32), (64, 64), (128, 128),
// (192, 128) and (256, 256) (`fa_backward_tc`), its products on the tensor
// cores.  It replaces what the JAX package leaves to XLA autodiff of its
// jnp chunked attention (src/repro/models/attention.py:92); there is no
// Pallas backward.
//
// What bounds it.  The five products are 2 (3 hd + 2 hdv) FLOP per live
// (q, k) pair and head (S and dK, dQ over hd; dP and dV over hdv): at the
// training shapes, (2 or 4, 1024, 1024, 12, 2, 128) causal, 13 or 26
// GFLOP against 16 or 31 MB of operands (~800 FLOP per byte), so the bf16
// tensor cores bound it (0.0163 ms at B = 2, 989 TFLOP/s); DeepSeek-V2-
// Lite's (2, 2048, 16, 16) at (192, 128) is 111.7 GFLOP (0.1130 ms) and
// RecurrentGemma-9B's (1, 3072, 16, 1) at (256, 256) with window 2,048
// 171.8 GFLOP (0.1738 ms).
//
// What the design does about that.  Every product is a warpgroup MMA
// (`wgmma.mma_async`, bf16 inputs, float32 accumulators) on the forward's
// 128-byte-swizzled shared tiles (`tc::load_tile`, `tc::desc`); Q, K and
// their gradients' tiles are hd wide, V and dO tiles hdv wide (a width
// below 64 is padded with zero columns, which leave every product
// unchanged):
//
//   fa_bwd_preprocess_tc_kernel  D = rowsum(dO o) over hdv, bytes-bound:
//       16-byte loads, hdv / 8 lanes a row reduced by shuffles
//   fa_bwd_dkdv_tc_kernel  one CTA per (b, query head, 64-key tile).  K
//       and V are loaded once; Q, dO and the tile's lse and D stream in
//       double-buffered (cp.async) over the query tiles of the causal /
//       window reach.  Per query tile:
//         S^T = K.Q^T, dP^T = V.dO^T     m64n64k16, both operands K-major
//         P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - D)   in registers
//         dV += P^T.dO, dK += dS^T.Q     m64nNk16, A = the accumulator
//             fragments in bf16 (as the forward's P.V), B = dO / Q read
//             MN-major (the forward's V descriptor), N = hdv or hd
//       dK and dV stay in float32 registers for the whole loop.  Up to hd
//       128 one warpgroup does every product and holds both (dK's and
//       dV's 64 floats a thread at hd 128 beside S's and dP's 32: 255
//       registers).  With g = H / Hkv > 1 each CTA writes float32
//       partials of its query head into (B, Sk, H, hd) and (B, Sk, H, hdv)
//       scratches and fa_bwd_gqa_reduce_kernel sums the g partials of each
//       kv head in head order into bf16 (RecurrentGemma: g = 16); with g
//       = 1 the CTA writes bf16 itself.  A CTA per query head (not per kv
//       head looping over its g heads) gives B H Sk / 64 CTAs: 768 at the
//       4 x 1024 training step against 128, and the key tiles launch
//       longest causal reach first (tile 0 sees every query tile).
//   fa_bwd_dq_tc_kernel  one CTA per (b, head, 64-row query tile), in
//       reverse q-tile order as the forward: Q, dO, lse, D loaded once, K
//       and V double-buffered over the forward's reach; S = Q.K^T, dP =
//       dO.V^T, dS in registers, dQ += dS.K (K read MN-major).  Up to hd
//       128 one warpgroup.
//
//   Past hd 128 (MLA's (192, 128), RecurrentGemma's (256, 256)) one
//   warpgroup cannot hold the gradients beside S and dP (224 and 320
//   accumulator floats), so each CTA is two warpgroups, and they split
//   every tile so that S and dP are computed once across the CTA and
//   their tensor work is equal.  Counted in hd-units (a 64 x N product
//   over the tile's 64 rows counts N; dK and dQ twice, hi + lo), a tile
//   costs each warpgroup 416 (dK / dV) and 352 (dQ) at (192, 128), 640
//   and 512 at (256, 256) (`backward_tile_work` in
//   kernels/flash_attention.py; 1,536 and 2,304 for both CTAs, where a
//   split by role, one warpgroup keeping dV and the other dK, each
//   computing S^T, costs 2,048 and 3,072, its longer warpgroup 704 and
//   1,024).  Both warpgroups run one instruction stream: only addresses
//   depend on the warpgroup, and no wgmma sits under a branch on it, so
//   ptxas serialises none (roles that branch on the warpgroup draw its
//   C7520 note: "program dependence on compiler-inserted WG.AR in
//   divergent path").
//     dK / dV: each warpgroup computes S^T and dP^T over its 32 of the
//       query tile's 64 queries (m64n32k16, K and V shared).  At (192,
//       128) it accumulates dV and dK over its queries (register-A
//       products, K = 32: m64n128k16, m64n192k16), P^T's and dS^T's
//       fragments in bf16 as above, dV's product running while dS^T is
//       formed; the two partials (96 + 64 floats a thread) are summed
//       once after the loop through the freed stages (warpgroup 1 hands
//       over its dK, warpgroup 0 its dV; a + b, so the order is fixed).
//       At (256, 256) those partials (256 floats) would not fit, so P^T
//       and dS^T (hi, lo) go to shared memory as bf16 (three 8 KiB
//       tiles), and each warpgroup accumulates its half of dK's and of
//       dV's columns over all 64 queries (shared-memory products,
//       m64n128k16, B read MN-major); dV's product is issued before dS^T
//       is formed.  ptxas: 255 registers at (192, 128), 233 at (256, 256),
//       no spill.  Shared memory: K, V, two Q and two dO stages, 122 KiB
//       at (192, 128); with the P^T and dS^T tiles 218 KiB at (256, 256)
//       (one CTA an SM either way).
//     dQ: each warpgroup computes S and dP over its 32 of the key tile's
//       64 keys and a dQ partial over them (register-A, K = 32:
//       m64n192k16 or m64n256k16); the partials are summed once after the
//       loop, each warpgroup writing half of dQ's columns.  Q, dO, lse and
//       D are shared; each warpgroup streams only its own 32 rows of K and
//       V (two stages) behind a barrier of its own (bar.sync 1 / 2, 128
//       threads), so the warpgroups need not meet inside the loop.
//       ptxas: 234 registers at (192, 128), 255 at (256, 256), no spill;
//       122 KiB and 194 KiB of shared memory.
//   What still holds these CTAs back (tools/ablate_flash_backward.py):
//   within a tile the S / dP products, the softmax math and the dK / dV
//   (dQ) products run one after the other, and leaving out any one of
//   them shortens the kernel by about its own share.  Neither turn-taking
//   between the warpgroups (two named barriers) nor interleaving S's and
//   dP's k-steps moved them; a software-pipelined dQ (the next tile's S
//   and dP issued before this tile's dQ, three stages) drew ptxas's C7515
//   note (non-wgmma instructions defining accumulators inside a pipeline
//   stage) and ran slower.  The m64n32k16 products read their A tile
//   from shared memory in both warpgroups, and at (256, 256) every dK /
//   dV CTA streams 64 KiB of Q and dO a tile.
//
// Numerics.  P is rounded to bf16 before P^T.dO, as the forward's P.V and
// SDPA's backward do; dS is formed from the float P.  dS enters dK and dQ
// as two bf16 terms, hi = bf16(dS) and lo = bf16(dS - hi), so one more
// product each: with dS as one bf16 term (SDPA's way) a random draw at the
// model's heads missed the card tests' tolerance (rtol = atol = 2e-2
// against float32 autograd), and SDPA's own backward misses it too; the
// split keeps dK and dQ at the FMA route's error.  Masks are built,
// branch-free, only on tiles that hold a masked pair (the diagonal, the
// window's edge, a ragged tile); P is a select on the mask (a row that
// attends nothing has lse ~ -1e30).  Deterministic: every output element
// is written by one CTA or summed in a fixed order; no float atomics.
// What it gives up: the products, the exponentials and the
// copies of one CTA run one after the other (no producer warp, no TMA),
// S and dP are computed twice, once in each of the two CTAs (nine
// products in all with the split dS, against the five the bound counts),
// and every query head re-reads its kv head's tiles.
//
// Alignment: as the forward, every operand starts on a 16-byte boundary and
// its b, s and h strides are multiples of 8 elements; `fa_backward_tc`
// refuses otherwise.

namespace tc {

// d (64 x 192 f32) += A (64 x 16 bf16, registers) . B (16 x 192, MN-major
// in shared memory, descriptor)
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16 bf16, registers) . B (16 x 256, MN-major
// in shared memory, descriptor)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 f32) = A (64 x 16) . B^T (B 32 x 16), both K-major in shared
// memory (descriptors); scale_d = 0 overwrites d, 1 accumulates
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) += A (64 x 16, K-major) . B (16 x 128, MN-major), both
// in shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16 f32) (+)= A (64 x 16) . B (16 x 16), both in shared memory
// (descriptors): A K-major (TA 0) or MN-major (TA 1), B MN-major; scale_d
// = 0 overwrites d, 1 accumulates
template <int TA>
__device__ __forceinline__ void wgmma_ss_n16_bmn(float (&d)[8], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d (64 x 32 f32) (+)= A (64 x 16) . B (16 x 32), as wgmma_ss_n16_bmn
template <int TA>
__device__ __forceinline__ void wgmma_ss_n32_bmn(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

}  // namespace tc

namespace bwd_tc {

constexpr int B64 = 64;          // query rows and keys per tile
constexpr int THREADS = 128;     // one warpgroup
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

using tc::smem_u32;

// warpgroups of a dK / dV or a dQ CTA: one up to hd 128; two past it,
// each computing S and dP over its 32 of the tile's 64 queries (dK / dV)
// or keys (dQ)
template <int HD>
__host__ __device__ constexpr int warpgroups() {
  return HD > 128 ? 2 : 1;
}

// Past hd 128, whether a dK / dV CTA splits dK's and dV's columns between
// its warpgroups (P^T and dS^T through shared memory) rather than the
// tile's queries (each warpgroup's partial dK and dV over its queries in
// registers, summed after the loop): where the partials, (HD + HDV) / 2
// floats a thread, would not fit beside S^T's and dP^T's 32.  (256, 256)
// splits columns, (192, 128) queries.
template <int HD, int HDV>
__host__ __device__ constexpr bool dkdv_split_cols() {
  return HD + HDV > 320;
}

// Two bf16 packed in a 32-bit word, as floats (.x the low half)
__device__ __forceinline__ float2 bf16x2(uint32_t w) {
  __nv_bfloat162 h;
  memcpy(&h, &w, sizeof(h));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;  // 0: fill the 4 bytes with zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

template <int HD, int HDV>
constexpr int smem_bytes(int row_stages) {
  // three hd-wide and three hdv-wide 64-row tiles (one of each loaded
  // once, two stages of each streamed), lse and D rows, slack to align to
  // 1,024 bytes
  return 3 * 64 * (tc::hd_padded<HD>() + tc::hd_padded<HDV>()) * 2 +
         row_stages * 2 * 64 * 4 + 1024;
}

// bytes of a 64 x 64 bf16 tile of P^T or dS^T (one swizzle atom wide)
constexpr int PTILE = 64 * 64 * 2;

// a dK / dV CTA's: smem_bytes, and where it splits columns, the P^T, dS^T
// hi and dS^T lo tiles
template <int HD, int HDV>
constexpr int dkdv_smem_bytes() {
  return smem_bytes<HD, HDV>(2) +
         (warpgroups<HD>() == 2 && dkdv_split_cols<HD, HDV>() ? 3 * PTILE
                                                              : 0);
}

// A tile holds a masked pair: a ragged edge, the causal diagonal, or the
// window's edge (q_offset is 0 in the backward)
__device__ __forceinline__ bool edge_tile(const bwd::Params& p, int q0,
                                          int k0) {
  return (q0 + B64 > p.sq) | (k0 + B64 > p.sk) |
         (p.causal & (k0 + B64 - 1 > q0)) |
         ((p.window > 0) & (q0 + B64 - 1 - k0 >= p.window));
}

// Bit i: is element i of this thread's 64 x (F / 2 * 4) accumulator
// fragment (64 x 64 at F = 32, 64 x 32 at 16) an attended pair?  Element
// i sits at row r0 + 8 ((i % 4) / 2) and column c0 + 8 (i / 4) + (i & 1);
// KEY_ROWS: rows are keys and columns queries (S^T), else rows are queries
// (S).
template <bool KEY_ROWS, int F = 32>
__device__ __forceinline__ uint32_t valid_bits(const bwd::Params& p, int r0,
                                               int c0) {
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int r = r0 + 8 * ((i % 4) / 2), c = c0 + 8 * (i / 4) + (i & 1);
    const int qp = KEY_ROWS ? c : r, kp = KEY_ROWS ? r : c;
    const bool ok = (qp < p.sq) & (kp < p.sk) & (!p.causal | (qp >= kp)) &
                    ((p.window <= 0) | (qp - kp < p.window));
    valid |= static_cast<uint32_t>(ok) << i;
  }
  return valid;
}

// d (64 x 64) = A (64 x W) . B^T (64 x W), both K-major swizzled tiles
// (W = hd or hdv, padded)
template <int W>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    tc::wgmma_ss_n64(d, tc::desc(a + off, 16, 1024),
                     tc::desc(b + off, 16, 1024), kk > 0);
  }
}

// acc[0, N / 2) (64 x N) += A (64 x 16 KS, bf16 fragments) . B (16 KS rows
// x N columns of a tile from `b`, read MN-major: 16 rows per step are two
// 1,024-byte atoms, 64-column atoms 8 KiB apart)
template <int N, int KS>
__device__ __forceinline__ void mma_rs(float* acc, const uint32_t (&a)[KS][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = tc::desc(b + kk * 2048, 8192, 1024);
    if constexpr (N == 256)
      tc::wgmma_rs_n256(acc, a[kk], db);
    else if constexpr (N == 192)
      tc::wgmma_rs_n192(acc, a[kk], db);
    else if constexpr (N == 128)
      tc::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc), a[kk], db);
    else
      tc::wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc), a[kk], db);
  }
}

// The accumulator fragment of a 64 x (F / 2 * 4) product as the A
// fragments of a 64 x (F / 2 * 4) (K = 64 at F = 32, 32 at 16) bf16
// operand
template <int F>
__device__ __forceinline__ void pack_a(const float (&s)[F],
                                       uint32_t (&a)[F / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = tc::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// The same as two bf16 fragments, hi = bf16(s) and lo = bf16(s - hi): a
// product with both keeps s to about 16 significant bits
template <int F>
__device__ __forceinline__ void pack_split(const float (&s)[F],
                                           uint32_t (&hi)[F / 8][4],
                                           uint32_t (&lo)[F / 8][4]) {
  pack_a(s, hi);
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 h = bf16x2(hi[kk][j]);
      lo[kk][j] = tc::pack_bf16(s[8 * kk + 2 * j] - h.x,
                                s[8 * kk + 2 * j + 1] - h.y);
    }
}

// S -> P = exp(scale S - lse) in place, a select on the pairs `valid`
// leaves out (a row that attends nothing has lse ~ -1e30); lse2(i) is the
// lse of element i in log2 units
template <int F, typename Lse>
__device__ __forceinline__ void probs(float (&s)[F], Lse lse2,
                                      uint32_t valid, float sl2) {
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const float pe = exp2f(fmaf(s[i], sl2, -lse2(i)));
    s[i] = ((valid >> i) & 1u) ? pe : 0.f;
  }
}

// dP -> dS = P (dP - D) in place; d(i) is the D of element i
template <int F, typename Dd>
__device__ __forceinline__ void dscores(const float (&pr)[F],
                                        float (&dp)[F], Dd d) {
#pragma unroll
  for (int i = 0; i < F; ++i) dp[i] = pr[i] * (dp[i] - d(i));
}

// S^T-like (64 x 32) = A (64 x W) . B^T (rows of B: 32 from `b`), both
// K-major swizzled tiles (W = hd or hdv, a multiple of 64); the first step
// overwrites d
template <int W>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    tc::wgmma_ss_n32(d, tc::desc(a + off, 16, 1024),
                     tc::desc(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x 128) += A (a 64 x 64 K-major tile at `a`) . B (64 rows x 128
// columns of a tile from `b`, read MN-major)
__device__ __forceinline__ void mma_ss_n128_mn(float (&acc)[64], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma_ss_n128_mn(acc, tc::desc(a + kk * 32, 16, 1024),
                         tc::desc(b + kk * 2048, 8192, 1024));
}

// A 64 x 32 accumulator fragment (this thread's rows `row` and row + 8,
// the tile's columns 8 chunk0 + 8 (i / 4) + 2 t4 + (i & 1)) into a 64 x 64
// K-major swizzled bf16 tile (`tile`: a generic pointer to it, 1,024-byte
// aligned) as bf16, or (`lo`) as the rest after bf16, x - bf16(x)
template <bool LO>
__device__ __forceinline__ void put_tile(unsigned char* tile,
                                         const float (&x)[16], int row,
                                         int chunk0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = x[4 * j + 2 * r], b = x[4 * j + 2 * r + 1];
      if (LO) {
        const float2 h = bf16x2(tc::pack_bf16(a, b));
        a -= h.x;
        b -= h.y;
      }
      *reinterpret_cast<uint32_t*>(
          tile + rr * 128 + (((chunk0 + j) ^ (rr % 8)) * 16) + 4 * t4) =
          tc::pack_bf16(a, b);
    }
  }
}

// Copy rows [0, n_valid) of 32 rows from `src` (row stride ss elements)
// into rows [r0, r0 + 32) of the 64-row swizzled tile at `dst` (as
// tc::load_tile lays it out), with the 128 threads of one warpgroup (t:
// the thread's index in it); rows past n_valid become zeros.  HD is a
// multiple of 64.
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int n_valid, int t,
                                          int r0) {
  constexpr int C = HD / 8;  // 16-byte chunks per row
  static_assert(HD % 64 == 0 && 32 * C % THREADS == 0, "whole chunks");
#pragma unroll
  for (int j = 0; j < 32 * C / THREADS; ++j) {
    const int i = t + j * THREADS;
    const int r = i / C, c = i % C, rr = r0 + r;
    const bool ok = r < n_valid;
    tc::cp_async16(dst + (c / 8) * 8192 + rr * 128 + ((c % 8) ^ (rr % 8)) * 16,
               ok ? src + r * ss + c * 8 : src, ok);
  }
}

// A barrier over the 128 threads of warpgroup wg (barriers 1 and 2;
// __syncthreads takes 0)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One fragment row (half r: rows g and g + 8) of a warpgroup's W columns
// of an accumulator, times mul: bf16 into `out` (the CTA owns the row) or,
// where `part` is not null, float32 into `part`; both point at the row's
// column 2 t4
template <int W>
__device__ __forceinline__ void put_row(const float* acc, int r, float mul,
                                        __nv_bfloat16* out, float* part) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float x = acc[4 * j + 2 * r] * mul, y = acc[4 * j + 2 * r + 1] * mul;
    if (part != nullptr)
      *reinterpret_cast<float2*>(part + 8 * j) = make_float2(x, y);
    else
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(x, y);
  }
}

// D = rowsum(dO o) for the route's aligned operands: 16-byte loads (8
// bf16), HDV / 8 neighbouring lanes a row, 64 rows a CTA
template <int HDV>
__global__ void __launch_bounds__(RED_THREADS)
fa_bwd_preprocess_tc_kernel(const bwd::Params p) {
  constexpr int L = HDV / 8;              // lanes per row
  static_assert(L <= 32 && 32 % L == 0, "a row's lanes within a warp");
  const int bh = blockIdx.y, b = bh / p.h, head = bh % p.h;
  const int c = threadIdx.x % L;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) +
                           b * p.o_sb + head * p.o_sh + 8 * c;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh + 8 * c;
  const int r_end = min(p.sq, (blockIdx.x + 1) * B64);
  // every thread takes every pass, so whole rows meet in the shuffles
  for (int r0 = blockIdx.x * B64; r0 < r_end; r0 += RED_THREADS / L) {
    const int r = r0 + static_cast<int>(threadIdx.x) / L;
    float s = 0.f;
    if (r < r_end) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + r * p.o_ss);
      const uint4 e = *reinterpret_cast<const uint4*>(dout + r * p.do_ss);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = bf16x2(aw[i]), y = bf16x2(ew[i]);
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (r < r_end && c == 0)
      p.delta[static_cast<long long>(bh) * p.sq + r] = s;
  }
}

// The query tiles [x, y) whose mask reaches keys [k0, k0 + keys)
__device__ __forceinline__ int2 query_tiles(const bwd::Params& p, int k0,
                                            int keys) {
  const int nq = (p.sq + B64 - 1) / B64;
  const int lo = p.causal ? min(nq, k0 / B64) : 0;
  int hi = nq;
  if (p.window > 0) hi = min(nq, (k0 + keys - 1 + p.window - 1) / B64 + 1);
  return make_int2(lo, hi);
}

// The key tiles [x, y) that query rows [q0, q0 + rows) reach (the
// forward's loop bounds)
__device__ __forceinline__ int2 key_tiles(const bwd::Params& p, int q0,
                                          int rows) {
  const int nk = (p.sk + B64 - 1) / B64;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + rows + B64 - 1) / B64);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    lo = first > 0 ? first / B64 : 0;
  }
  return make_int2(lo, hi);
}

// dK / dV up to hd 128: one warpgroup computes S^T, P^T, dP^T, dS^T and
// keeps dK and dV, for key tile `kt` of the (b, head) of blockIdx.x
template <int HD, int HDV>
__device__ __forceinline__ void dkdv_one_warpgroup(const bwd::Params& p,
                                                   float* dk_part,
                                                   float* dv_part, int kt) {
  constexpr int HDP = tc::hd_padded<HD>(), HDVP = tc::hd_padded<HDV>();
  constexpr int TILE = 64 * HDP * 2;    // bytes of a K or Q tile
  constexpr int VTILE = 64 * HDVP * 2;  // bytes of a V or dO tile
  constexpr int DV = HDP / 2;           // dK at acc[0, DV), dV after it
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t ks = (s0 + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t qs = vs + VTILE;       // two stages
  const uint32_t dos = qs + 2 * TILE;   // two stages
  const uint32_t rs = dos + 2 * VTILE;  // per stage: lse[64], then D[64]
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvh = head / p.g;
  const int k0 = kt * B64;  // key tile 0 (the longest reach) first
  const int keys = min(B64, p.sk - k0);

  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + kvh * p.k_sh + k0 * p.k_ss;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + kvh * p.v_sh + k0 * p.v_ss;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + head * p.q_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;
  const int2 qtr = query_tiles(p, k0, keys);
  const int qt_lo = qtr.x, qt_hi = qtr.y;

  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * B64, n = p.sq - q0;
    tc::load_tile<HD, HDP>(qs + st * TILE, q + q0 * p.q_ss, p.q_ss, n, tid);
    tc::load_tile<HDV, HDVP>(dos + st * VTILE, dout + q0 * p.do_ss, p.do_ss,
                             n, tid);
    if (tid < 2 * B64) {
      const int r = tid % B64;
      const float* src = (tid < B64 ? lse : delta) + q0;
      cp_async4(rs + st * 512 + tid * 4, r < n ? src + r : src, r < n);
    }
  };
  tc::load_tile<HD, HDP>(ks, k, p.k_ss, keys, tid);
  tc::load_tile<HDV, HDVP>(vs, v, p.v_ss, keys, tid);
  if (qt_lo < qt_hi) load_q_tile(qt_lo, 0);
  tc::cp_async_commit();

  float acc[(HDP + HDVP) / 2];
#pragma unroll
  for (int j = 0; j < (HDP + HDVP) / 2; ++j) acc[j] = 0.f;
  const float sl2 = p.scale * LOG2E;
  const int krow = warp * 16 + g8;  // this thread's rows: krow, krow + 8

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int st = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) {  // the next query tile streams in meanwhile
      load_q_tile(qt + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();
    const uint32_t qst = qs + st * TILE, dost = dos + st * VTILE;

    // S^T first, then P^T in float (kept for dS^T) and as bf16 fragments;
    // dP^T's accumulator is born after them (no spills at hd 128)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::wgmma_fence();
    mma_ss<HDP>(s, ks, qst);     // S^T = K.Q^T
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    // lse, then D, of this thread's column (query) c of element i
    const float* lse_t = rows_p + st * 128;
    auto col = [&](int i) { return 2 * t4 + 8 * (i / 4) + (i & 1); };
    const int q0 = qt * B64;
    probs(s, [&](int i) { return lse_t[col(i)] * LOG2E; },
          edge_tile(p, q0, k0) ? valid_bits<true>(p, k0 + krow, q0 + 2 * t4)
                               : 0xFFFFFFFFu,
          sl2);
    uint32_t ap[4][4];
    pack_a(s, ap);
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    tc::wgmma_fence();
    mma_ss<HDVP>(dp, vs, dost);            // dP^T = V.dO^T
    mma_rs<HDVP>(acc + DV, ap, dost);      // dV += P^T.dO
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    dscores(s, dp, [&](int i) { return lse_t[64 + col(i)]; });
    uint32_t as[4][4], al[4][4];
    pack_split(dp, as, al);
    tc::wgmma_fence();
    mma_rs<HDP>(acc, as, qst);   // dK += dS^T.Q, dS^T as hi + lo
    mma_rs<HDP>(acc, al, qst);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();  // no copy may outlive the CTA

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= keys) continue;
    // g = 1: this CTA owns the rows (bf16); else float32 partials of this
    // query head, (B, Sk, H, hd) and (B, Sk, H, hdv)
    const long long prow =
        (static_cast<long long>(b) * p.sk + k0 + row) * p.h + head;
    put_row<HD>(acc, r, p.scale,
                static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                    kvh * p.dk_sh + (k0 + row) * p.dk_ss + 2 * t4,
                dk_part ? dk_part + prow * HD + 2 * t4 : nullptr);
    put_row<HDV>(acc + DV, r, 1.f,
                 static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                     kvh * p.dv_sh + (k0 + row) * p.dv_ss + 2 * t4,
                 dv_part ? dv_part + prow * HDV + 2 * t4 : nullptr);
  }
}

// dK / dV past hd 128: two warpgroups over the CTA's 64 keys, each
// computing S^T and dP^T over its 32 of a query tile's 64 queries, so
// that the CTA computes each once.  Then (dkdv_split_cols) either each
// warpgroup accumulates dK and dV over its queries (register-A products,
// K = 32) and the two partials are summed once, after the loop, or both
// put P^T and dS^T into shared memory and each accumulates its half of
// dK's and of dV's columns over all 64 queries.  Both warpgroups run one
// instruction stream: only addresses depend on the warpgroup.
template <int HD, int HDV>
__device__ __forceinline__ void dkdv_two_warpgroups(const bwd::Params& p,
                                                    float* dk_part,
                                                    float* dv_part) {
  constexpr bool COLS = dkdv_split_cols<HD, HDV>();
  static_assert(HD % 64 == 0 && HDV % 64 == 0 &&
                    (!COLS || (HD == 256 && HDV == 256)),
                "whole swizzle atoms; a column half is 128 wide");
  constexpr int NT = 2 * THREADS;
  constexpr int TILE = 64 * HD * 2;    // bytes of a K or Q tile
  constexpr int VTILE = 64 * HDV * 2;  // bytes of a V or dO tile
  // this thread's dK and dV columns: all of them (a partial over its
  // warpgroup's queries) or its warpgroup's half
  constexpr int KW = COLS ? HD / 2 : HD, VW = COLS ? HDV / 2 : HDV;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t ks = (s0 + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t qs = vs + VTILE;        // two stages
  const uint32_t dos = qs + 2 * TILE;    // two stages
  const uint32_t pts = dos + 2 * VTILE;  // COLS: P^T, dS^T hi, dS^T lo
  const uint32_t rs = pts + (COLS ? 3 * PTILE : 0);  // lse[64], D[64] a stage
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));
  unsigned char* ptile = smem + (pts - s0);

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / THREADS, warp = (tid % THREADS) / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvh = head / p.g;
  const int k0 = blockIdx.y * B64;  // key tile 0 (the longest reach) first
  const int keys = min(B64, p.sk - k0);

  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + kvh * p.k_sh + k0 * p.k_ss;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + kvh * p.v_sh + k0 * p.v_ss;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + head * p.q_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.sq;
  const int2 qtr = query_tiles(p, k0, keys);

  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * B64, n = p.sq - q0;
    tc::load_tile<HD, HD, NT>(qs + st * TILE, q + q0 * p.q_ss, p.q_ss, n,
                              tid);
    tc::load_tile<HDV, HDV, NT>(dos + st * VTILE, dout + q0 * p.do_ss,
                                p.do_ss, n, tid);
    if (tid < 2 * B64) {
      const int r = tid % B64;
      const float* src = (tid < B64 ? lse : delta) + q0;
      cp_async4(rs + st * 512 + tid * 4, r < n ? src + r : src, r < n);
    }
  };
  tc::load_tile<HD, HD, NT>(ks, k, p.k_ss, keys, tid);
  tc::load_tile<HDV, HDV, NT>(vs, v, p.v_ss, keys, tid);
  if (qtr.x < qtr.y) load_q_tile(qtr.x, 0);
  tc::cp_async_commit();

  float dk[KW / 2], dv[VW / 2];
#pragma unroll
  for (int j = 0; j < KW / 2; ++j) dk[j] = 0.f;
#pragma unroll
  for (int j = 0; j < VW / 2; ++j) dv[j] = 0.f;
  const float sl2 = p.scale * LOG2E;
  const int krow = warp * 16 + g8;  // this thread's keys: krow, krow + 8
  const int qh = 32 * wg;           // this warpgroup's queries of a tile
  // the query of the tile in S^T's column of element i
  auto col = [&](int i) { return qh + 2 * t4 + 8 * (i / 4) + (i & 1); };

  for (int qt = qtr.x; qt < qtr.y; ++qt) {
    const int st = (qt - qtr.x) & 1;
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    // tile qt has landed, and both warpgroups are past tile qt - 1's
    // products: its stage (and P^T and dS^T) may be written
    __syncthreads();
    if (qt + 1 < qtr.y) load_q_tile(qt + 1, st ^ 1);  // streams in meanwhile
    tc::cp_async_commit();
    const uint32_t qst = qs + st * TILE, dost = dos + st * VTILE;
    const float* lse_t = rows_p + st * 128;  // lse[64], then D[64]
    const int q0 = qt * B64;

    // S^T = K.Q^T and dP^T = V.dO^T over this warpgroup's queries
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    mma_ss_n32<HD>(s, ks, qst + qh * 128);
    tc::wgmma_commit();
    mma_ss_n32<HDV>(dp, vs, dost + qh * 128);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // S^T; dP^T runs on
    tc::fence_regs(s);
    probs(s, [&](int i) { return lse_t[col(i)] * LOG2E; },
          edge_tile(p, q0, k0)
              ? valid_bits<true, 16>(p, k0 + krow, q0 + qh + 2 * t4)
              : 0xFFFFFFFFu,
          sl2);
    if constexpr (COLS) {
      // P^T (bf16) into its shared tile; dV's product over all 64 queries
      // runs while dS^T is formed
      put_tile<false>(ptile, s, krow, qh / 8, t4);
      tc::fence_async_smem();
      __syncthreads();
      tc::wgmma_fence();
      mma_ss_n128_mn(dv, pts, dost + wg * 2 * 8192);  // dV += P^T.dO
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // dP^T; dV runs on
      tc::fence_regs(dp);
      dscores(s, dp, [&](int i) { return lse_t[64 + col(i)]; });
      put_tile<false>(ptile + PTILE, dp, krow, qh / 8, t4);
      put_tile<true>(ptile + 2 * PTILE, dp, krow, qh / 8, t4);
      tc::fence_async_smem();
      __syncthreads();
      tc::wgmma_fence();
      // dK += dS^T.Q, dS^T as hi + lo
      mma_ss_n128_mn(dk, pts + PTILE, qst + wg * 2 * 8192);
      mma_ss_n128_mn(dk, pts + 2 * PTILE, qst + wg * 2 * 8192);
      tc::wgmma_commit();
    } else {
      uint32_t ap[2][4];
      pack_a(s, ap);
      tc::wgmma_fence();
      mma_rs<HDV>(dv, ap, dost + qh * 128);  // dV += P^T.dO, its queries
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // dP^T; dV runs on
      tc::fence_regs(dp);
      dscores(s, dp, [&](int i) { return lse_t[64 + col(i)]; });
      uint32_t as[2][4], al[2][4];
      pack_split(dp, as, al);
      tc::wgmma_fence();
      mma_rs<HD>(dk, as, qst + qh * 128);  // dK += dS^T.Q, hi + lo
      mma_rs<HD>(dk, al, qst + qh * 128);
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
  }
  tc::fence_regs(dk);
  tc::fence_regs(dv);
  tc::cp_async_wait<0>();  // no copy may outlive the CTA

  const int t = tid % THREADS;
  if constexpr (!COLS) {
    // the two partials meet in the stages' shared memory, free now:
    // warpgroup 1 hands over its dK, warpgroup 0 its dV
    static_assert((KW + VW) / 2 * THREADS * 4 <= 2 * (TILE + VTILE),
                  "the partials fit the stages");
    float* x = reinterpret_cast<float*>(smem + (qs - s0));
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < KW / 2; ++j) x[j * THREADS + t] = dk[j];
    } else {
#pragma unroll
      for (int j = 0; j < VW / 2; ++j) x[(KW / 2 + j) * THREADS + t] = dv[j];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < KW / 2; ++j) dk[j] += x[j * THREADS + t];
    } else {
#pragma unroll
      for (int j = 0; j < VW / 2; ++j) dv[j] += x[(KW / 2 + j) * THREADS + t];
    }
  }
  // each warpgroup's halves (COLS), else dK by warpgroup 0 and dV by 1
  const int kc = COLS ? wg * KW : 0, vc = COLS ? wg * VW : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= keys) continue;
    // g = 1: this CTA owns the rows (bf16); else float32 partials of this
    // query head, (B, Sk, H, hd) and (B, Sk, H, hdv)
    const long long prow =
        (static_cast<long long>(b) * p.sk + k0 + row) * p.h + head;
    if (COLS || wg == 0)
      put_row<KW>(dk, r, p.scale,
                  static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                      kvh * p.dk_sh + (k0 + row) * p.dk_ss + kc + 2 * t4,
                  dk_part ? dk_part + prow * HD + kc + 2 * t4 : nullptr);
    if (COLS || wg == 1)
      put_row<VW>(dv, r, 1.f,
                  static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                      kvh * p.dv_sh + (k0 + row) * p.dv_ss + vc + 2 * t4,
                  dv_part ? dv_part + prow * HDV + vc + 2 * t4 : nullptr);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS * warpgroups<HD>())
fa_bwd_dkdv_tc_kernel(const bwd::Params p, float* dk_part, float* dv_part) {
  if constexpr (warpgroups<HD>() == 1)
    dkdv_one_warpgroup<HD, HDV>(p, dk_part, dv_part, blockIdx.y);
  else
    dkdv_two_warpgroups<HD, HDV>(p, dk_part, dv_part);
}

// dQ up to hd 128: one warpgroup computes S, P, dP, dS and keeps dQ, for
// the query tile `y` from the last of the (b, head) of blockIdx.x
template <int HD, int HDV>
__device__ __forceinline__ void dq_one_warpgroup(const bwd::Params& p,
                                                 int y) {
  constexpr int HDP = tc::hd_padded<HD>(), HDVP = tc::hd_padded<HDV>();
  constexpr int TILE = 64 * HDP * 2;    // bytes of a Q or K tile
  constexpr int VTILE = 64 * HDVP * 2;  // bytes of a dO or V tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t qs = (s0 + 1023u) & ~1023u;
  const uint32_t dos = qs + TILE;
  const uint32_t ks = dos + VTILE;      // two stages
  const uint32_t vs = ks + 2 * TILE;    // two stages
  const uint32_t rs = vs + 2 * VTILE;   // lse[64], then D[64]
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvh = head / p.g;
  const int nq = (p.sq + B64 - 1) / B64;
  const int q0 = (nq - 1 - y) * B64;
  const int rows = min(B64, p.sq - q0);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + head * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh + q0 * p.do_ss;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int2 ktr = key_tiles(p, q0, rows);
  const int lo = ktr.x, hi = ktr.y;

  tc::load_tile<HD, HDP>(qs, q, p.q_ss, rows, tid);
  tc::load_tile<HDV, HDVP>(dos, dout, p.do_ss, rows, tid);
  if (tid < 2 * B64) {
    const int r = tid % B64;
    const float* src = (tid < B64 ? p.lse : p.delta) +
                       static_cast<long long>(bh) * p.sq + q0;
    cp_async4(rs + tid * 4, r < rows ? src + r : src, r < rows);
  }
  auto load_kv_tile = [&](int kt, int st) {
    const int kk0 = kt * B64;
    tc::load_tile<HD, HDP>(ks + st * TILE, k + kk0 * p.k_ss, p.k_ss,
                           p.sk - kk0, tid);
    tc::load_tile<HDV, HDVP>(vs + st * VTILE, v + kk0 * p.v_ss, p.v_ss,
                             p.sk - kk0, tid);
  };
  if (lo < hi) load_kv_tile(lo, 0);
  tc::cp_async_commit();

  float dq[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) dq[j] = 0.f;
  const float sl2 = p.scale * LOG2E;
  const int qrow = warp * 16 + g8;  // this thread's rows: qrow, qrow + 8
  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_kv_tile(kt + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();
    if (kt == lo) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = rows_p[qrow + 8 * r] * LOG2E;
        dd[r] = rows_p[64 + qrow + 8 * r];
      }
    }
    const uint32_t kst = ks + st * TILE, vst = vs + st * VTILE;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    mma_ss<HDP>(s, qs, kst);     // S = Q.K^T
    mma_ss<HDVP>(dp, dos, vst);  // dP = dO.V^T
    tc::wgmma_commit();
    tc::wgmma_wait_all();

    const int k0 = kt * B64;
    probs(s, [&](int i) { return lse2[(i % 4) / 2]; },
          edge_tile(p, q0, k0) ? valid_bits<false>(p, q0 + qrow, k0 + 2 * t4)
                               : 0xFFFFFFFFu,
          sl2);
    dscores(s, dp, [&](int i) { return dd[(i % 4) / 2]; });
    uint32_t as[4][4], al[4][4];
    pack_split(dp, as, al);
    tc::wgmma_fence();
    mma_rs<HDP>(dq, as, kst);   // dQ += dS.K, dS as hi + lo
    mma_rs<HDP>(dq, al, kst);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= rows) continue;
    put_row<HD>(dq, r, p.scale,
                static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                    head * p.dq_sh + (q0 + row) * p.dq_ss + 2 * t4,
                nullptr);
  }
}

// dQ past hd 128: two warpgroups over the CTA's 64 queries, each taking
// 32 of every key tile's 64 keys: S and dP over its keys (so the CTA
// computes each once), dS in registers, and a partial dQ over its keys
// (register-A products, K = 32).  The partials are summed once, after the
// loop, each warpgroup writing half of dQ's columns.  Q, dO, lse and D
// are shared; each warpgroup streams only its own rows of K and V (two
// stages) behind a barrier of its own, as the dK / dV CTA by queries does.
template <int HD, int HDV>
__device__ __forceinline__ void dq_two_warpgroups(const bwd::Params& p) {
  static_assert(HD % 64 == 0 && HDV % 64 == 0, "whole swizzle atoms");
  constexpr int NT = 2 * THREADS;
  constexpr int TILE = 64 * HD * 2;    // bytes of a Q or K tile
  constexpr int VTILE = 64 * HDV * 2;  // bytes of a dO or V tile
  constexpr int H4 = HD / 4;  // dQ's floats a thread in half its columns
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t qs = (s0 + 1023u) & ~1023u;
  const uint32_t dos = qs + TILE;
  const uint32_t ks = dos + VTILE;      // two stages
  const uint32_t vs = ks + 2 * TILE;    // two stages
  const uint32_t rs = vs + 2 * VTILE;   // lse[64], then D[64]
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / THREADS, t = tid % THREADS, warp = t / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvh = head / p.g;
  const int nq = (p.sq + B64 - 1) / B64;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * B64;
  const int rows = min(B64, p.sq - q0);
  const int kh = 32 * wg;  // this warpgroup's keys of a tile

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + head * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh + q0 * p.do_ss;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int2 ktr = key_tiles(p, q0, rows);

  tc::load_tile<HD, HD, NT>(qs, q, p.q_ss, rows, tid);
  tc::load_tile<HDV, HDV, NT>(dos, dout, p.do_ss, rows, tid);
  if (tid < 2 * B64) {
    const int r = tid % B64;
    const float* src = (tid < B64 ? p.lse : p.delta) +
                       static_cast<long long>(bh) * p.sq + q0;
    cp_async4(rs + tid * 4, r < rows ? src + r : src, r < rows);
  }
  // this warpgroup's 32 rows of key tile kt into stage st
  auto load_kv_rows = [&](int kt, int st) {
    const int k0 = kt * B64 + kh, n = p.sk - k0;
    load_rows<HD>(ks + st * TILE, k + k0 * p.k_ss, p.k_ss, n, t, kh);
    load_rows<HDV>(vs + st * VTILE, v + k0 * p.v_ss, p.v_ss, n, t, kh);
  };
  if (ktr.x < ktr.y) load_kv_rows(ktr.x, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  __syncthreads();  // Q, dO, lse, D: both warpgroups read all 64 queries

  float dq[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;
  const float sl2 = p.scale * LOG2E;
  const int qrow = warp * 16 + g8;  // this thread's rows: qrow, qrow + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows_p[qrow + 8 * r] * LOG2E;
    dd[r] = rows_p[64 + qrow + 8 * r];
  }

  for (int kt = ktr.x; kt < ktr.y; ++kt) {
    const int st = (kt - ktr.x) & 1;
    if (kt > ktr.x) {
      tc::cp_async_wait<0>();
      tc::fence_async_smem();
      // this warpgroup's rows of tile kt have landed, and its threads are
      // past tile kt - 1's products: that stage may be refilled
      warpgroup_sync(wg);
    }
    const uint32_t kst = ks + st * TILE + kh * 128;
    const uint32_t vst = vs + st * VTILE + kh * 128;

    // S = Q.K^T and dP = dO.V^T over this warpgroup's keys
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    mma_ss_n32<HD>(s, qs, kst);
    tc::wgmma_commit();
    mma_ss_n32<HDV>(dp, dos, vst);
    tc::wgmma_commit();
    // the next tile's rows stream in meanwhile
    if (kt + 1 < ktr.y) load_kv_rows(kt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::wgmma_wait<1>();  // S; dP runs on
    tc::fence_regs(s);
    const int k0 = kt * B64;
    probs(s, [&](int i) { return lse2[(i % 4) / 2]; },
          edge_tile(p, q0, k0)
              ? valid_bits<false, 16>(p, q0 + qrow, k0 + kh + 2 * t4)
              : 0xFFFFFFFFu,
          sl2);
    tc::wgmma_wait<0>();
    tc::fence_regs(dp);
    dscores(s, dp, [&](int i) { return dd[(i % 4) / 2]; });
    uint32_t as[2][4], al[2][4];
    pack_split(dp, as, al);
    tc::wgmma_fence();
    mma_rs<HD>(dq, as, kst);  // dQ += dS.K, dS as hi + lo
    mma_rs<HD>(dq, al, kst);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
  }
  tc::fence_regs(dq);
  tc::cp_async_wait<0>();

  // the partials meet in the K stages' shared memory, free once both
  // warpgroups are past their loops: warpgroup 0 writes dQ's columns [0,
  // HD / 2) and warpgroup 1 the rest, each handing the other its partial
  // of the other's columns
  static_assert(HD / 2 * THREADS * 4 <= 2 * TILE, "the partials fit");
  float* x = reinterpret_cast<float*>(smem + (ks - s0));
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < H4; ++j) x[(H4 + j) * THREADS + t] = dq[H4 + j];
  } else {
#pragma unroll
    for (int j = 0; j < H4; ++j) x[j * THREADS + t] = dq[j];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < H4; ++j) dq[j] += x[j * THREADS + t];
  } else {
#pragma unroll
    for (int j = 0; j < H4; ++j) dq[H4 + j] += x[(H4 + j) * THREADS + t];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* dqr = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                         head * p.dq_sh + (q0 + row) * p.dq_ss +
                         wg * (HD / 2) + 2 * t4;
    if (wg == 0)
      put_row<HD / 2>(dq, r, p.scale, dqr, nullptr);
    else
      put_row<HD / 2>(dq + H4, r, p.scale, dqr, nullptr);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS * warpgroups<HD>())
fa_bwd_dq_tc_kernel(const bwd::Params p) {
  if constexpr (warpgroups<HD>() == 1)
    dq_one_warpgroup<HD, HDV>(p, blockIdx.y);
  else
    dq_two_warpgroups<HD, HDV>(p);
}


// ----------------------------- dK / dV and dQ in one grid, up to hd 128
// fa_bwd_dkdv_dq_tc_kernel: the dK / dV CTAs and the dQ CTAs of the
// kernels above (one warpgroup each, up to hd 128) as one launch, where H
// == Hkv and `fa_backward_tc`'s caller asks for it (the wrapper's
// backward_plan: at (64, 64)); the preprocess (D) runs before it as
// before.
//
// What bounds it.  whisper-tiny's encoder in training, (8, 1500, 6, 6) at
// hd 64, is 69 GFLOP for the five products (0.070 ms at 989 TFLOP/s);
// the two kernels took 0.220 and 0.176 ms on an H100 80GB HBM3, each
// 1,152 CTAs two an SM (190 and 178 registers): 4.4 waves of the 264
// places, so 5 rounds, the last 36% full, and the dQ kernel cannot start
// before the last dK / dV CTA ends.
//
// What the design does about that.  The two kernels' CTAs share one grid,
// (b H, nk + nq): y below nk a dK / dV CTA of key tile y, else a dQ CTA
// (the dQ kernel's order: the query tile of longest reach first).  They
// read the same D, q, k, v, o and dO and write disjoint outputs, so they
// run side by side: 2,304 CTAs in 8.7 waves, 9 rounds, and the dK / dV
// CTAs' tail fills with dQ CTAs.  Each CTA's work and numerics are the
// kernels' own, so the gradients are bit-equal to theirs.  (A one-pass
// kernel that computed S and dP once a pair and added each key tile's dQ
// partial into a float32 accumulator in a fixed order of the key tiles,
// under a ticket a query tile, took 0.54-0.59 ms there: PERF.md.)
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_dq_tc_kernel(const bwd::Params p) {
  static_assert(warpgroups<HD>() == 1, "one warpgroup a CTA, up to hd 128");
  const int nk = (p.sk + B64 - 1) / B64;
  if (static_cast<int>(blockIdx.y) < nk)
    dkdv_one_warpgroup<HD, HDV>(p, nullptr, nullptr, blockIdx.y);
  else
    dq_one_warpgroup<HD, HDV>(p, blockIdx.y - nk);
}

// ------------------------- the one-launch backward at (24, 16), short heads
// fa_bwd_narrow_tc_kernel: DeepSeek-V2-Lite's smoke pair (24, 16) where
// Sq and Sk are at most narrow::MAX_LEN (256), chosen by the wrapper's
// backward_plan from the shapes alone (`fa_backward_narrow`); longer heads
// take the three (four with GQA) kernels above.
//
// What bounds it.  At the smoke's (2, 256, 4, 4) causal the five products
// are 2 (3 x 24 + 2 x 16) x 8 heads x 32,896 pairs = 55 MFLOP against
// 165 KB of operands and gradients: 0.05 us on the bytes, 0.06 us on the
// tensor cores.  Neither binds.  The three-kernel route pays three
// launches and, in each of its 32-CTA kernels, a chain of up to four
// dependent tile steps on widths padded to 64 (its dK / dV kernel alone
// takes 0.0101 ms of device time on an H100 80GB HBM3,
// tools/compare_flash_backward.py).
//
// What the design does about that.  One launch computes D, dQ, dK and dV,
// deterministic (no float atomics), and no CTA walks more than one
// (query tile, key tile) step a query head:
//   - a cluster of WG = 4 CTAs owns one (b, kv head); CTA r of it owns
//     query tile r, and each CTA's four warpgroups own one key tile each,
//     so the cluster covers the head's 4 x 4 tiles at once;
//   - a CTA loads every K and V tile once, then per query head of the kv
//     head (GQA: the g heads in head order) its Q, dO and lse tile and
//     computes D = rowsum(dO o) for its rows (two lanes a row, summed as
//     fa_bwd_preprocess_tc_kernel sums them), not in a launch of its own;
//   - each warpgroup computes, for one half of the tile's queries after
//     the other, S^T = K.Q^T and dP^T = V.dO^T (m64n32k16, K-major), P^T
//     and dS^T in registers, and writes P^T and dS^T (hi and lo) as bf16
//     into its own three 64 x 64 shared tiles; behind a barrier of the
//     warpgroup's own it issues, as one group, dV += P^T.dO (m64n16k16),
//     dK += dS^T.Q (m64n32k16, hi + lo; A K-major) and dQ's partial over
//     its keys, dS.K (m64n32k16, hi + lo; A read MN-major from the same
//     dS^T tiles), every B MN-major.  So no A fragment sits in registers,
//     and 32 score floats, not 64, sit beside the gradients' 24: with P^T
//     and dS^T as register fragments, and again with S^T and dP^T whole
//     (64 x 64), ptxas spilled 24 and 28 bytes at the 128 registers four
//     warpgroups allow;
//   - dQ: the four warpgroups' partials meet in shared memory (two sets,
//     by the parity of the head, so one CTA barrier a head suffices) and
//     are summed in warpgroup order, each warpgroup 8 of dQ's columns;
//   - dK and dV: each warpgroup keeps its key tile's partial over its
//     CTA's queries in registers over the heads; after the last head it
//     stores the partial into the tile's owner CTA through the cluster's
//     distributed shared memory (a cluster barrier before, one after), and
//     CTA r's warpgroup r sums key tile r's four partials in rank order.
//   (A first layout, one CTA a (b, kv head) walking the four query tiles
//   itself, took 0.0200-0.0222 ms of device time at the smoke's shape,
//   against the three kernels' 0.0213: the chain of tile steps, not the
//   launches, set its time.)
// A (query, key) tile past the causal or window reach, or past Sq or Sk,
// is masked whole (P = dS = 0) rather than skipped, so every warpgroup runs
// the same code: no wgmma sits under a branch on the warpgroup.  Widths
// are padded only to the next k16 step: q.k's 24 to 32 (64-byte rows and
// swizzle), v's 16 stays 16 (32-byte rows and swizzle).  Shared memory a
// CTA: K 16 KiB, V 8 KiB, its Q and dO tiles 6 KiB, lse and D 0.5 KiB,
// P^T and dS^T 96 KiB, the partials 64 KiB: 191.5 KiB (one CTA an SM).
// Numerics as above: P rounded to bf16 for dV, dS as hi + lo for dK and
// dQ.
namespace narrow {

constexpr int WG = 4;                // warpgroups a CTA, CTAs a cluster
constexpr int THREADS = 128 * WG;
constexpr int MAX_LEN = WG * B64;    // the queries and keys of one head
constexpr int ST = 64 * 64 * 2;      // bytes of a P^T or dS^T tile

template <int HD, int HDV>
constexpr int smem_bytes() {
  // K and V (MAX_LEN rows), the CTA's Q and dO tiles, its lse and D rows,
  // each warpgroup's P^T, dS^T hi and lo, two sets of WG dQ partials (64
  // x hd float32; after the heads, the dK and dV partials), slack to align
  // to 1,024 bytes
  return (MAX_LEN + B64) *
             (tc::k16_padded<HD>() + tc::k16_padded<HDV>()) * 2 +
         2 * B64 * 4 + WG * 3 * ST + 2 * WG * 64 * tc::k16_padded<HD>() * 4 +
         1024;
}

template <int HD, int HDV>
__global__ void __cluster_dims__(WG, 1, 1) __launch_bounds__(THREADS, 1)
fa_bwd_narrow_tc_kernel(const bwd::Params p) {
  constexpr int HDP = tc::k16_padded<HD>(), HDVP = tc::k16_padded<HDV>();
  static_assert(HD % 8 == 0 && HDP == 32 && HDV == 16,
                "dK and dQ at N = 32, dV at N = 16; D two lanes a row");
  constexpr int KT = 64 * HDP * 2;   // bytes of a K or Q tile
  constexpr int VT = 64 * HDVP * 2;  // bytes of a V or dO tile
  constexpr int NQ = HDP / 2;        // a thread's floats of dK, dQ
  constexpr int NV = HDVP / 2;       // a thread's floats of dV
  static_assert((NQ + NV) <= 2 * NQ, "dK and dV's partials fit dQ's");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t ks = (s0 + 1023u) & ~1023u;  // WG tiles
  const uint32_t vs = ks + WG * KT;           // WG tiles
  const uint32_t qs = vs + WG * VT;           // the CTA's query tile
  const uint32_t dos = qs + KT;
  const uint32_t sts = dos + VT;  // a warpgroup's P^T, dS^T hi, lo
  const uint32_t dqs = sts + WG * 3 * ST;     // 2 x WG dQ partials
  const uint32_t rs = dqs + 2 * WG * NQ * 128 * 4;
  float* part = reinterpret_cast<float*>(smem + (dqs - s0));
  float* lse_s = reinterpret_cast<float*>(smem + (rs - s0));  // 64
  float* d_s = lse_s + B64;                                    // 64

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  // warp-uniform: only addresses depend on it until the sums
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, lane = t % 32, warp = t / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int hkv = p.h / p.g;
  const int bk = blockIdx.x / WG, b = bk / hkv, kvh = bk % hkv;
  const int qt = static_cast<int>(cluster.block_rank());  // query tile
  const int q0 = qt * B64;
  const int k0 = wg * B64;          // this warpgroup's key tile
  const int krow = warp * 16 + g8;  // this thread's rows: krow, krow + 8
  const uint32_t kst = ks + wg * KT, vst = vs + wg * VT;
  const uint32_t pts = sts + wg * 3 * ST;  // P^T, dS^T hi, dS^T lo
  const float sl2 = p.scale * LOG2E;

  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  // every key tile once (row r of the MAX_LEN lands in tile r / 64)
  tc::load_narrow<HD, HDP, THREADS>(ks, k, p.k_ss, p.sk, MAX_LEN, tid);
  tc::load_narrow<HDV, HDVP, THREADS>(vs, v, p.v_ss, p.sk, MAX_LEN, tid);

  float dk[NQ], dv[NV];
#pragma unroll
  for (int j = 0; j < NQ; ++j) dk[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) dv[j] = 0.f;

  for (int hq = kvh * p.g; hq < (kvh + 1) * p.g; ++hq) {
    const int step = hq - kvh * p.g;  // its parity: the partials' set
    const long long bh = static_cast<long long>(b) * p.h + hq;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                             b * p.q_sb + hq * p.q_sh + q0 * p.q_ss;
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                                b * p.do_sb + hq * p.do_sh + q0 * p.do_ss;
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) +
                             b * p.o_sb + hq * p.o_sh + q0 * p.o_ss;
    // the stages of the head before (Q, dO, lse, D) were last read before
    // the CTA barrier of its step
    tc::load_narrow<HD, HDP, THREADS>(qs, q, p.q_ss, p.sq - q0, B64, tid);
    tc::load_narrow<HDV, HDVP, THREADS>(dos, dout, p.do_ss, p.sq - q0, B64,
                                        tid);
    tc::cp_async_commit();
    if (tid < 2 * B64) {  // lse and D of the tile's rows: two lanes a row
      const int r = tid / 2, c = tid % 2;
      const bool live = q0 + r < p.sq;
      float s = 0.f;
      if (live) {
        const uint4 a =
            *reinterpret_cast<const uint4*>(o + r * p.o_ss + 8 * c);
        const uint4 e =
            *reinterpret_cast<const uint4*>(dout + r * p.do_ss + 8 * c);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = bf16x2(aw[i]), y = bf16x2(ew[i]);
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (c == 0) {
        d_s[r] = s;
        lse_s[r] = live ? p.lse[bh * p.sq + q0 + r] : 0.f;
      }
    }
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();

    // Two halves of the tile's 64 queries, one after the other (32 score
    // floats a thread live, not 64): S^T = K.Q^T over hd and dP^T =
    // V.dO^T over hdv (m64n32k16; k16 steps 32 bytes apart in a row, 8-row
    // groups 16 W bytes apart), P^T and dS^T in registers, then P^T and
    // dS^T (hi, lo) into this warpgroup's tiles as bf16 pairs: elements 8
    // kk + 2 j and + 1 of half h are row krow + 8 (j & 1), columns
    // (queries) 32 h + 16 kk + 8 (j >> 1) + 2 t4 and + 1
    const bool edge = edge_tile(p, q0, k0);
    auto put = [&](uint32_t tile, int kk, int j, uint32_t word) {
      *reinterpret_cast<uint32_t*>(
          smem + (tile - s0) +
          tc::swizzled<128>(krow + 8 * (j & 1), 2 * kk + (j >> 1)) + 4 * t4) =
          word;
    };
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        tc::wgmma_ss_n32(
            s, tc::desc_row<2 * HDP>(kst + kk * 32, 16, 16 * HDP),
            tc::desc_row<2 * HDP>(qs + h * 64 * HDP + kk * 32, 16, 16 * HDP),
            kk > 0);
#pragma unroll
      for (int kk = 0; kk < HDVP / 16; ++kk)
        tc::wgmma_ss_n32(
            dp, tc::desc_row<2 * HDVP>(vst + kk * 32, 16, 16 * HDVP),
            tc::desc_row<2 * HDVP>(dos + h * 64 * HDVP + kk * 32, 16,
                                   16 * HDVP),
            kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s);
      tc::fence_regs(dp);
      // the query (of the tile) in S^T's column of element i
      auto col = [&](int i) {
        return 32 * h + 2 * t4 + 8 * (i / 4) + (i & 1);
      };
      probs(s, [&](int i) { return lse_s[col(i)] * LOG2E; },
            edge ? valid_bits<true, 16>(p, k0 + krow, q0 + 32 * h + 2 * t4)
                 : 0xFFFFu,
            sl2);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          put(pts, 2 * h + kk, j,
              tc::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]));
      dscores(s, dp, [&](int i) { return d_s[col(i)]; });
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = dp[8 * kk + 2 * j], y = dp[8 * kk + 2 * j + 1];
          const uint32_t hi = tc::pack_bf16(x, y);
          const float2 hf = bf16x2(hi);
          put(pts + ST, 2 * h + kk, j, hi);
          put(pts + 2 * ST, 2 * h + kk, j,
              tc::pack_bf16(x - hf.x, y - hf.y));
        }
    }
    tc::fence_async_smem();
    warpgroup_sync(wg);  // the warpgroup's P^T and dS^T are all in
    // A from those tiles (16 queries a k-step: K-major, 32 bytes apart; 16
    // keys a k-step: MN-major, 2,048 bytes apart), B the 16 rows of a
    // k-step of dO, Q or K, MN-major:
    //   dV += P^T.dO, dK += dS^T.Q (hi + lo), dQ's partial over this key
    //   tile = dS.K (hi + lo)
    float dq[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) dq[j] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_ss_n16_bmn<0>(
          dv, tc::desc_row<128>(pts + kk * 32, 16, 1024),
          tc::desc_row<2 * HDVP>(dos + kk * 32 * HDVP, VT, 16 * HDVP), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::wgmma_ss_n32_bmn<0>(
          dk,
          tc::desc_row<128>(pts + (1 + kk / 4) * ST + (kk % 4) * 32, 16,
                            1024),
          tc::desc_row<2 * HDP>(qs + (kk % 4) * 32 * HDP, KT, 16 * HDP), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::wgmma_ss_n32_bmn<1>(
          dq,
          tc::desc_row<128>(pts + (1 + kk / 4) * ST + (kk % 4) * 2048, ST,
                            1024),
          tc::desc_row<2 * HDP>(kst + (kk % 4) * 32 * HDP, KT, 16 * HDP),
          kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();  // dV, dK and dQ's partial
    tc::fence_regs(dq);
    tc::fence_regs(dk);
    tc::fence_regs(dv);
    float* mine = part + ((step & 1) * WG + wg) * NQ * 128 + t;
#pragma unroll
    for (int j = 0; j < NQ; ++j) mine[j * 128] = dq[j];
    __syncthreads();
    // dQ of the tile: warpgroup w sums fragment elements [4 w, 4 w + 4)
    // (columns 8 w + 2 t4 and + 1 of rows krow, krow + 8) over the WG
    // partials in warpgroup order
    if (8 * wg < HD) {
      const float* set = part + (step & 1) * WG * NQ * 128 + t;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < WG; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] += set[(w * NQ + 4 * wg + e) * 128];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + krow + 8 * r;
        if (row < p.sq)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
              hq * p.dq_sh + row * p.dq_ss + 8 * wg + 2 * t4) =
              __floats2bfloat162_rn(x[2 * r] * p.scale,
                                    x[2 * r + 1] * p.scale);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy may outlive the CTA

  // dK and dV: warpgroup w pushes its key tile's partial (over this
  // CTA's queries and the heads) into the shared memory of CTA w, the
  // tile's owner, element j of thread t at kv[(qt (NQ + NV) + j) 128 + t]
  // (remote stores: no load waits on the cluster); then CTA r's warpgroup
  // r sums key tile r's four partials in rank order.  (Reading the
  // partials remotely instead cost 0.0010 ms of the kernel's 0.0113,
  // tools/ablate_flash_narrow.py.)
  float* kv = part;
  cluster.sync();  // every CTA is past its dQ sums: the sets are free
  {
    float* dst = cluster.map_shared_rank(kv, wg) + qt * (NQ + NV) * 128 + t;
#pragma unroll
    for (int j = 0; j < NQ; ++j) dst[j * 128] = dk[j];
#pragma unroll
    for (int j = 0; j < NV; ++j) dst[(NQ + j) * 128] = dv[j];
  }
  cluster.sync();  // every push has landed
  if (wg == qt) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) dk[j] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) dv[j] = 0.f;
#pragma unroll
    for (int c = 0; c < WG; ++c) {
      const float* rp = kv + c * (NQ + NV) * 128 + t;
#pragma unroll
      for (int j = 0; j < NQ; ++j) dk[j] += rp[j * 128];
#pragma unroll
      for (int j = 0; j < NV; ++j) dv[j] += rp[(NQ + j) * 128];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + krow + 8 * r;
      if (row >= p.sk) continue;
      put_row<HD>(dk, r, p.scale,
                  static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                      kvh * p.dk_sh + row * p.dk_ss + 2 * t4,
                  nullptr);
      put_row<HDV>(dv, r, 1.f,
                   static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                       kvh * p.dv_sh + row * p.dv_ss + 2 * t4,
                   nullptr);
    }
  }
}

template <int HD, int HDV>
cudaError_t launch(const bwd::Params& p, int batch, cudaStream_t stream) {
  if (p.sq > MAX_LEN || p.sk > MAX_LEN) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<HD, HDV>();
  auto kernel = fa_bwd_narrow_tc_kernel<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // a cluster of WG CTAs (__cluster_dims__) per (b, kv head)
  kernel<<<batch * (p.h / p.g) * WG, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace narrow

template <int HD, int HDV>
cudaError_t launch(const bwd::Params& p, int batch, float* dk_part,
                   float* dv_part, bool one_grid, cudaStream_t stream) {
  // one grid: one warpgroup a CTA and no GQA partials to reduce
  if (one_grid && (warpgroups<HD>() != 1 || p.g != 1))
    return cudaErrorInvalidValue;
  const int nq = (p.sq + B64 - 1) / B64, nk = (p.sk + B64 - 1) / B64;
  fa_bwd_preprocess_tc_kernel<HDV>
      <<<dim3(nq, batch * p.h), RED_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_bytes<HD, HDV>();
  constexpr int dq_bytes = smem_bytes<HD, HDV>(1);
  if constexpr (warpgroups<HD>() == 1) {
    if (one_grid) {  // y below nk a dK / dV CTA, else a dQ CTA
      constexpr int bytes = dkdv_bytes > dq_bytes ? dkdv_bytes : dq_bytes;
      auto both = fa_bwd_dkdv_dq_tc_kernel<HD, HDV>;
      err = cudaFuncSetAttribute(
          both, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      both<<<dim3(batch * p.h, nk + nq), THREADS, bytes, stream>>>(p);
      return cudaGetLastError();
    }
  }

  auto dkdv = fa_bwd_dkdv_tc_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(batch * p.h, nk), THREADS * warpgroups<HD>(), dkdv_bytes,
         stream>>>(p, p.g > 1 ? dk_part : nullptr,
                   p.g > 1 ? dv_part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (p.g > 1) {
    err = bwd::launch_reduce<__nv_bfloat16>(p, batch, HD, HDV, dk_part,
                                            dv_part, stream);
    if (err != cudaSuccess) return err;
  }

  auto dqk = fa_bwd_dq_tc_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(batch * p.h, nq), THREADS * warpgroups<HD>(), dq_bytes,
        stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const bwd::Params& p, int hd, int hdv, int batch,
                     float* dk_part, float* dv_part, bool one_grid,
                     cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(16, 16):
      return launch<16, 16>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(24, 16):
      return launch<24, 16>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(32, 32):
      return launch<32, 32>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(64, 64):
      return launch<64, 64>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(128, 128):
      return launch<128, 128>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(192, 128):
      return launch<192, 128>(p, batch, dk_part, dv_part, one_grid, stream);
    case pair(256, 256):
      return launch<256, 256>(p, batch, dk_part, dv_part, one_grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_narrow(const bwd::Params& p, int hd, int hdv, int batch,
                            cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(24, 16): return narrow::launch<24, 16>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd_tc

// ------------------------------------------ float32 route on the tensor
// cores ("tf32x3"): `fa_backward_tf32`, the gradient of the forward's
// flash_attention_tf32_kernel at the bfloat16 route's pairs, its products
// on the tensor cores as split TF32 (flash_attention_common.cuh: three
// TF32 wgmma a product, summed in float32).  The same four steps as the
// other routes: D = rowsum(dO o) (the FMA route's preprocess kernel: it
// reads two float32 rows a query and is bound by bytes), dK / dV per
// (query head, key tile) into float32 partials where H > Hkv, their sum
// in head order (fa_bwd_gqa_reduce_kernel), dQ per query tile.  Every
// output element is written by one CTA in a fixed order, so two runs
// give the same bits.
//
// 32-bit wgmma operands have no transpose bit: A (registers or shared
// memory) and B (shared memory) are both K-major.  So each product takes
// the operand that the product reads transposed as A, from registers:
// fragments loaded from shared memory with any addressing and split
// there, and as B only what is stored K-major:
//   S   = Q.K^T       M 64 queries, N BN keys, K hd:   A = Q rows, B = K
//   dP  = dO.V^T      M 64 queries, N BN keys, K hdv:  A = dO rows, B = V
//   dV^T += dO^T.P    M hdv, N BN keys, K 64 queries:  A = dO read by
//                     columns, B = P^T (keys x queries, written there)
//   dK^T += Q^T.dS    M hd, the same:                  A = Q by columns,
//                     B = dS^T
//   dQ^T += K^T.dS^T  M hd, N 64 queries, K BN keys:   A = K by columns,
//                     B = dS (queries x keys, written there)
// with P = exp(scale S - lse) on the attended pairs (a select: the lse of
// a fully masked row is about -1e30), dS = P (dP - D); dK and dQ take the
// scale at the store.  M below 64 (hd or hdv 16, 24, 32) is padded with
// zero fragments.  Q and dO are stored as plain rows of pitch width + 4
// floats (row fragments conflict-free, column fragments at most two-way);
// K, V, P^T, dS^T and dS as K-major tiles in the 128-byte swizzle, split
// in shared memory (hi in place, lo beside it) after the tile lands; K^T's
// fragments for dQ read both parts as they stand.
//
// Accuracy.  The tensor cores truncate each wgmma's float32 sum toward
// zero, so a running sum drifts by up to an ulp of itself a wgmma.  So
// dK^T, dV^T and dQ^T take each tile's product in a fresh accumulator and
// add it to the running sum in float32 (rounded to nearest), and dP sums
// its k-steps so (gemm_tf32x3_rn): dS = P (dP - D) takes dP against D, a
// float32 sum, and where a row attends few keys dP - D is that drift
// alone.  S is summed so too, as the forward sums it, in the dK / dV
// kernel but at (192, 128), which spilled so; there and in the dQ kernel,
// whose dQ^T accumulators leave no registers for it past hd 128, on the
// tensor cores (exp(scale S - lse) then meets the forward's lse to about
// 1e-6 of P).  With both, the errors against the plain version are the
// FMA route's (chip_smoke.py's kernels phase, an H100 80GB HBM3 at 700 W).
//
// fa_bwd_dkdv_tf32_kernel: one warpgroup a (b, query head, BN-key tile),
// walking the query tiles the mask lets reach its keys; dK^T and dV^T
// stay in registers ((hd + hdv) / 64 blocks of BN / 2 floats a thread).
// Its loads overlap: dO of the next query tile streams in during dK^T,
// Q during the next dP.  fa_bwd_dq_tf32_kernel: one warpgroup a (b,
// head, 64-query tile), the q tiles longest reach first, walking the key
// tiles of the forward's reach; dQ^T in registers (hd / 64 blocks of 32
// floats, at (256, 256) each block's product in two halves of 32 queries
// for the registers); V_{j+1} streams in during S_j, dS_j and dQ_j,
// K_{j+1} during dP_{j+1}.  BN is 32 keys, 16 at (256, 256) so that the
// tiles fit: K, V and their lo parts 2 BN (hd + hdv) floats, Q and dO 64
// (hd + hdv + 8), the four P^T / dS^T tiles 4 x 64 BN (dS, dS lo: 2 x 64
// x 32), the query tile's lse and D 2 x 64 (in shared memory, for the
// registers), 1,024 bytes of slack: 200,192 and 183,808 bytes at (192,
// 128), 216,576 either at (256, 256), 167,424 and 151,040 at (128, 128):
// one CTA an SM.
//
// What bounds it: five products, 2 (3 hd + 2 hdv) FLOP a live pair, each
// as three TF32 products at 495 TFLOP/s; this route does seven (S and dP
// in both kernels), from L2 the q tiles once a key tile (dK / dV) and the
// key tiles once a q tile (dQ).

namespace bwd_tf32 {

using namespace tc;
using bwd::Params;

constexpr int BQ = 64;        // queries: the M of S and dP
constexpr int THREADS = 128;  // one warpgroup

// keys a tile: the N of S and dP, the keys of a dK / dV CTA
template <int HD, int HDV>
__host__ __device__ constexpr int bn() {
  return HD + HDV > 384 ? 16 : 32;
}

template <int W>
__host__ __device__ constexpr int w32() {
  return (W + 31) / 32 * 32;
}

// blocks of 64 rows of a product whose M is W (hd or hdv)
template <int W>
__host__ __device__ constexpr int mblocks() {
  return (W + 63) / 64;
}

template <int HD, int HDV>
__host__ __device__ constexpr int kv_bytes() {  // K, V and their lo parts
  return 2 * bn<HD, HDV>() * (w32<HD>() + w32<HDV>()) * 4;
}

template <int HD, int HDV>
__host__ __device__ constexpr int rows_bytes() {  // Q and dO rows
  return BQ * (HD + 4 + HDV + 4) * 4;
}

template <int HD, int HDV>
__host__ __device__ constexpr int dkdv_smem_bytes() {  // + P^T, dS^T, lo,
  return kv_bytes<HD, HDV>() + rows_bytes<HD, HDV>() +   // lse, D
         4 * bn<HD, HDV>() * BQ * 4 + 2 * BQ * 4 + 1024;
}

template <int HD, int HDV>
__host__ __device__ constexpr int dq_smem_bytes() {  // + dS, dS lo, lse, D
  return kv_bytes<HD, HDV>() + rows_bytes<HD, HDV>() + 2 * BQ * 128 +
         2 * BQ * 4 + 1024;
}

// A fragments of a row tile (pitch P floats) read by rows: a points at
// this thread's a0 (row 16 w + g, column t4)
template <int P>
struct RowFrag {
  const float* a;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) const {
    const float x[4] = {a[8 * kk], a[8 * P + 8 * kk], a[8 * kk + 4],
                        a[8 * P + 8 * kk + 4]};
    tf32_split(x, hi, lo);
  }
};

// A fragments of a row tile (pitch P floats, W columns) read by columns,
// M the tile's columns from d0 = 64 mb + 16 w + g: a points at row t4,
// column d0; columns past W are zeros
template <int P, int W>
struct ColFrag {
  const float* a;
  int d0;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) const {
    const float* r = a + 8 * kk * P;
    const float x[4] = {d0 < W ? r[0] : 0.f, d0 + 8 < W ? r[8] : 0.f,
                        d0 < W ? r[4 * P] : 0.f,
                        d0 + 8 < W ? r[4 * P + 8] : 0.f};
    tf32_split(x, hi, lo);
  }
};

// A fragments of a swizzled K-major tile of R rows (keys) and W columns
// already split (the tile holds hi, `lo` the lo part at the same offsets)
// read by columns (K^T): rows 8 kk + t4 (+ 4), columns d0 (+ 8) of block
// m, from four byte offsets of block 0, step 0 (the swizzle's XOR term
// is the same at every step and block); columns past W are zeros
template <int R, int W>
struct SwzColFrag {
  const unsigned char* t;
  const unsigned char* lo;
  uint32_t at[4];
  int d0;
  __device__ __forceinline__ SwzColFrag(const unsigned char* t_,
                                        const unsigned char* lo_, int t4,
                                        int c0, int m)
      : t(t_ + m * 2 * R * 128), lo(lo_ + m * 2 * R * 128), d0(64 * m + c0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) at[i] = swz_f32(t4 + 4 * (i / 2), c0 + 8 * (i % 2), R);
  }
  __device__ __forceinline__ void operator()(int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo_)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = d0 + 8 * (i % 2) < W;
      const uint32_t o = at[i] + kk * 8 * 128;
      hi[i] = ok ? *reinterpret_cast<const uint32_t*>(t + o) : 0u;
      lo_[i] = ok ? *reinterpret_cast<const uint32_t*>(lo + o) : 0u;
    }
  }
};


template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_tf32_kernel(const Params p, float* dk_part, float* dv_part) {
  constexpr int BN = bn<HD, HDV>();
  constexpr int KB = BN * w32<HD>() * 4, VB = BN * w32<HDV>() * 4;
  constexpr int PB = BN * BQ * 4;  // a P^T or dS^T tile
  constexpr int QP = HD + 4, OP = HDV + 4;
  constexpr int MK = mblocks<HD>(), MV = mblocks<HDV>();
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_u32(f32_smem);
  const uint32_t ks = (raw + 1023u) & ~1023u, ks_lo = ks + KB;
  const uint32_t vs = ks_lo + KB, vs_lo = vs + VB;
  const uint32_t pt = vs_lo + VB, pt_lo = pt + PB;
  const uint32_t dst = pt_lo + PB, dst_lo = dst + PB;
  const uint32_t qs = dst_lo + PB, dos = qs + BQ * QP * 4;
  unsigned char* sm = f32_smem + (ks - raw);  // generic, at ks
  const float* q_sm = reinterpret_cast<const float*>(sm + (qs - ks));
  const float* do_sm = reinterpret_cast<const float*>(sm + (dos - ks));
  // the query tile's lse and D (in shared memory, not registers: past hd
  // 128 the kernel leaves none)
  float* lse_sm = const_cast<float*>(do_sm) + BQ * OP;
  float* d_sm = lse_sm + BQ;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, wrow = warp * 16;
  const int k0 = blockIdx.y * BN;
  const long long bh = blockIdx.x;
  const int b = blockIdx.x / p.h, head = blockIdx.x % p.h;
  const int kvh = head / p.g;
  const int keys = min(BN, p.sk - k0);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb +
                   kvh * p.k_sh + k0 * p.k_ss;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb +
                   kvh * p.v_sh + k0 * p.v_ss;
  const float* q =
      static_cast<const float*>(p.q) + b * p.q_sb + head * p.q_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + head * p.do_sh;

  // the query tiles whose mask reaches keys [k0, k0 + keys)
  const int nq = (p.sq + BQ - 1) / BQ;
  const int qt_lo = p.causal ? min(nq, k0 / BQ) : 0;
  int qt_hi = nq;
  if (p.window > 0) qt_hi = min(nq, (k0 + keys - 1 + p.window - 1) / BQ + 1);

  // three commit groups: K and V, dO, Q; then one dO and one Q a tile
  load_tile_f32<HD, THREADS>(ks, k, p.k_ss, keys, BN, tid);
  load_tile_f32<HDV, THREADS>(vs, v, p.v_ss, keys, BN, tid);
  cp_async_commit();
  if (qt_lo < qt_hi) {
    const int q0 = qt_lo * BQ;
    load_rows_f32<HDV, THREADS>(dos, dout + q0 * p.do_ss, p.do_ss,
                                p.sq - q0, tid);
    cp_async_commit();
    load_rows_f32<HD, THREADS>(qs, q + q0 * p.q_ss, p.q_ss, p.sq - q0, tid);
  } else {
    cp_async_commit();
  }
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
  tile_split<THREADS>(reinterpret_cast<float*>(sm),
                      reinterpret_cast<float*>(sm + (ks_lo - ks)), KB, tid);
  tile_split<THREADS>(reinterpret_cast<float*>(sm + (vs - ks)),
                      reinterpret_cast<float*>(sm + (vs_lo - ks)), VB, tid);
  fence_async_smem();

  float dk[MK][BN / 2], dv[MV][BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
#pragma unroll
    for (int m = 0; m < MK; ++m) dk[m][i] = 0.f;
#pragma unroll
    for (int m = 0; m < MV; ++m) dv[m][i] = 0.f;
  }
  const RowFrag<QP> q_rows{q_sm + (wrow + g) * QP + t4};
  const RowFrag<OP> do_rows{do_sm + (wrow + g) * OP + t4};

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ, rows = min(BQ, p.sq - q0);
    if (tid < BQ) {  // the last tile's were read before its last barrier
      lse_sm[tid] = tid < rows ? p.lse[bh * p.sq + q0 + tid] : 0.f;
      d_sm[tid] = tid < rows ? p.delta[bh * p.sq + q0 + tid] : 0.f;
    }
    cp_async_wait<1>();  // dO of this tile (Q may still stream)
    __syncthreads();
    float s[BN / 2], dp[BN / 2];
    gemm_tf32x3_rn<BN, HDV / 8>(dp, do_rows, vs, vs_lo, Steps<BN>{});
    cp_async_wait<0>();  // Q
    __syncthreads();
    if constexpr (HD == 192)  // no registers for two steps in flight
      gemm_tf32x3<BN, HD / 8>(s, q_rows, ks, ks_lo, Steps<BN>{}, false);
    else
      gemm_tf32x3_rn<BN, HD / 8>(s, q_rows, ks, ks_lo, Steps<BN>{});

    // P and dS (rows: queries, columns: keys), stored transposed with
    // their lo parts: element (query c, key r) of a [2][BN][128 B] tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = wrow + g + 8 * ((i % 4) / 2);
      const int key = 8 * (i / 4) + 2 * t4 + (i & 1);
      const bool ok = row < rows && bwd::attends(p, q0 + row, k0 + key);
      const float pe = ok ? expf(s[i] * p.scale - lse_sm[row]) : 0.f;
      const float ds = pe * (dp[i] - d_sm[row]);
      const uint32_t at = swz_f32(key, row, BN);
      store_split(sm + (pt - ks), sm + (pt_lo - ks), at, pe);
      store_split(sm + (dst - ks), sm + (dst_lo - ks), at, ds);
    }
    fence_async_smem();
    __syncthreads();

    // each block into a fresh accumulator, added to dV^T / dK^T in
    // float32 (rounded to nearest): the tensor cores truncate each
    // wgmma's sum, and a running sum would drift by up to an ulp a wgmma
    // over the query range
#pragma unroll
    for (int m = 0; m < MV; ++m) {
      float t[BN / 2];
      gemm_tf32x3<BN, BQ / 8>(
          t, ColFrag<OP, HDV>{do_sm + t4 * OP + 64 * m + wrow + g,
                              64 * m + wrow + g},
          pt, pt_lo, Steps<BN>{}, false);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dv[m][i] += t[i];
    }
    __syncthreads();  // dO is read: the next tile's may stream in
    if (qt + 1 < qt_hi)
      load_rows_f32<HDV, THREADS>(dos, dout + (q0 + BQ) * p.do_ss, p.do_ss,
                                  p.sq - q0 - BQ, tid);
    cp_async_commit();
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      float t[BN / 2];
      gemm_tf32x3<BN, BQ / 8>(
          t, ColFrag<QP, HD>{q_sm + t4 * QP + 64 * m + wrow + g,
                             64 * m + wrow + g},
          dst, dst_lo, Steps<BN>{}, false);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dk[m][i] += t[i];
    }
    __syncthreads();  // Q, P^T and dS^T are read
    if (qt + 1 < qt_hi)
      load_rows_f32<HD, THREADS>(qs, q + (q0 + BQ) * p.q_ss, p.q_ss,
                                 p.sq - q0 - BQ, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // dK^T and dV^T fragments: row (column of dK, dV) 64 m + 16 w + g + 8
  // (e / 2), column (key) 8 j + 2 t4 + (e & 1) of element 4 j + e
  const long long part_row =
      (static_cast<long long>(b) * p.sk + k0) * p.h + head;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int key = 8 * (i / 4) + 2 * t4 + (i & 1);
    if (key >= keys) continue;
    const int dr = wrow + g + 8 * ((i % 4) / 2);
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      const int d = 64 * m + dr;
      if (d >= HD) continue;
      const float x = dk[m][i] * p.scale;
      if (dk_part != nullptr)
        dk_part[(part_row + static_cast<long long>(key) * p.h) * HD + d] = x;
      else
        static_cast<float*>(p.dk)[b * p.dk_sb + (k0 + key) * p.dk_ss +
                                  kvh * p.dk_sh + d] = x;
    }
#pragma unroll
    for (int m = 0; m < MV; ++m) {
      const int d = 64 * m + dr;
      if (d >= HDV) continue;
      if (dv_part != nullptr)
        dv_part[(part_row + static_cast<long long>(key) * p.h) * HDV + d] =
            dv[m][i];
      else
        static_cast<float*>(p.dv)[b * p.dv_sb + (k0 + key) * p.dv_ss +
                                  kvh * p.dv_sh + d] = dv[m][i];
    }
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_tf32_kernel(const Params p) {
  constexpr int BN = bn<HD, HDV>();
  constexpr int KB = BN * w32<HD>() * 4, VB = BN * w32<HDV>() * 4;
  constexpr int DB = BQ * 128;  // dS: 64 query rows of up to 32 keys
  constexpr int QP = HD + 4, OP = HDV + 4;
  constexpr int MK = mblocks<HD>();
  constexpr int NQ = HD > 192 ? 32 : 64;  // dQ^T's N a wgmma
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_u32(f32_smem);
  const uint32_t ks = (raw + 1023u) & ~1023u, ks_lo = ks + KB;
  const uint32_t vs = ks_lo + KB, vs_lo = vs + VB;
  const uint32_t ds = vs_lo + VB, ds_lo = ds + DB;
  const uint32_t qs = ds_lo + DB, dos = qs + BQ * QP * 4;
  unsigned char* sm = f32_smem + (ks - raw);
  const float* q_sm = reinterpret_cast<const float*>(sm + (qs - ks));
  const float* do_sm = reinterpret_cast<const float*>(sm + (dos - ks));
  // the tile's lse and D (in shared memory, not registers: the dQ^T
  // accumulators past hd 128 leave none)
  float* lse_sm = const_cast<float*>(do_sm) + BQ * OP;
  float* d_sm = lse_sm + BQ;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, wrow = warp * 16;
  const int nq = (p.sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const long long bh = blockIdx.x;
  const int b = blockIdx.x / p.h, head = blockIdx.x % p.h;
  const int kvh = head / p.g;
  const int rows = min(BQ, p.sq - q0);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb +
                   head * p.q_sh + q0 * p.q_ss;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb +
                      head * p.do_sh + q0 * p.do_ss;
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the key tiles this query tile reaches (the forward's loop bounds)
  const int nk = (p.sk + BN - 1) / BN;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + rows + BN - 1) / BN);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    lo = first > 0 ? first / BN : 0;
  }

  // three commit groups: Q and dO, V, K; then one V and one K a tile
  load_rows_f32<HD, THREADS>(qs, q, p.q_ss, rows, tid);
  load_rows_f32<HDV, THREADS>(dos, dout, p.do_ss, rows, tid);
  cp_async_commit();
  if (lo < hi)
    load_tile_f32<HDV, THREADS>(vs, v + lo * BN * p.v_ss, p.v_ss,
                                p.sk - lo * BN, BN, tid);
  cp_async_commit();
  if (lo < hi)
    load_tile_f32<HD, THREADS>(ks, k + lo * BN * p.k_ss, p.k_ss,
                               p.sk - lo * BN, BN, tid);
  cp_async_commit();

  if (tid < BQ) {
    lse_sm[tid] = tid < rows ? p.lse[bh * p.sq + q0 + tid] : 0.f;
    d_sm[tid] = tid < rows ? p.delta[bh * p.sq + q0 + tid] : 0.f;
  }
  float dq[MK][BQ / 2];
#pragma unroll
  for (int m = 0; m < MK; ++m)
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dq[m][i] = 0.f;
  const RowFrag<QP> q_rows{q_sm + (wrow + g) * QP + t4};
  const RowFrag<OP> do_rows{do_sm + (wrow + g) * OP + t4};

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BN;
    cp_async_wait<1>();  // V of this tile (and Q, dO); K may still stream
    __syncthreads();
    tile_split<THREADS>(reinterpret_cast<float*>(sm + (vs - ks)),
                        reinterpret_cast<float*>(sm + (vs_lo - ks)), VB, tid);
    fence_async_smem();
    __syncthreads();
    float s[BN / 2], dp[BN / 2];
    gemm_tf32x3_rn<BN, HDV / 8>(dp, do_rows, vs, vs_lo, Steps<BN>{});
    __syncthreads();  // V is read: the next tile's may stream in
    if (kt + 1 < hi)
      load_tile_f32<HDV, THREADS>(vs, v + (k0 + BN) * p.v_ss, p.v_ss,
                                  p.sk - k0 - BN, BN, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K of this tile
    __syncthreads();
    tile_split<THREADS>(reinterpret_cast<float*>(sm),
                        reinterpret_cast<float*>(sm + (ks_lo - ks)), KB, tid);
    fence_async_smem();
    __syncthreads();
    gemm_tf32x3<BN, HD / 8>(s, q_rows, ks, ks_lo, Steps<BN>{}, false);

    // dS (rows: queries, columns: the tile's keys) with its lo part
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = wrow + g + 8 * ((i % 4) / 2);
      const int key = 8 * (i / 4) + 2 * t4 + (i & 1);
      const bool ok = row < rows && bwd::attends(p, q0 + row, k0 + key);
      const float pe = ok ? expf(s[i] * p.scale - lse_sm[row]) : 0.f;
      const float x = pe * (dp[i] - d_sm[row]);
      store_split(sm + (ds - ks), sm + (ds_lo - ks), swz_f32(row, key, BQ),
                  x);
    }
    fence_async_smem();
    __syncthreads();
    // each block into a fresh accumulator, added to dQ^T in float32
    // (rounded to nearest), as dK^T and dV^T are; at (256, 256) a block's
    // 64 queries in two halves (NQ 32): with one product of 64 it spills
#pragma unroll
    for (int m = 0; m < MK; ++m)
#pragma unroll
      for (int nh = 0; nh < BQ / NQ; ++nh) {
        float t[NQ / 2];
        gemm_tf32x3<NQ, BN / 8>(
            t, SwzColFrag<BN, HD>(sm, sm + (ks_lo - ks), t4, wrow + g, m),
            ds + nh * NQ * 128, ds_lo + nh * NQ * 128, Steps<BQ>{}, false);
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) dq[m][nh * NQ / 2 + i] += t[i];
      }
    __syncthreads();  // K and dS are read
    if (kt + 1 < hi)
      load_tile_f32<HD, THREADS>(ks, k + (k0 + BN) * p.k_ss, p.k_ss,
                                 p.sk - k0 - BN, BN, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // dQ^T fragments: row (column of dQ) 64 m + 16 w + g + 8 (e / 2),
  // column (query) 8 j + 2 t4 + (e & 1) of element 4 j + e
  float* dqp = static_cast<float*>(p.dq) + b * p.dq_sb + head * p.dq_sh +
               q0 * p.dq_ss;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) {
    const int row = 8 * (i / 4) + 2 * t4 + (i & 1);
    if (row >= rows) continue;
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      const int d = 64 * m + wrow + g + 8 * ((i % 4) / 2);
      if (d < HD) dqp[row * p.dq_ss + d] = dq[m][i] * p.scale;
    }
  }
}

template <int HD, int HDV>
cudaError_t launch(const Params& p, int batch, float* dk_part,
                   float* dv_part, cudaStream_t stream) {
  constexpr int BN = bn<HD, HDV>();
  bwd::fa_bwd_preprocess_kernel<float>
      <<<dim3((p.sq + BQ - 1) / BQ, batch * p.h), bwd::THREADS, 0, stream>>>(
          p, HDV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_bytes<HD, HDV>();
  auto dkdv = fa_bwd_dkdv_tf32_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(batch * p.h, (p.sk + BN - 1) / BN), THREADS, dkdv_bytes,
         stream>>>(p, p.g > 1 ? dk_part : nullptr,
                   p.g > 1 ? dv_part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.g > 1) {
    err = bwd::launch_reduce<float>(p, batch, HD, HDV, dk_part, dv_part,
                                    stream);
    if (err != cudaSuccess) return err;
  }

  constexpr int dq_bytes = dq_smem_bytes<HD, HDV>();
  auto dqk = fa_bwd_dq_tf32_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(batch * p.h, (p.sq + BQ - 1) / BQ), THREADS, dq_bytes,
        stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int hd, int hdv, int batch,
                     float* dk_part, float* dv_part, cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(16, 16): return launch<16, 16>(p, batch, dk_part, dv_part, stream);
    case pair(24, 16): return launch<24, 16>(p, batch, dk_part, dv_part, stream);
    case pair(32, 32): return launch<32, 32>(p, batch, dk_part, dv_part, stream);
    case pair(64, 64): return launch<64, 64>(p, batch, dk_part, dv_part, stream);
    case pair(128, 128):
      return launch<128, 128>(p, batch, dk_part, dv_part, stream);
    case pair(192, 128):
      return launch<192, 128>(p, batch, dk_part, dv_part, stream);
    case pair(256, 256):
      return launch<256, 256>(p, batch, dk_part, dv_part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd_tf32

}  // namespace

extern "C" {

// The backward's parameters from the entry points' arguments (24 element
// strides: (b, s, h) of q, k, v, o, dO, dq, dk, dv in that order).
static cudaError_t make_bwd_params(
    bwd::Params& p, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, float* delta, void* dq,
    void* dk, void* dv, const long long* strides, int batch, int sq, int sk,
    int h, int hkv, int causal, int window, float scale) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  long long* fields[24] = {
      &p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
      &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh,
      &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss, &p.dq_sh,
      &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *fields[i] = strides[i];
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.g = h / hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return cudaSuccess;
}

// The FMA route's backward (float32, and bfloat16 with any pair): dq, dk,
// dv (in the operands' dtype, written whole) from dO, q, k, v, the
// forward's o and lse, through three kernels on `stream` (four where H >
// Hkv: the GQA reduction); delta is a float32 (B, H, Sq) scratch, dk_part
// and dv_part float32 (B, Sk, H, hd) and (B, Sk, H, hdv) scratches (null
// where H == Hkv).  hd: q, k, dq and dk's head dim; hdv: v, o, dO and
// dv's, a pair of bwd::dispatch.  strides: 24 element strides, (b, s, h)
// of q, k, v, o, dO, dq, dk, dv in that order; dk and dv contiguous.
// dtype: 0 float32, 1 bfloat16.  Returns the CUDA status of the launches
// (cudaErrorInvalidValue for a pair not built).
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, float* dk_part, float* dv_part,
                const long long* strides, int batch, int sq, int sk, int h,
                int hkv, int hd, int hdv, int causal, int window,
                float scale, int dtype, void* stream) {
  if (hkv > 0 && h != hkv && (dk_part == nullptr || dv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? bwd::dispatch<float>(p, hd, hdv, batch, dk_part, dv_part, s)
        : dtype == 1 ? bwd::dispatch<__nv_bfloat16>(p, hd, hdv, batch,
                                                    dk_part, dv_part, s)
                     : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Every operand of the tensor-core routes on a 16-byte boundary and every
// stride a multiple of 8 elements
static bool tc_aligned(const void* const (&ptrs)[8],
                       const long long* strides) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// The tensor-core route's backward: bfloat16, (hd, hdv) a pair of
// bwd_tc::dispatch; the same arguments as `fa_backward` without dtype,
// and one_grid.  Every pointer on a 16-byte boundary and every stride a
// multiple of 8 elements.  Four kernels: preprocess, dK/dV, the GQA
// reduction (H > Hkv), dQ; with one_grid nonzero (up to hd 128, h == hkv,
// else cudaErrorInvalidValue) two: preprocess, then the dK / dV and dQ
// CTAs in one grid (fa_bwd_dkdv_dq_tc_kernel).
int fa_backward_tc(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, float* dk_part,
                   float* dv_part, const long long* strides, int batch,
                   int sq, int sk, int h, int hkv, int hd, int hdv,
                   int causal, int window, float scale, int one_grid,
                   void* stream) {
  if (!tc_aligned({q, k, v, o, dout, dq, dk, dv}, strides))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (hkv > 0 && h != hkv && (dk_part == nullptr || dv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_tc::dispatch(p, hd, hdv, batch, dk_part, dv_part, one_grid != 0,
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The float32 route on the tensor cores (split TF32): float32, (hd, hdv)
// a pair of bwd_tf32::dispatch; the arguments of `fa_backward` without
// dtype.  Every pointer on a 16-byte boundary and every stride a multiple
// of 4 elements (16-byte cp.async), else cudaErrorMisalignedAddress.
// Four kernels: the FMA route's preprocess (D), dK / dV, the GQA
// reduction (H > Hkv), dQ.
int fa_backward_tf32(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv,
                     float* dk_part, float* dv_part,
                     const long long* strides, int batch, int sq, int sk,
                     int h, int hkv, int hd, int hdv, int causal, int window,
                     float scale, void* stream) {
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (hkv > 0 && h != hkv && (dk_part == nullptr || dv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_tf32::dispatch(p, hd, hdv, batch, dk_part, dv_part,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The tensor-core route's one-launch backward (fa_bwd_narrow_tc_kernel):
// the arguments of `fa_backward_tc` without its scratches (D is computed
// in the kernel; no partials), (hd, hdv) a pair of bwd_tc::dispatch_narrow
// and sq, sk at most bwd_tc::narrow::MAX_LEN (else cudaErrorInvalidValue).
int fa_backward_narrow(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv,
                       const long long* strides, int batch, int sq, int sk,
                       int h, int hkv, int hd, int hdv, int causal,
                       int window, float scale, void* stream) {
  if (!tc_aligned({q, k, v, o, dout, dq, dk, dv}, strides))
    return static_cast<int>(cudaErrorMisalignedAddress);
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, nullptr, dq,
                                    dk, dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_tc::dispatch_narrow(p, hd, hdv, batch,
                                static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
