// Flash attention for NVIDIA Hopper (sm_90a), plain C interface: two
// forward kernels and, at the end of this file, the backward's two routes
// (float32 FMAs: three kernels; tensor cores: four).
// The two forward kernels compute the same function; the wrapper
// (kernels/flash_attention.py, `_route`) picks one by dtype and head dim:
//
//   flash_attention_tc_kernel  bfloat16, (hd, hdv) in {(16, 16), (24, 16),
//                              (32, 32), (64, 64), (128, 128), (192, 128),
//                              (256, 256)}: products on the tensor cores,
//                              wgmma (`fa_forward_tc`)
//   flash_attention_kernel     float32 (those pairs and (8, 8)) and bfloat16
//                              with hd = 8: float32 FMAs (`fa_forward`)
//
// hd is the q.k head dim, hdv v's and the output's: they differ for
// DeepSeek-V2's multi-head latent attention (qk = nope 128 + rope 64 = 192,
// v 128; 24 / 16 in its smoke config); RecurrentGemma's local attention
// takes (256, 256), 16 query heads over one kv head.  Both kernels are
// templates over
// <HD, HDV>: the Q and K tiles are HD wide; the V tile, the O accumulator,
// the output store are HDV wide; m, l and lse are per query row.
//
// Both replace the Pallas TPU kernel `flash_attention_pallas` (`_fa_kernel`,
// src/repro/kernels/flash_attention.py:102) and compute what
// `repro.models.attention.flash_attention` computes (l. 92-196): a chunked
// online softmax over key tiles, GQA (kv head = q head / g, read in place),
// causal and sliding-window masks, `q_offset` for appended queries, and
// ragged Sq / Sk.  Numerics follow the reference: scores in float32 scaled
// by 1/sqrt(hd), masked scores -1e30, p = exp(s - m_new) * valid, output
// acc / max(l, 1e-30), so a fully masked row gives 0.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hdv), o
// (B, Sq, H, hdv), read
// and written through element strides (the last dimension has stride 1).
// No pad or transpose copy: the ragged q and k edges are masked here.
//
// What bounds both.  At the smoke's prefill shape, (B, Sq, Sk, H, Hkv, hd) =
// (1, 2048, 2048, 12, 2, 128) bf16 causal, the live causal half is about
// 12.9 GFLOP against about 15 MB of q, k, v and o: ~860 FLOP per byte, far
// above the card's ~295 bf16 FLOP per byte, so the bound is the tensor
// cores (13 us at 989 TFLOP/s).  At DeepSeek-V2-Lite's prefill, (1, 2048,
// 2048, 16, 16) with qk 192 / v 128, it is 2 H (S (S + 1) / 2)(192 + 128)
// = 21.5 GFLOP against about 42 MB (22 us against 12.5 us by bytes): the
// tensor cores again.  At RecurrentGemma-9B's 3,072-token prefill, (1,
// 3072, 3072, 16, 1) at (256, 256) with window 2,048, the ~4.2 M live
// pairs a head are 2 H pairs (256 + 256) = 69 GFLOP against about 53 MB
// of bf16 (70 us against 16 us by bytes): the tensor cores.
//
// flash_attention_kernel (the float32 route).  One CTA of 256 threads owns
// one (b, h, 64-row q tile) and loops over 64-key tiles itself (the TPU
// kernel's sequential k grid axis becomes this loop).  The loop runs from
// the window's first reachable tile to the causal reach of the q tile (the
// `lo`/`hi` of attention.py:164-172), so fully masked tiles are never
// visited: the tile skip is a loop bound, not a predicate.  Skipping them
// is exact: such a tile leaves m, l and acc unchanged.  Q, K and V tiles
// are staged in shared memory as float32 (K rows padded to hd + 1 against
// bank conflicts); the running max m and sum l live in shared memory, the
// accumulator in registers, all float32; `expf` is the accurate one.
// Scores and P.V are float32 FMAs, each beside a shared-memory load, on
// the 67 TFLOP/s CUDA cores: exact enough for the float32 tolerance
// (2e-5), far from the bound.  At (256, 256) the tiles take 214,272 bytes
// of shared memory (one CTA an SM, under the 232,448-byte opt-in) and the
// accumulator 4 x 16 floats a thread.
//
// flash_attention_tc_kernel (the bfloat16 route) is described above its
// definition below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* lse;                   // (B, H, Sq) row log-sum-exp, or null
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

template <int HD, int HDV>
constexpr int smem_floats() {
  return BQ * HD + BK * (HD + 1) + BK * HDV + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int KP = HD + 1;
  constexpr int PP = BK + 1;
  float* Qs = smem;                  // [BQ][HD]
  float* Ks = Qs + BQ * HD;          // [BK][KP]
  float* Vs = Ks + BK * KP;          // [BK][HDV]
  float* Ps = Vs + BK * HDV;         // [BQ][PP]  scores, then probabilities
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
  // P.V: thread (py, px) owns rows py*RPT + i and columns px + TX*j of
  // the HDV output columns (the scores' loop above runs over HD)
  constexpr int TX = HDV < 16 ? HDV : 16;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BQ / TY;
  constexpr int CPT = HDV / TX;
  static_assert(HDV % TX == 0 && BQ % TY == 0, "P.V thread layout");
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
      Ks[c * KP + d] =
          k0 + c < p.sk ? load_f32(k + (k0 + c) * p.k_ss + d) : 0.f;
    }
    for (int i = tid; i < BK * HDV; i += THREADS) {
      const int c = i / HDV, d = i % HDV;
      Vs[i] = k0 + c < p.sk ? load_f32(v + (k0 + c) * p.v_ss + d) : 0.f;
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
        const float vv = Vs[c * HDV + px + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // row_l is final

  // the backward's softmax statistic: m + log(l) per row (natural units)
  if (p.lse != nullptr)
    for (int r = tid; r < rows; r += THREADS)
      p.lse[static_cast<long long>(blockIdx.y) * p.sq + q0 + r] =
          row_m[r] + logf(fmaxf(row_l[r], 1e-30f));

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

template <typename T, int HD, int HDV>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int bytes =
      smem_floats<HD, HDV>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, batch_heads);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the (hd, hdv) pairs of the repo's configs: hd == hdv for the GQA
// families and RecurrentGemma's (256, 256), (192, 128) for
// DeepSeek-V2-Lite's MLA and (24, 16) for its smoke config
constexpr int pair(int hd, int hdv) { return hd * 1024 + hdv; }

template <typename T>
cudaError_t dispatch(const Params& p, int hd, int hdv, int batch_heads,
                     cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(8, 8): return launch<T, 8, 8>(p, batch_heads, stream);
    case pair(16, 16): return launch<T, 16, 16>(p, batch_heads, stream);
    case pair(24, 16): return launch<T, 24, 16>(p, batch_heads, stream);
    case pair(32, 32): return launch<T, 32, 32>(p, batch_heads, stream);
    case pair(64, 64): return launch<T, 64, 64>(p, batch_heads, stream);
    case pair(128, 128): return launch<T, 128, 128>(p, batch_heads, stream);
    case pair(192, 128): return launch<T, 192, 128>(p, batch_heads, stream);
    case pair(256, 256): return launch<T, 256, 256>(p, batch_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ tensor-core route (bf16)
// flash_attention_tc_kernel: the same function for bfloat16 operands with
// (hd, hdv) in {(16, 16), (24, 16), (32, 32), (64, 64), (128, 128),
// (192, 128), (256, 256)}, its products on the tensor cores.
//
// Design (a FlashAttention-3-style warpgroup kernel without the producer
// warp).  One CTA is one warpgroup of 4 warps and owns one (b, h, 64-row q
// tile); it loops over 64-key tiles.  Both products are Hopper warpgroup
// MMAs (`wgmma.mma_async`, bf16 inputs, float32 accumulators):
//   S = Q.K^T  m64n64k16, A = Q and B = K read by the tensor cores straight
//              from shared memory through matrix descriptors (both K-major);
//              hd / 16 k-steps (12 at hd 192);
//   O += P.V   m64nNk16 (N = hdv padded: 64 or 128), A = P from
//              registers — the S
//              accumulator fragment rounded to bf16 (as every tensor-core
//              flash kernel does), B = V from shared memory as an MN-major
//              operand (the transpose bit, which 16-bit types have).
// Shared tiles use the 128-byte swizzle that the descriptors name: a tile is
// [width / 64][64 rows][128 B], the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), each 8-row group a 1,024-byte-aligned atom, so the tensor
// cores read without bank conflicts.  Q and K tiles are hd wide, V tiles
// hdv wide.  A width below 64 (hd 16, 24, 32; hdv 16, 32) is padded to 64
// columns of zeros in shared memory (the copy zero-fills them), which
// leaves S and the kept columns of O unchanged.  At (192, 128) shared memory
// holds Q (24 KiB), two K stages (48 KiB) and two V stages (32 KiB): 105
// KiB, so two CTAs still share an SM.  Q and K stay in shared memory, so
// the accumulators are those of hd 128 (S's 32 floats a thread, O's 64):
// ptxas gives 236 registers at (192, 128), 196 at (128, 128), no spills.
// K and V tiles are
// double-buffered: 16-byte `cp.async.cg` copies of tile j + 1 run while
// tile j is multiplied (then `fence.proxy.async` makes them visible to the
// tensor cores); ragged q and k rows are zero-filled by the copy itself.
// The softmax stays in registers: each thread holds 2 rows x 16 scores of a
// tile, the row max and sum reduce over the 4 lanes of a quad with
// `__shfl_xor_sync`, scores are scaled by log2(e)/sqrt(hd) and exponentiated
// with `exp2f`, and the row sum l adds the unrounded p.  Masks are built,
// branch-free, only on tiles that hold a masked pair (the diagonal, the
// window's edge, the ragged last tile); per-element branches there cost
// more than the products.  The key loop is bounded to the causal / window
// reach as in the float32 kernel.  The grid runs (B * H, q tiles) with the q
// tiles in reverse order, so the longest causal tiles of every head start
// first and the short ones fill the tail.
//
// hdv 256 (RecurrentGemma).  One warpgroup cannot hold O at 256 columns:
// 128 floats a thread beside S's 32 and P's 16 pass the 255-register limit
// once addresses count ((192, 128) already takes 236).  So a CTA there is
// two warpgroups (256 threads) over the same 64 q rows: both run S = Q.K^T
// (16 k-steps) and the same register softmax on the same tile, so their m
// and l agree bit for bit; warpgroup w keeps O's columns [128 w, 128 w +
// 128) and runs P.V (m64n128k16) on V's descriptor advanced by two
// 64-column atoms (16 KiB) a warpgroup.  The 256 threads share the
// cp.async copies, warpgroup 0 writes lse and each warpgroup stores its
// half of O.  Each thread's accumulators stay those of (192, 128) (ptxas:
// 199 registers, no spill); shared memory holds Q (32 KiB), two K stages
// (64 KiB) and two V stages (64 KiB): 161 KiB, one CTA an SM.  The cost is S computed twice: 1.5 times the tensor work of one S
// and P.V, chosen over P through shared memory (a barrier between the
// warpgroups each tile) for a first kernel that is simple and right.
//
// What it gives up: the products and the softmax of one CTA run one after
// the other (two CTAs per SM overlap each other; no producer warp, no
// ping-pong of two warpgroups), the copies are cp.async rather than TMA,
// and every q tile re-reads its K and V tiles (GQA heads are not packed).
//
// Alignment: cp.async moves 16 bytes, so q, k, v and o must start on a
// 16-byte boundary and their b, s and h strides must be multiples of 8
// elements; the wrapper checks and raises, and `fa_forward_tc` refuses.

namespace tc {

constexpr int BQ = 64;              // q rows per CTA: one warpgroup
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy; wgmma reads through the async
// proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (between atoms along M/N of an MN-major operand; unused for
// K-major) and stride byte offset (between 8-row groups), all >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 64 f32) = A (64 x 16) . B^T (B 64 x 16), both K-major in shared
// memory (descriptors); scale_d = 0 overwrites d, 1 accumulates
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, MN-major
// in shared memory, descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) . B (16 x 128, MN-major
// in shared memory, descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Copy rows [0, n_valid) of a 64 x HD tile (row stride `ss` elements) into
// the swizzled shared tile at `dst`, [HDP / 64][64][128 B], with the NT
// threads of the CTA (one warpgroup unless named); rows past n_valid and
// columns past HD become zeros.
template <int HD, int HDP, int NT = THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int n_valid,
                                          int tid) {
  constexpr int C = HDP / 8;  // 16-byte chunks per row
  static_assert(64 * C % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < 64 * C / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid && c * 8 < HD;
    const __nv_bfloat16* g = ok ? src + r * ss + c * 8 : src;
    cp_async16(dst + (c / 8) * 8192 + r * 128 + ((c % 8) ^ (r % 8)) * 16, g,
               ok);
  }
}

// Online softmax of one key tile in registers.  s[4 nb + e] is this
// thread's score of row q + 8 (e / 2) and key k + 8 nb + (e & 1); on return
// it holds p, m_r and l_r are updated and alpha rescales the accumulator's
// two rows.  MASK builds the masks (branch-free); tiles without a masked
// pair skip them.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&alpha)[2],
                                             const Params& p, int q, int k,
                                             float sl2) {
  uint32_t valid = 0xFFFFFFFFu;
  if (MASK) {
    valid = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qp = q + 8 * ((i % 4) / 2), kp = k + 8 * (i / 4) + (i & 1);
      const bool ok = (kp < p.sk) & (!p.causal | (qp >= kp)) &
                      ((p.window <= 0) | (qp - kp < p.window));
      valid |= static_cast<uint32_t>(ok) << i;
    }
  }
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = MASK && !((valid >> i) & 1u) ? NEG : s[i] * sl2;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m_r[r], mx[r]);
    alpha[r] = exp2f(m_r[r] - m_new[r]);
    m_r[r] = m_new[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float pe = exp2f(s[i] - m_new[(i % 4) / 2]);
    if (MASK) pe = ((valid >> i) & 1u) ? pe : 0.f;  // p = exp(s - m) * valid
    s[i] = pe;
    rs[(i % 4) / 2] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
}

template <int HD>
__host__ __device__ constexpr int hd_padded() {
  return HD < 64 ? 64 : HD;
}

// warpgroups of a CTA: one, or one per 128 of O's columns past 128 (two at
// hdv 256)
template <int HDV>
__host__ __device__ constexpr int warpgroups() {
  return hd_padded<HDV>() > 128 ? hd_padded<HDV>() / 128 : 1;
}

template <int HD, int HDV>
constexpr int smem_bytes() {
  // Q, two K stages, two V stages, and slack to align to 1,024 bytes
  return 3 * 64 * hd_padded<HD>() * 2 + 2 * 64 * hd_padded<HDV>() * 2 + 1024;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS * warpgroups<HDV>())
flash_attention_tc_kernel(const Params p) {
  constexpr int HDP = hd_padded<HD>();
  constexpr int HDVP = hd_padded<HDV>();
  constexpr int NWG = warpgroups<HDV>();
  constexpr int NT = THREADS * NWG;     // threads of the CTA
  constexpr int WN = HDVP / NWG;        // O columns of one warpgroup
  constexpr int OCOLS = NWG == 1 ? HDV : WN;  // of them, stored
  static_assert(HD % 8 == 0 && HDV % 8 == 0 && HDP % 64 == 0 &&
                    (WN == 64 || WN == 128) && (NWG == 1 || HDV == HDVP),
                "16-byte chunks; whole swizzle atoms; wgmma N of 64 or 128");
  constexpr int TILE = 64 * HDP * 2;    // bytes of one Q or K tile
  constexpr int VTILE = 64 * HDVP * 2;  // bytes of one V tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t ks = qs + TILE;
  const uint32_t vs = ks + 2 * TILE;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / THREADS, warp = (tid % THREADS) / 32;
  const int nqt = (p.sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.h;
  const int head = blockIdx.x % p.h;
  const int kvh = head / p.g;
  const int rows = min(BQ, p.sq - q0);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + head * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                     head * p.o_sh + q0 * p.o_ss;

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

  load_tile<HD, HDP, NT>(qs, q, p.q_ss, rows, tid);
  if (lo < hi) {
    const int k0 = lo * BK;
    load_tile<HD, HDP, NT>(ks, k + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
    load_tile<HDV, HDVP, NT>(vs, v + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
  }
  cp_async_commit();

  // accumulator fragments: warp w of a warpgroup holds rows 16 w + g and
  // 16 w + g + 8, columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-wide
  // block j of its warpgroup's WN columns
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = warp * 16;
  const float sl2 = p.scale * LOG2E;
  float acc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this thread's part of the running sums

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {  // the next tile streams in while this one runs
      const int k1 = (kt + 1) * BK;
      load_tile<HD, HDP, NT>(ks + (st ^ 1) * TILE, k + k1 * p.k_ss, p.k_ss,
                             p.sk - k1, tid);
      load_tile<HDV, HDVP, NT>(vs + (st ^ 1) * VTILE, v + k1 * p.v_ss,
                               p.v_ss, p.sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t kst = ks + st * TILE;
    // this warpgroup's columns of V: WN / 64 atoms of 8 KiB a warpgroup
    const uint32_t vst = vs + st * VTILE + wg * (WN / 64) * 8192;

    // S = Q.K^T: k16 steps along hd, 32 bytes apart inside a 128-byte
    // swizzle row, 8 KiB apart across the 64-column halves
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(s, desc(qs + off, 16, 1024), desc(kst + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    const int k0 = kt * BK;
    const bool edge = k0 + BK > p.sk ||
                      (p.causal && k0 + BK - 1 > qpos_lo) ||
                      (p.window > 0 && qpos_lo + rows - 1 - k0 >= p.window);
    float alpha[2];
    if (edge)
      softmax_tile<true>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                         k0 + 2 * t4, sl2);
    else
      softmax_tile<false>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                          k0 + 2 * t4, sl2);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P.V: P's A fragments from the S fragments, 16 keys per step;
    // V's 16 key rows per step are two 1,024-byte atoms (SBO) and its
    // 64-column halves 8 KiB apart (LBO)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(vst + kk * 2048, 8192, 1024);
      if constexpr (WN == 128)
        wgmma_rs_n128(acc, a[kk], dv);
      else
        wgmma_rs_n64(acc, a[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy may outlive the CTA (an empty key range)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = wrow + g + 8 * r;
    // m_r is in log2 units: lse = m_r ln 2 + log(l), natural units; the
    // warpgroups' m and l are equal, warpgroup 0 writes it
    if (p.lse != nullptr && wg == 0 && t4 == 0 && row < rows)
      p.lse[static_cast<long long>(blockIdx.x) * p.sq + q0 + row] =
          m_r[r] * LN2 + logf(fmaxf(l, 1e-30f));
    if (row < rows) {
      __nv_bfloat16* orow = o + row * p.o_ss + wg * WN + 2 * t4;
#pragma unroll
      for (int j = 0; j < OCOLS / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD, int HDV>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, HDV>();
  auto kernel = flash_attention_tc_kernel<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS * warpgroups<HDV>(), bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int hd, int hdv, int batch_heads,
                     cudaStream_t stream) {
  switch (pair(hd, hdv)) {
    case pair(16, 16): return launch<16, 16>(p, batch_heads, stream);
    case pair(24, 16): return launch<24, 16>(p, batch_heads, stream);
    case pair(32, 32): return launch<32, 32>(p, batch_heads, stream);
    case pair(64, 64): return launch<64, 64>(p, batch_heads, stream);
    case pair(128, 128): return launch<128, 128>(p, batch_heads, stream);
    case pair(192, 128): return launch<192, 128>(p, batch_heads, stream);
    case pair(256, 256): return launch<256, 256>(p, batch_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
// Deterministic by construction: every output element is written by one
// CTA, which sums in a fixed order; no float atomics.  So two backward
// runs give the same bits, and a resumed training run the same state.
//
// fa_bwd_dkdv_kernel: one CTA of 256 threads per (b, kv head, 64-key
// tile).  It loops over the g query heads of its kv head and, for each,
// over the 64-row query tiles the causal / window mask lets reach its
// keys (skipping a fully masked tile is exact), recomputing S and P from
// q, k and lse; dK and dV stay in registers for the whole loop.
// fa_bwd_dq_kernel: one CTA per (b, head, 64-row query tile), looping over
// the key tiles of the forward's reach; dQ stays in registers.  Tiles are
// staged in shared memory as float32 (rows padded to hd + 1 against bank
// conflicts); the products are float32 FMAs, as in the forward's FMA
// kernel, for both dtypes.
//
// What bounds it.  The backward's five products are 10 B H Sq Sk hd FLOP
// (half under causal); at the training shape (4, 1024, 1024, 12, 2, 128)
// that is ~26 GFLOP per layer against ~31 MB of operands: far above the
// card's ~295 bf16 FLOP per byte, so the tensor cores bound it.  This
// kernel does seven products (S and dP twice) on the 67 TFLOP/s CUDA
// cores, with one CTA per SM (~160 KiB of shared memory each), and the
// causal dK/dV CTAs are unbalanced (the first key tile sees every query
// tile).  These kernels are the FMA route (`fa_backward`: float32, and
// bfloat16 with hd 8); bfloat16 with hd >= 16 takes the tensor-core route
// below (`fa_backward_tc`, namespace bwd_tc).

namespace bwd {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BK + 1;    // padded row of a P / dS tile

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

// D = rowsum(dO o): one warp per row, 8 rows per CTA pass
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_preprocess_kernel(const Params p, int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / p.h, head = bh % p.h;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + head * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + head * p.do_sh;
  const int r_end = min(p.sq, (blockIdx.x + 1) * BQ);
  for (int r = blockIdx.x * BQ + warp; r < r_end; r += THREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < hd; d += 32)
      s = fmaf(load_f32(o + r * p.o_ss + d), load_f32(dout + r * p.do_ss + d),
               s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) p.delta[static_cast<long long>(bh) * p.sq + r] = s;
  }
}

// Stage rows [0, n) of a tile of 64 rows (row stride ss elements) into
// shared memory as float32 with row pitch HD + 1; rows past n are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int n, int tid) {
  for (int i = tid; i < 64 * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < n ? load_f32(src + r * ss + d) : 0.f;
  }
}

// S = A.B^T and dP = C.E^T over hd for one (64 x 64) tile pair: thread
// (sy, sx) owns rows sy*4 + i and columns sx + 16 j, as the forward's
// score loop does
template <int HD>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&dp)[4][4], int sy,
                                             int sx) {
  constexpr int HP = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], bb[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(sy * 4 + i) * HP + d];
      c[i] = C[(sy * 4 + i) * HP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = B[(sx + 16 * j) * HP + d];
      e[j] = E[(sx + 16 * j) * HP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return 4 * 64 * (HD + 1) + 2 * BQ * PP + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int HP = HD + 1;
  float* Ks = smem;                 // [BK][HP]
  float* Vs = Ks + BK * HP;         // [BK][HP]
  float* Qs = Vs + BK * HP;         // [BQ][HP]
  float* dOs = Qs + BQ * HP;        // [BQ][HP]
  float* Ps = dOs + BQ * HP;        // [BQ][PP]
  float* dSs = Ps + BQ * PP;        // [BQ][PP]
  float* lse_s = dSs + BQ * PP;     // [BQ]
  float* D_s = lse_s + BQ;          // [BQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int hkv = p.h / p.g;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int keys = min(BK, p.sk - k0);

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage<T, HD>(Ks, k + k0 * p.k_ss, p.k_ss, keys, tid);
  stage<T, HD>(Vs, v + k0 * p.v_ss, p.v_ss, keys, tid);

  // the query tiles whose mask reaches keys [k0, k0 + keys)
  const int nq = (p.sq + BQ - 1) / BQ;
  const int qt_lo = p.causal ? min(nq, k0 / BQ) : 0;
  int qt_hi = nq;
  if (p.window > 0) qt_hi = min(nq, (k0 + keys - 1 + p.window - 1) / BQ + 1);

  const int sy = tid / 16, sx = tid % 16;
  // dK and dV: thread (py, px) owns key rows py*RPT + i, columns px + TX*j
  constexpr int TX = HD < 16 ? HD : 16;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BK / TY;
  constexpr int CPT = HD / TX;
  const int py = tid / TX, px = tid % TX;
  float dk[RPT][CPT], dv[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int hq = 0; hq < p.g; ++hq) {
    const int head = kvh * p.g + hq;
    const long long bh = static_cast<long long>(b) * p.h + head;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
    const T* dout =
        static_cast<const T*>(p.dout) + b * p.do_sb + head * p.do_sh;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      const int rows = min(BQ, p.sq - q0);
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      stage<T, HD>(Qs, q + q0 * p.q_ss, p.q_ss, rows, tid);
      stage<T, HD>(dOs, dout + q0 * p.do_ss, p.do_ss, rows, tid);
      for (int r = tid; r < BQ; r += THREADS) {
        lse_s[r] = r < rows ? p.lse[bh * p.sq + q0 + r] : 0.f;
        D_s[r] = r < rows ? p.delta[bh * p.sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<HD>(Qs, Ks, dOs, Vs, s, dp, sy, sx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy * 4 + i;
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
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], ds[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * PP + py * RPT + i];
          ds[i] = dSs[r * PP + py * RPT + i];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float dov = dOs[r * HP + px + TX * j];
          const float qv = Qs[r * HP + px + TX * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][j] = fmaf(pv[i], dov, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int c = py * RPT + i;
    if (c < keys) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        store_f32(dkp + (k0 + c) * p.dk_ss + px + TX * j, dk[i][j] * p.scale);
        store_f32(dvp + (k0 + c) * p.dv_ss + px + TX * j, dv[i][j]);
      }
    }
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  return 4 * 64 * (HD + 1) + BQ * PP + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int HP = HD + 1;
  float* Qs = smem;                 // [BQ][HP]
  float* dOs = Qs + BQ * HP;        // [BQ][HP]
  float* Ks = dOs + BQ * HP;        // [BK][HP]
  float* Vs = Ks + BK * HP;         // [BK][HP]
  float* dSs = Vs + BK * HP;        // [BQ][PP]
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
  stage<T, HD>(Qs, q + q0 * p.q_ss, p.q_ss, rows, tid);
  stage<T, HD>(dOs, dout + q0 * p.do_ss, p.do_ss, rows, tid);
  for (int r = tid; r < BQ; r += THREADS) {
    lse_s[r] = r < rows ? p.lse[bh * p.sq + q0 + r] : 0.f;
    D_s[r] = r < rows ? p.delta[bh * p.sq + q0 + r] : 0.f;
  }

  // the key tiles this query tile reaches (the forward's loop bounds)
  const int nk = (p.sk + BK - 1) / BK;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + rows + BK - 1) / BK);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  const int sy = tid / 16, sx = tid % 16;
  constexpr int TX = HD < 16 ? HD : 16;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BQ / TY;
  constexpr int CPT = HD / TX;
  const int py = tid / TX, px = tid % TX;
  float dq[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[i][j] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    stage<T, HD>(Ks, k + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
    stage<T, HD>(Vs, v + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<HD>(Qs, Ks, dOs, Vs, s, dp, sy, sx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int c = 0; c < BK; ++c) {
      float ds[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) ds[i] = dSs[(py * RPT + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kv = Ks[c * HP + px + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dq[i][j] = fmaf(ds[i], kv, dq[i][j]);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + head * p.dq_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = py * RPT + i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        store_f32(dqp + (q0 + r) * p.dq_ss + px + TX * j, dq[i][j] * p.scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int hkv = p.h / p.g;
  fa_bwd_preprocess_kernel<T><<<dim3((p.sq + BQ - 1) / BQ, batch * p.h),
                                THREADS, 0, stream>>>(p, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_floats<HD>() * sizeof(float);
  auto dkdv = fa_bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.sk + BK - 1) / BK, batch * hkv), THREADS, dkdv_bytes,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = dq_smem_floats<HD>() * sizeof(float);
  auto dqk = fa_bwd_dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((p.sq + BQ - 1) / BQ, batch * p.h), THREADS, dq_bytes,
        stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, int batch, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(p, batch, stream);
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// ------------------------------------------- backward, tensor cores (bf16)
// The same gradient for bfloat16 operands with hd in {16, 32, 64, 128}
// (`fa_backward_tc`), its products on the tensor cores.  It replaces what
// the JAX package leaves to XLA autodiff of its jnp chunked attention
// (src/repro/models/attention.py:92); there is no Pallas backward.
//
// What bounds it.  The five products are 10 hd FLOP per live (q, k) pair
// and head: at the training shapes, (2 or 4, 1024, 1024, 12, 2, 128)
// causal, 13 or 26 GFLOP against 16 or 31 MB of operands (~800 FLOP per
// byte), so the bf16 tensor cores bound it (0.0163 ms at B = 2, 989
// TFLOP/s).
//
// What the design does about that.  Every product is a warpgroup MMA
// (`wgmma.mma_async`, bf16 inputs, float32 accumulators) on the forward's
// 128-byte-swizzled shared tiles (`tc::load_tile`, `tc::desc`):
//
//   fa_bwd_preprocess_tc_kernel  D = rowsum(dO o), bytes-bound: 16-byte
//       loads, hd / 8 lanes a row reduced by shuffles
//   fa_bwd_dkdv_tc_kernel  one CTA (one warpgroup) per (b, query head,
//       64-key tile).  K and V are loaded once; Q, dO and the tile's lse
//       and D stream in double-buffered (cp.async) over the query tiles of
//       the causal / window reach.  Per query tile:
//         S^T = K.Q^T, dP^T = V.dO^T     m64n64k16, both operands K-major
//         P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - D)   in registers
//         dV += P^T.dO, dK += dS^T.Q     m64nNk16, A = the accumulator
//             fragments in bf16 (as the forward's P.V), B = dO / Q read
//             MN-major (the forward's V descriptor)
//       dK and dV stay in float32 registers for the whole loop.  With
//       g = H / Hkv > 1 each CTA writes float32 partials of its query head
//       into a (B, Sk, H, hd) scratch and fa_bwd_gqa_reduce_kernel sums the
//       g partials of each kv head in head order into bf16; with g = 1 the
//       CTA writes bf16 itself.  A CTA per query head (not per kv head
//       looping over its g heads) gives B H Sk / 64 CTAs: 768 at the
//       4 x 1024 training step against 128, and the key tiles launch
//       longest causal reach first (tile 0 sees every query tile).
//   fa_bwd_dq_tc_kernel  one CTA per (b, head, 64-row query tile), in
//       reverse q-tile order as the forward: Q, dO, lse, D loaded once, K
//       and V double-buffered over the forward's reach; S = Q.K^T, dP =
//       dO.V^T, dS in registers, dQ += dS.K (K read MN-major).
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
// copies of one CTA run one after the other (no producer warp, no TMA, no
// ping-pong), S and dP are computed twice (nine products in all with the
// split dS, against the five the bound counts), and every query head
// re-reads its kv head's tiles.
//
// Alignment: as the forward, every operand starts on a 16-byte boundary and
// its b, s and h strides are multiples of 8 elements; `fa_backward_tc`
// refuses otherwise.

namespace bwd_tc {

constexpr int B64 = 64;          // query rows and keys per tile
constexpr int THREADS = 128;     // one warpgroup
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

using tc::smem_u32;

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

template <int HD>
constexpr int smem_bytes(int row_stages) {
  // four or six 64-row tiles, lse and D rows, slack to align to 1,024 bytes
  return 6 * 64 * tc::hd_padded<HD>() * 2 + row_stages * 2 * 64 * 4 + 1024;
}

// A tile holds a masked pair: a ragged edge, the causal diagonal, or the
// window's edge (q_offset is 0 in the backward)
__device__ __forceinline__ bool edge_tile(const bwd::Params& p, int q0,
                                          int k0) {
  return (q0 + B64 > p.sq) | (k0 + B64 > p.sk) |
         (p.causal & (k0 + B64 - 1 > q0)) |
         ((p.window > 0) & (q0 + B64 - 1 - k0 >= p.window));
}

// Bit i: is element i of this thread's 64 x 64 accumulator fragment an
// attended pair?  Element i sits at row r0 + 8 ((i % 4) / 2) and column
// c0 + 8 (i / 4) + (i & 1); KEY_ROWS: rows are keys and columns queries
// (S^T), else rows are queries (S).
template <bool KEY_ROWS>
__device__ __forceinline__ uint32_t valid_bits(const bwd::Params& p, int r0,
                                               int c0) {
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i % 4) / 2), c = c0 + 8 * (i / 4) + (i & 1);
    const int qp = KEY_ROWS ? c : r, kp = KEY_ROWS ? r : c;
    const bool ok = (qp < p.sq) & (kp < p.sk) & (!p.causal | (qp >= kp)) &
                    ((p.window <= 0) | (qp - kp < p.window));
    valid |= static_cast<uint32_t>(ok) << i;
  }
  return valid;
}

// d (64 x 64) = A (64 x hd) . B^T (64 x hd), both K-major swizzled tiles
template <int HDP>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    tc::wgmma_ss_n64(d, tc::desc(a + off, 16, 1024),
                     tc::desc(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x HDP) += A (64 x 64, bf16 fragments) . B (64 x HDP tile, read
// MN-major: 16 rows per step are two 1,024-byte atoms)
template <int HDP>
__device__ __forceinline__ void mma_rs(float (&acc)[HDP / 2],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = tc::desc(b + kk * 2048, 8192, 1024);
    if constexpr (HDP == 128)
      tc::wgmma_rs_n128(acc, a[kk], db);
    else
      tc::wgmma_rs_n64(acc, a[kk], db);
  }
}

// The accumulator fragment of a 64 x 64 product as the A fragments of a
// 64 x 64 (K = 64) bf16 operand
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = tc::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// The same as two bf16 fragments, hi = bf16(s) and lo = bf16(s - hi): a
// product with both keeps s to about 16 significant bits
__device__ __forceinline__ void pack_split(const float (&s)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  pack_a(s, hi);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
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
template <typename Lse>
__device__ __forceinline__ void probs(float (&s)[32], Lse lse2,
                                      uint32_t valid, float sl2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pe = exp2f(fmaf(s[i], sl2, -lse2(i)));
    s[i] = ((valid >> i) & 1u) ? pe : 0.f;
  }
}

// dP -> dS = P (dP - D) in place; d(i) is the D of element i
template <typename Dd>
__device__ __forceinline__ void dscores(const float (&pr)[32],
                                        float (&dp)[32], Dd d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = pr[i] * (dp[i] - d(i));
}

// D = rowsum(dO o) for the route's aligned operands: 16-byte loads (8
// bf16), HD / 8 neighbouring lanes a row, 64 rows a CTA
template <int HD>
__global__ void __launch_bounds__(RED_THREADS)
fa_bwd_preprocess_tc_kernel(const bwd::Params p) {
  constexpr int L = HD / 8;               // lanes per row
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_tc_kernel(const bwd::Params p, float* dk_part, float* dv_part) {
  constexpr int HDP = tc::hd_padded<HD>();
  constexpr int TILE = 64 * HDP * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t ks = (s0 + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t qs = vs + TILE;        // two stages
  const uint32_t dos = qs + 2 * TILE;   // two stages
  const uint32_t rs = dos + 2 * TILE;   // per stage: lse[64], then D[64]
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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

  // the query tiles whose mask reaches keys [k0, k0 + keys)
  const int nq = (p.sq + B64 - 1) / B64;
  const int qt_lo = p.causal ? min(nq, k0 / B64) : 0;
  int qt_hi = nq;
  if (p.window > 0)
    qt_hi = min(nq, (k0 + keys - 1 + p.window - 1) / B64 + 1);

  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * B64, n = p.sq - q0;
    tc::load_tile<HD, HDP>(qs + st * TILE, q + q0 * p.q_ss, p.q_ss, n, tid);
    tc::load_tile<HD, HDP>(dos + st * TILE, dout + q0 * p.do_ss, p.do_ss, n,
                           tid);
    const int r = tid % B64;
    const float* src = (tid < B64 ? lse : delta) + q0;
    cp_async4(rs + st * 512 + tid * 4, r < n ? src + r : src, r < n);
  };
  tc::load_tile<HD, HDP>(ks, k, p.k_ss, keys, tid);
  tc::load_tile<HD, HDP>(vs, v, p.v_ss, keys, tid);
  if (qt_lo < qt_hi) load_q_tile(qt_lo, 0);
  tc::cp_async_commit();

  float dk[HDP / 2], dv[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) dk[j] = dv[j] = 0.f;
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
    const uint32_t qst = qs + st * TILE, dost = dos + st * TILE;

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
    mma_ss<HDP>(dp, vs, dost);   // dP^T = V.dO^T
    mma_rs<HDP>(dv, ap, dost);   // dV += P^T.dO, in the same group
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    dscores(s, dp, [&](int i) { return lse_t[64 + col(i)]; });
    uint32_t as[4][4], al[4][4];
    pack_split(dp, as, al);
    tc::wgmma_fence();
    mma_rs<HDP>(dk, as, qst);    // dK += dS^T.Q, dS^T as hi + lo
    mma_rs<HDP>(dk, al, qst);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    __syncthreads();  // this stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();  // no copy may outlive the CTA

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= keys) continue;
    if (dk_part == nullptr) {  // g = 1: this CTA owns the rows
      __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                           kvh * p.dk_sh + (k0 + row) * p.dk_ss + 2 * t4;
      __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                           kvh * p.dv_sh + (k0 + row) * p.dv_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * r] * p.scale,
                                  dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    } else {  // float32 partials of this query head, (B, Sk, H, hd)
      const long long off =
          ((static_cast<long long>(b) * p.sk + k0 + row) * p.h + head) * HD +
          2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(dk_part + off + 8 * j) = make_float2(
            dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(dv_part + off + 8 * j) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dK, dV (bf16) = the sums of the g query heads' float32 partials of each
// kv head, in head order: four elements a thread
__global__ void __launch_bounds__(RED_THREADS)
fa_bwd_gqa_reduce_kernel(const bwd::Params p, const float* dk_part,
                         const float* dv_part, int batch, int hd) {
  const int hkv = p.h / p.g, d4n = hd / 4;
  const long long n4 = static_cast<long long>(batch) * p.sk * hkv * d4n;
  const long long i =
      static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (i >= n4) return;
  const int d = static_cast<int>(i % d4n) * 4;
  long long rest = i / d4n;
  const int kvh = static_cast<int>(rest % hkv);
  rest /= hkv;
  const int s = static_cast<int>(rest % p.sk);
  const int b = static_cast<int>(rest / p.sk);
  const long long base =
      ((static_cast<long long>(b) * p.sk + s) * p.h + kvh * p.g) * hd + d;
  float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f), sv4 = sk4;
  for (int hq = 0; hq < p.g; ++hq) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + base + hq * hd);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + base + hq * hd);
    sk4.x += a.x; sk4.y += a.y; sk4.z += a.z; sk4.w += a.w;
    sv4.x += c.x; sv4.y += c.y; sv4.z += c.z; sv4.w += c.w;
  }
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                            s * p.dk_ss + kvh * p.dk_sh + d) =
      make_uint2(tc::pack_bf16(sk4.x, sk4.y), tc::pack_bf16(sk4.z, sk4.w));
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                            s * p.dv_ss + kvh * p.dv_sh + d) =
      make_uint2(tc::pack_bf16(sv4.x, sv4.y), tc::pack_bf16(sv4.z, sv4.w));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_tc_kernel(const bwd::Params p) {
  constexpr int HDP = tc::hd_padded<HD>();
  constexpr int TILE = 64 * HDP * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t qs = (s0 + 1023u) & ~1023u;
  const uint32_t dos = qs + TILE;
  const uint32_t ks = dos + TILE;       // two stages
  const uint32_t vs = ks + 2 * TILE;    // two stages
  const uint32_t rs = vs + 2 * TILE;    // lse[64], then D[64]
  const float* rows_p = reinterpret_cast<const float*>(smem + (rs - s0));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvh = head / p.g;
  const int nq = (p.sq + B64 - 1) / B64;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * B64;
  const int rows = min(B64, p.sq - q0);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + head * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              b * p.do_sb + head * p.do_sh + q0 * p.do_ss;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the key tiles this query tile reaches (the forward's loop bounds)
  const int nk = (p.sk + B64 - 1) / B64;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + rows + B64 - 1) / B64);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    lo = first > 0 ? first / B64 : 0;
  }

  tc::load_tile<HD, HDP>(qs, q, p.q_ss, rows, tid);
  tc::load_tile<HD, HDP>(dos, dout, p.do_ss, rows, tid);
  {
    const int r = tid % B64;
    const float* src = (tid < B64 ? p.lse : p.delta) +
                       static_cast<long long>(bh) * p.sq + q0;
    cp_async4(rs + tid * 4, r < rows ? src + r : src, r < rows);
  }
  auto load_kv_tile = [&](int kt, int st) {
    const int kk0 = kt * B64;
    tc::load_tile<HD, HDP>(ks + st * TILE, k + kk0 * p.k_ss, p.k_ss,
                           p.sk - kk0, tid);
    tc::load_tile<HD, HDP>(vs + st * TILE, v + kk0 * p.v_ss, p.v_ss,
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
    const uint32_t kst = ks + st * TILE, vst = vs + st * TILE;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    mma_ss<HDP>(s, qs, kst);     // S = Q.K^T
    mma_ss<HDP>(dp, dos, vst);   // dP = dO.V^T
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
    mma_rs<HDP>(dq, as, kst);    // dQ += dS.K, dS as hi + lo
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
    __nv_bfloat16* dqr = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                         head * p.dq_sh + (q0 + row) * p.dq_ss + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * j) = __floats2bfloat162_rn(
          dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
  }
}

template <int HD>
cudaError_t launch(const bwd::Params& p, int batch, float* dk_part,
                   float* dv_part, cudaStream_t stream) {
  const int nq = (p.sq + B64 - 1) / B64, nk = (p.sk + B64 - 1) / B64;
  fa_bwd_preprocess_tc_kernel<HD>
      <<<dim3(nq, batch * p.h), RED_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = smem_bytes<HD>(2);
  auto dkdv = fa_bwd_dkdv_tc_kernel<HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(batch * p.h, nk), THREADS, dkdv_bytes, stream>>>(
      p, p.g > 1 ? dk_part : nullptr, p.g > 1 ? dv_part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (p.g > 1) {
    const long long n4 =
        static_cast<long long>(batch) * p.sk * (p.h / p.g) * (HD / 4);
    fa_bwd_gqa_reduce_kernel<<<
        static_cast<unsigned>((n4 + RED_THREADS - 1) / RED_THREADS),
        RED_THREADS, 0, stream>>>(p, dk_part, dv_part, batch, HD);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  constexpr int dq_bytes = smem_bytes<HD>(1);
  auto dqk = fa_bwd_dq_tc_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(batch * p.h, nq), THREADS, dq_bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const bwd::Params& p, int hd, int batch, float* dk_part,
                     float* dv_part, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(p, batch, dk_part, dv_part, stream);
    case 32: return launch<32>(p, batch, dk_part, dv_part, stream);
    case 64: return launch<64>(p, batch, dk_part, dv_part, stream);
    case 128: return launch<128>(p, batch, dk_part, dv_part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd_tc

}  // namespace

// strides: 12 element strides, (b, s, h) of q, k, v, o in that order.
static cudaError_t make_params(Params& p, const void* q, const void* k,
                        const void* v, void* o, float* lse,
                        const long long* strides,
                        int batch, int sq, int sk, int h, int hkv,
                        int causal, int window, int q_offset, float scale) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  return cudaSuccess;
}

extern "C" {

// The float32 route.  hd: q and k's head dim; hdv: v and o's.  dtype: 0
// float32, 1 bfloat16.  lse: null, or a float32 (B, H, Sq) output for each
// row's log-sum-exp (the backward's statistic).  Returns the CUDA status
// of the launch (cudaErrorInvalidValue for an (hd, hdv) pair not built).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               const long long* strides, int batch, int sq, int sk, int h,
               int hkv, int hd, int hdv, int causal, int window,
               int q_offset, float scale, float* lse, int dtype,
               void* stream) {
  Params p;
  cudaError_t err = make_params(p, q, k, v, o, lse, strides, batch, sq, sk,
                                h, hkv, causal, window, q_offset, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? dispatch<float>(p, hd, hdv, batch * h, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(p, hd, hdv, batch * h, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tensor-core route: bfloat16, (hd, hdv) a pair of tc::dispatch;
// pointers on 16-byte boundaries and strides in multiples of 8 elements
// (cp.async).
int fa_forward_tc(const void* q, const void* k, const void* v, void* o,
                  const long long* strides, int batch, int sq, int sk, int h,
                  int hkv, int hd, int hdv, int causal, int window,
                  int q_offset, float scale, float* lse, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Params p;
  cudaError_t err = make_params(p, q, k, v, o, lse, strides, batch, sq, sk,
                                h, hkv, causal, window, q_offset, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tc::dispatch(p, hd, hdv, batch * h,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

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

// The FMA route's backward (float32, and bfloat16 with any hd): dq, dk, dv
// (in the operands' dtype, written whole) from dO, q, k, v, the forward's
// o and lse, through three kernels on `stream`; delta is a float32
// (B, H, Sq) scratch.  strides: 24 element strides, (b, s, h) of q, k, v,
// o, dO, dq, dk, dv in that order.  dtype: 0 float32, 1 bfloat16.  Returns
// the CUDA status of the launches.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, const long long* strides, int batch,
                int sq, int sk, int h, int hkv, int hd, int causal,
                int window, float scale, int dtype, void* stream) {
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? bwd::dispatch<float>(p, hd, batch, s)
      : dtype == 1 ? bwd::dispatch<__nv_bfloat16>(p, hd, batch, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tensor-core route's backward: bfloat16, hd in {16, 32, 64, 128}; the
// same arguments as `fa_backward` without dtype, plus dk_part and dv_part,
// two float32 (B, Sk, H, hd) scratches (null where H == Hkv).  Every
// pointer on a 16-byte boundary and every stride a multiple of 8 elements.
// Four kernels: preprocess, dK/dV, the GQA reduction (H > Hkv), dQ.
int fa_backward_tc(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, float* dk_part,
                   float* dv_part, const long long* strides, int batch,
                   int sq, int sk, int h, int hkv, int hd, int causal,
                   int window, float scale, void* stream) {
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (hkv > 0 && h != hkv && (dk_part == nullptr || dv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Params p;
  cudaError_t err = make_bwd_params(p, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, strides, batch, sq, sk, h, hkv,
                                    causal, window, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_tc::dispatch(p, hd, batch, dk_part, dv_part,
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
