// Forward flash attention for NVIDIA Hopper (sm_90a), plain C interface.
// Two kernels compute the same function; the wrapper
// (kernels/flash_attention.py, `_route`) picks one by dtype and head dim:
//
//   flash_attention_tc_kernel  bfloat16, hd in {16, 32, 64, 128}: products
//                              on the tensor cores, wgmma (`fa_forward_tc`)
//   flash_attention_kernel     float32 (any hd of the five) and bfloat16
//                              with hd = 8: float32 FMAs (`fa_forward`)
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
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o (B, Sq, H, hd), read
// and written through element strides (the last dimension has stride 1).
// No pad or transpose copy: the ragged q and k edges are masked here.
//
// What bounds both.  At the smoke's prefill shape, (B, Sq, Sk, H, Hkv, hd) =
// (1, 2048, 2048, 12, 2, 128) bf16 causal, the live causal half is about
// 12.9 GFLOP against about 15 MB of q, k, v and o: ~860 FLOP per byte, far
// above the card's ~295 bf16 FLOP per byte, so the bound is the tensor
// cores (13 us at 989 TFLOP/s).
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
// (2e-5), far from the bound.
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


// ------------------------------------------------ tensor-core route (bf16)
// flash_attention_tc_kernel: the same function for bfloat16 operands with
// hd in {16, 32, 64, 128}, its products on the tensor cores.
//
// Design (a FlashAttention-3-style warpgroup kernel without the producer
// warp).  One CTA is one warpgroup of 4 warps and owns one (b, h, 64-row q
// tile); it loops over 64-key tiles.  Both products are Hopper warpgroup
// MMAs (`wgmma.mma_async`, bf16 inputs, float32 accumulators):
//   S = Q.K^T  m64n64k16, A = Q and B = K read by the tensor cores straight
//              from shared memory through matrix descriptors (both K-major);
//   O += P.V   m64nNk16 (N = 64 or 128), A = P from registers — the S
//              accumulator fragment rounded to bf16 (as every tensor-core
//              flash kernel does), B = V from shared memory as an MN-major
//              operand (the transpose bit, which 16-bit types have).
// Shared tiles use the 128-byte swizzle that the descriptors name: a tile is
// [hd / 64][64 rows][128 B], the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), each 8-row group a 1,024-byte-aligned atom, so the tensor
// cores read without bank conflicts.  A head dim below 64 is padded to 64
// columns of zeros in shared memory (the copy zero-fills them), which
// leaves S and the kept columns of O unchanged.  K and V tiles are
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
// the swizzled shared tile at `dst`, [HDP / 64][64][128 B]; rows past
// n_valid and columns past HD become zeros.
template <int HD, int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int n_valid,
                                          int tid) {
  constexpr int C = HDP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < 64 * C / THREADS; ++j) {
    const int i = tid + j * THREADS;
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

template <int HD>
constexpr int smem_bytes() {
  // Q, two K stages, two V stages, and slack to align to 1,024 bytes
  return 5 * 64 * hd_padded<HD>() * 2 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const Params p) {
  constexpr int HDP = hd_padded<HD>();
  constexpr int TILE = 64 * HDP * 2;  // bytes of one Q, K or V tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t ks = qs + TILE;
  const uint32_t vs = ks + 2 * TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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

  load_tile<HD, HDP>(qs, q, p.q_ss, rows, tid);
  if (lo < hi) {
    const int k0 = lo * BK;
    load_tile<HD, HDP>(ks, k + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
    load_tile<HD, HDP>(vs, v + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
  }
  cp_async_commit();

  // accumulator fragments: warp w holds rows 16 w + g and 16 w + g + 8,
  // columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-wide block j
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = warp * 16;
  const float sl2 = p.scale * LOG2E;
  float acc[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this thread's part of the running sums

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {  // the next tile streams in while this one runs
      const int k1 = (kt + 1) * BK;
      load_tile<HD, HDP>(ks + (st ^ 1) * TILE, k + k1 * p.k_ss, p.k_ss,
                         p.sk - k1, tid);
      load_tile<HD, HDP>(vs + (st ^ 1) * TILE, v + k1 * p.v_ss, p.v_ss,
                         p.sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t kst = ks + st * TILE;
    const uint32_t vst = vs + st * TILE;

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
    for (int j = 0; j < HDP / 8; ++j) {
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
      if constexpr (HDP == 128)
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
    if (row < rows) {
      __nv_bfloat16* orow = o + row * p.o_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  auto kernel = flash_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int hd, int batch_heads,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(p, batch_heads, stream);
    case 32: return launch<32>(p, batch_heads, stream);
    case 64: return launch<64>(p, batch_heads, stream);
    case 128: return launch<128>(p, batch_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// strides: 12 element strides, (b, s, h) of q, k, v, o in that order.
static cudaError_t make_params(Params& p, const void* q, const void* k,
                        const void* v, void* o, const long long* strides,
                        int batch, int sq, int sk, int h, int hkv,
                        int causal, int window, int q_offset, float scale) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
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
  return cudaSuccess;
}

extern "C" {

// The float32 route.  dtype: 0 float32, 1 bfloat16.  Returns the CUDA
// status of the launch.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               const long long* strides, int batch, int sq, int sk, int h,
               int hkv, int hd, int causal, int window, int q_offset,
               float scale, int dtype, void* stream) {
  Params p;
  cudaError_t err = make_params(p, q, k, v, o, strides, batch, sq, sk, h,
                                hkv, causal, window, q_offset, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? dispatch<float>(p, hd, batch * h, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(p, hd, batch * h, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tensor-core route: bfloat16, hd in {16, 32, 64, 128}; pointers on
// 16-byte boundaries and strides in multiples of 8 elements (cp.async).
int fa_forward_tc(const void* q, const void* k, const void* v, void* o,
                  const long long* strides, int batch, int sq, int sk, int h,
                  int hkv, int hd, int causal, int window, int q_offset,
                  float scale, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Params p;
  cudaError_t err = make_params(p, q, k, v, o, strides, batch, sq, sk, h,
                                hkv, causal, window, q_offset, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tc::dispatch(p, hd, batch * h, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
