// Flash attention for NVIDIA Hopper (sm_90a), plain C interface: two
// forward kernels (their backward is flash_attention_bwd.cu; the helpers
// both use, flash_attention_common.cuh).
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

#include "flash_attention_common.cuh"

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
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

}  // extern "C"
