// Flash attention for NVIDIA Hopper (sm_90a), plain C interface: the
// forward kernels (their backward is flash_attention_bwd.cu; the helpers
// both use, flash_attention_common.cuh).
// The forward kernels compute the same function; the wrapper
// (kernels/flash_attention.py, `_route`) picks a route by dtype and head
// dims, and the tensor-core route a kernel by hd:
//
//   flash_attention_tc_kernel  bfloat16, (hd, hdv) in {(16, 16), (24, 16),
//                              (32, 32), (64, 64), (128, 128)}: products on
//                              the tensor cores, wgmma (`fa_forward_tc`)
//   flash_attention_narrow_kernel  bfloat16, (24, 16) with at most 256
//                              keys: the same products, one key tile a
//                              one-warpgroup CTA, four CTAs a cluster
//                              (`fa_forward_narrow`; the wrapper's
//                              forward_plan picks it from the shapes)
//   flash_attention_ws_kernel  bfloat16, (192, 128) and (256, 256): the
//                              same products in a warp-specialised CTA, a
//                              TMA producer and two consumer warpgroups
//                              (`fa_forward_tc`); at (64, 64) without a
//                              mask, where the CTAs leave SMs idle, the
//                              same CTA split over a cluster
//                              (`fa_forward_split`; forward_plan picks
//                              it from the shapes)
//   flash_attention_tf32_kernel  float32, the same pairs: the products on
//                              the tensor cores as split TF32, three
//                              wgmma a product (`fa_forward_tf32`)
//   flash_attention_kernel     float32 at (8, 8) (and at any pair when
//                              named) and bfloat16 with hd = 8: float32
//                              FMAs (`fa_forward`)
//
// hd is the q.k head dim, hdv v's and the output's: they differ for
// DeepSeek-V2's multi-head latent attention (qk = nope 128 + rope 64 = 192,
// v 128; 24 / 16 in its smoke config); RecurrentGemma's local attention
// takes (256, 256), 16 query heads over one kv head.  The kernels are
// templates over
// <HD, HDV>: the Q and K tiles are HD wide; the V tile, the O accumulator,
// the output store are HDV wide; m, l and lse are per query row.
//
// All replace the Pallas TPU kernel `flash_attention_pallas` (`_fa_kernel`,
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
// What bounds them.  At the smoke's prefill shape, (B, Sq, Sk, H, Hkv, hd) =
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
// flash_attention_kernel (the FMA route: float32 at hd 8, and the
// comparison the smoke times flash_attention_tf32_kernel against; its
// design, kept as written at port time).  One CTA of 256 threads owns
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
// flash_attention_tc_kernel, flash_attention_narrow_kernel and
// flash_attention_ws_kernel (the bfloat16 route) are described above
// their definitions below.

#include <cooperative_groups.h>
#include <cuda.h>

#include "flash_attention_common.cuh"

namespace cg = cooperative_groups;

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
// The same function for bfloat16 operands with (hd, hdv) in {(16, 16),
// (24, 16), (32, 32), (64, 64), (128, 128), (192, 128), (256, 256)}, its
// products on the tensor cores: `flash_attention_tc_kernel` up to hd 128,
// `flash_attention_ws_kernel` past it (DeepSeek-V2's MLA at (192, 128),
// RecurrentGemma's (256, 256)).  `tc::launch` picks by HD.
//
// flash_attention_tc_kernel (hd <= 128; a FlashAttention-3-style
// warpgroup kernel without the producer warp).  One CTA is one warpgroup
// of 4 warps and owns one (b, h, 64-row q tile); it loops over 64-key
// tiles.  Both products are Hopper warpgroup MMAs (`wgmma.mma_async`, bf16
// inputs, float32 accumulators):
//   S = Q.K^T  m64n64k16, A = Q and B = K read by the tensor cores straight
//              from shared memory through matrix descriptors (both K-major);
//              hd / 16 k-steps;
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
// leaves S and the kept columns of O unchanged.  ptxas gives 196 registers
// at (128, 128), no spills.  K and V tiles are
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
// first and the short ones fill the tail.  What it gives up: the products
// and the softmax of one CTA run one after the other (several CTAs share an
// SM and overlap each other), and the copies are cp.async rather than TMA.
//
// flash_attention_ws_kernel (hd > 128: (192, 128) and (256, 256); warp-
// specialised).  Past hd 128 one SM holds one CTA (its tiles take 169 and
// 193 KiB), so the overlap has to come from inside it.  A CTA is three
// warpgroups over one (b, h, 128-row q tile):
//   warpgroup 0, the producer: `setmaxnreg` lowers it to 24 registers a
//     thread; one thread loads Q once and streams K and V tiles through
//     rings of STAGES slots with TMA (`cp.async.bulk.tensor.4d` on tensor
//     maps over (d, h, s, b), built by the launcher from the element
//     strides; 64 x 64-column boxes, 128-byte swizzle, exactly the layout
//     the wgmma descriptors read).  Each slot has a full mbarrier (the
//     producer's arrive.expect_tx, completed by the copy's bytes) and an
//     empty one (one arrival from each consumer warp).  K and V have rings
//     of their own, since K_j is free once S_j is computed and V_j only
//     after P_j.V_j a tile later.
//   warpgroups 1 and 2, the consumers, 240 registers a thread: each owns
//     64 of the q rows and all of O's columns for them, so S is computed
//     once for each (query row, key): hd + hdv hd-units a row and tile (512
//     at (256, 256), 320 at (192, 128)), where the two-warpgroup CTA this
//     replaces computed S in both warpgroups (768 at (256, 256)).  O is
//     hdv / 2 floats a thread (128 at (256, 256)), S 32, P 16.  At (192,
//     128) Q also moves into registers once (48 a thread): S then takes
//     A from registers and reads only K from shared memory, where S as
//     m64n64k16 with both operands there is held to shared memory's rate
//     (3% of the kernel's time on an H100 80GB HBM3, measured with
//     tools/compare_flash_forward.py).  At (256, 256) there is no room
//     for Q.
// The softmax folds the score scale into the exponent (one fma and the
// flush-to-zero ex2 an element, the max over raw scores): 9% and 7% of
// the kernel's time at (192, 128) and (256, 256) against a scale, a
// subtract and exp2f an element (H100 80GB HBM3, the same tool).
// Softmax beside the products: the consumers take turns on two named
// barriers (`bar.sync id, 256`, the other warpgroup's `bar.arrive`).  In
// its turn a consumer issues O += P_{j-1}.V_{j-1} and S_j = Q.K_j^T as one
// wgmma group and hands the turn over; it then waits for its group, frees
// K_j and V_{j-1}, and runs the softmax of S_j and O's rescale while the
// other consumer's group runs on the tensor cores.  The first tile's S and
// the last tile's P.V run in turns of their own, so every turn is the
// same straight-line code: no wgmma under a branch on the warpgroup (the
// role is a warp-uniform `__shfl_sync` value, branched on once), and no
// accumulator is read or written between a group's issue and its wait
// (`fence_regs` pins them).  Both consumers walk the CTA's whole key
// range; a tile that masks all of one warpgroup's rows changes neither
// its m, l nor O (exact, as in the float32 kernel), and costs the lower
// warpgroup about one tile on the causal diagonal.  Rows past Sq and keys
// past Sk arrive as zeros (TMA clips each box per dimension, so a box never
// crosses into the next head or batch); keys past Sk are masked in the
// softmax as in the tc kernel, rows past Sq are not stored.  The q tiles
// run longest-reach first, as in the tc kernel.
//   (192, 128): Q 48 KiB (two warpgroups' 64 rows), 3 stages of K (24 KiB)
//     and V (16 KiB): 168 KiB + 1 KiB alignment slack.
//   (256, 256): Q 64 KiB, 2 stages of K (32 KiB) and V (32 KiB): 192 KiB +
//     1 KiB.
// Barriers are static shared memory (8 bytes each, 1 + 4 STAGES; ptxas
// counts 1,024 bytes, the alignment of the dynamic tiles after them).
// ptxas: 168 registers at the launch bound (384 threads), the consumers
// 240 after `setmaxnreg`, the producer 24 (128 x 24 + 256 x 240 = 64,512
// of 65,536); no spill, no C7520 or C7515 note.  A ring of 2, 3 or 4
// stages timed the same at (192, 128) (the same tool), so it keeps 3.
// What still does not overlap: within one consumer the softmax waits for
// its own S (only the other consumer's group covers it), and the output
// is stored from registers after the last tile; the grid is not
// persistent, so one CTA's epilogue does not overlap the next one's loads;
// GQA heads are not packed per K/V tile (their K / V come from L2).
//
// Alignment: cp.async and TMA move 16-byte pieces, so q, k, v and o must
// start on a 16-byte boundary and their b, s and h strides must be
// multiples of 8 elements; the wrapper checks and raises, and
// `fa_forward_tc` refuses.

namespace tc {

constexpr int BQ = 64;              // q rows per CTA: one warpgroup
constexpr int BK = 64;              // keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Bit i: does the thread's score s[i] of a tile (row q + 8 ((i % 4) / 2),
// key k + 8 (i / 4) + (i & 1)) pair a query with a key it attends?
__device__ __forceinline__ uint32_t valid_bits(const Params& p, int q,
                                               int k) {
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qp = q + 8 * ((i % 4) / 2), kp = k + 8 * (i / 4) + (i & 1);
    const bool ok = (kp < p.sk) & (!p.causal | (qp >= kp)) &
                    ((p.window <= 0) | (qp - kp < p.window));
    valid |= static_cast<uint32_t>(ok) << i;
  }
  return valid;
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
  const uint32_t valid = MASK ? valid_bits(p, q, k) : 0xFFFFFFFFu;
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

// the first key tile and one past the last (tiles of TK keys) that a q
// range starting at query position qpos_lo with `rows` rows can reach
// (attention.py:164-172)
template <int TK = BK>
__device__ __forceinline__ void key_range(const Params& p, int qpos_lo,
                                          int rows, int& lo, int& hi) {
  const int nk = (p.sk + TK - 1) / TK;
  hi = nk;
  if (p.causal) hi = min(nk, (qpos_lo + rows + TK - 1) / TK);
  lo = 0;
  if (p.window > 0) {
    const int first = qpos_lo - p.window + 1;
    lo = first > 0 ? first / TK : 0;
  }
}

// does the key tile of TK keys at k0 hold a masked pair for the rows
// from qpos?
template <int TK = BK>
__device__ __forceinline__ bool edge_tile(const Params& p, int qpos,
                                          int rows, int k0) {
  return k0 + TK > p.sk || (p.causal && k0 + TK - 1 > qpos) ||
         (p.window > 0 && qpos + rows - 1 - k0 >= p.window);
}

// P's A fragments (bf16) from the S fragments, 16 keys per k-step
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q.K^T over HD: k16 steps 32 bytes apart inside a 128-byte swizzle
// row, 8 KiB apart across the 64-column atoms
template <int HDP>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t qt,
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    wgmma_ss_n64(s, desc(qt + off, 16, 1024), desc(kt + off, 16, 1024),
                 kk > 0);
  }
}

template <int HD, int HDV>
constexpr int smem_bytes() {
  // Q, two K stages, two V stages, and slack to align to 1,024 bytes
  return 3 * 64 * hd_padded<HD>() * 2 + 2 * 64 * hd_padded<HDV>() * 2 + 1024;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const Params p) {
  constexpr int HDP = hd_padded<HD>();
  constexpr int HDVP = hd_padded<HDV>();
  static_assert(HD % 8 == 0 && HDV % 8 == 0 && HDP % 64 == 0 &&
                    (HDVP == 64 || HDVP == 128) && HD <= 128,
                "16-byte chunks; whole swizzle atoms; wgmma N of 64 or 128");
  constexpr int TILE = 64 * HDP * 2;    // bytes of one Q or K tile
  constexpr int VTILE = 64 * HDVP * 2;  // bytes of one V tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t qs = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t ks = qs + TILE;
  const uint32_t vs = ks + 2 * TILE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
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

  const int qpos_lo = p.q_offset + q0;
  int lo, hi;
  key_range(p, qpos_lo, rows, lo, hi);

  load_tile<HD, HDP>(qs, q, p.q_ss, rows, tid);
  if (lo < hi) {
    const int k0 = lo * BK;
    load_tile<HD, HDP>(ks, k + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
    load_tile<HDV, HDVP>(vs, v + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
  }
  cp_async_commit();

  // accumulator fragments: warp w holds rows 16 w + g and 16 w + g + 8,
  // columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-wide block j
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = warp * 16;
  const float sl2 = p.scale * LOG2E;
  float acc[HDVP / 2];
#pragma unroll
  for (int j = 0; j < HDVP / 2; ++j) acc[j] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this thread's part of the running sums

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {  // the next tile streams in while this one runs
      const int k1 = (kt + 1) * BK;
      load_tile<HD, HDP>(ks + (st ^ 1) * TILE, k + k1 * p.k_ss, p.k_ss,
                         p.sk - k1, tid);
      load_tile<HDV, HDVP>(vs + (st ^ 1) * VTILE, v + k1 * p.v_ss, p.v_ss,
                           p.sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t kst = ks + st * TILE;
    const uint32_t vst = vs + st * VTILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
    issue_s<HDP>(s, qs, kst);
    wgmma_commit();
    wgmma_wait_all();

    const int k0 = kt * BK;
    float alpha[2];
    if (edge_tile(p, qpos_lo, rows, k0))
      softmax_tile<true>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                         k0 + 2 * t4, sl2);
    else
      softmax_tile<false>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                          k0 + 2 * t4, sl2);
#pragma unroll
    for (int j = 0; j < HDVP / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P.V: V's 16 key rows per step are two 1,024-byte atoms (SBO) and
    // its 64-column halves 8 KiB apart (LBO)
    uint32_t a[4][4];
    pack_p(s, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(vst + kk * 2048, 8192, 1024);
      if constexpr (HDVP == 128)
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
    // m_r is in log2 units: lse = m_r ln 2 + log(l), natural units
    if (p.lse != nullptr && t4 == 0 && row < rows)
      p.lse[static_cast<long long>(blockIdx.x) * p.sq + q0 + row] =
          m_r[r] * LN2 + logf(fmaxf(l, 1e-30f));
    if (row < rows) {
      __nv_bfloat16* orow = o + row * p.o_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ------------------------------------------- the warp-specialised CTA
// flash_attention_ws_kernel<HD, HDV, MODE>: a TMA producer and two
// consumer warpgroups of 64 query rows each, taking turns on the tensor
// cores.  MODE PLAIN past hd 128 (every launch there).  MODE SPLIT at
// (64, 64), which the wrapper's forward_plan picks from the shapes for a
// launch without a mask (no causal diagonal, no window) of at least 128
// queries whose b H ceil(Sq / 128) CTAs leave SMs idle; other (64, 64)
// launches take flash_attention_tc_kernel.
//
// What bounds it there.  whisper-tiny's encoder, (1, 1500, 1500, 6, 6),
// is 3.5 GFLOP (0.0035 ms at 989 TFLOP/s) on 4.6 MB (0.0014 ms at 3.35
// TB/s); the one-warpgroup kernel's 144 CTAs of 64 rows each walk 24
// dependent key tiles and took 0.030 ms on an H100 80GB HBM3: its time is
// the chain of tile steps in a CTA, and 12 SMs stay idle.
//
// What the design does about that.  A cluster of S CTAs (S <= MAX_SPLIT,
// as many as the SMs hold at once) shares one (b, h, 128-row q tile) and
// splits its key range: CTA r walks key tiles [n r / S, n (r + 1) / S)
// (whisper's encoder: 72 q tiles x 3 = 216 CTAs of 8 tiles each, in one
// wave of two CTAs an SM).  Each then writes its O, m and l (in fragment
// order) into its own freed ring, and after a cluster barrier rank 0 reads
// the others' through distributed shared memory and sums them in rank
// order (the same bits every run), then writes o and lse.  Two CTAs share
// an SM: the producer is one warp after the two consumer warpgroups (288
// threads, no setmaxnreg: a producer warpgroup left the consumers too few
// of the registers two CTAs an SM allow), Q is read from shared memory,
// and a consumer issues S_j and P_j.V_j in turns of their own, so one
// accumulator is in flight at a time (issued together, as past hd 128,
// they drew ptxas's C7512 note: wgmma serialised for want of registers).
namespace ws {

constexpr int BQ = 128;             // q rows per CTA: two consumers of 64
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int TURN = 256;           // threads on a turn's named barrier
constexpr int PLAIN = 0, SPLIT = 1;  // no cluster, or the key range split
constexpr int MAX_SPLIT = 4;        // CTAs a split cluster

template <int HD, int HDV>
__host__ __device__ constexpr int stages() {
  return HD + HDV > 320 ? 2 : 3;
}

// CTAs an SM: two at (64, 64)
template <int HD, int HDV>
__host__ __device__ constexpr int ctas_per_sm() {
  return HD + HDV <= 128 ? 2 : 1;
}

// threads a CTA: two consumer warpgroups and a producer warpgroup (its
// registers given to the consumers by setmaxnreg), or at two CTAs an SM
// the consumers then one producer warp
template <int HD, int HDV>
__host__ __device__ constexpr int threads() {
  return ctas_per_sm<HD, HDV>() == 2 ? 2 * 128 + 32 : THREADS;
}

// 64 x 64-column boxes of Q (two warpgroups), the K and V rings, and slack
// to align to 1,024 bytes
template <int HD, int HDV>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * 64 * HD * 2 + stages<HD, HDV>() * 64 * (HD + HDV) * 2 + 1024;
}

// Q as S's register operand where the registers allow it (hd / 4 a
// thread beside O's hdv / 2): only K is then read from shared memory
template <int HD, int HDV>
__host__ __device__ constexpr bool q_in_registers() {
  return HD + HDV <= 320 && ctas_per_sm<HD, HDV>() == 1;
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softmax_tile with the score scale folded into the exponent: the row max
// is taken over the raw scores (the scale is positive, so it commutes with
// the max and its rounding), and each p is exp2(fma(s, scale, -m)) on the
// flush-to-zero ex2 (a p below 2^-126 is 0; P is rounded to bf16 anyway).
// m_r, l_r and alpha mean what they mean in softmax_tile.
template <bool MASK>
__device__ __forceinline__ void softmax_tile_fma(float (&s)[32],
                                                 float (&m_r)[2],
                                                 float (&l_r)[2],
                                                 float (&alpha)[2],
                                                 const Params& p, int q,
                                                 int k, float sl2) {
  const uint32_t valid = MASK ? valid_bits(p, q, k) : 0xFFFFFFFFu;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (MASK) s[i] = ((valid >> i) & 1u) ? s[i] : NEG;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m_r[r], mx[r] == NEG ? NEG : mx[r] * sl2);
    alpha[r] = ex2_ftz(m_r[r] - m_new[r]);
    m_r[r] = m_new[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float pe = ex2_ftz(fmaf(s[i], sl2, -m_new[(i % 4) / 2]));
    if (MASK) pe = ((valid >> i) & 1u) ? pe : 0.f;  // p = exp(s - m) * valid
    s[i] = pe;
    rs[(i % 4) / 2] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
}

template <int HD, int HDV, int MODE>
__global__ void __launch_bounds__(threads<HD, HDV>(), ctas_per_sm<HD, HDV>())
flash_attention_ws_kernel(const __grid_constant__ Params p,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv) {
  constexpr int NS = stages<HD, HDV>();
  constexpr int QT = 64 * HD * 2;   // bytes of one warpgroup's Q, one K tile
  constexpr int VT = 64 * HDV * 2;  // bytes of one V tile
  constexpr int OW = HDV > 128 ? 128 : HDV;  // O's column blocks: wgmma N
  constexpr int NH = HDV / OW;               // and their count
  static_assert(HD % 64 == 0 && (HDV == 64 || HDV % 128 == 0),
                "whole 64-column boxes; O in 64- or 128-column blocks");
  static_assert((MODE == PLAIN) == (HD > 128), "a split up to hd 128");
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  // q full; K full, K empty, V full, V empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 4 * NS];
  const uint32_t qs = (smem_u32(ws_smem) + 1023u) & ~1023u;
  const uint32_t ks = qs + 2 * QT;
  const uint32_t vs = ks + NS * QT;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * NS;
  const uint32_t v_full = k_empty + 8 * NS, v_empty = v_full + 8 * NS;

  // a split's cluster: its CTAs share (b, h) and the q tile
  int bh = blockIdx.x, rank = 0, nrank = 1;
  if constexpr (MODE == SPLIT) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    nrank = static_cast<int>(cluster.num_blocks());
    bh = blockIdx.x / nrank;
  }
  const int nqt = (p.sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = bh / p.h;
  const int head = bh % p.h;
  const int kvh = head / p.g;
  int lo, hi;
  key_range(p, p.q_offset + q0, min(BQ, p.sq - q0), lo, hi);
  if constexpr (MODE == SPLIT) {  // this CTA's share of the key tiles
    const int all = hi - lo;
    hi = lo + all * (rank + 1) / nrank;
    lo += all * rank / nrank;
  }
  const int n = hi - lo;  // key tiles of the CTA: the same for both consumers

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform role: 0 the producer, 1 and 2 the consumers (warpgroups
  // 1 and 2, or 0 and 1 before a producer warp)
  constexpr bool WARP_PRODUCER = threads<HD, HDV>() != THREADS;
  const int lead = WARP_PRODUCER ? 2 * 128 : 0;  // the producer's thread
  const int role = __shfl_sync(
      0xffffffffu,
      WARP_PRODUCER ? (threadIdx.x < 2 * 128 ? 1 + threadIdx.x / 128 : 0)
                    : threadIdx.x / 128,
      0);
  if (role == 0) {
    if constexpr (!WARP_PRODUCER)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == lead && n > 0) {
      mbar_expect_tx(q_full, 2 * QT);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          tma_load_4d(qs + w * QT + c * 8192, &tq, q_full, c * 64, head,
                      q0 + 64 * w, b);
      for (int j = 0; j < n; ++j) {
        const int st = j % NS;
        const uint32_t ph = (j / NS) & 1;
        const int k0 = (lo + j) * BK;
        mbar_wait(k_empty + 8 * st, ph ^ 1);  // a fresh slot passes
        mbar_expect_tx(k_full + 8 * st, QT);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          tma_load_4d(ks + st * QT + c * 8192, &tk, k_full + 8 * st, c * 64,
                      kvh, k0, b);
        mbar_wait(v_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(v_full + 8 * st, VT);
#pragma unroll
        for (int c = 0; c < HDV / 64; ++c)
          tma_load_4d(vs + st * VT + c * 8192, &tv, v_full + 8 * st, c * 64,
                      kvh, k0, b);
      }
    }
    if constexpr (MODE == SPLIT) {  // the consumers' two around the
      cg::this_cluster().sync();    // hand-over
      cg::this_cluster().sync();
    }
    return;
  }
  if constexpr (!WARP_PRODUCER)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = role - 1;
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = warp * 16;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const int qpos = p.q_offset + qw;
  const int rows = max(0, min(64, p.sq - qw));
  const uint32_t qt = qs + wg * QT;
  const int mine = 1 + wg, other = 2 - wg;  // named barriers of the turns
  const float sl2 = p.scale * LOG2E;

  float acc[NH][OW / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < OW / 2; ++j) acc[h][j] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this thread's part of the running sums
  float s[32];
  uint32_t a[4][4];
  constexpr bool QREG = q_in_registers<HD, HDV>();
  uint32_t aq[QREG ? HD / 16 : 1][4];  // Q's A fragments (QREG)
  // S = Q.K^T for the K tile at kt, Q from registers or shared memory
  auto issue_qk = [&](uint32_t kt) {
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n64_k(s, aq[kk],
                       desc(kt + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024),
                       kk > 0);
    } else {
      issue_s<HD>(s, qt, kt);
    }
  };

  // the softmax of tile lo + j in s, O rescaled (not before the first)
  auto softmax = [&](int j, bool rescale) {
    const int k0 = (lo + j) * BK;
    float alpha[2];
    if (edge_tile(p, qpos, 64, k0))
      softmax_tile_fma<true>(s, m_r, l_r, alpha, p, qpos + wrow + g,
                             k0 + 2 * t4, sl2);
    else
      softmax_tile_fma<false>(s, m_r, l_r, alpha, p, qpos + wrow + g,
                              k0 + 2 * t4, sl2);
    if (rescale) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j2 = 0; j2 < OW / 8; ++j2) {
          acc[h][4 * j2 + 0] *= alpha[0];
          acc[h][4 * j2 + 1] *= alpha[0];
          acc[h][4 * j2 + 2] *= alpha[1];
          acc[h][4 * j2 + 3] *= alpha[1];
        }
    }
    pack_p(s, a);
  };
  // O += P.V for the V tile at vt: V's 16 key rows per k-step are two
  // 1,024-byte atoms (SBO), its 64-column atoms 8 KiB apart (LBO), each
  // 128-column block of O 16 KiB further
  auto issue_pv = [&](uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t dv = desc(vt + h * 16384 + kk * 2048, 8192, 1024);
        if constexpr (OW == 128)
          wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc[h]), a[kk], dv);
        else
          wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc[h]), a[kk], dv);
      }
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  };

  if (n > 0) {
    if (wg == 1) named_arrive(1, TURN);  // warpgroup 1's turn comes first
    mbar_wait(q_full, 0);
    if constexpr (QREG) {
      // aq[kk][e]: row g + 8 (e & 1), columns 16 kk + 2 t4 + 8 (e >> 1)
      // and the next one, read through the 128-byte swizzle
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wrow + g + 8 * (e & 1);
          const int c = 16 * kk + 2 * t4 + 8 * (e >> 1);
          const uint32_t addr = qt + (c / 64) * 8192 + r * 128 +
                                ((((c % 64) / 8) ^ (r % 8)) * 16) +
                                (c % 8) * 2;
          asm volatile("ld.shared.u32 %0, [%1];\n"
                       : "=r"(aq[kk][e])
                       : "r"(addr));
        }
    }
    // turn 0: S of the first tile
    mbar_wait(k_full, 0);
    named_sync(mine, TURN);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    issue_qk(ks);
    wgmma_commit();
    named_arrive(other, TURN);
    wgmma_wait_all();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty);
    softmax(0, false);
    // turn j: P_{j-1}.V_{j-1} and S_j in one group, or (two CTAs an SM)
    // in two turns, one accumulator in flight at a time
    for (int j = 1; j < n; ++j) {
      const int st = j % NS, pst = (j - 1) % NS;
      if constexpr (WARP_PRODUCER) {
        mbar_wait(v_full + 8 * pst, ((j - 1) / NS) & 1);
        named_sync(mine, TURN);
        fence_acc();
        wgmma_fence();
        issue_pv(vs + pst * VT);
        wgmma_commit();
        named_arrive(other, TURN);
        wgmma_wait_all();
        fence_acc();
        if (lane == 0) mbar_arrive(v_empty + 8 * pst);
        mbar_wait(k_full + 8 * st, (j / NS) & 1);
        named_sync(mine, TURN);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
        issue_qk(ks + st * QT);
        wgmma_commit();
        named_arrive(other, TURN);
        wgmma_wait_all();
        fence_regs(s);
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
      } else {
        mbar_wait(k_full + 8 * st, (j / NS) & 1);
        mbar_wait(v_full + 8 * pst, ((j - 1) / NS) & 1);
        named_sync(mine, TURN);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        fence_acc();
        wgmma_fence();
        issue_pv(vs + pst * VT);
        issue_qk(ks + st * QT);
        wgmma_commit();
        named_arrive(other, TURN);
        wgmma_wait_all();
        fence_regs(s);
        fence_acc();
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * st);
          mbar_arrive(v_empty + 8 * pst);
        }
      }
      softmax(j, true);
    }
    // the last turn: P.V of the last tile; warpgroup 2 takes no turn after
    // it, so it hands none over
    const int pst = (n - 1) % NS;
    mbar_wait(v_full + 8 * pst, ((n - 1) / NS) & 1);
    named_sync(mine, TURN);
    fence_acc();
    wgmma_fence();
    issue_pv(vs + pst * VT);
    wgmma_commit();
    if (wg == 0) named_arrive(other, TURN);
    wgmma_wait_all();
    fence_acc();
  }

  if constexpr (MODE == SPLIT) {
    // the hand-over: element e of consumer thread c (O's fragment, then m
    // and l of its two rows) at hand[e 256 + c] in the CTA's own ring,
    // free once both consumers are past their last tile
    constexpr int E = NH * OW / 2 + 4;
    static_assert(E * TURN * 4 <= NS * (QT + VT), "the hand-over fits");
    float* hand = reinterpret_cast<float*>(ws_smem + (ks - smem_u32(ws_smem)));
    const int c = wg * 128 + tid;
    named_sync(3, TURN);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < OW / 2; ++j)
        hand[(h * OW / 2 + j) * TURN + c] = acc[h][j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hand[(E - 4 + r) * TURN + c] = m_r[r];
      hand[(E - 2 + r) * TURN + c] = l_r[r];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's hand-over is written
    if (rank == 0) {
      // m, l and O of ranks 1.. summed into rank 0's in rank order
      float mx[2] = {m_r[0], m_r[1]};
      for (int w = 1; w < nrank; ++w) {
        const float* rh = cluster.map_shared_rank(hand, w);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r] = fmaxf(mx[r], rh[(E - 4 + r) * TURN + c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = exp2f(m_r[r] - mx[r]);
        l_r[r] *= e;
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int j = 0; j < OW / 8; ++j) {
            acc[h][4 * j + 2 * r] *= e;
            acc[h][4 * j + 2 * r + 1] *= e;
          }
      }
      for (int w = 1; w < nrank; ++w) {
        const float* rh = cluster.map_shared_rank(hand, w);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float e = exp2f(rh[(E - 4 + r) * TURN + c] - mx[r]);
          l_r[r] += rh[(E - 2 + r) * TURN + c] * e;
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int j = 0; j < OW / 8; ++j) {
              acc[h][4 * j + 2 * r] +=
                  rh[(h * OW / 2 + 4 * j + 2 * r) * TURN + c] * e;
              acc[h][4 * j + 2 * r + 1] +=
                  rh[(h * OW / 2 + 4 * j + 2 * r + 1) * TURN + c] * e;
            }
        }
      }
      m_r[0] = mx[0];
      m_r[1] = mx[1];
    }
    cluster.sync();  // rank 0 has read every hand-over
    if (rank != 0) return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = wrow + g + 8 * r;
    if (row < rows) {
      // m_r is in log2 units: lse = m_r ln 2 + log(l), natural units
      if (p.lse != nullptr && t4 == 0)
        p.lse[static_cast<long long>(bh) * p.sq + qw + row] =
            m_r[r] * LN2 + logf(fmaxf(l, 1e-30f));
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                            head * p.o_sh + (qw + row) * p.o_ss + 2 * t4;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < OW / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + OW * h + 8 * j) =
              __floats2bfloat162_rn(acc[h][4 * j + 2 * r] * inv,
                                    acc[h][4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime (no
// link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over (d, h, s, b) = (width, n[0], n[1], n[2]) with
// element strides st[] (h, s, b), in 64-column x 64-row boxes, 128-byte
// swizzle.  A dimension of length 1 is never stepped over (the wrapper
// passes stride 0): it gets the packed stride.
bool encode(CUtensorMap* map, const void* base, int width, const int (&n)[3],
            const long long (&st)[3]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), 0, 0, 0};
  cuuint64_t strides[3];
  long long packed = width;
  for (int i = 0; i < 3; ++i) {
    const long long s = n[i] == 1 || st[i] == 0 ? packed : st[i];
    dims[i + 1] = static_cast<cuuint64_t>(n[i]);
    strides[i] = static_cast<cuuint64_t>(s) * 2;
    packed = s * n[i];
  }
  const cuuint32_t box[4] = {64, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch: PLAIN on a grid of (b h, q tiles); SPLIT with a cluster of
// `cluster` CTAs along x, `cluster` CTAs a (b, h)
template <int HD, int HDV, int MODE>
cudaError_t launch(const Params& p, int batch_heads, int cluster,
                   cudaStream_t stream) {
  if (MODE == SPLIT ? cluster < 2 || cluster > MAX_SPLIT : cluster != 1)
    return cudaErrorInvalidValue;
  const int batch = batch_heads / p.h, hkv = p.h / p.g;
  alignas(64) CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, HD, {p.h, p.sq, batch}, {p.q_sh, p.q_ss, p.q_sb}) ||
      !encode(&tk, p.k, HD, {hkv, p.sk, batch}, {p.k_sh, p.k_ss, p.k_sb}) ||
      !encode(&tv, p.v, HDV, {hkv, p.sk, batch}, {p.v_sh, p.v_ss, p.v_sb}))
    return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<HD, HDV>();
  auto kernel = flash_attention_ws_kernel<HD, HDV, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nqt = (p.sq + BQ - 1) / BQ;
  if constexpr (MODE == PLAIN) {
    kernel<<<dim3(batch_heads, nqt), THREADS, bytes, stream>>>(p, tq, tk, tv);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch_heads * cluster, nqt);
    cfg.blockDim = dim3(threads<HD, HDV>());
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, p, tq, tk, tv);
  }
}

}  // namespace ws

// ----------------------------- the narrow CTAs at (24, 16), short key ranges
// flash_attention_narrow_kernel: DeepSeek-V2-Lite's smoke pair (24, 16)
// where the keys number at most narrow::MAX_KEYS (256), chosen by the
// wrapper's forward_plan from the shapes alone (`fa_forward_narrow`);
// longer key ranges take flash_attention_tc_kernel<24, 16>.
//
// What bounds it.  At the smoke's (2, 256, 256, 4, 4) causal the live
// work is 2 (24 + 16) x 8 heads x 32,896 pairs = 21 MFLOP against 328 KB
// of q, k, v and o: 0.1 us on the bytes, 0.02 us on the tensor cores.
// Neither binds: an empty launch takes 0.9 us of device time on an H100
// 80GB HBM3 (chip_smoke.py's mla_smoke row), and the tc
// kernel's CTA of the last q tile walks its four key tiles in a strict
// chain (copy, S, wait, softmax, P.V, wait, barrier) on widths padded to
// 64.
//
// What the design does about that.  A cluster of WG = 4 CTAs of one
// warpgroup each owns one (b, h, 64-row q tile): CTA r loads Q and the
// r-th key tile of the q tile's range (lo + r) and computes, for that tile
// alone, S = Q.K^T (m64n64k16, both K-major), its softmax in registers
// (scale folded into the exponent, flush-to-zero ex2, as the
// warp-specialised kernel's) and O = P.V (m64n16k16, V MN-major), so no
// CTA walks more than one tile.  CTAs 1..3 then push their O, m and l (12
// floats a thread, in fragment order) into CTA 0's shared memory through
// the cluster's distributed shared memory; after one cluster barrier CTA 0
// rescales and sums them in rank order (the same bits every run) and
// writes o and lse.  A tile past the range is zero-filled and masked
// whole, so every CTA runs the same code.  Widths are padded only to the
// next k16 step: q.k's 24 to 32 (64-byte rows, 64-byte swizzle: S in two
// k-steps, not four), v's 16 stays 16 (32-byte rows, 32-byte swizzle: P.V
// at N = 16, not 64).  Shared memory a CTA: Q 4 KiB, K 4 KiB, V 2 KiB, the
// hand-over 18 KiB.  Every case of the tc kernel holds: causal or not,
// window, GQA, q_offset, ragged Sq and Sk, lse.
// (A first layout, one CTA of four warpgroups a q tile with the hand-over
// in its own shared memory, took 0.0063 ms of device time at the smoke's
// shape against the tc kernel's 0.0066; leaving its softmax out saved
// 0.0021 ms and its K / V loads 0.0010 (tools/ablate_flash_narrow.py):
// four tiles' scalar work issued from one SM, sixteen warps on its four
// schedulers.)
namespace narrow {

constexpr int WG = 4;                // CTAs a cluster: one key tile each
constexpr int THREADS = 128;         // one warpgroup a CTA
constexpr int MAX_KEYS = WG * BK;    // the keys a cluster holds at once
constexpr int HANDOVER = 12;         // floats a thread: O's 8, m and l x 2

template <int HD, int HDV>
constexpr int smem_bytes() {
  // Q, the CTA's K and V tiles, the hand-over of WG - 1 CTAs (read in
  // rank 0), and slack to align to 1,024 bytes
  return 2 * 64 * k16_padded<HD>() * 2 + 64 * k16_padded<HDV>() * 2 +
         (WG - 1) * HANDOVER * 128 * 4 + 1024;
}

template <int HD, int HDV>
__global__ void __cluster_dims__(WG, 1, 1) __launch_bounds__(THREADS)
flash_attention_narrow_kernel(const Params p) {
  constexpr int HDP = k16_padded<HD>(), HDVP = k16_padded<HDV>();
  static_assert(HD % 8 == 0 && HDV % 8 == 0 && HDP <= 64 && HDVP == 16,
                "16-byte chunks; rows of at most 128 bytes; O at N = 16");
  constexpr int KT = 64 * HDP * 2;   // bytes of the Q tile or a K tile
  constexpr int VT = 64 * HDVP * 2;  // bytes of a V tile
  extern __shared__ __align__(1024) unsigned char nw_smem[];
  const uint32_t s0 = smem_u32(nw_smem);
  const uint32_t qs = (s0 + 1023u) & ~1023u;
  const uint32_t ks = qs + KT;
  const uint32_t vs = ks + KT;
  float* hand = reinterpret_cast<float*>(nw_smem + (vs + VT - s0));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, wrow = warp * 16;
  const int bh = blockIdx.x / WG;
  const int nqt = (p.sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = bh / p.h;
  const int head = bh % p.h;
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

  const int qpos_lo = p.q_offset + q0;
  int lo, hi;
  key_range(p, qpos_lo, rows, lo, hi);
  // this CTA's key tile (past the range: zeros, masked whole)
  const int k0 = (lo + rank) * BK;
  const bool live = lo + rank < hi;
  load_narrow<HD, HDP, THREADS>(qs, q, p.q_ss, rows, BQ, tid);
  load_narrow<HD, HDP, THREADS>(ks, live ? k + k0 * p.k_ss : k, p.k_ss,
                                live ? p.sk - k0 : 0, BK, tid);
  load_narrow<HDV, HDVP, THREADS>(vs, live ? v + k0 * p.v_ss : v, p.v_ss,
                                  live ? p.sk - k0 : 0, BK, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  // S = Q.K^T: k16 steps 32 bytes apart in the 2 HDP-byte rows, 8-row
  // groups 16 HDP bytes apart
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss_n64(s, desc_row<2 * HDP>(qs + kk * 32, 16, 16 * HDP),
                 desc_row<2 * HDP>(ks + kk * 32, 16, 16 * HDP), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // the tile's softmax; a tile past the range holds no attended pair, and
  // every such tile is an edge tile, so it leaves m = -1e30, l = 0, P = 0
  const float sl2 = p.scale * LOG2E;
  float m_r[2] = {NEG, NEG};  // row max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
  float alpha[2];
  if (edge_tile(p, qpos_lo, rows, k0))
    ws::softmax_tile_fma<true>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                               k0 + 2 * t4, sl2);
  else
    ws::softmax_tile_fma<false>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                                k0 + 2 * t4, sl2);

  // O = P.V: V's 16 key rows per step are 16 rows of 2 HDVP bytes, its
  // 8-row groups 16 HDVP bytes apart (SBO)
  float acc[HDVP / 2];
#pragma unroll
  for (int j = 0; j < HDVP / 2; ++j) acc[j] = 0.f;
  uint32_t a[4][4];
  pack_p(s, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n16(acc, a[kk],
                 desc_row<2 * HDVP>(vs + kk * 32 * HDVP, VT, 16 * HDVP));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);

  // the hand-over: CTA r > 0 stores element j of thread t into rank 0's
  // hand[((r - 1) HANDOVER + j) 128 + t]
  if (rank > 0) {
    float* h = cluster.map_shared_rank(hand, 0) +
               (rank - 1) * HANDOVER * 128 + tid;
#pragma unroll
    for (int j = 0; j < HDVP / 2; ++j) h[j * 128] = acc[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      h[(8 + r) * 128] = m_r[r];
      h[(10 + r) * 128] = l_r[r];
    }
  }
  cluster.sync();  // every hand-over has landed in rank 0
  if (rank > 0) return;

  // rank 0 sums the four (m, l, O) in rank order
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int w = 1; w < WG; ++w)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(mx[r], hand[((w - 1) * HANDOVER + 8 + r) * 128 + tid]);
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float e = exp2f(m_r[r] - mx[r]);
    l[r] = l_r[r] * e;
#pragma unroll
    for (int j = 0; j < HDVP / 8; ++j) {
      acc[4 * j + 2 * r] *= e;
      acc[4 * j + 2 * r + 1] *= e;
    }
  }
#pragma unroll
  for (int w = 1; w < WG; ++w) {
    const float* h = hand + (w - 1) * HANDOVER * 128 + tid;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = exp2f(h[(8 + r) * 128] - mx[r]);
      l[r] += h[(10 + r) * 128] * e;
#pragma unroll
      for (int j = 0; j < HDVP / 8; ++j) {
        acc[4 * j + 2 * r] += h[(4 * j + 2 * r) * 128] * e;
        acc[4 * j + 2 * r + 1] += h[(4 * j + 2 * r + 1) * 128] * e;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = wrow + g + 8 * r;
    // mx is in log2 units: lse = mx ln 2 + log(l), natural units
    if (p.lse != nullptr && t4 == 0 && row < rows)
      p.lse[static_cast<long long>(bh) * p.sq + q0 + row] =
          mx[r] * LN2 + logf(fmaxf(lr, 1e-30f));
    if (row < rows) {
      __nv_bfloat16* orow = o + row * p.o_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD, int HDV>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  if (p.sk > MAX_KEYS) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<HD, HDV>();
  auto kernel = flash_attention_narrow_kernel<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // a cluster of WG CTAs (__cluster_dims__) per (b, h, q tile)
  const dim3 grid(batch_heads * WG, (p.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace narrow

template <int HD, int HDV>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  if constexpr (HD > 128) {
    return ws::launch<HD, HDV, ws::PLAIN>(p, batch_heads, 1, stream);
  } else {
    constexpr int bytes = smem_bytes<HD, HDV>();
    auto kernel = flash_attention_tc_kernel<HD, HDV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(batch_heads, (p.sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, bytes, stream>>>(p);
    return cudaGetLastError();
  }
}

// out[3..5] of a kernel whose out[1] dynamic shared memory bytes are set:
// after the launch's own cudaFuncSetAttribute, cudaFuncGetAttributes'
// static shared memory, registers and maximum dynamic shared memory
cudaError_t loaded_attributes(const void* kernel, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[1]);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = attr.numRegs;
  out[5] = attr.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

// What a launch at (HD, HDV) uses, from the source and the loaded kernel:
// threads, dynamic shared memory bytes, q rows a CTA, then (after the
// launch's own cudaFuncSetAttribute) cudaFuncGetAttributes' static shared
// memory, registers and maximum dynamic shared memory.
template <int HD, int HDV>
cudaError_t attributes(int* out) {
  const void* kernel;
  if constexpr (HD > 128) {
    kernel = reinterpret_cast<const void*>(
        ws::flash_attention_ws_kernel<HD, HDV, ws::PLAIN>);
    out[0] = ws::THREADS;
    out[1] = ws::smem_bytes<HD, HDV>();
    out[2] = ws::BQ;
  } else {
    kernel = reinterpret_cast<const void*>(flash_attention_tc_kernel<HD, HDV>);
    out[0] = THREADS;
    out[1] = smem_bytes<HD, HDV>();
    out[2] = BQ;
  }
  return loaded_attributes(kernel, out);
}

#define FA_TC_PAIRS(X)                                                 \
  X(16, 16) X(24, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 128)      \
  X(256, 256)

cudaError_t dispatch(const Params& p, int hd, int hdv, int batch_heads,
                     cudaStream_t stream) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return launch<A, B>(p, batch_heads, stream);
    FA_TC_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_attributes(int hd, int hdv, int* out) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return attributes<A, B>(out);
    FA_TC_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

// the pairs of the narrow CTA (short key ranges)
#define FA_NARROW_PAIRS(X) X(24, 16)

cudaError_t dispatch_narrow(const Params& p, int hd, int hdv,
                            int batch_heads, cudaStream_t stream) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return narrow::launch<A, B>(p, batch_heads, stream);
    FA_NARROW_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

// What the narrow CTA's launch uses, as `attributes` gives it
template <int HD, int HDV>
cudaError_t narrow_attributes(int* out) {
  const void* kernel = reinterpret_cast<const void*>(
      narrow::flash_attention_narrow_kernel<HD, HDV>);
  out[0] = narrow::THREADS;
  out[1] = narrow::smem_bytes<HD, HDV>();
  out[2] = BQ;
  return loaded_attributes(kernel, out);
}

cudaError_t dispatch_narrow_attributes(int hd, int hdv, int* out) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return narrow_attributes<A, B>(out);
    FA_NARROW_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

// the warp-specialised CTA split over a cluster: (64, 64) only
cudaError_t dispatch_split(const Params& p, int hd, int hdv, int cluster,
                           int batch_heads, cudaStream_t stream) {
  if (pair(hd, hdv) != pair(64, 64)) return cudaErrorInvalidValue;
  return ws::launch<64, 64, ws::SPLIT>(p, batch_heads, cluster, stream);
}

// What the split's launch uses, as `attributes` gives it
cudaError_t dispatch_split_attributes(int hd, int hdv, int* out) {
  if (pair(hd, hdv) != pair(64, 64)) return cudaErrorInvalidValue;
  out[0] = ws::threads<64, 64>();
  out[1] = ws::smem_bytes<64, 64>();
  out[2] = ws::BQ;
  return loaded_attributes(
      reinterpret_cast<const void*>(
          ws::flash_attention_ws_kernel<64, 64, ws::SPLIT>),
      out);
}

}  // namespace tc

// ------------------------------------------ float32 route on the tensor
// cores ("tf32x3")
// flash_attention_tf32_kernel<HD, HDV>: float32 operands at the pairs of
// the bfloat16 route, the products on the tensor cores as split TF32
// (flash_attention_common.cuh: x = hi + lo, each product hi.hi + hi.lo +
// lo.hi in float32, about 22 of float32's 24 bits).  It replaces, in
// float32, the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:102), as every forward kernel
// here does, and the FMA kernel above at these pairs.
//
// What bounds it: the three TF32 products, 3 x 2 (hd + hdv) FLOP a live
// (query, key) pair at 495 TFLOP/s (a third of the TF32 rate, 2.5x the
// CUDA cores' 67 TFLOP/s of float32 FMA); at DeepSeek-V2-Lite's prefill,
// (1, 2048, 2048, 16, 16) at (192, 128) causal, 0.130 ms against 0.019 ms
// of bytes.  The numerics are the FMA kernel's: scores scaled by
// 1/sqrt(hd) in float32, masked scores -1e30, the accurate expf, the
// output acc / max(l, 1e-30), lse = m + log(l) in natural units.
//
// One CTA is one warpgroup over one (b, h, 64-row q tile); it walks
// 32-key tiles from the window's first reachable tile to the causal reach
// (fully masked tiles are skipped by the loop bounds, exactly), the q
// tiles longest reach first.  Per tile:
//   S = Q.K^T  m64n32k8, HD / 8 k-steps of three wgmma each, each step
//              into a fresh accumulator added to S in float32
//              (gemm_tf32x3_rn: two steps in flight): A = Q from
//              registers, split there (the first 12 steps' fragments held
//              for the whole CTA at (192, 128), the rest read each tile
//              from Q's rows in shared memory, pitch width + 4 floats:
//              conflict-free); B = K (K-major, as stored) split into hi
//              and lo tiles, 128-byte swizzled, 32 floats an atom row.
//   O += P.V   m64nNk8 (N = hdv in chunks of at most 32), each chunk into
//              a fresh accumulator (two in flight), O = alpha O + it in
//              float32; A = P from the
//              S accumulators, split in registers; B must be K-major for
//              32-bit types (no transpose bit), so V is staged transposed:
//              a 4-byte cp.async scatter writes V^T (hdv rows of 32 keys)
//              and within each 8-key group puts key 2c + e at position c
//              + 4 e, the order in which the S accumulator fragment (keys
//              2 t4, 2 t4 + 1 of each 8) is the P.V A fragment (columns
//              t4, t4 + 4): no shuffle.
// Each tile of K and V^T is split where it lands (hi in place, lo beside
// it; 16-byte reads and writes at the same swizzled offsets).  K and V
// are one stage each, their copies split so that they overlap: K_{j+1}
// streams in while the softmax and P_j.V_j run, V_{j+1} while S_{j+1}
// does.  Shared memory: K and its lo part (32 x HD, padded to 32
// columns), V^T and its lo part (HDV x 32), Q's rows past the register
// steps, 1 KiB of alignment slack: 108,544 bytes at (192, 128) and
// 100,352 at (128, 128) (two CTAs an SM), 198,656 at (256, 256) (one),
// 51,200 at (64, 64).  All of Q in registers (96 floats at (192, 128))
// spilled and serialised the wgmma (C7512); with none, one CTA an SM
// took 1.67x the time there (tools/ablate_flash_tf32.py, an H100 80GB
// HBM3 at 700 W).  The float32 sums of fresh accumulators (S's steps,
// P.V's tiles) are the accuracy: the tensor cores truncate each wgmma's
// sum toward zero (gemm_tf32x3_rn); with S as a running sum the output's
// error was 3x (same tool), and with running sums throughout
// Llama-3.2-Vision's float32 prefill logits moved past the serving
// parity's bound.
// Alignment: 16-byte cp.async, so q, k, v and o start on 16-byte
// boundaries with b, s, h strides in multiples of 4 elements
// (`fa_forward_tf32` refuses others; the wrapper checks and raises).

namespace tf32 {

using namespace tc;

constexpr int BQ = 64;   // query rows a CTA: one warpgroup
constexpr int BK = 32;   // keys a tile
constexpr int THREADS = 128;

// a K-major tile's width, padded to whole 32-float atom rows
template <int W>
__host__ __device__ constexpr int w32() {
  return (W + 31) / 32 * 32;
}

template <int HD>
__host__ __device__ constexpr int k_bytes() {
  return BK * w32<HD>() * 4;
}

template <int HDV>
__host__ __device__ constexpr int v_bytes() {  // V^T: HDV rows of 32 keys
  return HDV * BK * 4;
}

// Q's k-steps held in registers as fragments (four floats a thread a
// step): the first 12 of 24 at (192, 128), so that its tiles fit two CTAs
// an SM; the rest, and every step at the other pairs, read from Q's rows
// in shared memory (at (128, 128) two CTAs fit without; all of (192,
// 128)'s 96 floats, or (256, 256)'s 128 beside O's, spill)
template <int HD>
__host__ __device__ constexpr int q_reg_steps() {
  return HD == 192 ? 12 : 0;
}

// Q's rows in shared memory: the columns past the register steps, pitch
// their width + 4 floats (conflict-free fragments)
template <int HD>
__host__ __device__ constexpr int q_pitch() {
  return HD - 8 * q_reg_steps<HD>() + 4;
}

template <int HD, int HDV>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * (k_bytes<HD>() + v_bytes<HDV>()) + BQ * q_pitch<HD>() * 4 +
         1024;
}

// V rows [0, n_valid) of a 32-key tile (row stride ss) into V^T at dst:
// row n of 32 keys (128 bytes, swizzled), key 8 kg + 2 kl + e at position
// 8 kg + kl + 4 e.  A warp's 32 copies are 4 keys x 8 columns: 32-byte
// global segments, 32 distinct banks.
template <int HDV>
__device__ __forceinline__ void load_vt(uint32_t dst, const float* src,
                                        long long ss, int n_valid, int tid) {
  const int lane = tid % 32, warp = tid / 32;
  const int kl = lane / 8, nl = lane % 8;
  constexpr int NB = HDV / 8;
#pragma unroll 4
  for (int u = warp; u < HDV; u += THREADS / 32) {  // BK * HDV / 32 units
    const int nb = u % NB, e = (u / NB) % 2, kg = u / NB / 2;
    const int key = 8 * kg + 2 * kl + e, n = 8 * nb + nl;
    const bool ok = key < n_valid;
    cp_async4(dst + n * 128 + (((2 * kg + e) ^ (n % 8)) * 16) + kl * 4,
              ok ? src + key * ss + n : src, ok);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
flash_attention_tf32_kernel(const Params p) {
  constexpr int KB = k_bytes<HD>(), VB = v_bytes<HDV>();
  constexpr int NV = HDV < 32 ? HDV : 32;  // P.V's N a wgmma
  constexpr int NCH = HDV / NV;
  static_assert(HD % 8 == 0 && HDV % 16 == 0 && HDV % NV == 0,
                "k8 steps; wgmma N of 16 or 32 a chunk");
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_u32(f32_smem);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t ks_lo = ks + KB, vs = ks_lo + KB, vs_lo = vs + VB;
  const uint32_t qs = vs_lo + VB;  // Q's rows past the register steps
  float* k_raw = reinterpret_cast<float*>(f32_smem + (ks - raw));
  float* k_lo = k_raw + KB / 4;
  float* v_raw = k_lo + KB / 4;
  float* v_lo = v_raw + VB / 4;
  const float* q_sm = v_lo + VB / 4;
  constexpr int QR = q_reg_steps<HD>(), QP = q_pitch<HD>();

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nqt = (p.sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.h;
  const int head = blockIdx.x % p.h;
  const int kvh = head / p.g;
  const int rows = min(BQ, p.sq - q0);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb +
                   head * p.q_sh + q0 * p.q_ss;
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + head * p.o_sh +
             q0 * p.o_ss;

  const int qpos_lo = p.q_offset + q0;
  int lo, hi;
  key_range<BK>(p, qpos_lo, rows, lo, hi);

  // accumulator fragments: warp w holds rows 16 w + g and 16 w + g + 8,
  // columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-wide block j
  const int wrow = warp * 16;
  // Q's fragments: a0 (row g, column 8 kk + t4), a1 (g + 8, the same), a2
  // and a3 four columns on; the register steps staged through the tile
  // area before the first K and V tiles, the rest read from Q's rows
  float qf[QR > 0 ? QR : 1][4];
  if constexpr (QR > 0) {
    constexpr int SP = 8 * QR + 4;  // the staged rows' pitch
    load_rows_f32<8 * QR, THREADS>(ks, q, p.q_ss, rows, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* sa = k_raw + (wrow + g) * SP + t4;
#pragma unroll
    for (int kk = 0; kk < QR; ++kk) {
      qf[kk][0] = sa[8 * kk];
      qf[kk][1] = sa[8 * SP + 8 * kk];
      qf[kk][2] = sa[8 * kk + 4];
      qf[kk][3] = sa[8 * SP + 8 * kk + 4];
    }
    __syncthreads();  // read before the tiles overwrite it
  }
  load_rows_f32<HD - 8 * QR, THREADS>(qs, q + 8 * QR, p.q_ss, rows, tid);
  const float* qa = q_sm + (wrow + g) * QP + t4 - 8 * QR;
  auto qfrag = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    float x[4];
    if (kk < QR) {  // kk is a constant of the unrolled loop
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qf[kk < QR ? kk : 0][i];
    } else {
      x[0] = qa[8 * kk];
      x[1] = qa[8 * QP + 8 * kk];
      x[2] = qa[8 * kk + 4];
      x[3] = qa[8 * QP + 8 * kk + 4];
    }
    tf32_split(x, hi, lo);
  };

  // Q's rows and the first K tile, then the first V tile: two commit
  // groups, and one of each a tile after them
  if (lo < hi)
    load_tile_f32<HD, THREADS>(ks, k + lo * BK * p.k_ss, p.k_ss,
                               p.sk - lo * BK, BK, tid);
  cp_async_commit();
  if (lo < hi)
    load_vt<HDV>(vs, v + lo * BK * p.v_ss, p.v_ss, p.sk - lo * BK, tid);
  cp_async_commit();

  float acc[NCH][NV / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) acc[c][j] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8
  float l_r[2] = {0.f, 0.f};  // this thread's part of the running sums

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<1>();  // K_kt (and Q): all but the newest group, V_kt
    __syncthreads();
    tile_split<THREADS>(k_raw, k_lo, KB, tid);
    fence_async_smem();
    __syncthreads();

    float s[BK / 2];
    gemm_tf32x3_rn<BK, HD / 8>(s, qfrag, ks, ks_lo, Steps<BK>{});
    __syncthreads();  // every warp is past S: K may be refilled
    if (kt + 1 < hi)
      load_tile_f32<HD, THREADS>(ks, k + (k0 + BK) * p.k_ss, p.k_ss,
                                 p.sk - k0 - BK, BK, tid);
    cp_async_commit();

    // online softmax in natural units: s[4 j + e] is row g + 8 (e / 2),
    // key k0 + 8 j + 2 t4 + (e & 1)
    uint32_t valid = 0xFFFFu;
    if (edge_tile<BK>(p, qpos_lo, rows, k0)) {
      valid = 0;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int qp = qpos_lo + wrow + g + 8 * ((i % 4) / 2);
        const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        const bool ok = (kp < p.sk) & (!p.causal | (qp >= kp)) &
                        ((p.window <= 0) | (qp - kp < p.window));
        valid |= static_cast<uint32_t>(ok) << i;
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ((valid >> i) & 1u) ? s[i] * p.scale : NEG;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pe = ((valid >> i) & 1u) ? expf(s[i] - m_r[(i % 4) / 2])
                                           : 0.f;
      s[i] = pe;
      rs[(i % 4) / 2] += pe;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
    // P's A fragments: k-step kk is keys 8 kk .. 8 kk + 7, column t4 key
    // 2 t4, column t4 + 4 key 2 t4 + 1 (V^T's order)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                          s[4 * kk + 3]};
      tf32_split(x, ph[kk], pl[kk]);
    }

    cp_async_wait<1>();  // V_kt: all but the newest group, K_kt+1
    __syncthreads();
    tile_split<THREADS>(v_raw, v_lo, VB, tid);
    fence_async_smem();
    __syncthreads();
    // P_j.V_j a chunk of NV of O's columns at a time, each into a fresh
    // accumulator (two in flight), O = alpha O + that in float32: a
    // running O drifts toward zero by an ulp of itself a wgmma
    // (gemm_tf32x3_rn), a fresh one by an ulp of the tile's share
    float t[2][NV / 2];
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) t[0][j] = t[1][j] = 0.f;
    auto add = [&](int c) {
      fence_regs(t[c & 1]);
#pragma unroll
      for (int j = 0; j < NV / 2; ++j)
        acc[c][j] = fmaf(acc[c][j], alpha[(j % 4) / 2], t[c & 1][j]);
    };
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * NV * 128 + kk * 32;
        wgmma_tf32x3<NV>(t[c & 1], ph[kk], pl[kk], desc(vs + off, 16, 1024),
                         desc(vs_lo + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();  // chunk c - 1 is done
        add(c - 1);
      }
    }
    wgmma_wait<0>();
    add(NCH - 1);
    __syncthreads();  // every warp is past P.V: V may be refilled
    if (kt + 1 < hi)
      load_vt<HDV>(vs, v + (k0 + BK) * p.v_ss, p.v_ss, p.sk - k0 - BK, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = wrow + g + 8 * r;
    if (p.lse != nullptr && t4 == 0 && row < rows)
      p.lse[static_cast<long long>(blockIdx.x) * p.sq + q0 + row] =
          m_r[r] + logf(l);
    if (row < rows) {
      float* orow = o + row * p.o_ss + 2 * t4;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < NV / 8; ++j)
          *reinterpret_cast<float2*>(orow + c * NV + 8 * j) = make_float2(
              acc[c][4 * j + 2 * r] / l, acc[c][4 * j + 2 * r + 1] / l);
    }
  }
}

template <int HD, int HDV>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, HDV>();
  auto kernel = flash_attention_tf32_kernel<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch_heads, (p.sq + BQ - 1) / BQ), THREADS, bytes,
           stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int HDV>
cudaError_t attributes(int* out) {
  out[0] = THREADS;
  out[1] = smem_bytes<HD, HDV>();
  out[2] = BQ;
  return tc::loaded_attributes(
      reinterpret_cast<const void*>(flash_attention_tf32_kernel<HD, HDV>),
      out);
}

cudaError_t dispatch(const Params& p, int hd, int hdv, int batch_heads,
                     cudaStream_t stream) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return launch<A, B>(p, batch_heads, stream);
    FA_TC_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_attributes(int hd, int hdv, int* out) {
  switch (pair(hd, hdv)) {
#define FA_CASE(A, B) \
  case pair(A, B): return attributes<A, B>(out);
    FA_TC_PAIRS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf32

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

// The tensor-core routes' operands: pointers on 16-byte boundaries and
// strides in multiples of 8 elements (cp.async, TMA), else
// cudaErrorMisalignedAddress; then the parameters
static cudaError_t make_tc_params(Params& p, const void* q, const void* k,
                                  const void* v, void* o, float* lse,
                                  const long long* strides, int batch,
                                  int sq, int sk, int h, int hkv, int causal,
                                  int window, int q_offset, float scale) {
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return cudaErrorMisalignedAddress;
  return make_params(p, q, k, v, o, lse, strides, batch, sq, sk, h, hkv,
                     causal, window, q_offset, scale);
}

// The tensor-core route: bfloat16, (hd, hdv) a pair of tc::dispatch;
// pointers on 16-byte boundaries and strides in multiples of 8 elements
// (cp.async, TMA).  cudaErrorInvalidValue also where the driver does not
// take a tensor map of the operands (past hd 128).
int fa_forward_tc(const void* q, const void* k, const void* v, void* o,
                  const long long* strides, int batch, int sq, int sk, int h,
                  int hkv, int hd, int hdv, int causal, int window,
                  int q_offset, float scale, float* lse, void* stream) {
  Params p;
  cudaError_t err = make_tc_params(p, q, k, v, o, lse, strides, batch, sq,
                                   sk, h, hkv, causal, window, q_offset,
                                   scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tc::dispatch(p, hd, hdv, batch * h,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The float32 route on the tensor cores (split TF32): float32, (hd, hdv)
// a pair of tf32::dispatch; pointers on 16-byte boundaries and strides in
// multiples of 4 elements (16-byte cp.async), else
// cudaErrorMisalignedAddress.  The arguments of `fa_forward_tc`.
int fa_forward_tf32(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int batch, int sq, int sk,
                    int h, int hkv, int hd, int hdv, int causal, int window,
                    int q_offset, float scale, float* lse, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Params p;
  cudaError_t err = make_params(p, q, k, v, o, lse, strides, batch, sq, sk,
                                h, hkv, causal, window, q_offset, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tf32::dispatch(p, hd, hdv, batch * h,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The tensor-core route's narrow CTA: the arguments of `fa_forward_tc`,
// (hd, hdv) a pair of tc::dispatch_narrow and sk at most
// tc::narrow::MAX_KEYS (else cudaErrorInvalidValue).
int fa_forward_narrow(const void* q, const void* k, const void* v, void* o,
                      const long long* strides, int batch, int sq, int sk,
                      int h, int hkv, int hd, int hdv, int causal,
                      int window, int q_offset, float scale, float* lse,
                      void* stream) {
  Params p;
  cudaError_t err = make_tc_params(p, q, k, v, o, lse, strides, batch, sq,
                                   sk, h, hkv, causal, window, q_offset,
                                   scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tc::dispatch_narrow(p, hd, hdv, batch * h,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The tensor-core route's warp-specialised CTA split over a cluster: the
// arguments of `fa_forward_tc`, then the CTAs a cluster that share a q
// tile's key range (2 <= cluster <= 4), (hd, hdv) (64, 64); else
// cudaErrorInvalidValue.
int fa_forward_split(const void* q, const void* k, const void* v, void* o,
                     const long long* strides, int batch, int sq, int sk,
                     int h, int hkv, int hd, int hdv, int causal, int window,
                     int q_offset, float scale, float* lse, int cluster,
                     void* stream) {
  Params p;
  cudaError_t err = make_tc_params(p, q, k, v, o, lse, strides, batch, sq,
                                   sk, h, hkv, causal, window, q_offset,
                                   scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tc::dispatch_split(p, hd, hdv, cluster, batch * h,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// What the tensor-core route's launch at (hd, hdv) uses (out: 6 ints):
// threads a CTA, dynamic shared memory bytes, q rows a CTA, static shared
// memory bytes, registers a thread, and the dynamic shared memory the
// kernel's attribute allows once the launch has set it.
int fa_forward_tc_attributes(int hd, int hdv, int* out) {
  return static_cast<int>(tc::dispatch_attributes(hd, hdv, out));
}

// The same for the warp-specialised CTA split over a cluster.
int fa_forward_split_attributes(int hd, int hdv, int* out) {
  return static_cast<int>(tc::dispatch_split_attributes(hd, hdv, out));
}

// The same for the narrow CTA at (hd, hdv).
int fa_forward_narrow_attributes(int hd, int hdv, int* out) {
  return static_cast<int>(tc::dispatch_narrow_attributes(hd, hdv, out));
}

// The same for the float32 route's tensor-core kernel at (hd, hdv).
int fa_forward_tf32_attributes(int hd, int hdv, int* out) {
  return static_cast<int>(tf32::dispatch_attributes(hd, hdv, out));
}

}  // extern "C"
