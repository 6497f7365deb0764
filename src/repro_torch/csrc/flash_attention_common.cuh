// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) sources: float32 loads and stores of
// either operand dtype, the (hd, hdv) pair key of the dispatchers, and the
// tensor-core primitives (cp.async copies, wgmma, the 128-byte-swizzled
// tile copy).  Each source includes it into its own anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the (hd, hdv) pairs of the repo's configs: hd == hdv for the GQA
// families and RecurrentGemma's (256, 256), (192, 128) for
// DeepSeek-V2-Lite's MLA and (24, 16) for its smoke config
constexpr int pair(int hd, int hdv) { return hd * 1024 + hdv; }

namespace tc {

constexpr int THREADS = 128;       // one warpgroup

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

// d (64 x 64 f32) = A (64 x 16 bf16, registers) . B^T (B 64 x 16, K-major
// in shared memory, descriptor); scale_d = 0 overwrites d, 1 accumulates
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

template <int HD>
__host__ __device__ constexpr int hd_padded() {
  return HD < 64 ? 64 : HD;
}

// --- narrow tiles (the (24, 16) kernels for short sequences): a width
// padded only to the next k16 step, its rows 2 W bytes in the 2 W-byte
// swizzle (32 or 64 bytes; 128 is the layout above)

template <int W>
__host__ __device__ constexpr int k16_padded() {
  return (W + 15) / 16 * 16;
}

// Byte offset of the 16-byte chunk c of row r in a tile of ROW-byte rows
// in the ROW-byte swizzle: address bits [4, 4 + log2(ROW / 16)) XOR bits
// [7, ...), i.e. the chunk index XOR (r ROW / 128) mod (ROW / 16)
template <int ROW>
__host__ __device__ constexpr uint32_t swizzled(int r, int c) {
  return r * ROW + ((c ^ ((r * ROW / 128) % (ROW / 16))) * 16);
}

// The descriptor of a tile of ROW-byte rows in the ROW-byte swizzle
// (`desc` is ROW 128): layout type 3, 2 or 1 for 32, 64 or 128 bytes.
// K-major: k16 steps 32 bytes apart in a row, SBO between 8-row groups
// (8 ROW); MN-major: SBO between 8-row groups along K, LBO between atoms
// along M / N.
template <int ROW>
__device__ __forceinline__ uint64_t desc_row(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "a wgmma swizzle");
  constexpr uint64_t mode = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// Copy rows [0, n_valid) of `rows` rows from `src` (row stride ss
// elements) into the tile of W-element rows at `dst` (2 W-byte swizzle),
// with the NT threads of the CTA; rows past n_valid and columns past HD
// become zeros (the copy fills them)
template <int HD, int W, int NT>
__device__ __forceinline__ void load_narrow(uint32_t dst,
                                            const __nv_bfloat16* src,
                                            long long ss, int n_valid,
                                            int rows, int tid) {
  constexpr int C = W / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid && c * 8 < HD;
    cp_async16(dst + swizzled<2 * W>(r, c), ok ? src + r * ss + c * 8 : src,
               ok);
  }
}

// d (64 x 16 f32) += A (64 x 16 bf16, registers) . B (16 x 16, MN-major
// in shared memory, descriptor)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- mbarriers and TMA (the warp-specialised forward past hd 128)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first as completed: parity 1 passes)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 4-d box of a tensor map into shared memory, completing on `bar`;
// coordinates innermost first, out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// named barriers: `count` threads in all, this thread waits or only arrives
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma operands across
// the issue or the wait (ptxas tracks the registers of wgmma in flight)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// --- the float32 route on the tensor cores (split TF32, "tf32x3")
//
// A TF32 product reads the sign, the exponent and the top 10 mantissa
// bits of each 32-bit operand and ignores the low 13 (it reads trunc(x),
// x with them cleared).  A float32 x is taken as hi + lo: hi = rna(x), x
// rounded to the nearest TF32 value (ties away from zero, as
// cvt.rna.tf32.f32), and lo = x - hi, exact in float32 and within half a
// TF32 ulp of x, of which the tensor cores read trunc(lo).  A product a.b
// is then hi_a.hi_b + hi_a.lo_b + lo_a.hi_b, three TF32 products summed
// in float32: hi + trunc(lo) is within 2^-21 |x| of x and lo_a.lo_b,
// dropped, below 2^-24 |a b|, errors of either sign, since lo has either
// sign (hi = x and lo = x - trunc(x), as a split that truncates takes
// them, has twice the error, all of it toward zero); about 22 of
// float32's 24 bits, at a third of the 495 TF32 TFLOP/s.
// tests/test_torch_tf32x3.py mirrors this split bit for bit on the CPU.

// x rounded to the nearest TF32 value, ties away from zero
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// the split of four float32 values, an A fragment of one k8 step
__device__ __forceinline__ void tf32_split(const float (&x)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_rna(x[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(x[i] - h);
  }
}

// d (64 x N f32) (+)= A (64 x 8 tf32, registers) . B^T (B N x 8, K-major
// in shared memory, descriptor); scale_d = 0 overwrites d.  The A fragment
// of a warp's 16 rows: a0 (row g, col t4), a1 (g + 8, t4), a2 (g, t4 + 4),
// a3 (g + 8, t4 + 4), g = lane / 4, t4 = lane % 4.  32-bit operands have
// no transpose bit: B is always K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the three split products of one k8 step: d (+)= hi.B + hi.B_lo + lo.B,
// B and B_lo the descriptors of a tile and its lo part (same layout)
template <int N>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[N / 2],
                                             const uint32_t (&hi)[4],
                                             const uint32_t (&lo)[4],
                                             uint64_t db, uint64_t db_lo,
                                             int scale_d) {
  wgmma_tf32<N>(d, hi, db, scale_d);
  wgmma_tf32<N>(d, hi, db_lo, 1);
  wgmma_tf32<N>(d, lo, db, 1);
}

// 4-byte cp.async (the transposing scatter of a float32 tile); src-size 0
// fills zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Copy rows [0, n_valid) of `rows` rows of W floats (row stride ss
// elements) into the K-major tile at `dst` in the 128-byte swizzle,
// [ceil(W / 32)][rows][128 B] (the layout `desc` reads, 32 floats a
// row of an atom column), with NT threads; rows past n_valid become
// zeros, columns past W of the last atom are not written
template <int W, int NT>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src,
                                              long long ss, int n_valid,
                                              int rows, int tid) {
  constexpr int C = W / 4;  // 16-byte chunks a row
  // not unrolled: unrolled, the compiler keeps each copy's offsets in
  // registers across the key loop, and the dQ kernels past hd 128 spill
#pragma unroll 1
  for (int i = tid; i < rows * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid;
    cp_async16(dst + (c / 8) * rows * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16,
               ok ? src + r * ss + c * 4 : src, ok);
  }
}

// Copy rows [0, n_valid) of a 64-row tile of W floats into shared memory
// as plain rows of pitch W + 4 floats (conflict-free A fragments); rows
// past n_valid become zeros
template <int W, int NT>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src,
                                              long long ss, int n_valid,
                                              int tid) {
  constexpr int C = W / 4;
  for (int i = tid; i < 64 * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid;
    cp_async16(dst + (r * (W + 4) + c * 4) * 4,
               ok ? src + r * ss + c * 4 : src, ok);
  }
}

// The split of a tile as it landed, over `bytes`, 16 bytes a thread a
// step: hi in place of the float32 values, lo at the same offsets of
// `lo` (so in the same swizzle)
template <int NT>
__device__ __forceinline__ void tile_split(float* x, float* lo, int bytes,
                                           int tid) {
  for (int i = tid; i < bytes / 16; i += NT) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                 tf32_rna(v.z), tf32_rna(v.w));
    reinterpret_cast<float4*>(x)[i] = h;
    reinterpret_cast<float4*>(lo)[i] =
        make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
}

// the split of one float32 value stored into a tile and its lo part
__device__ __forceinline__ void store_split(unsigned char* tile,
                                            unsigned char* lo, uint32_t at,
                                            float x) {
  const float h = tf32_rna(x);
  *reinterpret_cast<float*>(tile + at) = h;
  *reinterpret_cast<float*>(lo + at) = x - h;
}

// step kk of a K-major tile of R rows: 32 bytes a step inside a 128-byte
// row, R x 128 bytes between 32-float atom columns
template <int R>
struct Steps {
  __device__ __forceinline__ uint32_t operator()(int kk) const {
    return (kk / 4) * R * 128 + (kk % 4) * 32;
  }
};

// d (64 x N) (+)= A (64 x 8 KS) . B over KS k8 steps, three TF32 wgmma a
// step: frag(kk, hi, lo) gives this thread's A fragment of step kk, split,
// B and B_lo are tiles whose step kk starts `off(kk)` bytes in; two
// steps' fragments in flight
template <int N, int KS, typename Frag, typename Off>
__device__ __forceinline__ void gemm_tf32x3(float (&d)[N / 2], Frag frag,
                                            uint32_t b, uint32_t b_lo,
                                            Off off, bool accumulate) {
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  }
  uint32_t hi[2][4], lo[2][4];
  frag(0, hi[0], lo[0]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_fence();
    wgmma_tf32x3<N>(d, hi[kk & 1], lo[kk & 1], desc(b + off(kk), 16, 1024),
                    desc(b_lo + off(kk), 16, 1024), accumulate || kk > 0);
    wgmma_commit();
    if (kk + 1 < KS) {
      wgmma_wait<1>();  // step kk - 1 is done: its fragments are free
      frag(kk + 1, hi[(kk + 1) & 1], lo[(kk + 1) & 1]);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// d (64 x N) = A . B as gemm_tf32x3 computes it, but each k8 step's
// three products into a fresh accumulator (two in flight), added to d in
// float32, rounded to nearest.  The tensor cores align a wgmma's products
// to the largest of them and the accumulator with a few guard bits and
// truncate the sum toward zero, so a running sum over hd / 8 steps (32
// at hd 256) drifts toward zero by up to an ulp of itself a wgmma; a
// fresh one a step drifts by an ulp of the step's share, in either
// direction from step to step.  (The backward's dS = P (dP - D) takes dP
// against D = rowsum(dO o), a float32 sum: where a row attends few keys
// dP - D is that drift alone.)
template <int N, int KS, typename Frag, typename Off>
__device__ __forceinline__ void gemm_tf32x3_rn(float (&d)[N / 2], Frag frag,
                                               uint32_t b, uint32_t b_lo,
                                               Off off) {
  float part[2][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = part[0][i] = part[1][i] = 0.f;
  uint32_t hi[2][4], lo[2][4];
  frag(0, hi[0], lo[0]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_fence();
    wgmma_tf32x3<N>(part[kk & 1], hi[kk & 1], lo[kk & 1],
                    desc(b + off(kk), 16, 1024),
                    desc(b_lo + off(kk), 16, 1024), 0);
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait<1>();  // step kk - 1 is done: add it, free its registers
      fence_regs(part[(kk - 1) & 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] += part[(kk - 1) & 1][i];
    }
    if (kk + 1 < KS) frag(kk + 1, hi[(kk + 1) & 1], lo[(kk + 1) & 1]);
  }
  wgmma_wait<0>();
  fence_regs(part[(KS - 1) & 1]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] += part[(KS - 1) & 1][i];
}

// Byte offset of element (r, c) of a K-major tile of `rows` rows in the
// 128-byte swizzle ([c / 32][rows][128 B])
__device__ __forceinline__ uint32_t swz_f32(int r, int c, int rows) {
  return (c / 32) * rows * 128 + r * 128 + ((((c % 32) / 4) ^ (r % 8)) * 16) +
         (c % 4) * 4;
}

}  // namespace tc

}  // namespace
