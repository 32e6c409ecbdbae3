// Hopper (sm_90a) building blocks of the port's attention kernels
// (attention_fwd_sm90.cu, attention_bwd_sm90.cu, their head-dim-128 forms
// *_d128.cu and their float32 forms *_f32.cu): mbarriers, TMA loads, wgmma
// m64n64k16 and m64n128k16 on bf16 tiles in the 128-byte swizzle, float32
// products on the tensor cores in 3xTF32 (mma.sync), bulk reduce-adds, the
// semaphores that order the backwards' dq adds, the backward's pre- and
// postprocess kernels, and the host's tensor-map encoder.  Each kernel
// source includes it once; ops/_build.py hashes it with every source that
// includes it, so an edit rebuilds them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that never ends
// (a lost transfer) traps after seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// -------------------------------------------------------------------- TMA

// One box of a 4-D tensor map (D, H, S, B) into shared memory, its first
// column at `col`; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h, int s,
                                         int b, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor for a tile in the 128-byte swizzle layout
// (8 rows of 128 bytes per 1024-byte atom).  LBO and SBO in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// A tile of 64 bf16 columns (one 128-byte swizzle row per tile row).
// K-major: the reduction dimension runs along the row; a k-step of 16 is 32
// bytes (descriptor + 2).  MN-major: the tile is read transposed; a k-step
// is 16 rows = 2048 bytes (descriptor + 128), and since the tile is one
// atom wide LBO is never used, so it is set equal to SBO.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return sw128_desc(addr, 1024, 1024); }
// Head dim 128: a bf16 row of 128 is two swizzle rows, so a tile is stored
// as two 64-column halves, each its own stack of 1024-byte atoms, the second
// `half_bytes` after the first.  K-major, k-steps 0-3 lie in the first half
// and 4-7 in the second: kmajor_desc of the half, + 2 per step inside it.
// MN-major with N = 128 (the two halves side by side): LBO is the step from
// the first 64 columns of N to the next, i.e. `half_bytes`.
__device__ __forceinline__ uint64_t mnmajor_desc_n128(uint32_t addr, uint32_t half_bytes) {
  return sw128_desc(addr, half_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// Until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory; TA / TB
// are the transpose immediates: 0 = K-major, 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (four bf16x2 per
// thread, the accumulator's own layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 128 (64 accumulator floats a thread): columns 8i +
// 2(t%4) and that + 1 in d[4i .. 4i+3] for i < 16, as for N = 64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ bulk copies

// dst[0:bytes] += src[0:bytes] as f32, shared to global, in the issuing
// thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// ------------------------------------------------- dq in a fixed order

// The backwards add each q tile's dQ partial into one f32 sum in a fixed
// order of key tiles, so that a run's dq does not depend on which CTA gets
// there first (FlashAttention-3's deterministic backward; splash sums its
// per-key-block partials in order too).  One int per (batch, head, q tile),
// zeroed by the entry point, counts the partials already added: the CTA of
// key tile kt waits until it reads kt (its turn), adds, and bumps it.  A CTA
// waits only on CTAs of lower key tiles, which the grid (key tile =
// blockIdx.z, the slowest dimension) launches before it, so every wait ends.

// Until *sem reads at least `turn`.  An acquire at GPU scope, then a proxy
// fence, so the adds released before the bump are visible to this thread's
// later loads, reductions and bulk copies.  Traps after seconds instead of
// hanging the card.
__device__ __forceinline__ void sem_wait(const int* sem, int turn) {
  for (uint32_t n = 0;; ++n) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(sem) : "memory");
    if (v >= turn) break;
    if (n == (1u << 25)) __trap();
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
// *sem += 1, releasing at GPU scope the writes this thread made before it
// (and those of every thread of the CTA that passed a barrier with it since).
__device__ __forceinline__ void sem_release(int* sem) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;" ::"l"(sem) : "memory");
}
// Until this thread's bulk reduce-adds have written device memory (not only
// read shared memory), then orders those async-proxy writes before the
// thread's later release: call before sem_release.
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ------------------------------------- float32 on the tensor cores (3xTF32)

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), lo the rest,
// exact in f32.  lo goes to the tensor core as it is, which reads its top
// 19 bits (CUTLASS's round-toward-zero for the small part).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// An m16n8k8 A fragment (four elements a thread) and B fragment (two), split.
// A (row-major 16 x 8): thread (g = lane / 4, t = lane % 4) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, k by n): (t, g), (t + 4,
// g); the accumulator (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: the small products first, then hi * hi; lo * lo is
// below f32's rounding and left out.  The arithmetic of SDPA's float32
// kernel (CUTLASS's OpMultiplyAddFastF32).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Byte offset of element (r, c) of a float32 tile of R rows that TMA loaded
// as 32-column boxes (128 bytes a row) in the 128-byte swizzle: box c / 32
// holds R rows of 128 bytes, and 16-byte chunk (c % 32) / 4 of row r sits at
// chunk ((c % 32) / 4) ^ (r % 8).  Each box starts on a 1024-byte boundary.
template <int R>
__device__ __forceinline__ int f32_at(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}
template <int R>
__device__ __forceinline__ float f32_ld(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + f32_at<R>(r, c));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ------------------------------------------- the backward's pre and post

// di[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in f32, from the bf16
// rows [B, S, H, D]: D / 8 threads per row, 16 bytes each.
template <int D>
__global__ void attn_bwd_sm90_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                         float* __restrict__ di, int H, int S, long long rows) {
  constexpr int TPR = D / 8;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = g / TPR;  // row of [B, S, H]
  const int part = static_cast<int>(g % TPR);
  float sum = 0.f;
  if (n < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + n * D + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + n * D + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(c2[i]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (n < rows && part == 0) {
    const long long b = n / (static_cast<long long>(S) * H);
    const int s = static_cast<int>((n / H) % S), h = static_cast<int>(n % H);
    di[(b * H + h) * S + s] = sum;
  }
}

// dq[b, s, h, :] = bf16(the accumulator's row), D / 8 threads per row, one
// 8-column block (32 bytes in, 16 bytes out) each.  The accumulator holds
// each (batch, head, BM-row tile) as one block [D / 8][BM][8] f32.
template <int D, int BM>
__global__ void attn_bwd_sm90_post_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int H, int S,
                                          long long rows) {
  constexpr int TPR = D / 8;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = g / TPR;
  const int cb = static_cast<int>(g % TPR);
  if (n >= rows) return;
  const long long b = n / (static_cast<long long>(S) * H);
  const int s = static_cast<int>((n / H) % S), h = static_cast<int>(n % H);
  const int n_q = (S + BM - 1) / BM;
  const float* src = dq_acc + (((b * H + h) * n_q + s / BM) * TPR + cb) * (BM * 8) + (s % BM) * 8;
  const float4 x0 = *reinterpret_cast<const float4*>(src), x1 = *reinterpret_cast<const float4*>(src + 4);
  const uint4 val = {pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w), pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w)};
  *reinterpret_cast<uint4*>(dq + n * D + cb * 8) = val;
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes beyond cudaError_t's: libcuda has no tensor-map encoder, or
// the encoder refused a tensor map (kMapError + its CUresult).
constexpr int kNoEncoder = 90000;
constexpr int kMapError = 100000;

// cuTensorMapEncodeTiled through the runtime, so the build needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over one [B, S, H, D] view (bf16, or float32 when `elem_bytes`
// is 4)
// with element strides (batch, seq, head), dims ordered (D, H, S, B); a box
// is `rows` rows of one head and `cols` columns (all D when 0; at most one
// 128-byte swizzle row: 64 bf16 or 32 float32), 128-byte swizzled.  Rows
// past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, const long long* st, int rows,
             int cols = 0, int elem_bytes = 2) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * elem_bytes,
                                 static_cast<cuuint64_t>(st[1]) * elem_bytes,
                                 static_cast<cuuint64_t>(st[0]) * elem_bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols ? cols : D), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// The text for an entry point's return code: a cudaError_t or one of the
// codes above.
const char* error_string(int err) {
  static char buf[96];
  if (err == kNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda";
  if (err >= kMapError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)", err - kMapError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
