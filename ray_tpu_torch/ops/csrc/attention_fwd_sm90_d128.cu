// Causal attention forward for Hopper (sm_90a), bf16, head dim 128.
//
// Replaces, at Llama's head dim, the TPU kernel that
// ray_tpu/ops/attention.py reaches through _splash_kernel /
// _splash_causal_attention:
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :1137 _splash_attention_forward
// (and, through causal_attention(impl="flash"), flash_attention.py:758
// _flash_attention_impl, which computes the same function).  It computes
// what attention_fwd_sm90.cu computes at head dim 64: o = softmax(q k^T) v
// under the causal mask with an online softmax, and lse, the natural-log
// logsumexp of each row of scores; q arrives pre-scaled by sm_scale
// (splash's convention).  q, k, v are [B, S, H, 128] bf16 with any
// batch/seq/head strides (multiples of 16 bytes); o is contiguous
// [B, S, H, 128] bf16 and lse contiguous [B, H, S] f32.
//
// What bounds it on an H100.  At Llama-2-7B's training and long-prefill
// shape (B=1, S=2048, H=32, D=128) the forward does 4*D*B*H*S(S+1)/2 =
// 3.4e10 FLOP against 67 MB to move (q, k, v read once, o written once,
// bf16): 0.035 ms at the 989 TFLOP/s bf16 tensor-core peak against 0.020 ms
// at 3.35 TB/s.  Each byte feeds twice the work it does at D=64, so the
// kernel is bound by the tensor cores, and the [S, S] scores must never
// leave the SM.
//
// What the design does about it.  The D=64 design (attention_fwd_sm90.cu)
// carried to D=128, where three things of it break:
//   - A bf16 row of 128 is 256 bytes, but the 128-byte swizzle takes a TMA
//     box of at most 128 bytes a row.  Every tile is loaded as two
//     64-column halves (two boxes, at column 0 and 64), each its own stack
//     of 8-row x 128-byte atoms; a tile's mbarrier expects both halves.
//     S = Q K^T runs eight k-steps, 0-3 inside the first half and 4-7
//     inside the second (K-major descriptors of each half, + 32 bytes a
//     step).  O += P V reads V MN-major with N = 128 across both halves:
//     the descriptor's leading byte offset is the step between them.
//   - O is 128 wide: wgmma m64n128k16, 64 accumulator floats a thread.
//     With the 64-float S fragment of 128-key tiles that is past what two
//     CTAs of 256 threads may hold (128 registers a thread), so one CTA
//     runs on each SM.  Its 9 warps put 3 on one SM sub-partition, which
//     caps a thread at 168 registers; the kernel takes 164.
//   - One CTA per SM leaves no second CTA to hide a stalled load, so the
//     loads come from a producer warp of their own: it issues every TMA
//     load of Q and of the K/V ring (2 stages of 128 keys) and waits on the
//     ring's "empty" mbarriers, and the two consumer warpgroups never wait
//     for each other's reads of a stage.
// Kept from the D=64 design: 128 q rows per CTA as two warpgroups of 64 rows,
// the softmax in registers (quad shuffles, base 2), the causal mask only on
// tiles that cross the diagonal, P born in registers as the A operand of
// P V, TMA's zero fill for a ragged S, the heaviest q tiles first, and O out
// through the warpgroup's own Q rows as 16-byte stores of whole rows.
// Later work (ROADMAP): a persistent grid (at B=1 S=2048 H=32 the 512 CTAs
// are 3.9 waves with a causal tail).  Issuing the next tile's S before this
// tile's P V inside a warpgroup (FlashAttention-3's intra-warpgroup
// overlap), at 256 threads and 3 stages, ran slower in a trial on the H100.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns an error code (0 on
// success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int D = 128;   // head dim: two 64-column halves of 128-byte swizzle rows
constexpr int ROW = 128;  // bytes of one row of one half
constexpr int BM = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int NCONSUMERS = 256;
constexpr int NTHREADS = NCONSUMERS + 32;  // and one producer warp
constexpr int BN = 128, STAGES = 2;        // 128-key tiles, a ring of 2 stages
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int QH = BM * ROW;   // one half of the Q tile
  static constexpr int KVH = BN * ROW;  // one half of a K or V tile
  static constexpr int KV = 2 * KVH;    // a K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + 2 * QH;
  static constexpr int v = k + STAGES * KV;
  static constexpr int bar = v + STAGES * KV;  // mbarriers: q, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// ----------------------------------------------------------------- kernel

// Grid: (q tiles, H, B), the q-tile index reversed so that the tiles with
// the most key tiles start first.  Warpgroup w < 2 owns q rows
// [row0 + 64w, row0 + 64w + 64); warp 8 is the producer.
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_sm90_d128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse,
                          int H, int S) {
  using L = Smem;
  constexpr int NS = BN / 2;  // S accumulator registers per thread
  constexpr int NO = D / 2;   // O accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  // causal: the last key tile is the one holding this CTA's last row
  const int n_kv = min((S + BN - 1) / BN, (row0 + BM - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMERS) {  // the producer warp: one thread issues every load
    if (tid == NCONSUMERS) {
      mbar_expect_tx(bar_q, 2 * L::QH);
      tma_load(base + L::q, &tq, bar_q, h, row0, b, 0);
      tma_load(base + L::q + L::QH, &tq, bar_q, h, row0, b, 64);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), (j / STAGES - 1) & 1);  // tile j - STAGES is done with
        const uint32_t kd = base + L::k + s * L::KV, vd = base + L::v + s * L::KV;
        mbar_expect_tx(full(s), 2 * L::KV);
        tma_load(kd, &tk, full(s), h, j * BN, b, 0);
        tma_load(kd + L::KVH, &tk, full(s), h, j * BN, b, 64);
        tma_load(vd, &tv, full(s), h, j * BN, b, 0);
        tma_load(vd + L::KVH, &tv, full(s), h, j * BN, b, 64);
      }
    }
    return;
  }

  const int wrow0 = row0 + 64 * wg;                     // this warpgroup's first q row
  const int r_lo = wrow0 + 16 * warp + lane / 4;        // this thread's two rows
  const int r_hi = r_lo + 8;
  const int c_off = 2 * (lane % 4);                     // its column pair in each n8 chunk
  const int last_j = min(n_kv - 1, (wrow0 + 63) / BN);  // tiles past it are all masked for this warpgroup
  const uint32_t q_rows = base + L::q + wg * 64 * ROW;  // this warpgroup's rows of the first Q half

  float acc_o[NO];
  zero(acc_o);
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, base-2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    if (j <= last_j) {
      // S = Q K^T: A = Q, B = K tile, both K-major; k-steps 0-3 in the first
      // half, 4-7 in the second
      float acc_s[NS];
      zero(acc_s);
      const uint32_t kt = base + L::k + s * L::KV;
      wgmma_fence();
      fence_regs(acc_s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, step = kk % 4;
        wgmma_ss<0, 0>(acc_s, kmajor_desc(q_rows + hf * L::QH) + 2 * step,
                       kmajor_desc(kt + hf * L::KVH) + 2 * step, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);

      // causal mask, only on tiles that reach past this warpgroup's first row
      const int col0 = j * BN;
      if (col0 + BN - 1 > wrow0) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int c = col0 + 8 * i + c_off;
          if (c > r_lo) acc_s[4 * i] = -INFINITY;
          if (c + 1 > r_lo) acc_s[4 * i + 1] = -INFINITY;
          if (c > r_hi) acc_s[4 * i + 2] = -INFINITY;
          if (c + 1 > r_hi) acc_s[4 * i + 3] = -INFINITY;
        }
      }
      // online softmax in base 2; the quad (lane / 4) shares the two rows
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx_lo = fmaxf(mx_lo, fmaxf(acc_s[4 * i], acc_s[4 * i + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(acc_s[4 * i + 2], acc_s[4 * i + 3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      // key tile 0 holds column 0, unmasked for every row, so the max is
      // finite from the first tile on and alpha is exp2(-inf) = 0 there
      const float mn_lo = fmaxf(m_lo, mx_lo * LOG2E);
      const float mn_hi = fmaxf(m_hi, mx_hi * LOG2E);
      const float alpha_lo = exp2f(m_lo - mn_lo), alpha_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        acc_s[4 * i] = exp2f(fmaf(acc_s[4 * i], LOG2E, -mn_lo));
        acc_s[4 * i + 1] = exp2f(fmaf(acc_s[4 * i + 1], LOG2E, -mn_lo));
        acc_s[4 * i + 2] = exp2f(fmaf(acc_s[4 * i + 2], LOG2E, -mn_hi));
        acc_s[4 * i + 3] = exp2f(fmaf(acc_s[4 * i + 3], LOG2E, -mn_hi));
        sum_lo += acc_s[4 * i] + acc_s[4 * i + 1];
        sum_hi += acc_s[4 * i + 2] + acc_s[4 * i + 3];
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc_o[4 * i] *= alpha_lo;
        acc_o[4 * i + 1] *= alpha_lo;
        acc_o[4 * i + 2] *= alpha_hi;
        acc_o[4 * i + 3] *= alpha_hi;
      }
      // P in bf16, in the A-fragment layout: k16 chunk kk is n8 chunks 2kk, 2kk+1
      uint32_t p[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) p[kk][w] = pack_bf16(acc_s[8 * kk + 2 * w], acc_s[8 * kk + 2 * w + 1]);
      // O += P V: B = V tile MN-major, N = 128 across its two halves; a
      // k-step is 16 key rows = 2048 bytes
      const uint64_t desc_v = mnmajor_desc_n128(base + L::v + s * L::KV, L::KVH);
      wgmma_fence();
      fence_regs(acc_o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc_o, p[kk], desc_v + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
    }
    // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: the quad's partial sums, then O / l through this warpgroup's
  // Q rows (both halves, 128-byte swizzled, as 16-byte chunks) and out as
  // whole rows
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  unsigned char* so = smem + L::q + wg * 64 * ROW;
  const int lr = 16 * warp + lane / 4;  // local row of r_lo; r_hi is lr + 8, same swizzle phase
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // every warp's last read of Q is done
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    unsigned char* dst = so + (i / 8) * L::QH;
    const int chunk = ((i % 8) ^ (lr % 8)) * 16 + 2 * c_off;
    *reinterpret_cast<uint32_t*>(dst + lr * ROW + chunk) = pack_bf16(acc_o[4 * i] * inv_lo, acc_o[4 * i + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(dst + (lr + 8) * ROW + chunk) =
        pack_bf16(acc_o[4 * i + 2] * inv_hi, acc_o[4 * i + 3] * inv_hi);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  const int wt = tid % 128;
#pragma unroll
  for (int it = 0; it < 64 * (D / 8) / 128; ++it) {
    const int idx = it * 128 + wt, r = idx / (D / 8), c = idx % (D / 8);
    const int row = wrow0 + r;
    if (row < S) {
      const uint4 val = *reinterpret_cast<const uint4*>(so + (c / 8) * L::QH + r * ROW + ((c % 8) ^ (r % 8)) * 16);
      *reinterpret_cast<uint4*>(o + ((static_cast<long long>(b) * S + row) * H + h) * D + c * 8) = val;
    }
  }
  if (lane % 4 == 0) {
    float* lse_bh = lse + (static_cast<long long>(b) * H + h) * S;
    if (r_lo < S) lse_bh[r_lo] = (m_lo + log2f(l_lo)) * LN2;
    if (r_hi < S) lse_bh[r_hi] = (m_hi + log2f(l_hi)) * LN2;
  }
}

// ------------------------------------------------------------------- host

int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int S,
           const long long* st, cudaStream_t stream) {
  using L = Smem;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B, H, S, D, st, BM, 64);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, BN, 64);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, BN, 64);
  if (e != 0) return e;
  auto kern = attn_fwd_sm90_d128_kernel;
  cudaError_t ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  dim3 grid((S + BM - 1) / BM, H, B);
  kern<<<grid, NTHREADS, L::bytes, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, H, S);
  return cudaGetLastError();
}

}  // namespace

// Same interface as rtt_attn_fwd_sm90.  dtype: 0 = bfloat16 (the only one
// taken); Dh must be 128.  strides: 9 element strides (batch, seq, head) of
// q, k, v, each a multiple of 8 elements.  o is contiguous [B, S, H, D]; lse
// contiguous [B, H, S].  Returns 0, a cudaError_t, or an error code of
// sm90_common.cuh; rtt_error_string names it.
extern "C" int rtt_attn_fwd_sm90_d128(int dtype, int Dh, const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int H, int S, const long long* strides, void* stream) {
  if (dtype != 0 || Dh != D) return cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, B, H, S, strides, static_cast<cudaStream_t>(stream));
}

// The kernel's dynamic shared memory in bytes and how many of its CTAs fit
// on one SM (registers and shared memory together), for the build report.
extern "C" int rtt_attn_fwd_sm90_d128_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = Smem::bytes;
  cudaError_t e =
      cudaFuncSetAttribute(attn_fwd_sm90_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, attn_fwd_sm90_d128_kernel, NTHREADS, Smem::bytes);
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
