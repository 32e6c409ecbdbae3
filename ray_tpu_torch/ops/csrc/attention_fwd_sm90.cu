// Causal attention forward for Hopper (sm_90a), bf16, head dim 64.
//
// Replaces the TPU kernel that ray_tpu/ops/attention.py reaches through
// _splash_kernel / _splash_causal_attention:
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :1137 _splash_attention_forward
// (and, through causal_attention(impl="flash"), flash_attention.py:758
// _flash_attention_impl, which computes the same function).  It computes
// what splash's forward computes: o = softmax(q k^T) v under the causal mask
// with an online softmax, and lse, the natural-log logsumexp of each row of
// scores.  q arrives pre-scaled by sm_scale (splash's convention).  q, k, v
// are [B, S, H, 64] bf16 with any batch/seq/head strides (multiples of 16
// bytes); o is contiguous [B, S, H, 64] bf16 and lse contiguous [B, H, S]
// f32.  bf16 at head dim 128 goes to attention_fwd_sm90_d128.cu, float32
// inputs to attn_fwd_kernel in causal_attention.cu.
//
// What bounds it on an H100.  At GPT-2 124M's shape (B=18, H=12, S=1024,
// D=64) the forward does 4*D*B*H*S(S+1)/2 = 2.9e10 FLOP over the causal
// pairs and must move 114 MB (q, k, v read once, o written once, bf16):
// 0.029 ms at the 989 TFLOP/s bf16 tensor-core peak against 0.034 ms at
// 3.35 TB/s.  It sits near the ridge, so both the tensor cores and the
// loads have to be kept busy, and the [S, S] scores must never leave the SM.
//
// What the design does about it.
//   - One CTA takes 128 q rows as two warpgroups of 64 rows; each runs
//     wgmma with M=64.  Tiles of 64 keys and values (BN) stream past.
//   - S = Q K^T is one wgmma chain (m64n64k16, four k-steps over D=64) with
//     both operands in shared memory.  Q is loaded once.  A bf16 row of 64 is
//     exactly 128 bytes, so every tile is stored with the 128-byte swizzle
//     that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B) and the wgmma descriptors
//     read (layout type 1).
//   - The softmax stays in registers: each thread holds two rows of the S
//     fragment, reduces them with two quad shuffles, keeps its running max
//     and partial sum, and works in base 2 (exp2f, log2(e) folded into the
//     scores).  The causal mask is compared only on tiles that cross the
//     diagonal.  The output accumulator is rescaled in registers.
//   - O += P V is a wgmma with A from registers: the S accumulator, rounded
//     to bf16 in place, already has the A-fragment layout of k16 chunks.  V
//     is read MN-major from shared memory (the descriptor's transpose bit).
//     Neither S nor P touches shared memory.
//   - K/V tiles arrive by TMA into a ring of 3 stages, issued by one thread
//     and completed on mbarriers, so tile j+1 is in flight while tile j is
//     computed; a second mbarrier per stage says when both warpgroups are
//     done with it.  TMA's out-of-bounds zero fill covers a ragged S.
//   - The grid runs the heaviest q tiles (most key tiles) first.
//   - O leaves through the warpgroup's own Q tile in shared memory, as
//     16-byte stores of whole rows.
// Later work (ROADMAP): a producer warp with setmaxnreg, a persistent grid,
// clusters with multicast, and overlapping one warpgroup's softmax with the
// other's products.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns an error code (0 on
// success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int D = 64;           // head dim: a bf16 row is one 128-byte swizzle row
constexpr int ROW_BYTES = D * 2;
constexpr int BM = 128;         // q rows per CTA: two warpgroups of 64
constexpr int NTHREADS = 256;
// 64-key tiles, a ring of 3 stages, two CTAs per SM: 64 KB of shared memory
// and at most 128 registers a thread each.  128-key tiles need more
// registers than that (the 64-float S fragment beside the 32-float O
// fragment): at two CTAs per SM they spill, at one they run slower.
constexpr int BN = 64, STAGES = 3, MIN_BLOCKS = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int KV = BN * ROW_BYTES;  // one K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + BM * ROW_BYTES;
  static constexpr int v = k + STAGES * KV;
  static constexpr int bar = v + STAGES * KV;  // mbarriers: q, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// ----------------------------------------------------------------- kernel

// Grid: (q tiles, H, B), the q-tile index reversed so that the tiles with
// the most key tiles start first.  256 threads: warpgroup w owns q rows
// [row0 + 64w, row0 + 64w + 64).  Thread 0 also issues every TMA load.
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
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
      mbar_init(empty(s), NTHREADS / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, BM * ROW_BYTES);
    tma_load(base + L::q, &tq, bar_q, h, row0, b);
    for (int j = 0; j < STAGES && j < n_kv; ++j) {
      mbar_expect_tx(full(j), 2 * L::KV);
      tma_load(base + L::k + j * L::KV, &tk, full(j), h, j * BN, b);
      tma_load(base + L::v + j * L::KV, &tv, full(j), h, j * BN, b);
    }
  }

  const int wrow0 = row0 + 64 * wg;                     // this warpgroup's first q row
  const int r_lo = wrow0 + 16 * warp + lane / 4;        // this thread's two rows
  const int r_hi = r_lo + 8;
  const int c_off = 2 * (lane % 4);                     // its column pair in each n8 chunk
  const int last_j = min(n_kv - 1, (wrow0 + 63) / BN);  // tiles past it are all masked for this warpgroup
  const uint64_t desc_q = kmajor_desc(base + L::q + wg * 64 * ROW_BYTES);

  float acc_o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc_o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, base-2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(full(s), parity);
    if (j <= last_j) {
      // S = Q K^T: A = Q (K-major), B = K tile (K-major); k-steps of 32 bytes
      float acc_s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) acc_s[i] = 0.f;
      const uint64_t desc_k = kmajor_desc(base + L::k + s * L::KV);
      wgmma_fence();
      fence_regs(acc_s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0, 0>(acc_s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
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
      for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = pack_bf16(acc_s[8 * kk], acc_s[8 * kk + 1]);
        p[kk][1] = pack_bf16(acc_s[8 * kk + 2], acc_s[8 * kk + 3]);
        p[kk][2] = pack_bf16(acc_s[8 * kk + 4], acc_s[8 * kk + 5]);
        p[kk][3] = pack_bf16(acc_s[8 * kk + 6], acc_s[8 * kk + 7]);
      }
      // O += P V: B = V tile, MN-major; a k-step is 16 key rows = 2048 bytes
      const uint64_t desc_v = mnmajor_desc(base + L::v + s * L::KV);
      wgmma_fence();
      fence_regs(acc_o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc_o, p[kk], desc_v + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
    }
    // this warp is done with stage s; thread 0 refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (tid == 0 && j + STAGES < n_kv) {
      mbar_wait(empty(s), parity);
      mbar_expect_tx(full(s), 2 * L::KV);
      tma_load(base + L::k + s * L::KV, &tk, full(s), h, (j + STAGES) * BN, b);
      tma_load(base + L::v + s * L::KV, &tv, full(s), h, (j + STAGES) * BN, b);
    }
    __syncwarp();
  }

  // epilogue: the quad's partial sums, then O / l through this warpgroup's
  // Q tile (128-byte swizzled, as 16-byte chunks) and out as whole rows
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  unsigned char* so = smem + L::q + wg * 64 * ROW_BYTES;
  const int lr = 16 * warp + lane / 4;  // local row of r_lo; r_hi is lr + 8, same swizzle phase
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // every warp's last read of Q is done
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int chunk = (i ^ (lr % 8)) * 16 + 2 * c_off;
    *reinterpret_cast<uint32_t*>(so + lr * ROW_BYTES + chunk) = pack_bf16(acc_o[4 * i] * inv_lo, acc_o[4 * i + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(so + (lr + 8) * ROW_BYTES + chunk) =
        pack_bf16(acc_o[4 * i + 2] * inv_hi, acc_o[4 * i + 3] * inv_hi);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  const int wt = tid % 128;
#pragma unroll
  for (int it = 0; it < 64 * (ROW_BYTES / 16) / 128; ++it) {
    const int idx = it * 128 + wt, r = idx / (ROW_BYTES / 16), c = idx % (ROW_BYTES / 16);
    const int row = wrow0 + r;
    if (row < S) {
      const uint4 val = *reinterpret_cast<const uint4*>(so + r * ROW_BYTES + (c ^ (r % 8)) * 16);
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
  int e = make_map(&tq, q, B, H, S, D, st, BM);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, BN);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, BN);
  if (e != 0) return e;
  auto kern = attn_fwd_sm90_kernel;
  cudaError_t ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  dim3 grid((S + BM - 1) / BM, H, B);
  kern<<<grid, NTHREADS, L::bytes, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, H, S);
  return cudaGetLastError();
}

}  // namespace

// Same interface as rtt_attn_fwd in causal_attention.cu.  dtype: 0 =
// bfloat16 (the only one taken); D must be 64.  strides: 9 element strides
// (batch, seq, head) of q, k, v, each a multiple of 8 elements.  o is
// contiguous [B, S, H, D]; lse contiguous [B, H, S].  Returns 0, a
// cudaError_t, or an error code of sm90_common.cuh; rtt_error_string names
// it.
extern "C" int rtt_attn_fwd_sm90(int dtype, int Dh, const void* q, const void* k, const void* v, void* o,
                                 float* lse, int B, int H, int S, const long long* strides, void* stream) {
  if (dtype != 0 || Dh != D) return cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, B, H, S, strides, static_cast<cudaStream_t>(stream));
}

// The kernel's dynamic shared memory in bytes and how many of its CTAs fit
// on one SM (registers and shared memory together), for the build report.
extern "C" int rtt_attn_fwd_sm90_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = Smem::bytes;
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, attn_fwd_sm90_kernel, NTHREADS, Smem::bytes);
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
