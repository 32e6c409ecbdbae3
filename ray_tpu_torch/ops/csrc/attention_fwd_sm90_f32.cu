// Causal attention forward for Hopper (sm_90a), float32, head dim 64 or 128.
//
// Replaces, for float32 inputs, the TPU kernel that ray_tpu/ops/attention.py
// reaches through _splash_kernel / _splash_causal_attention:
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :1137 _splash_attention_forward
// (and, through causal_attention(impl="flash"), flash_attention.py:758
// _flash_attention_impl).  It computes what splash's forward computes, with
// its conventions: o = softmax(q k^T) v under the causal mask with an online
// softmax, and lse, the natural-log logsumexp of each row of scores, for q
// pre-scaled by sm_scale.  q, k, v are [B, S, H, D] float32 with any
// batch/seq/head strides (multiples of 16 bytes); o is contiguous
// [B, S, H, D] float32 and lse contiguous [B, H, S] float32.  The bf16
// inputs go to attention_fwd_sm90.cu (D=64) and attention_fwd_sm90_d128.cu
// (D=128).
//
// What bounds it on an H100.  At phase (h)'s shape (GPT-2 124M in float32
// at batch 4: B=4, H=12, S=1024, D=64) the forward does 4*D*B*H*S(S+1)/2 =
// 6.4e9 FLOP over the causal pairs and moves 50 MB (q, k, v read once, o
// written once, f32): 0.096 ms at the 67 TFLOP/s FP32 peak of the CUDA
// cores, against 0.015 ms at 3.35 TB/s.  So the products must leave the
// CUDA cores for the tensor cores, and to keep float32's accuracy (the
// reference is float32; single-pass TF32 keeps 10 mantissa bits) each runs
// as three TF32 products (3xTF32, as SDPA's float32 kernel does): each
// operand x is split into hi = tf32(x) and lo = x - hi, and hi*hi + hi*lo
// + lo*hi is accumulated in f32.  Three TF32 products at the 494.7 TFLOP/s
// dense TF32 peak make the bound 165 TFLOP/s of float32 products (0.039 ms
// here); mma.sync, which this kernel uses, reaches less of the tensor cores
// than wgmma does.
//
// What the design does about it.
//   - The products are mma.sync m16n8k8 TF32 with the split done in
//     registers (sm90_common.cuh's FragA / FragB / mma_3xtf32).  wgmma's
//     TF32 form reads shared-memory operands K-major only, which P V (V is
//     MN-major as loaded) does not meet; mma.sync has no layout rule on the
//     shared-memory side.
//   - One CTA of NW warps takes 16 * NW q rows, 16 a warp; tiles of 64 keys
//     and values stream past through a TMA ring of 2 stages (mbarriers: full
//     by transaction bytes, empty by one arrival a warp), issued by thread
//     0.  Q is loaded once.  Every tile lies in shared memory as 32-column
//     boxes of 128-byte rows in the 128-byte swizzle, which TMA writes: the
//     fragment loads (row g, column t) of S = Q K^T and the column gathers
//     (row 2t, column g) of P V hit 32 different banks.
//   - The softmax stays in registers, as in attention_fwd_sm90.cu: the
//     quad of a row's threads reduces with two shuffles, running max and
//     sum in base 2, the causal mask only on tiles that cross the diagonal.
//   - O += P V takes P straight from the S accumulator: the accumulator
//     holds columns 2t and 2t + 1 of each 8-key block, where the A fragment
//     wants t and t + 4, so the 8 keys of each k-step are taken in the order
//     0, 2, 4, 6, 1, 3, 5, 7 (k-index t is key 2t, t + 4 is key 2t + 1) and
//     V's rows are read in the same order.  Neither S nor P touches shared
//     memory.
//   - O and lse leave from registers.
//
// Plain C interface, loaded with ctypes: the entry point launches on the
// caller's stream, allocates nothing, and returns an error code (0 on
// success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int BN = 64;  // keys a tile
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// NW warps of 16 q rows each: 8 at both head dims, 97 KB of shared memory
// at D=64 and 193 KB at D=128; one CTA an SM either way (at D=64 the
// registers, 197 a thread, leave no room for a second: held to 128 a
// thread, it spilled and ran slower).
template <int D>
struct Fwd {
  static constexpr int NW = 8;
  static constexpr int MIN_BLOCKS = 1;  // CTAs an SM that __launch_bounds__ sizes the registers for
  static constexpr int BM = 16 * NW;  // q rows a CTA
  static constexpr int NTHREADS = 32 * NW;
  static constexpr int Q = BM * D * 4;   // the Q tile
  static constexpr int KV = BN * D * 4;  // one K or V tile
  static constexpr int q = 0;            // byte offsets from a 1024-byte aligned base
  static constexpr int k = q + Q;
  static constexpr int v = k + STAGES * KV;
  static constexpr int bar = v + STAGES * KV;  // mbarriers: q, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// ----------------------------------------------------------------- kernel

// Grid: (q tiles, H, B), the q-tile index reversed so that the tiles with the
// most key tiles start first.  Warp w owns q rows [row0 + 16w, row0 + 16w +
// 16); thread (g = lane / 4, t = lane % 4) holds rows 16w + g and 16w + g + 8.
template <int D>
__global__ void __launch_bounds__(Fwd<D>::NTHREADS, Fwd<D>::MIN_BLOCKS)
attn_fwd_sm90_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, float* __restrict__ o, float* __restrict__ lse,
                         int H, int S) {
  using L = Fwd<D>;
  constexpr int BM = L::BM, NB = D / 8, NK = BN / 8;  // n8 blocks of O and of S
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  // causal: the last key tile is the one holding this CTA's last row
  const int n_kv = min((S + BN - 1) / BN, (row0 + BM - 1) / BN + 1);

  auto load_kv = [&](int j) {  // K and V tile j into stage j % STAGES, 32 columns a box
    const int s = j % STAGES;
    mbar_expect_tx(full(s), 2 * L::KV);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      tma_load(base + L::k + s * L::KV + c * BN * 128, &tk, full(s), h, j * BN, b, 32 * c);
      tma_load(base + L::v + s * L::KV + c * BN * 128, &tv, full(s), h, j * BN, b, 32 * c);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), L::NW);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) tma_load(base + L::q + c * BM * 128, &tq, bar_q, h, row0, b, 32 * c);
    for (int j = 0; j < STAGES && j < n_kv; ++j) load_kv(j);
  }

  const int lr = 16 * warp + g;   // this thread's low row in the Q tile; the high one is lr + 8
  const int wrow0 = row0 + 16 * warp;
  const int r_lo = wrow0 + g, r_hi = r_lo + 8;
  const int last_j = min(n_kv - 1, (wrow0 + 15) / BN);  // tiles past it are all masked for this warp
  const unsigned char* sq = smem + L::q;

  float acc_o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc_o[n][0] = acc_o[n][1] = acc_o[n][2] = acc_o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, base-2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(full(s), parity);
    if (j <= last_j) {
      const unsigned char* sk = smem + L::k + s * L::KV;
      const unsigned char* sv = smem + L::v + s * L::KV;
      // S = Q K^T: A = Q rows (k = head dim), B = K rows
      float acc_s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) acc_s[n][0] = acc_s[n][1] = acc_s[n][2] = acc_s[n][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA a;
        a.set(f32_ld<BM>(sq, lr, 8 * kk + t), f32_ld<BM>(sq, lr + 8, 8 * kk + t), f32_ld<BM>(sq, lr, 8 * kk + t + 4),
              f32_ld<BM>(sq, lr + 8, 8 * kk + t + 4));
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          FragB bk;
          bk.set(f32_ld<BN>(sk, 8 * n + g, 8 * kk + t), f32_ld<BN>(sk, 8 * n + g, 8 * kk + t + 4));
          mma_3xtf32(acc_s[n], a, bk);
          if (n % 4 == 3) asm volatile("" ::: "memory");
        }
        asm volatile("" ::: "memory");  // no loads hoisted from the next k-step: registers
      }
      // causal mask, only on tiles that reach past this warp's first row
      const int col0 = j * BN;
      if (col0 + BN - 1 > wrow0) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int c = col0 + 8 * n + 2 * t;
          if (c > r_lo) acc_s[n][0] = -INFINITY;
          if (c + 1 > r_lo) acc_s[n][1] = -INFINITY;
          if (c > r_hi) acc_s[n][2] = -INFINITY;
          if (c + 1 > r_hi) acc_s[n][3] = -INFINITY;
        }
      }
      // online softmax in base 2; the quad (lane / 4) shares the two rows.
      // Key tile j <= last_j starts at or before this warp's first row, so
      // every row has an unmasked key in it and the max is finite.
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(acc_s[n][0], acc_s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(acc_s[n][2], acc_s[n][3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo * LOG2E);
      const float mn_hi = fmaxf(m_hi, mx_hi * LOG2E);
      const float alpha_lo = exp2f(m_lo - mn_lo), alpha_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        acc_s[n][0] = exp2f(fmaf(acc_s[n][0], LOG2E, -mn_lo));
        acc_s[n][1] = exp2f(fmaf(acc_s[n][1], LOG2E, -mn_lo));
        acc_s[n][2] = exp2f(fmaf(acc_s[n][2], LOG2E, -mn_hi));
        acc_s[n][3] = exp2f(fmaf(acc_s[n][3], LOG2E, -mn_hi));
        sum_lo += acc_s[n][0] + acc_s[n][1];
        sum_hi += acc_s[n][2] + acc_s[n][3];
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc_o[n][0] *= alpha_lo;
        acc_o[n][1] *= alpha_lo;
        acc_o[n][2] *= alpha_hi;
        acc_o[n][3] *= alpha_hi;
      }
      // O += P V over the tile's 8-key blocks; k-index t is key 2t, t + 4
      // is key 2t + 1, in P's fragment and in V's rows alike
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        FragA p;
        p.set(acc_s[kc][0], acc_s[kc][2], acc_s[kc][1], acc_s[kc][3]);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          FragB bv;
          bv.set(f32_ld<BN>(sv, 8 * kc + 2 * t, 8 * n + g), f32_ld<BN>(sv, 8 * kc + 2 * t + 1, 8 * n + g));
          mma_3xtf32(acc_o[n], p, bv);
          if (n % 4 == 3) asm volatile("" ::: "memory");
        }
        asm volatile("" ::: "memory");
      }
    }
    // this warp is done with stage s; thread 0 refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (tid == 0 && j + STAGES < n_kv) {
      mbar_wait(empty(s), parity);
      load_kv(j + STAGES);
    }
    __syncwarp();
  }

  // epilogue: the quad's partial sums, then O / l and lse from registers
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  float* o_lo = o + ((static_cast<long long>(b) * S + r_lo) * H + h) * D + 2 * t;
  float* o_hi = o + ((static_cast<long long>(b) * S + r_hi) * H + h) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (r_lo < S) *reinterpret_cast<float2*>(o_lo + 8 * n) = make_float2(acc_o[n][0] * inv_lo, acc_o[n][1] * inv_lo);
    if (r_hi < S) *reinterpret_cast<float2*>(o_hi + 8 * n) = make_float2(acc_o[n][2] * inv_hi, acc_o[n][3] * inv_hi);
  }
  if (t == 0) {
    float* lse_bh = lse + (static_cast<long long>(b) * H + h) * S;
    if (r_lo < S) lse_bh[r_lo] = (m_lo + log2f(l_lo)) * LN2;
    if (r_hi < S) lse_bh[r_hi] = (m_hi + log2f(l_hi)) * LN2;
  }
}

// ------------------------------------------------------------------- host

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int S,
           const long long* st, cudaStream_t stream) {
  using L = Fwd<D>;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B, H, S, D, st, L::BM, 32, 4);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, BN, 32, 4);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, BN, 32, 4);
  if (e != 0) return e;
  auto kern = attn_fwd_sm90_f32_kernel<D>;
  cudaError_t ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  dim3 grid((S + L::BM - 1) / L::BM, H, B);
  kern<<<grid, L::NTHREADS, L::bytes, stream>>>(tq, tk, tv, static_cast<float*>(o), lse, H, S);
  return cudaGetLastError();
}

template <int D>
int occupancy(int* smem_bytes, int* ctas_per_sm) {
  using L = Fwd<D>;
  *smem_bytes = L::bytes;
  auto kern = attn_fwd_sm90_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, L::NTHREADS, L::bytes);
}

}  // namespace

// Same interface as rtt_attn_fwd_sm90.  dtype: 1 = float32 (the only one
// taken); Dh 64 or 128.  strides: 9 element strides (batch, seq, head) of
// q, k, v, each a multiple of 4 elements.  o is contiguous [B, S, H, D]
// float32; lse contiguous [B, H, S].  Returns 0, a cudaError_t, or an error
// code of sm90_common.cuh; rtt_error_string names it.
extern "C" int rtt_attn_fwd_sm90_f32(int dtype, int Dh, const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int H, int S, const long long* strides, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64>(q, k, v, o, lse, B, H, S, strides, st);
  if (Dh == 128) return launch<128>(q, k, v, o, lse, B, H, S, strides, st);
  return cudaErrorInvalidValue;
}

// The kernel's dynamic shared memory in bytes and how many of its CTAs fit
// on one SM (registers and shared memory together) at head dim Dh, for the
// build report.
extern "C" int rtt_attn_fwd_sm90_f32_occupancy(int Dh, int* smem_bytes, int* ctas_per_sm) {
  if (Dh == 64) return occupancy<64>(smem_bytes, ctas_per_sm);
  if (Dh == 128) return occupancy<128>(smem_bytes, ctas_per_sm);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
