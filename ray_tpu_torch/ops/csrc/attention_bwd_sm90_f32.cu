// Causal attention backward for Hopper (sm_90a), float32, head dim 64 or 128.
//
// Replaces, for float32 inputs, the TPU kernel that ray_tpu/ops/attention.py
// reaches through _splash_kernel (BlockSizes with use_fused_bwd_kernel=True):
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :2196 _splash_attention_bwd_dkv, the fused kernel giving dq, dk and dv
// (and, through causal_attention(impl="flash"), flash_attention.py:1121
// _flash_attention_bwd_dkv and :1456 _flash_attention_bwd_dq).  It computes
// what attention_bwd_sm90.cu computes for bf16, with splash's conventions:
// q arrives pre-scaled by sm_scale; lse is the natural-log logsumexp of the
// scaled scores; di = rowsum(dO * O) in f32; P = exp(S - lse) is
// recomputed, never stored.  q, k, v are [B, S, H, D] float32 with any
// batch/seq/head strides (multiples of 16 bytes); o, dO and the outputs dq,
// dk, dv are contiguous [B, S, H, D] float32.
//
// What bounds it on an H100.  At phase (h)'s shape (B=4, H=12, S=1024,
// D=64) the backward does five products over the causal pairs,
// 10*D*B*H*S(S+1)/2 = 1.6e10 FLOP, against 101 MB to move: 0.24 ms at the
// 67 TFLOP/s FP32 peak of the CUDA cores, 0.030 ms at 3.35 TB/s.  So, as in
// attention_fwd_sm90_f32.cu, the products run on the tensor cores as
// 3xTF32 (hi*hi + hi*lo + lo*hi of TF32 splits, f32 accumulate: float32's
// accuracy), whose bound is 165 TFLOP/s of float32 products (0.098 ms).
//
// What the design does about it.
//   - mma.sync m16n8k8 TF32, the split in registers (sm90_common.cuh).
//     wgmma's TF32 form takes K-major shared-memory operands only, and three
//     of the five products read an operand the other way (P^T dO, dS^T Q,
//     dS K); mma.sync has no layout rule there.
//   - One CTA of NW warps per (16 * NW keys, head, batch) walks the 64-row q
//     tiles at and below its diagonal, as attention_bwd_sm90.cu does; warp w
//     owns keys 16w .. 16w + 15 of the CTA.  K and V are loaded once by TMA;
//     Q and dO stream through a ring of 2 stages (TMA, mbarriers).  Tiles
//     lie in shared memory as 32-column boxes in the 128-byte swizzle, so
//     the row loads (row g, column t) and the column gathers (row 2t, column
//     g) below hit 32 different banks.
//   - The products, per warp (rows = its 16 keys):
//       (1) S^T  = K Q^T     A = K rows,  B = Q rows
//       (2) dP^T = V dO^T    A = V rows,  B = dO rows
//       (3) dV  += P^T dO    A = P^T (registers), B = dO columns
//       (4) dK  += dS^T Q    A = dS^T (registers), B = Q columns
//       (5) dQ   = dS K      A = dS (shared memory), B = K columns; the
//                            CTA's warps split dQ's 64 rows x D columns
//     (3) and (4) take A straight from the (1)/(2) accumulators, the 8 q
//     rows of each k-step taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (the
//     accumulator holds columns 2t and 2t + 1 where the A fragment wants t
//     and t + 4), and the B rows in the same order; (5) reads dS in that
//     order too, as 8-byte loads.  dS^T goes to shared memory as dS, [64 q
//     rows][keys + 8] f32: the pad makes (5)'s loads conflict-free.
//   - P = exp2(S^T log2e - lse log2e), the causal mask only where a warp's
//     keys cross the q tile's rows; a warp whose keys all lie after the q
//     tile skips (1)-(4) and writes zeros to dS.  q rows past S get lse =
//     +inf, so P = 0 there.
//   - dK and dV stay in registers across the q tiles and leave once.
//   - dq: each q tile's dQ is added to dq (f32, zeroed by the entry point)
//     in the order of the key tiles: the warps of key tile kt wait until the
//     tile's semaphore (sm90_common.cuh) reads kt, add their part with
//     reductions to device memory, fence, and thread 0 bumps it at the next
//     q tile's first barrier.  Every element gets one add per key tile, in
//     that order, so dq is the same from run to run.  A CTA walks its q
//     tiles from the last down to its diagonal, so that every key tile
//     reaches a q tile at the same time and kt trails kt - 1 by one tile
//     (walked upwards, kt would reach each tile before kt - 1 and wait).
//   - di comes from a small kernel here, one row per D/4 threads.
//
// Plain C interface, loaded with ctypes: the entry point launches its two
// kernels on the caller's stream, allocates nothing, and returns an error
// code (0 on success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 64;  // q rows a tile
constexpr float LOG2E = 1.4426950408889634f;

// D=64: 8 warps (128 keys), 164 KB, one CTA an SM (4 warps and one stage,
// two CTAs an SM, ran no faster).  D=128: 4 warps (64 keys), 212 KB: 8
// warps' K and V (128 KB) leave no room for two stages.
template <int D>
struct Bwd {
  static constexpr int NW = D == 64 ? 8 : 4;
  static constexpr int STAGES = 2;  // of the Q/dO ring
  static constexpr int QC = D == 64 ? 32 : 16;  // q rows of a tile that (1)-(4) take at a time
  static constexpr int BN = 16 * NW;  // keys a CTA
  static constexpr int NTHREADS = 32 * NW;
  static constexpr int DS_LD = BN + 8;  // row stride of dS in floats
  static constexpr int KV = BN * D * 4;  // the K or the V tile
  static constexpr int QT = BM * D * 4;  // one Q or dO tile
  static constexpr int k = 0;            // byte offsets from a 1024-byte aligned base
  static constexpr int v = k + KV;
  static constexpr int q = v + KV;
  static constexpr int dout = q + STAGES * QT;
  static constexpr int ds = dout + STAGES * QT;
  static constexpr int stats = ds + BM * DS_LD * 4;  // lse log2e (64), di (64) of the next q tile
  static constexpr int bar = stats + 2 * BM * 4;     // mbarriers: kv, full[STAGES]
  static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;  // + alignment slack
};

// ----------------------------------------------------------------- kernels

// di[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d], f32 rows [B, S, H, D]:
// D / 4 threads a row, 16 bytes each, summed in a fixed order.
template <int D>
__global__ void attn_bwd_sm90_f32_pre_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                             float* __restrict__ di, int H, int S, long long rows) {
  constexpr int TPR = D / 4;
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = gi / TPR;  // row of [B, S, H]
  const int part = static_cast<int>(gi % TPR);
  float sum = 0.f;
  if (n < rows) {
    const float4 a = *reinterpret_cast<const float4*>(o + n * D + part * 4);
    const float4 c = *reinterpret_cast<const float4*>(dout + n * D + part * 4);
    sum = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, a.w * c.w)));
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (n < rows && part == 0) {
    const long long b = n / (static_cast<long long>(S) * H);
    const int s = static_cast<int>((n / H) % S), h = static_cast<int>(n % H);
    di[(b * H + h) * S + s] = sum;
  }
}

// Grid: (H, B, key tiles of BN).  Thread (g = lane / 4, t = lane % 4) of
// warp w holds, in the (1)-(4) accumulators, keys 16w + g and 16w + g + 8
// (rows) and q rows 8n + 2t and 8n + 2t + 1 (dK and dV: head dims) of each
// n8 block n.
template <int D>
__global__ void __launch_bounds__(Bwd<D>::NTHREADS)
attn_bwd_sm90_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ di, int* __restrict__ sem,
                         float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int H, int S) {
  using L = Bwd<D>;
  constexpr int BN = L::BN, NW = L::NW, STAGES = L::STAGES, QC = L::QC;
  constexpr int NB = D / 8, NQC = QC / 8;  // n8 blocks of the head dims, of a chunk's q rows
  // (1)-(2)'s k-steps unrolled at D=64; at D=128 a loop, whose addressing
  // at run time leaves dK and dV (128 registers) room without spills
  constexpr int KK_UNROLL = D == 64 ? D / 8 : 1;
  constexpr int DQ_COLS = D / (NW / 4);  // (5): 4 warps across the q rows, NW / 4 across the head dims
  constexpr int DQ_UNROLL = D == 64 ? DQ_COLS / 32 : 1;  // (5)'s passes of 32 head dims: one at D=64
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::bar;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int col0 = kt * BN;
  const int n_q = (S + BM - 1) / BM;
  const int q_first = col0 / BM;  // the first q tile at or below the diagonal
  const int n_it = n_q - q_first;
  const long long bh = static_cast<long long>(b) * H + h;
  int* sem_bh = sem + bh * n_q;  // key tiles added to each q tile so far
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  float* sds = reinterpret_cast<float*>(smem + L::ds);

  // lse (base 2) and di of q tile j's rows, one value for each of the first
  // 128 threads; +inf past S makes P 0 there (TMA's zero fill of Q alone
  // would give exp2(-lse) instead)
  auto load_stat = [&](int j) {
    const int row = (q_first + j) * BM + tid % BM;
    if (row >= S) return tid < BM ? INFINITY : 0.f;
    return tid < BM ? lse[bh * S + row] * LOG2E : di[bh * S + row];
  };
  if (tid < 2 * BM) stats[tid] = load_stat(n_it - 1);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the q tiles are walked from the last down to the diagonal (see dq
  // above): iteration it takes tile n_it - 1 - it
  auto load_q_tile = [&](int it) {  // Q and dO of iteration it into stage it % STAGES
    const int s = it % STAGES, row0 = (q_first + n_it - 1 - it) * BM;
    mbar_expect_tx(full(s), 2 * L::QT);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      tma_load(base + L::q + s * L::QT + c * BM * 128, &tq, full(s), h, row0, b, 32 * c);
      tma_load(base + L::dout + s * L::QT + c * BM * 128, &tdo, full(s), h, row0, b, 32 * c);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::KV);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      tma_load(base + L::k + c * BN * 128, &tk, bar_kv, h, col0, b, 32 * c);
      tma_load(base + L::v + c * BN * 128, &tv, bar_kv, h, col0, b, 32 * c);
    }
    for (int it = 0; it < STAGES && it < n_it; ++it) load_q_tile(it);
  }

  const unsigned char* sk = smem + L::k;
  const unsigned char* sv = smem + L::v;
  const int kr = 16 * warp + g;  // this thread's low key in the CTA's tile; the high one is kr + 8
  const int qr = 16 * (warp % 4);                // (5): this warp's first q row of the tile
  const int d0 = DQ_COLS * (warp / 4);           // (5): and its first head dim
  const float* lse2 = stats;
  const float* dis = stats + BM;

  float acc_dk[NB][4], acc_dv[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int j = n_it - 1 - it, s = it % STAGES, qt = q_first + j, qrow0 = qt * BM;
    const float next_stat = it + 1 < n_it && tid < 2 * BM ? load_stat(j - 1) : 0.f;  // stored after barrier 1
    // barrier 0: every warp is done with the previous tile's (5), so dS is
    // free, and has added and fenced its part of that tile's dQ: the next
    // key tile's turn there
    __syncthreads();
    if (tid == 0 && it > 0) sem_release(sem_bh + qt + 1);
    mbar_wait(full(s), (it / STAGES) & 1);
    const unsigned char* sq = smem + L::q + s * L::QT;
    const unsigned char* sdo = smem + L::dout + s * L::QT;
    const int key0 = col0 + 16 * warp;  // this warp's first key

    // (1)-(4) over QC q rows at a time, so that S^T and dP^T take QC / 2
    // registers each beside dK and dV
#pragma unroll 1
    for (int q0 = 0; q0 < BM; q0 += QC) {
      const bool active = qrow0 + q0 + QC - 1 >= key0;  // some q row of the chunk sees a key of this warp
      const bool diag = qrow0 + q0 < key0 + 15;         // some (q row, key) pair is masked
      float acc_s[NQC][4], acc_dp[NQC][4];              // S^T, then P^T; dP^T, then dS^T
      if (active) {
        // (1) S^T = K Q^T and (2) dP^T = V dO^T, reducing over the head dims
#pragma unroll
        for (int n = 0; n < NQC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_s[n][e] = acc_dp[n][e] = 0.f;
#pragma unroll (KK_UNROLL)
        for (int kk = 0; kk < D / 8; ++kk) {
          const int c = 8 * kk + t;
          FragA ak, av;
          ak.set(f32_ld<BN>(sk, kr, c), f32_ld<BN>(sk, kr + 8, c), f32_ld<BN>(sk, kr, c + 4),
                 f32_ld<BN>(sk, kr + 8, c + 4));
          av.set(f32_ld<BN>(sv, kr, c), f32_ld<BN>(sv, kr + 8, c), f32_ld<BN>(sv, kr, c + 4),
                 f32_ld<BN>(sv, kr + 8, c + 4));
#pragma unroll
          for (int n = 0; n < NQC; ++n) {
            const int r = q0 + 8 * n + g;
            FragB bq, bd;
            bq.set(f32_ld<BM>(sq, r, c), f32_ld<BM>(sq, r, c + 4));
            bd.set(f32_ld<BM>(sdo, r, c), f32_ld<BM>(sdo, r, c + 4));
            mma_3xtf32(acc_s[n], ak, bq);
            mma_3xtf32(acc_dp[n], av, bd);
          }
          asm volatile("" ::: "memory");  // loads stay in their k-step: registers
        }
        // P^T = exp2(S^T log2e - lse log2e), keys after the q row masked;
        // dS^T = P^T (dP^T - di)
#pragma unroll
        for (int n = 0; n < NQC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + g + (e & 2) * 4, qc = q0 + 8 * n + 2 * t + (e & 1);
            float p = exp2f(fmaf(acc_s[n][e], LOG2E, -lse2[qc]));
            if (diag && key > qrow0 + qc) p = 0.f;
            acc_s[n][e] = p;
            acc_dp[n][e] = p * (acc_dp[n][e] - dis[qc]);
          }
        // (3) dV += P^T dO and (4) dK += dS^T Q, reducing over the chunk's q rows
#pragma unroll
        for (int kc = 0; kc < NQC; ++kc) {
          FragA ap, ads;
          ap.set(acc_s[kc][0], acc_s[kc][2], acc_s[kc][1], acc_s[kc][3]);
          ads.set(acc_dp[kc][0], acc_dp[kc][2], acc_dp[kc][1], acc_dp[kc][3]);
          const int r = q0 + 8 * kc + 2 * t;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            FragB bd, bq;
            bd.set(f32_ld<BM>(sdo, r, 8 * n + g), f32_ld<BM>(sdo, r + 1, 8 * n + g));
            bq.set(f32_ld<BM>(sq, r, 8 * n + g), f32_ld<BM>(sq, r + 1, 8 * n + g));
            mma_3xtf32(acc_dv[n], ap, bd);
            mma_3xtf32(acc_dk[n], ads, bq);
            if (n % 2 == 1) asm volatile("" ::: "memory");
          }
        }
      }
      // dS^T into dS, [q row][key]
#pragma unroll
      for (int n = 0; n < NQC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sds[(q0 + 8 * n + 2 * t + (e & 1)) * L::DS_LD + kr + (e & 2) * 4] = active ? acc_dp[n][e] : 0.f;
    }
    // barrier 1: dS is written; every warp is done with stage s and with
    // this tile's stats
    __syncthreads();
    if (tid == 0 && it + STAGES < n_it) load_q_tile(it + STAGES);
    if (it + 1 < n_it && tid < 2 * BM) stats[tid] = next_stat;  // read after the next barrier 0

    // (5) dQ[qr .. qr+15, d0 .. d0+DQ_COLS) = dS K, reducing over the CTA's
    // keys, 32 head dims at a time (16 accumulator registers beside dK and
    // dV), each added once key tiles 0 .. kt-1 have added theirs
#pragma unroll (DQ_UNROLL)
    for (int ci = 0; ci < DQ_COLS / 32; ++ci) {
      const int dc = d0 + 32 * ci;
      float acc_dq[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc_dq[n][0] = acc_dq[n][1] = acc_dq[n][2] = acc_dq[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < BN / 8; ++kc) {
        const int key = 8 * kc + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(sds + (qr + g) * L::DS_LD + key);
        const float2 hi = *reinterpret_cast<const float2*>(sds + (qr + g + 8) * L::DS_LD + key);
        FragA a;
        a.set(lo.x, hi.x, lo.y, hi.y);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          FragB bk;
          bk.set(f32_ld<BN>(sk, key, dc + 8 * n + g), f32_ld<BN>(sk, key + 1, dc + 8 * n + g));
          mma_3xtf32(acc_dq[n], a, bk);
        }
        asm volatile("" ::: "memory");
      }
      if (ci == 0) {
        if (lane == 0) sem_wait(sem_bh + qt, kt);
        __syncwarp();
      }
      const int row_lo = qrow0 + qr + g, row_hi = row_lo + 8;
      float* dq_lo = dq + ((static_cast<long long>(b) * S + row_lo) * H + h) * D + dc + 2 * t;
      float* dq_hi = dq + ((static_cast<long long>(b) * S + row_hi) * H + h) * D + dc + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (row_lo < S) {
          atomicAdd(dq_lo + 8 * n, acc_dq[n][0]);
          atomicAdd(dq_lo + 8 * n + 1, acc_dq[n][1]);
        }
        if (row_hi < S) {
          atomicAdd(dq_hi + 8 * n, acc_dq[n][2]);
          atomicAdd(dq_hi + 8 * n + 1, acc_dq[n][3]);
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) sem_release(sem_bh + q_first);  // the next key tile's turn on the diagonal tile, the last one

  // epilogue: dK and dV from registers
  const int key_lo = col0 + kr, key_hi = key_lo + 8;
  const long long off_lo = ((static_cast<long long>(b) * S + key_lo) * H + h) * D + 2 * t;
  const long long off_hi = ((static_cast<long long>(b) * S + key_hi) * H + h) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (key_lo < S) {
      *reinterpret_cast<float2*>(dk + off_lo + 8 * n) = make_float2(acc_dk[n][0], acc_dk[n][1]);
      *reinterpret_cast<float2*>(dv + off_lo + 8 * n) = make_float2(acc_dv[n][0], acc_dv[n][1]);
    }
    if (key_hi < S) {
      *reinterpret_cast<float2*>(dk + off_hi + 8 * n) = make_float2(acc_dk[n][2], acc_dk[n][3]);
      *reinterpret_cast<float2*>(dv + off_hi + 8 * n) = make_float2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// ------------------------------------------------------------------- host

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* di,
           int* sem, float* dq, float* dk, float* dv, int B, int H, int S, const long long* st, cudaStream_t stream) {
  using L = Bwd<D>;
  const long long contiguous[3] = {static_cast<long long>(S) * H * D, static_cast<long long>(H) * D, D};
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map(&tq, q, B, H, S, D, st, BM, 32, 4);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, L::BN, 32, 4);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, L::BN, 32, 4);
  if (e == 0) e = make_map(&tdo, dout, B, H, S, D, contiguous, BM, 32, 4);
  if (e != 0) return e;
  const int n_q = (S + BM - 1) / BM;
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned row_blocks = static_cast<unsigned>((rows * (D / 4) + 255) / 256);

  cudaError_t ce = cudaMemsetAsync(dq, 0, static_cast<size_t>(rows) * D * sizeof(float), stream);
  if (ce == cudaSuccess) ce = cudaMemsetAsync(sem, 0, static_cast<size_t>(B) * H * n_q * sizeof(int), stream);
  if (ce != cudaSuccess) return ce;
  attn_bwd_sm90_f32_pre_kernel<D><<<row_blocks, 256, 0, stream>>>(static_cast<const float*>(o),
                                                                  static_cast<const float*>(dout), di, H, S, rows);
  if ((ce = cudaGetLastError()) != cudaSuccess) return ce;
  auto kern = attn_bwd_sm90_f32_kernel<D>;
  ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  kern<<<dim3(H, B, (S + L::BN - 1) / L::BN), L::NTHREADS, L::bytes, stream>>>(tq, tk, tv, tdo, lse, di, sem, dq, dk,
                                                                               dv, H, S);
  return cudaGetLastError();
}

template <int D>
int occupancy(int* smem_bytes, int* ctas_per_sm) {
  using L = Bwd<D>;
  *smem_bytes = L::bytes;
  auto kern = attn_bwd_sm90_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, L::NTHREADS, L::bytes);
}

}  // namespace

// dtype: 1 = float32 (the only one taken); Dh 64 or 128.  strides: 9
// element strides (batch, seq, head) of q, k, v, each a multiple of 4
// elements.  o, dout, dq, dk, dv are contiguous [B, S, H, D] float32; lse
// and di (written here) contiguous [B, H, S] float32.  sem: int scratch of
// B * H * ceil(S / 64); it and dq are zeroed here.  Returns 0, a
// cudaError_t, or an error code of sm90_common.cuh; rtt_error_string names
// it.
extern "C" int rtt_attn_bwd_sm90_f32(int dtype, int Dh, const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, float* di, int* sem, void* dq, void* dk,
                                     void* dv, int B, int H, int S, const long long* strides, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *fq = static_cast<float*>(dq), *fk = static_cast<float*>(dk), *fv = static_cast<float*>(dv);
  if (Dh == 64) return launch<64>(q, k, v, o, dout, lse, di, sem, fq, fk, fv, B, H, S, strides, st);
  if (Dh == 128) return launch<128>(q, k, v, o, dout, lse, di, sem, fq, fk, fv, B, H, S, strides, st);
  return cudaErrorInvalidValue;
}

// The main kernel's dynamic shared memory in bytes and how many of its CTAs
// fit on one SM (registers and shared memory together) at head dim Dh, for
// the build report.
extern "C" int rtt_attn_bwd_sm90_f32_occupancy(int Dh, int* smem_bytes, int* ctas_per_sm) {
  if (Dh == 64) return occupancy<64>(smem_bytes, ctas_per_sm);
  if (Dh == 128) return occupancy<128>(smem_bytes, ctas_per_sm);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
