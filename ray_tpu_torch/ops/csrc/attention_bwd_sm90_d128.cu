// Causal attention backward for Hopper (sm_90a), bf16, head dim 128.
//
// Replaces, at Llama's head dim, the TPU kernel that
// ray_tpu/ops/attention.py reaches through _splash_kernel (BlockSizes with
// use_fused_bwd_kernel=True):
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :2196 _splash_attention_bwd_dkv, the fused kernel giving dq, dk and dv
// (and, through causal_attention(impl="flash"), flash_attention.py:1121
// _flash_attention_bwd_dkv and :1456 _flash_attention_bwd_dq).  It computes
// what attention_bwd_sm90.cu computes at head dim 64, with splash's
// conventions: q arrives pre-scaled by sm_scale; lse is the natural-log
// logsumexp of the scaled scores; di = rowsum(dO * O) in f32; P = exp(S -
// lse) is recomputed, never stored; dq, dk, dv come back in q's dtype.
// q, k, v are [B, S, H, 128] bf16 with any batch/seq/head strides
// (multiples of 16 bytes); o, dO and the outputs are contiguous
// [B, S, H, 128] bf16.
//
// What bounds it on an H100.  At Llama-2-7B's training shape (B=1, S=2048,
// H=32, D=128) the backward does five products over the causal pairs,
// 10*D*B*H*S(S+1)/2 = 8.6e10 FLOP, against 134 MB to move: 0.087 ms at the
// 989 TFLOP/s bf16 peak against 0.040 ms at 3.35 TB/s.  It is bound by the
// tensor cores, so all five products run as wgmma, and P and dS stay on the
// SM.
//
// What the design does about it.  The D=64 design (attention_bwd_sm90.cu:
// the products with the operands swapped so that P^T and dS^T are born in
// registers, dK and dV held in registers across the q tiles, dq added by
// bulk reduce-add into an f32 accumulator of whole 64-row tiles) carried
// to D=128, where it breaks in three places:
//   - Registers.  dK and dV of 64 keys are 2 x 64 floats a thread at D=128,
//     and S^T and dP^T add 2 x 32: past what a thread may hold at three
//     CTAs (or two) per SM.  So one CTA of two warpgroups runs on each SM,
//     each thread with up to 255 registers; each warpgroup owns 64 of the
//     CTA's 128 keys, and both read one Q/dO ring.  A third warpgroup (or
//     warp) that only loads would cost every thread its registers: at 9 to
//     12 warps a CTA, ptxas gives each thread at most 168 and spilled,
//     with setmaxnreg at 24/240 and at 40/232 alike.
//   - Tiles are 256 bytes a row.  Every tile is loaded by TMA as two
//     64-column halves (the 128-byte swizzle takes at most 128 bytes a box
//     row), each a stack of 8-row x 128-byte atoms.  (1) and (2) reduce over
//     D in eight k-steps, 0-3 inside the first half and 4-7 inside the
//     second.  (3) and (4) are 128 wide (wgmma m64n128k16, dO and Q read
//     MN-major across both halves: the leading byte offset is the step
//     between them).
//   - dQ = dS K reduces over the CTA's 128 keys, both warpgroups' dS^T:
//     each writes its 64 rows of dS^T (double-buffered, so one barrier
//     of the two warpgroups a q tile suffices) and computes the 64 columns
//     of dQ in its half of K, m64n64k16 over eight k-steps.
// The products, for warpgroup w (keys 64w .. 64w+63 of the CTA):
//   (1) S^T  = K_w Q^T   A = K_w (K-major), B = Q  (K-major)       m64n64
//   (2) dP^T = V_w dO^T  A = V_w (K-major), B = dO (K-major)       m64n64
//   (3) dV_w += P^T dO   A = P^T (registers), B = dO (MN-major)    m64n128
//   (4) dK_w += dS^T Q   A = dS^T (registers), B = Q (MN-major)    m64n128
//   (5) dQ[:, 64w:] = dS K[:, 64w:]  A = dS (MN-major, from dS^T),
//                                    B = K half w (MN-major)       m64n64
// Thread 0 loads K and V of the CTA's keys once, then each 64-row q tile's
// Q and dO into a ring of 2 stages, completed on "full" mbarriers; it
// refills a stage once every warp has arrived on its "empty" mbarrier.  The
// first warpgroup's threads stage each tile's lse (times log2 e, +inf past
// S so P = 0 there) and di one tile ahead.  A q tile wholly above a
// warpgroup's keys (the CTA's first, for the second warpgroup) is skipped:
// its dS^T rows are zero.  Each warpgroup stages its dQ half (f32, 16 KB,
// in 8-column blocks) and adds it with one cp.reduce.async.bulk into the
// accumulator, which keeps each (batch, head, 64-row tile) as one 32 KB
// block of 16 blocks [64 rows][8].  The adds go in the order of the key
// tiles (sm90_common.cuh's semaphores: both halves of key tile kt wait
// until the q tile's count reads 2 kt; each bumps it once its reduce has
// completed, which it waits for halfway through the next q tile: earlier
// stalls the warpgroup, later delays the next key tile), so dq is the
// same from run to run.  A CTA walks its q tiles from the last down to its
// diagonal, so that every key tile reaches a q tile at the same time and
// kt trails kt - 1 only by the add; walked upwards, kt would reach each q
// tile two tiles before kt - 1 and wait there every time, which at one CTA
// an SM leaves the SM idle.  The pre- and postprocess kernels (di, the
// cast of dq) are sm90_common.cuh's, at D=128.
// Later work (ROADMAP): a persistent grid, overlapping one warpgroup's
// products with the other's elementwise work.
//
// Plain C interface, loaded with ctypes: the entry point launches its three
// kernels on the caller's stream, allocates nothing, and returns an error
// code (0 on success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int D = 128;    // head dim: two 64-column halves of 128-byte swizzle rows
constexpr int ROW = 128;  // bytes of one row of one half
constexpr int BN = 128;   // keys per CTA: two warpgroups of 64
constexpr int BM = 64;    // q rows per tile
// Two warpgroups and nothing else: at 9 to 12 warps a CTA, an SM
// sub-partition holds three of them and every thread gets at most 168
// registers, which dK and dV (128 floats) beside S^T and dP^T (64) overflow.
constexpr int NTHREADS = 256;
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int KH = BN * ROW;     // one half of the K or V tile (128 keys)
  static constexpr int QH = BM * ROW;     // one half of a Q or dO tile (64 rows)
  static constexpr int DS = BN * BM * 2;  // dS^T, [128 keys][64 q rows] bf16
  static constexpr int DQ = BM * 64 * 4;  // one warpgroup's f32 dQ half, [8][64 rows][8]
  static constexpr int k = 0;
  static constexpr int v = k + 2 * KH;
  static constexpr int q = v + 2 * KH;
  static constexpr int dout = q + STAGES * 2 * QH;
  static constexpr int ds = dout + STAGES * 2 * QH;
  static constexpr int dq = ds + 2 * DS;
  static constexpr int stats = dq + 2 * DQ;                 // [STAGES][lse log2e (64), di (64)] f32
  static constexpr int bar = stats + STAGES * 2 * BM * 4;  // mbarriers: kv, full[STAGES], empty[STAGES]
  static constexpr int bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// The accumulator as A fragments: k16 chunk kk is n8 chunks 2kk and 2kk+1,
// rounded to bf16 pairs.
__device__ __forceinline__ void to_a_fragments(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) a[kk][w] = pack_bf16(acc[8 * kk + 2 * w], acc[8 * kk + 2 * w + 1]);
}

// A 64 x 128 f32 accumulator, rounded to bf16, into rows [row0, row0 + 64)
// of a tile stored as two 64-column halves `half_bytes` apart, 128-byte
// swizzled: chunk i (16 bytes) of row r sits at chunk i ^ (r % 8).
__device__ __forceinline__ void store_swizzled(unsigned char* tile, int half_bytes, int row0, const float (&acc)[64],
                                               int r_lo, int c_off) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    unsigned char* t = tile + (i / 8) * half_bytes + row0 * ROW;
    const int chunk = ((i % 8) ^ (r_lo % 8)) * 16 + 2 * c_off;  // row r_lo + 8 has the same phase
    *reinterpret_cast<uint32_t*>(t + r_lo * ROW + chunk) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(t + (r_lo + 8) * ROW + chunk) = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ----------------------------------------------------------------- kernel

// Grid: (H, B, key tiles of 128).  256 threads: warpgroup w owns keys
// [col0 + 64w, col0 + 64w + 64); thread 0 also issues every TMA load.  The
// accumulator fragment layout (m64nN): thread t of a warpgroup holds rows
// 16(t/32) + (t%32)/4 and that + 8, columns 8i + 2(t%4) and that + 1, as
// acc[4i .. 4i+3].
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_sm90_d128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq_acc,
                          int* __restrict__ sem, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::bar;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int col0 = kt * BN;
  const int n_q = (S + BM - 1) / BM;
  const int q_first = col0 / BM;    // the first q tile at or below the diagonal
  const int n_it = n_q - q_first;
  const long long bh = static_cast<long long>(b) * H + h;
  float* stats = reinterpret_cast<float*>(smem + L::stats);

  // lse (base 2) and di of q tile j's rows, one value for each thread of
  // warpgroup 0, for the buffer stats[it % 2] of the iteration that takes
  // it; +inf past S makes P 0 there
  // (TMA's zero fill of Q alone would give exp2(-lse) instead)
  auto load_stat = [&](int j) {
    const int row = (q_first + j) * BM + tid % BM;
    if (row >= S) return tid < BM ? INFINITY : 0.f;
    return tid < BM ? lse[bh * S + row] * LOG2E : di[bh * S + row];
  };
  if (tid < 2 * BM) stats[tid] = load_stat(n_it - 1);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NTHREADS / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0 issues every TMA load: K and V once, Q and dO through the ring
  // the q tiles are walked from the last down to the diagonal: iteration it
  // takes tile n_it - 1 - it (see the dq order above)
  auto load_q_tile = [&](int it) {
    const int s = it % STAGES, row0 = (q_first + n_it - 1 - it) * BM;
    const uint32_t sq = base + L::q + s * 2 * L::QH, sdo = base + L::dout + s * 2 * L::QH;
    mbar_expect_tx(full(s), 4 * L::QH);
    tma_load(sq, &tq, full(s), h, row0, b, 0);
    tma_load(sq + L::QH, &tq, full(s), h, row0, b, 64);
    tma_load(sdo, &tdo, full(s), h, row0, b, 0);
    tma_load(sdo + L::QH, &tdo, full(s), h, row0, b, 64);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 4 * L::KH);
    tma_load(base + L::k, &tk, bar_kv, h, col0, b, 0);
    tma_load(base + L::k + L::KH, &tk, bar_kv, h, col0, b, 64);
    tma_load(base + L::v, &tv, bar_kv, h, col0, b, 0);
    tma_load(base + L::v + L::KH, &tv, bar_kv, h, col0, b, 64);
    for (int it = 0; it < STAGES && it < n_it; ++it) load_q_tile(it);
  }

  const int r_lo = 16 * warp + lane / 4;  // local rows: keys of this warpgroup in S^T, dK, dV; q rows in dQ
  const int r_hi = r_lo + 8;
  const int c_off = 2 * (lane % 4);  // column pair in each n8 chunk: q rows in S^T, dims in dQ
  const bool leader = tid % 128 == 0;
  const uint32_t k_rows = base + L::k + wg * 64 * ROW, v_rows = base + L::v + wg * 64 * ROW;
  const uint64_t desc_k_mn = mnmajor_desc(base + L::k + wg * L::KH);  // K half wg, all 128 keys, for (5)
  float* dq_bh = dq_acc + bh * n_q * (BM * D);
  int* sem_bh = sem + bh * n_q;  // dQ halves added to each q tile so far

  float acc_dk[64], acc_dv[64];
  zero(acc_dk);
  zero(acc_dv);

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int j = n_it - 1 - it, s = it % STAGES;  // j: the q tile, from the CTA's diagonal
    const float next_stat = it + 1 < n_it && tid < 2 * BM ? load_stat(j - 1) : 0.f;  // stored before bar 1
    const float* lse2 = stats + (it % 2) * 2 * BM;  // visible since the previous tile's bar 1
    const float* dis = lse2 + BM;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t sq = base + L::q + s * 2 * L::QH, sdo = base + L::dout + s * 2 * L::QH;
    unsigned char* sds = smem + L::ds + (it % 2) * L::DS + wg * 64 * ROW;  // this warpgroup's rows of dS^T

    if (j < wg) {
      // the q tile lies wholly above this warpgroup's keys: dS^T = 0
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(sds + r_lo * ROW + i * 16 + 2 * c_off) = 0u;
        *reinterpret_cast<uint32_t*>(sds + r_hi * ROW + i * 16 + 2 * c_off) = 0u;
      }
    } else {
      // (1) S^T = K Q^T and (2) dP^T = V dO^T, two groups: P needs only the first
      float acc_s[32], acc_dp[32];
      zero(acc_s);
      zero(acc_dp);
      wgmma_fence();
      fence_regs(acc_s);
      fence_regs(acc_dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, step = kk % 4;
        wgmma_ss<0, 0>(acc_s, kmajor_desc(k_rows + hf * L::KH) + 2 * step,
                       kmajor_desc(sq + hf * L::QH) + 2 * step, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, step = kk % 4;
        wgmma_ss<0, 0>(acc_dp, kmajor_desc(v_rows + hf * L::KH) + 2 * step,
                       kmajor_desc(sdo + hf * L::QH) + 2 * step, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc_s);

      // P^T = exp2(S^T log2e - lse log2e); on this warpgroup's diagonal
      // tile (j == wg) keys after the q row are masked
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? r_lo : r_hi, qc = 8 * i + c_off + (e & 1);
          const float p = exp2f(fmaf(acc_s[4 * i + e], LOG2E, -lse2[qc]));
          acc_s[4 * i + e] = (j == wg && key > qc) ? 0.f : p;
        }
      wgmma_wait<0>();
      fence_regs(acc_dp);
      // dS^T = P^T (dP^T - di)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_dp[4 * i + e] = acc_s[4 * i + e] * (acc_dp[4 * i + e] - dis[8 * i + c_off + (e & 1)]);
      uint32_t pf[4][4], dsf[4][4];
      to_a_fragments(acc_s, pf);
      to_a_fragments(acc_dp, dsf);

      // (3) dV += P^T dO and (4) dK += dS^T Q, A from registers, B
      // MN-major with N = 128 across both halves
      const uint64_t desc_do = mnmajor_desc_n128(sdo, L::QH), desc_q = mnmajor_desc_n128(sq, L::QH);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs(acc_dv, pf[kk], desc_do + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs(acc_dk, dsf[kk], desc_q + 128 * kk);
      wgmma_commit();

      // this warpgroup's rows of dS^T (q contiguous, 128-byte swizzled),
      // while (3) and (4) run.  This buffer was last read by (5) two
      // tiles ago, which both warpgroups finished before the last barrier.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int chunk = (i ^ (r_lo % 8)) * 16 + 2 * c_off;  // r_hi % 8 == r_lo % 8
        *reinterpret_cast<uint32_t*>(sds + r_lo * ROW + chunk) = dsf[i / 2][2 * (i % 2)];
        *reinterpret_cast<uint32_t*>(sds + r_hi * ROW + chunk) = dsf[i / 2][2 * (i % 2) + 1];
      }
    }
    fence_async_smem();
    // stats[(j+1) % 2] was last read by tile j - 1, before the last bar 1
    if (it + 1 < n_it && tid < 2 * BM) stats[((it + 1) % 2) * 2 * BM + tid] = next_stat;
    if (leader && it > 0) {  // the previous tile's add is done: the staging half is free, the next key tile's turn
      bulk_wait_done();
      sem_release(sem_bh + q_first + j + 1);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(NTHREADS) : "memory");  // all of dS^T and the next stats written

    // (5) dQ[:, 64wg:] = dS K[:, 64wg:]: A = dS read transposed from dS^T,
    // B = K half wg MN-major; eight k-steps of 16 keys
    float acc_dq[32];
    zero(acc_dq);
    const uint64_t desc_ds = mnmajor_desc(base + L::ds + (it % 2) * L::DS);
    wgmma_fence();
    fence_regs(acc_dq);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_ss<1, 1>(acc_dq, desc_ds + 128 * kk, desc_k_mn + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    if (tid == 0 && it + STAGES < n_it) {  // refill stage s once every warp is done with it
      mbar_wait(empty(s), (it / STAGES) & 1);
      load_q_tile(it + STAGES);
    }

    // dQ to the staging half in 8-column blocks: element (r, c) at
    // ((c / 8) * 64 + r) * 8 + c % 8, so a warp's float2 stores are contiguous
    float* sdq = reinterpret_cast<float*>(smem + L::dq + wg * L::DQ);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float2*>(sdq + (i * 64 + r_lo) * 8 + c_off) = make_float2(acc_dq[4 * i], acc_dq[4 * i + 1]);
      *reinterpret_cast<float2*>(sdq + (i * 64 + r_hi) * 8 + c_off) =
          make_float2(acc_dq[4 * i + 2], acc_dq[4 * i + 3]);
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");  // this warpgroup's dQ stores are done
    if (leader) {
      sem_wait(sem_bh + q_first + j, 2 * kt);  // both halves of key tiles 0 .. kt-1 are added
      bulk_reduce_add(dq_bh + static_cast<long long>(q_first + j) * (BM * D) + wg * (BM * 64),
                      base + L::dq + wg * L::DQ, L::DQ);
    }
  }

  // epilogue: dK and dV in bf16 through the K and V tiles, once both
  // warpgroups' last (5) has read K, then out as 16-byte stores of whole rows
  asm volatile("bar.sync 1, %0;" ::"n"(NTHREADS) : "memory");
  store_swizzled(smem + L::k, L::KH, 64 * wg, acc_dk, r_lo, c_off);
  store_swizzled(smem + L::v, L::KH, 64 * wg, acc_dv, r_lo, c_off);
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int wt = tid % 128;
#pragma unroll
  for (int it = 0; it < 64 * (D / 8) / 128; ++it) {
    const int idx = it * 128 + wt, r = 64 * wg + idx / (D / 8), c = idx % (D / 8);
    const int key = col0 + r;
    if (key < S) {
      const long long off = ((static_cast<long long>(b) * S + key) * H + h) * D + c * 8;
      const int at = (c / 8) * L::KH + r * ROW + ((c % 8) ^ (r % 8)) * 16;
      *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(smem + L::k + at);
      *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(smem + L::v + at);
    }
  }
  if (leader) {  // the last add (the diagonal tile's) is done: the next key tile's turn
    bulk_wait_done();
    sem_release(sem_bh + q_first);
  }
}

// ------------------------------------------------------------------- host

int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* di,
           float* dq_acc, int* sem, void* dq, void* dk, void* dv, int B, int H, int S, const long long* st,
           cudaStream_t stream) {
  using L = Smem;
  const long long contiguous[3] = {static_cast<long long>(S) * H * D, static_cast<long long>(H) * D, D};
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map(&tq, q, B, H, S, D, st, BM, 64);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, BN, 64);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, BN, 64);
  if (e == 0) e = make_map(&tdo, dout, B, H, S, D, contiguous, BM, 64);
  if (e != 0) return e;
  const int n_q = (S + BM - 1) / BM;
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned row_blocks = static_cast<unsigned>((rows * (D / 8) + 255) / 256);

  cudaError_t ce = cudaMemsetAsync(dq_acc, 0, static_cast<size_t>(B) * H * n_q * BM * D * sizeof(float), stream);
  if (ce == cudaSuccess) ce = cudaMemsetAsync(sem, 0, static_cast<size_t>(B) * H * n_q * sizeof(int), stream);
  if (ce != cudaSuccess) return ce;
  attn_bwd_sm90_pre_kernel<D><<<row_blocks, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                              static_cast<const bf16*>(dout), di, H, S, rows);
  if ((ce = cudaGetLastError()) != cudaSuccess) return ce;
  auto kern = attn_bwd_sm90_d128_kernel;
  ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  kern<<<dim3(H, B, (S + BN - 1) / BN), NTHREADS, L::bytes, stream>>>(
      tq, tk, tv, tdo, lse, di, dq_acc, sem, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S);
  if ((ce = cudaGetLastError()) != cudaSuccess) return ce;
  attn_bwd_sm90_post_kernel<D, BM><<<row_blocks, 256, 0, stream>>>(dq_acc, static_cast<bf16*>(dq), H, S, rows);
  return cudaGetLastError();
}

}  // namespace

// Same interface as rtt_attn_bwd_sm90.  dtype: 0 = bfloat16 (the only one
// taken); Dh must be 128.  strides: 9 element strides (batch, seq, head) of
// q, k, v, each a multiple of 8 elements.  o, dout, dq, dk, dv are
// contiguous [B, S, H, D] bf16; lse and di (written here) contiguous
// [B, H, S] f32.  dq_acc: f32 scratch of B * H * ceil(S / 64) * 64 * D
// elements, and sem: int scratch of B * H * ceil(S / 64), both zeroed
// here.  Returns 0, a cudaError_t, or an error code of
// sm90_common.cuh; rtt_error_string names it.
extern "C" int rtt_attn_bwd_sm90_d128(int dtype, int Dh, const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* di, float* dq_acc, int* sem,
                                      void* dq, void* dk, void* dv, int B, int H, int S, const long long* strides,
                                      void* stream) {
  if (dtype != 0 || Dh != D) return cudaErrorInvalidValue;
  return launch(q, k, v, o, dout, lse, di, dq_acc, sem, dq, dk, dv, B, H, S, strides,
                static_cast<cudaStream_t>(stream));
}

// The main kernel's dynamic shared memory in bytes and how many of its CTAs
// fit on one SM (registers and shared memory together), for the build report.
extern "C" int rtt_attn_bwd_sm90_d128_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = Smem::bytes;
  cudaError_t e =
      cudaFuncSetAttribute(attn_bwd_sm90_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, attn_bwd_sm90_d128_kernel, NTHREADS, Smem::bytes);
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
