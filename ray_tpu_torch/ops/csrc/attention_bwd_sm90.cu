// Causal attention backward for Hopper (sm_90a), bf16, head dim 64.
//
// Replaces the TPU kernel that ray_tpu/ops/attention.py reaches through
// _splash_kernel (BlockSizes with use_fused_bwd_kernel=True):
//   jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py
//   :2196 _splash_attention_bwd_dkv, the fused kernel giving dq, dk and dv
// (and, through causal_attention(impl="flash"), flash_attention.py:1121
// _flash_attention_bwd_dkv and :1456 _flash_attention_bwd_dq, which compute
// the same function).  It computes what splash's fused backward computes,
// with splash's conventions: q arrives pre-scaled by sm_scale; lse is the
// natural-log logsumexp of the scaled scores; di = rowsum(dO * O) in f32
// (splash_attention_kernel.py:2285); P = exp(S - lse) is recomputed, never
// stored; dq, dk, dv come back in q's dtype.  q, k, v are [B, S, H, 64]
// bf16 with any batch/seq/head strides (multiples of 16 bytes); o, dO and
// the outputs are contiguous [B, S, H, 64] bf16.  bf16 at head dim 128 goes
// to attention_bwd_sm90_d128.cu, float32 inputs to attn_bwd_kernel in
// causal_attention.cu.
//
// What bounds it on an H100.  At GPT-2 124M's shape (B=18, H=12, S=1024,
// D=64) the backward does five products over the causal pairs,
// 10*D*B*H*S(S+1)/2 = 7.3e10 FLOP, against 227 MB to move: 0.073 ms at the
// 989 TFLOP/s bf16 peak against 0.068 ms at 3.35 TB/s.  It is bound by the
// tensor cores, so all five products must run as wgmma, and the [S, S] P and
// dS must stay on the SM.
//
// What the design does about it.
//   - One CTA of one warpgroup per (64-key tile, head, batch) walks the q
//     tiles at and below its diagonal.  The grid's slowest dimension is the
//     key tile, so the tiles with the most q tiles (key tile 0) start first.
//   - K and V of the CTA's keys are loaded once by TMA.  64-row tiles of Q
//     and dO stream through a ring of STAGES by TMA, issued by one thread
//     and completed on mbarriers.  Every tile is a bf16 row of 64 = one
//     128-byte swizzle row (CU_TENSOR_MAP_SWIZZLE_128B, descriptor type 1).
//   - The products are wgmma m64n64k16 with the operands swapped so that
//     P^T and dS^T are born in registers (rows = keys, columns = q rows):
//       (1) S^T  = K  Q^T  A = K  (smem, K-major), B = Q  (smem, K-major)
//       (2) dP^T = V  dO^T A = V  (smem, K-major), B = dO (smem, K-major)
//       (3) dV  += P^T dO  A = P^T  (registers),   B = dO (smem, MN-major)
//       (4) dK  += dS^T Q  A = dS^T (registers),   B = Q  (smem, MN-major)
//       (5) dQ   = dS K    A = dS   (smem, MN-major: dS^T stored row by key),
//                          B = K  (smem, MN-major)
//     K-major: the reduction dimension is contiguous in each row (32-byte
//     k-steps inside the swizzle row, descriptor + 2).  MN-major: the tile is
//     read transposed (transpose immediate 1; k-steps of 16 rows, descriptor
//     + 128).  The Q, dO and K tiles are each read through both kinds of
//     descriptor.  (3) and (4) take A from registers: the f32 accumulator of
//     (1)/(2), rounded to bf16 pairs, is already the A fragment of a k16
//     chunk.  Only dS^T goes to shared memory (8 KB, bf16), for (5).
//   - P = exp2(S^T log2e - lse log2e) with lse by column; the causal mask
//     only on the diagonal tile; q rows past S get lse = +inf, so P = 0
//     there (TMA's zero fill of Q alone would give exp2(-lse) instead).
//   - dK and dV stay in registers across the q tiles, and leave once,
//     rounded to bf16, as 16-byte row stores through the K and V tiles.
//   - dq: each q tile's dQ partial (f32) is staged in shared memory and
//     added to an f32 accumulator in device memory by one bulk reduce-add
//     (cp.reduce.async.bulk ... add.f32) of 16 KB, in the order of the key
//     tiles (sm90_common.cuh's semaphores: the CTA of key tile kt adds to q
//     tile i once the count of i reads kt), so dq is the same from run to
//     run.  The count is bumped when the reduce has completed, which thread
//     0 waits for at the next q tile's first barrier, so the add overlaps
//     the next tile's products; key tile kt then trails kt - 1 by about two
//     q tiles, which three CTAs an SM hide.  The accumulator keeps each
//     (batch, head, 64-row tile) as one contiguous 16 KB block, stored
//     in 8-column blocks ([8][64 rows][8]) so that a warp's stores of its
//     dQ fragment cover 256 contiguous bytes with no bank conflict; the
//     rows are padded to a multiple of 64.  A postprocess kernel casts it
//     to dq [B, S, H, 64] bf16; a preprocess kernel computes di.
// Later work (ROADMAP): a producer warp with setmaxnreg, more than one
// consumer warpgroup, a persistent grid, clusters.
//
// Plain C interface, loaded with ctypes: the entry point launches its three
// kernels on the caller's stream, allocates nothing, and returns an error
// code (0 on success).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int D = 64;  // head dim: a bf16 row is one 128-byte swizzle row
constexpr int ROW_BYTES = D * 2;
constexpr int BN = 64;  // keys per CTA
constexpr int BM = 64;  // q rows per tile
constexpr int NTHREADS = 128;  // one warpgroup
// A ring of 2 Q/dO stages and one dQ staging buffer: 75 KB of shared
// memory and at most 168 registers a thread, so three CTAs fit on an SM.
// (Two dQ buffers or 3 stages leave room for two CTAs only, which ran
// slower on the H100.)
constexpr int STAGES = 2, DQ_BUFS = 1, MIN_BLOCKS = 3;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int TILE = 64 * ROW_BYTES;  // one bf16 tile of 64 rows
  static constexpr int DQ = BM * D * 4;        // one f32 dQ tile
  static constexpr int k = 0;
  static constexpr int v = k + TILE;
  static constexpr int q = v + TILE;
  static constexpr int dout = q + STAGES * TILE;
  static constexpr int ds = dout + STAGES * TILE;
  static constexpr int dq = ds + TILE;
  static constexpr int stats = dq + DQ_BUFS * DQ;  // [2][lse log2e (64), di (64)] f32
  static constexpr int bar = stats + 2 * 2 * BM * 4;  // mbarriers: kv, full[STAGES]
  static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;  // + alignment slack
};

// The accumulator as A fragments: k16 chunk kk is n8 chunks 2kk and 2kk+1,
// rounded to bf16 pairs.  a[kk][2t] holds the thread's low row of n8 chunk
// 2kk+t, a[kk][2t+1] its high row.
__device__ __forceinline__ void to_a_fragments(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) a[kk][w] = pack_bf16(acc[8 * kk + 2 * w], acc[8 * kk + 2 * w + 1]);
}

// A 64 x 64 f32 accumulator, rounded to bf16, into a 128-byte swizzled
// tile of 64 rows: chunk i (16 bytes) of row r sits at chunk i ^ (r % 8).
__device__ __forceinline__ void store_swizzled(unsigned char* tile, const float (&acc)[32], int r_lo, int c_off) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int chunk = (i ^ (r_lo % 8)) * 16 + 2 * c_off;  // row r_lo + 8 has the same phase
    *reinterpret_cast<uint32_t*>(tile + r_lo * ROW_BYTES + chunk) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(tile + (r_lo + 8) * ROW_BYTES + chunk) = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ----------------------------------------------------------------- kernels

// Grid: (H, B, key tiles).  128 threads, one warpgroup; thread 0 also
// issues every TMA load and bulk reduce.  The accumulator fragment layout
// (m64n64): thread t holds rows 16(t/32) + (t%32)/4 and that + 8, columns
// 8i + 2(t%4) and that + 1 for i < 8, as acc[4i .. 4i+3] = (lo, c), (lo,
// c+1), (hi, c), (hi, c+1).
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
attn_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
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

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int col0 = kt * BN;
  const int n_q = (S + BM - 1) / BM;
  const int n_it = n_q - kt;  // the q tiles at and below the diagonal (BM == BN)
  const long long bh = static_cast<long long>(b) * H + h;
  const float* lse_bh = lse + bh * S;
  const float* di_bh = di + bh * S;
  float* dq_bh = dq_acc + bh * n_q * (BM * D);
  // partials added so far to q tile i of this (batch, head); computed where
  // used, as a live pointer costs the registers of three CTAs an SM
  auto sem_of = [&](int i) { return sem + (static_cast<long long>(blockIdx.y) * H + blockIdx.x) * n_q + i; };
  // lse (base 2) and di of q tile j's rows, one value per thread, for the
  // buffer stats[j % 2]; +inf past S makes P 0 there
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  auto load_stat = [&](int j) {
    const int row = (kt + j) * BM + tid % BM;
    if (row >= S) return tid < BM ? INFINITY : 0.f;
    return tid < BM ? lse_bh[row] * LOG2E : di_bh[row];
  };
  stats[tid] = load_stat(0);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::TILE);
    tma_load(base + L::k, &tk, bar_kv, h, col0, b);
    tma_load(base + L::v, &tv, bar_kv, h, col0, b);
    for (int j = 0; j < STAGES && j < n_it; ++j) {
      mbar_expect_tx(full(j), 2 * L::TILE);
      tma_load(base + L::q + j * L::TILE, &tq, full(j), h, (kt + j) * BM, b);
      tma_load(base + L::dout + j * L::TILE, &tdo, full(j), h, (kt + j) * BM, b);
    }
  }

  const int r_lo = 16 * warp + lane / 4;  // local rows: keys in S^T, dK, dV; q rows in dQ
  const int r_hi = r_lo + 8;
  const int c_off = 2 * (lane % 4);  // column pair in each n8 chunk: q rows in S^T, dims in dQ
  const uint64_t desc_k = kmajor_desc(base + L::k), desc_v = kmajor_desc(base + L::v);
  const uint64_t desc_k_mn = mnmajor_desc(base + L::k), desc_ds = mnmajor_desc(base + L::ds);

  float acc_dk[32], acc_dv[32];
  zero(acc_dk);
  zero(acc_dv);

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_it; ++j) {
    const int s = j % STAGES;
    const float next_stat = j + 1 < n_it ? load_stat(j + 1) : 0.f;  // stored before the first barrier
    const float* lse2 = stats + (j % 2) * 2 * BM;  // visible since the previous tile's barriers
    const float* dis = lse2 + BM;
    mbar_wait(full(s), (j / STAGES) & 1);
    const uint32_t sq = base + L::q + s * L::TILE, sdo = base + L::dout + s * L::TILE;

    // (1) S^T = K Q^T and (2) dP^T = V dO^T, two groups: P needs only the first
    float acc_s[32], acc_dp[32];
    zero(acc_s);
    zero(acc_dp);
    wgmma_fence();
    fence_regs(acc_s);
    fence_regs(acc_dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0, 0>(acc_s, desc_k + 2 * kk, kmajor_desc(sq) + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0, 0>(acc_dp, desc_v + 2 * kk, kmajor_desc(sdo) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc_s);

    // P^T = exp2(S^T log2e - lse log2e); on the diagonal tile keys after the q row are masked
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? r_lo : r_hi, qc = 8 * i + c_off + (e & 1);
        const float p = exp2f(fmaf(acc_s[4 * i + e], LOG2E, -lse2[qc]));
        acc_s[4 * i + e] = (j == 0 && key > qc) ? 0.f : p;
      }
    wgmma_wait<0>();
    fence_regs(acc_dp);
    // dS^T = P^T (dP^T - di)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dp[4 * i + e] = acc_s[4 * i + e] * (acc_dp[4 * i + e] - dis[8 * i + c_off + (e & 1)]);
    uint32_t pf[4][4], dsf[4][4];
    to_a_fragments(acc_s, pf);
    to_a_fragments(acc_dp, dsf);

    // (3) dV += P^T dO and (4) dK += dS^T Q, A from registers, B MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs(acc_dv, pf[kk], mnmajor_desc(sdo) + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs(acc_dk, dsf[kk], mnmajor_desc(sq) + 128 * kk);
    wgmma_commit();

    // dS^T to shared memory, row by key (q contiguous, 128-byte swizzled),
    // while (3) and (4) run.  The previous tile's (5) read it last, and
    // every warp finished that before the previous barrier.
    unsigned char* sds = smem + L::ds;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int chunk = (i ^ (r_lo % 8)) * 16 + 2 * c_off;  // r_hi % 8 == r_lo % 8
      *reinterpret_cast<uint32_t*>(sds + r_lo * ROW_BYTES + chunk) = dsf[i / 2][2 * (i % 2)];
      *reinterpret_cast<uint32_t*>(sds + r_hi * ROW_BYTES + chunk) = dsf[i / 2][2 * (i % 2) + 1];
    }
    fence_async_smem();
    if (j + 1 < n_it) stats[((j + 1) % 2) * 2 * BM + tid] = next_stat;  // stats[(j+1) % 2] was read before the last barrier
    if (tid == 0 && j > 0) {  // the previous tile's add is done: the dQ buffer is free, the next key tile's turn
      bulk_wait_done();
      sem_release(sem_of(kt + j - 1));
    }
    __syncthreads();

    // (5) dQ = dS K: A = dS read transposed from dS^T, B = K MN-major
    float acc_dq[32];
    zero(acc_dq);
    wgmma_fence();
    fence_regs(acc_dq);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_ss<1, 1>(acc_dq, desc_ds + 128 * kk, desc_k_mn + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(acc_dk);
    fence_regs(acc_dv);

    // dQ to its staging buffer in 8-column blocks: element (r, c) at
    // ((c / 8) * 64 + r) * 8 + c % 8, so a warp's float2 stores are contiguous
    const int buf = j % DQ_BUFS;
    float* sdq = reinterpret_cast<float*>(smem + L::dq + buf * L::DQ);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float2*>(sdq + (i * 64 + r_lo) * 8 + c_off) = make_float2(acc_dq[4 * i], acc_dq[4 * i + 1]);
      *reinterpret_cast<float2*>(sdq + (i * 64 + r_hi) * 8 + c_off) =
          make_float2(acc_dq[4 * i + 2], acc_dq[4 * i + 3]);
    }
    fence_async_smem();
    __syncthreads();  // every warp is done with stage s, dS^T, and its dQ stores
    if (tid == 0) {
      if (j + STAGES < n_it) {
        mbar_expect_tx(full(s), 2 * L::TILE);
        tma_load(sq, &tq, full(s), h, (kt + j + STAGES) * BM, b);
        tma_load(sdo, &tdo, full(s), h, (kt + j + STAGES) * BM, b);
      }
      sem_wait(sem_of(kt + j), kt);  // key tiles 0 .. kt-1 have added theirs
      bulk_reduce_add(dq_bh + static_cast<long long>(kt + j) * (BM * D), base + L::dq + buf * L::DQ, L::DQ);
    }
  }

  // epilogue: dK and dV in bf16 through the K and V tiles (nothing reads
  // them any more: the last barrier followed every wgmma), then out as
  // 16-byte stores of whole rows
  unsigned char* stile[2] = {smem + L::k, smem + L::v};
  store_swizzled(stile[0], acc_dk, r_lo, c_off);
  store_swizzled(stile[1], acc_dv, r_lo, c_off);
  __syncthreads();
  bf16* out[2] = {dk, dv};
#pragma unroll
  for (int it = 0; it < BN * (ROW_BYTES / 16) / NTHREADS; ++it) {
    const int idx = it * NTHREADS + tid, r = idx / (ROW_BYTES / 16), c = idx % (ROW_BYTES / 16);
    const int key = col0 + r;
    if (key < S) {
      const long long off = ((static_cast<long long>(b) * S + key) * H + h) * D + c * 8;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        *reinterpret_cast<uint4*>(out[t] + off) = *reinterpret_cast<const uint4*>(stile[t] + r * ROW_BYTES + (c ^ (r % 8)) * 16);
    }
  }
  if (tid == 0) {  // the last add is done: the next key tile's turn
    bulk_wait_done();
    sem_release(sem_of(kt + n_it - 1));
  }
}

// ------------------------------------------------------------------- host

int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* di,
           float* dq_acc, int* sem, void* dq, void* dk, void* dv, int B, int H, int S, const long long* st,
           cudaStream_t stream) {
  using L = Smem;
  const long long contiguous[3] = {static_cast<long long>(S) * H * D, static_cast<long long>(H) * D, D};
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map(&tq, q, B, H, S, D, st, BM);
  if (e == 0) e = make_map(&tk, k, B, H, S, D, st + 3, BN);
  if (e == 0) e = make_map(&tv, v, B, H, S, D, st + 6, BN);
  if (e == 0) e = make_map(&tdo, dout, B, H, S, D, contiguous, BM);
  if (e != 0) return e;
  const int n_q = (S + BM - 1) / BM;
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned row_blocks = static_cast<unsigned>((rows * 8 + 255) / 256);

  cudaError_t ce = cudaMemsetAsync(dq_acc, 0, static_cast<size_t>(B) * H * n_q * BM * D * sizeof(float), stream);
  if (ce == cudaSuccess) ce = cudaMemsetAsync(sem, 0, static_cast<size_t>(B) * H * n_q * sizeof(int), stream);
  if (ce != cudaSuccess) return ce;
  attn_bwd_sm90_pre_kernel<D><<<row_blocks, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                              static_cast<const bf16*>(dout), di, H, S, rows);
  if ((ce = cudaGetLastError()) != cudaSuccess) return ce;
  auto kern = attn_bwd_sm90_kernel;
  ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return ce;
  kern<<<dim3(H, B, n_q), NTHREADS, L::bytes, stream>>>(tq, tk, tv, tdo, lse, di, dq_acc, sem,
                                                        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S);
  if ((ce = cudaGetLastError()) != cudaSuccess) return ce;
  attn_bwd_sm90_post_kernel<D, BM><<<row_blocks, 256, 0, stream>>>(dq_acc, static_cast<bf16*>(dq), H, S, rows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (the only one taken); Dh must be 64.  strides: 9
// element strides (batch, seq, head) of q, k, v, each a multiple of 8
// elements.  o, dout, dq, dk, dv are contiguous [B, S, H, D] bf16; lse and
// di (written here) contiguous [B, H, S] f32.  dq_acc: f32 scratch of
// B * H * ceil(S / 64) * 64 * D elements, and sem: int scratch of
// B * H * ceil(S / 64), both zeroed here.  Returns 0, a
// cudaError_t, or an error code of sm90_common.cuh; rtt_error_string names
// it.
extern "C" int rtt_attn_bwd_sm90(int dtype, int Dh, const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, float* di, float* dq_acc, int* sem, void* dq,
                                 void* dk, void* dv, int B, int H, int S, const long long* strides, void* stream) {
  if (dtype != 0 || Dh != D) return cudaErrorInvalidValue;
  return launch(q, k, v, o, dout, lse, di, dq_acc, sem, dq, dk, dv, B, H, S, strides,
                static_cast<cudaStream_t>(stream));
}

// The main kernel's dynamic shared memory in bytes and how many of its CTAs
// fit on one SM (registers and shared memory together), for the build report.
extern "C" int rtt_attn_bwd_sm90_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = Smem::bytes;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, attn_bwd_sm90_kernel, NTHREADS, Smem::bytes);
}

extern "C" const char* rtt_error_string(int err) { return error_string(err); }
