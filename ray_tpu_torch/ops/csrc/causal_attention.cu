// Causal multi-head attention for Hopper (sm_90a): forward and fused backward.
//
// Replaces the TPU splash-attention kernels that ray_tpu/ops/attention.py
// reaches through _splash_kernel / _splash_causal_attention:
//   attn_fwd_kernel  <- jax/experimental/pallas/ops/tpu/splash_attention/
//                       splash_attention_kernel.py:_splash_attention_forward
//   attn_bwd_kernel  <- same file, _splash_attention_bwd_dkv with
//                       use_fused_bwd_kernel=True (dq, dk and dv in one kernel)
// They also serve causal_attention(impl="flash"), whose TPU kernels
// (flash_attention.py) compute the same function.  For bfloat16 at head
// dim 64 the forward is attention_fwd_sm90.cu (wgmma, TMA), chosen by
// ops/attention.py's routing table; attn_fwd_kernel takes head dim 128 and
// float32 inputs.
//
// Convention (splash's): q arrives pre-scaled by sm_scale, so the kernels
// compute softmax(q k^T) v with no scale inside, and the residual lse is the
// logsumexp of the pre-scaled scores.  Layout [B, S, H, D] with arbitrary
// batch/seq/head strides (last dim contiguous); lse and di are [B, H, S] f32.
//
// What bounds them on an H100.  At GPT-2 124M's shape (B=18, H=12, S=1024,
// D=64) the causal forward does ~2*B*H*S^2*D = 2.9e10 FLOP and moves ~114 MB
// (q, k, v, o in bf16): 0.029 ms of bf16 tensor-core peak against 0.034 ms of
// HBM, so it sits near the ridge.  The backward does ~5*B*H*S^2*D = 7.2e10
// FLOP over ~230 MB: operations bound.  What the design does about it: the
// [S, S] scores never reach device memory (online softmax in the forward,
// recompute from lse in the backward), tiles above the diagonal are skipped,
// and every product runs on the tensor cores (WMMA bf16 16x16x16, f32
// accumulate).  These kernels stage every tile product through shared
// memory and run one block per tile; attention_fwd_sm90.cu is the forward
// redesigned for Hopper.  float32 inputs take an FMA path at half the tile size: it is
// there so the algorithm can be held against the float32 reference exactly.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

template <typename T> struct Tile;
// BM: rows of a q tile and of a k/v tile.  PAD: elements added to each shared
// row (16 bytes) to spread the rows over the banks; keeps WMMA's ldm rules.
template <> struct Tile<bf16> { static constexpr int BM = 64, PAD = 8; };
template <> struct Tile<float> { static constexpr int BM = 32, PAD = 4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// C[M x N] (f32, shared) = (ACC ? C : 0) + A[M x K] * B[K x N], A and B in
// shared memory.  TA: A is stored transposed (element (i, k) at A[k*lda + i]);
// TB likewise for B.  All threads of the block take part; no barrier inside.
template <typename T, int M, int N, int K, bool TA, bool TB, bool ACC, int NWARPS>
__device__ __forceinline__ void block_gemm(const T* A, int lda, const T* B, int ldb,
                                           float* C, int ldc) {
  if constexpr (std::is_same<T, float>::value) {
    for (int o = threadIdx.x; o < M * N; o += NWARPS * 32) {
      const int i = o / N, j = o % N;
      float acc = ACC ? C[i * ldc + j] : 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = TA ? A[k * lda + i] : A[i * lda + k];
        const float b = TB ? B[j * ldb + k] : B[k * ldb + j];
        acc = fmaf(a, b, acc);
      }
      C[i * ldc + j] = acc;
    }
  } else {
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    constexpr int TN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * TN; t += NWARPS) {
      const int ti = t / TN, tj = t % TN;
      float* cp = C + ti * 16 * ldc + tj * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC) {
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        const T* ap = TA ? A + kk * 16 * lda + ti * 16 : A + ti * 16 * lda + kk * 16;
        const T* bp = TB ? B + tj * 16 * ldb + kk * 16 : B + kk * 16 * ldb + tj * 16;
        wmma::load_matrix_sync(a, ap, lda);
        wmma::load_matrix_sync(b, bp, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
}

// rows [row0, row0 + ROWS) of a [S, D] slice with row stride `ss` (elements)
// into shared memory with row stride `ld`; rows at or past S read as zero.
// 16-byte vectors: the wrapper checks that base and strides allow them.
template <typename T, int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long ss,
                                          int row0, int S) {
  constexpr int E = 16 / sizeof(T);  // elements per vector
  constexpr int VPR = D / E;         // vectors per row
  for (int v = threadIdx.x; v < ROWS * VPR; v += NTHREADS) {
    const int r = v / VPR, c = (v % VPR) * E;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

struct Strides {  // element strides of q, k, v: batch, seq, head
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// ------------------------------------------------------------------ forward

template <typename T, int D>
struct FwdLayout {
  static constexpr int BM = Tile<T>::BM, BN = BM;
  static constexpr int LD = D + Tile<T>::PAD;    // q, k, v rows
  static constexpr int LDS = BN + 4;             // f32 scores
  static constexpr int LDP = BN + Tile<T>::PAD;  // probabilities in T
  static constexpr int LDO = D + 4;              // f32 output accumulator
  static constexpr int q = 0;
  static constexpr int k = q + align128(BM * LD * int(sizeof(T)));
  static constexpr int v = k + align128(BN * LD * int(sizeof(T)));
  static constexpr int s = v + align128(BN * LD * int(sizeof(T)));
  static constexpr int p = s + align128(BM * LDS * 4);
  static constexpr int o = p + align128(BM * LDP * int(sizeof(T)));
  static constexpr int m = o + align128(BM * LDO * 4);
  static constexpr int l = m + align128(BM * 4);
  static constexpr int bytes = l + align128(BM * 4);
};

// One block per (q tile, head, batch).  K/V tiles stream through shared
// memory up to the diagonal; each warp owns whole score rows for the online
// softmax (running max m and sum l in f32).  Writes O in T and lse in f32.
template <typename T, int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int H, int S, Strides st) {
  using L = FwdLayout<T, D>;
  constexpr int BM = L::BM, BN = L::BN, NT = NWARPS * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;

  load_rows<T, BM, D, NT>(sQ, L::LD, qb, st.qs, row0, S);
  for (int i = threadIdx.x; i < BM * L::LDO; i += NT) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NT) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  // causal: the last k/v tile is the one holding this q tile's last row
  const int n_kv = min((S + BN - 1) / BN, (row0 + BM - 1) / BN + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int col0 = j * BN;
    __syncthreads();  // the previous tile's P*V has finished with sK, sV, sP
    load_rows<T, BN, D, NT>(sK, L::LD, kb, st.ks, col0, S);
    load_rows<T, BN, D, NT>(sV, L::LD, vb, st.vs, col0, S);
    __syncthreads();
    block_gemm<T, BM, BN, D, false, true, false, NWARPS>(sQ, L::LD, sK, L::LD, sS, L::LDS);
    __syncthreads();
    for (int r = warp; r < BM; r += NWARPS) {
      const int row = row0 + r;
      float mx = -INFINITY;
      for (int c = lane; c < BN; c += 32) {
        const int col = col0 + c;
        const float s = (col <= row && row < S) ? sS[r * L::LDS + c] : -INFINITY;
        sS[r * L::LDS + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with nothing unmasked yet (only rows past S) keeps p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < BN; c += 32) {
        const float p = expf(sS[r * L::LDS + c] - m_use);
        sP[r * L::LDP + c] = from_f32<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_use);  // 0 while m_old is -inf
      for (int d = lane; d < D; d += 32) sO[r * L::LDO + d] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();
    block_gemm<T, BM, D, BN, false, false, true, NWARPS>(sP, L::LDP, sV, L::LD, sO, L::LDO);
  }
  __syncthreads();
  T* ob = o + ((long long)b * S * H + h) * D;  // o is contiguous [B, S, H, D]
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, d = i % D, row = row0 + r;
    if (row < S) ob[(long long)row * H * D + d] = from_f32<T>(sO[r * L::LDO + d] / sL[r]);
  }
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int row = row0 + r;
    if (row < S) lse[((long long)b * H + h) * S + row] = sM[r] + logf(sL[r]);
  }
}

// ----------------------------------------------------------------- backward

template <typename T, int D>
struct BwdLayout {
  static constexpr int BM = Tile<T>::BM, BN = BM;
  static constexpr int LD = D + Tile<T>::PAD;
  static constexpr int LDS = BN + 4;
  static constexpr int LDP = BN + Tile<T>::PAD;
  static constexpr int LDO = D + 4;
  static constexpr int TILE = align128(BM * LD * int(sizeof(T)));
  static constexpr int SCORES = align128(BM * LDS * 4);
  static constexpr int DQ = align128(BM * LDO * 4);
  static constexpr int k = 0, v = k + TILE, q = v + TILE, dout = q + TILE;
  // scratch holds S and dP, and later this tile's dq partial sums
  static constexpr int s = dout + TILE;
  static constexpr int dp = s + SCORES;
  static constexpr int p = s + (2 * SCORES > DQ ? 2 * SCORES : DQ);
  static constexpr int ds = p + align128(BM * LDP * int(sizeof(T)));
  static constexpr int dk = ds + align128(BM * LDP * int(sizeof(T)));
  static constexpr int dv = dk + align128(BN * LDO * 4);
  static constexpr int lse = dv + align128(BN * LDO * 4);
  static constexpr int di = lse + align128(BM * 4);
  static constexpr int bytes = di + align128(BM * 4);
};

// One block per (k/v tile, head, batch), looping over the q tiles at and
// below the diagonal.  dk and dv accumulate in shared f32 and are written
// once; dq is summed across k/v tiles by f32 atomics into dq_acc
// (contiguous [B, S, H, D], zeroed by the caller).  P is recomputed from the
// saved lse; di = rowsum(dO * O) comes precomputed, as in splash.
template <typename T, int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, float* __restrict__ dq_acc,
                T* __restrict__ dk, T* __restrict__ dv, int H, int S, Strides st) {
  using L = BwdLayout<T, D>;
  constexpr int BM = L::BM, BN = L::BN, NT = NWARPS * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sdO = reinterpret_cast<T*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sdP = reinterpret_cast<float*>(smem + L::dp);
  float* sdQ = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  T* sdS = reinterpret_cast<T*>(smem + L::ds);
  float* sdK = reinterpret_cast<float*>(smem + L::dk);
  float* sdV = reinterpret_cast<float*>(smem + L::dv);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDi = reinterpret_cast<float*>(smem + L::di);

  const int h = blockIdx.y, b = blockIdx.z;
  const int col0 = blockIdx.x * BN;
  const long long HD = (long long)H * D;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const long long ob = ((long long)b * S * H + h) * D;  // dO, dq_acc, dk, dv
  const float* lse_b = lse + ((long long)b * H + h) * S;
  const float* di_b = di + ((long long)b * H + h) * S;

  load_rows<T, BN, D, NT>(sK, L::LD, kb, st.ks, col0, S);
  load_rows<T, BN, D, NT>(sV, L::LD, vb, st.vs, col0, S);
  for (int i = threadIdx.x; i < BN * L::LDO; i += NT) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }
  const int n_q = (S + BM - 1) / BM;
  for (int it = col0 / BM; it < n_q; ++it) {
    const int row0 = it * BM;
    __syncthreads();  // the previous q tile is done with sQ, sdO, sdS, sdQ
    load_rows<T, BM, D, NT>(sQ, L::LD, qb, st.qs, row0, S);
    load_rows<T, BM, D, NT>(sdO, L::LD, dout + ob, HD, row0, S);
    for (int r = threadIdx.x; r < BM; r += NT) {
      const int row = row0 + r;
      sLse[r] = row < S ? lse_b[row] : 0.f;
      sDi[r] = row < S ? di_b[row] : 0.f;
    }
    __syncthreads();
    block_gemm<T, BM, BN, D, false, true, false, NWARPS>(sQ, L::LD, sK, L::LD, sS, L::LDS);
    block_gemm<T, BM, BN, D, false, true, false, NWARPS>(sdO, L::LD, sV, L::LD, sdP, L::LDS);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN, row = row0 + r, col = col0 + c;
      const float p = (col <= row && row < S) ? expf(sS[r * L::LDS + c] - sLse[r]) : 0.f;
      const float ds = p * (sdP[r * L::LDS + c] - sDi[r]);
      sP[r * L::LDP + c] = from_f32<T>(p);
      sdS[r * L::LDP + c] = from_f32<T>(ds);
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q, dQ_tile = dS K (sdQ overwrites sS and sdP,
    // which nothing reads any more in this phase)
    block_gemm<T, BN, D, BM, true, false, true, NWARPS>(sP, L::LDP, sdO, L::LD, sdV, L::LDO);
    block_gemm<T, BN, D, BM, true, false, true, NWARPS>(sdS, L::LDP, sQ, L::LD, sdK, L::LDO);
    block_gemm<T, BM, D, BN, false, false, false, NWARPS>(sdS, L::LDP, sK, L::LD, sdQ, L::LDO);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * D; i += NT) {
      const int r = i / D, d = i % D, row = row0 + r;
      if (row < S) atomicAdd(dq_acc + ob + row * HD + d, sdQ[r * L::LDO + d]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BN * D; i += NT) {
    const int r = i / D, d = i % D, col = col0 + r;
    if (col < S) {
      dk[ob + col * HD + d] = from_f32<T>(sdK[r * L::LDO + d]);
      dv[ob + col * HD + d] = from_f32<T>(sdV[r * L::LDO + d]);
    }
  }
}

constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int S, const Strides& st, cudaStream_t stream) {
  using L = FwdLayout<T, D>;
  auto kern = attn_fwd_kernel<T, D, kFwdWarps>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((S + L::BM - 1) / L::BM, H, B);
  kern<<<grid, kFwdWarps * 32, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, S, st);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, float* dq_acc, void* dk, void* dv,
                       int B, int H, int S, const Strides& st, cudaStream_t stream) {
  using L = BwdLayout<T, D>;
  auto kern = attn_bwd_kernel<T, D, kBwdWarps>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((S + L::BN - 1) / L::BN, H, B);
  kern<<<grid, kBwdWarps * 32, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv),
      H, S, st);
  return cudaGetLastError();
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  strides: 9 element strides (batch, seq,
// head) of q, k, v.  o is contiguous [B, S, H, D]; lse contiguous [B, H, S].
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a dtype or
// head dim the kernels do not take.
extern "C" int rtt_attn_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int H, int S,
                            const long long* strides, void* stream) {
  const Strides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_fwd<bf16, 64>(q, k, v, o, lse, B, H, S, st, s);
  if (dtype == 0 && D == 128) return launch_fwd<bf16, 128>(q, k, v, o, lse, B, H, S, st, s);
  if (dtype == 1 && D == 64) return launch_fwd<float, 64>(q, k, v, o, lse, B, H, S, st, s);
  if (dtype == 1 && D == 128) return launch_fwd<float, 128>(q, k, v, o, lse, B, H, S, st, s);
  return cudaErrorInvalidValue;
}

// dout, dq_acc (f32), dk and dv are contiguous [B, S, H, D]; lse and di are
// contiguous [B, H, S] f32; dq_acc must be zero on entry.
extern "C" int rtt_attn_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* di, float* dq_acc,
                            void* dk, void* dv, int B, int H, int S, const long long* strides,
                            void* stream) {
  const Strides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_bwd<bf16, 64>(q, k, v, dout, lse, di, dq_acc, dk, dv, B, H, S, st, s);
  if (dtype == 0 && D == 128)
    return launch_bwd<bf16, 128>(q, k, v, dout, lse, di, dq_acc, dk, dv, B, H, S, st, s);
  if (dtype == 1 && D == 64)
    return launch_bwd<float, 64>(q, k, v, dout, lse, di, dq_acc, dk, dv, B, H, S, st, s);
  if (dtype == 1 && D == 128)
    return launch_bwd<float, 128>(q, k, v, dout, lse, di, dq_acc, dk, dv, B, H, S, st, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
