// ACTION two-sweep kernels for Hopper (sm_90a), CUDA C++ with a plain C
// interface loaded through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces the TPU kernels of ehgr_tpu/ops/pallas/action_mega.py:
//   action_stats  (_stats_kernel, pallas_call at :142)
//       x [N,T,S,C], w [3,C], W_p3 [C,Cr]  ->  mc [N,T,S], pool [N,T,C],
//       x3 = x_shift @ W_p3 [N,T,S,Cr], with
//       x_shift[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1] (zero at clip edges)
//       recomputed on the fly and never written.
//   action_apply  (_apply_kernel, pallas_call at :209)
//       out = (x_shift * (g1[row] + gch[n,t,c])) @ W_net  [N,T,S,F];
//       the gated sum never reaches device memory.  Only off the main
//       path: fp32, and bf16 shapes that csrc/action_apply.cu does not take
//       (C % 64 != 0, F % 8 != 0 or a misaligned operand).
// and the TPU kernel of ehgr_tpu/ops/pallas/action_fused.py:
//   action_prologue  (action_fused_prologue :60, pallas_call at :75)
//       the action_stats sweep plus one store of x_shift [N,T,S,C]: the
//       same template with XS = true, where the block that owns mc/pool
//       also writes the shifted tile it built.
//
// What bounds them on the H100: action_stats moves x once (2 B/elem in
// bf16) and does 2*Cr flops per element of x, at most 256 flops/element
// (Cr=128), so it is bound by bytes at every ResNet-50 site.  action_apply
// does 2*F flops per element of x: bytes bound it at the 56^2/28^2 sites,
// the tensor-core rate at the 7^2 C=2048 F=512 site.  action_prologue adds
// one write of x_shift to action_stats' bytes: bytes bound it everywhere.
//
// Design (simple and right first; wgmma/TMA are later work):
//   * One block owns BM=64 rows of one (n,t) slab and BN output columns and
//     walks all of C in BK=32 chunks, so W never has to fit shared memory
//     (W_net at C=2048 is 2 MB) and a block's row reductions (mc) complete
//     in the block.  Row tiles never straddle two (n,t) slabs: S=49 and
//     S=196 leave a ragged last tile, masked on load (zero rows) and store.
//   * The A tile is built in f32 from three reads of x (rows r-S, r, r+S of
//     the same clip; tap w0 only for t>0, w2 only for t<T-1), gated for
//     apply, and kept in shared memory.  The neighbouring-t reads hit L2:
//     blocks of t-1, t, t+1 for the same rows run close together.
//   * bf16 (the main path): x is read 16 bytes (8 channels) a thread, the
//     shifted (and gated) tile is rounded to bf16 in shared memory, and the
//     product runs on the tensor cores through WMMA 16x16x16 bf16 fragments
//     with f32 accumulators, staged through shared memory for the masked
//     epilogue.  mc and pool are summed from the f32 values before that
//     rounding (warp shuffles, then one atomicAdd per column per block).
//   * fp32 (and bf16 with C not a multiple of 8): the same sweep with plain
//     FMA, 4 x BN/16 outputs a thread, so fp32 stays exact fp32.
//   * pool is a reduction across blocks: each block sums its tile's columns
//     in f32 and adds them with one atomicAdd per column into f32 scratch;
//     a second small kernel divides by S and casts.  The TPU kernel
//     accumulated pool in the input dtype (bf16 on the main path); this one
//     accumulates in f32.
//   * Everything launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;
constexpr int BK = 32;
constexpr int TY = 16;                 // thread rows;  TM = BM / TY = 4
constexpr int TX = 16;                 // thread cols;  TN = BN / TX
constexpr int TM = BM / TY;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One tile sweep shared by all three kernels.  STATS: A = x_shift, and the
// block also emits mc (row means) and adds its column sums to pool_acc; XS
// (with STATS): that block also stores A to xs.  Otherwise
// A = x_shift * (g1[row] + gch[nt, k]).
template <typename T, int BN, bool STATS, bool XS>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ x, const T* __restrict__ wsh,
             const T* __restrict__ wmat, const T* __restrict__ g1,
             const T* __restrict__ gch, T* __restrict__ out,
             T* __restrict__ mc, float* __restrict__ pool_acc,
             T* __restrict__ xs, int tlen, int S, int C, int F,
             int n_stiles) {
  constexpr int TN = BN / TX;
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int nt = blockIdx.x / n_stiles;            // n*T + t
  const int s0 = (blockIdx.x % n_stiles) * BM;
  const int f0 = blockIdx.y * BN;
  const int t = nt % tlen;
  const bool has_prev = t > 0;
  const bool has_next = t + 1 < tlen;
  const size_t slab = (size_t)S * C;               // one (n,t) frame
  const T* xb = x + (size_t)nt * slab;
  const bool side = STATS && blockIdx.y == 0;      // mc / pool owner

  const int ty = tid / TX, tx = tid % TX;
  const int lk = tid % BK;                         // this thread's A column
  const int lr = tid / BK;                         // first A row it loads
  constexpr int kRowStep = kThreads / BK;          // 8

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;
  float rsum = 0.f;                                // mc, rows tid < BM

  for (int k0 = 0; k0 < C; k0 += BK) {
    const int k = k0 + lk;
    const bool kin = k < C;
    const float w0 = kin ? ld(wsh + k) : 0.f;
    const float w1 = kin ? ld(wsh + C + k) : 0.f;
    const float w2 = kin ? ld(wsh + 2 * C + k) : 0.f;
    float gc = 0.f;
    if (!STATS && kin) gc = ld(gch + (size_t)nt * C + k);
#pragma unroll
    for (int r = 0; r < BM / kRowStep; ++r) {
      const int i = lr + r * kRowStep;
      const int s = s0 + i;
      float v = 0.f;
      if (kin && s < S) {
        const T* p = xb + (size_t)s * C + k;
        v = w1 * ld(p);
        if (has_prev) v += w0 * ld(p - slab);
        if (has_next) v += w2 * ld(p + slab);
        if (!STATS) v *= ld(g1 + (size_t)nt * S + s) + gc;
        if (XS && side) st(xs + (size_t)nt * slab + (size_t)s * C + k, v);
      }
      As[i][lk] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, j = idx % BN;
      const int kr = k0 + kk, f = f0 + j;
      Bs[kk][j] = (kr < C && f < F) ? ld(wmat + (size_t)kr * F + f) : 0.f;
    }
    __syncthreads();

    if (side) {
      if (tid < BM) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) rsum += As[tid][kk];
      } else if (tid < BM + BK) {
        const int kk = tid - BM;
        float csum = 0.f;
#pragma unroll 8
        for (int i = 0; i < BM; ++i) csum += As[i][kk];
        if (k0 + kk < C) atomicAdd(pool_acc + (size_t)nt * C + k0 + kk, csum);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = As[ty + m * TY][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][j] = fmaf(a[m], b[j], acc[m][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int s = s0 + ty + m * TY;
    if (s >= S) continue;
    T* orow = out + ((size_t)nt * S + s) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + j * TX;
      if (f < F) st(orow + f, acc[m][j]);
    }
  }
  if (side && tid < BM && s0 + tid < S)
    st(mc + (size_t)nt * S + s0 + tid, rsum / (float)C);
}

template <typename T>
__global__ void pool_finalize(const float* __restrict__ acc,
                              T* __restrict__ pool, size_t n, float inv_s) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) st(pool + i, acc[i] * inv_s);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core sweep (WMMA).  Needs C % 8 == 0 and 16-byte aligned x,
// w and gch (checked by the host code).
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return r;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int BN, bool STATS, bool XS>
__global__ void __launch_bounds__(kThreads)
sweep_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wsh,
                const bf16* __restrict__ wmat, const bf16* __restrict__ g1,
                const bf16* __restrict__ gch, bf16* __restrict__ out,
                bf16* __restrict__ mc, float* __restrict__ pool_acc,
                bf16* __restrict__ xs, int tlen, int S, int C, int F,
                int n_stiles) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8;          // bf16; rows stay 16-byte aligned
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;          // f32 staging of the accumulators
  constexpr int FC = BN / 16;          // fragment columns
  constexpr int NFR = (BM / 16) * FC;  // fragments in the tile
  constexpr int NWARP = kThreads / 32;
  constexpr int FPW = (NFR + NWARP - 1) / NWARP;
  struct Tiles {
    bf16 a[BM][LDA];
    bf16 b[BK][LDB];
  };
  union Smem {
    Tiles t;
    float c[BM][LDC];
  };
  __shared__ __align__(128) Smem sm;
  __shared__ float rsum[BM];           // stats: row sums over C
  __shared__ float csum[NWARP][BK];    // stats: per-warp column sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = blockIdx.x / n_stiles;
  const int s0 = (blockIdx.x % n_stiles) * BM;
  const int f0 = blockIdx.y * BN;
  const int t = nt % tlen;
  const bool has_prev = t > 0, has_next = t + 1 < tlen;
  const size_t slab = (size_t)S * C;
  const bool side = STATS && blockIdx.y == 0;
  // A tile: 4 threads a row, 8 channels each
  const int arow = tid / 4, ak = (tid % 4) * 8;
  const int s_a = s0 + arow;
  const bool row_in = s_a < S;
  const bf16* xrow = x + (size_t)nt * slab + (size_t)(row_in ? s_a : 0) * C;
  float g1v = 0.f;
  if (!STATS && row_in) g1v = __bfloat162float(g1[(size_t)nt * S + s_a]);
  const bool vec_b = F % 8 == 0 && (uintptr_t)wmat % 16 == 0;

  if (STATS) {
    if (tid < BM) rsum[tid] = 0.f;
    __syncthreads();
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int i = 0; i < FPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  // This thread's operands of one chunk, fetched a chunk ahead so the loads
  // are in flight during the previous chunk's MMA: x at t-1, t, t+1, the
  // three taps, gch (apply) and its share of the W tile.  All loads start
  // together (predicated, no branch between them).
  constexpr int NB = (BK * BN / 8 + kThreads - 1) / kThreads;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 rx0, rx1, rx2, rw0, rw1, rw2, rg = zero, rb[NB];
  auto fetch = [&](int k0) {
    const int k = k0 + ak;
    const bool in = row_in && k < C;       // C % 8 == 0: all 8 or none
    const int kc = k < C ? k : 0;
    const bf16* p = xrow + kc;
    rx1 = in ? ld16(p) : zero;
    rx0 = in && has_prev ? ld16(p - slab) : zero;
    rx2 = in && has_next ? ld16(p + slab) : zero;
    rw0 = ld16(wsh + kc);
    rw1 = ld16(wsh + C + kc);
    rw2 = ld16(wsh + 2 * C + kc);
    if (!STATS) rg = ld16(gch + (size_t)nt * C + kc);
    if (vec_b) {
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int idx = tid + r * kThreads;
        const int kr = k0 + idx / (BN / 8), f = f0 + (idx % (BN / 8)) * 8;
        rb[r] = idx < BK * BN / 8 && kr < C && f < F
                    ? ld16(wmat + (size_t)kr * F + f) : zero;
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < C; k0 += BK) {
    float v[8], a[8], w[8];
    unpack8(rx1, a);
    unpack8(rw1, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i] * a[i];
    unpack8(rx0, a);
    unpack8(rw0, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += w[i] * a[i];
    unpack8(rx2, a);
    unpack8(rw2, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += w[i] * a[i];
    if (!STATS) {
      unpack8(rg, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= g1v + w[i];
    }
    const uint4 packed = pack8(v);
    *reinterpret_cast<uint4*>(&sm.t.a[arow][ak]) = packed;
    if (XS && side && row_in && k0 + ak < C)
      *reinterpret_cast<uint4*>(xs + (size_t)nt * slab + (size_t)s_a * C +
                                k0 + ak) = packed;
    if (side) {
      float r = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) r += v[i];
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      if ((lane & 3) == 0) rsum[arow] += r;    // one owner per row
#pragma unroll
      for (int i = 0; i < 8; ++i) {            // over the warp's 8 rows
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 4);
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 8);
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16);
      }
      if (lane < 4) {
#pragma unroll
        for (int i = 0; i < 8; ++i) csum[warp][lane * 8 + i] = v[i];
      }
    }
    if (vec_b) {
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int idx = tid + r * kThreads;
        if (idx < BK * BN / 8)
          *reinterpret_cast<uint4*>(
              &sm.t.b[idx / (BN / 8)][(idx % (BN / 8)) * 8]) = rb[r];
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += kThreads) {
        const int kk = idx / BN, j = idx % BN;
        const int kr = k0 + kk, f = f0 + j;
        sm.t.b[kk][j] = (kr < C && f < F) ? wmat[(size_t)kr * F + f]
                                          : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    if (k0 + BK < C) fetch(k0 + BK);

    if (side && tid < BK && k0 + tid < C) {
      float c = 0.f;
#pragma unroll
      for (int wi = 0; wi < NWARP; ++wi) c += csum[wi][tid];
      atomicAdd(pool_acc + (size_t)nt * C + k0 + tid, c);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const int fr = warp + i * NWARP;
        if (fr < NFR) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, &sm.t.a[(fr / FC) * 16][kk], LDA);
          wmma::load_matrix_sync(fb, &sm.t.b[kk][(fr % FC) * 16], LDB);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int fr = warp + i * NWARP;
    if (fr < NFR)
      wmma::store_matrix_sync(&sm.c[(fr / FC) * 16][(fr % FC) * 16], acc[i],
                              LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int i = idx / BN, j = idx % BN;
    const int s = s0 + i, f = f0 + j;
    if (s < S && f < F)
      out[((size_t)nt * S + s) * F + f] = __float2bfloat16(sm.c[i][j]);
  }
  if (side && tid < BM && s0 + tid < S)
    mc[(size_t)nt * S + s0 + tid] = __float2bfloat16(rsum[tid] / (float)C);
}

// The tensor-core sweep takes bf16 with 8-channel rows and 16-byte aligned
// operands; anything else takes the FMA sweep.
bool tc_ok(int c, const void* x, const void* w, const void* gch) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)w | (uintptr_t)gch;
  return c % 8 == 0 && a % 16 == 0;
}

template <int BN, bool STATS, bool XS = false>
void launch_tc(const void* x, const void* w, const void* wmat, const void* g1,
               const void* gch, void* out, void* mc, float* pool_acc,
               void* xs, int n, int t, int s, int c, int f,
               cudaStream_t stream) {
  const int n_stiles = (s + BM - 1) / BM;
  dim3 grid((unsigned)(n * t * n_stiles), (unsigned)((f + BN - 1) / BN));
  sweep_tc_kernel<BN, STATS, XS><<<grid, kThreads, 0, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)wmat, (const bf16*)g1,
      (const bf16*)gch, (bf16*)out, (bf16*)mc, pool_acc, (bf16*)xs, t, s, c,
      f, n_stiles);
}

template <typename T, int BN, bool STATS, bool XS = false>
void launch_sweep(const void* x, const void* w, const void* wmat,
                  const void* g1, const void* gch, void* out, void* mc,
                  float* pool_acc, void* xs, int n, int t, int s, int c,
                  int f, cudaStream_t stream) {
  const int n_stiles = (s + BM - 1) / BM;
  dim3 grid((unsigned)(n * t * n_stiles), (unsigned)((f + BN - 1) / BN));
  sweep_kernel<T, BN, STATS, XS><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)wmat, (const T*)g1, (const T*)gch,
      (T*)out, (T*)mc, pool_acc, (T*)xs, t, s, c, f, n_stiles);
}

// action_stats (XS = false) and action_prologue (XS = true: x_shift to xs)
template <typename T, bool XS>
int stats_impl(const void* x, const void* w, const void* wp3, void* xs,
               void* mc, void* pool, void* x3, float* pool_acc, int n, int t,
               int s, int c, int cr, cudaStream_t stream) {
  const size_t npool = (size_t)n * t * c;
  cudaError_t e = cudaMemsetAsync(pool_acc, 0, npool * sizeof(float), stream);
  if (e != cudaSuccess) return (int)e;
  if (sizeof(T) == 2 && tc_ok(c, x, w, XS ? xs : w)) {
    if (cr <= 16)
      launch_tc<16, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc, pool_acc,
                              xs, n, t, s, c, cr, stream);
    else if (cr <= 64)
      launch_tc<64, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc, pool_acc,
                              xs, n, t, s, c, cr, stream);
    else
      launch_tc<128, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc, pool_acc,
                               xs, n, t, s, c, cr, stream);
  } else if (cr <= 16) {
    launch_sweep<T, 16, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc,
                                  pool_acc, xs, n, t, s, c, cr, stream);
  } else {
    launch_sweep<T, 64, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc,
                                  pool_acc, xs, n, t, s, c, cr, stream);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((npool + 255) / 256);
  pool_finalize<T><<<blocks, 256, 0, stream>>>(pool_acc, (T*)pool, npool,
                                               1.f / (float)s);
  return (int)cudaGetLastError();
}

template <typename T>
int apply_impl(int tc, const void* x, const void* w, const void* g1,
               const void* gch, const void* wn, void* out, int n, int t,
               int s, int c, int f, cudaStream_t stream) {
  if (tc) {
    if (sizeof(T) != 2 || !tc_ok(c, x, w, gch))
      return (int)cudaErrorInvalidValue;
    launch_tc<64, false>(x, w, wn, g1, gch, out, nullptr, nullptr, nullptr,
                         n, t, s, c, f, stream);
  } else {
    launch_sweep<T, 64, false>(x, w, wn, g1, gch, out, nullptr, nullptr,
                               nullptr, n, t, s, c, f, stream);
  }
  return (int)cudaGetLastError();
}

template <bool XS>
int stats_entry(int dtype, const void* x, const void* w, const void* wp3,
                void* xs, void* mc, void* pool, void* x3, void* pool_acc,
                int n, int t, int s, int c, int cr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* acc = (float*)pool_acc;
  if (dtype == 0)
    return stats_impl<float, XS>(x, w, wp3, xs, mc, pool, x3, acc, n, t, s,
                                 c, cr, st);
  if (dtype == 1)
    return stats_impl<__nv_bfloat16, XS>(x, w, wp3, xs, mc, pool, x3, acc, n,
                                         t, s, c, cr, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer to a
// contiguous tensor of that dtype (pool_acc: f32 scratch of n*t*c).  Returns
// the cudaError_t of the launches (0 = success).
extern "C" int ehgr_action_stats(int dtype, const void* x, const void* w,
                                 const void* wp3, void* mc, void* pool,
                                 void* x3, void* pool_acc, int n, int t,
                                 int s, int c, int cr, void* stream) {
  return stats_entry<false>(dtype, x, w, wp3, nullptr, mc, pool, x3,
                            pool_acc, n, t, s, c, cr, stream);
}

// action_stats' outputs plus x_shift [N,T,S,C] in xs.
extern "C" int ehgr_action_prologue(int dtype, const void* x, const void* w,
                                    const void* wp3, void* xs, void* mc,
                                    void* pool, void* x3, void* pool_acc,
                                    int n, int t, int s, int c, int cr,
                                    void* stream) {
  return stats_entry<true>(dtype, x, w, wp3, xs, mc, pool, x3, pool_acc, n,
                           t, s, c, cr, stream);
}

// action_apply off its main path (the main path is csrc/action_apply.cu):
// tc = 1 the tensor-core sweep (bf16, C % 8 == 0, x, w, gch 16-byte
// aligned, else cudaErrorInvalidValue), tc = 0 the FMA sweep.
extern "C" int ehgr_action_apply(int dtype, int tc, const void* x,
                                 const void* w, const void* g1,
                                 const void* gch, const void* wn, void* out,
                                 int n, int t, int s, int c, int f,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return apply_impl<float>(tc, x, w, g1, gch, wn, out, n, t, s, c, f, st);
  if (dtype == 1)
    return apply_impl<__nv_bfloat16>(tc, x, w, g1, gch, wn, out, n, t, s, c,
                                     f, st);
  return (int)cudaErrorInvalidValue;
}
