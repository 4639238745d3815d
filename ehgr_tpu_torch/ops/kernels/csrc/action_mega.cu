// ACTION sweeps off the main path, for Hopper (sm_90a): CUDA C++ with a
// plain C interface loaded through ctypes (ehgr_tpu_torch/ops/kernels/
// build.py).  The main path runs csrc/action_stats.cu (action_stats,
// action_prologue) and csrc/action_apply.cu (action_apply): bf16 with
// C % 64 == 0 and 16-byte aligned operands, which every ResNet-50 ACTION
// site meets.  This file computes the same functions for fp32 and for the
// other bf16 shapes (the 'fma_sweep' route of ops/kernels/action_mega.py).
//
// Replaces the TPU kernels of ehgr_tpu/ops/pallas/action_mega.py:
//   action_stats  (_stats_kernel, pallas_call at :142)
//       x [N,T,S,C], w [3,C], W_p3 [C,Cr]  ->  mc [N,T,S], pool [N,T,C],
//       x3 = x_shift @ W_p3 [N,T,S,Cr], with
//       x_shift[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1] (zero at clip edges)
//       recomputed on the fly and never written.
//   action_apply  (_apply_kernel, pallas_call at :209)
//       out = (x_shift * (g1[row] + gch[n,t,c])) @ W_net  [N,T,S,F];
//       the gated sum never reaches device memory.
// and the TPU kernel of ehgr_tpu/ops/pallas/action_fused.py:
//   action_prologue  (action_fused_prologue :60, pallas_call at :75)
//       the action_stats sweep plus one store of x_shift [N,T,S,C]: the
//       same template with XS = true, where the block that owns mc/pool
//       also writes the shifted tile it built.
//
// Design (one plain sweep; the speed is the Hopper kernels' business):
//   * One block owns BM=64 rows of one (n,t) frame and BN output columns
//     and walks all of C in BK=32 chunks, so W never has to fit shared
//     memory and a block's row reductions (mc) complete in the block.  Row
//     tiles never straddle two frames: a ragged last tile is masked on load
//     (zero rows) and store.
//   * The A tile is built in f32 from three reads of x (rows r-S, r, r+S of
//     the same clip; tap w0 only for t>0, w2 only for t<T-1), gated for
//     apply, and the product runs on plain FMA, 4 x BN/16 outputs a thread,
//     so fp32 stays exact fp32.
//   * pool in a fixed order, with no atomics: the block of column block 0
//     writes its tile's f32 column sums as one row of the partials
//     [N*T*strips, C]; pool_reduce (csrc/action_common.cuh) sums them in
//     strip order and divides by S.  Two calls on the same input agree
//     bitwise.  The TPU kernel accumulated pool in the input dtype; this
//     one in f32.
//   * Everything launches on the caller's stream and allocates nothing.

#include "action_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;
static_assert(BM == kPoolStrip, "one row of pool partials a row tile");
constexpr int BK = 32;
constexpr int TY = 16;                 // thread rows;  TM = BM / TY = 4
constexpr int TX = 16;                 // thread cols;  TN = BN / TX
constexpr int TM = BM / TY;

// One tile sweep shared by all three kernels.  STATS: A = x_shift, and the
// block also emits mc (row means) and writes its column sums to part; XS
// (with STATS): that block also stores A to xs.  Otherwise
// A = x_shift * (g1[row] + gch[nt, k]).
template <typename T, int BN, bool STATS, bool XS>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ x, const T* __restrict__ wsh,
             const T* __restrict__ wmat, const T* __restrict__ g1,
             const T* __restrict__ gch, T* __restrict__ out,
             T* __restrict__ mc, float* __restrict__ part,
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
        if (k0 + kk < C) part[(size_t)blockIdx.x * C + k0 + kk] = csum;
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

template <typename T, int BN, bool STATS, bool XS = false>
void launch_sweep(const void* x, const void* w, const void* wmat,
                  const void* g1, const void* gch, void* out, void* mc,
                  float* part, void* xs, int n, int t, int s, int c, int f,
                  cudaStream_t stream) {
  const int n_stiles = (s + BM - 1) / BM;
  dim3 grid((unsigned)(n * t * n_stiles), (unsigned)((f + BN - 1) / BN));
  sweep_kernel<T, BN, STATS, XS><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)wmat, (const T*)g1, (const T*)gch,
      (T*)out, (T*)mc, part, (T*)xs, t, s, c, f, n_stiles);
}

// action_stats (XS = false) and action_prologue (XS = true: x_shift to xs)
template <typename T, bool XS>
int stats_impl(const void* x, const void* w, const void* wp3, void* xs,
               void* mc, void* pool, void* x3, float* part, int n, int t,
               int s, int c, int cr, cudaStream_t stream) {
  if (cr <= 16)
    launch_sweep<T, 16, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc, part,
                                  xs, n, t, s, c, cr, stream);
  else
    launch_sweep<T, 64, true, XS>(x, w, wp3, nullptr, nullptr, x3, mc, part,
                                  xs, n, t, s, c, cr, stream);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_pool_reduce<T>(part, pool, n * t, c, s, stream);
}

template <bool XS>
int stats_entry(int dtype, const void* x, const void* w, const void* wp3,
                void* xs, void* mc, void* pool, void* x3, void* part, int n,
                int t, int s, int c, int cr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)part;
  if (dtype == 0)
    return stats_impl<float, XS>(x, w, wp3, xs, mc, pool, x3, p, n, t, s, c,
                                 cr, st);
  if (dtype == 1)
    return stats_impl<bf16, XS>(x, w, wp3, xs, mc, pool, x3, p, n, t, s, c,
                                cr, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer to a
// contiguous tensor of that dtype (part: f32 scratch of
// ehgr_action_pool_scratch_rows(n, t, s) x c).  Returns the cudaError_t of
// the launches (0 = success).
extern "C" int ehgr_action_stats(int dtype, const void* x, const void* w,
                                 const void* wp3, void* mc, void* pool,
                                 void* x3, void* part, int n, int t, int s,
                                 int c, int cr, void* stream) {
  return stats_entry<false>(dtype, x, w, wp3, nullptr, mc, pool, x3, part, n,
                            t, s, c, cr, stream);
}

// action_stats' outputs plus x_shift [N,T,S,C] in xs.
extern "C" int ehgr_action_prologue(int dtype, const void* x, const void* w,
                                    const void* wp3, void* xs, void* mc,
                                    void* pool, void* x3, void* part, int n,
                                    int t, int s, int c, int cr,
                                    void* stream) {
  return stats_entry<true>(dtype, x, w, wp3, xs, mc, pool, x3, part, n, t, s,
                           c, cr, stream);
}

// action_apply off its main path (the main path is csrc/action_apply.cu).
extern "C" int ehgr_action_apply(int dtype, const void* x, const void* w,
                                 const void* g1, const void* gch,
                                 const void* wn, void* out, int n, int t,
                                 int s, int c, int f, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch_sweep<float, 64, false>(x, w, wn, g1, gch, out, nullptr, nullptr,
                                   nullptr, n, t, s, c, f, st);
  else if (dtype == 1)
    launch_sweep<bf16, 64, false>(x, w, wn, g1, gch, out, nullptr, nullptr,
                                  nullptr, n, t, s, c, f, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Rows of the f32 pool partials (part) that ehgr_action_stats and
// ehgr_action_prologue write for x [n,t,s,*].
extern "C" int ehgr_action_pool_scratch_rows(int n, int t, int s) {
  return pool_scratch_rows(n, t, s);
}
