// TSM temporal shift for Hopper (sm_90a), CUDA C++ with a plain C interface
// loaded through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces the TPU kernel tsm_shift_pallas of ehgr_tpu/ops/pallas/shift.py
// (_shift_kernel through _run_shift, pallas_call at :72; custom VJP at
// :94-96, the reverse shift):
//   forward   channels [0, fold)       read x[t+1]
//             channels [fold, 2*fold)  read x[t-1]
//             the rest                 read x[t]
//   reverse   the two directions swapped (the transpose of the forward)
// with zero where the source frame lies outside the clip, fold = C / fold_div,
// on x [N,T,S,C] (S = H*W, contiguous).
//
// What bounds it on the H100: bytes.  It is a copy with zeros: each output
// element is written once and each input element read at most once, and it
// does no arithmetic.
//
// Design (simple and right first):
//   * A thread owns one (n, s) column and V channels (16 bytes: 8 bf16 or 4
//     fp32) and walks T, issuing the loads of TC steps together ahead of
//     their stores.  Neighbouring threads take neighbouring channel vectors,
//     so a warp's loads and stores are contiguous.  C not a multiple of V (or
//     a pointer off 16 bytes) takes V = 1.
//   * The source frame is chosen per channel range.  A vector that lies in
//     one range has one source frame: one 16-byte load, or none at a clip
//     edge (a zero is stored and nothing is read).  fold need not be a
//     multiple of V (C = 96, fold_div = 8 gives fold = 12), so a vector that
//     straddles fold or 2*fold picks each lane's source frame on its own
//     (at most two such vectors a row).
//   * The data move as raw bits (16-bit lanes for bf16, 32-bit for fp32), so
//     the result is bitwise the plain shift's, -0.0 and NaN included.
//   * Grid: x over channel vectors, y over (n, s) rows in a grid-stride loop
//     (the geometry of shift.cu, computed by the Python wrapper).
//   * Everything launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TC = 8;                  // T steps whose loads issue together

template <int B>
struct Raw;                            // an unsigned type of B bytes
template <>
struct Raw<16> { using R = uint4; };
template <>
struct Raw<4> { using R = unsigned int; };
template <>
struct Raw<2> { using R = unsigned short; };

// Frame offset of channel ch's source: +1 reads t+1, -1 reads t-1.
__device__ __forceinline__ int src_dt(int ch, int fold, bool reverse) {
  if (ch < fold) return reverse ? -1 : 1;
  if (ch < 2 * fold) return reverse ? 1 : -1;
  return 0;
}

// U: one element's bits; V: elements a thread moves at once.
template <typename U, int V>
__global__ void __launch_bounds__(kThreads)
tsm_sweep(const U* __restrict__ x, U* __restrict__ y, int n, int tn, int s,
          int c, int fold, bool reverse) {
  using R = typename Raw<sizeof(U) * V>::R;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= c) return;
  const int d_lo = src_dt(c0, fold, reverse);
  // the three ranges have three different offsets, so equal offsets at the
  // vector's ends mean one range for all of it
  const bool uniform = d_lo == src_dt(c0 + V - 1, fold, reverse);
  const long long rows = (long long)n * s;
  const long long ts = (long long)s * c;            // stride of one t step
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += (long long)gridDim.y * blockDim.y) {
    const long long nn = r / s;
    const long long base = (nn * tn * s + (r - nn * s)) * c + c0;
    if (uniform) {
      for (int t0 = 0; t0 < tn; t0 += TC) {
        R v[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int src = t0 + j + d_lo;
          v[j] = R{};
          if (t0 + j < tn && src >= 0 && src < tn)
            v[j] = __ldg(reinterpret_cast<const R*>(x + base + src * ts));
        }
#pragma unroll
        for (int j = 0; j < TC; ++j)
          if (t0 + j < tn)
            *reinterpret_cast<R*>(y + base + (t0 + j) * ts) = v[j];
      }
    } else {
      for (int t = 0; t < tn; ++t) {
        union {
          R q;
          U e[V];
        } o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int src = t + src_dt(c0 + i, fold, reverse);
          o.e[i] = (src >= 0 && src < tn) ? __ldg(x + base + src * ts + i)
                                          : U(0);
        }
        *reinterpret_cast<R*>(y + base + t * ts) = o.q;
      }
    }
  }
}

template <typename U, int V>
int launch(const void* x, void* y, int n, int t, int s, int c, int fold,
           int reverse, int bx, int by, int gx, int gy, cudaStream_t stream) {
  if (bx * by != kThreads) return (int)cudaErrorInvalidValue;
  tsm_sweep<U, V><<<dim3(gx, gy), dim3(bx, by), 0, stream>>>(
      (const U*)x, (U*)y, n, t, s, c, fold, reverse != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: channels a thread moves at once
// (16 bytes, or 1); fold = C / fold_div; reverse: 0 = forward, 1 = the
// transpose; (bx, by, gx, gy): block and grid, from shift.py's geometry().
// x and y are device pointers to contiguous [N,T,S,C] tensors of that dtype.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ehgr_tsm_shift(int dtype, const void* x, void* y, int n, int t,
                              int s, int c, int fold, int reverse, int vec,
                              int bx, int by, int gx, int gy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4)
    return launch<unsigned int, 4>(x, y, n, t, s, c, fold, reverse, bx, by,
                                   gx, gy, st);
  if (dtype == 0 && vec == 1)
    return launch<unsigned int, 1>(x, y, n, t, s, c, fold, reverse, bx, by,
                                   gx, gy, st);
  if (dtype == 1 && vec == 8)
    return launch<unsigned short, 8>(x, y, n, t, s, c, fold, reverse, bx, by,
                                     gx, gy, st);
  if (dtype == 1 && vec == 1)
    return launch<unsigned short, 1>(x, y, n, t, s, c, fold, reverse, bx, by,
                                     gx, gy, st);
  return (int)cudaErrorInvalidValue;
}
