// Learnable (ACTION) temporal shift for Hopper (sm_90a), CUDA C++ with a
// plain C interface loaded through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces the TPU kernel learnable_shift_pallas of
// ehgr_tpu/ops/pallas/shift.py (_lshift_kernel, pallas_call at :141, custom
// VJP at :166-181):
//   forward   y[t]  = w0*x[t-1] + w1*x[t] + w2*x[t+1]   (zero at clip edges)
//   backward  dx[t] = w2*g[t-1] + w1*g[t] + w0*g[t+1]   (the same sweep over
//                                                        g, taps reversed)
//             dw[k,c] = sum over n,t,s of x[t+k-1] * g[t], in f32
// on x, g [N,T,S,C] (S = H*W, contiguous) and w [3,C].
//
// What bounds them on the H100: bytes.  The forward reads x once and writes
// y once (2*N*T*S*C elements), the backward reads g and x once and writes dx
// once (3*N*T*S*C), for 3-9 flops per element: far under the card's
// operations-per-byte line.
//
// Design (simple and right first):
//   * The TPU kernel held the whole T axis of an (n, h-tile) slab in VMEM so
//     each element was read from HBM once.  Here a thread owns one (n, s)
//     column through T and V channels (16 bytes: 8 bf16 or 4 fp32) and walks
//     T with a sliding window in registers (prev, cur, next), so each element
//     is still read once; the loads of TC steps are issued together ahead of
//     their use to keep enough bytes in flight.  Neighbouring threads take
//     neighbouring channel vectors, so a warp's loads are contiguous.  C not
//     a multiple of V (or a pointer off 16 bytes) takes V = 1.
//   * Clip edges: the window starts with prev = 0 and stops at t = T-1 with
//     next = 0, so the shift never crosses from one clip (n) into another,
//     in the backward's dx too.
//   * dw is a reduction over N*T*S rows, across blocks.  Each thread keeps
//     its 3*V partial sums in f32 registers over all its rows; the block sums
//     them over threadIdx.y in shared memory and writes one partial per
//     (block row, k, c) to f32 scratch; a second small kernel adds the
//     partials in a fixed order and casts to w's dtype.  No atomics: the
//     result is the same from run to run.
//   * Grid: x over channel vectors, y over (n, s) rows in a grid-stride loop,
//     capped near 8 blocks of 256 threads per SM (the geometry is computed by
//     the Python wrapper, shift.py, so the CPU tests reach it).
//   * Everything launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Loads and stores of V elements of T: ld() returns the raw bits (so a run
// of loads can be issued before any is used), cvt() widens them to f32, st()
// rounds f32 to T and stores.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  using R = uint4;
  static __device__ __forceinline__ R zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ R ld(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void cvt(R r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void st(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using R = uint4;
  static __device__ __forceinline__ R zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ R ld(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void cvt(R r, float (&f)[8]) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p,
                                            const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pack(f[0], f[1]), bf16_pack(f[2], f[3]),
                   bf16_pack(f[4], f[5]), bf16_pack(f[6], f[7]));
  }
};

template <>
struct Io<float, 1> {
  using R = float;
  static __device__ __forceinline__ R zero() { return 0.f; }
  static __device__ __forceinline__ R ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void cvt(R r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ void st(float* p, const float (&f)[1]) {
    *p = f[0];
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using R = unsigned short;
  static __device__ __forceinline__ R zero() { return 0; }
  static __device__ __forceinline__ R ld(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void cvt(R r, float (&f)[1]) {
    f[0] = __uint_as_float((uint32_t)r << 16);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p,
                                            const float (&f)[1]) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// One sweep over `in` [N,T,S,C] writing out[t] = a0*in[t-1] + a1*in[t] +
// a2*in[t+1].  Forward: in = x, (a0,a1,a2) = (w0,w1,w2).  BWD: in = g, the
// taps reversed, and the block also writes its dw partials (x read once).
template <typename T, int V, int TC, bool BWD>
__global__ void __launch_bounds__(kThreads)
shift_sweep(const T* __restrict__ in, const T* __restrict__ x,
            const T* __restrict__ w, T* __restrict__ out,
            float* __restrict__ part, int n, int tn, int s, int c) {
  using IO = Io<T, V>;
  using R = typename IO::R;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool on = c0 < c;
  float dw0[V], dw1[V], dw2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) dw0[i] = dw1[i] = dw2[i] = 0.f;

  if (on) {
    float a0[V], a1[V], a2[V];
    IO::cvt(IO::ld(w + (BWD ? 2 : 0) * c + c0), a0);
    IO::cvt(IO::ld(w + c + c0), a1);
    IO::cvt(IO::ld(w + (BWD ? 0 : 2) * c + c0), a2);
    const long long rows = (long long)n * s;
    const long long ts = (long long)s * c;          // stride of one t step
    for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
         r < rows; r += (long long)gridDim.y * blockDim.y) {
      const long long nn = r / s;
      const long long base = (nn * tn * s + (r - nn * s)) * c + c0;
      float prev[V], cur[V];
#pragma unroll
      for (int i = 0; i < V; ++i) prev[i] = 0.f;
      IO::cvt(IO::ld(in + base), cur);
      for (int t0 = 0; t0 < tn; t0 += TC) {
        R nx[TC];                     // in[t+1] for t in [t0, t0+TC)
        R xr[BWD ? TC : 1];           // x[t]
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int t = t0 + j;
          nx[j] = (t + 1 < tn) ? IO::ld(in + base + (t + 1) * ts) : IO::zero();
          if constexpr (BWD)
            xr[j] = (t < tn) ? IO::ld(x + base + t * ts) : IO::zero();
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int t = t0 + j;
          if (t >= tn) break;
          float nxt[V], o[V];
          IO::cvt(nx[j], nxt);
#pragma unroll
          for (int i = 0; i < V; ++i)
            o[i] = a0[i] * prev[i] + a1[i] * cur[i] + a2[i] * nxt[i];
          IO::st(out + base + t * ts, o);
          if constexpr (BWD) {
            // dw0 = sum x[t-1] g[t] = sum x[t] g[t+1]; dw2 = sum x[t] g[t-1]
            float xv[V];
            IO::cvt(xr[j], xv);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              dw0[i] = fmaf(xv[i], nxt[i], dw0[i]);
              dw1[i] = fmaf(xv[i], cur[i], dw1[i]);
              dw2[i] = fmaf(xv[i], prev[i], dw2[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < V; ++i) {
            prev[i] = cur[i];
            cur[i] = nxt[i];
          }
        }
      }
    }
  }

  if constexpr (BWD) {
    // sum the partials of the block's rows (threadIdx.y) for each channel;
    // every thread takes part in the barriers, the ones past C with zeros
    __shared__ float red[kThreads * 3 * V];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    float* mine = red + tid * 3 * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i] = dw0[i];
      mine[V + i] = dw1[i];
      mine[2 * V + i] = dw2[i];
    }
    __syncthreads();
    for (int half = blockDim.y / 2; half > 0; half >>= 1) {
      if (threadIdx.y < half) {
        const float* other = red + (tid + half * blockDim.x) * 3 * V;
#pragma unroll
        for (int k = 0; k < 3 * V; ++k) mine[k] += other[k];
      }
      __syncthreads();
    }
    if (threadIdx.y == 0 && on) {
      float* p = part + (long long)blockIdx.y * 3 * c + c0;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) p[k * c + i] = mine[k * V + i];
    }
  }
}

// dw[i] = sum over block rows b of part[b, i], i over 3*C, in a fixed order.
template <typename T>
__global__ void dw_reduce(const float* __restrict__ part, T* __restrict__ dw,
                          int parts, int n3c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n3c) return;
  float acc = 0.f;
  for (int b = 0; b < parts; ++b) acc += part[(long long)b * n3c + i];
  float o[1] = {acc};
  Io<T, 1>::st(dw + i, o);
}

template <typename T, int V, bool BWD>
int launch(const void* in, const void* x, const void* w, void* out,
           float* part, void* dw, int n, int t, int s, int c, int bx, int by,
           int gx, int gy, cudaStream_t stream) {
  if (bx * by != kThreads) return (int)cudaErrorInvalidValue;
  constexpr int TC = BWD ? 4 : 8;
  shift_sweep<T, V, TC, BWD><<<dim3(gx, gy), dim3(bx, by), 0, stream>>>(
      (const T*)in, (const T*)x, (const T*)w, (T*)out, part, n, t, s, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !BWD) return (int)e;
  const int n3c = 3 * c;
  dw_reduce<T><<<(n3c + 255) / 256, 256, 0, stream>>>(part, (T*)dw, gy, n3c);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int dtype, int vec, const void* in, const void* x,
             const void* w, void* out, float* part, void* dw, int n, int t,
             int s, int c, int bx, int by, int gx, int gy,
             cudaStream_t stream) {
  if (dtype == 0 && vec == 4)
    return launch<float, 4, BWD>(in, x, w, out, part, dw, n, t, s, c, bx, by,
                                 gx, gy, stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1, BWD>(in, x, w, out, part, dw, n, t, s, c, bx, by,
                                 gx, gy, stream);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8, BWD>(in, x, w, out, part, dw, n, t, s, c,
                                         bx, by, gx, gy, stream);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1, BWD>(in, x, w, out, part, dw, n, t, s, c,
                                         bx, by, gx, gy, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: channels a thread loads at once
// (16 bytes, or 1); (bx, by, gx, gy): block and grid, from shift.py's
// geometry().  Every pointer is a device pointer to a contiguous tensor of
// that dtype (part: f32 scratch of gy*3*c).  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int ehgr_shift_fwd(int dtype, const void* x, const void* w,
                              void* y, int n, int t, int s, int c, int vec,
                              int bx, int by, int gx, int gy, void* stream) {
  return dispatch<false>(dtype, vec, x, nullptr, w, y, nullptr, nullptr, n, t,
                         s, c, bx, by, gx, gy, (cudaStream_t)stream);
}

extern "C" int ehgr_shift_bwd(int dtype, const void* x, const void* g,
                              const void* w, void* dx, void* part, void* dw,
                              int n, int t, int s, int c, int vec, int bx,
                              int by, int gx, int gy, void* stream) {
  return dispatch<true>(dtype, vec, g, x, w, dx, (float*)part, dw, n, t, s, c,
                        bx, by, gx, gy, (cudaStream_t)stream);
}
