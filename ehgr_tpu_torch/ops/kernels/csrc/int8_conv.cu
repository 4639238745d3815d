// int8 implicit-GEMM convolution for Hopper (sm_90a), CUDA C++ with a plain
// C interface loaded through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces no TPU kernel: the JAX package computes its int8 convolution
// outside Pallas, as XLA's lax.conv_general_dilated(xq, wq, ...,
// preferred_element_type=int32) (ehgr_tpu/ops/quantize.py:121-125), and
// PyTorch has no int8 convolution on CUDA (torch._int_mm covers a 1x1
// stride-1 site only).  It computes
//   out[m, c] = dtype( float(sum_k xq[m, k] * wq[c, k]) * scale[c] )
// with the sum in int32, on
//   xq    int8 [N, H, W, Cin]  (the model's channels_last activation),
//   wq    int8 [Cout, KH, KW, Cin]  (K = KH*KW*Cin contiguous),
//   scale f32 [Cout]  (xs * ws, computed by the caller, so the product
//         is the JAX package's),
//   out   bf16 or f32 [N, Ho, Wo, Cout],
// where row m = (n, oh, ow) gathers the input pixel (oh*stride - pad + kh,
// ow*stride - pad + kw) for each tap, zero outside the image.  The epilogue
// is JAX's order: convert the int32 sum to f32 (round to nearest), one f32
// multiply by scale[c], then round to bf16 (to nearest even), so the result
// is bitwise that of int8_conv_plain (ops/kernels/int8_conv.py).
//
// What bounds it on the H100: operations at the 3x3 sites with wide
// channels (K = 9 * Cin), bytes at the 1x1 sites (K = Cin, each output
// element written as 2 or 4 bytes against K multiply-adds).
//
// Design (simple and right first; wgmma on s8, TMA and a deeper ring are
// later work):
//   * A block computes a 128 x 64 tile of out (rows x output channels) with
//     4 warps, 2 x 2, each 64 x 32, as 4 x 4 tensor-core products
//     mma.sync.m16n8k32.s32.s8.s8.s32 for every 32 bytes of K.
//   * K advances in steps of 64 bytes through a 3-stage cp.async ring in
//     shared memory.  Cin % 16 == 0, so each 16-byte piece of a row of the
//     A tile lies in one tap (kh, kw): it is one cp.async from the input
//     pixel, or a zero fill (padding, rows past M, K past its end).  The
//     weight tile is read the same way from its K-contiguous rows.
//   * Rows of the shared tiles are 80 bytes apart, so the 32-bit fragment
//     reads of a warp (8 rows x 4 words) fall in 32 different banks.
//   * Blocks walk the output channel tiles fastest, so the blocks that read
//     one activation tile run together and it comes from L2 after its first
//     read.
//   * Everything launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;               // rows of out a block
constexpr int BN = 64;                // output channels a block
constexpr int BK = 64;                // bytes of K a ring stage
constexpr int kThreads = 128;         // 4 warps, 2 (rows) x 2 (channels)
constexpr int kStages = 3;
constexpr int kRow = BK + 16;         // bytes between rows of a shared tile
constexpr int kTileA = BM * kRow;
constexpr int kTileB = BN * kRow;

struct Geometry {
  int n, h, w, cin, cout, kh, kw, stride, pad, ho, wo;
  int m, k;                           // GEMM rows (N*Ho*Wo) and depth
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, OutT* __restrict__ out,
          Geometry g) {
  __shared__ __align__(16) int8_t smem[kStages * (kTileA + kTileB)];
  int8_t* sa = smem;
  int8_t* sb = smem + kStages * kTileA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (g.cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;

  // the 16-byte piece of K this thread copies, and its rows: A rows
  // row0 + 32 i (i < 4), B rows row0 + 32 i (i < 2)
  const int seg = tid & 3, row0 = tid >> 2;
  long long a_img[4];
  int a_ih[4], a_iw[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + row0 + 32 * i;
    a_ok[i] = m < g.m;
    const long long mm = a_ok[i] ? m : 0;
    const long long hw = (long long)g.ho * g.wo;
    const long long img = mm / hw;
    const int r = (int)(mm - img * hw);
    const int oh = r / g.wo, ow = r - (r / g.wo) * g.wo;
    a_img[i] = img * g.h * g.w * g.cin;
    a_ih[i] = oh * g.stride - g.pad;
    a_iw[i] = ow * g.stride - g.pad;
  }

  auto load_stage = [&](int stage, int k0) {
    const int k = k0 + seg * 16;
    const bool k_ok = k < g.k;
    const int tap = k_ok ? k / g.cin : 0;
    const int ci = k - tap * g.cin;
    const int kh = tap / g.kw, kw = tap - (tap / g.kw) * g.kw;
    int8_t* da = sa + stage * kTileA + seg * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_ih[i] + kh, iw = a_iw[i] + kw;
      const bool ok = a_ok[i] && k_ok && ih >= 0 && ih < g.h && iw >= 0 &&
                      iw < g.w;
      const int8_t* src =
          ok ? x + a_img[i] + ((long long)ih * g.w + iw) * g.cin + ci : x;
      cp_async16(da + (row0 + 32 * i) * kRow, src, ok);
    }
    int8_t* db = sb + stage * kTileB + seg * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = n0 + row0 + 32 * i;
      const bool ok = k_ok && c < g.cout;
      const int8_t* src = ok ? w + (long long)c * g.k + k : w;
      cp_async16(db + (row0 + 32 * i) * kRow, src, ok);
    }
  };

  const int k_tiles = (g.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s * BK);
    cp_async_commit();
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int gr = lane >> 2, tq = (lane & 3) * 4;   // fragment row, byte
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed (this thread's)
    __syncthreads();                // ... and every thread's; kt-1 is done
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next * BK);
    cp_async_commit();
    const int8_t* ta = sa + (kt % kStages) * kTileA;
    const int8_t* tb = sb + (kt % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = ta + (wm + 16 * i + gr) * kRow + kk + tq;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = tb + (wn + 8 * j + gr) * kRow + kk + tq;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows wm + 16 i + gr (+8), channels wn + 8 j +
  // 2 (lane & 3) (+1); Cout % 8 == 0, so an 8-channel group is all in or
  // all out
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn + 8 * j + 2 * (lane & 3);
    if (c >= g.cout) continue;
    const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm + 16 * i + gr + 8 * half;
        if (m >= g.m) continue;
        store2(out + m * g.cout + c,
               __fmul_rn(__int2float_rn(acc[i][j][2 * half]), s0),
               __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s1));
      }
    }
  }
}

}  // namespace

// dtype (of out): 0 = float32, 1 = bfloat16.  x: int8 [n, h, w, cin]; wt:
// int8 [cout, kh, kw, cin]; scale: f32 [cout]; out: [n, ho, wo, cout]; all
// contiguous device pointers, x and wt 16-byte aligned; cin % 16 == 0 and
// cout % 8 == 0.  Returns the cudaError_t of the launch (0 = success).
extern "C" int ehgr_int8_conv(int dtype, const void* x, const void* wt,
                              const void* scale, void* out, int n, int h,
                              int w, int cin, int cout, int kh, int kw,
                              int stride, int pad, int ho, int wo,
                              void* stream) {
  if (cin % 16 != 0 || cout % 8 != 0 || n <= 0 || ho <= 0 || wo <= 0)
    return (int)cudaErrorInvalidValue;
  Geometry g{n, h, w, cin, cout, kh, kw, stride, pad, ho, wo,
             n * ho * wo, kh * kw * cin};
  const long long blocks =
      (long long)((g.m + BM - 1) / BM) * ((cout + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    int8_conv<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int8_t*)x, (const int8_t*)wt, (const float*)scale,
        (float*)out, g);
  else if (dtype == 1)
    int8_conv<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int8_t*)x, (const int8_t*)wt, (const float*)scale,
        (__nv_bfloat16*)out, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
