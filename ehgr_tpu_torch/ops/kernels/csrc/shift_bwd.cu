// learnable_shift_bwd for Hopper (sm_90a), route 'strip': one sweep over g
// and x that writes dx and the dw partials, and a second pass that sums the
// partials in a fixed order.  CUDA C++ with a plain C interface loaded
// through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces, on the main path (bf16 with C % 64 == 0 and x, g, w, dx 16-byte
// aligned, which every ResNet-50 ACTION site meets; fp32 and other shapes
// keep shift_sweep<..., true> + dw_reduce of csrc/shift.cu), the custom VJP
// of the TPU kernel learnable_shift_pallas, ehgr_tpu/ops/pallas/shift.py:158
// (_l_bwd at :170-182):
//   dx[t]   = w2*g[t-1] + w1*g[t] + w0*g[t+1]   (zero at clip edges, never
//                                                across clips)
//   dw[k,c] = sum over n, t, s of x[t+k-1] * g[t], in f32, returned in bf16
// on x, g [N,T,S,C] (S = H*W) and w [3,C].  The rounding points are the
// sweep's: dx in f32 in the same order and rounded once, dw accumulated in
// f32 and rounded once.
//
// What bounds it on the H100: bytes.  It must read g and x once and write
// dx once (3*N*T*S*C bf16), for 11 flops an element: far under the card's
// operations-per-byte line.
//
// Design:
//   * A block owns a strip of R rows (S positions) of one clip n and one
//     64-channel chunk (one 128-byte row segment), and walks all T frames of
//     it.  Its 256 threads cover 32 rows x 8 16-byte vectors at a time; a
//     strip of more rows is walked in sub-strips of 32, each through all T
//     frames.  The host picks R per site (shift.py strip_geometry): up to 4
//     sub-strips where that still leaves two waves of two blocks an SM, so
//     the 56^2 sites run long blocks and the 14^2 / 7^2 sites many.
//   * The g and x frame tiles ride a cp.async ring of kStages stages in
//     shared memory, 16-byte copies, kStages - 1 frames ahead of their use:
//     24 KB a block in flight, two blocks an SM.  Each thread copies and
//     later reads only its own 16 bytes of a stage, so the ring needs no
//     barrier: cp.async.wait_group alone makes a thread's copies visible to
//     it.  A slot is refilled one step after it was read.  Rows past the
//     strip are zero-filled, not read; the frame after the clip's last is
//     never loaded (its g is zero), so nothing crosses into the next clip.
//   * dx and dw from the same pass: a thread keeps g[t-2], g[t-1] and
//     x[t-1] of its row and channels in registers (f32).  When g[t] and x[t]
//     arrive it adds x[t]*g[t] (dw1), x[t]*g[t-1] (dw2) and x[t-1]*g[t]
//     (dw0) to its 24 f32 sums and stores dx[t-1] (16 bytes); dx[T-1]
//     follows the last frame.  g and x are read from device memory once.
//   * dw in a fixed order, no atomics: the 32 rows of the block meet by two
//     xor shuffles (commutative pairs, so every lane of a group holds the
//     same sum), the 8 warps in shared memory summed in warp order; one f32
//     partial row [3, 64] per block goes to part [N*strips, 3, C].
//     dw_finish sums them over the N*strips partials: a block takes cb
//     columns and 256 / cb threads along the partials, each summing a
//     strided run in order, then a tree in shared memory; cb = min(C/64, 32)
//     rounded down to a power of two, so C <= 2048 gives 192 blocks (at
//     least one an SM) and no thread adds more than a few partials in
//     series.  Two calls on the same input agree bitwise in dx and dw.
//   * Everything launches on the caller's stream and allocates nothing.

#include "action_common.cuh"

namespace {

constexpr int kRows = 32;                  // rows of a sub-strip
constexpr int kVecs = 8;                   // 16-byte vectors of a chunk
constexpr int kChunk = kVecs * 8;          // channels of a chunk: 128 bytes
constexpr int kThreads = kRows * kVecs;    // 256
constexpr int kStages = 4;                 // ring stages: 3 frames ahead
constexpr int kWarps = kThreads / 32;

// 16 bytes global -> shared, asynchronously; zeros where !in (nothing
// read).  The "memory" clobber keeps the compiler from moving the read of a
// slot past the copy that refills it.
__device__ __forceinline__ void ring_copy16(uint32_t dst, const void* src,
                                            bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One ring stage: the g and the x vector of every thread, in thread order
// (a warp's 32 vectors are 512 contiguous bytes: no bank conflict).
struct Stage {
  uint4 g[kThreads];
  uint4 x[kThreads];
};
static_assert(kStages * sizeof(Stage) >= kWarps * 3 * kChunk * 4,
              "the dw sums of the warps fit in the ring");

__global__ void __launch_bounds__(kThreads, 2)
shift_bwd_strip(const bf16* __restrict__ x, const bf16* __restrict__ g,
                const bf16* __restrict__ w, bf16* __restrict__ dx,
                float* __restrict__ part, int tlen, int S, int C, int R,
                int nstrips) {
  __shared__ __align__(128) Stage ring[kStages];

  const int chunks = C / kChunk;
  const int chunk = blockIdx.x % chunks;
  const int p = blockIdx.x / chunks;           // n * nstrips + strip
  const int n = p / nstrips;
  const int row0 = (p - n * nstrips) * R;
  const int rows = min(R, S - row0);           // rows of this strip
  const int J = (rows + kRows - 1) / kRows * tlen;   // steps: (sub, frame)
  const int tid = threadIdx.x;
  const int vec = tid % kVecs, trow = tid / kVecs;
  const int c0 = chunk * kChunk + vec * 8;
  const long long clip = (long long)n * tlen * S * C + c0;
  const bf16* gc = g + clip;
  const bf16* xc = x + clip;
  bf16* dxc = dx + clip;

  // taps of dx: the forward's reversed
  float ap[8], ac[8], an[8];
  unpack8(ldg16(w + 2 * C + c0), ap);
  unpack8(ldg16(w + C + c0), ac);
  unpack8(ldg16(w + c0), an);

  // issue: the copies of step j (sub-strip ju, frame jf) into slot j % kStages
  int j_issue = 0, ju = 0, jf = 0;
  auto issue = [&]() {
    if (j_issue < J) {
      const int r = ju * kRows + trow;
      const bool in = r < rows;
      const long long off = in ? ((long long)jf * S + row0 + r) * C : 0;
      Stage& st = ring[j_issue % kStages];
      ring_copy16(smem_u32(&st.g[tid]), gc + off, in);
      ring_copy16(smem_u32(&st.x[tid]), xc + off, in);
      if (++jf == tlen) {
        jf = 0;
        ++ju;
      }
    }
    ++j_issue;
    ring_commit();              // one group a step, empty past the end
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();

  float dw0[8], dw1[8], dw2[8], gp2[8], gp1[8], xp1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dw0[i] = dw1[i] = dw2[i] = 0.f;

  int u = 0, f = 0;
  for (int j = 0; j < J; ++j) {
    issue();                    // refills the slot read at step j - 1
    cp_async_wait<kStages - 1>();
    const Stage& st = ring[j % kStages];
    float gf[8], xf[8];
    unpack8(st.g[tid], gf);
    unpack8(st.x[tid], xf);
    if (f == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) gp2[i] = gp1[i] = xp1[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dw1[i] = fmaf(xf[i], gf[i], dw1[i]);
      dw2[i] = fmaf(xf[i], gp1[i], dw2[i]);
      dw0[i] = fmaf(xp1[i], gf[i], dw0[i]);
    }
    const int r = u * kRows + trow;
    const long long at = ((long long)f * S + row0 + r) * C;
    if (f > 0 && r < rows) {    // dx[f-1], its next frame now here
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = ap[i] * gp2[i] + ac[i] * gp1[i] + an[i] * gf[i];
      *reinterpret_cast<uint4*>(dxc + at - (long long)S * C) = pack8(o);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gp2[i] = gp1[i];
      gp1[i] = gf[i];
      xp1[i] = xf[i];
    }
    if (++f == tlen) {          // dx[T-1]: no frame after the clip's last
      if (r < rows) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          o[i] = ap[i] * gp2[i] + ac[i] * gp1[i] + an[i] * 0.f;
        *reinterpret_cast<uint4*>(dxc + at) = pack8(o);
      }
      f = 0;
      ++u;
    }
  }

  // dw over the block's rows: lanes l, l^8, l^16, l^24 hold channels vec
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int m = 8; m <= 16; m *= 2) {
      dw0[i] += __shfl_xor_sync(0xffffffffu, dw0[i], m);
      dw1[i] += __shfl_xor_sync(0xffffffffu, dw1[i], m);
      dw2[i] += __shfl_xor_sync(0xffffffffu, dw2[i], m);
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // every thread done with its ring slots
  float* red = reinterpret_cast<float*>(ring);   // [warp][k][64]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kVecs) {
    float* o = red + warp * 3 * kChunk + lane * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i] = dw0[i];
      o[kChunk + i] = dw1[i];
      o[2 * kChunk + i] = dw2[i];
    }
  }
  __syncthreads();
  if (tid < 3 * kChunk) {       // (k, channel) = (tid / 64, tid % 64)
    float acc = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) acc += red[wi * 3 * kChunk + tid];
    const int k = tid / kChunk;
    part[((long long)p * 3 + k) * C + chunk * kChunk + tid % kChunk] = acc;
  }
}

// dw[j] = sum over the partial rows q of part[q, j], j over 3*C: cb columns
// a block, 256 / cb threads along q, each summing q = r, r + 256/cb, ... in
// order, then a tree over r in shared memory (fixed order).
__global__ void __launch_bounds__(kThreads)
dw_finish(const float* __restrict__ part, bf16* __restrict__ dw, int parts,
          int n3c, int cb) {
  __shared__ float red[kThreads];
  const int col = threadIdx.x % cb, r = threadIdx.x / cb;
  const int rp = kThreads / cb;
  const int j = blockIdx.x * cb + col;
  float acc = 0.f;
  if (j < n3c)
    for (int q = r; q < parts; q += rp) acc += part[(long long)q * n3c + j];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = rp / 2; h > 0; h /= 2) {
    if (r < h) red[threadIdx.x] += red[threadIdx.x + h * cb];
    __syncthreads();
  }
  if (r == 0 && j < n3c) dw[j] = __float2bfloat16_rn(red[col]);
}

}  // namespace

// dtype: 1 = bfloat16 (the only one this route takes); x, g, dx [n,t,s,c],
// w, dw [3,c], every pointer 16-byte aligned, c % 64 == 0; rows: R, the
// rows of a strip, nstrips = ceil(s / rows); part: f32 scratch of
// n*nstrips*3*c; cb: dw_finish's columns a block (a power of two <= 32),
// all from shift.py's strip_geometry().  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int ehgr_shift_bwd_strip(int dtype, const void* x, const void* g,
                                    const void* w, void* dx, void* part,
                                    void* dw, int n, int t, int s, int c,
                                    int rows, int nstrips, int cb,
                                    void* stream) {
  if (dtype != 1 || n < 1 || t < 1 || s < 1 || c < kChunk ||
      c % kChunk != 0 || rows < 1 || (long long)rows * nstrips < s ||
      (long long)rows * (nstrips - 1) >= s || cb < 1 || cb > 32 ||
      (cb & (cb - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)g | (uintptr_t)w | (uintptr_t)dx) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n * nstrips * (c / kChunk);
  shift_bwd_strip<<<blocks, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)g, (const bf16*)w, (bf16*)dx,
      (float*)part, t, s, c, rows, nstrips);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n3c = 3 * c;
  dw_finish<<<(n3c + cb - 1) / cb, kThreads, 0, st>>>(
      (const float*)part, (bf16*)dw, n * nstrips, n3c, cb);
  return (int)cudaGetLastError();
}
