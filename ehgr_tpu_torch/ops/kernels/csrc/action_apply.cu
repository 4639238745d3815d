// action_apply for Hopper (sm_90a): one gated A tile per output row strip,
// a cp.async ring over K and the product on wgmma.  CUDA C++ with a plain C
// interface loaded through ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces the TPU kernel action_apply of ehgr_tpu/ops/pallas/action_mega.py
// (_apply_kernel, pallas_call at :209) on the main path: bf16 with C % 64 ==
// 0, F % 8 == 0 and 16-byte aligned operands, which every ResNet-50 ACTION
// site meets (other shapes and fp32 take the FMA sweep of
// csrc/action_mega.cu):
//     out = (x_shift * (g1[row] + gch[n,t,:])) @ W_net          [N*T*S, F]
//     x_shift[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1]   (zero at clip edges)
// with the TPU kernel's rounding points: shift and gate in f32, one rounding
// of the gated tile to bf16, f32 accumulation, one rounding of out.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s dense bf16): it must
// read x once and write out once, 2 bytes an element, and does 2*F flops an
// element of x: F flops a byte of x against the card's ~295.  Bytes bound
// it at the 56^2 and 28^2 sites (F <= 256) and at (196, 1024, 256);
// operations at (196, 1024, 512) and (49, 2048, 512).
//
// Design:
//   * Rows are the flattened N*T*S rows.  A block owns a strip of BM rows
//     (one warpgroup of 128 threads per 64 rows) and BN = min(F rounded up
//     to 64, 256) columns, so each element of x is shifted and gated once
//     at F <= 256, twice at F = 512.  BM = 64 at BN = 64 (two blocks an
//     SM), else 128 (one).  Strips straddle frames: each row's own t
//     decides its taps (w0 only if t > 0, w2 only if t < T-1) and its own
//     n*T+t picks its gch row, so S = 49 and S = 196 waste no rows; a
//     ragged last strip is masked (zero rows in, no stores out).
//   * K runs in BK = 64-channel chunks (128 bytes: one 128-byte swizzle
//     row).  A ring brings each chunk's three x tiles (rows r - S, r, r + S
//     of [N*T*S, C]) and its [BK, BN] tile of W_net by cp.async, 16 bytes a
//     thread, zero-filled where a row, a tap or a column is masked; at
//     BN <= 128 also the chunk's three taps and the gch rows of the strip's
//     first four frames (a row in a later frame, S < 43, reads its gch from
//     global memory).  The loads of chunk k + 1 fly while chunk k's A tile
//     is built and chunk k - 1's product runs.
//   * The threads build the chunk's gated bf16 A tile from the staged x
//     tiles into the 128-byte-swizzled K-major layout that wgmma reads; then
//     fence.proxy.async, a barrier, and 4 x wgmma m64nBNk16 per warpgroup
//     with the accumulators in registers, waited a chunk later.
//   * Epilogue: accumulators to bf16 through shared memory, then 16-byte
//     coalesced stores; rows past N*T*S and columns past F are not stored.
//   * Deterministic: no atomics, every output one f32 sum in a fixed order.
//
// Shared memory (dynamic, raised with cudaFuncSetAttribute), at BN = 256,
// BM = 128:
//     x ring    2 stages x 3 tiles x 128 rows x 128 B = 96 KB
//     W ring    3 stages x 64 k-rows x 256 x 2 B      = 96 KB
//     A tiles   2 x 128 rows x 128 B                  = 32 KB
//   224 KB (+ up to 1008 B to align the base to 1024) of the 227 KB a block
//   may hold.  W has one stage more than x because wgmma k - 1 still reads
//   its W tile while the loads of chunk k + 1 start.  BN = 128, BM =
//   128: 176 KB + 1.75 KB of gates; BN = 64, BM = 64: 88 KB + 1.75 KB.
//   At BN = 256 the 128 accumulators a thread leave no registers to stage
//   the gates: the build reads taps and gch from global memory (L1/L2).
//
// Traps:
//   * W_net is [C, F] with F contiguous, so B is MN-major.  Its tile is kept
//     as 64-column atoms of 64 k-rows x 128 bytes, 128-byte swizzled (LBO =
//     the atom stride, SBO = 8 k-rows), and wgmma reads it through the
//     transpose bit (imm-trans-b = 1); the weight is never transposed.
//   * The A tile's stores apply the XOR swizzle the descriptor declares
//     (16-byte chunk c of row r at r*128 + ((c ^ (r % 8)) * 16)); every tile
//     base is 1024-byte aligned, so a descriptor advanced by 32 bytes a k16
//     step stays on the pattern.
//   * The first wgmma of a strip runs with scale-d = 0 instead of zeroed
//     accumulators: a non-wgmma write to them would serialize the wgmmas.
//   * One block per SM at BN >= 128: (49, 2048, 512) at 20 clips has 62
//     strips x 2 column blocks, 124 blocks for 132 SMs (chip_smoke.py
//     prints the grid of each site).

#include "action_common.cuh"

namespace {

constexpr int BK = 64;                 // channels of a chunk: 128 bytes
constexpr int kXStages = 2, kWStages = 3;
constexpr int kVecs = 4;               // A vectors a thread builds a chunk
constexpr int kFrames = 4;             // gch rows staged a chunk
constexpr int kGate = (3 + kFrames) * BK * 2;   // taps + gch of a chunk

// Byte offsets into the dynamic shared memory, every tile 1024-byte
// aligned.
template <int BN, int BM>
struct Smem {
  // the gates ride the ring at BN <= 128; at BN = 256 the accumulators
  // leave no registers for it and the build reads them from global memory
  static constexpr bool kStageGates = BN <= 128;
  static constexpr int kThreads = BM * 2;          // BM / 64 warpgroups
  static constexpr int kTile = BM * BK * 2;        // an x or A tile
  static constexpr int kWTile = BK * BN * 2;
  static constexpr int kX = 0;                               // x ring
  static constexpr int kW = kX + kXStages * 3 * kTile;       // W ring
  static constexpr int kA = kW + kWStages * kWTile;          // A tiles
  static constexpr int kG = kA + 2 * kTile;                  // gate ring
  static constexpr int kBytes = kG + (kStageGates ? kXStages * kGate : 0);
  static constexpr int kOutPitch = BN * 2 + 16;              // epilogue row
  static_assert(BM * BK / 8 == kVecs * kThreads, "4 A vectors a thread");
  static_assert(BM * kOutPitch <= kW, "the epilogue reuses the x ring");
};

template <int BN, int BM>
__global__ void __launch_bounds__(BM * 2, BM == 64 ? 2 : 1)
apply_strip_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wsh,
                   const bf16* __restrict__ g1, const bf16* __restrict__ gch,
                   const bf16* __restrict__ wn, bf16* __restrict__ out,
                   int M, int tlen, int S, int C, int F, int ncb) {
  using L = Smem<BN, BM>;
  constexpr int kThreads = L::kThreads, kTile = L::kTile;
  constexpr int kRowStep = kThreads / 8;       // rows between a thread's
  extern __shared__ uint8_t smem_raw[];        // A vectors
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = (blockIdx.x / ncb) * BM;        // column blocks of a strip
  const int f0 = (blockIdx.x % ncb) * BN;        // run next to each other
  const size_t slab = (size_t)S * C;             // one frame

  // This thread's A vectors: rows r8 + kRowStep*j, channels c8*8 .. c8*8+7
  // of each chunk.  It also brings their x with cp.async, so it reads back
  // only what it copied itself.
  const int c8 = tid % 8, r8 = tid / 8;
  // The strip's rows lie in frames nt0, nt0 + 1, ...; the gch rows of the
  // first kFrames of them come with each chunk into shared memory (every
  // site: S >= 49 puts a 128-row strip in at most 4 frames), a row in a
  // later frame reads its gch from global memory.
  // Row j of this thread is m0 + r8 + kRowStep*j.  Few registers: the
  // accumulators take BN/2 of them.
  const int nt0 = m0 / S, nframes = M / S;
  const bf16* xrow = x + (size_t)(m0 + r8) * C + c8 * 8;   // row 0, chunk 0
  const size_t xstep = (size_t)kRowStep * C;
  uint32_t flags = 0;              // bit j: row in; 4 + j: t > 0; 8 + j: t < T-1
  uint32_t frame = 0;              // byte j: row j's n*T+t - nt0 (< 128)
  uint32_t g1p[kVecs / 2] = {};    // bf16 pairs of the rows' g1
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int r = m0 + r8 + kRowStep * j;
    if (r < M) {
      const int nt = r / S, t = nt % tlen;
      flags |= 1u << j;
      if (t > 0) flags |= 16u << j;
      if (t + 1 < tlen) flags |= 256u << j;
      frame |= (uint32_t)(nt - nt0) << (8 * j);
      g1p[j / 2] |= (uint32_t)__bfloat16_as_ushort(g1[r]) << (16 * (j % 2));
    }
  }

  auto load_chunk = [&](int kc) {
    const int k0 = kc * BK;
    const uint32_t xs = sbase + L::kX + (kc % kXStages) * 3 * kTile;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t d = xs + (r8 + kRowStep * j) * 128 + c8 * 16;
      const bf16* p = xrow + j * xstep + k0;
      const bool in = flags >> j & 1u, prev = flags >> (4 + j) & 1u,
                 next = flags >> (8 + j) & 1u;
      cp_async16(d, prev ? p - slab : x, prev);           // tile 0: t - 1
      cp_async16(d + kTile, in ? p : x, in);              // tile 1: t
      cp_async16(d + 2 * kTile, next ? p + slab : x, next);  // tile 2: t + 1
    }
    const uint32_t ws = sbase + L::kW + (kc % kWStages) * L::kWTile;
    constexpr int kPerRow = BN / 8;              // 16-byte vectors a k-row
#pragma unroll
    for (int v = 0; v < BK * kPerRow / kThreads; ++v) {
      const int idx = tid + v * kThreads;
      const int k = idx / kPerRow, nc = idx % kPerRow;
      const int f = f0 + nc * 8;
      const bool in = f < F;                     // F % 8 == 0
      const uint32_t d = ws + (nc / 8) * (BK * 128) + k * 128 +
                         (((nc % 8) ^ (k % 8)) << 4);
      cp_async16(d, in ? wn + (size_t)(k0 + k) * F + f : wn, in);
    }
    // the chunk's three taps and the gch rows of frames nt0 .. nt0 + 3
    if constexpr (L::kStageGates) {
      const uint32_t gs = sbase + L::kG + (kc % kXStages) * kGate;
      if (tid < 3 * 8) {
        cp_async16(gs + tid * 16, wsh + (tid / 8) * C + k0 + (tid % 8) * 8,
                   true);
      } else if (tid < (3 + kFrames) * 8) {
        const int nt = nt0 + tid / 8 - 3;
        cp_async16(gs + tid * 16,
                   nt < nframes ? gch + (size_t)nt * C + k0 + (tid % 8) * 8
                                : gch, nt < nframes);
      }
    }
  };

  // the gated tile in f32 (TPU kernel's order: w1*x, + w0*x[t-1],
  // + w2*x[t+1], times g1 + gch), rounded once to bf16, stored swizzled
  auto build_a = [&](int kc) {
    const uint8_t* xs = smem + L::kX + (kc % kXStages) * 3 * kTile;
    uint8_t* as = smem + L::kA + (kc % 2) * kTile;
    const uint8_t* gs = smem + L::kG + (kc % kXStages) * kGate + c8 * 16;
    const int k0 = kc * BK + c8 * 8;
    uint4 tw0, tw1, tw2;
    if constexpr (L::kStageGates) {
      tw0 = *reinterpret_cast<const uint4*>(gs);
      tw1 = *reinterpret_cast<const uint4*>(gs + 128);
      tw2 = *reinterpret_cast<const uint4*>(gs + 256);
    } else {
      tw0 = ldg16(wsh + k0);
      tw1 = ldg16(wsh + C + k0);
      tw2 = ldg16(wsh + 2 * C + k0);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int row = r8 + kRowStep * j;
      const int o = row * 128 + c8 * 16;
      const uint32_t fr = frame >> (8 * j) & 255u;
      const uint4 rg = L::kStageGates && fr < kFrames
          ? *reinterpret_cast<const uint4*>(gs + (3 + fr) * 128)
          : ldg16(gch + (size_t)(nt0 + fr) * C + k0);
      const float g1r = __bfloat162float(__ushort_as_bfloat16(
          (unsigned short)(g1p[j / 2] >> (16 * (j % 2)))));
      const uint4 xp = *reinterpret_cast<const uint4*>(xs + o),
                  xc = *reinterpret_cast<const uint4*>(xs + kTile + o),
                  xn = *reinterpret_cast<const uint4*>(xs + 2 * kTile + o);
      uint4 res;
#pragma unroll
      for (int i = 0; i < 4; ++i) {      // one bf16 pair at a time
        const float2 c = bf2(word(xc, i)), pv = bf2(word(xp, i)),
                     nv = bf2(word(xn, i)), t0 = bf2(word(tw0, i)),
                     t1 = bf2(word(tw1, i)), t2 = bf2(word(tw2, i)),
                     g = bf2(word(rg, i));
        float v0 = t1.x * c.x, v1 = t1.y * c.y;
        v0 += t0.x * pv.x;
        v1 += t0.y * pv.y;
        v0 += t2.x * nv.x;
        v1 += t2.y * nv.y;
        v0 *= g1r + g.x;
        v1 *= g1r + g.y;
        word(res, i) = pack2(v0, v1);
      }
      *reinterpret_cast<uint4*>(as + row * 128 + ((c8 ^ (row % 8)) << 4)) =
          res;
    }
  };

  float acc[BN / 2];                   // the first wgmma sets them
  const int kt = C / BK;
  // one cp.async group a chunk (empty past the end), kXStages - 1 ahead
#pragma unroll
  for (int i = 0; i < kXStages - 1; ++i) {
    if (i < kt) load_chunk(i);
    cp_async_commit();
  }
  for (int kc = 0; kc < kt; ++kc) {
    cp_async_wait<kXStages - 2>();     // chunk kc is in shared memory
    fence_proxy_async();
    __syncthreads();                   // ... for every thread; the slots the
                                       // next load takes are spent
    if (kc + kXStages - 1 < kt) load_chunk(kc + kXStages - 1);
    cp_async_commit();
    build_a(kc);
    fence_proxy_async();
    __syncthreads();                   // A tile kc complete
    const uint32_t a_rows = sbase + L::kA + (kc % 2) * kTile +
                            (warp / 4) * 64 * 128;
    const uint32_t w_tile = sbase + L::kW + (kc % kWStages) * L::kWTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<BN>(acc, desc_sw128(a_rows + kk * 32, 16, 1024),
                     desc_sw128(w_tile + kk * 16 * 128, BK * 128, 1024),
                     kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                   // wgmma kc - 1 is done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  __syncthreads();

  // epilogue: bf16 pairs into the spent x ring, then 16-byte stores
  uint8_t* stage = smem + L::kX;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (row + 8 * i) * L::kOutPitch + (n8 * 8 + 2 * (lane % 4)) * 2) =
          __floats2bfloat162_rn(acc[n8 * 4 + 2 * i], acc[n8 * 4 + 2 * i + 1]);
  __syncthreads();
  constexpr int kPerRow = BN / 8;
  for (int v = tid; v < BM * kPerRow; v += kThreads) {
    const int rr = v / kPerRow, cv = v % kPerRow;
    const int r = m0 + rr, f = f0 + cv * 8;
    if (r < M && f < F)
      *reinterpret_cast<uint4*>(out + (size_t)r * F + f) =
          *reinterpret_cast<const uint4*>(stage + rr * L::kOutPitch +
                                          cv * 16);
  }
}

template <int BN, int BM>
int launch(const void* x, const void* w, const void* g1, const void* gch,
           const void* wn, void* out, int n, int t, int s, int c, int f,
           cudaStream_t stream) {
  using L = Smem<BN, BM>;
  // + room to align a 16-byte aligned base to 1024 bytes
  const int bytes = L::kBytes + 1024 - 16;
  auto kernel = apply_strip_kernel<BN, BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int m = n * t * s, ncb = (f + BN - 1) / BN;
  const int blocks = (m + BM - 1) / BM * ncb;
  kernel<<<blocks, L::kThreads, bytes, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)g1, (const bf16*)gch,
      (const bf16*)wn, (bf16*)out, m, t, s, c, f, ncb);
  return (int)cudaGetLastError();
}

// The launch geometry: BN = F rounded up to 64, at most 256; 64-row strips
// (two blocks an SM) at BN = 64, else 128-row strips.
void geometry(int f, int* bn, int* bm) {
  *bn = f <= 64 ? 64 : f <= 128 ? 128 : 256;
  *bm = *bn == 64 ? 64 : 128;
}

int apply_entry(const void* x, const void* w, const void* g1,
                const void* gch, const void* wn, void* out, int n, int t,
                int s, int c, int f, cudaStream_t st) {
  int bn, bm;
  geometry(f, &bn, &bm);
  if (bn == 64) return launch<64, 64>(x, w, g1, gch, wn, out, n, t, s, c, f, st);
  if (bn == 128)
    return launch<128, 128>(x, w, g1, gch, wn, out, n, t, s, c, f, st);
  return launch<256, 128>(x, w, g1, gch, wn, out, n, t, s, c, f, st);
}

}  // namespace

// dtype 1 (bf16) only.  x [n*t*s, c], w [3, c], g1 [n*t*s], gch [n*t, c],
// wn [c, f], out [n*t*s, f]: contiguous device tensors; c % 64 == 0,
// f % 8 == 0 and x, w, gch, wn, out 16-byte aligned, else
// cudaErrorInvalidValue.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int ehgr_action_apply_strip(int dtype, const void* x,
                                       const void* w, const void* g1,
                                       const void* gch, const void* wn,
                                       void* out, int n, int t, int s, int c,
                                       int f, void* stream) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)w | (uintptr_t)gch |
                      (uintptr_t)wn | (uintptr_t)out;
  if (dtype != 1 || c % BK != 0 || f % 8 != 0 || a % 16 != 0 ||
      n * t * s <= 0 || f <= 0)
    return (int)cudaErrorInvalidValue;
  return apply_entry(x, w, g1, gch, wn, out, n, t, s, c, f,
                     (cudaStream_t)stream);
}

// The grid ehgr_action_apply_strip launches for rows x f: grid[0] row
// strips, grid[1] column blocks, grid[2] BN, grid[3] BM.
extern "C" int ehgr_action_apply_strip_grid(int rows, int f, int* grid) {
  geometry(f, &grid[2], &grid[3]);
  grid[0] = (rows + grid[3] - 1) / grid[3];
  grid[1] = (f + grid[2] - 1) / grid[2];
  return 0;
}
