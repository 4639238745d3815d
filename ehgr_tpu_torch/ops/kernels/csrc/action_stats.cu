// action_stats and action_prologue for Hopper (sm_90a): one sweep over x
// with a window over T, a cp.async ring over K and the product on the
// tensor cores.  CUDA C++ with a plain C interface loaded through ctypes
// (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces, on the main path (bf16 with C % 64 == 0, Cr % 4 == 0, Cr <= 128
// and 16-byte aligned operands, which every ResNet-50 ACTION site meets;
// fp32 and other shapes keep the FMA sweep of csrc/action_mega.cu):
//   action_stats     ehgr_tpu/ops/pallas/action_mega.py:126 (pallas_call
//                    at :142): x [N,T,S,C], w [3,C], W_p3 [C,Cr] ->
//                    mc [N,T,S] (channel mean of x_shift), pool [N,T,C]
//                    (spatial mean), x3 = x_shift @ W_p3 [N,T,S,Cr];
//   action_prologue  ehgr_tpu/ops/pallas/action_fused.py:60 (pallas_call at
//                    :75): the same outputs plus x_shift [N,T,S,C] (XS).
//     x_shift[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1]   (zero at clip edges)
// with the rounding points of the earlier sweep: the shift in f32 (the TPU
// kernel's order: w1*x, + w0*x[t-1], + w2*x[t+1]), mc and pool summed in
// f32, the A tile rounded once to bf16 (the prologue stores that same
// tile), x3 accumulated in f32 and rounded once.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s dense bf16): it must
// read x once and write mc, pool and x3 (and x_shift) once; it does 2*Cr
// flops an element of x, at most 128 flops a byte at Cr = 128 against the
// card's ~295, so bytes bound it at every site.
//
// Design:
//   * A block owns a strip of BM = 64 spatial rows s0 .. s0+63 of one clip
//     n and a group of TG consecutive frames t0 .. t0+TG-1.  Strips stay in
//     one clip: the kernel is bound by bytes and a masked row costs none
//     (it is zero-filled, not read), and one-clip strips give at least as
//     many blocks as strips that straddle clips (20 clips: 980 / 260 / 80
//     / 20 strips at 56^2 / 28^2 / 14^2 / 7^2, against 980 / 245 / 62 /
//     16).
//   * K runs in 64-channel chunks (128 bytes: one 128-byte swizzle row).
//     A ring brings each chunk's TG + 2 frame tiles (t0-1 .. t0+TG; frames
//     outside the clip are zero-filled, not read) by cp.async, 8 lanes to
//     a row's 128 bytes.  So x is read (TG+2)/TG times from L2 but about
//     once from memory: the halo frames are the neighbouring frame
//     group's, whose block runs next to this one (T = 8: 1.25 reads at
//     TG = 4, 1.75 at 2, 2.75 at 1).
//   * 256 threads and at most ~113 KB of shared memory a block (a
//     two-stage ring), so two blocks share an SM and one's loads overlap
//     the other's build (at 7^2, with 160 blocks, this beat one block an
//     SM with a four-stage ring).  The host picks TG per site: the largest
//     of 4 / 2 / 1 under a cap (4 at Cr <= 16, 2 at Cr <= 64, 1 above:
//     registers, as measured in PERF.md) that still gives two blocks an
//     SM.
//   * The build: warp w owns channels 8w .. 8w+7 of the chunk, lane l the
//     rows l and l + 32, and walks its two vectors through the TG frames:
//     x[t-1], x[t], x[t+1] in registers as f32 (each vector converted
//     once, the taps once a chunk), the f32 shift, one rounding to bf16,
//     stored in place over x[t-1] (no thread reads that vector
//     again), which leaves the A tile of frame t0+i in slot i, in the
//     128-byte-swizzled K-major layout the product reads.  The same pass
//     sums the f32 values: per frame its 8 channels over the warp's 64
//     rows (pool: 9 shuffles reduce and scatter them over the lanes, so a
//     column's sum never leaves its warp), and its rows' 8-channel sums
//     (mc), which meet across the 8 warps once, at the end.
//   * The product: N = Cr rounded up to 16 / 32 / 64 / 128 (zero
//     columns), so a thread holds no more accumulators than Cr needs.
//     ResNet-50's largest Cr is 2048 / 16 = 128; a larger Cr takes the
//     FMA sweep.
//     W_p3 [C, Cr] keeps Cr contiguous: its chunk rides the ring as
//     64-column atoms (16-byte copies; 8-byte ones at Cr = 4, whose rows
//     are 8 bytes).  A warpgroup multiplies the A tiles of TG/2 frames (at
//     TG = 1 and N = 128: half the columns of the one frame) by it with
//     4 x wgmma m64nNk16 a chunk, B read MN-major through the transpose
//     bit (as in csrc/action_apply.cu), the accumulators in registers; the
//     product of chunk k runs while the sums of chunk k are written and
//     the loads of chunk k + 1 land.
//   * pool in a fixed order, with no atomics: one f32 row of partials
//     [N*T*strips, C] per strip and frame; pool_reduce
//     (csrc/action_common.cuh) sums the strips in order and divides by S.
//     Two calls on the same input agree bitwise in every output.
//   * The prologue stores x_shift from the finished A tiles, 8 lanes to a
//     row's 128 bytes.
//   * Epilogue: x3 from the accumulators, mc from the row sums; rows past
//     S and frames past T are not stored.

#include "action_common.cuh"

namespace {

constexpr int BM = 64;                  // spatial rows of a strip
static_assert(BM == kPoolStrip, "one row of pool partials a strip");
constexpr int BK = 64;                  // channels of a chunk: 128 bytes
constexpr int kTile = BM * BK * 2;      // an x or A tile, 8 KB
constexpr int kThreads = 256;           // two warpgroups
constexpr int kStages = 2;              // ring stages (fewer if C < 128)
constexpr int kSmemSM = 233472;         // shared memory of an SM
constexpr int kSMs = 132;
constexpr int kMinBlocks = 2 * kSMs;    // two blocks an SM
// the (TG, N) the kernel is built for: every TG under the cap of its N
#define EHGR_STATS_SHAPES(X)                                               \
  X(4, 16) X(2, 16) X(1, 16) X(2, 32) X(1, 32) X(2, 64) X(1, 64) X(1, 128)

// One ring stage (every tile 1024-byte aligned): the TG + 2 frame tiles and
// the W_p3 tile, MN-major as W_p3 lies in memory: 64-column atoms of 64
// k-rows x 128 bytes, 128-byte swizzled; columns Cr .. stay zero.
template <int TG, int N>
struct Cfg {
  // warpgroup g multiplies frames g*kFPW .. g*kFPW + kFPW-1 by all N
  // columns; at TG = 1 and N = 128 both take frame 0, warpgroup g the
  // columns g*N/2 .. (whole 64-column atoms of the W_p3 tile); at TG = 1
  // and N <= 64 warpgroup 1 has no frame
  static constexpr bool kSplit = TG == 1 && N == 128;
  static constexpr int kFPW = TG >= 2 ? TG / 2 : 1;
  static constexpr int kNW = kSplit ? N / 2 : N;   // columns a warpgroup
  static constexpr int kWTile = BK * (N < 64 ? 64 : N) * 2;
  static constexpr int kW = (TG + 2) * kTile;
  static constexpr int kStage = kW + kWTile;
  static constexpr int bytes(int stages) {
    return stages * kStage + 1024 - 16;          // + room to align to 1024
  }
  static_assert(TG == 1 || TG == 2 || TG == 4, "TG is 1, 2 or 4");
  static_assert(kFPW * kNW / 2 <= 64, "at most 64 accumulators a thread");
  static_assert(8 * TG * BM * 4 <= kStage, "the mc sums fit in a stage");
};

// byte offset of element (row r, channel k) of an A tile: 128-byte rows,
// the 16-byte chunks of row r XOR-swizzled by r % 8
__device__ __forceinline__ int kmajor(int r, int k) {
  return r * 128 + (((k / 8) ^ (r % 8)) << 4) + (k % 8) * 2;
}
// byte offset of element (k, col) of the W_p3 tile: 64-column atoms of 64
// k-rows x 128 bytes, the 16-byte chunks of row k XOR-swizzled by k % 8
__device__ __forceinline__ int w_offset(int k, int col) {
  return (col / 64) * (BK * 128) + kmajor(k, col % 64);
}
template <int TG, int N, bool XS>
__global__ void __launch_bounds__(kThreads, 2)
stats_window_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wsh,
                    const bf16* __restrict__ wp3, bf16* __restrict__ xs_out,
                    bf16* __restrict__ mc, float* __restrict__ part,
                    bf16* __restrict__ x3, int tlen, int S, int C, int Cr,
                    int nst, int ngroups, int stages) {
  using L = Cfg<TG, N>;
  constexpr int kFPW = L::kFPW, kNW = L::kNW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the frame group runs fastest: blocks that share halo frames run
  // together
  const int g = blockIdx.x % ngroups;
  const int strip = blockIdx.x / ngroups % nst;
  const int n = blockIdx.x / (ngroups * nst);
  const int t0 = g * TG, s0 = strip * BM;
  const size_t slab = (size_t)S * C;                // one frame
  const int kt = C / BK;

  // copies: 8 lanes a row (128 contiguous bytes), rows lr and lr + 32
  const int lc = tid % 8, lr = tid / 8;
  const bool cin[2] = {s0 + lr < S, s0 + lr + 32 < S};
  const bf16* xrow = x + (size_t)n * tlen * slab + (size_t)(s0 + lr) * C +
                     lc * 8;
  // the build: warp w owns channels 8w .. 8w+7 of a chunk and the lane
  // rows lane and lane + 32, so a column's pool sum meets in one warp
  const int c8 = warp;
  const int bo = lane * 128 + ((c8 ^ (lane % 8)) << 4);  // + 32*128: h = 1

  // the padding columns of the W_p3 tiles stay zero: the ring writes only
  // columns < Cr
  for (int i = tid; i < stages * L::kWTile / 16; i += kThreads) {
    const int st = i / (L::kWTile / 16), v = i % (L::kWTile / 16);
    *reinterpret_cast<uint4*>(smem + st * L::kStage + L::kW + v * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // the W_p3 copies: vectors of vw columns, per_row a row; where per_row
  // divides the block, thread tid copies column wcol of rows wk + wstep*i
  const int vw = Cr % 8 == 0 ? 8 : 4, per_row = Cr / vw;
  const bool wfix = kThreads % per_row == 0;
  const int wk = tid / per_row, wcol = tid % per_row * vw,
            wstep = kThreads / per_row;
  auto load_chunk = [&](int kc) {
    const int k0 = kc * BK;
    const uint32_t st = sbase + (kc % stages) * L::kStage;
#pragma unroll 1
    for (int f = 0; f < TG + 2; ++f) {               // frame t0 - 1 + f
      const int tf = t0 - 1 + f;
      const bool fin = tf >= 0 && tf < tlen;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lr + 32 * h;
        const bool in = fin && cin[h];
        cp_async16(st + f * kTile + row * 128 + ((lc ^ (row % 8)) << 4),
                   in ? xrow + (size_t)tf * slab + (size_t)(32 * h) * C + k0
                      : x, in);
      }
    }
    // W_p3 rows k0 .. k0+63: 16 bytes a copy, 8 at Cr % 8 != 0
    const uint32_t ws = st + L::kW;
    if (wfix) {                  // this thread's column is the same each row
      for (int k = wk; k < BK; k += wstep) {
        const bf16* src = wp3 + (size_t)(k0 + k) * Cr + wcol;
        if (vw == 8) cp_async16(ws + w_offset(k, wcol), src, true);
        else cp_async8(ws + w_offset(k, wcol), src, true);
      }
    } else {
      for (int i = tid; i < BK * per_row; i += kThreads) {
        const int k = i / per_row, col = i % per_row * vw;
        const bf16* src = wp3 + (size_t)(k0 + k) * Cr + col;
        if (vw == 8) cp_async16(ws + w_offset(k, col), src, true);
        else cp_async8(ws + w_offset(k, col), src, true);
      }
    }
  };

  // pool: frame f's 8 column sums over the warp's 64 rows, reduced and
  // scattered over the lanes (9 shuffles): lane l ends with channel
  // 4*b4 + 2*b3 + b2 of its bits, and one of each 4 lanes writes it
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  auto pool_write = [&](int kc, int f, const float* col) {
    float a4[4], a2[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a4[i] = (h16 ? col[i + 4] : col[i]) +
              __shfl_xor_sync(0xffffffffu, h16 ? col[i] : col[i + 4], 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a2[i] = (h8 ? a4[i + 2] : a4[i]) +
              __shfl_xor_sync(0xffffffffu, h8 ? a4[i] : a4[i + 2], 8);
    float a1 = (h4 ? a2[1] : a2[0]) +
               __shfl_xor_sync(0xffffffffu, h4 ? a2[0] : a2[1], 4);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
    if (lane % 4 == 0 && t0 + f < tlen)
      part[(((size_t)n * tlen + t0 + f) * nst + strip) * C + kc * BK +
           c8 * 8 + 4 * h16 + 2 * h8 + h4] = a1;
  };
  // TG = 4 reduces each frame as it is built (registers); fewer frames
  // reduce after the barrier, their chains interleaved, while the product
  // runs
  constexpr bool kPoolEarly = TG >= 4;

  float acc[kFPW][kNW / 2];             // a frame's first wgmma sets them
  float msum[2][TG];                   // this thread's 8-channel row sums
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int f = 0; f < TG; ++f) msum[h][f] = 0.f;
  // the taps of this warp's channels, a chunk ahead
  const int kt0 = c8 * 8;
  uint4 tn0 = ldg16(wsh + kt0), tn1 = ldg16(wsh + C + kt0),
        tn2 = ldg16(wsh + 2 * C + kt0);

  // one cp.async group a chunk (empty past the end), stages - 1 ahead
  for (int i = 0; i < stages - 1; ++i) {
    if (i < kt) load_chunk(i);
    cp_async_commit();
  }
  const int wg = warp / 4, q = warp % 4;
  for (int kc = 0; kc < kt; ++kc) {
    wgmma_wait<0>();                   // product kc - 1 is done ...
    __syncthreads();                   // ... in both warpgroups: its slot is
                                       // spent
    if (kc + stages - 1 < kt) load_chunk(kc + stages - 1);
    cp_async_commit();
    const uint4 tw0 = tn0, tw1 = tn1, tw2 = tn2;
    if (kc + 1 < kt) {
      const int k1 = (kc + 1) * BK + c8 * 8;
      tn0 = ldg16(wsh + k1);
      tn1 = ldg16(wsh + C + k1);
      tn2 = ldg16(wsh + 2 * C + k1);
    }
    if (stages > 1) cp_async_wait<1>();  // chunk kc is in shared memory
    else cp_async_wait<0>();
    __syncthreads();                   // ... for every thread

    // build: the A tiles of the TG frames in place, and the sums
    uint8_t* stg = smem + (kc % stages) * L::kStage;
    // the window in f32: each x vector is converted once, the taps once a
    // chunk
    float pf[2][8], cf[2][8], a0[8], a1[8], a2[8];
    unpack8(tw0, a0);
    unpack8(tw1, a1);
    unpack8(tw2, a2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unpack8(*reinterpret_cast<const uint4*>(stg + bo + h * 32 * 128),
              pf[h]);
      unpack8(*reinterpret_cast<const uint4*>(stg + kTile + bo +
                                              h * 32 * 128), cf[h]);
    }
    float col[TG][8];                  // per frame: its channels' sums
#pragma unroll
    for (int f = 0; f < TG; ++f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) col[f][i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = bo + h * 32 * 128;
        float nf[8], v[8];
        unpack8(*reinterpret_cast<const uint4*>(stg + (f + 2) * kTile + o),
                nf);
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = a1[i] * cf[h][i];
          v[i] += a0[i] * pf[h][i];
          v[i] += a2[i] * nf[i];
          rs += v[i];
          col[f][i] += v[i];
          pf[h][i] = cf[h][i];
          cf[h][i] = nf[i];
        }
        *reinterpret_cast<uint4*>(stg + f * kTile + o) = pack8(v);  // t-1
        msum[h][f] += rs;
      }
      if constexpr (kPoolEarly) pool_write(kc, f, col[f]);
    }
    fence_proxy_async();
    __syncthreads();                   // A tiles complete

    // the product: each warpgroup's frames (64 rows each) by the W_p3
    // tile, 4 x wgmma m64nNk16, B MN-major through the transpose bit
    const uint32_t stage_u = sbase + (kc % stages) * L::kStage;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kFPW; ++i) {
      // no branch around wgmma (it would serialize them): a frame past T
      // is multiplied and not stored, and at TG = 1, N <= 64 warpgroup 1
      // repeats frame 0's product and stores nothing
      const int f = L::kSplit || wg * kFPW + i >= TG ? 0 : wg * kFPW + i;
      const uint32_t at = stage_u + f * kTile;
      const uint32_t wt = stage_u + L::kW + (L::kSplit ? wg * kNW / 64 : 0) *
                                                (BK * 128);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<kNW>(acc[i], desc_sw128(at + kk * 32, 16, 1024),
                        desc_sw128(wt + kk * 16 * 128, BK * 128, 1024),
                        kc > 0 || kk > 0);
    }
    wgmma_commit();

    if constexpr (!kPoolEarly) {       // while the product runs
#pragma unroll
      for (int f = 0; f < TG; ++f) pool_write(kc, f, col[f]);
    }

    if (XS) {                          // x_shift: the A tiles, coalesced
#pragma unroll
      for (int f = 0; f < TG; ++f) {
        if (t0 + f >= tlen) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = lr + 32 * h;
          if (cin[h])
            *reinterpret_cast<uint4*>(
                xs_out + ((size_t)n * tlen + t0 + f) * slab +
                (size_t)(s0 + row) * C + kc * BK + lc * 8) =
                *reinterpret_cast<const uint4*>(
                    stg + f * kTile + row * 128 + ((lc ^ (row % 8)) << 4));
        }
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kFPW; ++i)
#pragma unroll
    for (int j = 0; j < kNW / 2; ++j) fence_operand(acc[i][j]);

  // x3: accumulator d[n8*4 + 2h + e] is row 16q + lane/4 + 8h, column
  // n8*8 + 2*(lane%4) + e of the warpgroup's frame and columns (q: the
  // warp in its warpgroup)
#pragma unroll
  for (int i = 0; i < kFPW; ++i) {
    const int f = L::kSplit ? 0 : wg * kFPW + i;
    const int t = t0 + f, nb = L::kSplit ? wg * kNW : 0;
    if (f >= TG || t >= tlen) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + q * 16 + lane / 4 + 8 * h;
      if (s >= S) continue;
      bf16* orow = x3 + (((size_t)n * tlen + t) * S + s) * Cr;
#pragma unroll
      for (int n8 = 0; n8 < kNW / 8; ++n8) {
        const int c = nb + n8 * 8 + 2 * (lane % 4);
        if (c < Cr)                    // Cr % 4 == 0: c + 1 < Cr too
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[i][n8 * 4 + 2 * h],
                                    acc[i][n8 * 4 + 2 * h + 1]);
      }
    }
  }

  // mc: the 8 warps' row sums meet in the spent ring, summed in warp order
  __syncthreads();
  float* mred = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < TG; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mred[(warp * TG + f) * BM + lane + 32 * h] = msum[h][f];
  __syncthreads();
  if (tid < TG * BM) {
    const int f = tid / BM, row = tid % BM;
    if (t0 + f < tlen && s0 + row < S) {
      float r = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w)
        r += mred[(w * TG + f) * BM + row];
      mc[((size_t)n * tlen + t0 + f) * S + s0 + row] =
          __float2bfloat16(r / (float)C);
    }
  }
}

// The launch geometry of a call.
struct Geo {
  int blocks, tg, nn, nst, groups, threads, stages, smem;
};

template <int TG, int N>
void fill(int kt, Geo* g) {
  static_assert(Cfg<TG, N>::bytes(kStages) + 1024 <= kSmemSM / 2,
                "two blocks an SM (the SM keeps 1 KB a block)");
  g->threads = kThreads;
  g->stages = kt < kStages ? kt : kStages;
  g->smem = Cfg<TG, N>::bytes(g->stages);
}

// N = Cr rounded up to 16 / 32 / 64 / 128; TG the largest of 4 / 2
// / 1 under the cap (4 at N = 16, 2 at 32 and 64, 1 above) that gives at
// least kMinBlocks blocks, and no larger than T needs.
void geometry(int n, int t, int s, int c, int cr, Geo* g) {
  g->nn = cr <= 16 ? 16 : cr <= 32 ? 32 : cr <= 64 ? 64 : 128;
  g->nst = pool_strips(s);
  const long long strips = (long long)n * g->nst;
  int tg = g->nn == 16 ? 4 : g->nn <= 64 ? 2 : 1;
  while (tg > 1 && (tg >= 2 * t ||
                    strips * ((t + tg - 1) / tg) < kMinBlocks))
    tg /= 2;
  g->tg = tg;
  g->groups = (t + tg - 1) / tg;
  g->blocks = (int)(strips * g->groups);
  const int kt = c / BK;
#define EHGR_FILL(TG_, N_) \
  if (tg == TG_ && g->nn == N_) fill<TG_, N_>(kt, g);
  EHGR_STATS_SHAPES(EHGR_FILL)
#undef EHGR_FILL
}

template <int TG, int N, bool XS>
int launch(const Geo& g, const void* x, const void* w, const void* wp3,
           void* xs, void* mc, void* part, void* x3, int t, int s, int c,
           int cr, cudaStream_t stream) {
  auto kernel = stats_window_kernel<TG, N, XS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.blocks, g.threads, g.smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)wp3, (bf16*)xs,
      (bf16*)mc, (float*)part, (bf16*)x3, t, s, c, cr, g.nst, g.groups,
      g.stages);
  return (int)cudaGetLastError();
}

template <bool XS>
int window_entry(int dtype, const void* x, const void* w, const void* wp3,
                 void* xs, void* mc, void* pool, void* x3, void* part, int n,
                 int t, int s, int c, int cr, cudaStream_t stream) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)w | (uintptr_t)wp3 |
                      (uintptr_t)(XS ? xs : x);
  if (dtype != 1 || c % BK != 0 || cr % 4 != 0 || cr <= 0 || cr > 128 ||
      a % 16 != 0 || n <= 0 || t <= 0 || s <= 0)
    return (int)cudaErrorInvalidValue;
  Geo g;
  geometry(n, t, s, c, cr, &g);
  int e = (int)cudaErrorInvalidValue;
#define EHGR_LAUNCH(TG_, N_)                                               \
  if (g.tg == TG_ && g.nn == N_)                                           \
    e = launch<TG_, N_, XS>(g, x, w, wp3, xs, mc, part, x3, t, s, c, cr,  \
                            stream);
  EHGR_STATS_SHAPES(EHGR_LAUNCH)
#undef EHGR_LAUNCH
  if (e != 0) return e;
  return launch_pool_reduce<bf16>((const float*)part, pool, n * t, c, s,
                                  stream);
}

}  // namespace

// dtype 1 (bf16) only.  x [n,t,s,c], w [3,c], wp3 [c,cr], mc [n,t,s],
// pool [n,t,c], x3 [n,t,s,cr]: contiguous device tensors; part: f32
// scratch of ehgr_action_pool_scratch_rows(n, t, s) x c.  c % 64 == 0,
// cr % 4 == 0, cr <= 128 and x, w, wp3 16-byte aligned, else
// cudaErrorInvalidValue.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int ehgr_action_stats_window(int dtype, const void* x,
                                        const void* w, const void* wp3,
                                        void* mc, void* pool, void* x3,
                                        void* part, int n, int t, int s,
                                        int c, int cr, void* stream) {
  return window_entry<false>(dtype, x, w, wp3, nullptr, mc, pool, x3, part,
                             n, t, s, c, cr, (cudaStream_t)stream);
}

// action_stats' outputs plus x_shift [n,t,s,c] in xs (16-byte aligned).
extern "C" int ehgr_action_prologue_window(int dtype, const void* x,
                                           const void* w, const void* wp3,
                                           void* xs, void* mc, void* pool,
                                           void* x3, void* part, int n,
                                           int t, int s, int c, int cr,
                                           void* stream) {
  return window_entry<true>(dtype, x, w, wp3, xs, mc, pool, x3, part, n, t,
                            s, c, cr, (cudaStream_t)stream);
}

// The launch the two entry points pick for these sizes, into grid[8]:
// blocks, TG, N, strips of a clip, frame groups, threads a block, ring
// stages, dynamic shared memory bytes.
extern "C" int ehgr_action_stats_window_grid(int n, int t, int s, int c,
                                             int cr, int* grid) {
  Geo g;
  geometry(n, t, s, c, cr, &g);
  const int v[8] = {g.blocks, g.tg, g.nn, g.nst, g.groups, g.threads,
                    g.stages, g.smem};
  for (int i = 0; i < 8; ++i) grid[i] = v[i];
  return 0;
}

// Rows of the f32 pool partials (part) that the two entry points write for
// x [n,t,s,*].
extern "C" int ehgr_action_pool_scratch_rows(int n, int t, int s) {
  return pool_scratch_rows(n, t, s);
}
