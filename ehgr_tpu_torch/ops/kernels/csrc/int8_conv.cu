// int8 convolution for Hopper (sm_90a) with the activation quantize fused
// into its A-tile load: CUDA C++ with a plain C interface loaded through
// ctypes (ehgr_tpu_torch/ops/kernels/build.py).
//
// Replaces no TPU kernel: the JAX package computes its int8 convolution
// outside Pallas, as XLA's lax.conv_general_dilated(xq, wq, ...,
// preferred_element_type=int32) on codes that XLA quantizes inside the
// producer's fusion (ehgr_tpu/ops/quantize.py:63-65, :117-125), and
// PyTorch has no int8 convolution on CUDA (torch._int_mm covers a 1x1
// stride-1 site only, and takes codes).  It computes, in one launch,
//   code[m, k] = clamp(rint(x[m, k] / xs), -127, 127)   (IEEE quotient,
//                rint half to even, zero outside the image)
//   out[m, c]  = dtype( float(sum_k code[m, k] * wq[c, k]) * (xs * ws[c]) )
// with the sum in int32, on
//   x   bf16 or f32 [N, H, W, Cin]  (the model's channels_last activation),
//   xs  f32 scalar on the device (read through its pointer: the
//       calibrated or dynamic scale never comes back to the host),
//   wq  int8 [Cout, KH, KW, Cin]  (K = KH*KW*Cin contiguous),
//   ws  f32 [Cout],
//   out x's dtype [N, Ho, Wo, Cout],
// where row m = (n, oh, ow) gathers the input pixel (oh*stride - pad + kh,
// ow*stride - pad + kw) for each tap.  Every rounding is the JAX package's
// (and int8_conv_plain's, ops/kernels/int8_conv.py): the f32 quotient,
// rint, the exact int32 sum, one int -> f32 rounding, one f32 multiply by
// the f32 product xs * ws[c], one rounding to dtype; so the two agree
// bitwise.
//
// What bounds it on the H100 (3.35 TB/s, 1,979 dense int8 TOPS): bytes at
// the 1x1 sites and the 3x3 ones with 64 and 128 channels (2 bytes an input
// element the conv reads and 2 an output element, against Cin or 9 Cin
// multiply-adds), operations at the 3x3 sites with 256 and 512 channels
// (1.254 ms for the 36 sites of a 20-clip forward).  Inside the kernel
// what bounds it is the A path: every A element is read, divided, rounded
// and packed once for each tap and each N tile that reads it (~3.1e9 a
// 20-clip forward, ~10 instructions each on the SMs' issue slots; at a 3x3
// site x crosses L2 -> SM nine times), and at the 1x1 sites the block's
// load, build, product and epilogue run one after another.
//
// Design:
//   * A block of BM / 64 warpgroups (BM = 64 or 128) computes a BM x BN
//     tile of out (rows x output channels), each warpgroup 64 rows, with
//     wgmma.mma_async m64nBNk32 s32.s8.s8 from two 128-byte-swizzled K-major
//     shared tiles (for 8-bit types wgmma reads both operands K-major only,
//     which is how both already lie: A rows of (kh, kw, Cin), wq's rows of
//     K).  BN = 64 / 128 / 256 from Cout (f32 input at most 128, for
//     shared memory); blocks walk the N tiles fastest, so the blocks that
//     read one activation tile run together and it comes from L2 after its
//     first read.  pick_tile chooses the tile.
//   * K moves 128 codes (one 128-byte swizzle row) a chunk.  A ring of XS
//     chunks brings the float activation by cp.async, 16-byte pieces, the 8
//     threads of a row on 128 contiguous bytes (whole 32-byte sectors):
//     Cin % 16 == 0, so a piece lies in one tap; padding, rows past M and K
//     past its end are not read at all (a mask per stage says so, and the
//     build writes zeros).  Each thread converts only the pieces it copied,
//     so the x ring needs no barrier of its own; it walks its pieces' taps
//     by addition, with no division in the loop.
//   * The quantize runs in registers: q = x * (1 / xs) with the reciprocal
//     rounded once a block; clamp to +-127; rint by adding 1.5 * 2^23 (the
//     low byte of the sum's bits is the int8 code).  |q - x / xs| < 1.5 *
//     2^-16 for |q| <= 127, so a code can differ from the IEEE quotient's
//     only where q lies that close to a half-integer: an element within
//     2^-14 of one takes __fdiv_rn (about one in 8,192).
//   * The weight tile comes by cp.async into a 3-stage ring, one chunk
//     ahead: wgmma kc - 1 may still read its slot while chunk kc + 1 loads.
//     The codes of chunk kc go into one of two A tiles, then
//     fence.proxy.async, a barrier and the wgmmas of chunk kc, waited a
//     chunk later, so the tensor cores run while the next chunk is built.
//     Where K is one chunk (the 1x1 sites with Cin <= 128) the block holds
//     64 rows and one stage of each (XS = 1), and three or more blocks
//     share an SM.
//   * Epilogue: acc -> f32 (round to nearest) times xs * ws[c] (staged in
//     shared memory), rounded to dtype into the spent rings, then 16-byte
//     stores along Cout, whole rows of the tile at a time.
//   * Everything launches on the caller's stream and allocates nothing.
//
// Shared memory (dynamic, raised with cudaFuncSetAttribute), bf16 at BN =
// 256, BM = 128, XS = 3:
//     x ring   3 stages x 128 rows x 128 x 2 B = 96 KB
//     W ring   3 stages x 256 rows x 128 B     = 96 KB
//     A tiles  2 x 128 rows x 128 B            = 32 KB
//     scales   256 x 4 B                       =  1 KB
//   225 KB (+ up to 1008 B to align the base to 1024) of the 227 KB a block
//   may hold: one block an SM; BN = 64, BM = 64, XS = 2: 72 KB, three
//   blocks an SM; one chunk (XS = 1, BM = 64) at BN = 256: 57 KB, three.
//
// Traps:
//   * The A and W tiles' stores apply the XOR swizzle the descriptors
//     declare (16-byte chunk c of row r at r*128 + ((c ^ (r % 8)) * 16));
//     every tile base is 1024-byte aligned, so a descriptor advanced by 32
//     bytes a k32 step stays on the pattern.
//   * Shared memory is read and written through its 32-bit address
//     (ld/st.shared): through a generic pointer ptxas emits generic loads.
//   * The first wgmma of a tile runs with scale-d = 0 instead of zeroed
//     accumulators.  Every chunk runs its four k32 steps, zeros past K (K =
//     64 at the stage-1 1x1 sites): a wgmma under a condition makes ptxas
//     wait on each one.
//   * The quotient's fast path is held bitwise to __fdiv_rn on every finite
//     bf16 value at three scales by chip_smoke.py.

#include "action_common.cuh"

namespace {

constexpr int BK = 128;                // codes of K a chunk: 128 bytes
constexpr int kWStages = 3;            // W ring stages (XS > 1)
constexpr float kRound = 12582912.f;   // 1.5 * 2^23
// a code of q may part from the IEEE quotient's only this close to a tie
// (|q - x / xs| < 1.5 * 2^-16 for |q| <= 127; twice that, and a margin)
constexpr float kNearTie = 0.5f - 1.f / 16384.f;

// keeps the compiler from reading an accumulator before the wait
__device__ __forceinline__ void fence_acc(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// D[64 x N] (+)= A[64 x 32] (K-major, shared) * B[32 x N] (K-major, shared),
// s8 in, s32 accumulators, N/2 a thread
__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db, scale_d);
  else if constexpr (BN == 128) wgmma_s8_n128(d, da, db, scale_d);
  else wgmma_s8_n256(d, da, db, scale_d);
}

// ---- shared memory by address (the generic path would not be LDS/STS) ---

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds64f(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts64(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n"
               :: "r"(a), "r"(x), "r"(y) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(x) : "memory");
}

// ---- the quantize -------------------------------------------------------

// clamp(x * rxs, +-127) + 1.5 * 2^23: the low byte of the bits is the code
// of the rounded (half to even) q; dev gathers |q - rint(q)|
__device__ __forceinline__ float scaled(float v, float rxs) {
  return fminf(fmaxf(__fmul_rn(v, rxs), -127.f), 127.f);
}
__device__ __forceinline__ uint32_t code_fast(float v, float rxs,
                                              float& dev) {
  const float q = scaled(v, rxs);
  const float t = __fadd_rn(q, kRound);
  dev = fmaxf(dev, fabsf(__fsub_rn(q, __fsub_rn(t, kRound))));
  return __float_as_uint(t);
}
// the same from the IEEE quotient (no reciprocal), as JAX divides
__device__ __forceinline__ uint32_t code_exact(float v, float xs) {
  const float q = fminf(fmaxf(__fdiv_rn(v, xs), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, kRound));
}
// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(const uint32_t* c) {
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                     __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

// the values of a 16-byte piece: 8 bf16 or 4 f32
__device__ __forceinline__ void unpack(const uint4& p, float* f,
                                       const bf16*) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t b = word(p, w);
    f[2 * w] = __uint_as_float(b << 16);
    f[2 * w + 1] = __uint_as_float(b & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& p, float* f,
                                       const float*) {
#pragma unroll
  for (int w = 0; w < 4; ++w) f[w] = __uint_as_float(word(p, w));
}

// the codes of a 16-byte piece (8 bf16 or 4 f32 values), in order, in the
// low bytes of a uint2 (f32: .x only); an element within kNearTie of a tie
// takes the exact quotient
template <typename T>
__device__ __forceinline__ uint2 quantize(const uint4& p, float xs,
                                          float rxs) {
  constexpr int kE = 16 / sizeof(T);
  float f[kE];
  unpack(p, f, (const T*)nullptr);
  uint32_t c[8] = {};
  float dev = 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) c[i] = code_fast(f[i], rxs, dev);
  if (dev > kNearTie) {
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (fabsf(__fsub_rn(scaled(f[i], rxs),
                          __fsub_rn(__uint_as_float(c[i]), kRound))) >
          kNearTie)
        c[i] = code_exact(f[i], xs);
  }
  return make_uint2(pack4(c), kE == 8 ? pack4(c + 4) : 0u);
}

// ---- stores of either dtype ---------------------------------------------

__device__ __forceinline__ void store_pair(uint32_t a, float x, float y,
                                           const bf16*) {
  sts32(a, pack2(x, y));
}
__device__ __forceinline__ void store_pair(uint32_t a, float x, float y,
                                           const float*) {
  sts64(a, __float_as_uint(x), __float_as_uint(y));
}

struct Geometry {
  int n, h, w, cin, cout, kh, kw, stride, pad, ho, wo;
  int m, k;                            // GEMM rows (N*Ho*Wo) and depth
};

// Byte offsets into the dynamic shared memory, every tile 1024-byte
// aligned; BM / 64 warpgroups, XS x stages; XS = 1: K is one chunk, and
// one stage of x, W and A is all a block holds.
template <typename T, int BN, int BM, int XS>
struct Smem {
  static constexpr int kThreads = BM * 2;
  static constexpr int kWS = XS == 1 ? 1 : kWStages;       // W stages
  static constexpr int kAS = XS == 1 ? 1 : 2;              // A tiles
  static constexpr int kXRow = BK * sizeof(T);       // a staged x row
  static constexpr int kXTile = BM * kXRow;
  static constexpr int kWTile = BN * BK;
  static constexpr int kATile = BM * BK;
  static constexpr int kX = 0;                               // x ring
  static constexpr int kW = kX + XS * kXTile;                // W ring
  static constexpr int kA = kW + kWS * kWTile;               // A tiles
  static constexpr int kS = kA + kAS * kATile;               // xs * ws
  static constexpr int kBytes = kS + BN * 4;
  static constexpr int kOutPitch = BN * sizeof(T) + 16;      // epilogue row
  static_assert(BM * kOutPitch <= kS, "the epilogue reuses the rings");
  static_assert(kBytes + 1024 - 16 <= 232448, "shared memory of a block");
};

template <typename T, int BN, int BM, int XS>
__global__ void __launch_bounds__(BM * 2, 1)
int8_conv_kernel(const T* __restrict__ x, const float* __restrict__ xs_ptr,
                 const int8_t* __restrict__ wq,
                 const float* __restrict__ ws, T* __restrict__ out,
                 Geometry g) {
  using L = Smem<T, BN, BM, XS>;
  constexpr int kThreads = L::kThreads;
  constexpr int kE = 16 / sizeof(T);           // values of a 16-byte piece
  constexpr int kPieces = BK / (8 * kE);       // pieces of a row a thread
  constexpr int kRowStep = kThreads / 8;       // rows between a thread's
  constexpr int kRows = BM / kRowStep;         // rows a thread: 4
  constexpr int kStageBits = kRows * kPieces;
  constexpr int kWS = L::kWS, kAS = L::kAS;
  static_assert(kRows == 4 && XS * kStageBits <= 32, "in_mask");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (g.cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const float xs = __ldg(xs_ptr);
  const float rxs = __frcp_rn(xs);
  for (int c = tid; c < BN; c += kThreads)   // BN may pass the threads
    sts32(sbase + L::kS + 4 * c, __float_as_uint(
        n0 + c < g.cout ? __fmul_rn(xs, __ldg(ws + n0 + c)) : 0.f));

  // This thread's pieces: rows r8 + kRowStep j (j < 4); in a chunk, piece q
  // holds the kE values at q * 8 kE + c8 kE, so the 8 threads of a row read
  // 128 contiguous bytes an instruction (whole 32-byte sectors).  It
  // copies their x itself and reads back only that.
  const int c8 = tid % 8, r8 = tid / 8;
  long long rowbase[kRows];           // element of pixel (n, oh*s - pad,
  int ih0[kRows], iw0[kRows];         // ow*s - pad)
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int m = m0 + r8 + kRowStep * j;
    const int hw = g.ho * g.wo;
    const int img = m / hw, r = m - img * hw;
    const int oh = r / g.wo, ow = r - (r / g.wo) * g.wo;
    ih0[j] = m < g.m ? oh * g.stride - g.pad : -(1 << 30);   // row past M:
    iw0[j] = ow * g.stride - g.pad;                          // never in
    rowbase[j] = (((long long)img * g.h + ih0[j]) * g.w + iw0[j]) * g.cin;
  }
  // the tap (kh, kw) and channel ci of each piece's first value in the next
  // chunk to load; k its place in K
  int pk[kPieces], pci[kPieces], pkh[kPieces], pkw[kPieces];
#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
    pk[q] = q * 8 * kE + c8 * kE;
    const int tap = pk[q] / g.cin;
    pci[q] = pk[q] - tap * g.cin;
    pkh[q] = tap / g.kw;
    pkw[q] = tap - pkh[q] * g.kw;
  }
  uint32_t in_mask = 0;      // bit s kStageBits + j kPieces + q: piece read

  auto load_x = [&](int kc) {
    const int s = kc % XS;
    const uint32_t dst = sbase + L::kX + s * L::kXTile +
                         r8 * L::kXRow + c8 * 16;
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int off = (pkh[q] * g.w + pkw[q]) * g.cin + pci[q];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int ih = ih0[j] + pkh[q], iw = iw0[j] + pkw[q];
        if (pk[q] < g.k && (unsigned)ih < (unsigned)g.h &&
            (unsigned)iw < (unsigned)g.w) {
          cp_async16(dst + kRowStep * j * L::kXRow + q * 128,
                     x + rowbase[j] + off, true);
          bits |= 1u << (j * kPieces + q);
        }
      }
      pk[q] += BK;                    // on to the next chunk's tap
      pci[q] += BK;
      while (pci[q] >= g.cin) {
        pci[q] -= g.cin;
        if (++pkw[q] == g.kw) {
          pkw[q] = 0;
          ++pkh[q];
        }
      }
    }
    in_mask = (in_mask & ~(((1u << kStageBits) - 1) << (s * kStageBits))) |
              (bits << (s * kStageBits));
  };

  // the weight chunk: BN rows of 128 bytes, zero past K and past Cout
  auto load_w = [&](int kc) {
    const int k0 = kc * BK;
    const uint32_t dst = sbase + L::kW + (kc % kWS) * L::kWTile;
#pragma unroll
    for (int v = 0; v < BN * 8 / kThreads; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx / 8, c = idx % 8;
      const bool in = n0 + r < g.cout && k0 + c * 16 < g.k;
      cp_async16(dst + r * 128 + ((c ^ (r % 8)) << 4),
                 in ? wq + (long long)(n0 + r) * g.k + k0 + c * 16 : wq, in);
    }
  };

  // the chunk's codes into A tile kc % 2, swizzled: piece q's kE codes at
  // byte q * 8 kE + c8 kE of the row
  // (the row loop stays rolled: unrolled, its fallbacks make the loop's
  // code outgrow the instruction cache)
  auto build_a = [&](int kc) {
    const int s = kc % XS;
    const uint32_t src = sbase + L::kX + s * L::kXTile + r8 * L::kXRow +
                         c8 * 16;
    const uint32_t a = sbase + L::kA + (kc % kAS) * L::kATile;
#pragma unroll 1
    for (int j = 0; j < kRows; ++j) {
      const int row = r8 + kRowStep * j;
      uint4 p[kPieces];                // the row's pieces, loaded first
#pragma unroll
      for (int q = 0; q < kPieces; ++q)
        p[q] = lds128(src + kRowStep * j * L::kXRow + q * 128);
#pragma unroll
      for (int q = 0; q < kPieces; ++q) {
        const int b = q * 8 * kE + c8 * kE;
        const uint32_t dst = a + row * 128 + (((b >> 4) ^ (row % 8)) << 4) +
                             (b & 15);
        uint2 w = make_uint2(0u, 0u);
        if (in_mask >> (s * kStageBits + j * kPieces + q) & 1u)
          w = quantize<T>(p[q], xs, rxs);
        if constexpr (kE == 8) sts64(dst, w.x, w.y);
        else sts32(dst, w.x);
      }
    }
  };

  const int kt = (g.k + BK - 1) / BK;    // (XS = 1: kt is 1)
  // x chunks XS - 1 ahead (a group each, the first with W chunk 0); W
  // chunks one ahead, in the group of the x chunk loaded beside them
#pragma unroll
  for (int i = 0; i < (XS > 1 ? XS - 1 : 1); ++i) {
    if (i < kt) load_x(i);
    if (i == 0) load_w(0);
    cp_async_commit();
  }
  int acc[BN / 2];                     // the first wgmma sets them
  const int wg = warp / 4;
  for (int kc = 0; kc < kt; ++kc) {
    cp_async_wait<(XS > 1 ? XS - 2 : 0)>();   // this thread's x of chunk kc
    __syncthreads();                   // every wgmma kc - 2 is done: W slot
                                       // (kc + 1) % 3, A tile kc % 2 free
    if (XS > 1 && kc + XS - 1 < kt) load_x(kc + XS - 1);
    if (kc + 1 < kt) load_w(kc + 1);
    cp_async_commit();
    build_a(kc);
    cp_async_wait<1>();                // this thread's W of chunk kc is in
    fence_proxy_async();
    __syncthreads();                   // A tile kc and W chunk kc complete
    const uint32_t a_rows = sbase + L::kA + (kc % kAS) * L::kATile +
                            wg * 64 * 128;
    const uint32_t w_tile = sbase + L::kW + (kc % kWS) * L::kWTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8<BN>(acc, desc_sw128(a_rows + kk * 32, 16, 1024),
                   desc_sw128(w_tile + kk * 32, 16, 1024), kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                   // wgmma kc - 1 is done
  }
  wgmma_wait<0>();
  cp_async_wait<0>();                  // (the groups past the end are empty)
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_acc(acc[i]);
  __syncthreads();                     // every build and wgmma is done: the
                                       // rings are free for the epilogue
  // accumulator (n8, i): row wg*64 + (warp%4)*16 + lane/4 + 8 i, channels
  // n8*8 + 2 (lane%4) (+1)
  const uint32_t stage = sbase + L::kX;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8) {
    const int c = n8 * 8 + 2 * (lane % 4);
    const float2 sc = lds64f(sbase + L::kS + 4 * c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      store_pair(stage + (row + 8 * i) * L::kOutPitch + c * sizeof(T),
                 __fmul_rn(__int2float_rn(acc[n8 * 4 + 2 * i]), sc.x),
                 __fmul_rn(__int2float_rn(acc[n8 * 4 + 2 * i + 1]), sc.y),
                 x);
  }
  __syncthreads();
  constexpr int kPerRow = BN * sizeof(T) / 16;   // 16-byte vectors a row
  constexpr int kLanes = 16 / sizeof(T);         // channels a vector
  for (int v = tid; v < BM * kPerRow; v += kThreads) {
    const int rr = v / kPerRow, cv = v % kPerRow;
    const int m = m0 + rr, c = n0 + cv * kLanes;
    if (m < g.m && c < g.cout)         // Cout % 8 == 0: a vector is all in
      *reinterpret_cast<uint4*>(out + (long long)m * g.cout + c) =
          lds128(stage + rr * L::kOutPitch + cv * 16);
  }
}

// The tile of a launch: BN from Cout (64, 128, 256; f32 input at most
// 128, for shared memory); K of one chunk: BM = 64 and one stage of each
// ring (XS = 1: three or more blocks an SM); else BM = 64 with two x
// stages at BN = 64 (three blocks an SM), BM = 128 with three (two for
// f32) above it.
struct Tile {
  int bn, bm, xs;
};
Tile pick_tile(int dtype, int cout, int k) {
  const int bn = cout <= 64 ? 64 : cout <= 128 || dtype == 0 ? 128 : 256;
  if (k <= BK) return {bn, 64, 1};
  if (bn == 64) return {64, 64, 2};
  return {bn, 128, dtype == 1 ? 3 : 2};
}

template <typename T, int BN, int BM, int XS>
int shared_bytes() {
  return Smem<T, BN, BM, XS>::kBytes + 1024 - 16;   // + room to align a
}                                                    // 16-byte aligned base

template <typename T, int BN, int BM, int XS>
int launch(const void* x, const void* xs, const void* wq, const void* ws,
           void* out, const Geometry& g, cudaStream_t stream) {
  const int bytes = shared_bytes<T, BN, BM, XS>();
  auto kernel = int8_conv_kernel<T, BN, BM, XS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((g.m + BM - 1) / BM) * ((g.cout + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, BM * 2, bytes, stream>>>(
      (const T*)x, (const float*)xs, (const int8_t*)wq, (const float*)ws,
      (T*)out, g);
  return (int)cudaGetLastError();
}

// every tile pick_tile makes: (launch or shared bytes) for one of them
template <bool kLaunch>
int dispatch(int dtype, const void* x, const void* xs, const void* wq,
             const void* ws, void* out, const Geometry& g,
             cudaStream_t st) {
  const Tile t = pick_tile(dtype, g.cout, g.k);
#define EHGR_TILE(T, BN, BM, XS)                                          \
  if (t.bn == BN && t.bm == BM && t.xs == XS)                             \
    return kLaunch ? launch<T, BN, BM, XS>(x, xs, wq, ws, out, g, st)     \
                   : shared_bytes<T, BN, BM, XS>();
  if (dtype == 1) {
    EHGR_TILE(bf16, 64, 64, 2)
    EHGR_TILE(bf16, 128, 128, 3)
    EHGR_TILE(bf16, 256, 128, 3)
    EHGR_TILE(bf16, 64, 64, 1)
    EHGR_TILE(bf16, 128, 64, 1)
    EHGR_TILE(bf16, 256, 64, 1)
  } else {
    EHGR_TILE(float, 64, 64, 2)
    EHGR_TILE(float, 128, 128, 2)
    EHGR_TILE(float, 64, 64, 1)
    EHGR_TILE(float, 128, 64, 1)
  }
#undef EHGR_TILE
  return kLaunch ? (int)cudaErrorInvalidValue : -1;
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16.  x: [n, h, w, cin]; xs:
// f32 scalar (> 0); wq: int8 [cout, kh, kw, cin]; ws: f32 [cout]; out:
// [n, ho, wo, cout]; all contiguous device pointers, x, wq and out 16-byte
// aligned; cin % 16 == 0 and cout % 8 == 0, else cudaErrorInvalidValue.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ehgr_int8_conv_fused(int dtype, const void* x, const void* xs,
                                    const void* wq, const void* ws,
                                    void* out, int n, int h, int w, int cin,
                                    int cout, int kh, int kw, int stride,
                                    int pad, int ho, int wo, void* stream) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)wq | (uintptr_t)out;
  if (cin % 16 != 0 || cout % 8 != 0 || a % 16 != 0 || n <= 0 || ho <= 0 ||
      wo <= 0 || (long long)n * ho * wo >= (1LL << 31) ||
      (long long)kh * kw * cin >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Geometry g{n, h, w, cin, cout, kh, kw, stride, pad, ho, wo,
             n * ho * wo, kh * kw * cin};
  return dispatch<true>(dtype, x, xs, wq, ws, out, g, (cudaStream_t)stream);
}

// The grid ehgr_int8_conv_fused launches for m output rows, cout channels
// and depth k (kh * kw * cin): grid[0] blocks, grid[1] BN, grid[2] BM,
// grid[3] x ring stages, grid[4] dynamic shared memory bytes.
extern "C" int ehgr_int8_conv_grid(int dtype, int m, int cout, int k,
                                   int* grid) {
  const Tile t = pick_tile(dtype, cout, k);
  Geometry g{};
  g.cout = cout;
  g.k = k;
  grid[0] = (m + t.bm - 1) / t.bm * ((cout + t.bn - 1) / t.bn);
  grid[1] = t.bn;
  grid[2] = t.bm;
  grid[3] = t.xs;
  grid[4] = dispatch<false>(dtype, nullptr, nullptr, nullptr, nullptr,
                            nullptr, g, nullptr);
  return 0;
}
