// Int8 bottleneck stages of the post-training-quantized ResNet50, for Hopper.
//
// Replaces the two Pallas TPU kernels of
// transmil_deepgraft_tpu/ops/pallas/qstage_kernel.py:
//   qstage_run <- _stage_kernel: a run of stride-1 bottlenecks,
//                 1x1 -> requant -> 3x3 over a -128 pad -> requant ->
//                 1x1 + (identity fma | 1x1 downsample) -> clip/round.
//   qentry_run <- _entry_kernel: one stride-2 stage-entry bottleneck,
//                 1x1 at full resolution, 3x3/s2 over a -128 pad,
//                 1x1 + the 1x1/s2 downsample projection.
// and adds one that replaces no TPU kernel (JAX runs the stem as XLA ops):
//   qstem_run: the stem, float32 tiles -> input quantize -> space-to-depth
//              4x4 int8 conv -> requant -> 3x3/2 max-pool, in one launch
//              (stem_kernel, at the end of this file).
//
// Both launchers run one kernel, conv_kernel, three times a bottleneck: conv1,
// conv2, and conv3 with the identity or the downsample in the same launch. It
// is an implicit GEMM over NHWC codes: rows = output pixels, K = taps * Cin in
// (di, dj, ci) order, N = Cout, with the weights packed once per block by the
// wrapper as (Cout, K), K contiguous. Accumulation is exact int32 on the
// tensor cores. Epilogues, each rounding where XLA:CPU rounds (it contracts
// acc * m + z into one fma; the residual sum into fma(acc3, m3, idn) + z3),
// spelled with __fmaf_rn / __fmul_rn / __fadd_rn so that nvcc contracts
// nothing else:
//   conv1     q = clip(rint(fma(float(acc), m, z))), stored as the byte q + 128
//   conv2     acc = sum(u * w) - 128 * colsum(w), then as conv1, stored as q
//   identity  q = clip(rint(fma(float(acc3), m3, float(x) * id_mult) + z3))
//   dsres     d = float(acc_d) * md; q = clip(rint(fma(float(acc3), m3, d) + z3))
//
// What bounds them on an H100: a 128-tile chunk is 1.016 int8 TOP (0.51 ms at
// the 1,979 TOP/s dense int8 rate; tools/mma_s8_peak.cu measures 1,958 for
// wgmma and 1,087 for mma.sync, so only wgmma reaches it) against 2.88 GB that
// this design must move (h1, h2 and every block's output written and read
// once, the block input read twice: 0.86 ms at 3.35 TB/s). Stage 1 (56x56,
// K = 64..576) is bound by bytes, stages 3-4 (K up to 4,608) by operations.
// What the design does:
//   - wgmma m64nNk32 (N = 64 or 128) from shared memory, two warpgroups of 64
//     rows a block, both operands K-major in the canonical 128-byte (K tile
//     128) or 64-byte (K tile 64, for K = 64 and 576) swizzle;
//   - a ring of 3-8 stages (up to 112 KB) fed by 16-byte cp.async, one
//     barrier a K tile, two blocks an SM, on a persistent grid whose ring runs
//     on across output tiles, so the next tile's loads fly during this one's
//     epilogue and the other block's products;
//   - the 3x3 pad by zero-fill: conv1 writes h1 as u8 = code + 128, so the pad
//     code -128 is the byte 0 that cp.async writes for a tap outside the
//     image (src-size 0), conv2 multiplies u8 x s8, and its epilogue adds
//     -128 * colsum(w2)[n]: sum((u - 128) * w) = sum(u * w) - 128 * sum(w),
//     exact in int32 (|sum(u * w)| <= 255 * 127 * 4,608 < 2^31);
//   - the downsample in conv3's launch: the K loop runs over the block input
//     (1x1, stride 1 or 2) into a second accumulator, then over h2;
//   - the column constants and identity codes ride in the ring with a tile's
//     last K tile; the output tile is staged in shared memory and written in
//     16-byte stores;
//   - no division in the loop: tiles and taps are stepped, a pixel is decoded
//     (multiply-shift) only for the 3x3 and the strided downsample.
// What holds it (tools/profile_qstage.py --phases, PERF.md): each K tile's
// wait for its products and, for short K, the requant epilogue's
// instructions (1,300-2,560 clocks a 128 x 64 identity tile); every warp
// also issues its own copies (380-1,040 clocks a K tile) before its products
// (310-980), but taking them off the warps gained nothing. Measured no
// faster: TMA for the 2D operands, a warp-specialized TMA producer (the
// warps then only multiply and requantize), one batch of products kept in
// flight. Not done: the epilogue of one warpgroup under the products of
// another, and (the TPU kernel keeps a tile's whole run on chip, which does
// not fit in 228 KB at 56x56x64) keeping h1 and h2 out of device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // output rows (pixels) a block
constexpr int THREADS = 256;         // two warpgroups of 64 rows
constexpr int SMEM_PER_BLOCK = 113 * 1024;  // two blocks an SM: (228 KB - 2 x 1 KB) / 2

enum Epi { EPI_U8 = 0, EPI_CS = 1, EPI_IDENTITY = 2, EPI_DSRES = 3 };

struct ConvArgs {
  const uint8_t* x;      // (n, h, w, cin) codes; u8 = code + 128 for EPI_CS
  const int8_t* wt;      // (cout, taps * cin), K contiguous
  const uint8_t* xd;     // EPI_DSRES: block input (n, hd, wd, cind);
                         // EPI_IDENTITY: identity codes (rows, cout)
  const int8_t* wdt;     // EPI_DSRES: (cout, cind)
  const float* sc;       // (2, cout) [m; z]
  const float* md;       // EPI_DSRES: (cout,)
  const int* cs;         // EPI_CS: (cout,) column sums of wt
  const float* id_mult;  // EPI_IDENTITY: () on the device
  uint8_t* out;          // (rows, cout): bytes q + 128 for EPI_U8, else codes q
  int n, h, w, cin;      // the main operand's input
  int ho, wo, cout;      // the output
  int hd, wd, cind;      // EPI_DSRES: the downsample's input
  // row / (ho * wo) and rem / wo as (n * mul) >> (32 + shr), mul 0 for a
  // divisor of 1 (set by the launcher)
  uint32_t hw_mul, hw_shr, w_mul, w_shr;
};

// The multiply and shift that divide 0 <= n < 2^31 by d exactly.
void fast_div(int d, uint32_t& mul, uint32_t& shr) {
  if (d <= 1) {
    mul = shr = 0;
    return;
  }
  int l = 0;
  while ((1LL << l) < d) ++l;  // ceil(log2 d)
  mul = (uint32_t)(((1ULL << (31 + l)) + d - 1) / d);
  shr = (uint32_t)(l - 1);
}

__device__ __forceinline__ int div_by(int n, uint32_t mul, uint32_t shr) {
  return mul ? (int)(__umulhi((uint32_t)n, mul) >> shr) : n;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile: rows of BK bytes in the
// canonical swizzle (128-byte for BK 128, 64-byte for BK 64), 8-row groups
// BK * 8 bytes apart (SBO), LBO unused. The tile base is 1024-byte aligned;
// the k32 steps inside a row move the start address by 32 bytes.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = (BK == 128) ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * BK) >> 4) << 32) | (layout << 62);
}

// Byte offset of 16-byte chunk c of row r in such a tile.
template <int BK>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  if constexpr (BK == 128) return (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4);
  else return (r >> 3) * 512 + (r & 7) * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// D (64 x N, int32) += A (64 x 32 bytes) * B (N x 32 bytes), both from shared
// memory; A is s8 or u8, B s8. D fragment: warp w of the warpgroup, lane l,
// register 4j + 2h + e holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
#define WGMMA_N64(ATYPE)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." ATYPE ".s8 "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
      "%30, %31}, %32, %33, p;\n}\n"  \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),  \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),  \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),  \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),  \
        "+r"(d[30]), "+r"(d[31])  \
      : "l"(da), "l"(db), "r"(1))

#define WGMMA_N128(ATYPE)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." ATYPE ".s8 "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"  \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),  \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),  \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),  \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),  \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),  \
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),  \
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),  \
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),  \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])  \
      : "l"(da), "l"(db), "r"(1))

template <int BN, bool AU8>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    if constexpr (AU8) WGMMA_N64("u8"); else WGMMA_N64("s8");
  } else {
    if constexpr (AU8) WGMMA_N128("u8"); else WGMMA_N128("s8");
  }
}

// clip(rint(y), -128, 127) as the byte of the int8 code: cvt.rni rounds half
// to even, as rintf.
__device__ __forceinline__ uint32_t clip_round(float y) {
  return (uint32_t)min(max(__float2int_rn(y), -128), 127) & 0xffu;
}

// ------------------------------------------------------------------ kernel

// A ring stage: the A tile (BM x BK), the B tile (BN x BK), and, loaded with
// the last K tile of an output tile, its column constants (m, z, and md or
// conv2's column sums: 3 x BN words) and for EPI_IDENTITY its identity codes
// (BM x BN). The output tile is staged at the stage's start once its
// products are done.
template <int BN, int BK, int EPI>
struct Tiling {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int C_OFF = (BM + BN) * BK;
  static constexpr int R_OFF = C_OFF + 16 * BN;
  static constexpr int OSTR = BN + 16;  // staging pitch: conflict-free fragment access
  static constexpr int STAGE = R_OFF + (EPI == EPI_IDENTITY ? BM * OSTR : 0);
  static constexpr int RING = SMEM_PER_BLOCK - 1024;  // less the alignment slack
  static constexpr int STAGES = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE;
  static_assert(STAGES >= 3 && BM * OSTR <= C_OFF && STAGE % 1024 == 0, "tiling");
};

// One convolution (EPI_DSRES: conv3 and the downsample) as an implicit GEMM,
// on a persistent grid: block b computes the BM x BN output tiles b, b + G,
// b + 2G, ... (G = gridDim.x; tile t is N tile t % (cout / BN) of M tile
// t / (cout / BN), so the blocks that share an A tile run together). The
// ring runs on across tiles: the next tile's loads are in flight while this
// one's epilogue runs. TAPS 9 is the 3x3 over a pad of 1; STRIDE is the main
// operand's stride, except for EPI_DSRES, whose main operand (h2) has stride
// 1 and whose downsample reads with STRIDE.
template <int BN, int BK, int TAPS, int STRIDE, int EPI>
__global__ void __launch_bounds__(THREADS, 2) conv_kernel(const ConvArgs a) {
  using T = Tiling<BN, BK, EPI>;
  constexpr bool AU8 = EPI == EPI_CS;
  constexpr int PAD = TAPS == 9 ? 1 : 0;
  constexpr int MS = EPI == EPI_DSRES ? 1 : STRIDE;
  constexpr int S = T::STAGES;
  constexpr int CPR = BK / 16;        // 16-byte chunks a tile row
  constexpr int RPP = THREADS / CPR;  // tile rows a pass of all threads
  constexpr int AP = BM / RPP, BP = BN / RPP;
  constexpr int ACC = BN / 2;
  static_assert(AP >= 1 && BP >= 1, "tiling");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  const int rows = a.n * a.ho * a.wo;
  const int ntiles = a.cout / BN;
  const int tiles = (rows + BM - 1) / BM * ntiles;
  const int k_main = TAPS * a.cin;
  const int kt_ds = EPI == EPI_DSRES ? a.cind / BK : 0;
  const int kt_tile = kt_ds + k_main / BK;  // K tiles an output tile
  const int items = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * kt_tile;

  // The loader's K tiles come in order, and it steps through tiles and taps
  // without dividing. This thread loads chunk lc of tile rows lr + RPP * i;
  // those rows share (r & 7), so their swizzled offsets are soff + i * RPP * BK.
  // A row's pixel is decoded only where the input is not laid out as the
  // output (the 3x3, the strided downsample); otherwise its offset is row * C.
  constexpr bool DECODE = TAPS == 9 || (EPI == EPI_DSRES && STRIDE != 1);
  const int lc = tid % CPR, lr = tid / CPR;
  const uint32_t soff = swizzled<BK>(lr, lc);
  const int step_m = (int)gridDim.x / ntiles, step_n = (int)gridDim.x % ntiles;
  int a_base[AP], d_base[AP], a_ih[AP], a_iw[AP];
  bool a_ok[AP];
  int ld_kt = kt_tile, ld_m0 = 0, ld_n0 = 0;
  int ld_mt = (int)blockIdx.x / ntiles, ld_nt = (int)blockIdx.x % ntiles;
  int tap_di = 0, tap_dj = 0, tap_ci = 0;  // the 3x3: the tap and channel of the next K tile

  auto next_tile = [&](int& mt, int& nt) {
    nt += step_n;
    mt += step_m;
    if (nt >= ntiles) {
      nt -= ntiles;
      ++mt;
    }
  };

  // The next K tile into ring stage st.
  auto load = [&](int st) {
    if (ld_kt == kt_tile) {
      ld_kt = 0;
      tap_di = tap_dj = tap_ci = 0;
      ld_m0 = ld_mt * BM;
      ld_n0 = ld_nt * BN;
      next_tile(ld_mt, ld_nt);
#pragma unroll
      for (int i = 0; i < AP; ++i) {
        const int row = ld_m0 + lr + RPP * i;
        a_ok[i] = row < rows;
        const int rr = a_ok[i] ? row : 0;
        if constexpr (DECODE) {
          const int img = div_by(rr, a.hw_mul, a.hw_shr);
          const int rem = rr - img * a.ho * a.wo;
          const int oh = div_by(rem, a.w_mul, a.w_shr), ow = rem - oh * a.wo;
          a_ih[i] = oh * MS - PAD;
          a_iw[i] = ow * MS - PAD;
          a_base[i] = ((img * a.h + a_ih[i]) * a.w + a_iw[i]) * a.cin;
          d_base[i] = ((img * a.hd + oh * STRIDE) * a.wd + ow * STRIDE) * a.cind;
        } else {
          a_ih[i] = a_iw[i] = 0;
          a_base[i] = rr * a.cin;
          d_base[i] = rr * a.cind;
        }
      }
    }
    const int kt = ld_kt++;
    const uint32_t stage = ring + st * T::STAGE;
    const uint32_t sa = stage + soff;
    const uint32_t sb = stage + T::A_BYTES + soff;
    if (kt == kt_tile - 1) {  // the tile's constants (and identity codes) ride with its last
      if (tid < BN / 4) {
        cp_async16(stage + T::C_OFF + 16 * tid, a.sc + ld_n0 + 4 * tid, true);
      } else if (tid < BN / 2) {
        cp_async16(stage + T::C_OFF + 16 * tid, a.sc + a.cout + ld_n0 + 4 * (tid - BN / 4), true);
      } else if (tid < 3 * BN / 4 && (EPI == EPI_DSRES || EPI == EPI_CS)) {
        const void* src = EPI == EPI_DSRES ? (const void*)(a.md + ld_n0 + 4 * (tid - BN / 2))
                                           : (const void*)(a.cs + ld_n0 + 4 * (tid - BN / 2));
        cp_async16(stage + T::C_OFF + 16 * tid, src, true);
      }
      if constexpr (EPI == EPI_IDENTITY) {
#pragma unroll
        for (int i = 0; i < BM * BN / 16 / THREADS; ++i) {
          const int q = tid + THREADS * i;
          const int r = q / (BN / 16), c = q % (BN / 16);
          const bool ok = ld_m0 + r < rows;
          cp_async16(stage + T::R_OFF + r * T::OSTR + 16 * c,
                     ok ? a.xd + (ld_m0 + r) * a.cout + ld_n0 + 16 * c : a.xd, ok);
        }
      }
    }
    if (EPI == EPI_DSRES && kt < kt_ds) {  // the downsample's K tiles come first
      const int k = kt * BK + 16 * lc;
#pragma unroll
      for (int i = 0; i < AP; ++i)
        cp_async16(sa + i * RPP * BK, a_ok[i] ? a.xd + d_base[i] + k : a.xd, a_ok[i]);
      const int8_t* src = a.wdt + (ld_n0 + lr) * a.cind + k;
#pragma unroll
      for (int j = 0; j < BP; ++j) cp_async16(sb + j * RPP * BK, src + j * RPP * a.cind, true);
      return;
    }
    const int k = (kt - kt_ds) * BK + 16 * lc;
    if constexpr (TAPS == 1) {
#pragma unroll
      for (int i = 0; i < AP; ++i)
        cp_async16(sa + i * RPP * BK, a_ok[i] ? a.x + a_base[i] + k : a.x, a_ok[i]);
    } else {  // this K tile lies in one tap (cin % BK == 0)
      const int toff = (tap_di * a.w + tap_dj) * a.cin + tap_ci + 16 * lc;
#pragma unroll
      for (int i = 0; i < AP; ++i) {
        const int ih = a_ih[i] + tap_di, iw = a_iw[i] + tap_dj;
        const bool ok = a_ok[i] && (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w;
        cp_async16(sa + i * RPP * BK, ok ? a.x + a_base[i] + toff : a.x, ok);
      }
      tap_ci += BK;
      if (tap_ci == a.cin) {
        tap_ci = 0;
        if (++tap_dj == 3) {
          tap_dj = 0;
          ++tap_di;
        }
      }
    }
    const int8_t* src = a.wt + (ld_n0 + lr) * k_main + k;
#pragma unroll
    for (int j = 0; j < BP; ++j) cp_async16(sb + j * RPP * BK, src + j * RPP * k_main, true);
  };

  int acc[ACC], accd[EPI == EPI_DSRES ? ACC : 1];
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const float idm = EPI == EPI_IDENTITY ? *a.id_mult : 0.f;

  for (int st = 0; st < S - 1; ++st) {
    if (st < items) load(st);
    cp_async_commit();
  }
  int kt = 0, mt = (int)blockIdx.x / ntiles, nt = (int)blockIdx.x % ntiles;
  for (int it = 0; it < items; ++it) {
    // K tile it is in; every warpgroup is done with it - 1, whose stage takes it + S - 1.
    cp_async_wait<S - 2>();
    __syncthreads();
    const int nxt = it + S - 1;
    if (nxt < items) load(nxt % S);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0;
#pragma unroll
      for (int i = 0; i < (EPI == EPI_DSRES ? ACC : 1); ++i) accd[i] = 0;
    }
    const bool last = kt + 1 == kt_tile;
    uint8_t* stage = sm + (it % S) * T::STAGE;
    const uint32_t sa = ring + (it % S) * T::STAGE + wg * 64 * BK;
    const uint32_t sb = ring + (it % S) * T::STAGE + T::A_BYTES;
    auto mma = [&](auto& d) {
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma<BN, AU8>(d, smem_desc<BK>(sa + 32 * kk), smem_desc<BK>(sb + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
    };
    if constexpr (EPI == EPI_DSRES) {
      if (kt < kt_ds) mma(accd);
      else mma(acc);
    } else {
      mma(acc);
    }
    if (!last) {
      ++kt;
      continue;
    }

    // Epilogue of this tile: the fragments to codes, staged over this
    // stage's A and B (every warpgroup is done with them after the barrier),
    // then 16-byte stores of whole rows.
    kt = 0;
    const int m0 = mt * BM, n0 = nt * BN;
    next_tile(mt, nt);
    const float* s_m = reinterpret_cast<const float*>(stage + T::C_OFF);
    const float* s_z = s_m + BN;
    const float* s_md = s_z + BN;
    const int* s_cs = reinterpret_cast<const int*>(s_z + BN);
    const uint8_t* s_res = stage + T::R_OFF;
    __syncthreads();
    if constexpr (EPI == EPI_CS) {  // the u8 offset: sum((u - 128) w) = sum(u w) - 128 sum(w)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int2 cs = *reinterpret_cast<const int2*>(s_cs + 8 * j + 2 * (lane & 3));
        acc[4 * j] -= 128 * cs.x;
        acc[4 * j + 1] -= 128 * cs.y;
        acc[4 * j + 2] -= 128 * cs.x;
        acc[4 * j + 3] -= 128 * cs.y;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 m = *reinterpret_cast<const float2*>(s_m + col);
      const float2 z = *reinterpret_cast<const float2*>(s_z + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + 8 * hf;
        const int i = 4 * j + 2 * hf;
        const float f0 = __int2float_rn(acc[i]), f1 = __int2float_rn(acc[i + 1]);
        float y0, y1;
        if constexpr (EPI == EPI_IDENTITY) {
          const char2 x = *reinterpret_cast<const char2*>(s_res + r * T::OSTR + col);
          y0 = __fadd_rn(__fmaf_rn(f0, m.x, __fmul_rn((float)x.x, idm)), z.x);
          y1 = __fadd_rn(__fmaf_rn(f1, m.y, __fmul_rn((float)x.y, idm)), z.y);
        } else if constexpr (EPI == EPI_DSRES) {
          const float2 md = *reinterpret_cast<const float2*>(s_md + col);
          y0 = __fadd_rn(__fmaf_rn(f0, m.x, __fmul_rn(__int2float_rn(accd[i]), md.x)), z.x);
          y1 = __fadd_rn(__fmaf_rn(f1, m.y, __fmul_rn(__int2float_rn(accd[i + 1]), md.y)), z.y);
        } else {
          y0 = __fmaf_rn(f0, m.x, z.x);
          y1 = __fmaf_rn(f1, m.y, z.y);
        }
        const uint32_t b = EPI == EPI_U8 ? 0x80u : 0u;  // conv1 stores code + 128
        *reinterpret_cast<uchar2*>(stage + r * T::OSTR + col) =
            make_uchar2((uint8_t)(clip_round(y0) ^ b), (uint8_t)(clip_round(y1) ^ b));
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BM * BN / 16 / THREADS; ++i) {
      const int q = tid + THREADS * i;
      const int r = q / (BN / 16), c = q % (BN / 16);
      if (m0 + r < rows)
        *reinterpret_cast<uint4*>(a.out + (size_t)(m0 + r) * a.cout + n0 + 16 * c) =
            *reinterpret_cast<const uint4*>(stage + r * T::OSTR + 16 * c);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ host

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return dev < 64 ? count[dev] : 132;
}

template <int BN, int BK, int TAPS, int STRIDE, int EPI>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr int bytes = Tiling<BN, BK, EPI>::SMEM;
  static unsigned long long configured = 0;  // bit d: the attribute is set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(conv_kernel<BN, BK, TAPS, STRIDE, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  const long long tiles = ((long long)a.n * a.ho * a.wo + BM - 1) / BM * (a.cout / BN);
  if (tiles <= 0 || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long long grid = tiles < 2LL * sm_count() ? tiles : 2LL * sm_count();
  ConvArgs args = a;
  fast_div(a.ho * a.wo, args.hw_mul, args.hw_shr);
  fast_div(a.wo, args.w_mul, args.w_shr);
  conv_kernel<BN, BK, TAPS, STRIDE, EPI><<<(unsigned)grid, THREADS, bytes, stream>>>(args);
  return cudaGetLastError();
}

// Tile shapes: N tiles of 128 for conv1 and conv2 where the K tile is 128
// (halving the A tiles that the L2 cache serves again for each N tile), 64
// for the others (conv3's two accumulators fit 128 registers).
cudaError_t conv1(const ConvArgs& a, cudaStream_t s) {
  if (a.cin % 128) return launch<64, 64, 1, 1, EPI_U8>(a, s);
  return a.cout % 128 ? launch<64, 128, 1, 1, EPI_U8>(a, s) : launch<128, 128, 1, 1, EPI_U8>(a, s);
}

template <int STRIDE>
cudaError_t conv2(const ConvArgs& a, cudaStream_t s) {
  if ((9 * a.cin) % 128) return launch<64, 64, 9, STRIDE, EPI_CS>(a, s);
  return a.cout % 128 ? launch<64, 128, 9, STRIDE, EPI_CS>(a, s)
                      : launch<128, 128, 9, STRIDE, EPI_CS>(a, s);
}

cudaError_t conv3_identity(const ConvArgs& a, cudaStream_t s) {
  return a.cin % 128 ? launch<64, 64, 1, 1, EPI_IDENTITY>(a, s)
                     : launch<64, 128, 1, 1, EPI_IDENTITY>(a, s);
}

template <int STRIDE>
cudaError_t conv3_ds(const ConvArgs& a, cudaStream_t s) {
  return a.cin % 128 == 0 && a.cind % 128 == 0 ? launch<64, 128, 1, STRIDE, EPI_DSRES>(a, s)
                                                : launch<64, 64, 1, STRIDE, EPI_DSRES>(a, s);
}

}  // namespace

extern "C" {

// One bottleneck's operands, prepared once by ops/qstage_kernel._prepare_block.
// wd/md are null for an identity block.
struct QBlockArgs {
  const int8_t* w1;      // (cmid, cin)
  const int8_t* w2;      // (cmid, 9 * cmid), K in (di, dj, ci) order
  const int8_t* w3;      // (cout, cmid)
  const int8_t* wd;      // (cout, cin) or null
  const float* sc1;      // (2, cmid) [m; z]
  const float* sc2;      // (2, cmid)
  const int* cs2;        // (cmid,) column sums of w2
  const float* sc3;      // (2, cout)
  const float* md;       // (cout,) or null
  const float* id_mult;  // () on the device; read by identity blocks only
  int cin, cmid, cout;
};

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

namespace {

// The kernels address activations with 32-bit offsets: every one of
// (n, h, w, c) codes, c the widest of the block, must hold fewer than 2^31.
bool widths_ok(const QBlockArgs& b, int n, int h, int w) {
  const long long widest = b.cin > b.cmid ? (b.cin > b.cout ? b.cin : b.cout)
                                          : (b.cmid > b.cout ? b.cmid : b.cout);
  return b.cin > 0 && b.cmid > 0 && b.cout > 0 && b.cin % 64 == 0 && b.cmid % 64 == 0 &&
         b.cout % 64 == 0 && (b.wd || b.cin == b.cout) &&
         (long long)n * h * w * widest < (1LL << 31);
}

// conv1 and conv2 of a block on x (n, h, w, cin): h1 (n, h, w, cmid) as u8,
// h2 (n, h / s, w / s, cmid) as codes.
template <int S>
cudaError_t conv12(const QBlockArgs& b, const int8_t* x, uint8_t* h1, int8_t* h2, int n,
                   int h, int w, cudaStream_t stream) {
  ConvArgs c1 = {};
  c1.x = reinterpret_cast<const uint8_t*>(x);
  c1.wt = b.w1;
  c1.sc = b.sc1;
  c1.out = h1;
  c1.n = n, c1.h = h, c1.w = w, c1.cin = b.cin, c1.ho = h, c1.wo = w, c1.cout = b.cmid;
  cudaError_t err = conv1(c1, stream);
  if (err != cudaSuccess) return err;
  ConvArgs c2 = {};
  c2.x = h1;
  c2.wt = b.w2;
  c2.sc = b.sc2;
  c2.cs = b.cs2;
  c2.out = reinterpret_cast<uint8_t*>(h2);
  c2.n = n, c2.h = h, c2.w = w, c2.cin = b.cmid, c2.ho = h / S, c2.wo = w / S, c2.cout = b.cmid;
  return conv2<S>(c2, stream);
}

// conv3 of a block from h2 (n, ho, wo, cmid) into out, with the identity
// (x at the same resolution) or the downsample of x (n, h, w, cin), stride S.
template <int S>
cudaError_t conv3(const QBlockArgs& b, const int8_t* x, const int8_t* h2, int8_t* out, int n,
                  int h, int w, cudaStream_t stream) {
  ConvArgs c3 = {};
  c3.x = reinterpret_cast<const uint8_t*>(h2);
  c3.wt = b.w3;
  c3.sc = b.sc3;
  c3.xd = reinterpret_cast<const uint8_t*>(x);
  c3.out = reinterpret_cast<uint8_t*>(out);
  c3.n = n, c3.h = h / S, c3.w = w / S, c3.cin = b.cmid;
  c3.ho = h / S, c3.wo = w / S, c3.cout = b.cout;
  if (b.wd) {
    c3.wdt = b.wd;
    c3.md = b.md;
    c3.hd = h, c3.wd = w, c3.cind = b.cin;
    return conv3_ds<S>(c3, stream);
  }
  c3.id_mult = b.id_mult;
  return conv3_identity(c3, stream);
}

}  // namespace

extern "C" {

// B7: stride-1 blocks on x (n, h, w, blocks[0].cin) -> out (n, h, w, last cout).
// Scratch: h1, h2 (n*h*w*max cmid bytes), act0/act1 (n*h*w*max cout; may be
// null for one block).
int qstage_run(const int8_t* x, int8_t* out, uint8_t* h1, int8_t* h2, int8_t* act0,
               int8_t* act1, const QBlockArgs* blocks, int nblocks, int n, int h, int w,
               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (nblocks < 1 || n < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  for (int i = 0; i < nblocks; ++i)
    if (!widths_ok(blocks[i], n, h, w) || (i && blocks[i].cin != blocks[i - 1].cout))
      return cudaErrorInvalidValue;
  int8_t* acts[2] = {act0, act1};
  const int8_t* in = x;
  for (int i = 0; i < nblocks; ++i) {
    const QBlockArgs& b = blocks[i];
    int8_t* dst = (i == nblocks - 1) ? out : acts[i % 2];
    cudaError_t err = conv12<1>(b, in, h1, h2, n, h, w, stream);
    if (err == cudaSuccess) err = conv3<1>(b, in, h2, dst, n, h, w, stream);
    if (err != cudaSuccess) return err;
    in = dst;
  }
  return cudaSuccess;
}

// B8: one stride-2 block with downsample on x (n, h, w, cin), h and w even ->
// out (n, h/2, w/2, cout). Scratch: h1 (n*h*w*cmid), h2 (n*h/2*w/2*cmid).
int qentry_run(const int8_t* x, int8_t* out, uint8_t* h1, int8_t* h2, const QBlockArgs* blk,
               int n, int h, int w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const QBlockArgs& b = *blk;
  if (!b.wd || !widths_ok(b, n, h, w) || n < 1 || h < 2 || w < 2 || (h % 2) || (w % 2))
    return cudaErrorInvalidValue;
  cudaError_t err = conv12<2>(b, x, h1, h2, n, h, w, stream);
  if (err != cudaSuccess) return err;
  return conv3<2>(b, x, h2, out, n, h, w, stream);
}

}  // extern "C"

// ------------------------------------------------------------------ stem
//
// stem_kernel: models/resnet_int8._plain_stem in one launch, from the float32
// tiles (n, h, w, 3) to the pooled int8 codes (n, h/4, w/4, 64) that B7
// takes. Bit for bit the plain route's arithmetic:
//   x_q = clip(rint(x / input_scale), -127, 127)   (IEEE divide, half to even)
//   the 7x7/s2 conv as a 4x4/s1 conv over the space-to-depth-by-2 input
//     (12 channels (di, dj, ci), zero pad (2, 1)), exact int32 sums
//   q = clip(rint(fma(float(acc), m, z)), -128, 127)   (C4's contraction)
//   the 3x3/2 max-pool over a -128 pad of 1
// What bounds it on an H100: a 128-tile chunk of 224 x 224 reads 77 MB of
// float32 and writes 25.7 MB of codes (31 us at 3.35 TB/s); its products are
// 52.6 G int8 operations with the 12 channels padded to 16 (27 us at 1,979
// TOP/s, 48 us at the ~1,087 that mma.sync reaches). The torch-op route
// moves ~2.5 GB of float64 im2col a chunk instead.
// What the design does: a block owns 14 x 14 pooled positions of one tile
// and computes the 29 x 29 conv positions they pool over (one row and one
// column of halo, recomputed by the neighbour too); it quantizes the 32 x 32
// space-to-depth positions that those read into shared memory, 16 bytes a
// position (12 codes, 4 zeros), so that a conv position's 4x4 window is four
// runs of 64 contiguous bytes and nothing is materialised in device memory.
// The products are mma.sync m16n8k32 s8 (M = conv positions, N = 64, K =
// (ki, kj, c) = 256): a warp owns 32 output channels, whose weights stay in
// its registers, and walks the block's 16-row tiles; the K order inside a
// 64-byte run is permuted alike in A and B so that a thread loads its A
// fragments 16 bytes at a time. The requantized codes stay in shared memory
// for the pool, which stores 16-byte vectors of channels.

namespace {

namespace stem {
constexpr int P = 14, Q = 14;                // pooled rows and columns a block
constexpr int R = 2 * P + 1, C = 2 * Q + 1;  // conv rows and columns a block (+1 halo each)
constexpr int XR = R + 3, XC = C + 3;        // space-to-depth positions they read
constexpr int MT = (R * C + 15) / 16;        // 16-row tiles of conv positions
constexpr int CV_PITCH = 80;   // bytes a conv position's 64 codes take (conflict-free stores)
constexpr int WT_PITCH = 272;  // bytes a weight row of K = 256 takes
constexpr int X_BYTES = XR * XC * 16;
constexpr int CV_BYTES = MT * 16 * CV_PITCH;
constexpr int SMEM = X_BYTES + CV_BYTES + 2 * 64 * 4;
static_assert(64 * WT_PITCH <= CV_BYTES, "the weights are staged where the codes go");
static_assert(X_BYTES % 16 == 0 && CV_BYTES % 16 == 0, "alignment");
}  // namespace stem

// D (16 x 8, int32) += A (16 x 32, s8) * B (32 x 8, s8). A: a0/a2 row g,
// a1/a3 row g + 8, bytes 4t..4t+3 (a0, a1) and 16+4t.. (a2, a3); B: b0 bytes
// 4t.., b1 16+4t.. of column g; D: d0/d1 row g, columns 2t, 2t+1, d2/d3 row
// g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// clip(rint(v / s), -127, 127) as a byte: __fdiv_rn is the IEEE divide.
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  return (uint32_t)min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a | b << 8 | c << 16 | d << 24;
}

// Block b: tile b % tiles_x of tile row b / tiles_x % tiles_y of image
// b / (tiles_x * tiles_y).
__global__ void __launch_bounds__(THREADS, 2)
    stem_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ m, const float* __restrict__ z,
                const float* __restrict__ scale, int8_t* __restrict__ out, int h, int w,
                int tiles_y, int tiles_x) {
  using namespace stem;
  extern __shared__ __align__(16) uint8_t stem_smem[];
  uint8_t* sx = stem_smem;              // (XR, XC, 16) input codes
  uint8_t* scv = stem_smem + X_BYTES;   // the weights (64, WT_PITCH), then the codes (R * C, CV_PITCH)
  float* smz = reinterpret_cast<float*>(scv + CV_BYTES);  // m[64], z[64]
  const int tid = threadIdx.x;
  const int tx = (int)blockIdx.x % tiles_x, ty = (int)blockIdx.x / tiles_x % tiles_y;
  const int img = (int)blockIdx.x / tiles_x / tiles_y;
  const int ph0 = ty * P, pw0 = tx * Q;  // the block's first pooled row and column
  const int h2 = h / 2, w2 = w / 2;

  // The weights (4, 4, 12, 64) HWIO as (n, k), k = (ki * 4 + kj) * 16 + c,
  // zero at c = 12..15.
  for (int i = tid; i < 64 * 16; i += THREADS)
    *reinterpret_cast<uint32_t*>(scv + (i >> 4) * WT_PITCH + (i & 15) * 16 + 12) = 0u;
  for (int i = tid; i < 16 * 12 * 64; i += THREADS) {
    const int n = i & 63, kc = i >> 6, tap = kc / 12;
    scv[n * WT_PITCH + tap * 16 + kc - tap * 12] = static_cast<uint8_t>(wq[i]);
  }
  if (tid < 64) {
    smz[tid] = m[tid];
    smz[64 + tid] = z[tid];
  }

  // Space-to-depth position (i, j) = image rows 2i, 2i+1 x columns 2j, 2j+1:
  // 6 contiguous floats a row, in the (di, dj, ci) order of the 12 channels.
  // Conv position (oh, ow) reads positions oh-2..oh+1 x ow-2..ow+1 (the
  // (2, 1) pad is the zeros outside the image); the block's conv positions
  // start at (2 ph0 - 1, 2 pw0 - 1), so its positions at (2 ph0 - 3, 2 pw0 - 3).
  const float s = *scale;
  const float* xi = x + (size_t)img * h * w * 3;
  for (int p = tid; p < XR * XC; p += THREADS) {
    const int xr = p / XC, xc = p - xr * XC;
    const int i = 2 * ph0 - 3 + xr, j = 2 * pw0 - 3 + xc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 0 && i < h2 && j >= 0 && j < w2) {
      const float* r0 = xi + ((size_t)2 * i * w + 2 * j) * 3;
      const float* r1 = r0 + (size_t)w * 3;
      v.x = pack4(quantize(r0[0], s), quantize(r0[1], s), quantize(r0[2], s), quantize(r0[3], s));
      v.y = pack4(quantize(r0[4], s), quantize(r0[5], s), quantize(r1[0], s), quantize(r1[1], s));
      v.z = pack4(quantize(r1[2], s), quantize(r1[3], s), quantize(r1[4], s), quantize(r1[5], s));
    }
    *reinterpret_cast<uint4*>(sx + 16 * p) = v;
  }
  __syncthreads();

  // Warp w multiplies into channels n0..n0+31 (n0 = 32 (w % 2)). Its B
  // fragments for (N tile j, ki) are the 16 bytes k = 64 ki + 16 t.. of
  // column n0 + 8 j + g: words 0, 1 for the first k32 step, 2, 3 for the
  // second. A takes the same permutation: a row's 16 bytes at 64 ki + 16 t
  // give (a0, a2) of the first step and (a0, a2) of the second.
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int n0 = (warp & 1) * 32;
  uint32_t bf[4][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) {
      const uint4 t = *reinterpret_cast<const uint4*>(scv + (n0 + 8 * j + g) * WT_PITCH + 64 * ki +
                                                      16 * tg);
      bf[j][ki][0] = t.x;
      bf[j][ki][1] = t.y;
      bf[j][ki][2] = t.z;
      bf[j][ki][3] = t.w;
    }
  }
  __syncthreads();  // the codes overwrite the weights

  // Conv position r * C + c (rows past R * C repeat the last and are never
  // pooled): its window's run ki is the 64 bytes at space-to-depth (r + ki, c).
  for (int t = warp >> 1; t < MT; t += THREADS / 64) {
    const int m_lo = min(16 * t + g, R * C - 1), m_hi = min(16 * t + g + 8, R * C - 1);
    const uint8_t* a_lo = sx + ((m_lo / C) * XC + m_lo % C) * 16 + 16 * tg;
    const uint8_t* a_hi = sx + ((m_hi / C) * XC + m_hi % C) * 16 + 16 * tg;
    int acc[4][4] = {};
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) {
      const uint4 lo = *reinterpret_cast<const uint4*>(a_lo + ki * XC * 16);
      const uint4 hi = *reinterpret_cast<const uint4*>(a_hi + ki * XC * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, bf[j][ki][0], bf[j][ki][1]);
        mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, bf[j][ki][2], bf[j][ki][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 8 * j + 2 * tg;
      const float2 mm = *reinterpret_cast<const float2*>(smz + col);
      const float2 zz = *reinterpret_cast<const float2*>(smz + 64 + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t q0 = clip_round(__fmaf_rn(__int2float_rn(acc[j][2 * hf]), mm.x, zz.x));
        const uint32_t q1 = clip_round(__fmaf_rn(__int2float_rn(acc[j][2 * hf + 1]), mm.y, zz.y));
        *reinterpret_cast<uint16_t*>(scv + (16 * t + g + 8 * hf) * CV_PITCH + col) =
            (uint16_t)(q0 | q1 << 8);
      }
    }
  }
  __syncthreads();

  // The pool: pooled (ph, pw) is the max over conv rows 2ph-1..2ph+1 and
  // columns 2pw-1..2pw+1; row or column -1 is the -128 pad, which no code is
  // below, so it is skipped. A thread takes 16 channels of a pooled position.
  const int h4 = h / 4, w4 = w / 4;
  for (int i = tid; i < P * Q * 4; i += THREADS) {
    const int pr = i / (Q * 4), pc = i / 4 % Q, cg = i & 3;
    const int ph = ph0 + pr, pw = pw0 + pc;
    if (ph >= h4 || pw >= w4) continue;
    uint4 mx = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int r = 2 * pr + d;
      if (ph0 == 0 && r == 0) continue;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int c = 2 * pc + e;
        if (pw0 == 0 && c == 0) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(scv + (r * C + c) * CV_PITCH + 16 * cg);
        mx.x = __vmaxs4(mx.x, v.x);
        mx.y = __vmaxs4(mx.y, v.y);
        mx.z = __vmaxs4(mx.z, v.z);
        mx.w = __vmaxs4(mx.w, v.w);
      }
    }
    *reinterpret_cast<uint4*>(out + (((size_t)img * h4 + ph) * w4 + pw) * 64 + 16 * cg) = mx;
  }
}

}  // namespace

extern "C" {

// The stem on x (n, h, w, 3) float32, h and w divisible by 4: w (4, 4, 12,
// 64) int8 HWIO, m and z (64,) float32, scale () float32, all on the device
// -> out (n, h/4, w/4, 64) int8.
int qstem_run(const float* x, const int8_t* w, const float* m, const float* z,
              const float* scale, int8_t* out, int n, int h, int wd, void* stream_ptr) {
  using namespace stem;
  if (n < 1 || h < 4 || wd < 4 || h % 4 || wd % 4 || (long long)h * wd * 3 >= (1LL << 31))
    return cudaErrorInvalidValue;
  const long long tiles_y = (h / 4 + P - 1) / P, tiles_x = (wd / 4 + Q - 1) / Q;
  const long long grid = n * tiles_y * tiles_x;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  static unsigned long long configured = 0;  // bit d: the attribute is set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  stem_kernel<<<(unsigned)grid, THREADS, SMEM, (cudaStream_t)stream_ptr>>>(
      x, w, m, z, scale, out, h, wd, (int)tiles_y, (int)tiles_x);
  return cudaGetLastError();
}

}  // extern "C"
