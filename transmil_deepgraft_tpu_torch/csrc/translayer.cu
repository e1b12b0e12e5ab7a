// Projections of the fused pre-norm Nystrom TransLayer (inference) for
// Hopper, float32 in and out.
//
// Replaces, with the landmark kernels of csrc/nystrom.cu, the two Pallas TPU
// kernels of transmil_deepgraft_tpu/ops/pallas/translayer_kernel.py:
//   translayer_k1 <- _k1: LayerNorm -> K, V = LN(x) W_k^T, LN(x) W_v^T
//                   -> attn3_v = softmax(q_lm K^T) V per head; V written out
//                   for the 33-tap value-residual conv.
//   translayer_k2 <- _k2: LayerNorm -> Q = LN(x) W_q^T * d^-1/2
//                   -> per head softmax(Q k_lm^T) B -> + res -> W_out + b_out + x.
// Each wrapper (ops/translayer_kernel.py) is a sequence of launches:
//   K1: translayer_kv_projection (LN statistics, the weight's split, [K|V]
//       into front-padded buffers), then nystrom_landmark_attn (B5's kernel)
//       over the n_pad + n keys, read through (batch, head, row) strides.
//   K2: translayer_q_projection (LN statistics, split, Q scaled by d^-1/2),
//       nystrom_query_lm (B6's kernel) writing O as (b, n, 512), then
//       translayer_out_projection ((O + res) W_out^T + b_out + x).
//
// Shapes are fixed to the model the repository ships: D = 512, 8 heads of 64,
// 256 landmarks. x is the UNPADDED layer input (b, rows, 512); the n_pad rows
// the layer front-pads are zeros AFTER LayerNorm (the reference's XLA path):
// as keys they score 0 and carry V = 0, so the wrapper zeroes the first n_pad
// rows of each batch of the K and V buffers and this file writes the rest.
//
// What bounds them on an H100: at the 40,960-tile request's layer (n = 65,537
// + 255 pad keys) K1 does 68.7 GFLOP of projection and 34.5 of attention, K2
// 34.4 each of Q, attention and out projection, against ~0.3-0.5 GB of
// traffic. Every product here and in nystrom.cu runs on the TF32 tensor cores
// with the 3xTF32 split (x = hi + lo, hi = x cut to TF32, lo = x - hi;
// a*b ~ lo*hi + hi*lo + hi*hi summed in float32), which keeps float32
// accuracy: 3 x 103 GFLOP over 495 TFLOP/s is 0.625 ms a kernel, the bound
// (on the float32 SIMT units the same work is 1.54 ms).
//
// What the design does about it:
// * one GEMM template, C[M, N] = A[M, 512] W^T with W the torch (out, in)
//   weight, on wgmma m64n256k8 TF32: both operands are K-major as they sit in
//   memory (the activation rows, the weight rows), which TF32 wgmma needs.
//   A block is two consumer warpgroups of 64 rows (BM = 128) by BN = 256
//   columns; K = 512 in 32 tiles of 16 floats (one 64-byte row, canonical
//   64-byte swizzle), streamed by cp.async through a 4-5-stage ring in
//   shared memory (40 or 48 KB a stage), one barrier a K tile.
// * A goes through registers (wgmma's A-from-registers form): each thread
//   loads its fragment from the raw tile, applies the prologue (LayerNorm
//   from per-row (mean, 1/std) that ln_stats_kernel wrote and per-column
//   (gamma, beta) staged in shared memory, or O + res), splits it into hi
//   and lo, and issues three wgmma a k-step against the weight's hi and lo
//   tiles. The products of one K tile run while the next tile's fragments
//   are prepared (two register sets; each warpgroup waits for the tile
//   before last), so the prologue and the barrier hide under the products.
//   The weight is split per call by split_kernel (1-2 MB): the optimizer
//   changes weights in place between validation calls, so no split is ever
//   cached.
// * epilogues from the accumulator registers: Q scaled by 1/8 (a power of
//   two, exact); [K|V] to the front-padded buffers (row m of batch m / n to
//   row n_pad + m % n); y = acc + b_out + x. The ragged last row tile is
//   zero-filled on load and masked on store.
// * offsets are 32-bit: the launchers refuse buffers of 2^31 floats or more.
// * K1's landmark attention sums at most 8 key tiles a split (the wrapper's
//   K1_SPLIT_TILES): the tensor cores truncate as they accumulate, and V's
//   columns carry the LayerNorm bias, so longer splits lose accuracy.
// What holds it (an H100, PERF.md): the GEMM reaches ~65% of the wgmma TF32
// rate for the LayerNorm modes and ~43% for the out projection. Without any
// load the loop's structure (a barrier and a wait a K tile) stays at ~75%;
// the rest is the L2 traffic of the weight's hi and lo tiles, which every
// row tile reads again, and the out projection's epilogue (x read, y
// written) with nothing to hide it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int DIM = 512;    // model width D (= heads * dim_head)
constexpr float LN_EPS = 1e-5f;
constexpr int THREADS = 256;

constexpr int BM = 128;          // rows a GEMM block: two warpgroups of 64
constexpr int BN = 256;          // columns a GEMM block (faster than 128 on the H100)
constexpr int BK = 16;           // floats a K tile: one 64-byte row, two k8 steps
constexpr int K_TILES = DIM / BK;
constexpr int ROW_BYTES = BK * 4;
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may take on sm_90

enum Mode { MODE_KV = 0, MODE_Q = 1, MODE_OUT = 2 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics, one warp a row: stats[2r] = mean, stats[2r+1] = 1/std.
__global__ void __launch_bounds__(THREADS) ln_stats_kernel(
    const float* __restrict__ x, float* __restrict__ stats, int rows) {
  int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * DIM);
  float4 v[4];
  for (int i = 0; i < 4; ++i) v[i] = xr[lane + 32 * i];
  float s = 0.f;
  for (int i = 0; i < 4; ++i) s += v[i].x + v[i].y + v[i].z + v[i].w;
  const float mu = warp_sum(s) * (1.f / DIM);
  float q = 0.f;
  for (int i = 0; i < 4; ++i) {
    const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
    q += a * a + b * b + c * c + d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) * (1.f / DIM) + LN_EPS);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

// x = hi + lo: hi is x cut to TF32 (its top 19 bits), lo the rest, which the
// tensor core cuts to TF32 in turn. |lo| < 2^-10 |x|, so the dropped lo*lo
// and lo's own cut are each below 2^-20 of the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A weight (count floats, a multiple of 4) -> its hi and lo parts.
__global__ void __launch_bounds__(THREADS) split_kernel(
    const float4* __restrict__ w, float4* __restrict__ hi, float4* __restrict__ lo, int n4) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const float4 v = w[i];
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
  lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(const uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(d[i][j]) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 64-byte rows in the
// canonical 64-byte swizzle: 8-row groups 512 bytes apart (SBO), LBO unused.
// The tile base is 1024-byte aligned; the second k8 step of a row (8 TF32
// values, 32 bytes) moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// Byte offset of 16-byte chunk c of row r in such a tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (r >> 3) * 512 + (r & 7) * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)

// D (64 x 256, float32) += A (64 x 8 TF32, registers) * B (256 x 8 TF32,
// shared memory, K-major). A fragment: warp w of the warpgroup, lane
// l = 4g + t, a[0] row 16w + g, column t; a[1] row +8; a[2], a[3] those rows
// at column t + 4. D fragment: register 4j + 2h + e holds row 16w + g + 8h,
// column 8j + 2t + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80),
        F8(88), F8(96), F8(104), F8(112), F8(120)
      : A4);
}

#undef F8
#undef A4

// ------------------------------------------------------------------ GEMM

struct GemmArgs {
  const float* a;      // (rows, 512): x (MODE_KV, MODE_Q) or O (MODE_OUT)
  const float* a2;     // MODE_OUT: res (rows, 512)
  const float* stats;  // MODE_KV, MODE_Q: (rows, 2) mean, 1/std
  const float* ln_w;   // MODE_KV, MODE_Q: (512,)
  const float* ln_b;
  const float* w;      // (2, n_out, 512): the weight's hi, then its lo
  const float* bias;   // MODE_OUT: b_out (512,)
  const float* resid;  // MODE_OUT: x (rows, 512)
  float* out;          // (rows, 512); MODE_KV: the K buffer (batch, n_pad + seq, 512)
  float* out2;         // MODE_KV: the V buffer, as the K buffer
  int rows, n_out;     // M = batch * seq, N
  int seq, n_pad;      // MODE_KV: rows of a batch, its front pad
  float alpha;         // MODE_Q: the scale of Q
};

// A ring stage: the A tile (two for MODE_OUT: O and res), then the weight's
// hi and lo tiles, each rows of 64 bytes, 1024-byte aligned. After the ring
// come the LayerNorm's (gamma, beta) pairs.
template <int MODE>
struct Tiling {
  static constexpr int A_TILES = MODE == MODE_OUT ? 2 : 1;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int B_OFF = A_TILES * A_BYTES;
  static constexpr int STAGE = B_OFF + 2 * B_BYTES;
  static constexpr int LN_BYTES = MODE == MODE_OUT ? 0 : DIM * 8;
  static constexpr int STAGES = (SMEM_MAX - 1024 - LN_BYTES) / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + LN_BYTES;
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "tiling");
};

// One BM x BN output tile a block: tile t is N tile t % (n_out / BN) of M
// tile t / (n_out / BN), so the blocks that share an A tile run together.
// K tile kt's products are issued, then (while they run) the warpgroup waits
// only for kt - 1's, the block frees kt - 1's stage for a new load, and the
// A fragments of kt + 1 are prepared in the other register set.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const GemmArgs p) {
  using T = Tiling<MODE>;
  constexpr int S = T::STAGES;
  constexpr bool LN = MODE != MODE_OUT;
  static_assert(K_TILES % 2 == 0, "the K loop takes two tiles a turn");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (ring - raw);
  float2* lnp = reinterpret_cast<float2*>(sm + S * T::STAGE);

  const int tid = threadIdx.x;
  const int ntiles = p.n_out / BN;
  const int m0 = (int)(blockIdx.x / ntiles) * BM, n0 = (int)(blockIdx.x % ntiles) * BN;

  // The loader: this thread copies chunk lc of tile rows lr + 64 i; those
  // rows share (r & 7), so their swizzled offsets are soff + i * 4096.
  const int lc = tid & 3, lr = tid >> 2;
  const uint32_t soff = swizzled(lr, lc);
  const float* w_hi = p.w + (size_t)n0 * DIM;
  const float* w_lo = w_hi + (size_t)p.n_out * DIM;
  auto load = [&](int kt) {
    const uint32_t stage = ring + (kt % S) * T::STAGE + soff;
    const int k = kt * BK + lc * 4;
#pragma unroll
    for (int i = 0; i < BM / 64; ++i) {
      const int row = m0 + lr + 64 * i;
      const bool ok = row < p.rows;
      const int off = ok ? row * DIM + k : 0;
      cp_async16(stage + i * 4096, p.a + off, ok);
      if constexpr (MODE == MODE_OUT) cp_async16(stage + T::A_BYTES + i * 4096, p.a2 + off, ok);
    }
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      const int off = (lr + 64 * j) * DIM + k;
      cp_async16(stage + T::B_OFF + j * 4096, w_hi + off, true);
      cp_async16(stage + T::B_OFF + T::B_BYTES + j * 4096, w_lo + off, true);
    }
  };

#pragma unroll
  for (int kt = 0; kt < S - 1; ++kt) {
    load(kt);
    cp_async_commit();
  }
  if constexpr (LN) {
    for (int c = tid; c < DIM; c += THREADS) lnp[c] = make_float2(p.ln_w[c], p.ln_b[c]);
  }

  // This thread's fragment rows (tile-local): ra and ra + 8, which share
  // their swizzle phase sw.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + warp * 16 + g, sw = (g >> 1) & 3;
  float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;
  if constexpr (LN) {
    if (m0 + ra < p.rows) {
      const float2 s = *reinterpret_cast<const float2*>(p.stats + 2 * (m0 + ra));
      mu0 = s.x;
      rs0 = s.y;
    }
    if (m0 + ra + 8 < p.rows) {
      const float2 s = *reinterpret_cast<const float2*>(p.stats + 2 * (m0 + ra + 8));
      mu1 = s.x;
      rs1 = s.y;
    }
  }

  // K tile kt's A fragments: the prologue applied, split into hi and lo.
  auto prep = [&](int kt, uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
    const float* a_rows =
        reinterpret_cast<const float*>(sm + (kt % S) * T::STAGE) + (ra >> 3) * 128 + g * 16;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // columns ks*8 + t (chunk 2ks) and ks*8 + t + 4 (chunk 2ks + 1) of rows ra, ra + 8
      const int c0 = ((2 * ks) ^ sw) * 4 + t, c1 = ((2 * ks + 1) ^ sw) * 4 + t;
      float v[4] = {a_rows[c0], a_rows[128 + c0], a_rows[c1], a_rows[128 + c1]};
      if constexpr (MODE == MODE_OUT) {
        const float* r_rows = a_rows + T::A_BYTES / 4;
        v[0] += r_rows[c0];
        v[1] += r_rows[128 + c0];
        v[2] += r_rows[c1];
        v[3] += r_rows[128 + c1];
      } else {
        const float2 gb0 = lnp[kt * BK + ks * 8 + t], gb1 = lnp[kt * BK + ks * 8 + t + 4];
        v[0] = fmaf((v[0] - mu0) * rs0, gb0.x, gb0.y);
        v[1] = fmaf((v[1] - mu1) * rs1, gb0.x, gb0.y);
        v[2] = fmaf((v[2] - mu0) * rs0, gb1.x, gb1.y);
        v[3] = fmaf((v[3] - mu1) * rs1, gb1.x, gb1.y);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[ks][i], al[ks][i]);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // One K tile: issue its products (the two small terms first, then hi * hi);
  // wait for the last tile's; free its stage for tile kt + S - 1; prepare
  // tile kt + 1's fragments in the other set while tile kt's products run.
  auto step = [&](int kt, const uint32_t (&ah)[2][4], const uint32_t (&al)[2][4],
                  uint32_t (&nh)[2][4], uint32_t (&nl)[2][4]) {
    const uint32_t b_hi = ring + (kt % S) * T::STAGE + T::B_OFF, b_lo = b_hi + T::B_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      wgmma_tf32(acc, al[ks], smem_desc(b_hi + 32 * ks));
      wgmma_tf32(acc, ah[ks], smem_desc(b_lo + 32 * ks));
      wgmma_tf32(acc, ah[ks], smem_desc(b_hi + 32 * ks));
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products are done: nh, nl and its stage are free
    fence_regs(nh);
    fence_regs(nl);
    cp_async_wait<S - 3>();  // this thread's copies of tile kt + 1 are in
    __syncthreads();         // ... everyone's; every warpgroup is done with tile kt - 1
    if (kt + S - 1 < K_TILES) load(kt + S - 1);
    cp_async_commit();
    if (kt + 1 < K_TILES) prep(kt + 1, nh, nl);
  };

  uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
  cp_async_wait<S - 2>();
  __syncthreads();  // tile 0 and the (gamma, beta) pairs are in
  prep(0, ah0, al0);
  for (int kt = 0; kt < K_TILES; kt += 2) {
    step(kt, ah0, al0, ah1, al1);
    step(kt + 1, ah1, al1, ah0, al0);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  // Epilogue from the fragments: rows ra (h = 0) and ra + 8 (h = 1),
  // columns 8j + 2t, +1.
  float* dst = p.out;
  int col0 = n0;
  if constexpr (MODE == MODE_KV) {
    if (n0 >= DIM) {  // BN divides 512: a tile lies in K or in V
      dst = p.out2;
      col0 = n0 - DIM;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + ra + 8 * h;
    if (m >= p.rows) continue;
    int orow = m;
    if constexpr (MODE == MODE_KV) orow = (m / p.seq) * (p.seq + p.n_pad) + p.n_pad + m % p.seq;
    float* o = dst + orow * DIM + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if constexpr (MODE == MODE_Q) {
        v.x *= p.alpha;
        v.y *= p.alpha;
      } else if constexpr (MODE == MODE_OUT) {
        const int c = col0 + 8 * j + 2 * t;
        const float2 bo = *reinterpret_cast<const float2*>(p.bias + c);
        const float2 xo = *reinterpret_cast<const float2*>(p.resid + m * DIM + c);
        v.x += bo.x + xo.x;
        v.y += bo.y + xo.y;
      }
      *reinterpret_cast<float2*>(o + 8 * j) = v;
    }
  }
}

// ------------------------------------------------------------------ host

// Raise the kernel's dynamic shared memory limit once per device (bit dev of
// done), not on every launch.
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int MODE>
cudaError_t gemm(const GemmArgs& p, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem((const void*)gemm_kernel<MODE>, Tiling<MODE>::SMEM, ready);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + BM - 1) / BM * (p.n_out / BN);
  gemm_kernel<MODE><<<blocks, THREADS, Tiling<MODE>::SMEM, s>>>(p);
  return cudaGetLastError();
}

// The LayerNorm statistics of x (rows, 512) and the split of the (n_out, 512)
// weight w into w_split (2, n_out, 512).
cudaError_t prologue(const float* x, float* stats, int rows, const float* w, float* w_split,
                     int n_out, cudaStream_t s) {
  if (x) {
    ln_stats_kernel<<<(rows + 7) / 8, THREADS, 0, s>>>(x, stats, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n4 = n_out * DIM / 4;
  split_kernel<<<(n4 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(w_split),
      reinterpret_cast<float4*>(w_split + n_out * DIM), n4);
  return cudaGetLastError();
}

constexpr long long OFFSET_LIMIT = 1LL << 31;  // floats a buffer may hold (32-bit offsets)

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1's projection: x (batch, seq, 512) -> K and V (batch, n_pad + seq, 512)
// each, rows n_pad.. of each batch (the caller zeroes the first n_pad).
// Scratch: w_split (2, 1024, 512), stats (batch * seq, 2).
int translayer_kv_projection(const float* x, const float* ln_w, const float* ln_b,
                             const float* w_kv, float* w_split, float* stats, float* k_pad,
                             float* v_pad, int batch, int seq, int n_pad, void* stream) {
  if (batch < 1 || seq < 1 || n_pad < 0 ||
      (long long)batch * (seq + n_pad) * DIM >= OFFSET_LIMIT)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * seq;
  cudaError_t err = prologue(x, stats, rows, w_kv, w_split, 2 * DIM, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = {};
  p.a = x, p.stats = stats, p.ln_w = ln_w, p.ln_b = ln_b, p.w = w_split;
  p.out = k_pad, p.out2 = v_pad, p.rows = rows, p.n_out = 2 * DIM, p.seq = seq, p.n_pad = n_pad;
  return gemm<MODE_KV>(p, s);
}

// K2's first projection: q (rows, 512) = LN(x) W_q^T * scale.
// Scratch: w_split (2, 512, 512), stats (rows, 2).
int translayer_q_projection(const float* x, const float* ln_w, const float* ln_b,
                            const float* w_q, float* w_split, float* stats, float* q, int rows,
                            float scale, void* stream) {
  if (rows < 1 || (long long)rows * DIM >= OFFSET_LIMIT) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prologue(x, stats, rows, w_q, w_split, DIM, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = {};
  p.a = x, p.stats = stats, p.ln_w = ln_w, p.ln_b = ln_b, p.w = w_split, p.out = q;
  p.rows = rows, p.n_out = DIM, p.alpha = scale;
  return gemm<MODE_Q>(p, s);
}

// K2's out projection: y (rows, 512) = (o + res) W_out^T + b_out + x.
// Scratch: w_split (2, 512, 512).
int translayer_out_projection(const float* o, const float* res, const float* x,
                              const float* w_out, float* w_split, const float* b_out, float* y,
                              int rows, void* stream) {
  if (rows < 1 || (long long)rows * DIM >= OFFSET_LIMIT) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prologue(nullptr, nullptr, rows, w_out, w_split, DIM, s);
  if (err != cudaSuccess) return err;
  GemmArgs p = {};
  p.a = o, p.a2 = res, p.w = w_split, p.bias = b_out, p.resid = x, p.out = y;
  p.rows = rows, p.n_out = DIM;
  return gemm<MODE_OUT>(p, s);
}

}  // extern "C"
