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
//
// Both launchers run one kernel, conv_i8_kernel, once per convolution: an
// implicit GEMM over NHWC int8 codes, rows = output pixels, K = taps * Cin in
// (di, dj, ci) order, N = Cout, with the weights as (K, Cout) row-major (the
// layout of _pack_block). Accumulation is exact int32 on the tensor cores
// (mma.sync m16n8k32 s8.s8.s32). A 3x3 tap that falls outside the image reads
// the code -128 (x = 0). Epilogues, each rounding where XLA:CPU rounds (it
// contracts acc * m + z into one fma; the residual sum into
// fma(acc3, m3, idn) + z3), spelled with __fmaf_rn / __fmul_rn / __fadd_rn so
// that nvcc contracts nothing else:
//   requant   q = clip(rint(fma(float(acc), m, z)), -128, 127)
//   scale     d = float(acc) * md                     (downsample, to scratch)
//   identity  q = clip(rint(fma(float(acc3), m3, float(x) * id_mult) + z3))
//   dsres     q = clip(rint(fma(float(acc3), m3, d) + z3))
// Intermediates (conv1 and conv2 codes, the downsample term, the activations
// between blocks) live in device scratch that the Python wrapper allocates.
//
// What bounds them on an H100: a 128-tile chunk is 0.51 TMAC of int8 work
// (0.51 ms at the 1,979 TOP/s dense int8 rate) against 0.6 GB of least
// traffic (0.18 ms at 3.35 TB/s): operations. What this first design does
// about it: 128 x BN x 64 tiles (BN 64 or 128) staged through shared memory
// with a register prefetch of the next K tile, 8 warps of mma.sync. Not done
// yet (the TPU kernel keeps a tile's whole run on chip, which does not fit in
// 228 KB at 56x56x64, so the intermediates go through device memory here):
// wgmma, TMA, on-chip tiles with halos across a bottleneck, the downsample
// fused into conv3's epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows (pixels) a block
constexpr int BK = 64;       // K bytes a tile: one tap's 64 channels
constexpr int KW = BK / 4;   // 32-bit words of K a tile
constexpr int THREADS = 256;

enum Epi { EPI_REQUANT = 0, EPI_SCALE = 1, EPI_IDENTITY = 2, EPI_DSRES = 3 };

struct ConvArgs {
  const int8_t* x;       // (n, h, w, cin) NHWC codes
  const int8_t* wt;      // (taps * cin, cout) row-major
  const float* sc;       // (2, cout) [m; z]; EPI_SCALE: (1, cout) m
  int8_t* out_q;         // (rows, cout) codes
  float* out_f;          // (rows, cout), EPI_SCALE
  const int8_t* res_q;   // (rows, cout) identity codes, EPI_IDENTITY
  const float* res_f;    // (rows, cout) downsample term, EPI_DSRES
  const float* id_mult;  // () identity multiplier, EPI_IDENTITY
  int n, h, w, cin, ho, wo, cout;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t clip_round(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -128.f), 127.f);
}

// One convolution as an implicit GEMM. Block tile BM x BN output, K in BK
// steps; 8 warps as WM x WN, each a (BM/WM) x 32 tile of m16n8k32 products.
// Shared memory holds A and B as 32-bit words of 4 consecutive k:
// As[kw][row], Bs[kw][col] (the row stride padded by 8 words, so that the
// fragment loads hit 32 distinct banks).
template <int TAPS, int STRIDE, int BN, int EPI>
__global__ void __launch_bounds__(THREADS) conv_i8_kernel(const ConvArgs a) {
  constexpr int WM = (BN == 128) ? 2 : 4;
  constexpr int WN = 8 / WM;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int MT = WTM / 16;
  constexpr int NT = WTN / 8;
  constexpr int PAD = (TAPS == 9) ? 1 : 0;
  constexpr int SA = BM + 8;
  constexpr int SB = BN + 8;
  constexpr int B_BLOCKS = (KW * BN / 4) / THREADS;  // 4x4-byte B blocks a thread

  __shared__ __align__(16) uint32_t As[2][KW][SA];
  __shared__ __align__(16) uint32_t Bs[2][KW][SB];

  const int tid = threadIdx.x;
  const int rows = a.n * a.ho * a.wo;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = TAPS * a.cin / BK;

  // The two A chunks (16 bytes each) this thread loads every K tile: row
  // r = c % BM of the tile, bytes 16 * (c / BM) of the tile's 64.
  int a_img[2], a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = tid + THREADS * r;
    const int row = m0 + (c % BM);
    a_ok[r] = row < rows;
    const int rr = a_ok[r] ? row : 0;
    const int img = rr / (a.ho * a.wo);
    const int rem = rr - img * a.ho * a.wo;
    const int oh = rem / a.wo, ow = rem - (rem / a.wo) * a.wo;
    a_img[r] = img;
    a_ih[r] = oh * STRIDE - PAD;
    a_iw[r] = ow * STRIDE - PAD;
  }

  uint4 a_reg[2];
  uint32_t b_reg[B_BLOCKS][4];

  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / a.cin;
    const int c0 = k0 - tap * a.cin;
    const int di = tap / 3, dj = tap - (tap / 3) * 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = (tid + THREADS * r) / BM;
      const int ih = a_ih[r] + di, iw = a_iw[r] + dj;
      if (!a_ok[r]) {
        a_reg[r] = make_uint4(0u, 0u, 0u, 0u);
      } else if (ih < 0 || ih >= a.h || iw < 0 || iw >= a.w) {
        a_reg[r] = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      } else {
        const size_t off = ((size_t)(a_img[r] * a.h + ih) * a.w + iw) * a.cin + c0 + 16 * q;
        a_reg[r] = *reinterpret_cast<const uint4*>(a.x + off);
      }
    }
#pragma unroll
    for (int i = 0; i < B_BLOCKS; ++i) {
      const int blk = tid + THREADS * i;
      const int g = blk / (BN / 4), j = blk - (blk / (BN / 4)) * (BN / 4);
      const int8_t* src = a.wt + (size_t)(k0 + 4 * g) * a.cout + n0 + 4 * j;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        b_reg[i][t] = *reinterpret_cast<const uint32_t*>(src + (size_t)t * a.cout);
    }
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + THREADS * r;
      const int row = c % BM, q = c / BM;
      As[buf][4 * q + 0][row] = a_reg[r].x;
      As[buf][4 * q + 1][row] = a_reg[r].y;
      As[buf][4 * q + 2][row] = a_reg[r].z;
      As[buf][4 * q + 3][row] = a_reg[r].w;
    }
#pragma unroll
    for (int i = 0; i < B_BLOCKS; ++i) {
      const int blk = tid + THREADS * i;
      const int g = blk / (BN / 4), j = blk - (blk / (BN / 4)) * (BN / 4);
      // b_reg[i][t] holds k = 4g + t, cols 4j..4j+3: transpose the 4x4 bytes
      // into one word of 4 k a column.
      const uint32_t lo01 = __byte_perm(b_reg[i][0], b_reg[i][1], 0x5140);
      const uint32_t lo23 = __byte_perm(b_reg[i][2], b_reg[i][3], 0x5140);
      const uint32_t hi01 = __byte_perm(b_reg[i][0], b_reg[i][1], 0x7362);
      const uint32_t hi23 = __byte_perm(b_reg[i][2], b_reg[i][3], 0x7362);
      uint4 v;
      v.x = __byte_perm(lo01, lo23, 0x5410);
      v.y = __byte_perm(lo01, lo23, 0x7632);
      v.z = __byte_perm(hi01, hi23, 0x5410);
      v.w = __byte_perm(hi01, hi23, 0x7632);
      *reinterpret_cast<uint4*>(&Bs[buf][g][4 * j]) = v;
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_tile(0);
  store_tile(0);
  __syncthreads();
  int buf = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1);
#pragma unroll
    for (int ks = 0; ks < KW / 8; ++ks) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WTM + i * 16 + gid;
        af[i][0] = As[buf][ks * 8 + tig][r];
        af[i][1] = As[buf][ks * 8 + tig][r + 8];
        af[i][2] = As[buf][ks * 8 + 4 + tig][r];
        af[i][3] = As[buf][ks * 8 + 4 + tig][r + 8];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * WTN + j * 8 + gid;
        bf[j][0] = Bs[buf][ks * 8 + tig][c];
        bf[j][1] = Bs[buf][ks * 8 + 4 + tig][c];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < ktiles) store_tile(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // Epilogue: acc[i][j] = rows (gid, gid + 8) x cols (2 tig, 2 tig + 1) of
  // the (i, j) 16 x 8 product.
  const float id_mult = (EPI == EPI_IDENTITY) ? *a.id_mult : 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * WTN + j * 8 + 2 * tig;
    const float m_0 = a.sc[col], m_1 = a.sc[col + 1];
    float z_0 = 0.f, z_1 = 0.f;
    if (EPI != EPI_SCALE) {
      z_0 = a.sc[a.cout + col];
      z_1 = a.sc[a.cout + col + 1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WTM + i * 16 + gid + 8 * half;
        if (row >= rows) continue;
        const size_t off = (size_t)row * a.cout + col;
        const float v0 = __int2float_rn(acc[i][j][2 * half]);
        const float v1 = __int2float_rn(acc[i][j][2 * half + 1]);
        if (EPI == EPI_SCALE) {
          *reinterpret_cast<float2*>(a.out_f + off) =
              make_float2(__fmul_rn(v0, m_0), __fmul_rn(v1, m_1));
          continue;
        }
        float y0, y1;
        if (EPI == EPI_REQUANT) {
          y0 = __fmaf_rn(v0, m_0, z_0);
          y1 = __fmaf_rn(v1, m_1, z_1);
        } else {
          float d0, d1;
          if (EPI == EPI_IDENTITY) {
            const char2 x = *reinterpret_cast<const char2*>(a.res_q + off);
            d0 = __fmul_rn((float)x.x, id_mult);
            d1 = __fmul_rn((float)x.y, id_mult);
          } else {
            const float2 d = *reinterpret_cast<const float2*>(a.res_f + off);
            d0 = d.x;
            d1 = d.y;
          }
          y0 = __fadd_rn(__fmaf_rn(v0, m_0, d0), z_0);
          y1 = __fadd_rn(__fmaf_rn(v1, m_1, d1), z_1);
        }
        char2 q;
        q.x = clip_round(y0);
        q.y = clip_round(y1);
        *reinterpret_cast<char2*>(a.out_q + off) = q;
      }
    }
  }
}

template <int TAPS, int STRIDE, int EPI>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  if (a.cin % BK || a.cout % 64) return cudaErrorInvalidValue;
  const long long rows = (long long)a.n * a.ho * a.wo;
  const int bn = (a.cout % 128 == 0) ? 128 : 64;
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)(a.cout / bn));
  if (bn == 128)
    conv_i8_kernel<TAPS, STRIDE, 128, EPI><<<grid, THREADS, 0, stream>>>(a);
  else
    conv_i8_kernel<TAPS, STRIDE, 64, EPI><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// Operands and shapes of one convolution: input (n, h, w, cin), output
// (n, ho, wo, cout); the caller sets the epilogue's pointers.
ConvArgs conv_args(const int8_t* x, const int8_t* wt, const float* sc, int n, int h,
                   int w, int cin, int ho, int wo, int cout) {
  ConvArgs a = {};
  a.x = x;
  a.wt = wt;
  a.sc = sc;
  a.n = n;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.ho = ho;
  a.wo = wo;
  a.cout = cout;
  return a;
}

}  // namespace

extern "C" {

// One bottleneck's packed operands (ops/qstage_kernel._pack_block). wd/md are
// null for an identity block.
struct QBlockArgs {
  const int8_t* w1;  // (cin, cmid)
  const float* sc1;  // (2, cmid)
  const int8_t* w2;  // (9 * cmid, cmid)
  const float* sc2;  // (2, cmid)
  const int8_t* w3;  // (cmid, cout)
  const float* sc3;  // (2, cout)
  const int8_t* wd;  // (cin, cout) or null
  const float* md;   // (1, cout) or null
  const float* id_mult;  // () on the device; read by identity blocks only
  int cin, cmid, cout;
};

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// B7: stride-1 blocks on x (n, h, w, blocks[0].cin) -> out (n, h, w, last cout).
// Scratch: h1, h2 (n*h*w*max cmid), act0/act1 (n*h*w*max cout; may be null for
// one block), ds (n*h*w*max cout floats; may be null without a downsample).
int qstage_run(const int8_t* x, int8_t* out, int8_t* h1, int8_t* h2, int8_t* act0,
               int8_t* act1, float* ds, const QBlockArgs* blocks, int nblocks, int n,
               int h, int w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int8_t* acts[2] = {act0, act1};
  const int8_t* in = x;
  for (int i = 0; i < nblocks; ++i) {
    const QBlockArgs& b = blocks[i];
    int8_t* dst = (i == nblocks - 1) ? out : acts[i % 2];
    ConvArgs c1 = conv_args(in, b.w1, b.sc1, n, h, w, b.cin, h, w, b.cmid);
    c1.out_q = h1;
    cudaError_t err = launch_conv<1, 1, EPI_REQUANT>(c1, stream);
    if (err != cudaSuccess) return err;
    ConvArgs c2 = conv_args(h1, b.w2, b.sc2, n, h, w, b.cmid, h, w, b.cmid);
    c2.out_q = h2;
    err = launch_conv<9, 1, EPI_REQUANT>(c2, stream);
    if (err != cudaSuccess) return err;
    ConvArgs c3 = conv_args(h2, b.w3, b.sc3, n, h, w, b.cmid, h, w, b.cout);
    c3.out_q = dst;
    if (b.wd) {
      ConvArgs cd = conv_args(in, b.wd, b.md, n, h, w, b.cin, h, w, b.cout);
      cd.out_f = ds;
      err = launch_conv<1, 1, EPI_SCALE>(cd, stream);
      if (err != cudaSuccess) return err;
      c3.res_f = ds;
      err = launch_conv<1, 1, EPI_DSRES>(c3, stream);
    } else {
      c3.res_q = in;
      c3.id_mult = b.id_mult;
      err = launch_conv<1, 1, EPI_IDENTITY>(c3, stream);
    }
    if (err != cudaSuccess) return err;
    in = dst;
  }
  return cudaSuccess;
}

// B8: one stride-2 block with downsample on x (n, h, w, cin), h and w even ->
// out (n, h/2, w/2, cout). Scratch: h1 (n*h*w*cmid), h2 (n*h/2*w/2*cmid),
// ds (n*h/2*w/2*cout floats).
int qentry_run(const int8_t* x, int8_t* out, int8_t* h1, int8_t* h2, float* ds,
               const QBlockArgs* blk, int n, int h, int w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const QBlockArgs& b = *blk;
  if (!b.wd || (h % 2) || (w % 2)) return cudaErrorInvalidValue;
  const int ho = h / 2, wo = w / 2;
  cudaError_t err;
  ConvArgs c1 = conv_args(x, b.w1, b.sc1, n, h, w, b.cin, h, w, b.cmid);
  c1.out_q = h1;
  err = launch_conv<1, 1, EPI_REQUANT>(c1, stream);
  if (err != cudaSuccess) return err;
  ConvArgs c2 = conv_args(h1, b.w2, b.sc2, n, h, w, b.cmid, ho, wo, b.cmid);
  c2.out_q = h2;
  err = launch_conv<9, 2, EPI_REQUANT>(c2, stream);
  if (err != cudaSuccess) return err;
  ConvArgs cd = conv_args(x, b.wd, b.md, n, h, w, b.cin, ho, wo, b.cout);
  cd.out_f = ds;
  err = launch_conv<1, 2, EPI_SCALE>(cd, stream);
  if (err != cudaSuccess) return err;
  ConvArgs c3 = conv_args(h2, b.w3, b.sc3, n, ho, wo, b.cmid, ho, wo, b.cout);
  c3.out_q = out;
  c3.res_f = ds;
  return launch_conv<1, 1, EPI_DSRES>(c3, stream);
}

}  // extern "C"
