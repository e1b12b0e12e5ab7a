// Fused pre-norm Nystrom TransLayer (inference) for Hopper, float32.
//
// Replaces the two Pallas TPU kernels of
// transmil_deepgraft_tpu/ops/pallas/translayer_kernel.py:
//   translayer_k1 <- _k1: stream x -> LayerNorm -> K, V = LN(x) W_k^T, LN(x) W_v^T
//                   -> attn3_v = softmax(q_lm K^T) V per head (online softmax),
//                   and V written out for the 33-tap value-residual conv.
//   translayer_k2 <- _k2: stream x -> LayerNorm -> Q = LN(x) W_q^T * d^-1/2
//                   -> per head softmax(Q k_lm^T) B -> + res -> W_out + b_out + x.
//
// Shapes are fixed to the model the repository ships: D = 512, 8 heads of 64,
// 256 landmarks. x is the UNPADDED layer input (b, rows, 512); the n_pad rows
// the layer front-pads are zeros AFTER LayerNorm (the reference's XLA path):
// as keys they score 0 and carry V = 0, which K1 adds analytically in its
// combine pass, and as queries they are dropped, so K2 never sees them.
//
// What bounds them on an H100: both do ~1.0e11 float32 operations at the
// 40,960-tile request (n = 65,792) against ~0.3-0.4 GB of traffic, so they are
// bound by the 67 TFLOP/s float32 rate (~1.5 ms each), not by memory.
// What this first design does about it: register-tiled SIMT float32 (8x8
// outputs a thread, operands staged through shared memory), no tensor cores.
// K1 runs as a LayerNorm-statistics pass, a projection GEMM that writes K and V
// to device memory (the TPU kernel keeps K on chip: n*512*4 bytes written and
// read again here), a split-over-n attention pass (1,024 keys a block, so that
// b*8*ceil(n/1024) blocks fill the 132 SMs) and a combine pass. K2 is one
// kernel over 32-row blocks that keeps LN(x), Q, the scores and the
// attention output in 161 KB of dynamic shared memory and streams W_q, k_lm,
// B and W_out through it. wgmma/TMA (TF32 or bf16) is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DIM = 512;    // model width D (= heads * dim_head)
constexpr int HEADS = 8;
constexpr int DHEAD = 64;
constexpr int LM = 256;     // landmarks
constexpr float LN_EPS = 1e-5f;
constexpr int THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Mean and 1/std of a 512-wide row held by one warp as 4 float4 a lane.
__device__ __forceinline__ void row_stats(const float4 (&v)[4], float& mu, float& rstd) {
  float s = 0.f;
  for (int i = 0; i < 4; ++i) s += v[i].x + v[i].y + v[i].z + v[i].w;
  mu = warp_sum(s) * (1.f / DIM);
  float q = 0.f;
  for (int i = 0; i < 4; ++i) {
    float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
    q += a * a + b * b + c * c + d * d;
  }
  rstd = rsqrtf(warp_sum(q) * (1.f / DIM) + LN_EPS);
}

// ---------------------------------------------------------------- K1 pieces

// LayerNorm statistics, one warp a row: stats[2r] = mean, stats[2r+1] = 1/std.
__global__ void __launch_bounds__(THREADS) ln_stats_kernel(
    const float* __restrict__ x, float* __restrict__ stats, int rows) {
  int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * DIM);
  float4 v[4];
  for (int i = 0; i < 4; ++i) v[i] = xr[lane + 32 * i];
  float mu, rstd;
  row_stats(v, mu, rstd);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

// [K | V] = LN(x) W_kv^T over all b*rows real rows. W_kv is (1024, 512), the
// K and V rows of to_qkv.weight. 128x128 output tile a block, 8 deep k steps,
// each thread 8x8 outputs. LN is applied while the x tile is staged.
constexpr int GBM = 128, GBN = 128, GBK = 8;

__global__ void __launch_bounds__(THREADS) kv_proj_kernel(
    const float* __restrict__ x, const float* __restrict__ stats,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const float* __restrict__ w_kv, float* __restrict__ k_out,
    float* __restrict__ v_out, int rows) {
  __shared__ __align__(16) float As[GBK][GBM];
  __shared__ __align__(16) float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * GBM, col0 = blockIdx.y * GBN;
  const int lr = tid >> 1, lk = (tid & 1) * 4;  // loader: one row, 4 of the 8 k
  const int arow = row0 + lr;
  const bool avalid = arow < rows;
  float mu = 0.f, rs = 0.f;
  if (avalid) {
    mu = stats[2 * arow];
    rs = stats[2 * arow + 1];
  }
  const float* aptr = x + (size_t)(avalid ? arow : 0) * DIM + lk;
  const float* bptr = w_kv + (size_t)(col0 + lr) * DIM + lk;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < DIM; k0 += GBK) {
    float4 a = *reinterpret_cast<const float4*>(aptr + k0);
    float4 g = *reinterpret_cast<const float4*>(ln_w + k0 + lk);
    float4 bb = *reinterpret_cast<const float4*>(ln_b + k0 + lk);
    float4 w = *reinterpret_cast<const float4*>(bptr + k0);
    As[lk + 0][lr] = avalid ? (a.x - mu) * rs * g.x + bb.x : 0.f;
    As[lk + 1][lr] = avalid ? (a.y - mu) * rs * g.y + bb.y : 0.f;
    As[lk + 2][lr] = avalid ? (a.z - mu) * rs * g.z + bb.z : 0.f;
    As[lk + 3][lr] = avalid ? (a.w - mu) * rs * g.w + bb.w : 0.f;
    Bs[lk + 0][lr] = w.x;
    Bs[lk + 1][lr] = w.y;
    Bs[lk + 2][lr] = w.z;
    Bs[lk + 3][lr] = w.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }

  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= rows) continue;
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + half * 64 + tx * 4;  // a 128-column tile never straddles K|V
      float* dst = c < DIM ? k_out + (size_t)r * DIM + c : v_out + (size_t)r * DIM + (c - DIM);
      *reinterpret_cast<float4*>(dst) = make_float4(
          acc[i][half * 4 + 0], acc[i][half * 4 + 1], acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
    }
  }
}

// Landmark attention over one chunk of keys for one (batch, head): online
// softmax of q_lm K^T over the chunk, accumulating P V. Writes the chunk's
// running max m, sum l and unnormalised accumulator for the combine pass.
constexpr int ACH = 1024;  // keys a block
constexpr int AT = 64;     // keys a shared-memory tile
constexpr int KT_LD = AT + 1;  // padded row of the transposed K tile
constexpr size_t ATTN_SMEM =
    sizeof(float) * (DHEAD * LM + DHEAD * KT_LD + AT * DHEAD + AT * LM);

__global__ void __launch_bounds__(THREADS, 1) lm_attn_partial_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ q_lm, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int rows, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  float* QT = smem;                 // [DHEAD][LM]  q_lm transposed
  float* KT = QT + DHEAD * LM;      // [DHEAD][KT_LD] key tile transposed
  float* Vs = KT + DHEAD * KT_LD;   // [AT][DHEAD]
  float* PT = Vs + AT * DHEAD;      // [AT][LM]     probabilities transposed
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * HEADS + h;

  const float* q = q_lm + bh * LM * DHEAD;
  for (int i = tid; i < LM * DHEAD / 4; i += THREADS) {
    const int r = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
    const float4 t = *reinterpret_cast<const float4*>(q + r * DHEAD + c4);
    QT[(c4 + 0) * LM + r] = t.x;
    QT[(c4 + 1) * LM + r] = t.y;
    QT[(c4 + 2) * LM + r] = t.z;
    QT[(c4 + 3) * LM + r] = t.w;
  }

  const int ty = tid >> 3;  // landmark rows ty*8 .. ty*8+7
  const int tx = tid & 7;   // keys (and value columns) tx + 8j
  float m_run[8], l_run[8], acc[8][8];
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -1e30f;
    l_run[i] = 0.f;
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int key0 = chunk * ACH;
  const int key_end = min(key0 + ACH, rows);
  const float* kb = k + (size_t)b * rows * DIM + h * DHEAD;
  const float* vb = v + (size_t)b * rows * DIM + h * DHEAD;

  for (int t0 = key0; t0 < key_end; t0 += AT) {
    __syncthreads();  // QT is in; the last tile's KT/Vs/PT reads are done
    for (int i = tid; i < AT * DHEAD / 4; i += THREADS) {
      const int kr = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
      const int key = t0 + kr;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (key < key_end) {
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)key * DIM + c4);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)key * DIM + c4);
      }
      KT[(c4 + 0) * KT_LD + kr] = kv4.x;
      KT[(c4 + 1) * KT_LD + kr] = kv4.y;
      KT[(c4 + 2) * KT_LD + kr] = kv4.z;
      KT[(c4 + 3) * KT_LD + kr] = kv4.w;
      *reinterpret_cast<float4*>(Vs + kr * DHEAD + c4) = vv4;
    }
    __syncthreads();

    float s[8][8];
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHEAD; ++d) {
      const float4 q0 = *reinterpret_cast<const float4*>(QT + d * LM + ty * 8);
      const float4 q1 = *reinterpret_cast<const float4*>(QT + d * LM + ty * 8 + 4);
      const float qr[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float kr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kr[j] = KT[d * KT_LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qr[i] * kr[j];
    }
    for (int j = 0; j < 8; ++j)
      if (t0 + tx + 8 * j >= key_end)
        for (int i = 0; i < 8; ++i) s[i][j] = -INFINITY;

    // online softmax; the 8 lanes sharing ty hold one row's 64 keys
    for (int i = 0; i < 8; ++i) {
      float mx = s[i][0];
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float ps = 0.f;
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        ps += p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int j = 0; j < 8; ++j) {
      float* dst = PT + (tx + 8 * j) * LM + ty * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < AT; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(PT + kk * LM + ty * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(PT + kk * LM + ty * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vr[j] = Vs[kk * DHEAD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += pr[i] * vr[j];
    }
  }

  const size_t base = bh * nchunks + chunk;
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    float* dst = part_acc + (base * LM + row) * DHEAD;
    for (int j = 0; j < 8; ++j) dst[tx + 8 * j] = acc[i][j];
    if (tx == 0) {
      part_ml[(base * LM + row) * 2] = m_run[i];
      part_ml[(base * LM + row) * 2 + 1] = l_run[i];
    }
  }
}

// Combine the chunks of one (batch, head): attn3_v = sum_c e^(m_c-M) acc_c / L.
// The n_pad front-pad keys score exactly 0 and carry V = 0: they add
// n_pad * e^(0-M) to L and nothing to the accumulator.
__global__ void __launch_bounds__(THREADS) lm_attn_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int nchunks, int n_pad) {
  const int row = blockIdx.x * 4 + threadIdx.x / DHEAD;
  const int d = threadIdx.x % DHEAD;
  const size_t bh = (size_t)blockIdx.z * HEADS + blockIdx.y;
  float big = n_pad > 0 ? 0.f : -INFINITY;
  for (int c = 0; c < nchunks; ++c)
    big = fmaxf(big, part_ml[((bh * nchunks + c) * LM + row) * 2]);
  float l = n_pad > 0 ? (float)n_pad * expf(-big) : 0.f;
  float a = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const size_t idx = (bh * nchunks + c) * LM + row;
    const float w = expf(part_ml[idx * 2] - big);
    l += part_ml[idx * 2 + 1] * w;
    a += part_acc[idx * DHEAD + d] * w;
  }
  out[(bh * LM + row) * DHEAD + d] = a / l;
}

// ---------------------------------------------------------------- K2

constexpr int RB = 32;  // rows a block
constexpr int WK = 16;  // k depth of a streamed weight tile
// Padded row strides of the transposed tiles, so that the transposing stores
// of one warp spread over the banks (~2-way instead of 16- and 4-way).
constexpr int KLM_LD = LM + 1;   // k_lm^T [DHEAD][KLM_LD]
constexpr int WS_LD = DIM + 4;   // weight tile [WK][WS_LD]; keeps float4 rows aligned
constexpr int R0_FLOATS = DHEAD * KLM_LD;  // >= RB * DIM and LM * DHEAD
constexpr int R2_FLOATS = WK * WS_LD;      // >= RB * LM
constexpr size_t K2_SMEM = sizeof(float) * (R0_FLOATS + RB * DIM + R2_FLOATS);
static_assert(R0_FLOATS >= RB * DIM && R0_FLOATS >= LM * DHEAD, "R0 too small");
static_assert(R2_FLOATS >= RB * LM && R0_FLOATS % 4 == 0 && WS_LD % 4 == 0, "R2 layout");

// acc[i][j] = sum_k A[ty*8+i][k] * W[col(j)][k] for a 32x512 A in shared
// memory and a (512, 512) torch-layout (out, in) weight W in device memory,
// streamed through Ws as [WK][WS_LD] tiles. Thread (ty = tid/64, tx = tid%64)
// owns rows ty*8..+7 and columns tx*4..+3 and 256+tx*4..+3.
__device__ __forceinline__ void gemm_rows(const float* __restrict__ A,
                                          const float* __restrict__ W,
                                          float* __restrict__ Ws, float (&acc)[8][8],
                                          int tid) {
  const int ty = tid >> 6, tx = tid & 63;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < DIM; k0 += WK) {
    __syncthreads();  // the last tile's reads are done
    for (int it = 0; it < WK * DIM / 4 / THREADS; ++it) {
      const int i = tid + THREADS * it;
      const int n = i >> 2, kq = (i & 3) * 4;
      const float4 w4 = *reinterpret_cast<const float4*>(W + (size_t)n * DIM + k0 + kq);
      Ws[(kq + 0) * WS_LD + n] = w4.x;
      Ws[(kq + 1) * WS_LD + n] = w4.y;
      Ws[(kq + 2) * WS_LD + n] = w4.z;
      Ws[(kq + 3) * WS_LD + n] = w4.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < WK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * DIM + k0 + kk];
      const float4 b0 = *reinterpret_cast<const float4*>(Ws + kk * WS_LD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Ws + kk * WS_LD + 256 + tx * 4);
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * br[j];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) k2_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const float* __restrict__ w_q, const float* __restrict__ k_lm,
    const float* __restrict__ bmat, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ y, int rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* R0 = smem;            // [32][512] LN(x), then k_lm^T [64][KLM_LD], then B [256][64]
  float* R1 = R0 + R0_FLOATS;  // [32][512] Q, then attention + res
  float* R2 = R1 + RB * DIM;   // [16][WS_LD] weight tile, or [32][256] probabilities
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, row0 = blockIdx.x * RB;
  const float* xb = x + (size_t)b * rows * DIM;
  const float* rb = res + (size_t)b * rows * DIM;

  // 1. LayerNorm, one warp a row, 4 rows a warp
  for (int rr = 0; rr < RB / 8; ++rr) {
    const int r = warp * (RB / 8) + rr, gr = row0 + r;
    float4 v[4];
    if (gr < rows) {
      const float4* xr = reinterpret_cast<const float4*>(xb + (size_t)gr * DIM);
      for (int i = 0; i < 4; ++i) v[i] = xr[lane + 32 * i];
      float mu, rstd;
      row_stats(v, mu, rstd);
      for (int i = 0; i < 4; ++i) {
        const int c = (lane + 32 * i) * 4;
        const float4 g = *reinterpret_cast<const float4*>(ln_w + c);
        const float4 bb = *reinterpret_cast<const float4*>(ln_b + c);
        v[i] = make_float4((v[i].x - mu) * rstd * g.x + bb.x, (v[i].y - mu) * rstd * g.y + bb.y,
                           (v[i].z - mu) * rstd * g.z + bb.z, (v[i].w - mu) * rstd * g.w + bb.w);
      }
    } else {
      for (int i = 0; i < 4; ++i) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(R0 + r * DIM + (lane + 32 * i) * 4) = v[i];
  }

  // 2. Q = LN(x) W_q^T * scale -> R1
  const int ty = tid >> 6, tx = tid & 63;
  float acc[8][8];
  gemm_rows(R0, w_q, R2, acc, tid);
  for (int i = 0; i < 8; ++i) {
    float* dst = R1 + (ty * 8 + i) * DIM;
    *reinterpret_cast<float4*>(dst + tx * 4) = make_float4(
        acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale, acc[i][3] * scale);
    *reinterpret_cast<float4*>(dst + 256 + tx * 4) = make_float4(
        acc[i][4] * scale, acc[i][5] * scale, acc[i][6] * scale, acc[i][7] * scale);
  }
  __syncthreads();

  // 3. per head: softmax(Q_h k_lm_h^T) B_h + res_h -> R1's head columns.
  //    Warp w owns rows w*4 .. w*4+3; lane l owns keys l + 32j.
  for (int h = 0; h < HEADS; ++h) {
    const size_t bh = (size_t)b * HEADS + h;
    const float* kl = k_lm + bh * LM * DHEAD;
    for (int i = tid; i < LM * DHEAD / 4; i += THREADS) {
      const int key = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
      const float4 t = *reinterpret_cast<const float4*>(kl + key * DHEAD + c4);
      R0[(c4 + 0) * KLM_LD + key] = t.x;
      R0[(c4 + 1) * KLM_LD + key] = t.y;
      R0[(c4 + 2) * KLM_LD + key] = t.z;
      R0[(c4 + 3) * KLM_LD + key] = t.w;
    }
    __syncthreads();

    float s[4][8];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHEAD; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = R1[(warp * 4 + i) * DIM + h * DHEAD + d];
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = R0[d * KLM_LD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      const float inv = 1.f / warp_sum(sum);
      for (int j = 0; j < 8; ++j) R2[(warp * 4 + i) * LM + lane + 32 * j] = s[i][j] * inv;
    }
    __syncthreads();  // k_lm^T reads are done: R0 takes B

    const float* bm = bmat + bh * LM * DHEAD;
    for (int i = tid; i < LM * DHEAD / 4; i += THREADS)
      reinterpret_cast<float4*>(R0)[i] = reinterpret_cast<const float4*>(bm)[i];
    __syncthreads();

    float o[4][2];
    for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = 0.f;
#pragma unroll 4
    for (int key = 0; key < LM; ++key) {
      const float b0 = R0[key * DHEAD + lane], b1 = R0[key * DHEAD + lane + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = R2[(warp * 4 + i) * LM + key];
        o[i][0] += p * b0;
        o[i][1] += p * b1;
      }
    }
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i, gr = row0 + r;
      float r0 = 0.f, r1 = 0.f;
      if (gr < rows) {
        r0 = rb[(size_t)gr * DIM + h * DHEAD + lane];
        r1 = rb[(size_t)gr * DIM + h * DHEAD + lane + 32];
      }
      R1[r * DIM + h * DHEAD + lane] = o[i][0] + r0;
      R1[r * DIM + h * DHEAD + lane + 32] = o[i][1] + r1;
    }
    __syncthreads();  // before the next head reuses R0 and R2
  }

  // 4. y = (attention + res) W_out^T + b_out + x
  gemm_rows(R1, w_out, R2, acc, tid);
  float* yb = y + (size_t)b * rows * DIM;
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + ty * 8 + i;
    if (gr >= rows) continue;
    for (int half = 0; half < 2; ++half) {
      const int c = half * 256 + tx * 4;
      const float4 xo = *reinterpret_cast<const float4*>(xb + (size_t)gr * DIM + c);
      const float4 bo = *reinterpret_cast<const float4*>(b_out + c);
      *reinterpret_cast<float4*>(yb + (size_t)gr * DIM + c) = make_float4(
          acc[i][half * 4 + 0] + bo.x + xo.x, acc[i][half * 4 + 1] + bo.y + xo.y,
          acc[i][half * 4 + 2] + bo.z + xo.z, acc[i][half * 4 + 3] + bo.w + xo.w);
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int translayer_k1_chunks(int rows) { return (rows + ACH - 1) / ACH; }

// x (batch, rows, 512) -> attn3_v (batch, 8, 256, 64) and v_out (batch, rows, 512).
// Scratch from the caller: k_scratch (batch*rows, 512), stats (batch*rows, 2),
// part_acc (batch, 8, nchunks, 256, 64), part_ml (batch, 8, nchunks, 256, 2).
int translayer_k1(const float* x, const float* ln_w, const float* ln_b, const float* w_kv,
                  const float* q_lm, float* attn3_v, float* v_out, float* k_scratch,
                  float* stats, float* part_acc, float* part_ml, int batch, int rows,
                  int n_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * rows;
  const int nchunks = translayer_k1_chunks(rows);
  ln_stats_kernel<<<(total + 7) / 8, THREADS, 0, s>>>(x, stats, total);
  kv_proj_kernel<<<dim3((total + GBM - 1) / GBM, 2 * DIM / GBN), THREADS, 0, s>>>(
      x, stats, ln_w, ln_b, w_kv, k_scratch, v_out, total);
  cudaError_t err = cudaFuncSetAttribute(
      lm_attn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ATTN_SMEM);
  if (err != cudaSuccess) return err;
  lm_attn_partial_kernel<<<dim3(nchunks, HEADS, batch), THREADS, ATTN_SMEM, s>>>(
      k_scratch, v_out, q_lm, part_acc, part_ml, rows, nchunks);
  lm_attn_combine_kernel<<<dim3(LM / 4, HEADS, batch), THREADS, 0, s>>>(
      part_acc, part_ml, attn3_v, nchunks, n_pad);
  return cudaGetLastError();
}

// x, res (batch, rows, 512) -> y (batch, rows, 512).
int translayer_k2(const float* x, const float* res, const float* ln_w, const float* ln_b,
                  const float* w_q, const float* k_lm, const float* bmat, const float* w_out,
                  const float* b_out, float* y, int batch, int rows, float scale,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K2_SMEM);
  if (err != cudaSuccess) return err;
  k2_kernel<<<dim3((rows + RB - 1) / RB, batch), THREADS, K2_SMEM, s>>>(
      x, res, ln_w, ln_b, w_q, k_lm, bmat, w_out, b_out, y, rows, scale);
  return cudaGetLastError();
}

}  // extern "C"
