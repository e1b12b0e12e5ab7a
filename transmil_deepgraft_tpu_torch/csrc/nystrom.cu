// Nystrom landmark attention kernels for Hopper, float32 (the training path of
// TransMIL with use_pallas).
//
// Replaces the four Pallas TPU kernels of
// transmil_deepgraft_tpu/ops/pallas/nystrom_kernel.py:
//   nystrom_landmark_attn <- _landmark_attn_kernel_packed (B5, packed qkv) and
//                            _landmark_attn_kernel (B3, (b*h, n, d) arrays):
//                            attn3_v = softmax(q_lm K^T) V per head, the m
//                            landmarks as queries over the n keys.
//   nystrom_query_lm      <- _query_lm_kernel_packed (B6) and _query_lm_kernel
//                            (B4): out = softmax(Q k_lm^T) B per head, the n
//                            rows as queries over the m landmarks.
//
// One body serves both layouts: K/V and Q are read through explicit batch,
// head and row strides (in floats), so the k/v/q planes of the packed
// (b, n, 3, h, d) projection are read in place (row stride 3*h*d = 1,536) and
// nothing is transposed in device memory. Every row of 64 floats is 256
// contiguous bytes; strides and bases must be multiples of 4 floats (16-byte
// float4 loads), which the wrappers check.
//
// Shapes are fixed to the model the repository ships: dim_head 64 and 256
// landmarks; batch, heads and n are free. Keys and rows at or beyond n are
// never loaded or written (a ragged tail needs no padding in memory).
//
// What bounds them on an H100: each does 4*m*n*h*d float32 operations
// (21.7 GFLOP at n = 41,472, 8 heads) against ~170 MB of traffic, so both are
// bound by the 67 TFLOP/s float32 rate (~0.33 ms), not by memory. What this
// first design does about it: register-tiled SIMT float32 (8x8 or 8x2 outputs
// a thread, operands staged through shared memory); no tensor cores yet.
// The landmark kernel splits n across blocks (the TPU kernel walks n in one
// sequential grid axis; Hopper blocks run in no order), each block keeping an
// online softmax over its keys, and a combine pass merges the per-split
// (max, sum, acc). The split shrinks until the grid fills the card twice.
// The query kernel keeps one head's k_lm^T and B (128 KB) in shared memory and
// walks several 64-row tiles with them. expf (not __expf) throughout.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DHEAD = 64;
constexpr int LM = 256;  // landmarks
constexpr int THREADS = 256;
constexpr int AT = 64;            // keys a shared-memory tile (landmark kernel)
constexpr int KT_LD = AT + 1;     // padded row of the transposed key tile
constexpr size_t ATTN_SMEM =
    sizeof(float) * (DHEAD * LM + DHEAD * KT_LD + AT * DHEAD + AT * LM);

constexpr int QR = 64;            // rows a tile (query kernel)
constexpr int KLM_LD = LM + 1;    // padded row of k_lm^T: transposing stores ~2-way
constexpr size_t QUERY_SMEM =
    sizeof(float) * (DHEAD * KLM_LD + LM * DHEAD + QR * DHEAD + QR * LM);

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// ------------------------------------------------------ landmark attention

// One split of keys [chunk*chunk_keys, ...) for one (batch, head): online
// softmax of q_lm K^T over the split, accumulating P V. Writes the split's
// running max m, sum l and unnormalised accumulator for the combine pass.
__global__ void __launch_bounds__(THREADS, 1) lm_attn_partial_kernel(
    const float* __restrict__ q_lm, const float* __restrict__ k,
    const float* __restrict__ v, long long sb, long long sh, long long sn,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int heads, int n,
    int chunk_keys, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  float* QT = smem;                 // [DHEAD][LM]  q_lm transposed
  float* KT = QT + DHEAD * LM;      // [DHEAD][KT_LD] key tile transposed
  float* Vs = KT + DHEAD * KT_LD;   // [AT][DHEAD]
  float* PT = Vs + AT * DHEAD;      // [AT][LM]     probabilities transposed
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * heads + h;

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

  const int key0 = chunk * chunk_keys;
  const int key_end = min(key0 + chunk_keys, n);
  const float* kb = k + (size_t)b * sb + (size_t)h * sh;
  const float* vb = v + (size_t)b * sb + (size_t)h * sh;

  for (int t0 = key0; t0 < key_end; t0 += AT) {
    __syncthreads();  // QT is in; the last tile's KT/Vs/PT reads are done
    for (int i = tid; i < AT * DHEAD / 4; i += THREADS) {
      const int kr = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
      const int key = t0 + kr;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (key < key_end) {  // keys at or beyond n are never loaded
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)key * sn + c4);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)key * sn + c4);
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
      if (t0 + tx + 8 * j >= key_end)  // the ragged tail: masked keys
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

// Merge the splits of one (batch, head): out = sum_c e^(m_c-M) acc_c / L.
__global__ void __launch_bounds__(THREADS) lm_attn_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int heads, int nchunks) {
  const int row = blockIdx.x * 4 + threadIdx.x / DHEAD;
  const int d = threadIdx.x % DHEAD;
  const size_t bh = (size_t)blockIdx.z * heads + blockIdx.y;
  float big = -INFINITY;
  for (int c = 0; c < nchunks; ++c)
    big = fmaxf(big, part_ml[((bh * nchunks + c) * LM + row) * 2]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const size_t idx = (bh * nchunks + c) * LM + row;
    const float w = expf(part_ml[idx * 2] - big);
    l += part_ml[idx * 2 + 1] * w;
    a += part_acc[idx * DHEAD + d] * w;
  }
  out[(bh * LM + row) * DHEAD + d] = a / l;
}

// --------------------------------------------------------- query attention

// Rows [blockIdx.x*rows_per_block, ...) of one (batch, head):
// out = softmax(Q k_lm^T) B. k_lm^T and B stay in shared memory for all the
// block's 64-row tiles. Warp w owns rows w*8 .. w*8+7 of a tile: lane l holds
// landmarks l + 32j of their scores, then output columns l and l + 32.
__global__ void __launch_bounds__(THREADS, 1) query_lm_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_sn,
    const float* __restrict__ k_lm, const float* __restrict__ bmat,
    float* __restrict__ out, long long o_sb, long long o_sh, long long o_sn,
    int heads, int n, int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* KT = smem;                 // [DHEAD][KLM_LD] k_lm transposed
  float* Bs = KT + DHEAD * KLM_LD;  // [LM][DHEAD]
  float* Qs = Bs + LM * DHEAD;      // [QR][DHEAD] one tile of query rows
  float* Ps = Qs + QR * DHEAD;      // [QR][LM] probabilities (each warp its 8 rows)
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * heads + h;

  const float* kl = k_lm + bh * LM * DHEAD;
  for (int i = tid; i < LM * DHEAD / 4; i += THREADS) {
    const int key = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
    const float4 t = *reinterpret_cast<const float4*>(kl + key * DHEAD + c4);
    KT[(c4 + 0) * KLM_LD + key] = t.x;
    KT[(c4 + 1) * KLM_LD + key] = t.y;
    KT[(c4 + 2) * KLM_LD + key] = t.z;
    KT[(c4 + 3) * KLM_LD + key] = t.w;
  }
  const float4* bm = reinterpret_cast<const float4*>(bmat + bh * LM * DHEAD);
  for (int i = tid; i < LM * DHEAD / 4; i += THREADS) reinterpret_cast<float4*>(Bs)[i] = bm[i];

  const float* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  float* ob = out + (size_t)b * o_sb + (size_t)h * o_sh;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, n);
  float* Pw = Ps + warp * 8 * LM;

  for (int t0 = row_begin; t0 < row_end; t0 += QR) {
    __syncthreads();  // k_lm^T/B are in; the last tile's Qs reads are done
    for (int i = tid; i < QR * DHEAD / 4; i += THREADS) {
      const int r = i / (DHEAD / 4), c4 = (i % (DHEAD / 4)) * 4;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + r < row_end)  // rows at or beyond n are never loaded
        t = *reinterpret_cast<const float4*>(qb + (size_t)(t0 + r) * q_sn + c4);
      *reinterpret_cast<float4*>(Qs + r * DHEAD + c4) = t;
    }
    __syncthreads();

    float s[8][8];
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DHEAD; d += 4) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (warp * 8 + i) * DHEAD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kr[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kr[j] = KT[(d + e) * KLM_LD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float qe = e == 0 ? qv[i].x : e == 1 ? qv[i].y : e == 2 ? qv[i].z : qv[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] += qe * kr[j];
        }
      }
    }
    for (int i = 0; i < 8; ++i) {
      float mx = s[i][0];
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      const float inv = 1.f / warp_sum(sum);
      for (int j = 0; j < 8; ++j) Pw[i * LM + lane + 32 * j] = s[i][j] * inv;
    }
    __syncwarp();

    float o[8][2];
    for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = 0.f;
#pragma unroll 2
    for (int key = 0; key < LM; key += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = *reinterpret_cast<const float4*>(Pw + i * LM + key);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b0 = Bs[(key + e) * DHEAD + lane], b1 = Bs[(key + e) * DHEAD + lane + 32];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
          o[i][0] += p * b0;
          o[i][1] += p * b1;
        }
      }
    }
    __syncwarp();  // this warp's P reads are done before the next tile rewrites them
    for (int i = 0; i < 8; ++i) {
      const int row = t0 + warp * 8 + i;
      if (row >= row_end) continue;  // rows at or beyond n are never written
      float* dst = ob + (size_t)row * o_sn;
      dst[lane] = o[i][0];
      dst[lane + 32] = o[i][1];
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Keys a block of the landmark kernel takes: max_keys (rounded down to a
// multiple of 64), halved while the grid would not fill the card twice.
int nystrom_landmark_chunk_keys(int bh, int n, int max_keys) {
  int chunk = max_keys / AT * AT;
  if (chunk < AT) chunk = AT;
  const int want = 2 * sm_count();
  while (chunk > 2 * AT && (long long)bh * ((n + chunk - 1) / chunk) < want)
    chunk = chunk / 2 / AT * AT;
  return chunk;
}

// q_lm (batch, heads, 256, 64) contiguous; k and v read as
// base + b*sb + h*sh + key*sn + c for key < n -> out (batch, heads, 256, 64).
// Scratch from the caller: part_acc (batch, heads, nchunks, 256, 64) and
// part_ml (batch, heads, nchunks, 256, 2), nchunks = ceil(n / chunk_keys).
int nystrom_landmark_attn(const float* q_lm, const float* k, const float* v, long long sb,
                          long long sh, long long sn, float* out, float* part_acc,
                          float* part_ml, int batch, int heads, int n, int chunk_keys,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (n + chunk_keys - 1) / chunk_keys;
  cudaError_t err = cudaFuncSetAttribute(
      lm_attn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ATTN_SMEM);
  if (err != cudaSuccess) return err;
  lm_attn_partial_kernel<<<dim3(nchunks, heads, batch), THREADS, ATTN_SMEM, s>>>(
      q_lm, k, v, sb, sh, sn, part_acc, part_ml, heads, n, chunk_keys, nchunks);
  lm_attn_combine_kernel<<<dim3(LM / 4, heads, batch), THREADS, 0, s>>>(
      part_acc, part_ml, out, heads, nchunks);
  return cudaGetLastError();
}

// Rows a block of the query kernel takes: 64-row tiles, up to 8 of them, as
// many as keep the grid at two blocks an SM or more.
int nystrom_query_rows(int bh, int n) {
  const long long tiles = (long long)bh * ((n + QR - 1) / QR);
  const long long per = tiles / (2 * sm_count());
  return QR * (int)(per < 1 ? 1 : per > 8 ? 8 : per);
}

// q read as base + b*q_sb + h*q_sh + row*q_sn + c; k_lm, bmat (batch, heads,
// 256, 64) contiguous; out written as base + b*o_sb + h*o_sh + row*o_sn + c,
// rows < n only.
int nystrom_query_lm(const float* q, long long q_sb, long long q_sh, long long q_sn,
                     const float* k_lm, const float* bmat, float* out, long long o_sb,
                     long long o_sh, long long o_sn, int batch, int heads, int n,
                     int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      query_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QUERY_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  query_lm_kernel<<<dim3(blocks, heads, batch), THREADS, QUERY_SMEM, s>>>(
      q, q_sb, q_sh, q_sn, k_lm, bmat, out, o_sb, o_sh, o_sn, heads, n, rows_per_block);
  return cudaGetLastError();
}

}  // extern "C"
