// Nystrom landmark attention kernels for Hopper, float32 in and out (the
// training path of TransMIL with use_pallas).
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
// cp.async copies), which the wrappers check. Shapes are fixed to the model
// the repository ships: dim_head 64 and 256 landmarks; batch, heads and n are
// free. Keys and rows at or beyond n are never loaded or written (a ragged
// tail needs no padding in memory).
//
// What bounds them on an H100: each does 4*m*n*h*d float32 operations, 21.7
// GFLOP at n = 41,472 and 8 heads, against ~170 MB of traffic (0.051 ms at
// 3.35 TB/s). On the float32 SIMT units (67 TFLOP/s) that is 0.325 ms. Both
// products here run on the tensor cores in TF32 with the 3xTF32 split
// (x = hi + lo, hi = x cut to TF32, lo = x - hi; a*b ~ lo*hi + hi*lo + hi*hi
// summed in float32), which keeps float32 accuracy (one-pass TF32 is off by
// ~7e-4 at the training shape, the split by ~1.5e-6). Three TF32 products
// per float32 one: 3 x 21.7 GFLOP over 495 TFLOP/s is 0.132 ms. The split
// product is the bound, not memory. mma.sync reaches ~265 TFLOP/s of TF32 on
// an H100 (tools/mma_tf32_peak.cu), 0.246 ms for this work; the rest of the
// 495 needs wgmma.
//
// What the design does about it:
// * mma.sync.m16n8k8 TF32, one warp per 16 query rows. The score fragment
//   stays in registers; the softmax runs on it (row max and sum over the quad
//   of lanes that hold a row) and it becomes the A operand of the second
//   product without a shuffle: that product's k order inside each 8-wide step
//   is permuted (k = t <-> column 2t, k = t+4 <-> column 2t+1), so the C
//   fragment's registers are the A fragment's, and the B operand rows are
//   read in the same order. The first product's k order is permuted the same
//   way in both operands, so each lane reads its A and B elements as 64-bit
//   pairs. Landmarks (query kernel) and keys (landmark kernel) are walked in
//   64-wide chunks with an online softmax, which bounds the registers. expf,
//   not __expf.
// * The split costs two instructions an element (a mask and a subtraction;
//   cvt.rna.tf32.f32 is four on sm_90a), done as each fragment is loaded.
// * Operands are staged in shared memory at row pitches where every fragment
//   load is free of bank conflicts: 72 floats for the 64-bit pairs (q, k_lm,
//   K), 68 for rows 2t/2t+1 at column g (B, V).
// * nystrom_query_lm: a persistent grid of min(tiles, SMs) blocks of 8 warps
//   walks 128-row tiles ordered by head; block i takes tiles
//   [i*T/G, (i+1)*T/G) of the T = b*h*ceil(n/128), so it stages one head's
//   k_lm and B (72 + 68 KB) only when its head changes. Q tiles come through a
//   two-stage cp.async ring (2 x 36 KB), the next tile's copy overlapping
//   this tile's products. Output rows are written from registers.
//   217,088 bytes of shared memory: one block an SM.
// * nystrom_landmark_attn: one launch. Grid (4 row tiles of 64 landmarks,
//   splits, b*h), 4 warps a block, each block holding its own 64 q_lm rows as
//   split A fragments in registers and walking its split of 64-key K/V tiles
//   through a two-stage cp.async ring (71,680 bytes). 193 registers: two
//   blocks an SM (capped at 168 registers for three, it spilled and ran
//   slower on the H100).
//   With one split a block normalises and writes its rows. Otherwise each
//   split writes its (acc, max, sum) to scratch, and the last block of a
//   (b*h, row tile) to finish (a __threadfence, then an atomicAdd on the
//   tile's counter) merges the splits in split order, so the result does not
//   depend on which block is last, and resets the counter to 0 for the next
//   launch. The split length (the wrappers' landmark_plan) is the fewest key
//   tiles that still give about two blocks an SM: at b 2, n = 1,280,
//   4 x 4 x 16 = 256 blocks of 320 keys; at b 1, n = 41,472,
//   4 x 8 x 8 = 256 blocks of 5,184 keys. The query kernel's grid is 132
//   blocks at both shapes (160 and 2,592 tiles on 132 SMs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int DHEAD = 64;
constexpr int LM = 256;          // landmarks
// Shared-memory row pitches at which the fragment loads are free of bank
// conflicts: LDX for operands read as 64-bit pairs (row g, columns 2t, 2t+1),
// LDY for operands read as rows 2t and 2t+1 at column g.
constexpr int LDX = DHEAD + 8;
constexpr int LDY = DHEAD + 4;
constexpr int CHUNK = 64;        // landmarks or keys a softmax step

constexpr int KT = 64;           // keys a tile (landmark kernel)
constexpr int LM_ROWS = 64;      // landmark rows a block: 4 warps x 16
constexpr int LM_TILES = LM / LM_ROWS;
constexpr int LM_THREADS = 128;
constexpr int LM_MIN_BLOCKS = 2; // landmark blocks an SM (the launch bound)
constexpr int LM_STAGE = KT * (LDX + LDY);                  // K then V of one stage
constexpr int LM_SMEM = sizeof(float) * 2 * LM_STAGE;
constexpr int PART = LM_ROWS * DHEAD + 2 * LM_ROWS;          // one split: acc, then (max, sum)

constexpr int QT = 128;          // query rows a tile: 8 warps x 16
constexpr int Q_THREADS = 256;
constexpr int Q_SMEM = sizeof(float) * (LM * LDX + LM * LDY + 2 * QT * LDX);  // k_lm, B, 2 Q stages

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false nothing is read and zeros land.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x cut to TF32 (its top 19 bits), lo the rest, which the
// tensor core cuts to TF32 in turn. Two instructions; cvt.rna.tf32.f32 is four
// on sm_90a (round, NaN/Inf test, select, mask). |lo| < 2^-10 |x|, so the
// dropped lo*lo and lo's own cut are each below 2^-20 of the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on a 16x8x8 step in 3xTF32: the two small terms first, then hi*hi.
// b0, b1 are the B fragment's (k = t, n = g) and (k = t + 4, n = g) elements.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(c, al, b0h, b1h);
  mma_tf32(c, ah, b0l, b1l);
  mma_tf32(c, ah, b0h, b1h);
}

// The split A fragments of a warp's 16 rows x 64 columns, read at pitch ld.
// The first product's k order is permuted (k = t <-> column 2t, k = t + 4 <->
// column 2t + 1) in both operands, so each lane reads 64-bit pairs:
// a0, a2 (row g, columns 2t, 2t+1), a1, a3 (row g+8, the same columns).
__device__ __forceinline__ void load_a(const float* rows, int ld, int g, int t,
                                       uint32_t (&ah)[8][4], uint32_t (&al)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < DHEAD / 8; ++ks) {
    const float2 r0 = *reinterpret_cast<const float2*>(rows + g * ld + ks * 8 + 2 * t);
    const float2 r8 = *reinterpret_cast<const float2*>(rows + (g + 8) * ld + ks * 8 + 2 * t);
    split(r0.x, ah[ks][0], al[ks][0]);
    split(r8.x, ah[ks][1], al[ks][1]);
    split(r0.y, ah[ks][2], al[ks][2]);
    split(r8.y, ah[ks][3], al[ks][3]);
  }
}

// One 64-wide softmax step of a warp's 16 query rows against 64 operand rows
// (landmarks or keys), X staged at pitch LDX and Y at LDY: s = A X^T, online
// softmax into (m, l), o = o * alpha + P Y. keys_left masks columns at or
// beyond it.
// Rows g and g + 8 of the warp are (m[0], l[0]) and (m[1], l[1]); o[nt] holds
// output columns nt*8 + 2t, +1 of both.
__device__ __forceinline__ void attend_chunk(const uint32_t (&ah)[8][4], const uint32_t (&al)[8][4],
                                             const float* X, const float* Y, int keys_left, int g,
                                             int t, float (&m)[2], float (&l)[2],
                                             float (&o)[8][4]) {
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DHEAD / 8; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(X + (nt * 8 + g) * LDX + ks * 8 + 2 * t);
      mma3(s[nt], ah[ks], al[ks], x.x, x.y);
    }
  }
  if (keys_left < CHUNK) {  // the ragged tail: masked columns
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col >= keys_left) s[nt][0] = s[nt][2] = -INFINITY;
      if (col + 1 >= keys_left) s[nt][1] = s[nt][3] = -INFINITY;
    }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float alpha0 = expf(m[0] - mx0), alpha1 = expf(m[1] - mx1);
  m[0] = mx0;
  m[1] = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = expf(s[nt][0] - mx0);
    s[nt][1] = expf(s[nt][1] - mx0);
    s[nt][2] = expf(s[nt][2] - mx1);
    s[nt][3] = expf(s[nt][3] - mx1);
    ps0 += s[nt][0] + s[nt][1];
    ps1 += s[nt][2] + s[nt][3];
    o[nt][0] *= alpha0;
    o[nt][1] *= alpha0;
    o[nt][2] *= alpha1;
    o[nt][3] *= alpha1;
  }
  l[0] = l[0] * alpha0 + ps0;  // this lane's share; the quad is summed at the end
  l[1] = l[1] * alpha1 + ps1;
#pragma unroll
  for (int kk = 0; kk < CHUNK / 8; ++kk) {
    // the C fragment of columns kk*8.. as the A fragment, k order permuted
    uint32_t ph[4], pl[4];
    split(s[kk][0], ph[0], pl[0]);
    split(s[kk][2], ph[1], pl[1]);
    split(s[kk][1], ph[2], pl[2]);
    split(s[kk][3], ph[3], pl[3]);
    const float* y = Y + (kk * 8 + 2 * t) * LDY + g;  // B rows 2t and 2t + 1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma3(o[nt], ph, pl, y[nt * 8], y[LDY + nt * 8]);
  }
}

// The quad's row sums, then 1 / sum for rows g and g + 8.
__device__ __forceinline__ void finish_sums(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// o (scaled by 1/l) to rows g and g + 8 of a warp's 16 rows at pitch ld.
__device__ __forceinline__ void store_rows(float* row_g, float* row_g8, const float (&o)[8][4],
                                           float inv0, float inv1, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row_g) *reinterpret_cast<float2*>(row_g + c) = make_float2(o[nt][0] * inv0, o[nt][1] * inv0);
    if (row_g8)
      *reinterpret_cast<float2*>(row_g8 + c) = make_float2(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

// ------------------------------------------------------ landmark attention

// 64 keys from key0 of K and V (rows at stride sn) into one ring stage.
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const float* kb, const float* vb,
                                        long long sn, int key0, int n, int tid) {
#pragma unroll
  for (int j = 0; j < KT * DHEAD / 4 / LM_THREADS; ++j) {
    const int i = tid + j * LM_THREADS, r = i >> 4, c4 = (i & 15) * 4;
    const bool ok = key0 + r < n;  // keys at or beyond n are never loaded
    const long long off = ok ? (long long)(key0 + r) * sn + c4 : 0;
    cp_async16(Ks + r * LDX + c4, kb + off, ok);
    cp_async16(Vs + r * LDY + c4, vb + off, ok);
  }
}

// Block (row tile, split, b*h): its 64 landmark rows over the split's key
// tiles, then either the output (one split) or the last-block merge.
__global__ void __launch_bounds__(LM_THREADS, LM_MIN_BLOCKS) landmark_attn_kernel(
    const float* __restrict__ q_lm, const float* __restrict__ k, const float* __restrict__ v,
    long long sb, long long sh, long long sn, float* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counters, int heads, int n, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];  // [2 stages][K (KT x LDX), V (KT x LDY)]
  __shared__ int is_last;
  const int rt = blockIdx.x, split_idx = blockIdx.y, splits = gridDim.y;
  const int bh = blockIdx.z, b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = rt * LM_ROWS + warp * 16;  // this warp's landmark rows

  uint32_t qh[8][4], ql[8][4];
  load_a(q_lm + ((size_t)bh * LM + row0) * DHEAD, DHEAD, g, t, qh, ql);

  const int tiles = (n + KT - 1) / KT;
  const int t_begin = split_idx * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, tiles);
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  load_kv(smem, smem + KT * LDX, kb, vb, sn, t_begin * KT, n, tid);
  cp_async_commit();
  for (int ti = t_begin, i = 0; ti < t_end; ++ti, ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile ti is in for all; every warp is done with the other stage
    if (ti + 1 < t_end) {
      float* nxt = smem + ((i + 1) & 1) * LM_STAGE;
      load_kv(nxt, nxt + KT * LDX, kb, vb, sn, (ti + 1) * KT, n, tid);
      cp_async_commit();
    }
    const float* Ks = smem + (i & 1) * LM_STAGE;
    attend_chunk(qh, ql, Ks, Ks + KT * LDX, n - ti * KT, g, t, m, l, o);
  }
  finish_sums(l);

  const size_t tile = (size_t)bh * LM_TILES + rt;
  if (splits == 1) {
    float* ob = out + ((size_t)bh * LM + row0) * DHEAD;
    store_rows(ob + g * DHEAD, ob + (g + 8) * DHEAD, o, 1.f / l[0], 1.f / l[1], t);
    return;
  }

  // this split's unnormalised acc, max and sum
  float* p = part + (tile * splits + split_idx) * PART;
  store_rows(p + (warp * 16 + g) * DHEAD, p + (warp * 16 + g + 8) * DHEAD, o, 1.f, 1.f, t);
  if (t == 0) {
    float* ml = p + LM_ROWS * DHEAD;
    *reinterpret_cast<float2*>(ml + (warp * 16 + g) * 2) = make_float2(m[0], l[0]);
    *reinterpret_cast<float2*>(ml + (warp * 16 + g + 8) * 2) = make_float2(m[1], l[1]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + tile, 1);
    is_last = done == splits - 1;
    if (is_last) atomicExch(counters + tile, 0);  // zero again for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the merge: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, in split order
  const float* p0 = part + tile * splits * PART;
  const int c4 = (tid & 15) * 4;
#pragma unroll 1
  for (int r = tid >> 4; r < LM_ROWS; r += LM_THREADS / 16) {
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) big = fmaxf(big, __ldcg(p0 + sp * PART + LM_ROWS * DHEAD + r * 2));
    float sum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float* ps = p0 + sp * PART;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ps + LM_ROWS * DHEAD + r * 2));
      const float w = expf(ml.x - big);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(ps + r * DHEAD + c4));
      sum += ml.y * w;
      acc.x += a.x * w;
      acc.y += a.y * w;
      acc.z += a.z * w;
      acc.w += a.w * w;
    }
    const float inv = 1.f / sum;
    *reinterpret_cast<float4*>(out + ((size_t)bh * LM + rt * LM_ROWS + r) * DHEAD + c4) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

// --------------------------------------------------------- query attention

// 128 rows of Q from row0 (rows at stride sn) into one ring stage.
__device__ __forceinline__ void load_q(float* Qs, const float* qb, long long sn, int row0, int n,
                                       int tid) {
#pragma unroll
  for (int j = 0; j < QT * DHEAD / 4 / Q_THREADS; ++j) {
    const int i = tid + j * Q_THREADS, r = i >> 4, c4 = (i & 15) * 4;
    const bool ok = row0 + r < n;  // rows at or beyond n are never loaded
    cp_async16(Qs + r * LDX + c4, qb + (ok ? (long long)(row0 + r) * sn + c4 : 0), ok);
  }
}

// Block i of G walks the tiles [i*T/G, (i+1)*T/G) of T = b*h*ceil(n/128),
// ordered by head: out = softmax(Q k_lm^T) B, restaging k_lm and B when the
// head changes.
__global__ void __launch_bounds__(Q_THREADS, 1) query_lm_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_sn,
    const float* __restrict__ k_lm, const float* __restrict__ bmat, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_sn, int heads, int bh_count, int n) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // [LM][LDX] k_lm of the current head
  float* Bs = Ks + LM * LDX;    // [LM][LDY] B of the current head
  float* Qring = Bs + LM * LDY; // [2][QT][LDX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int per_head = (n + QT - 1) / QT;
  const long long total = (long long)bh_count * per_head;
  const long long t_begin = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  if (t_begin >= t_end) return;

  auto q_base = [&](long long ti) {
    const int bh = (int)(ti / per_head);
    return q + (bh / heads) * q_sb + (bh % heads) * q_sh;
  };
  load_q(Qring, q_base(t_begin), q_sn, (int)(t_begin % per_head) * QT, n, tid);
  cp_async_commit();
  int staged = -1;
  for (long long ti = t_begin; ti < t_end; ++ti) {
    const int i = (int)(ti - t_begin);
    const int bh = (int)(ti / per_head), row0 = (int)(ti % per_head) * QT;
    cp_async_wait<0>();
    __syncthreads();  // Q tile ti is in for all; every warp is done with tile ti - 1
    const bool restage = bh != staged;
    if (restage) {
      const float* kl = k_lm + (size_t)bh * LM * DHEAD;
      const float* bm = bmat + (size_t)bh * LM * DHEAD;
#pragma unroll 4
      for (int j = 0; j < LM * DHEAD / 4 / Q_THREADS; ++j) {
        const int r = (tid + j * Q_THREADS) >> 4, c4 = (tid & 15) * 4;
        cp_async16(Ks + r * LDX + c4, kl + r * DHEAD + c4, true);
        cp_async16(Bs + r * LDY + c4, bm + r * DHEAD + c4, true);
      }
      cp_async_commit();
      staged = bh;
    }
    if (ti + 1 < t_end) {
      load_q(Qring + ((i + 1) & 1) * QT * LDX, q_base(ti + 1), q_sn,
             (int)((ti + 1) % per_head) * QT, n, tid);
      cp_async_commit();
    }
    if (restage) {  // k_lm and B must be in; the next Q tile may still be in flight
      if (ti + 1 < t_end)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }

    uint32_t qh[8][4], ql[8][4];
    load_a(Qring + (i & 1) * QT * LDX + warp * 16 * LDX, LDX, g, t, qh, ql);
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < LM; c += CHUNK)
      attend_chunk(qh, ql, Ks + c * LDX, Bs + c * LDY, CHUNK, g, t, m, l, o);
    finish_sums(l);

    const int r = row0 + warp * 16 + g;  // rows at or beyond n are never written
    float* ob = out + (bh / heads) * o_sb + (bh % heads) * o_sh;
    store_rows(r < n ? ob + (long long)r * o_sn : nullptr,
               r + 8 < n ? ob + (long long)(r + 8) * o_sn : nullptr, o, 1.f / l[0], 1.f / l[1], t);
  }
}

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

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The tiling the wrappers plan their grids and scratch with, for them to
// check against: keys a tile, landmark rows a block, landmark blocks an SM,
// query rows a tile, floats of one split's partial result.
void nystrom_tiling(int* out) {
  out[0] = KT;
  out[1] = LM_ROWS;
  out[2] = LM_MIN_BLOCKS;
  out[3] = QT;
  out[4] = PART;
}

// q_lm (batch, heads, 256, 64) contiguous; k and v read as
// base + b*sb + h*sh + key*sn + c for key < n -> out (batch, heads, 256, 64).
// Key tiles of 64 go to `splits` splits of tiles_per_split (the last one
// shorter, none empty). With splits > 1: part (part_floats floats) holds
// batch*heads*4*splits partials of 4,224 floats, counters (counter_words
// ints) batch*heads*4 ints, zero on entry and on exit. A plan that misses a
// key tile or a scratch too small for it returns cudaErrorInvalidValue.
int nystrom_landmark_attn(const float* q_lm, const float* k, const float* v, long long sb,
                          long long sh, long long sn, float* out, float* part,
                          long long part_floats, int* counters, int counter_words, int batch,
                          int heads, int n, int tiles_per_split, int splits, void* stream) {
  const long long tiles = (n + KT - 1) / KT, row_tiles = (long long)batch * heads * LM_TILES;
  if (n < 1 || tiles_per_split < 1 || splits < 1 || (long long)splits * tiles_per_split < tiles ||
      (long long)(splits - 1) * tiles_per_split >= tiles)
    return cudaErrorInvalidValue;
  if (splits > 1 && (counter_words < row_tiles || part_floats < row_tiles * splits * PART))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem((const void*)landmark_attn_kernel, LM_SMEM, ready);
  if (err != cudaSuccess) return err;
  landmark_attn_kernel<<<dim3(LM_TILES, splits, batch * heads), LM_THREADS, LM_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      q_lm, k, v, sb, sh, sn, out, part, counters, heads, n, tiles_per_split);
  return cudaGetLastError();
}

// q read as base + b*q_sb + h*q_sh + row*q_sn + c; k_lm, bmat (batch, heads,
// 256, 64) contiguous; out written as base + b*o_sb + h*o_sh + row*o_sn + c,
// rows < n only. `blocks` persistent blocks share the 128-row tiles.
int nystrom_query_lm(const float* q, long long q_sb, long long q_sh, long long q_sn,
                     const float* k_lm, const float* bmat, float* out, long long o_sb,
                     long long o_sh, long long o_sn, int batch, int heads, int n, int blocks,
                     void* stream) {
  if (n < 1 || blocks < 1) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem((const void*)query_lm_kernel, Q_SMEM, ready);
  if (err != cudaSuccess) return err;
  query_lm_kernel<<<blocks, Q_THREADS, Q_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q, q_sb, q_sh, q_sn, k_lm, bmat, out, o_sb, o_sh, o_sn, heads, batch * heads, n);
  return cudaGetLastError();
}

}  // extern "C"
