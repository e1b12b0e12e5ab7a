"""Operations, least bytes and the peak rule that every roofline and mfu
share of the benchmark is taken against.

The peak rule (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates):

- an int8 operation counts at 1,979 TOP/s;
- every floating-point operation counts at 989 TFLOP/s, the dense bf16
  rate: the card's highest float rate without sparsity or fp8. A float32
  kernel built from 3xTF32 products, or a TF32 or bf16 kernel that replaces
  it later, is then held to one and the same yardstick, and no share of it
  can pass 100%;
- a byte counts at 3.35 TB/s (HBM3).

Operations and bytes come from shapes, for what the inputs need: the real
tiles and rows, and the model's own square pad and landmark pad, never a
serving bucket's pad or the zero tiles of a ragged chunk. An operation is a
multiply or an add (2 a multiply-accumulate). Each input byte is read once
and each output byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

import math

PEAK_INT8_OPS = 1979e12
PEAK_FLOAT_OPS = 989e12
PEAK_BYTES = 3.35e12

# ResNet50 (He et al. 2016): bottlenecks a stage, mid widths, first strides
R50_LAYERS = (3, 4, 6, 3)
R50_PLANES = (64, 128, 256, 512)
R50_STRIDES = (1, 2, 2, 2)
R50_EXPANSION = 4


def least_s(ops: float, nbytes: float, *, int8: bool = False) -> float:
    """Least seconds of a kernel: the larger of its operations at the peak
    rate and its bytes at the memory rate."""
    return max(ops / (PEAK_INT8_OPS if int8 else PEAK_FLOAT_OPS), nbytes / PEAK_BYTES)


def ops_s(int8_ops: float = 0.0, float_ops: float = 0.0) -> float:
    """Seconds of the operations alone at the peak rule (an mfu's numerator)."""
    return int8_ops / PEAK_INT8_OPS + float_ops / PEAK_FLOAT_OPS


# ------------------------------------------------------------ int8 ResNet50

def r50_blocks():
    """(stage, stride, cin, mid, cout, has_downsample) of each bottleneck."""
    cin = 64
    for stage, (count, mid, first) in enumerate(zip(R50_LAYERS, R50_PLANES, R50_STRIDES)):
        cout = mid * R50_EXPANSION
        for b in range(count):
            stride = first if b == 0 else 1
            yield stage, stride, cin, mid, cout, b == 0 and (stride != 1 or cin != cout)
            cin = cout


def r50_segments(hw: int = 224):
    """The int8 forward after the stem as its kernel segments: stage 1 (one
    stage launch), then the entry block and the interior blocks of stages
    2-4. Yields (name, [(stride, cin, mid, cout, has_ds), ...], (h, w, c) of
    the segment's input)."""
    blocks = list(r50_blocks())
    h = hw // 4
    segs = [("s1", blocks[0:3])]
    start = 3
    for stage in (1, 2, 3):
        count = R50_LAYERS[stage]
        segs += [(f"e{stage + 1}", blocks[start:start + 1]),
                 (f"i{stage + 1}", blocks[start + 1:start + count])]
        start += count
    for name, blks in segs:
        cin = blks[0][2]
        yield name, [b[1:] for b in blks], (h, h, cin)
        h //= blks[0][1]


def r50_segment_cost(blocks, x_hwc, n: int) -> tuple[float, float]:
    """(int8 operations, least bytes) of one segment on n tiles: the input
    codes, every weight and the fma constants (float32, a mid channel two,
    an output channel two) read once, the output codes written once."""
    h, w, c_in = x_hwc
    macs, nbytes = 0, n * h * w * c_in
    for stride, cin, mid, cout, has_ds in blocks:
        full, out = n * h * w, n * (h // stride) * (w // stride)
        macs += full * cin * mid + out * 9 * mid * mid + out * mid * cout
        nbytes += cin * mid + 9 * mid * mid + mid * cout + 4 * (4 * mid + 2 * cout)
        if has_ds:
            macs += out * cin * cout
            nbytes += cin * cout + 4 * cout
        h, w = h // stride, w // stride
    return 2.0 * macs, float(nbytes + n * h * w * cout)


def r50_stem_ops(hw: int = 224) -> float:
    """Operations of the 7x7/2 stem on one tile (3 -> 64 channels)."""
    out = (hw // 2) ** 2
    return 2.0 * out * 7 * 7 * 3 * 64


def r50_tile_ops(hw: int = 224) -> float:
    """int8 operations of one tile through the stem and all 16 bottlenecks."""
    return r50_stem_ops(hw) + sum(r50_segment_cost(b, x, 1)[0] for _, b, x in r50_segments(hw))


def qstage_least_s(n: int, hw: int = 224) -> float:
    """Least seconds of the int8 stage kernels (stage 1 and the entry and
    interior segments of stages 2-4) on one chunk of n real tiles."""
    return sum(least_s(*r50_segment_cost(b, x, n), int8=True) for _, b, x in r50_segments(hw))


# ------------------------------------------------------------------ TransMIL

def square_side(n: int) -> int:
    return int(math.ceil(math.sqrt(n)))


def landmark_pad(n: int, m: int = 256) -> int:
    return (m - n % m) % m


def transmil_tokens(n: int, m: int = 256) -> tuple[int, int]:
    """(tokens, landmark-padded tokens) of a TransLayer on an n-row bag:
    the duplicate pad to a square grid, plus the cls token."""
    t = square_side(n) ** 2 + 1
    return t, t + landmark_pad(t, m)


def nystrom_ops(np_: int, heads: int = 8, d: int = 64, m: int = 256, iters: int = 6) -> float:
    """Float operations of Nystrom attention on np_ (landmark-padded) tokens,
    all heads: q k_lm^T, attn1 B, q_lm k^T, attn3 v (each 2 np_ m d), the
    landmark scores and B = pinv attn3_v (each 2 m^2 d) and the pinv (four
    m x m x m products an iteration)."""
    return heads * (4 * 2.0 * np_ * m * d + 2 * 2.0 * m * m * d + iters * 4 * 2.0 * m ** 3)


def translayer_ops(np_: int, dim: int = 512, heads: int = 8, d: int = 64, m: int = 256) -> float:
    """One TransLayer on np_ padded tokens: qkv, attention, the 33-tap value
    residual, the out projection."""
    inner = heads * d
    return (2.0 * np_ * dim * 3 * inner + nystrom_ops(np_, heads, d, m)
            + 2.0 * 33 * np_ * inner + 2.0 * np_ * inner * dim)


def transmil_ops(n: int, in_features: int = 2048, dim: int = 512, n_classes: int = 2) -> float:
    """Float operations of one TransMIL forward on an n-row bag: fc1 on the
    real rows, two TransLayers, PPEG (7x7, 5x5, 3x3 depthwise) on the square
    grid, the classifier."""
    side2 = square_side(n) ** 2
    _, np_ = transmil_tokens(n)
    half = in_features // 2
    fc1 = 2.0 * n * (in_features * half + half * dim)
    ppeg = 2.0 * side2 * dim * (49 + 25 + 9)
    return fc1 + 2 * translayer_ops(np_, dim) + ppeg + 2.0 * dim * n_classes


def translayer_kernel_costs(t: int, dim: int = 512, m: int = 256) -> dict:
    """(float operations, least bytes) of K1 and K2 on one layer of t tokens
    (batch 1): every input read once, every output written once, float32.
    K1: LayerNorm, [K|V] = LN(x) W_kv^T, the landmark kernel over t + pad
    keys; K2: LayerNorm, Q, the query kernel, the out projection."""
    pad = landmark_pad(t, m)
    act, w, lm, vec = t * dim * 4, dim * dim * 4, m * dim * 4, dim * 4
    return {
        "k1": (2.0 * t * dim * 2 * dim + 2 * 2.0 * m * (t + pad) * dim,
               act + 2 * vec + 2 * w + lm + lm + act),
        "k2": (2.0 * t * dim * dim * 2 + 2 * 2.0 * m * t * dim,
               2 * act + 3 * vec + 2 * w + 2 * lm + act),
    }


def translayer_least_s(n: int) -> float:
    """Least seconds of K1 and K2 of both TransLayers on an n-row bag."""
    t, _ = transmil_tokens(n)
    return 2 * sum(least_s(*c) for c in translayer_kernel_costs(t).values())


def nystrom_kernel_costs(b: int, np_: int, heads: int = 8, d: int = 64, m: int = 256) -> dict:
    """(float operations, least bytes) of the landmark kernel (B5: q_lm, k,
    v -> attn3 v) and the query kernel (B6: q, k_lm, B -> out) on one call."""
    ops = 4.0 * m * np_ * heads * d * b
    plane, lm = b * np_ * heads * d * 4, b * heads * m * d * 4
    return {"landmark": (ops, lm + 2 * plane + lm), "query": (ops, plane + 2 * lm + plane)}


def nystrom_least_s(b: int, np_: int) -> float:
    """Least seconds of one B5 and one B6 launch."""
    return sum(least_s(*c) for c in nystrom_kernel_costs(b, np_).values())
