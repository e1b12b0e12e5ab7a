"""Int8 post-training-quantized ResNet50 feature extractor (port of
``models/resnet_int8.py``).

Everything stays in the quantized domain, as in the JAX package:

- BN folds into per-channel conv scale/bias; weights quantize per output
  channel, symmetric int8; post-stem activations are ReLU outputs stored with
  zero point -128 (the zero-point term folds into the bias).
- Every conv epilogue is one folded per-channel fma on the int32 accumulator,
  ``q_next = clip(round(acc * m + z), -128, 127)``; ReLU is the clip floor.
- Residuals add in the same folded domain: ``acc3 * m3 + x * id_mult + z3``
  (identity) or ``acc3 * m3 + accd * md + z3`` (downsample).
- 3x3 convs pad with -128, the code of x = 0.
- The stem is a space-to-depth 4x4 int8 conv on symmetric input codes.

On a CUDA device the stem and the bottleneck stages run as the hand-written
kernels of ``ops/qstage_kernel.py`` (``csrc/qstage.cu``): ``_stem_q`` runs the
input quantization, the stem conv, its requant and the 3x3/2 max-pool as one
stem-kernel launch (XLA ops in JAX), ``apply_qresnet50`` runs stage 1 as one
stage-kernel launch and each later stage as one entry-kernel launch plus one
stage-kernel launch. The average pool is torch ops.

Numerics. The plain path repeats XLA:CPU's arithmetic bit for bit: integer
convolutions run as float64 im2col matmuls (exact below 2**53), and the
epilogues emulate the single fused multiply-add that XLA contracts
``acc * m + z`` into (``fma(acc, m, z)``; for the residual
``fma(acc3, m3, idn) + z3``) as a float64 ``a * b + c`` rounded once to
float32.

Calibration (``_calibrate``) runs in float64 where JAX runs float32 (its stem
in bf16), so the calibrated scales agree with JAX's to rounding, not to the
bit; ``utils/jax_params.qresnet_from_jax`` carries JAX's constants across
when bit-exact codes are wanted.

The JAX package's TPU layout variants are here too:
``apply_qresnet50_wpack1`` runs stage 1 on the W-pair-packed grid
(``ops/qstage_kernel.fused_stage_wpacked``: the stage kernel with
``pack_wpair_block`` weights on the card; bit-exact), and
``apply_stage_wpacked_xla`` is that stage's plain version;
``apply_qresnet50_bf16s1`` runs the stem and stage 1 as bf16 convolutions
summed in float32 (``build_bf16_stage1``) and quantizes once into stage 2's
input code. They were TPU layout devices (the packed grid fills its 128-lane
tiles at C = 64; bf16 beat int8 at C = 64 on its matrix unit); on the card
they compute the same features by other routes and are not expected to be
faster.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.ops.quantization import (
    fold_bn,
    quantize_weight,
    zero_point_bias,
)
from transmil_deepgraft_tpu_torch.utils.profiling import span

LAYERS_R50 = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
EXPANSION = 4
# ResNet50 block-index boundaries: layer1 = blocks[0:3] (all stride 1),
# layer{2,3,4} = one stride-2 entry + stride-1 interiors.
_STAGE_SLICES = ((0, 3), (3, 7), (7, 13), (13, 16))


def _block_plan(truncate_after: int = 4):
    """Yields (name, stride, has_downsample) for every bottleneck block."""
    in_planes = 64
    for stage in range(truncate_after):
        p, s = PLANES[stage], STRIDES[stage]
        for b in range(LAYERS_R50[stage]):
            stride = s if b == 0 else 1
            has_ds = b == 0 and (stride != 1 or in_planes != p * EXPANSION)
            yield f"layer{stage + 1}_{b}", stride, has_ds
            in_planes = p * EXPANSION


def _fold_all(variables: dict, truncate_after: int) -> dict:
    """{key: (folded_kernel f64, folded_bias f64)} for stem + every block conv.
    ``variables``: flax-layout {'params','batch_stats'} of numpy arrays."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def fold(conv_tree, bn_p, bn_s):
        return fold_bn(
            np.asarray(conv_tree["kernel"], np.float64),
            np.asarray(bn_p["scale"], np.float64),
            np.asarray(bn_p["bias"], np.float64),
            np.asarray(bn_s["mean"], np.float64),
            np.asarray(bn_s["var"], np.float64),
        )

    folded = {"conv1": fold(params["conv1"], params["bn1"], stats["bn1"])}
    for name, _, has_ds in _block_plan(truncate_after):
        bp, bs = params[name], stats[name]
        for i in (1, 2, 3):
            folded[f"{name}.conv{i}"] = fold(bp[f"conv{i}"], bp[f"bn{i}"], bs[f"bn{i}"])
        if has_ds:
            folded[f"{name}.downsample"] = fold(
                bp["downsample_conv"], bp["downsample_bn"], bs["downsample_bn"]
            )
    return folded


# ----------------------------------------------------------- calibration

def _oihw(kernel: np.ndarray, dev: torch.device) -> torch.Tensor:
    """HWIO numpy kernel -> OIHW float64 tensor holding its float32 values
    (JAX casts the folded kernel to the activations' float32)."""
    k = torch.from_numpy(np.asarray(kernel, np.float32).astype(np.float64))
    return k.permute(3, 2, 0, 1).contiguous().to(dev)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's "SAME" padding of an NCHW tensor: (total // 2, total - total // 2);
    for a stride-2 3x3 conv on an even size that is (0, 1)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_f64(x, kernel, bias, stride=1):
    """Calibration conv (``_conv_f32`` in JAX, with its "SAME" padding), in float64."""
    out = F.conv2d(_same_pad(x, kernel.shape[-1], stride), kernel, stride=stride)
    return out + bias.view(1, -1, 1, 1)


def _stem(x, kernel, bias):
    """Stem conv on bf16-rounded input and kernel (JAX's bf16 stem), summed in
    float64, + relu + 3x3/2 maxpool. x NCHW float64."""
    bf = torch.bfloat16
    out = F.conv2d(x.to(bf).double(), kernel.to(bf).double(), stride=2, padding=3)
    out = F.relu(out + bias.view(1, -1, 1, 1))
    return F.max_pool2d(out, 3, stride=2, padding=1)


def _calibrate(folded: dict, tiles: np.ndarray, truncate_after: int,
               dev: torch.device) -> dict:
    """Float forward with folded weights on ``dev``, recording max|x| per conv
    input (plus the final block output under key 'final')."""
    record: dict[str, float] = {}

    def note(key, x):
        record[key] = float(x.abs().max())

    def conv(key, x, stride=1):
        k, b = folded[key]
        bias = torch.from_numpy(np.asarray(b, np.float32).astype(np.float64)).to(dev)
        return _conv_f64(x, _oihw(k, dev), bias, stride)

    x = torch.from_numpy(np.asarray(tiles, np.float32)).to(dev).double()
    record["input"] = float(x.abs().max())
    k, b = folded["conv1"]
    out = _stem(x.permute(0, 3, 1, 2), _oihw(k, dev),
                torch.from_numpy(np.asarray(b, np.float32).astype(np.float64)).to(dev))
    for name, stride, has_ds in _block_plan(truncate_after):
        identity = out
        note(f"{name}.conv1", out)
        h = F.relu(conv(f"{name}.conv1", out))
        note(f"{name}.conv2", h)
        h = F.relu(conv(f"{name}.conv2", h, stride))
        note(f"{name}.conv3", h)
        h = conv(f"{name}.conv3", h)
        if has_ds:
            identity = conv(f"{name}.downsample", out, stride)
        out = F.relu(h + identity)
    note("final", out)
    return record


# ------------------------------------------------------------- the model

class QBlock(NamedTuple):
    """One bottleneck with every scale folded into per-channel fma constants
    (torch tensors, HWIO int8 kernels)."""

    w1: torch.Tensor  # int8 (1,1,Cin,Mid)
    m1: torch.Tensor  # (Mid,) f32: s_in1*s_w1 / s_in2
    z1: torch.Tensor  # (Mid,) f32: bias'/s_in2 - 128
    w2: torch.Tensor  # int8 (3,3,Mid,Mid)
    m2: torch.Tensor
    z2: torch.Tensor
    w3: torch.Tensor  # int8 (1,1,Mid,Cout)
    m3: torch.Tensor  # (Cout,) f32: s_in3*s_w3 / s_out
    z3: torch.Tensor  # (Cout,) f32: combined conv3+identity bias in out units, -128
    wd: Optional[torch.Tensor]  # int8 downsample kernel or None
    md: Optional[torch.Tensor]  # (Cout,) or None
    id_mult: torch.Tensor  # () f32: s_id/s_out (identity fma; unused when wd set)

    def to(self, device) -> "QBlock":
        return QBlock(*(None if t is None else t.to(device) for t in self))


class QResNet50(NamedTuple):
    stem_w: torch.Tensor  # int8 (4,4,12,64): space-to-depth folded 7x7/s2 stem
    stem_m: torch.Tensor  # (64,) f32 folded fma multiplier
    stem_z: torch.Tensor  # (64,) f32 folded fma bias (-128-shifted)
    input_scale: torch.Tensor  # () f32: symmetric input quantization scale
    blocks: tuple  # tuple[QBlock, ...]
    final_scale: torch.Tensor  # () f32: dequant scale for the pooled features
    truncate_after: int
    feature_dim: int

    def to(self, device) -> "QResNet50":
        return self._replace(
            stem_w=self.stem_w.to(device), stem_m=self.stem_m.to(device),
            stem_z=self.stem_z.to(device), input_scale=self.input_scale.to(device),
            blocks=tuple(b.to(device) for b in self.blocks),
            final_scale=self.final_scale.to(device),
        )


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def build_qresnet50(
    variables: dict, calib_tiles: np.ndarray, truncate_after: int = 4,
    device: str | torch.device | None = None,
) -> QResNet50:
    """variables: the fp32 ResNet50 {'params','batch_stats'} in flax layout
    (numpy); calib_tiles: (N, H, W, 3) representative tiles for
    activation-scale calibration. Calibrates on ``device`` (None = CUDA) and
    returns the model there."""
    dev = resolve_device(device)
    folded = _fold_all(variables, truncate_after)
    record = _calibrate(folded, calib_tiles, truncate_after, dev)

    def act_scale(key: str) -> float:
        return max(record[key], 1e-12) / 255.0

    plan = list(_block_plan(truncate_after))
    blocks: list[QBlock] = []
    for i, (name, stride, has_ds) in enumerate(plan):
        s_in1 = act_scale(f"{name}.conv1")
        s_in2 = act_scale(f"{name}.conv2")
        s_in3 = act_scale(f"{name}.conv3")
        s_out = (
            act_scale(f"{plan[i + 1][0]}.conv1") if i + 1 < len(plan) else act_scale("final")
        )

        def qc(key, s_in):
            k, b = folded[key]
            w_q, s_w = quantize_weight(np.asarray(k, np.float32))
            bias_eff = np.asarray(b, np.float64) + zero_point_bias(w_q, s_in, s_w)
            return w_q, s_in * s_w.astype(np.float64), bias_eff

        w1, sk1, b1 = qc(f"{name}.conv1", s_in1)
        w2, sk2, b2 = qc(f"{name}.conv2", s_in2)
        w3, sk3, b3 = qc(f"{name}.conv3", s_in3)

        z3 = b3 / s_out - 128.0
        if has_ds:
            wd, skd, bd = qc(f"{name}.downsample", s_in1)
            md = _f32(skd / s_out)
            wd = torch.from_numpy(wd)
            z3 = z3 + bd / s_out
            id_mult = np.float64(0.0)
        else:
            wd = md = None
            # identity q (zero point -128): y_id = (id_q + 128) * s_in1
            id_mult = s_in1 / s_out
            z3 = z3 + 128.0 * id_mult

        blocks.append(QBlock(
            w1=torch.from_numpy(w1), m1=_f32(sk1 / s_in2), z1=_f32(b1 / s_in2 - 128.0),
            w2=torch.from_numpy(w2), m2=_f32(sk2 / s_in3), z2=_f32(b2 / s_in3 - 128.0),
            w3=torch.from_numpy(w3), m3=_f32(sk3 / s_out), z3=_f32(z3),
            wd=wd, md=md, id_mult=_f32(id_mult),
        ))

    # Stem as a space-to-depth int8 conv: the 7x7/s2 conv on (H, W, 3) is a
    # 4x4/s1 conv on the s2d-by-2 input (H/2, W/2, 12) with the kernel
    # zero-padded to 8x8 at the top-left and reshaped to the (di, dj, ci)
    # channel packing. Inputs quantize symmetrically, so the implicit zero
    # padding and the s2d reshape stay exact.
    stem_k, stem_b = folded["conv1"]
    k8 = np.zeros((8, 8, 3, 64))
    k8[1:, 1:] = np.asarray(stem_k)
    k_s2d = k8.reshape(4, 2, 4, 2, 3, 64).transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, 64)
    stem_wq, stem_sw = quantize_weight(np.asarray(k_s2d, np.float32))
    s_inp = max(record["input"], 1e-12) / 127.0
    s_block1 = act_scale(f"{plan[0][0]}.conv1")
    return QResNet50(
        stem_w=torch.from_numpy(stem_wq),
        stem_m=_f32(s_inp * stem_sw.astype(np.float64) / s_block1),
        stem_z=_f32(np.asarray(stem_b, np.float64) / s_block1 - 128.0),
        input_scale=_f32(s_inp),
        blocks=tuple(blocks),
        final_scale=_f32(act_scale("final")),
        truncate_after=truncate_after,
        feature_dim=PLANES[truncate_after - 1] * EXPANSION,
    ).to(dev)


class QResNet50Fused(NamedTuple):
    """``QResNet50`` plus the W-pair-packed stage-1 blocks of
    ``ops/qstage_kernel.pack_wpair_block``. The packing is a TPU lane-layout
    device; on the card stage 1 runs unpacked, and the packed blocks serve
    callers of ``fused_stage_wpacked``."""

    q: QResNet50
    stage1_packed: tuple  # tuple[QBlock, ...] from pack_wpair_block


def prepare_qresnet50_fused(q: QResNet50) -> QResNet50Fused:
    from transmil_deepgraft_tpu_torch.ops.qstage_kernel import pack_wpair_block

    if q.truncate_after != 4:
        raise ValueError("fused path currently supports the full 4-stage net")
    s1 = tuple(pack_wpair_block(b) for b in q.blocks[0:3])
    return QResNet50Fused(q=q, stage1_packed=s1)


# ------------------------------------------------------ quantized forward

def _conv_q(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Unpadded int8 conv of NHWC codes with an HWIO kernel -> the exact int32
    accumulator as float64 NHWC: im2col in (di, dj, ci) order, one matmul."""
    kh, kw, cin, cout = w_q.shape
    x = x_q.double()
    _, h, w, _ = x.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    cols = [x[:, di:di + (ho - 1) * stride + 1:stride, dj:dj + (wo - 1) * stride + 1:stride]
            for di in range(kh) for dj in range(kw)]
    cols = torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]
    return cols @ w_q.reshape(kh * kw * cin, cout).double()


def _rq(acc: torch.Tensor, m: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """int32 accumulator (exact, any float dtype) -> next layer's int8 code:
    ``clip(round(fma(float32(acc), m, z)))``, the fma emulated in float64 and
    rounded once to float32. ReLU is implicit: y <= 0 lands at the clip floor."""
    y = (acc.float().double() * m.double() + z.double()).float()
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def _rq_residual(acc3: torch.Tensor, m3: torch.Tensor, idn: torch.Tensor,
                 z3: torch.Tensor) -> torch.Tensor:
    """Block output code: ``clip(round(fma(float32(acc3), m3, idn) + z3))``,
    with ``idn`` the float32 identity term (``x * id_mult`` or ``accd * md``)."""
    t = (acc3.float().double() * m3.double() + idn.double()).float()
    return torch.clamp(torch.round(t + z3), -128, 127).to(torch.int8)


def _plain_block(x: torch.Tensor, blk: QBlock, stride: int) -> torch.Tensor:
    """One quantized bottleneck on NHWC int8 codes (the XLA block of JAX)."""
    h = _rq(_conv_q(x, blk.w1), blk.m1, blk.z1)
    # explicit -128 pad: a zero pad would inject q = 0 == x = 128 * s
    h = F.pad(h, (0, 0, 1, 1, 1, 1), value=-128)
    h = _rq(_conv_q(h, blk.w2, stride), blk.m2, blk.z2)
    acc3 = _conv_q(h, blk.w3)
    if blk.wd is not None:
        idn = _conv_q(x, blk.wd, stride).float() * blk.md
    else:
        idn = x.float() * blk.id_mult
    return _rq_residual(acc3, blk.m3, idn, blk.z3)


def _plain_blocks(x: torch.Tensor, blocks, strides) -> torch.Tensor:
    for blk, s in zip(blocks, strides):
        x = _plain_block(x, blk, s)
    return x


def _plain_stem(q: QResNet50, tiles: torch.Tensor) -> torch.Tensor:
    """The stem as torch ops: input quantization, space-to-depth stem conv,
    requant, 3x3/2 max-pool with a -128 floor: (N, H, W, 3) float -> (N, H/4,
    W/4, 64) int8 codes."""
    n, hh, ww, _ = tiles.shape
    x_q = torch.clamp(torch.round(tiles.float() / q.input_scale), -127, 127).to(torch.int8)
    # space-to-depth by 2: (N, H, W, 3) -> (N, H/2, W/2, 12), channel (di,dj,ci)
    x_q = x_q.reshape(n, hh // 2, 2, ww // 2, 2, 3)
    x_q = x_q.permute(0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 12)
    x_q = F.pad(x_q, (0, 0, 2, 1, 2, 1))  # zero is exact: symmetric input codes
    stem_q = _rq(_conv_q(x_q, q.stem_w), q.stem_m, q.stem_z)
    pooled = F.max_pool2d(
        F.pad(stem_q.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), value=-128.0), 3, stride=2)
    return pooled.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _stem_q(q: QResNet50, tiles: torch.Tensor) -> torch.Tensor:
    """The stem of every int8 route: (N, H, W, 3) float -> (N, H/4, W/4, 64)
    int8 codes, as float32 through ``ops/qstage_kernel.fused_stem`` (one
    kernel launch on a CUDA tensor, :func:`_plain_stem` on a CPU one)."""
    from transmil_deepgraft_tpu_torch.ops.qstage_kernel import fused_stem

    with span("backbone.stem"):
        return fused_stem(tiles.float().contiguous(), q)


def _pool(q: QResNet50, out_q: torch.Tensor) -> torch.Tensor:
    """Dequantized global average pool: mean((q + 128) * s). The sum of the
    codes is exact in float32; it is divided by the count, as jnp.mean does."""
    count = out_q.shape[1] * out_q.shape[2]
    return (out_q.float().sum(dim=(1, 2)) / count + 128.0) * q.final_scale


def _forward(q: QResNet50, tiles: torch.Tensor, t_cfg: tuple) -> torch.Tensor:
    from transmil_deepgraft_tpu_torch.ops.qstage_kernel import fused_bottleneck_stage

    out = _stem_q(q, tiles)
    t1, *rest = t_cfg
    lo, hi = _STAGE_SLICES[0]
    if t1:
        out = fused_bottleneck_stage(out, q.blocks[lo:hi], tiles_per_step=t1)
    else:
        out = _plain_blocks(out, q.blocks[lo:hi], [1] * (hi - lo))
    return _pool(q, _later_stages(q, out, tuple(rest)))


def _later_stages(q: QResNet50, out: torch.Tensor, rest: tuple = (1,) * 6) -> torch.Tensor:
    """Stages 2.. on stage 1's output codes: each stage's entry kernel, then
    its stage kernel (``rest`` = tiles-per-step for (e2, i2, e3, i3, e4,
    i4); a 0 takes that segment's plain block loop)."""
    from transmil_deepgraft_tpu_torch.ops.qstage_kernel import (
        fused_bottleneck_stage,
        fused_entry_block,
    )

    for stage in range(1, q.truncate_after):
        lo, hi = _STAGE_SLICES[stage]
        te, ti = rest[2 * stage - 2], rest[2 * stage - 1]
        if te:
            out = fused_entry_block(out, q.blocks[lo], tiles_per_step=te)
        else:
            out = _plain_blocks(out, q.blocks[lo:lo + 1], [2])
        if ti:
            out = fused_bottleneck_stage(out, q.blocks[lo + 1:hi], tiles_per_step=ti)
        else:
            out = _plain_blocks(out, q.blocks[lo + 1:hi], [1] * (hi - lo - 1))
    return out


def apply_qresnet50(q: QResNet50, tiles: torch.Tensor) -> torch.Tensor:
    """tiles (N, H, W, 3) float (H, W divisible by 32) on the model's device
    -> features (N, feature_dim) float32. On CUDA the stages run the
    stage/entry kernels; on the CPU their plain versions."""
    return _forward(q, tiles, (1,) * 7)


def apply_qresnet50_fused(
    prep: QResNet50Fused, tiles: torch.Tensor, *, t_cfg: tuple = (1, 2, 4, 4, 4, 4, 4),
) -> torch.Tensor:
    """``apply_qresnet50`` with the JAX package's per-segment control:
    ``t_cfg`` = tiles-per-step for (s1, e2, i2, e3, i3, e4, i4), each of which
    must divide the batch (on the card it is only that check). A ``0`` entry
    sends that segment through the plain block loop instead of its kernel."""
    return _forward(prep.q, tiles, t_cfg)


# ------------------------------------------------------ TPU layout variants

def apply_stage_wpacked_xla(x_q: torch.Tensor, packed_blocks) -> torch.Tensor:
    """A stride-1 stage on the W-pair-packed grid, plain: the (N, H, W, C)
    codes viewed as (N, H, W/2, 2C) (a free reshape) through the quantized
    block loop with ``pack_wpair_block`` weights, then viewed back. The same
    integer arithmetic as the unpacked loop, so bit-exact to it."""
    n, hh, ww, cin = x_q.shape
    out = _plain_blocks(x_q.reshape(n, hh, ww // 2, 2 * cin), packed_blocks,
                        [1] * len(packed_blocks))
    return out.reshape(n, hh, ww, out.shape[-1] // 2)


def apply_qresnet50_wpack1(prep: QResNet50Fused, tiles: torch.Tensor) -> torch.Tensor:
    """``apply_qresnet50`` with stage 1 on the W-pair-packed grid
    (``ops/qstage_kernel.fused_stage_wpacked``: one stage-kernel launch with
    the packed blocks on the card, :func:`apply_stage_wpacked_xla`'s plain
    loop on the CPU); stages 2-4 as ``apply_qresnet50`` runs them.
    Bit-exact to it."""
    from transmil_deepgraft_tpu_torch.ops.qstage_kernel import fused_stage_wpacked

    q = prep.q
    out = fused_stage_wpacked(_stem_q(q, tiles), q.blocks[0:3], packed_blocks=prep.stage1_packed)
    return _pool(q, _later_stages(q, out))


class BF16Stage1(NamedTuple):
    """The folded stem and stage 1 for the mixed-precision variant: bf16
    kernels (OIHW), float32 biases, and stage 2's input scale from the same
    calibration as ``build_qresnet50`` (so stages 2-4 see the same codes'
    meaning)."""

    stem_k: torch.Tensor  # bf16 (64, 3, 7, 7) BN-folded stem kernel
    stem_b: torch.Tensor  # (64,) f32
    convs: tuple  # per stage-1 block: (k1, b1, k2, b2, k3, b3[, kd, bd])
    out_scale: torch.Tensor  # () f32: the scale of layer2_0.conv1's input

    def to(self, device) -> "BF16Stage1":
        return BF16Stage1(self.stem_k.to(device), self.stem_b.to(device),
                          tuple(tuple(t.to(device) for t in c) for c in self.convs),
                          self.out_scale.to(device))


def build_bf16_stage1(variables: dict, calib_tiles: np.ndarray,
                      device: str | torch.device | None = None) -> BF16Stage1:
    """Companion to ``build_qresnet50`` (the same calibration tiles give the
    same stage-2 input scale), on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    folded = _fold_all(variables, 4)
    record = _calibrate(folded, calib_tiles, 4, dev)
    s_out = max(record["layer2_0.conv1"], 1e-12) / 255.0

    def kb(key):
        k, b = folded[key]
        return (_oihw(k, torch.device("cpu")).float().to(torch.bfloat16), _f32(b))

    convs = []
    for i in range(3):
        parts = []
        for conv in ("conv1", "conv2", "conv3", "downsample"):
            if f"layer1_{i}.{conv}" in folded:
                parts += kb(f"layer1_{i}.{conv}")
        convs.append(tuple(parts))
    stem_k, stem_b = kb("conv1")
    return BF16Stage1(stem_k, stem_b, tuple(convs), _f32(s_out)).to(dev)


def _conv_bf16(x: torch.Tensor, k: torch.Tensor, stride: int = 1, padding: int = 0):
    """A convolution of bf16-rounded NCHW input and bf16 kernel, summed in
    float32 (XLA's ``preferred_element_type=float32``). The bf16 values run
    through a float32 convolution: every product is exact, and on the card
    TF32 (allowed here) holds bf16 values exactly, so cuDNN may take its
    tensor-core route without changing a bit."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        return F.conv2d(x.to(torch.bfloat16).float(), k.float(), stride=stride, padding=padding)


def _bf16_stage1_codes(s1: BF16Stage1, tiles: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) float tiles -> stage 2's (N, H/4, W/4, 256) int8 input
    codes: the bf16 stem + max-pool + stage 1, then one quantization (zero
    point -128)."""
    x = tiles.permute(0, 3, 1, 2)
    h = F.relu(_conv_bf16(x, s1.stem_k, stride=2, padding=3) + s1.stem_b.view(1, -1, 1, 1))
    h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=-float("inf")), 3, stride=2)
    for parts in s1.convs:
        k1, b1, k2, b2, k3, b3 = parts[:6]
        y = F.relu(_conv_bf16(h, k1) + b1.view(1, -1, 1, 1))
        y = F.relu(_conv_bf16(y, k2, padding=1) + b2.view(1, -1, 1, 1))
        y = _conv_bf16(y, k3) + b3.view(1, -1, 1, 1)
        idn = _conv_bf16(h, parts[6]) + parts[7].view(1, -1, 1, 1) if len(parts) == 8 else h
        h = F.relu(y + idn)
    out_q = torch.clamp(torch.round(h / s1.out_scale) - 128.0, -128, 127).to(torch.int8)
    return out_q.permute(0, 2, 3, 1).contiguous()


def apply_qresnet50_bf16s1(q: QResNet50, s1: BF16Stage1, tiles: torch.Tensor) -> torch.Tensor:
    """Mixed-precision forward: bf16 stem and stage 1 (summed in float32),
    one quantization into stage 2's input code, int8 stages 2-4 (the entry
    and stage kernels on the card)."""
    return _pool(q, _later_stages(q, _bf16_stage1_codes(s1, tiles)))
