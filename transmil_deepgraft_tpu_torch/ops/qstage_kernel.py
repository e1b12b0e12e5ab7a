"""Fused int8 bottleneck stages of the quantized ResNet50 (port of
``ops/pallas/qstage_kernel.py``), and its stem.

Two hand-written CUDA kernels (``csrc/qstage.cu``) replace the two Pallas TPU
kernels, and a third runs the stem, which JAX leaves to XLA:

  qstage_run (B7, replaces ``_stage_kernel``): a run of stride-1 bottlenecks,
      1x1 -> requant -> 3x3 over a -128 pad -> requant -> 1x1 + (identity fma
      or 1x1 downsample) -> clip/round. Stage 1 and the interior of stages 2-4.
  qentry_run (B8, replaces ``_entry_kernel``): one stride-2 stage-entry
      bottleneck, 1x1 at full resolution, 3x3/s2 over a -128 pad, 1x1 +
      the 1x1/s2 downsample projection.
  qstem_run (``stem_kernel``): the stem of ``models/resnet_int8._stem_q``,
      float32 tiles -> input quantize -> space-to-depth 4x4 int8 conv ->
      requant -> 3x3/2 max-pool over a -128 pad, in one launch and without
      a device-memory intermediate; the codes equal the torch-op route's
      (``_plain_stem``) bit for bit.

The two stage launchers run one int8 implicit-GEMM kernel three times a
bottleneck (conv1, conv2, conv3 with the identity or the downsample in the
same launch):
``wgmma`` s8 with int32 accumulation from a ``cp.async`` ring in shared memory,
with the folded-fma epilogue of ``models/resnet_int8`` written so that it
rounds exactly where XLA:CPU does. conv1 stores its codes as u8 = code + 128,
so the 3x3 pad is a zero fill and conv2 subtracts 128 * colsum(w2)
(:func:`_prepare_block` makes the column sums). Intermediates live in device
scratch that the wrapper allocates.

A block's operands are prepared once (:func:`_prepare_block`: weights as
(Cout, K) with K contiguous, scales stacked, column sums) and kept while the
block's tensors live; ``PREPARES`` counts the preparations.

Each wrapper (:func:`fused_bottleneck_stage`, :func:`fused_entry_block`,
:func:`fused_stem`) launches its kernel on a CUDA tensor, uses its plain
version (:func:`stage_reference`, :func:`entry_reference`,
:func:`stem_reference`) on a CPU tensor, and raises on anything else.
``tiles_per_step`` (the TPU grid step) is only checked for dividing the
batch: the CUDA kernels tile rows, not images.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Sequence

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.models.resnet_int8 import QBlock, _plain_blocks, _plain_stem
from transmil_deepgraft_tpu_torch.ops import _build
from transmil_deepgraft_tpu_torch.utils.profiling import count

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES = {"qstage_run": 0, "qentry_run": 0, "qstem_run": 0}
# Blocks prepared for the kernels (_prepare_block) since import.
PREPARES = {"blocks": 0}
CHANNEL_MULTIPLE = 64  # the kernels' K and N tiles


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _QBlockArgs(ctypes.Structure):
    """Mirror of ``QBlockArgs`` in ``csrc/qstage.cu``."""

    _fields_ = [
        ("w1", ctypes.c_void_p), ("w2", ctypes.c_void_p), ("w3", ctypes.c_void_p),
        ("wd", ctypes.c_void_p), ("sc1", ctypes.c_void_p), ("sc2", ctypes.c_void_p),
        ("cs2", ctypes.c_void_p), ("sc3", ctypes.c_void_p), ("md", ctypes.c_void_p),
        ("id_mult", ctypes.c_void_p),
        ("cin", ctypes.c_int), ("cmid", ctypes.c_int), ("cout", ctypes.c_int),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (once a process)."""
    lib = _build.load("qstage")
    lib.qstage_run.argtypes = [_P] * 6 + [ctypes.POINTER(_QBlockArgs), _I, _I, _I, _I, _P]
    lib.qstage_run.restype = _I
    lib.qentry_run.argtypes = [_P] * 4 + [ctypes.POINTER(_QBlockArgs), _I, _I, _I, _P]
    lib.qentry_run.restype = _I
    lib.qstem_run.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.qstem_run.restype = _I
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA (kernel); raises
    for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"the int8 stage kernels run on CUDA or CPU tensors, not {x.device}")


def _pack_block(blk: QBlock) -> tuple[list, bool]:
    """QBlock -> (arrays, has_ds) in the JAX kernel's layout: w1 (Cin, Cmid),
    sc1 (2, Cmid) [m; z], w2 (9*Cmid, Cmid) in (di, dj, ci) row order, sc2,
    w3 (Cmid, Cout), sc3, then wd (Cin, Cout) and md (1, Cout), or id_mult as
    (1, 1). :func:`_prepare_block` transposes these weights for the CUDA
    kernels."""
    w1 = blk.w1.reshape(blk.w1.shape[-2], blk.w1.shape[-1])
    w2 = blk.w2.reshape(-1, blk.w2.shape[-1])
    w3 = blk.w3.reshape(blk.w3.shape[-2], blk.w3.shape[-1])
    sc1 = torch.stack([blk.m1, blk.z1])
    sc2 = torch.stack([blk.m2, blk.z2])
    sc3 = torch.stack([blk.m3, blk.z3])
    arrays = [w1, sc1, w2, sc2, w3, sc3]
    if blk.wd is not None:
        arrays += [blk.wd.reshape(blk.wd.shape[-2], blk.wd.shape[-1]), blk.md.reshape(1, -1)]
        return arrays, True
    arrays += [blk.id_mult.float().reshape(1, 1)]
    return arrays, False


class _Prepared(NamedTuple):
    """One block's operands for the CUDA kernels, and their C struct."""

    w1: torch.Tensor  # int8 (Cmid, Cin)
    w2: torch.Tensor  # int8 (Cmid, 9*Cmid), K in (di, dj, ci) order
    w3: torch.Tensor  # int8 (Cout, Cmid)
    wd: torch.Tensor | None  # int8 (Cout, Cin)
    sc1: torch.Tensor  # float32 (2, Cmid) [m; z]
    sc2: torch.Tensor  # float32 (2, Cmid)
    cs2: torch.Tensor  # int32 (Cmid,): sum over K of w2
    sc3: torch.Tensor  # float32 (2, Cout)
    md: torch.Tensor | None  # float32 (Cout,)
    id_mult: torch.Tensor  # float32 (1,), read on the device
    args: _QBlockArgs


def _prepare_block(blk: QBlock) -> _Prepared:
    """A block's operands for the kernels: each weight as (Cout, K) with K
    contiguous, in the (di, dj, ci) K order of :func:`_pack_block` (the
    K-major operand of ``wgmma``, copied 16 bytes at a time); [m; z] stacked
    per conv; conv2's column sums, for the u8 offset of its input."""
    cin, cmid = blk.w1.shape[-2:]
    cout = blk.w3.shape[-1]
    dev = blk.w1.device
    if tuple(blk.w2.shape[-3:]) != (3, cmid, cmid) or blk.w3.shape[-2] != cmid:
        raise ValueError(f"inconsistent block widths: w1 {tuple(blk.w1.shape)}, "
                         f"w2 {tuple(blk.w2.shape)}, w3 {tuple(blk.w3.shape)}")
    has_ds = blk.wd is not None
    if not has_ds and cin != cout:
        raise ValueError(f"an identity block needs Cin == Cout, got {cin} -> {cout}")
    weights = [("w1", blk.w1), ("w2", blk.w2), ("w3", blk.w3)] + ([("wd", blk.wd)] if has_ds else [])
    consts = [("m1", blk.m1), ("z1", blk.z1), ("m2", blk.m2), ("z2", blk.z2), ("m3", blk.m3),
              ("z3", blk.z3), ("id_mult", blk.id_mult)] + ([("md", blk.md)] if has_ds else [])
    for name, t, dtype in [(n, t, torch.int8) for n, t in weights] + \
            [(n, t, torch.float32) for n, t in consts]:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if has_ds and tuple(blk.wd.shape[-2:]) != (cin, cout):
        raise ValueError(f"downsample kernel must be ({cin}, {cout}), got {tuple(blk.wd.shape)}")
    w2k = blk.w2.reshape(9 * cmid, cmid)
    prep = dict(
        w1=blk.w1.reshape(cin, cmid).t().contiguous(),
        w2=w2k.t().contiguous(),
        w3=blk.w3.reshape(cmid, cout).t().contiguous(),
        wd=blk.wd.reshape(cin, cout).t().contiguous() if has_ds else None,
        sc1=torch.stack([blk.m1, blk.z1]).contiguous(),
        sc2=torch.stack([blk.m2, blk.z2]).contiguous(),
        cs2=w2k.sum(0, dtype=torch.int32),
        sc3=torch.stack([blk.m3, blk.z3]).contiguous(),
        md=blk.md.reshape(cout).contiguous() if has_ds else None,
        id_mult=blk.id_mult.reshape(1).contiguous(),
    )
    args = _QBlockArgs(cin=cin, cmid=cmid, cout=cout, **{
        k: None if v is None else v.data_ptr() for k, v in prep.items()})
    PREPARES["blocks"] += 1
    return _Prepared(**prep, args=args)


# id(block.w1) -> (identity of every tensor of the block, its preparation);
# an entry leaves when its w1 is collected.
_PREPARED: dict[int, tuple[tuple, _Prepared]] = {}


def _prepared(blk: QBlock) -> _Prepared:
    """:func:`_prepare_block` once per block: a later call with the same
    tensors, none changed in place since, reuses the preparation."""
    key = id(blk.w1)
    sig = tuple(None if t is None else (id(t), -1 if t.is_inference() else t._version)
                for t in blk)
    hit = _PREPARED.get(key)
    if hit is not None and hit[0] == sig:
        return hit[1]
    prep = _prepare_block(blk)
    if hit is None:
        weakref.finalize(blk.w1, _PREPARED.pop, key, None)
    _PREPARED[key] = (sig, prep)
    return prep


def _check_divides(n: int, tiles_per_step: int) -> None:
    if n % tiles_per_step:
        raise ValueError(f"N={n} not divisible by tiles_per_step={tiles_per_step}")


def _check_blocks(preps: Sequence[_Prepared], x_q: torch.Tensor) -> None:
    """The prepared blocks chain from x_q's channels, live on its device,
    have the kernels' channel multiples, and fit their 32-bit offsets."""
    n, h, w, cin = x_q.shape
    dev = x_q.device
    widest = max(max(p.args.cin, p.args.cmid, p.args.cout) for p in preps)
    if n * h * w * widest >= 2 ** 31:
        raise ValueError(f"the CUDA kernels address fewer than 2^31 codes an activation: "
                         f"split the batch of {n}")
    for p in preps:
        a = p.args
        if p.w1.device != dev:
            raise ValueError(f"the block's weights are on {p.w1.device}, x_q on {dev}")
        if a.cin % CHANNEL_MULTIPLE or a.cmid % CHANNEL_MULTIPLE or a.cout % CHANNEL_MULTIPLE:
            raise ValueError(f"the CUDA kernels take channel counts that are multiples of "
                             f"{CHANNEL_MULTIPLE}, got {a.cin}/{a.cmid}/{a.cout}")
        if a.cin != cin:
            raise ValueError("block input widths do not chain from x_q through the blocks")
        cin = a.cout


def _check_input(x_q: torch.Tensor) -> None:
    """The kernels read 16-byte runs of channels."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be (N, H, W, C) int8, got {x_q.dtype} {tuple(x_q.shape)}")
    if x_q.data_ptr() % 16:
        raise ValueError("x_q must be 16-byte aligned")


def _call(name: str, dev: torch.device, *args) -> None:
    """Run the C launcher ``name`` on the current stream of ``dev``."""
    lib = _library()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, name)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()} ({err})")


# ------------------------------------------------------------ plain versions

def stage_reference(x_q: torch.Tensor, blocks: Sequence[QBlock]) -> torch.Tensor:
    """Plain version of the stage kernel: the quantized block loop at stride 1."""
    return _plain_blocks(x_q, blocks, [1] * len(blocks))


def entry_reference(x_q: torch.Tensor, blk: QBlock) -> torch.Tensor:
    """Plain version of the entry kernel: one quantized block at stride 2."""
    return _plain_blocks(x_q, [blk], [2])


# ------------------------------------------------------------ B7: the stage

def fused_bottleneck_stage(
    x_q: torch.Tensor, blocks: Sequence[QBlock], *, tiles_per_step: int = 1,
) -> torch.Tensor:
    """Run stride-1 QBlocks: (N, H, W, Cin) int8 codes (zero point -128) ->
    (N, H, W, Cout) int8. N must be divisible by ``tiles_per_step``."""
    _check_divides(x_q.shape[0], tiles_per_step)
    if _on_cpu(x_q):
        return stage_reference(x_q, blocks)
    x_q = x_q.contiguous()
    _check_input(x_q)
    dev = x_q.device
    n, h, w, _ = x_q.shape
    preps = [_prepared(b) for b in blocks]
    _check_blocks(preps, x_q)
    rows = n * h * w
    cmid = max(p.args.cmid for p in preps)
    wide = max(p.args.cout for p in preps)
    h1 = torch.empty(rows * cmid, dtype=torch.uint8, device=dev)
    h2 = torch.empty(rows * cmid, dtype=torch.int8, device=dev)
    acts = [torch.empty(rows * wide, dtype=torch.int8, device=dev) if len(preps) > 1 else None
            for _ in range(2)]
    out = torch.empty((n, h, w, preps[-1].args.cout), dtype=torch.int8, device=dev)
    c_args = (_QBlockArgs * len(preps))(*(p.args for p in preps))
    _call("qstage_run", dev, x_q.data_ptr(), out.data_ptr(), h1.data_ptr(), h2.data_ptr(),
          *(None if a is None else a.data_ptr() for a in acts), c_args, len(preps), n, h, w)
    LAUNCHES["qstage_run"] += 1
    return out


# ------------------------------------------------------------ B8: the entry

def fused_entry_block(
    x_q: torch.Tensor, blk: QBlock, *, tiles_per_step: int = 1,
) -> torch.Tensor:
    """Stride-2 stage-entry bottleneck with its 1x1/s2 downsample projection:
    (N, 2H, 2W, Cin) int8 -> (N, H, W, Cout) int8."""
    if blk.wd is None:
        raise ValueError("entry block must carry a downsample projection")
    _check_divides(x_q.shape[0], tiles_per_step)
    if _on_cpu(x_q):
        return entry_reference(x_q, blk)
    x_q = x_q.contiguous()
    _check_input(x_q)
    dev = x_q.device
    n, h, w, _ = x_q.shape
    if h % 2 or w % 2:
        raise ValueError(f"the entry kernel takes an even H and W, got {h}x{w}")
    prep = _prepared(blk)
    _check_blocks([prep], x_q)
    a = prep.args
    h1 = torch.empty(n * h * w * a.cmid, dtype=torch.uint8, device=dev)
    h2 = torch.empty(n * (h // 2) * (w // 2) * a.cmid, dtype=torch.int8, device=dev)
    out = torch.empty((n, h // 2, w // 2, a.cout), dtype=torch.int8, device=dev)
    _call("qentry_run", dev, x_q.data_ptr(), out.data_ptr(), h1.data_ptr(), h2.data_ptr(),
          ctypes.byref(a), n, h, w)
    LAUNCHES["qentry_run"] += 1
    return out


# ------------------------------------------------------------------ the stem

def stem_reference(tiles: torch.Tensor, q) -> torch.Tensor:
    """Plain version of the stem kernel: the stem as torch ops."""
    return _plain_stem(q, tiles)


def _check_tiles(tiles: torch.Tensor) -> None:
    if tiles.dim() != 4 or tiles.dtype != torch.float32 or tiles.shape[-1] != 3:
        raise ValueError(f"the stem takes (N, H, W, 3) float32 tiles, got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")
    h, w = tiles.shape[1:3]
    if h % 4 or w % 4:
        raise ValueError(f"the stem takes H and W divisible by 4, got {h}x{w}")
    if not tiles.is_contiguous():
        raise ValueError("the stem takes contiguous tiles")


def fused_stem(tiles: torch.Tensor, q) -> torch.Tensor:
    """The stem of the int8 ResNet50 ``q`` (a ``QResNet50``): (N, H, W, 3)
    float32 tiles, H and W divisible by 4 -> (N, H/4, W/4, 64) int8 codes
    (zero point -128)."""
    _check_tiles(tiles)
    if _on_cpu(tiles):
        return stem_reference(tiles, q)
    dev = tiles.device
    for name, t, dtype, shape in (("stem_w", q.stem_w, torch.int8, (4, 4, 12, 64)),
                                  ("stem_m", q.stem_m, torch.float32, (64,)),
                                  ("stem_z", q.stem_z, torch.float32, (64,)),
                                  ("input_scale", q.input_scale, torch.float32, ())):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n, h, w, _ = tiles.shape
    out = torch.empty((n, h // 4, w // 4, 64), dtype=torch.int8, device=dev)
    _call("qstem_run", dev, tiles.data_ptr(), q.stem_w.data_ptr(), q.stem_m.data_ptr(),
          q.stem_z.data_ptr(), q.input_scale.data_ptr(), out.data_ptr(), n, h, w)
    LAUNCHES["qstem_run"] += 1
    count("backbone.stem_kernel")
    return out


# ------------------------------------------------------ W-pair packed stage

def pack_wpair_block(blk: QBlock) -> QBlock:
    """Re-express a QBlock on the W-pair-packed grid: (T, H, W, C) viewed as
    (T, H, W/2, 2C), a free reshape, with weights rebuilt for it (numpy, the
    JAX package's transform). The 1x1 convs become parity-block-diagonal; the
    3x3 conv maps onto a 3x3 over the packed grid: output parity pi_out at
    packed col p reads original cols 2p+pi_out+d-1, d in 0..2, i.e. packed tap
    floor((pi_out+d-1)/2) + 1 with input parity (pi_out+d-1) mod 2. Unused
    (tap, parity) slots get weight 0.

    On the TPU this fills its 128-lane tiles at C = 64; on the card it only
    doubles stage 1's MACs with zero blocks, so the forward does not use it."""
    dev = blk.w1.device

    def diag2(w):  # (1,1,Cin,Cout) -> (1,1,2Cin,2Cout) parity-block-diagonal
        w = w.cpu().numpy()
        ci, co = w.shape[-2], w.shape[-1]
        out = np.zeros((1, 1, 2 * ci, 2 * co), np.int8)
        w = w.reshape(ci, co)
        out[0, 0, :ci, :co] = w
        out[0, 0, ci:, co:] = w
        return torch.from_numpy(out).to(dev)

    def pair2(v):
        return torch.from_numpy(np.tile(v.cpu().numpy(), 2)).to(dev)

    w2 = blk.w2.cpu().numpy()  # (3, 3, Cmid, Cmid)
    c = w2.shape[-2]
    w2p = np.zeros((3, 3, 2 * c, 2 * c), np.int8)
    for pi_out in range(2):
        for d in range(3):
            j = pi_out + d - 1
            dp = (j // 2) + 1  # packed tap index 0..2
            pi_in = j % 2
            w2p[:, dp, pi_in * c:(pi_in + 1) * c, pi_out * c:(pi_out + 1) * c] = w2[:, d]

    return QBlock(
        w1=diag2(blk.w1), m1=pair2(blk.m1), z1=pair2(blk.z1),
        w2=torch.from_numpy(w2p).to(dev), m2=pair2(blk.m2), z2=pair2(blk.z2),
        w3=diag2(blk.w3), m3=pair2(blk.m3), z3=pair2(blk.z3),
        wd=None if blk.wd is None else diag2(blk.wd),
        md=None if blk.md is None else pair2(blk.md),
        id_mult=blk.id_mult,
    )


def fused_stage_wpacked(
    x_q: torch.Tensor, blocks: Sequence[QBlock], *, tiles_per_step: int = 1,
    packed_blocks: Sequence[QBlock] | None = None,
) -> torch.Tensor:
    """``fused_bottleneck_stage`` on the W-pair-packed grid. x_q: (N, H, W, C)
    int8, W even. Pass ``packed_blocks`` (from ``pack_wpair_block``) to skip
    re-packing weights on every call."""
    n, hh, ww, cin = x_q.shape
    if ww % 2:
        raise ValueError(f"W={ww} must be even for W-pair packing")
    if packed_blocks is None:
        packed_blocks = [pack_wpair_block(b) for b in blocks]
    xp = x_q.reshape(n, hh, ww // 2, 2 * cin)
    out = fused_bottleneck_stage(xp, packed_blocks, tiles_per_step=tiles_per_step)
    return out.reshape(n, hh, ww, out.shape[-1] // 2)
