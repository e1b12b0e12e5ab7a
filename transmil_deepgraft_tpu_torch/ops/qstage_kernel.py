"""Fused int8 bottleneck stages of the quantized ResNet50 (port of
``ops/pallas/qstage_kernel.py``).

Two hand-written CUDA kernels (``csrc/qstage.cu``) replace the two Pallas TPU
kernels:

  qstage_run (B7, replaces ``_stage_kernel``): a run of stride-1 bottlenecks,
      1x1 -> requant -> 3x3 over a -128 pad -> requant -> 1x1 + (identity fma
      or 1x1 downsample) -> clip/round. Stage 1 and the interior of stages 2-4.
  qentry_run (B8, replaces ``_entry_kernel``): one stride-2 stage-entry
      bottleneck, 1x1 at full resolution, 3x3/s2 over a -128 pad, 1x1 +
      the 1x1/s2 downsample projection.

Each launcher runs one int8 implicit-GEMM convolution kernel per conv (int32
accumulation on the tensor cores, ``mma.sync`` s8), with the folded-fma
epilogue of ``models/resnet_int8`` written so that it rounds exactly where
XLA:CPU does. Intermediates live in device scratch that the wrapper allocates.

Each wrapper (:func:`fused_bottleneck_stage`, :func:`fused_entry_block`)
launches its kernel on a CUDA tensor, uses its plain version
(:func:`stage_reference`, :func:`entry_reference`) on a CPU tensor, and raises
on anything else. ``tiles_per_step`` (the TPU grid step) is only checked for
dividing the batch: the CUDA kernels tile rows, not images.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.models.resnet_int8 import QBlock, _plain_blocks
from transmil_deepgraft_tpu_torch.ops import _build

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES = {"qstage_run": 0, "qentry_run": 0}
CHANNEL_MULTIPLE = 64  # the kernels' K and N tiles


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _QBlockArgs(ctypes.Structure):
    """Mirror of ``QBlockArgs`` in ``csrc/qstage.cu``."""

    _fields_ = [
        ("w1", ctypes.c_void_p), ("sc1", ctypes.c_void_p),
        ("w2", ctypes.c_void_p), ("sc2", ctypes.c_void_p),
        ("w3", ctypes.c_void_p), ("sc3", ctypes.c_void_p),
        ("wd", ctypes.c_void_p), ("md", ctypes.c_void_p),
        ("id_mult", ctypes.c_void_p),
        ("cin", ctypes.c_int), ("cmid", ctypes.c_int), ("cout", ctypes.c_int),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (once a process)."""
    lib = _build.load("qstage")
    lib.qstage_run.argtypes = [_P] * 7 + [ctypes.POINTER(_QBlockArgs), _I, _I, _I, _I, _P]
    lib.qstage_run.restype = _I
    lib.qentry_run.argtypes = [_P] * 5 + [ctypes.POINTER(_QBlockArgs), _I, _I, _I, _P]
    lib.qentry_run.restype = _I
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
    """QBlock -> (kernel arrays, has_ds): w1 (Cin, Cmid), sc1 (2, Cmid) [m; z],
    w2 (9*Cmid, Cmid) in (di, dj, ci) row order, sc2, w3 (Cmid, Cout), sc3,
    then wd (Cin, Cout) and md (1, Cout), or id_mult as (1, 1)."""
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


def _check_divides(n: int, tiles_per_step: int) -> None:
    if n % tiles_per_step:
        raise ValueError(f"N={n} not divisible by tiles_per_step={tiles_per_step}")


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()} ({err})")


def _block_args(arrays: list, has_ds: bool, x_dev: torch.device) -> _QBlockArgs:
    """Validate one packed block for the kernels and fill its C struct."""
    w1, sc1, w2, sc2, w3, sc3 = (a.contiguous() for a in arrays[:6])
    cin, cmid = w1.shape
    cout = w3.shape[1]
    for name, t, dtype in (("w1", w1, torch.int8), ("w2", w2, torch.int8),
                           ("w3", w3, torch.int8), ("sc1", sc1, torch.float32),
                           ("sc2", sc2, torch.float32), ("sc3", sc3, torch.float32)):
        if t.device != x_dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {x_dev}, got {t.dtype} on {t.device}")
    if w2.shape != (9 * cmid, cmid) or w3.shape[0] != cmid:
        raise ValueError(f"inconsistent block widths: w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)}")
    if cin % CHANNEL_MULTIPLE or cmid % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"the CUDA kernels take channel counts that are multiples of "
                         f"{CHANNEL_MULTIPLE}, got {cin}/{cmid}/{cout}")
    args = _QBlockArgs(w1=w1.data_ptr(), sc1=sc1.data_ptr(), w2=w2.data_ptr(),
                       sc2=sc2.data_ptr(), w3=w3.data_ptr(), sc3=sc3.data_ptr(),
                       cin=cin, cmid=cmid, cout=cout)
    if has_ds:
        wd, md = arrays[6].contiguous(), arrays[7].contiguous().float()
        if wd.shape != (cin, cout) or wd.dtype != torch.int8 or wd.device != x_dev:
            raise ValueError(f"downsample kernel must be int8 ({cin}, {cout}) on {x_dev}")
        args.wd, args.md = wd.data_ptr(), md.data_ptr()
        keep = [w1, sc1, w2, sc2, w3, sc3, wd, md]
    else:
        if cin != cout:
            raise ValueError(f"an identity block needs Cin == Cout, got {cin} -> {cout}")
        idm = arrays[6].contiguous()  # read on the device: no host sync
        if idm.device != x_dev or idm.dtype != torch.float32:
            raise ValueError(f"id_mult must be float32 on {x_dev}")
        args.id_mult = idm.data_ptr()
        keep = [w1, sc1, w2, sc2, w3, sc3, idm]
    args._keep = keep  # the tensors behind the pointers live as long as the struct
    return args


def _check_input(x_q: torch.Tensor) -> None:
    """The kernels read 16-byte runs of channels."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be (N, H, W, C) int8, got {x_q.dtype} {tuple(x_q.shape)}")
    if x_q.data_ptr() % 16:
        raise ValueError("x_q must be 16-byte aligned")


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
    packed = [_pack_block(b) for b in blocks]
    _check_divides(x_q.shape[0], tiles_per_step)
    if _on_cpu(x_q):
        return stage_reference(x_q, blocks)
    x_q = x_q.contiguous()
    _check_input(x_q)
    dev = x_q.device
    n, h, w, cin = x_q.shape
    args = [_block_args(a, ds, dev) for a, ds in packed]
    if args[0].cin != cin or any(a.cin != b.cout for a, b in zip(args[1:], args)):
        raise ValueError("block input widths do not chain from x_q through the blocks")
    rows = n * h * w
    i8 = dict(dtype=torch.int8, device=dev)
    cmid = max(a.cmid for a in args)
    wide = max(a.cout for a in args)
    h1, h2 = torch.empty(rows * cmid, **i8), torch.empty(rows * cmid, **i8)
    acts = [torch.empty(rows * wide, **i8) if len(args) > 1 else None for _ in range(2)]
    ds = (torch.empty(rows * wide, dtype=torch.float32, device=dev)
          if any(a.wd for a in args) else None)
    out = torch.empty((n, h, w, args[-1].cout), **i8)
    c_args = (_QBlockArgs * len(args))(*args)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.qstage_run(
            x_q.data_ptr(), out.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            *(None if a is None else a.data_ptr() for a in acts),
            None if ds is None else ds.data_ptr(), c_args, len(args), n, h, w,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, "qstage_run", err)
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
    arrays, _ = _pack_block(blk)
    _check_divides(x_q.shape[0], tiles_per_step)
    if _on_cpu(x_q):
        return entry_reference(x_q, blk)
    x_q = x_q.contiguous()
    _check_input(x_q)
    dev = x_q.device
    n, h, w, cin = x_q.shape
    if h % 2 or w % 2:
        raise ValueError(f"the entry kernel takes an even H and W, got {h}x{w}")
    args = _block_args(arrays, True, dev)
    if args.cin != cin:
        raise ValueError(f"x_q has {cin} channels, the block takes {args.cin}")
    i8 = dict(dtype=torch.int8, device=dev)
    h1 = torch.empty(n * h * w * args.cmid, **i8)
    h2 = torch.empty(n * (h // 2) * (w // 2) * args.cmid, **i8)
    ds = torch.empty(n * (h // 2) * (w // 2) * args.cout, dtype=torch.float32, device=dev)
    out = torch.empty((n, h // 2, w // 2, args.cout), **i8)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.qentry_run(
            x_q.data_ptr(), out.data_ptr(), h1.data_ptr(), h2.data_ptr(), ds.data_ptr(),
            ctypes.byref(args), n, h, w, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, "qentry_run", err)
    LAUNCHES["qentry_run"] += 1
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
