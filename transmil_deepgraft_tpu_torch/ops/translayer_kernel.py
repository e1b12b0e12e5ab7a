"""Fused pre-norm Nystrom TransLayer for inference (port of
``ops/pallas/translayer_kernel.py``).

    y = x + W_out( attn(LN(x)) + res_conv(V) ) + b_out

runs as two kernel wrappers plus glue in torch ops, as the JAX package leaves
its glue to XLA:

  glue : x_lm = segmean(LN(x)), q_lm/k_lm, attn2 softmax, Newton-Schulz pinv
  K1   : LN -> K/V projection -> attn3_v = softmax(q_lm K^T) V; V written out
  glue : B = pinv(attn2) attn3_v; res = 33-tap depthwise conv of V
  K2   : LN -> Q projection -> softmax(Q k_lm^T) B -> + res -> W_out + b_out + x

On the card each wrapper is a short sequence of launches (:func:`_k1_stages`,
:func:`_k2_stages`): the projections are one hand-written TF32 tensor-core
GEMM (``csrc/translayer.cu``) with LayerNorm or ``O + res`` applied to its A
operand on the way in, and the two landmark attentions are the kernels of
B5 and B6 (``csrc/nystrom.cu``, through :mod:`.nystrom_kernel`'s uncounted
launch path), which read K, V and Q in place through (batch, head, row)
strides. Every product uses the 3xTF32 split and keeps float32 accuracy. The
weights' hi/lo split is made on every call: the optimizer changes them in
place between validation calls.

Front padding follows the reference's XLA path, not JAX's ``fused_translayer``:
the layer input is front-padded to a multiple of the landmark count AFTER
LayerNorm, so the ``n_pad`` pad rows are zeros. They count in the landmark
segment means, take part as keys (score 0, V = 0) and are dropped from the
output. (JAX's fused kernels pad before LayerNorm and so see pad rows equal
to the LN bias.)

Each kernel wrapper (:func:`translayer_k1`, :func:`translayer_k2`) launches its
kernels on a CUDA tensor, uses its plain version (:func:`k1_reference`,
:func:`k2_reference`) on a CPU tensor, and raises on anything else. Weights are
in the port's torch layout: ``w_qkv`` (3*inner, D), ``w_out`` (D, inner),
``res_weight`` (heads, 1, 33, 1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.ops import _build
from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv1d
from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention
from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv

LN_EPS = 1e-5
# The only shape the kernels are built for: the model the repository ships.
KERNEL_DIM, KERNEL_HEADS, KERNEL_DIM_HEAD, KERNEL_LANDMARKS = 512, 8, 64, 256
# Key tiles (of 64) a split of the landmark kernel in K1, at most. The tensor
# cores truncate as they accumulate, so the landmark kernel's error grows with
# the keys a split sums; V's columns carry LN(x)'s bias and do not cancel.
K1_SPLIT_TILES = 8
# The kernels address buffers with 32-bit offsets.
OFFSET_LIMIT = 2**31

# Calls of each kernel wrapper on the card since the last reset_launch_counts().
LAUNCHES = {"translayer_k1": 0, "translayer_k2": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (once a process)."""
    lib = _build.load("translayer")
    lib.translayer_kv_projection.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.translayer_kv_projection.restype = _I
    lib.translayer_q_projection.argtypes = [_P] * 7 + [_I, ctypes.c_float, _P]
    lib.translayer_q_projection.restype = _I
    lib.translayer_out_projection.argtypes = [_P] * 7 + [_I, _P]
    lib.translayer_out_projection.restype = _I
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA (kernel); raises
    for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"fused TransLayer kernels run on CUDA or CPU tensors, not {x.device}")


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_width(x: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[2] != KERNEL_DIM:
        raise ValueError(
            f"the CUDA TransLayer kernels take (b, n, {KERNEL_DIM}) input, got {tuple(x.shape)}"
        )


def _check_offsets(rows: int) -> None:
    if rows * KERNEL_DIM >= OFFSET_LIMIT:
        raise ValueError(f"{rows} rows of {KERNEL_DIM} pass the kernels' 32-bit offsets")


def _run(name: str, dev: torch.device, *args) -> None:
    """Run the C launcher ``name`` of the translayer library on ``dev``'s
    current stream (appended to ``args``)."""
    nk._call(_library(), name, dev, *args, nk._stream(dev))


# ------------------------------------------------------- the card's launches

class _Parts(NamedTuple):
    """The launches the kernel wrappers are made of, in (batch, head, row)
    terms that the plain stand-ins in the CPU tests share."""

    # (x, ln_weight, ln_bias, w_kv, kv, n_pad): K and V into rows n_pad.. of
    # each batch of kv[0] and kv[1]
    project_kv: Callable
    # (q_lm, k, v, strides, keys) -> softmax(q_lm K^T) V, K and V read from
    # k and v's first float at strides (batch, head, row)
    landmark: Callable
    # (x, ln_weight, ln_bias, w_q, scale, q): q = LN(x) W_q^T * scale
    project_q: Callable
    # (q, k_lm, bmat, o, strides, n): o = softmax(Q k_lm^T) B, Q read from q
    # and written to o at strides (batch, head, row)
    query: Callable
    # (o, res, x, w_out, b_out, y): y = (o + res) W_out^T + b_out + x
    project_out: Callable


def _kv_projection(x, ln_weight, ln_bias, w_kv, kv, n_pad):
    b, n, dim = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    w_split = torch.empty((2, 2 * dim, dim), **f32)
    stats = torch.empty((b * n, 2), **f32)
    _run("translayer_kv_projection", x.device, x.data_ptr(), ln_weight.data_ptr(),
         ln_bias.data_ptr(), w_kv.data_ptr(), w_split.data_ptr(), stats.data_ptr(),
         kv[0].data_ptr(), kv[1].data_ptr(), b, n, n_pad)


def _landmark(q_lm, k, v, strides, keys):
    b, h = q_lm.shape[:2]
    return nk.landmark_launch(q_lm, k.data_ptr(), v.data_ptr(), strides, b, h, keys,
                              K1_SPLIT_TILES)


def _q_projection(x, ln_weight, ln_bias, w_q, scale, q):
    dim = x.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    w_split = torch.empty((2, dim, dim), **f32)
    stats = torch.empty((x.shape[0] * x.shape[1], 2), **f32)
    _run("translayer_q_projection", x.device, x.data_ptr(), ln_weight.data_ptr(),
         ln_bias.data_ptr(), w_q.data_ptr(), w_split.data_ptr(), stats.data_ptr(), q.data_ptr(),
         x.shape[0] * x.shape[1], float(scale))


def _query(q, k_lm, bmat, o, strides, n):
    b, h = k_lm.shape[:2]
    nk.query_launch(q.view(b, n, h, -1), q.data_ptr(), strides, k_lm, bmat, o, strides, b, h, n)


def _out_projection(o, res, x, w_out, b_out, y):
    dim = x.shape[-1]
    w_split = torch.empty((2, dim, dim), dtype=torch.float32, device=x.device)
    _run("translayer_out_projection", x.device, o.data_ptr(), res.data_ptr(), x.data_ptr(),
         w_out.data_ptr(), w_split.data_ptr(), b_out.data_ptr(), y.data_ptr(),
         x.shape[0] * x.shape[1])


_KERNELS = _Parts(_kv_projection, _landmark, _q_projection, _query, _out_projection)


def _k1_stages(x, n_pad, ln_weight, ln_bias, w_kv, q_lm, parts: _Parts = _KERNELS):
    """K1 as its launches: [K|V] into buffers of n_pad + n rows a batch whose
    first n_pad rows are zero (pad keys are zeros after LayerNorm: score 0,
    V = 0), then the landmark attention over all n_pad + n keys. Returns
    (attn3_v, V's real rows as a view of its buffer)."""
    b, n, dim = x.shape
    keys = n_pad + n
    kv = x.new_empty((2, b, keys, dim))
    kv[:, :, :n_pad] = 0
    parts.project_kv(x, ln_weight, ln_bias, w_kv, kv, n_pad)
    attn3_v = parts.landmark(q_lm, kv[0], kv[1], (keys * dim, KERNEL_DIM_HEAD, dim), keys)
    return attn3_v, kv[1, :, n_pad:]


def _k2_stages(x, res, ln_weight, ln_bias, w_q, k_lm, bmat, w_out, b_out, scale,
               parts: _Parts = _KERNELS):
    """K2 as its launches: Q, the query attention over the landmarks written
    as O (b, n, D) (head h in columns h*d..), then the out projection of
    O + res with b_out and x added."""
    b, n, dim = x.shape
    strides = (n * dim, KERNEL_DIM_HEAD, dim)  # (batch, head, row) of a (b, n, D) buffer
    q, o, y = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    parts.project_q(x, ln_weight, ln_bias, w_q, scale, q)
    parts.query(q, k_lm, bmat, o, strides, n)
    parts.project_out(o, res, x, w_out, b_out, y)
    return y


# --------------------------------------------------------------------- K1

def k1_reference(x, n_pad, ln_weight, ln_bias, w_kv, q_lm):
    """Plain version of K1. x (b, n, D) unpadded; w_kv (2*inner, D) the K and V
    rows of to_qkv; q_lm (b, h, m, d) scaled query landmarks. Returns
    (attn3_v (b, h, m, d), v (b, n, inner)) over the front-padded sequence."""
    b, n, _ = x.shape
    h, d = q_lm.shape[1], q_lm.shape[3]
    inner = h * d
    kv = F.layer_norm(x, x.shape[-1:], ln_weight, ln_bias, LN_EPS) @ w_kv.t()
    k, v = kv[..., :inner], kv[..., inner:]
    kh = F.pad(k.reshape(b, n, h, d).transpose(1, 2), (0, 0, n_pad, 0))
    vh = F.pad(v.reshape(b, n, h, d).transpose(1, 2), (0, 0, n_pad, 0))
    attn3 = torch.softmax(q_lm @ kh.transpose(-1, -2), dim=-1)
    return attn3 @ vh, v.contiguous()


def translayer_k1(x, n_pad, ln_weight, ln_bias, w_kv, q_lm):
    """K1 (replaces ``_k1``): launches the CUDA kernels on CUDA tensors
    (:func:`_k1_stages`), runs :func:`k1_reference` on CPU tensors. The V it
    returns is a view of the kernels' padded buffer."""
    if _on_cpu(x):
        return k1_reference(x, n_pad, ln_weight, ln_bias, w_kv, q_lm)
    _check_kernel_width(x)
    b, n, dim = x.shape
    h, m, d = KERNEL_HEADS, KERNEL_LANDMARKS, KERNEL_DIM_HEAD
    dev = x.device
    _check("x", x, (b, n, dim), dev)
    _check("ln_weight", ln_weight, (dim,), dev)
    _check("ln_bias", ln_bias, (dim,), dev)
    _check("w_kv", w_kv, (2 * dim, dim), dev)
    _check("q_lm", q_lm, (b, h, m, d), dev)
    if not 0 <= n_pad < m:
        raise ValueError(f"n_pad must be in [0, {m}), got {n_pad}")
    _check_offsets(b * (n + n_pad))
    out = _k1_stages(x, n_pad, ln_weight, ln_bias, w_kv, q_lm)
    LAUNCHES["translayer_k1"] += 1
    return out


# --------------------------------------------------------------------- K2

def k2_reference(x, res, ln_weight, ln_bias, w_q, k_lm, bmat, w_out, b_out, scale):
    """Plain version of K2. x, res (b, n, D); w_q (inner, D); k_lm, bmat
    (b, h, m, d); w_out (D, inner). Returns y (b, n, D)."""
    b, n, _ = x.shape
    h, d = k_lm.shape[1], k_lm.shape[3]
    q = F.layer_norm(x, x.shape[-1:], ln_weight, ln_bias, LN_EPS) @ w_q.t() * scale
    q = q.reshape(b, n, h, d).transpose(1, 2)
    attn = torch.softmax(q @ k_lm.transpose(-1, -2), dim=-1) @ bmat  # (b, h, n, d)
    inner = attn.transpose(1, 2).reshape(b, n, h * d) + res
    return inner @ w_out.t() + b_out + x


def translayer_k2(x, res, ln_weight, ln_bias, w_q, k_lm, bmat, w_out, b_out, scale):
    """K2 (replaces ``_k2``): launches the CUDA kernels on CUDA tensors
    (:func:`_k2_stages`), runs :func:`k2_reference` on CPU tensors."""
    if _on_cpu(x):
        return k2_reference(x, res, ln_weight, ln_bias, w_q, k_lm, bmat, w_out, b_out, scale)
    _check_kernel_width(x)
    b, n, dim = x.shape
    h, m, d = KERNEL_HEADS, KERNEL_LANDMARKS, KERNEL_DIM_HEAD
    dev = x.device
    _check("x", x, (b, n, dim), dev)
    _check("res", res, (b, n, dim), dev)
    _check("ln_weight", ln_weight, (dim,), dev)
    _check("ln_bias", ln_bias, (dim,), dev)
    _check("w_q", w_q, (dim, dim), dev)
    _check("k_lm", k_lm, (b, h, m, d), dev)
    _check("bmat", bmat, (b, h, m, d), dev)
    _check("w_out", w_out, (dim, dim), dev)
    _check("b_out", b_out, (dim,), dev)
    _check_offsets(b * n)
    y = _k2_stages(x, res, ln_weight, ln_bias, w_q, k_lm, bmat, w_out, b_out, scale)
    LAUNCHES["translayer_k2"] += 1
    return y


# --------------------------------------------------------------- the layer

def landmark_pad(n: int, num_landmarks: int) -> int:
    """Front-pad that brings a sequence of n to a multiple of num_landmarks."""
    return (num_landmarks - n % num_landmarks) % num_landmarks


def value_residual_kernel(res_weight: torch.Tensor, dim_head: int) -> torch.Tensor:
    """torch res_conv weight (heads, 1, ks, 1) -> the (ks, 1, heads*dim_head)
    kernel of one depthwise conv over all value columns, each head's taps
    repeated over its dim_head columns."""
    w = res_weight[:, 0, :, 0].t()  # (ks, heads)
    return w.repeat_interleave(dim_head, dim=1)[:, None, :]


def landmark_glue(x, n_pad, ln_weight, ln_bias, w_qkv, *, heads, dim_head,
                  num_landmarks, pinv_iterations):
    """The torch-op glue ahead of K1: landmarks = segment means of the
    front-padded LN(x) (pad rows zero), projected to q_lm (scaled) and k_lm
    (b, h, m, d), and pinv(softmax(q_lm k_lm^T)) (b, h, m, m)."""
    b, n, dim = x.shape
    m, inner = num_landmarks, heads * dim_head
    lnx = F.pad(F.layer_norm(x, (dim,), ln_weight, ln_bias, LN_EPS), (0, 0, n_pad, 0))
    x_lm = lnx.reshape(b, m, (n + n_pad) // m, dim).mean(dim=2)  # (b, m, D)
    q_lm = (x_lm @ w_qkv[:inner].t()).reshape(b, m, heads, dim_head).transpose(1, 2)
    k_lm = (x_lm @ w_qkv[inner:2 * inner].t()).reshape(b, m, heads, dim_head).transpose(1, 2)
    q_lm = q_lm * dim_head ** -0.5
    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    return q_lm.contiguous(), k_lm.contiguous(), newton_schulz_pinv(attn2, pinv_iterations)


def fused_translayer(
    x, ln_weight, ln_bias, w_qkv, w_out, b_out, res_weight,
    *, heads=8, dim_head=64, num_landmarks=256, pinv_iterations=6,
):
    """One pre-norm Nystrom TransLayer (inference): y = x + attn-block(x).

    x: (b, n, D) UNPADDED; the landmark front-pad is handled inside. Returns
    (b, n, D). On CUDA the two kernels take shape (b, n, 512), 8 heads of 64
    and 256 landmarks.
    """
    inner = heads * dim_head
    n_pad = landmark_pad(x.shape[1], num_landmarks)
    q_lm, k_lm, attn2_inv = landmark_glue(
        x, n_pad, ln_weight, ln_bias, w_qkv, heads=heads, dim_head=dim_head,
        num_landmarks=num_landmarks, pinv_iterations=pinv_iterations,
    )
    attn3_v, v = translayer_k1(x, n_pad, ln_weight, ln_bias, w_qkv[inner:], q_lm)
    bmat = (attn2_inv @ attn3_v).contiguous()
    res = depthwise_conv1d(v, value_residual_kernel(res_weight, dim_head)).contiguous()
    return translayer_k2(x, res, ln_weight, ln_bias, w_qkv[:inner], k_lm, bmat,
                         w_out, b_out, dim_head ** -0.5)


def fused_translayer_reference(
    x, ln_weight, ln_bias, w_qkv, w_out, b_out, res_weight,
    *, heads=8, dim_head=64, num_landmarks=256, pinv_iterations=6,
):
    """Plain version of :func:`fused_translayer`, written as the reference's
    layer: LN -> front zero-pad -> qkv -> Nystrom attention -> + value
    residual -> out projection -> strip the pad -> + x."""
    b, n, dim = x.shape
    inner = heads * dim_head
    n_pad = landmark_pad(n, num_landmarks)
    xp = F.pad(F.layer_norm(x, (dim,), ln_weight, ln_bias, LN_EPS), (0, 0, n_pad, 0))
    qkv = (xp @ w_qkv.t()).reshape(b, n + n_pad, 3, heads, dim_head)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = nystrom_attention(q, k, v, num_landmarks=num_landmarks,
                            pinv_iterations=pinv_iterations).out
    out = out.transpose(1, 2).reshape(b, n + n_pad, inner)
    out = out + depthwise_conv1d(qkv[:, :, 2].reshape(b, n + n_pad, inner),
                                 value_residual_kernel(res_weight, dim_head))
    return x + (out @ w_out.t() + b_out)[:, n_pad:]
