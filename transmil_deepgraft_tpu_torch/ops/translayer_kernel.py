"""Fused pre-norm Nystrom TransLayer for inference (port of
``ops/pallas/translayer_kernel.py``).

    y = x + W_out( attn(LN(x)) + res_conv(V) ) + b_out

runs as two hand-written CUDA kernels (``csrc/translayer.cu``) plus glue in
torch ops, as the JAX package leaves its glue to XLA:

  glue : x_lm = segmean(LN(x)), q_lm/k_lm, attn2 softmax, Newton-Schulz pinv
  K1   : LN -> K/V projection -> attn3_v = softmax(q_lm K^T) V; V written out
  glue : B = pinv(attn2) attn3_v; res = 33-tap depthwise conv of V
  K2   : LN -> Q projection -> softmax(Q k_lm^T) B -> + res -> W_out + b_out + x

Front padding follows the reference's XLA path, not JAX's ``fused_translayer``:
the layer input is front-padded to a multiple of the landmark count AFTER
LayerNorm, so the ``n_pad`` pad rows are zeros. They count in the landmark
segment means, take part as keys (score 0, V = 0) and are dropped from the
output. (JAX's fused kernels pad before LayerNorm and so see pad rows equal
to the LN bias.)

Each kernel wrapper (:func:`translayer_k1`, :func:`translayer_k2`) launches its
kernel on a CUDA tensor, uses its plain version (:func:`k1_reference`,
:func:`k2_reference`) on a CPU tensor, and raises on anything else. Weights are
in the port's torch layout: ``w_qkv`` (3*inner, D), ``w_out`` (D, inner),
``res_weight`` (heads, 1, 33, 1).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.ops import _build
from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv1d
from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention
from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv

LN_EPS = 1e-5
# The only shape the kernels are built for: the model the repository ships.
KERNEL_DIM, KERNEL_HEADS, KERNEL_DIM_HEAD, KERNEL_LANDMARKS = 512, 8, 64, 256

# Launches of each kernel since the last reset_launch_counts().
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
    lib.translayer_k1.argtypes = [_P] * 11 + [_I, _I, _I, _P]
    lib.translayer_k1.restype = _I
    lib.translayer_k1_chunks.argtypes = [_I]
    lib.translayer_k1_chunks.restype = _I
    lib.translayer_k2.argtypes = [_P] * 10 + [_I, _I, ctypes.c_float, _P]
    lib.translayer_k2.restype = _I
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


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()} ({err})")


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
    """K1 (replaces ``_k1``): launches the CUDA kernel on CUDA tensors, runs
    :func:`k1_reference` on CPU tensors."""
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
    lib = _library()
    nchunks = lib.translayer_k1_chunks(n)
    f32 = dict(dtype=torch.float32, device=dev)
    attn3_v = torch.empty((b, h, m, d), **f32)
    v = torch.empty((b, n, dim), **f32)
    k_scratch = torch.empty((b, n, dim), **f32)
    stats = torch.empty((b * n, 2), **f32)
    part_acc = torch.empty((b, h, nchunks, m, d), **f32)
    part_ml = torch.empty((b, h, nchunks, m, 2), **f32)
    with torch.cuda.device(dev):
        err = lib.translayer_k1(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w_kv.data_ptr(),
            q_lm.data_ptr(), attn3_v.data_ptr(), v.data_ptr(), k_scratch.data_ptr(),
            stats.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, n, n_pad,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, "translayer_k1", err)
    LAUNCHES["translayer_k1"] += 1
    return attn3_v, v


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
    """K2 (replaces ``_k2``): launches the CUDA kernel on CUDA tensors, runs
    :func:`k2_reference` on CPU tensors."""
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
    lib = _library()
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.translayer_k2(
            x.data_ptr(), res.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w_q.data_ptr(), k_lm.data_ptr(), bmat.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), y.data_ptr(), b, n, float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, "translayer_k2", err)
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
