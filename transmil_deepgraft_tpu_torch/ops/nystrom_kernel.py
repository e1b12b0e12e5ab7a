"""Fused Nystrom attention for training (port of ``ops/pallas/nystrom_kernel.py``).

Two hand-written CUDA kernels (``csrc/nystrom.cu``) replace the four Pallas
TPU kernels, each in two layouts:

  nystrom_landmark_attn (B5 ``_landmark_attn_kernel_packed``, B3
      ``_landmark_attn_kernel``): ``attn3_v = softmax(q_lm k^T) v`` with the
      m landmarks as queries over the n keys (online softmax, split over n,
      the splits merged by the last block in the same launch); on request it
      also writes each landmark row's log-sum-exp, which sequence-parallel
      attention (``parallel/sp_nystrom``) merges across processes.
  nystrom_query_lm (B6 ``_query_lm_kernel_packed``, B4 ``_query_lm_kernel``):
      ``softmax(q k_lm^T) B`` with the n rows as queries over the m landmarks.

Both compute their two products on tensor cores in TF32 with the 3xTF32
split, which keeps float32 accuracy. Their grids come from the shape alone
(:func:`landmark_plan`, :func:`query_plan`, cached per shape, the SM count
once per device), so a launch makes no query of the device. The JAX
wrappers' ``block_n`` (the TPU's tile) has no counterpart here, and none of
these functions takes it.

The landmark means, the m x m softmax, the Newton-Schulz pinv and
``B = pinv @ attn3_v`` stay torch ops, as the JAX package leaves them to XLA,
in its order of scaling: the packed form scales the q landmarks after the
mean and hands B6 ``k_lm * scale``; the (b, h, n, d) form scales q before its
mean.

:func:`nystrom_attention_fused_packed` and :func:`nystrom_attention_fused` are
``torch.autograd.Function``s whose backward is :func:`nystrom_attention_bwd`,
the analytic O(n*m) VJP (the JAX package writes it in XLA ops and has no
backward kernel; here it is torch ops). They save only their inputs and
recompute the small pieces.

Each kernel wrapper launches its kernel on a CUDA tensor, uses its plain
version (:func:`landmark_attention_reference`,
:func:`query_landmark_attention_reference`) on a CPU tensor, and raises on
anything else. The plain versions materialise the (b, h, m, n) scores: 340 MB
at n = 41,472 and 8 heads, which the card holds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transmil_deepgraft_tpu_torch.ops import _build
from transmil_deepgraft_tpu_torch.ops.nystrom import _segment_means
from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz, newton_schulz_pinv

# The only shape the kernels are built for: the model the repository ships.
KERNEL_DIM_HEAD, KERNEL_LANDMARKS = 64, 256
# The kernels' tiling (csrc/nystrom.cu, checked against the library's
# nystrom_tiling when it loads): 64-key tiles and 64 landmark rows a block of
# the landmark kernel, two of its blocks an SM; 128-row tiles of the query
# kernel, one block an SM.
KEY_TILE, LANDMARK_ROWS, LANDMARK_BLOCKS_PER_SM = 64, 64, 2
QUERY_ROWS = 128
# Floats of one split's partial result: acc (64 x 64), then (max, sum) a row.
_PARTIAL = LANDMARK_ROWS * KERNEL_DIM_HEAD + 2 * LANDMARK_ROWS

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES = {"nystrom_landmark_attn": 0, "nystrom_query_lm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (once a process);
    raises if the library's tiling is not the one the plans here assume."""
    lib = _build.load("nystrom")
    lib.nystrom_landmark_attn.argtypes = [_P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _P, _I,
                                          _I, _I, _I, _I, _I, _P]
    lib.nystrom_landmark_attn.restype = _I
    lib.nystrom_query_lm.argtypes = [_P, _L, _L, _L, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P]
    lib.nystrom_query_lm.restype = _I
    tiling = (_I * 5)()
    lib.nystrom_tiling(tiling)
    want = (KEY_TILE, LANDMARK_ROWS, LANDMARK_BLOCKS_PER_SM, QUERY_ROWS, _PARTIAL)
    if tuple(tiling) != want:
        raise RuntimeError(f"csrc/nystrom.cu tiles as {tuple(tiling)} (keys, landmark rows, "
                           f"blocks an SM, query rows, partial floats); the plans assume {want}")
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def landmark_plan(bh: int, n: int, sms: int) -> tuple[int, int]:
    """(key tiles a split, splits) of the landmark kernel for b*h heads of n
    keys on ``sms`` SMs. Split s takes the 64-key tiles
    [s * per, min((s + 1) * per, ceil(n / 64))); the grid is
    (4, splits, b*h). The fewest tiles a split that still give about
    LANDMARK_BLOCKS_PER_SM blocks an SM; every split holds at least one tile.
    A split's length does not bound its accuracy: the kernel sums each key
    tile's products in a fresh accumulator."""
    tiles = -(-n // KEY_TILE)
    row_tiles = bh * (KERNEL_LANDMARKS // LANDMARK_ROWS)
    want = max(1, LANDMARK_BLOCKS_PER_SM * sms // row_tiles)
    per = -(-tiles // want)
    return per, -(-tiles // per)


@functools.lru_cache(maxsize=256)
def query_plan(bh: int, n: int, sms: int) -> int:
    """Blocks of the persistent query kernel: block i of G takes the 128-row
    tiles [i*T // G, (i+1)*T // G) of the T = b*h*ceil(n / 128), in head order."""
    return min(bh * -(-n // QUERY_ROWS), sms)


# Per (device, stream): (buffer, counter words) of the landmark kernel's
# scratch, kept across launches (a stream runs them in turn). The first words
# are the per-tile counters (int32, zero between launches: the last block of a
# tile resets its counter), the rest the splits' partial results.
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _scratch(dev: torch.device, stream: int, tiles: int, floats: int) -> tuple[int, int, int, int]:
    """(partials address, its floats, counters address, their words) with
    room for ``tiles`` counters and ``floats`` floats of partials; grows the
    buffer (zeroed) when short."""
    buf, words = _SCRATCH.get((dev.index, stream), (None, 0))
    if buf is None or words < tiles or buf.numel() - words < floats:
        have = 0 if buf is None else buf.numel() - words
        words = max(words, -(-tiles // 4) * 4)  # the partials stay 16-byte aligned
        buf = torch.zeros(words + max(have, floats), dtype=torch.float32, device=dev)
        _SCRATCH[(dev.index, stream)] = buf, words
    return buf.data_ptr() + 4 * words, buf.numel() - words, buf.data_ptr(), words


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as a raw pointer, without building
    a ``torch.cuda.Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA (kernel); raises
    for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"Nystrom kernels run on CUDA or CPU tensors, not {x.device}")


def _check_rows(name: str, t: torch.Tensor, device: torch.device) -> None:
    """A float32 tensor on ``device`` whose last axis is one contiguous
    dim_head row, 16-byte aligned, with every stride a multiple of 4."""
    stride = t.stride()
    if (t.device == device and t.dtype == torch.float32 and t.shape[-1] == KERNEL_DIM_HEAD
            and stride[-1] == 1 and not t.data_ptr() % 16 and not any(s % 4 for s in stride[:-1])):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.shape[-1] != KERNEL_DIM_HEAD or t.stride(-1) != 1:
        raise ValueError(f"{name} must end in a contiguous axis of {KERNEL_DIM_HEAD}, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    raise ValueError(f"{name} must be 16-byte aligned with strides a multiple of 4")


def _check_landmarks(name: str, t: torch.Tensor, batch: int, heads: int,
                     device: torch.device) -> None:
    """A contiguous float32 (batch, heads, 256, 64) tensor on ``device``,
    16-byte aligned."""
    if (t.device == device and t.dtype == torch.float32 and t.is_contiguous()
            and t.shape == (batch, heads, KERNEL_LANDMARKS, KERNEL_DIM_HEAD)
            and not t.data_ptr() % 16):
        return
    _check_rows(name, t, device)
    if tuple(t.shape) != (batch, heads, KERNEL_LANDMARKS, KERNEL_DIM_HEAD) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({batch}, {heads}, {KERNEL_LANDMARKS}, "
                         f"{KERNEL_DIM_HEAD}) tensor, got {tuple(t.shape)}")


def _check_length(n: int) -> None:
    if n < 1:
        raise ValueError(f"the Nystrom kernels need at least one row, got n = {n}")


def _call(lib: ctypes.CDLL, name: str, dev: torch.device, *args) -> None:
    """Run the C launcher ``name`` with ``dev`` as the current device."""
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, name)(*args)
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()} ({err})")


# ------------------------------------------------------- plain versions

def landmark_attention_reference(q_lm: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 return_stats: bool = False):
    """``softmax(q_lm k^T) v`` over (..., m, d), (..., n, d), (..., n, d);
    with ``return_stats`` also each row's log-sum-exp of the scores
    (natural base), (..., m)."""
    s = q_lm @ k.transpose(-1, -2)
    out = torch.softmax(s, dim=-1) @ v
    return (out, torch.logsumexp(s, dim=-1)) if return_stats else out


def query_landmark_attention_reference(q: torch.Tensor, k_lm: torch.Tensor,
                                       bmat: torch.Tensor) -> torch.Tensor:
    """``softmax(q k_lm^T) B`` over (..., n, d), (..., m, d), (..., m, d)."""
    return torch.softmax(q @ k_lm.transpose(-1, -2), dim=-1) @ bmat


# ------------------------------------------------------- kernel launches

def landmark_launch(q_lm, k_ptr, v_ptr, k_strides, batch, heads, n, stats=None):
    """B5/B3's kernel, uncounted: q_lm (batch, heads, m, d); k and v read from
    ``k_ptr``/``v_ptr`` at ``k_strides`` (batch, head, row), in floats ->
    (batch, heads, m, d). With ``stats`` (a contiguous float32 (batch, heads,
    m) tensor on q_lm's device) the kernel also writes each row's
    log-sum-exp there. The caller has checked k and v. The TransLayer
    kernels (``translayer_kernel``) launch it through here and count their
    own calls."""
    dev = q_lm.device
    _check_landmarks("q_lm", q_lm, batch, heads, dev)
    _check_length(n)
    bh = batch * heads
    per, splits = landmark_plan(bh, n, _sm_count(dev.index))
    stream = _stream(dev)
    out = torch.empty((batch, heads, KERNEL_LANDMARKS, KERNEL_DIM_HEAD), dtype=torch.float32,
                      device=dev)
    tiles = bh * (KERNEL_LANDMARKS // LANDMARK_ROWS)
    scratch = (None, 0, None, 0)
    if splits > 1:
        scratch = _scratch(dev, stream, tiles, tiles * splits * _PARTIAL)
    if stats is not None and (stats.device != dev or stats.dtype != torch.float32
                              or not stats.is_contiguous()
                              or tuple(stats.shape) != (batch, heads, KERNEL_LANDMARKS)):
        raise ValueError(f"stats must be a contiguous float32 ({batch}, {heads}, "
                         f"{KERNEL_LANDMARKS}) tensor on {dev}")
    _call(_library(), "nystrom_landmark_attn", dev, q_lm.data_ptr(), k_ptr, v_ptr, *k_strides,
          out.data_ptr(), None if stats is None else stats.data_ptr(), *scratch, batch, heads,
          n, per, splits, stream)
    return out


def _launch_landmark(*args, **kw):
    """:func:`landmark_launch`, counted as one launch of B5/B3."""
    out = landmark_launch(*args, **kw)
    LAUNCHES["nystrom_landmark_attn"] += 1
    return out


def query_launch(q, q_ptr, q_strides, k_lm, bmat, out, o_strides, batch, heads, n):
    """B6/B4's kernel, uncounted: rows of q read from ``q_ptr`` at
    ``q_strides`` (batch, head, row), in floats; k_lm, bmat (batch, heads, m,
    d); the result written into ``out`` (float32, allocated by the caller on
    q's device) at ``o_strides``. ``q`` is the tensor whose rows are read,
    checked here. The TransLayer kernels launch it through here and count
    their own calls."""
    dev = q.device
    _check_rows("q", q, dev)
    _check_landmarks("k_lm", k_lm, batch, heads, dev)
    _check_landmarks("bmat", bmat, batch, heads, dev)
    _check_length(n)
    blocks = query_plan(batch * heads, n, _sm_count(dev.index))
    _call(_library(), "nystrom_query_lm", dev, q_ptr, *q_strides, k_lm.data_ptr(),
          bmat.data_ptr(), out.data_ptr(), *o_strides, batch, heads, n, blocks, _stream(dev))
    return out


def _launch_query(*args):
    """:func:`query_launch`, counted as one launch of B6/B4."""
    out = query_launch(*args)
    LAUNCHES["nystrom_query_lm"] += 1
    return out


# ------------------------------------------------------- (b*h, n, d) layout

def landmark_attention(q_lm: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       return_stats: bool = False):
    """B3: ``softmax(q_lm k^T) v``; q_lm (bh, m, d), k and v (bh, n, d) ->
    (bh, m, d) float32; with ``return_stats`` also each row's log-sum-exp
    of the scores, (bh, m), in the natural base (the kernel writes it)."""
    if _on_cpu(q_lm):
        return landmark_attention_reference(q_lm, k, v, return_stats)
    _check_rows("k", k, q_lm.device)
    _check_rows("v", v, q_lm.device)
    bh, n, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or v.stride() != k.stride():
        raise ValueError(f"k and v must share shape and strides, got {tuple(k.shape)}, {tuple(v.shape)}")
    stats = None
    if return_stats:
        stats = torch.empty((bh, 1, KERNEL_LANDMARKS), dtype=torch.float32, device=q_lm.device)
    out = _launch_landmark(q_lm[:, None], k.data_ptr(), v.data_ptr(),
                           (k.stride(0), 0, k.stride(1)), bh, 1, n, stats=stats)[:, 0]
    return (out, stats[:, 0]) if return_stats else out


def query_landmark_attention(q: torch.Tensor, k_lm: torch.Tensor,
                             bmat: torch.Tensor) -> torch.Tensor:
    """B4: ``softmax(q k_lm^T) B``; q (bh, n, d), k_lm and B (bh, m, d) ->
    (bh, n, d) float32."""
    if _on_cpu(q):
        return query_landmark_attention_reference(q, k_lm, bmat)
    bh, n, d = q.shape
    out = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    return _launch_query(q, q.data_ptr(), (q.stride(0), 0, q.stride(1)), k_lm[:, None],
                         bmat[:, None], out, (out.stride(0), 0, out.stride(1)), bh, 1, n)


# ------------------------------------------------------- packed layout

def _check_packed(qkv: torch.Tensor) -> tuple[int, int, int]:
    """(b, n, h) of a (b, n, 3, h, d) qkv."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (b, n, 3, h, d), got {tuple(qkv.shape)}")
    b, n, _, h, _ = qkv.shape
    return b, n, h


def landmark_attention_packed(q_lm: torch.Tensor, qkv: torch.Tensor) -> torch.Tensor:
    """B5: per head ``softmax(q_lm k^T) v`` reading the k and v planes of the
    packed qkv in place; q_lm (b, h, m, d), qkv (b, n, 3, h, d) -> (b, h, m, d)."""
    if _on_cpu(qkv):
        k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)  # views, (b, h, n, d)
        return landmark_attention_reference(q_lm, k, v)
    b, n, h = _check_packed(qkv)
    _check_rows("qkv", qkv, q_lm.device)
    s_b, s_n, s_plane, s_h, _ = qkv.stride()
    k_ptr = qkv.data_ptr() + 4 * s_plane  # the k and v planes, in bytes
    return _launch_landmark(q_lm, k_ptr, k_ptr + 4 * s_plane, (s_b, s_h, s_n), b, h, n)


def query_landmark_attention_packed(qkv: torch.Tensor, k_lm: torch.Tensor,
                                    bmat: torch.Tensor) -> torch.Tensor:
    """B6: per head ``softmax(q k_lm^T) B`` reading the q plane of the packed
    qkv in place; k_lm, B (b, h, m, d) -> (b, n, h, d)."""
    if _on_cpu(qkv):
        out = query_landmark_attention_reference(qkv[:, :, 0].transpose(1, 2), k_lm, bmat)
        return out.transpose(1, 2)
    b, n, h = _check_packed(qkv)
    d = KERNEL_DIM_HEAD
    out = torch.empty((b, n, h, d), dtype=torch.float32, device=qkv.device)
    s_b, s_n, _, s_h, _ = qkv.stride()
    return _launch_query(qkv, qkv.data_ptr(), (s_b, s_h, s_n), k_lm, bmat,
                         out, (n * h * d, d, h * d), b, h, n)


# ------------------------------------------------------- the attention ops

def _packed_forward(qkv, num_landmarks, pinv_iterations, scale):
    b, n, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"qkv must be (b, n, 3, h, d), got {tuple(qkv.shape)}")
    m = num_landmarks
    if n % m:
        raise ValueError(f"sequence length {n} not a multiple of landmarks {m}")
    scale = d ** -0.5 if scale is None else scale
    seg = n // m
    # a bfloat16 qkv goes through the kernels upcast (exact); what JAX hands
    # its kernels in the input dtype (the landmarks, B) is rounded to it
    dt = qkv.dtype
    qkv = qkv.float()
    # landmarks (b, h, m, d): the q landmarks scaled after the mean
    q_lm = qkv[:, :, 0].reshape(b, m, seg, h, d).mean(dim=2).transpose(1, 2) * scale
    k_lm = qkv[:, :, 1].reshape(b, m, seg, h, d).mean(dim=2).transpose(1, 2)
    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    attn2_inv = newton_schulz_pinv(attn2, pinv_iterations)
    attn3_v = landmark_attention_packed(q_lm.to(dt).float().contiguous(), qkv)
    bmat = (attn2_inv @ attn3_v).to(dt).float().contiguous()
    return query_landmark_attention_packed(qkv, (k_lm * scale).to(dt).float().contiguous(), bmat)


class _FusedPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_landmarks, pinv_iterations, scale):
        ctx.save_for_backward(qkv)
        ctx.config = (num_landmarks, pinv_iterations, scale)
        return _packed_forward(qkv, num_landmarks, pinv_iterations, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        num_landmarks, pinv_iterations, scale = ctx.config
        d = qkv.shape[-1]
        q, k, v = (qkv[:, :, i].float().transpose(1, 2) for i in range(3))
        ratio = 1.0 if scale is None else scale / d ** -0.5
        if scale is not None:  # the forward scaled q by `scale`, not d**-0.5: fold the ratio
            q = q * ratio
        dq, dk, dv = nystrom_attention_bwd(q, k, v, g.transpose(1, 2), num_landmarks=num_landmarks,
                                           pinv_iterations=pinv_iterations)
        if scale is not None:
            dq = dq * ratio
        dqkv = torch.stack([dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)], dim=2)
        return dqkv.to(qkv.dtype), None, None, None


def nystrom_attention_fused_packed(qkv: torch.Tensor, num_landmarks: int = 256,
                                   pinv_iterations: int = 6,
                                   scale: float | None = None) -> torch.Tensor:
    """Fused Nystrom attention over the packed (b, n, 3, h, d) qkv projection
    (B5 + B6 on the card); q is scaled by ``scale`` (default d**-0.5).
    Returns (b, n, h, d) float32 for a float32 or bfloat16 qkv; its gradient
    is the analytic backward, in the dtype of qkv."""
    return _FusedPacked.apply(qkv, num_landmarks, pinv_iterations, scale)


def _fused_forward(q, k, v, num_landmarks, pinv_iterations):
    b, h, n, d = q.shape
    m = num_landmarks
    qs = q * d ** -0.5  # q scaled before its mean
    q_lm = _segment_means(qs.float(), m)
    k_lm = _segment_means(k.float(), m)
    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    attn2_inv = newton_schulz_pinv(attn2, pinv_iterations)
    attn3_v = landmark_attention(q_lm.reshape(b * h, m, d).contiguous(), k.reshape(b * h, n, d),
                                 v.reshape(b * h, n, d))
    bmat = (attn2_inv.reshape(b * h, m, m) @ attn3_v).contiguous()
    out = query_landmark_attention(qs.reshape(b * h, n, d), k_lm.reshape(b * h, m, d).contiguous(),
                                   bmat)
    return out.reshape(b, h, n, d)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_landmarks, pinv_iterations):
        ctx.save_for_backward(q, k, v)
        ctx.config = (num_landmarks, pinv_iterations)
        return _fused_forward(q, k, v, num_landmarks, pinv_iterations)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        num_landmarks, pinv_iterations = ctx.config
        dq, dk, dv = nystrom_attention_bwd(q, k, v, g, num_landmarks=num_landmarks,
                                           pinv_iterations=pinv_iterations)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def nystrom_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_landmarks: int = 256, pinv_iterations: int = 6) -> torch.Tensor:
    """Fused-kernel Nystrom attention (B3 + B4 on the card) over contiguous
    (b, h, n, d) q, k, v; the same semantics as
    ``ops.nystrom.nystrom_attention(...).out``."""
    return _Fused.apply(q.contiguous(), k.contiguous(), v.contiguous(), num_landmarks,
                        pinv_iterations)


# ------------------------------------------------------- the backward

def _softmax_vjp(a: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """d s for y = softmax(s) rows given a = softmax(s) and da = dy."""
    return a * (da - (a * da).sum(dim=-1, keepdim=True))


def _expand_segments(x_lm: torch.Tensor, n: int) -> torch.Tensor:
    """(..., m, d) -> (..., n, d): each landmark broadcast over its segment."""
    return x_lm.repeat_interleave(n // x_lm.shape[-2], dim=-2)


def nystrom_attention_bwd(q, k, v, g, *, num_landmarks, pinv_iterations):
    """Analytic VJP of Nystrom attention over (b, h, n, d) q, k, v and the
    output cotangent g; only n x m intermediates, no n x n matrix.

      Qs = Q d**-0.5;  Qlm = segmean(Qs);  Klm = segmean(K)
      A1 = softmax(Qs Klm^T);  A2 = softmax(Qlm Klm^T);  Z = NSpinv(A2)
      A3 = softmax(Qlm K^T);   W3 = A3 V;    OUT = A1 (Z W3)

    The pinv's VJP is autograd of :func:`newton_schulz_pinv` (whose init
    divisor is detached, as JAX stops its gradient). Returns (dQ, dK, dV) in
    float32.
    """
    b, h, n, d = q.shape
    m = num_landmarks
    seg = n // m
    scale = d ** -0.5
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    q_lm = _segment_means(qs, m)
    k_lm = _segment_means(kf, m)

    a2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    with torch.enable_grad():  # the recompute is the backward's work, not the forward pinv's
        a2_var = a2.detach().requires_grad_(True)
        z_var = newton_schulz(a2_var, pinv_iterations)
    z = z_var.detach()

    a1 = torch.softmax(qs @ k_lm.transpose(-1, -2), dim=-1)  # (b, h, n, m)
    a3 = torch.softmax(q_lm @ kf.transpose(-1, -2), dim=-1)  # (b, h, m, n)
    w3 = a3 @ vf
    bmat = z @ w3

    gf = g.float()
    da1 = gf @ bmat.transpose(-1, -2)  # OUT = A1 B
    dbmat = a1.transpose(-1, -2) @ gf
    dz = dbmat @ w3.transpose(-1, -2)  # B = Z W3
    dw3 = z.transpose(-1, -2) @ dbmat
    (da2,) = torch.autograd.grad(z_var, a2_var, dz)
    ds2 = _softmax_vjp(a2, da2)
    da3 = dw3 @ vf.transpose(-1, -2)  # W3 = A3 V
    dv = a3.transpose(-1, -2) @ dw3
    ds3 = _softmax_vjp(a3, da3)
    ds1 = _softmax_vjp(a1, da1)

    dqs = ds1 @ k_lm
    dq_lm = ds2 @ k_lm + ds3 @ kf
    dk_lm = ds2.transpose(-1, -2) @ q_lm + ds1.transpose(-1, -2) @ qs
    dk = ds3.transpose(-1, -2) @ q_lm
    dqs = dqs + _expand_segments(dq_lm, n) / seg
    dk = dk + _expand_segments(dk_lm, n) / seg
    return dqs * scale, dk, dv
