"""TransMIL in plain PyTorch, on flax-layout parameters.

The head as the DeepGraft reference defines it (Shao et al., NeurIPS 2021;
github.com/Ycblue/TransMIL-DeepGraft ``code/models/TransMIL.py``): fc1
(2048 -> 1024, GELU, LayerNorm, 1024 -> 512, GELU); the bag duplicate-padded
to a square grid; the cls token; TransLayer 1; PPEG (the grid plus its 7x7,
5x5 and 3x3 depthwise convs); TransLayer 2; LayerNorm; the classifier on
the cls row. A TransLayer is pre-norm Nystrom attention: the normed tokens
front-padded with zeros to a multiple of 256, qkv without bias, q scaled by
64**-0.5, contiguous-segment landmarks, ``softmax(q k_lm^T) pinv(softmax(q_lm
k_lm^T)) softmax(q_lm k^T) v`` with the order-3 Newton-Schulz pinv (6
iterations, its divisor one max over every batch and head), plus the 33-tap
depthwise value residual, the out projection (and its dropout in training),
the pad stripped, the residual added.

Precision (``mode``), each Dense layer, the value residual and PPEG:
  ``float32``  float32 with TF32 off (the slide path's head);
  ``tf32``     the same with TF32 on (the float32 control);
  ``bf16``     bfloat16 products and results, float32 parameters, the
               residual stream, LayerNorm, softmax and the pinv float32
               (the trained configuration's 16-mixed);
  ``fp8``      the bf16 mode with every operand of those layers first
               rounded to float8 e4m3 with a per-tensor scale (its control).
The attention's products are float32 in every mode but ``tf32``.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F

HEADS, DIM_HEAD, LANDMARKS, PINV_ITERS = 8, 64, 256, 6


@contextlib.contextmanager
def precision(mode: str):
    """Matmul and cuDNN settings of ``mode`` for the duration, restored after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        m.allow_bf16_reduced_precision_reduction = saved[2]


class Head:
    """The forward of TransMIL on a parameter tree of torch tensors."""

    def __init__(self, params: dict, mode: str = "float32", dropout=None) -> None:
        self.p = params
        self.mode = mode
        self.dt = torch.bfloat16 if mode in ("bf16", "fp8") else torch.float32
        self.acc = torch.float32  # the residual stream, LayerNorm and attention
        # dropout: None (eval) or (p, generator): the out projection's mask
        self.dropout = dropout

    # ---------------------------------------------------------- precision
    def _op(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a Dense layer, the value residual or PPEG."""
        if self.mode == "fp8":
            scale = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
            rounded = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
            t = t + (rounded - t.detach()).to(t.dtype)  # the rounded value, t's gradient
        return t.to(self.dt)

    def dense(self, x: torch.Tensor, tree: dict) -> torch.Tensor:
        y = self._op(x) @ self._op(tree["kernel"])
        return y + self._op(tree["bias"]) if "bias" in tree else y

    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        if self.dt != torch.bfloat16:
            return F.gelu(x)
        return 0.5 * x * torch.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))

    def layer_norm(self, x: torch.Tensor, tree: dict) -> torch.Tensor:
        return F.layer_norm(x.to(self.acc), (x.shape[-1],), tree["scale"].to(self.acc),
                            tree["bias"].to(self.acc), 1e-5)

    # ------------------------------------------------------------- layers
    def fc1(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gelu(self.dense(x.to(self.dt), self.p["fc1_0"]))
        h = self.layer_norm(h, self.p["fc1_norm0"])
        return self.gelu(self.dense(h, self.p["fc1_1"]))

    def translayer(self, x: torch.Tensor, tree: dict) -> torch.Tensor:
        b, n, dim = x.shape
        inner = HEADS * DIM_HEAD
        pad = (LANDMARKS - n % LANDMARKS) % LANDMARKS
        xp = F.pad(self.layer_norm(x, tree["norm"]), (0, 0, pad, 0))
        np_ = n + pad
        qkv = self.dense(xp, tree["attn"]["to_qkv"]).reshape(b, np_, 3, HEADS, DIM_HEAD)
        q, k, v = (qkv[:, :, i].transpose(1, 2).to(self.acc) for i in range(3))
        out = nystrom(q, k, v).transpose(1, 2).reshape(b, np_, inner)
        # the value residual: each head's taps along the sequence, per column
        v = self._op(qkv[:, :, 2]).to(self.acc)  # (b, np, heads, d)
        w = self._op(tree["attn"]["res_conv"]).to(self.acc)  # (taps, heads)
        res = correlate(v, w[:, :, None], dims=(1,))
        out = out + res.to(self.dt).to(self.acc).reshape(b, np_, inner)
        y = self.dense(out, tree["attn"]["to_out"])
        if self.dropout is not None:
            rate, gen = self.dropout
            keep = torch.empty_like(y).bernoulli_(1.0 - rate, generator=gen)
            y = y * keep / (1.0 - rate)
        return x + y[:, -n:].to(self.acc)

    def ppeg(self, x: torch.Tensor, side: int) -> torch.Tensor:
        b, _, c = x.shape
        cls, feat = x[:, :1], x[:, 1:]
        grid = self._op(feat.reshape(b, side, side, c)).to(self.acc)
        pos = self.p["pos_layer"]
        out = grid
        for name in ("proj", "proj1", "proj2"):  # (k, k, 1, C) depthwise kernels
            w = self._op(pos[name]).to(self.acc)[:, :, 0, :]  # (k, k, C)
            conv = correlate(grid, w, dims=(1, 2))
            out = out + conv + self._op(pos[f"{name}_bias"]).to(self.acc)
        return torch.cat([cls, out.to(self.dt).to(self.acc).reshape(b, side * side, c)], dim=1)

    def __call__(self, bags: torch.Tensor) -> torch.Tensor:
        """(B, n, D) float32 bags -> (B, n_classes) float32 logits."""
        h = self.fc1(bags)
        n = h.shape[1]
        side = math.ceil(math.sqrt(n))
        if side * side > n:
            h = torch.cat([h, h[:, :side * side - n]], dim=1)
        cls = self.p["cls_token"].expand(h.shape[0], -1, -1).to(self.acc)
        h = torch.cat([cls, h.to(self.acc)], dim=1)
        h = self.translayer(h, self.p["layer1"])
        h = self.ppeg(h, side)
        h = self.translayer(h, self.p["layer2"])
        h = self.layer_norm(h, self.p["norm"])[:, 0]
        return h @ self.p["fc"]["kernel"].to(self.acc) + self.p["fc"]["bias"].to(self.acc)


def correlate(x: torch.Tensor, w: torch.Tensor, dims: tuple) -> torch.Tensor:
    """A "same"-padded depthwise correlation over ``dims`` of x (one dim or
    two adjacent ones) as a sum of shifted products, in float32:
    ``out[t] = sum_k w[k] * x[t + k - K // 2]`` with zeros outside. ``w`` has
    one tap axis a dim, then axes that broadcast against x's trailing ones."""
    taps = w.shape[:len(dims)]
    pads = [0, 0] * x.dim()
    for d, k in zip(dims, taps):
        pads[2 * (x.dim() - 1 - d)] = pads[2 * (x.dim() - 1 - d) + 1] = k // 2
    xp = F.pad(x, pads)
    out = 0
    for idx in itertools.product(*(range(k) for k in taps)):
        view = xp
        for d, k0 in zip(dims, idx):
            view = view.narrow(d, k0, x.shape[d])
        out = out + w[idx] * view
    return out


def pinv(a: torch.Tensor, iters: int = PINV_ITERS) -> torch.Tensor:
    """Order-3 Newton-Schulz pseudo-inverse; the init divisor is one max over
    the whole batch of heads, with no gradient."""
    abs_a = a.abs()
    div = (abs_a.sum(dim=-1).max() * abs_a.sum(dim=-2).max()).detach()
    z = a.transpose(-1, -2) / div
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13 * eye - az @ (15 * eye - az @ (7 * eye - az)))
    return z


def nystrom(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) float32, n a multiple of the landmarks -> (b, h, n, d)."""
    b, h, n, d = q.shape
    q = q * d ** -0.5
    q_lm = q.reshape(b, h, LANDMARKS, n // LANDMARKS, d).mean(3)
    k_lm = k.reshape(b, h, LANDMARKS, n // LANDMARKS, d).mean(3)
    a1 = torch.softmax(q @ k_lm.transpose(-1, -2), dim=-1)
    a2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    a3 = torch.softmax(q_lm @ k.transpose(-1, -2), dim=-1)
    return (a1 @ pinv(a2)) @ (a3 @ v)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Mean over the batch of -log softmax at the label (one-hot targets)."""
    one_hot = F.one_hot(labels, n_classes).float()
    return -(one_hot * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
