"""CAM algorithm zoo over (tiles, h, w, C) feature maps (port of
``visualize/cam.py``).

The reference drives pytorch_grad_cam variants from its feature/classic
visualizers (``visualize_feature.py:21``, ``visualize_classic.py:21``:
GradCAM, HiResCAM, GradCAMPlusPlus, XGradCAM, EigenCAM, EigenGradCAM,
ScoreCAM) plus the ``show_cam_on_image`` jet overlay. As in the JAX package
they are functions of an activation map ``A`` and, for the gradient-based
ones, its upstream gradient ``G``, both (N, h, w, C) tensors (what
``torch.autograd.grad`` w.r.t. the backbone's pre-pool map gives, see
``visualize/gradcam.py``); the formulas are the published ones:

  gradcam        w_c = mean_hw(G)                cam = relu(sum_c w_c A_c)
  hirescam       cam = relu(sum_c (G * A)_c)     (no spatial averaging)
  gradcam_pp     alpha = G^2 / (2 G^2 + sum_hw(A G^3)); w = sum_hw(alpha relu(G))
  xgradcam       w_c = sum_hw(G A) / (sum_hw A + eps)
  eigencam       cam = A @ v1,  v1 = first right-singular vector of A (per tile)
  eigengradcam   eigencam on (G * A)
  scorecam       gradient-free: per-channel activation masks re-scored by the
                 model, softmax-weighted (``score_cam``)
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _collapse(weighted: torch.Tensor) -> torch.Tensor:
    return torch.relu(weighted.sum(dim=-1))


def _gradcam(a, g):
    return _collapse(g.mean(dim=(1, 2), keepdim=True) * a)


def _hirescam(a, g):
    return _collapse(g * a)


def _gradcam_pp(a, g):
    g2, g3 = g * g, g * g * g
    denom = 2.0 * g2 + (a * g3).sum(dim=(1, 2), keepdim=True)
    alpha = g2 / torch.where(denom != 0, denom, torch.ones_like(denom))
    w = (alpha * torch.relu(g)).sum(dim=(1, 2), keepdim=True)
    return _collapse(w * a)


def _xgradcam(a, g):
    w = (g * a).sum(dim=(1, 2), keepdim=True) / (a.sum(dim=(1, 2), keepdim=True) + 1e-7)
    return _collapse(w * a)


def _eigen_project(a):
    """Per-tile projection onto the first right-singular vector, sign-corrected
    so that the projection's mean is non-negative. v1 is the dominant
    eigenvector of flat^T flat by 100 power iterations, as in JAX."""
    n, h, w, c = a.shape
    flat = a.reshape(n, h * w, c)
    m = flat.transpose(1, 2) @ flat
    v = torch.ones((n, c, 1), dtype=flat.dtype, device=flat.device) / np.sqrt(c)
    for _ in range(100):
        v = m @ v
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
    proj = (flat @ v)[..., 0]  # (N, h*w)
    sign = torch.where(proj.mean(dim=1, keepdim=True) < 0, -1.0, 1.0).to(proj.dtype)
    return (proj * sign).reshape(n, h, w)


def _eigencam(a, g):
    del g
    return _eigen_project(a)


def _eigengradcam(a, g):
    return _eigen_project(g * a)


CAM_METHODS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "gradcam": _gradcam,
    "hirescam": _hirescam,
    "gradcam_pp": _gradcam_pp,
    "xgradcam": _xgradcam,
    "eigencam": _eigencam,
    "eigengradcam": _eigengradcam,
}


def compute_cam(method: str, activations: torch.Tensor,
                grads: torch.Tensor | None = None) -> torch.Tensor:
    """(N, h, w, C) activations [+ grads] -> raw (N, h, w) CAM (not normalized).
    ``grads`` may be None only for the gradient-free ``eigencam``."""
    if method not in CAM_METHODS:
        raise ValueError(f"unknown CAM method {method!r}; choose from {sorted(CAM_METHODS)}")
    if grads is None:
        if method != "eigencam":
            raise ValueError(f"{method} needs grads; only 'eigencam' is gradient-free")
        grads = activations  # unused
    return CAM_METHODS[method](activations, grads)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), ``jax.image.resize(..., 'bilinear')``:
    half-pixel centres, edge weights renormalized (the edge value), a
    triangle filter widened when it shrinks (torch's antialias)."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, 1, *x.shape[-2:])
    out = F.interpolate(flat, size=size, mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(*lead, *size)


def score_cam(
    activations: torch.Tensor,
    tiles: torch.Tensor,
    masked_score_fn: Callable[[torch.Tensor], torch.Tensor],
    channel_batch: int = 64,
) -> torch.Tensor:
    """ScoreCAM (gradient-free): each channel's activation map, upsampled to
    the tile size and min-max normalized, masks the input; the model's target
    score on the masked input weights that channel (softmax over channels).

    ``masked_score_fn(masked_tiles) -> ()`` scores one masked copy of the
    whole tile batch (e.g. the bag logit of the target class). The masks are
    made ``channel_batch`` channels at a time, to bound memory."""
    n, h, w, c = activations.shape
    th, tw = tiles.shape[1], tiles.shape[2]
    if c % channel_batch:
        raise ValueError(f"C={c} not divisible by channel_batch={channel_batch}")
    scores = []
    for start in range(0, c, channel_batch):
        maps = activations[..., start:start + channel_batch].permute(3, 0, 1, 2)  # (B, N, h, w)
        up = resize_bilinear(maps, (th, tw))
        lo = up.amin(dim=(1, 2, 3), keepdim=True)
        hi = up.amax(dim=(1, 2, 3), keepdim=True)
        masks = (up - lo) / (hi - lo + 1e-8)
        scores += [masked_score_fn(tiles * mk[..., None]).reshape(()) for mk in masks]
    wgt = torch.softmax(torch.stack(scores), dim=0)
    return torch.relu(torch.einsum("nhwc,c->nhw", activations, wgt))


def normalize_cam(cam, per_tile: bool = False) -> np.ndarray:
    """Min-max to [0, 1]; per tile (classic mode) or over the whole slide."""
    if isinstance(cam, torch.Tensor):
        cam = cam.detach().cpu().numpy()
    cam = np.asarray(cam, np.float32)
    if per_tile:
        flat = cam.reshape(cam.shape[0], -1)
        lo = flat.min(-1).reshape(-1, 1, 1)
        hi = flat.max(-1).reshape(-1, 1, 1)
    else:
        lo, hi = cam.min(), cam.max()
    return (cam - lo) / (hi - lo + 1e-12)


_JET_STOPS = np.asarray(
    [[0, 0, 127], [0, 0, 255], [0, 255, 255], [255, 255, 0], [255, 0, 0], [127, 0, 0]],
    np.float32,
)


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """[0,1] grayscale -> uint8 RGB jet (the cv2.COLORMAP_JET family the
    reference's ``show_cam_on_image`` applies)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    pos = x * (len(_JET_STOPS) - 1)
    i0 = np.clip(pos.astype(np.int32), 0, len(_JET_STOPS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _JET_STOPS[i0] * (1 - frac) + _JET_STOPS[i0 + 1] * frac
    return rgb.astype(np.uint8)


def show_cam_on_image(image: np.ndarray, cam: np.ndarray,
                      image_weight: float = 0.6) -> np.ndarray:
    """Reference ``show_cam_on_image(..., use_rgb=True, image_weight=0.6)``
    (``visualize_classic.py:271``): jet-coloured CAM blended over the [0,1]
    RGB image. Returns uint8 RGB."""
    heat = jet_colormap(cam).astype(np.float32) / 255.0
    img = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    out = image_weight * img + (1.0 - image_weight) * heat
    return (out * 255.0).astype(np.uint8)
