"""Pixel-level GradCAM through the backbone (port of
``visualize/gradcam.py``; the reference's fused-model CAM).

The reference wraps ``GradCAM(nn.Sequential(retccl, transmil))`` with the
last ResNet stage as the target layer (``visualize_mil.py:199-234``) and
per-tile CAM for classic CNNs (``visualize_classic.py``,
``test_visualize.py:38-120``). Here, as in JAX, the gradient is taken w.r.t.
the backbone's pre-pool feature map (``return_spatial=True``):

  weights_c = mean_spatial( d logit_target / d A )      (GradCAM weights)
  cam       = relu( sum_c weights_c * A_c )             per tile, (h, w)

normalized over the slide to [0, 1]. The gradient flows through the MIL head
(bag logit -> pooled features -> the map), so tile saliency follows the
slide-level decision. The head runs in eval mode with autograd on (a
TransMIL head takes its standard layers).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.visualize.cam import compute_cam, normalize_cam, resize_bilinear


def _spatial(backbone: torch.nn.Module, tiles: torch.Tensor) -> torch.Tensor:
    """The backbone's (N, h, w, C) pre-pool map in eval mode, as a leaf
    that takes a gradient."""
    backbone.eval()
    with torch.no_grad():
        maps = backbone(tiles, return_spatial=True)
    return maps.detach().requires_grad_(True)


def pixel_gradcam_image_mil(backbone: torch.nn.Module, head: torch.nn.Module,
                            tiles: torch.Tensor, target_class: int,
                            method: str = "gradcam") -> np.ndarray:
    """Per-tile pixel-level CAM through backbone + MIL head: (N, H, W, 3)
    tiles -> (N, h, w) maps, min-max normalized over the slide."""
    head.eval()
    with torch.enable_grad():
        maps = _spatial(backbone, tiles)
        logits = head(maps.mean(dim=(1, 2))[None])
        if isinstance(logits, tuple):
            logits = logits[1] if logits[0].dim() > logits[1].dim() else logits[0]
        (grads,) = torch.autograd.grad(logits.reshape(-1)[target_class], maps)
    return normalize_cam(compute_cam(method, maps.detach(), grads))


def classic_tile_gradcam(backbone: torch.nn.Module, tiles: torch.Tensor, target_class: int,
                         classifier_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         method: str = "gradcam") -> np.ndarray:
    """Per-tile CAM for classic per-tile classifiers (ref
    ``visualize_classic.py``): the gradient of each tile's OWN logit w.r.t.
    its last conv map, each tile's map divided by its maximum.
    ``classifier_apply`` maps pooled features -> logits (default: the pooled
    features themselves)."""
    with torch.enable_grad():
        maps = _spatial(backbone, tiles)
        pooled = maps.mean(dim=(1, 2))
        logits = classifier_apply(pooled) if classifier_apply is not None else pooled
        (grads,) = torch.autograd.grad(logits[:, target_class].sum(), maps)
    cam = compute_cam(method, maps.detach(), grads).float().cpu().numpy()
    per_tile_max = cam.reshape(cam.shape[0], -1).max(-1, keepdims=True) + 1e-12
    return cam / per_tile_max.reshape(-1, 1, 1)


def assemble_pixel_heatmap(cams: np.ndarray, coords: np.ndarray, tile_size: int = 224,
                           downscale: int = 16) -> np.ndarray:
    """Stitch per-tile CAM maps into a slide heatmap by tile coords (ref
    ``visualize_feature.py`` assemble): each (h, w) map resized (bilinear,
    as ``jax.image.resize``) to the tile's footprint at 1/``downscale`` and
    placed at its grid cell. (H, W) float32 in [0, 1]."""
    coords = np.asarray(coords)
    ts = tile_size // downscale
    gx = coords[:, 0].max() + 1
    gy = coords[:, 1].max() + 1
    out = np.zeros((int(gy) * ts, int(gx) * ts), np.float32)
    tiles = resize_bilinear(torch.from_numpy(np.asarray(cams, np.float32)), (ts, ts)).numpy()
    for tile, (x, y) in zip(tiles, coords):
        out[int(y) * ts:(int(y) + 1) * ts, int(x) * ts:(int(x) + 1) * ts] = tile
    return np.clip(out, 0.0, 1.0)
