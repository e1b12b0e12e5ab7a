"""Slide heatmaps: attention rows + GradCAM at the bag-feature level (port
of ``visualize/heatmap.py``; ref ``code/visualize_mil.py:81-670``).

- per-slide tile attention from the head's Nystrom query row (TransMIL's
  ``return_attn``, O(n*m), never the n x n matrix), mean over heads,
  min-max normalized (ref ``:584-592``);
- GradCAM tile attribution: ``relu(sum_c d score / d f * f)`` over the bag
  features, one ``torch.autograd.grad`` (ref ``:199-234`` wraps torch GradCAM
  around backbone + head). The gradient forward runs with autograd on, so a
  TransMIL takes its standard layers (B5/B6 with their analytic backward
  under ``use_pallas`` on the card), never the fused K1/K2 route;
- ``assemble_heatmap``: scatter tile scores onto the slide grid, gaussian
  smoothing, ROI mask from connected components (scipy.ndimage in place of
  skimage's remove_small_objects/holes, ref ``:245-436``);
- JPEG export: 'jet' (the default) from the port's own copy of matplotlib's
  256-entry table, so a heatmap JPEG needs no matplotlib; other colormap
  names import it;
- ``deep_feature_factorization``: scikit-learn's ``NMF(init='nndsvda',
  solver='cd', max_iter=400)`` written in numpy, so it needs no scikit-learn.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.models import head_logits


def attention_tile_scores(attn) -> np.ndarray:
    """(n_tokens,) tile scores of a ``TransMILAttention`` payload: the
    reference slice of bag 0, mean over heads, min-max normalized (ref
    ``visualize_mil.py:585-592``)."""
    scores = attn.tile_scores()[0].detach().float().cpu().numpy()  # (heads, n)
    scores = scores.mean(0)
    lo, hi = scores.min(), scores.max()
    return (scores - lo) / (hi - lo + 1e-12)


def gradcam_tile_scores(apply_fn: Callable[[torch.Tensor], torch.Tensor], bag: torch.Tensor,
                        target_class: int) -> np.ndarray:
    """GradCAM at the bag-feature level: ``relu(sum_c dL/df * f)``, min-max
    normalized. ``apply_fn(bag) -> logits (1, C)`` holds the weights."""
    with torch.enable_grad():
        b = bag.detach().requires_grad_(True)
        (grads,) = torch.autograd.grad(apply_fn(b)[0, target_class], b)
    cam = torch.relu((grads * b.detach()).sum(-1)).float().cpu().numpy().reshape(-1)
    lo, hi = cam.min(), cam.max()
    return (cam - lo) / (hi - lo + 1e-12)


def assemble_heatmap(coords: np.ndarray, scores: np.ndarray, *, downsample: int = 1,
                     blur_sigma: float = 1.0) -> np.ndarray:
    """Scatter per-tile scores into a 2D grid by tile coords (x, y), the mean
    where tiles share a cell, gaussian-smoothed; (H, W) in [0, 1]."""
    coords = np.asarray(coords, np.int64) // max(downsample, 1)
    scores = np.asarray(scores, np.float64)
    n = min(len(coords), len(scores))
    coords, scores = coords[:n], scores[:n]
    w = int(coords[:, 0].max()) + 1
    h = int(coords[:, 1].max()) + 1
    grid = np.zeros((h, w), np.float64)
    count = np.zeros((h, w), np.float64)
    np.add.at(grid, (coords[:, 1], coords[:, 0]), scores)
    np.add.at(count, (coords[:, 1], coords[:, 0]), 1.0)
    grid = np.where(count > 0, grid / np.maximum(count, 1), 0.0)
    if blur_sigma > 0:
        from scipy.ndimage import gaussian_filter

        grid = gaussian_filter(grid, blur_sigma)
    hi = grid.max()
    return grid / hi if hi > 0 else grid


def assemble_pixel_attention_map(coords: np.ndarray, scores: np.ndarray, *, tile_px: int = 224,
                                 sigma: float = 15.0) -> np.ndarray:
    """The reference's full-resolution attention mask (``visualize_mil.py:
    368-436`` ``_save_attention_map``): min-max normalize the tile scores,
    scatter onto the tile grid, bilinear-upsample to ``tile_px`` pixels a
    tile (``F.interpolate``, align_corners=False), min-max again, gaussian
    blur of ``sigma`` pixels."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    coords = np.asarray(coords, np.int64)
    s = np.asarray(scores, np.float64)
    s = (s - s.min()) / (s.max() - s.min() + 1e-12)
    w = int(coords[:, 0].max()) + 1
    h = int(coords[:, 1].max()) + 1
    grid = np.zeros((h, w), np.float64)
    grid[coords[:, 1], coords[:, 0]] = s
    H, W = h * tile_px, w * tile_px
    # align_corners=False sampling: src = (i + 0.5) * scale - 0.5, edge-clamped
    yy = (np.arange(H) + 0.5) * (h / H) - 0.5
    xx = (np.arange(W) + 0.5) * (w / W) - 0.5
    cy, cx = np.meshgrid(yy, xx, indexing="ij")
    up = map_coordinates(grid, [cy, cx], order=1, mode="nearest")
    up = (up - up.min()) / (up.max() - up.min() + 1e-12)
    return gaussian_filter(up, sigma=sigma)


def roi_mask(occupancy: np.ndarray, min_size: int = 16, fill_holes: bool = True) -> np.ndarray:
    """Tissue-region mask: drop small connected components, fill holes."""
    from scipy import ndimage

    mask = np.asarray(occupancy) > 0
    labeled, n = ndimage.label(mask)
    if n:
        sizes = ndimage.sum_labels(mask, labeled, index=np.arange(1, n + 1))
        keep = np.zeros(n + 1, bool)
        keep[1:] = sizes >= min_size
        mask = keep[labeled]
    if fill_holes:
        mask = ndimage.binary_fill_holes(mask)
    return mask


# matplotlib's 'jet' (``matplotlib._cm._jet_data``): per channel, the (x, y0,
# y1) segments of its LinearSegmentedColormap
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_JET_N = 256


@lru_cache(maxsize=1)
def jet_table() -> np.ndarray:
    """(256, 3) float64 RGB: the segments sampled as matplotlib's
    ``LinearSegmentedColormap`` samples them (``_create_lookup_table``, N 256,
    gamma 1)."""
    cols = []
    for channel in ("red", "green", "blue"):
        seg = np.asarray(_JET_SEGMENTS[channel], np.float64)
        x, y0, y1 = seg[:, 0] * (_JET_N - 1), seg[:, 1], seg[:, 2]
        xind = (_JET_N - 1) * np.linspace(0, 1, _JET_N)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols, axis=1)


def colormap_rgb(values: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """[0, 1] float values -> (..., 3) float RGB in [0, 1], as
    ``matplotlib.colormaps[colormap](values)[..., :3]``; 'jet' without
    matplotlib."""
    if colormap != "jet":
        try:
            import matplotlib as mpl
        except ImportError as e:
            raise ImportError(f"colormap {colormap!r} needs matplotlib, which is not installed; "
                              "'jet' does not") from e
        return mpl.colormaps[colormap](values)[..., :3]
    xa = np.array(values, dtype=np.float64) * _JET_N
    xa[xa == _JET_N] = _JET_N - 1  # 1.0 is the last entry, not over the range
    idx = np.clip(xa.astype(int), 0, _JET_N - 1)
    return jet_table()[idx]


def save_heatmap_jpeg(heatmap: np.ndarray, path: str | Path, *,
                      base_image: Optional[np.ndarray] = None, alpha: float = 0.5,
                      colormap: str = "jet", upscale: int = 8) -> Path:
    """Render a heatmap (optionally blended over a thumbnail) to JPEG."""
    from PIL import Image

    hm = np.clip(np.asarray(heatmap, np.float64), 0, 1)
    rgb = (colormap_rgb(hm, colormap) * 255).astype(np.uint8)
    img = Image.fromarray(rgb)
    if upscale > 1:
        img = img.resize((img.width * upscale, img.height * upscale), Image.BILINEAR)
    if base_image is not None:
        base = Image.fromarray(np.asarray(base_image).astype(np.uint8)).resize(img.size)
        img = Image.blend(base.convert("RGB"), img, alpha)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path, quality=90)
    return path


def _svd_flip_u(u: np.ndarray, vt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``svd_flip`` on U: each column's largest-magnitude
    entry made positive (V's rows follow)."""
    signs = np.sign(u[np.argmax(np.abs(u), axis=0), np.arange(u.shape[1])])
    return u * signs, vt * signs[:, None]


def _nndsvda(x: np.ndarray, k: int, eps: float = 1e-6) -> tuple[np.ndarray, np.ndarray]:
    """NNDSVD initialization, its zeros filled with the mean of X
    (scikit-learn ``_initialize_nmf(init='nndsvda')``; the SVD is exact here,
    scikit-learn's is randomized)."""
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    u, vt = _svd_flip_u(u[:, :k], vt[:k])
    w = np.zeros_like(u)
    h = np.zeros_like(vt)
    w[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
    h[0, :] = np.sqrt(s[0]) * np.abs(vt[0, :])
    for j in range(1, k):
        a, b = u[:, j], vt[j, :]
        a_p, b_p = np.maximum(a, 0), np.maximum(b, 0)
        a_n, b_n = np.abs(np.minimum(a, 0)), np.abs(np.minimum(b, 0))
        a_p_nrm, b_p_nrm = np.linalg.norm(a_p), np.linalg.norm(b_p)
        a_n_nrm, b_n_nrm = np.linalg.norm(a_n), np.linalg.norm(b_n)
        m_p, m_n = a_p_nrm * b_p_nrm, a_n_nrm * b_n_nrm
        if m_p > m_n:
            uu, vv, sigma = a_p / a_p_nrm, b_p / b_p_nrm, m_p
        else:
            uu, vv, sigma = a_n / a_n_nrm, b_n / b_n_nrm, m_n
        lbd = np.sqrt(s[j] * sigma)
        w[:, j] = lbd * uu
        h[j, :] = lbd * vv
    w[w < eps] = 0
    h[h < eps] = 0
    avg = x.mean()
    w[w == 0] = avg
    h[h == 0] = avg
    return w, h


def _cd_sweep(x: np.ndarray, w: np.ndarray, ht: np.ndarray) -> float:
    """One cyclic coordinate-descent pass over W's columns for X ~ W Ht^T
    (scikit-learn ``_update_coordinate_descent``, no regularization); the
    rows of a column are independent, so a column updates at once. Returns
    the projected-gradient violation."""
    hht = ht.T @ ht
    xht = x @ ht
    violation = 0.0
    for t in range(w.shape[1]):
        grad = w @ hht[t] - xht[:, t]
        pg = np.where(w[:, t] == 0, np.minimum(0.0, grad), grad)
        violation += float(np.abs(pg).sum())
        if hht[t, t] != 0:
            w[:, t] = np.maximum(w[:, t] - grad / hht[t, t], 0.0)
    return violation


def nmf(x: np.ndarray, n_components: int, max_iter: int = 400,
        tol: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """Non-negative X (n, d) ~ W (n, k) @ H (k, d): scikit-learn's
    ``NMF(init='nndsvda', solver='cd', beta_loss='frobenius')`` (alternating
    W and H sweeps until the violation falls to ``tol`` of the first's)."""
    x = np.asarray(x, np.float64)
    w, h = _nndsvda(x, n_components)
    w = np.ascontiguousarray(w)
    ht = np.ascontiguousarray(h.T)
    first = None
    for _ in range(max_iter):
        violation = _cd_sweep(x, w, ht) + _cd_sweep(x.T, ht, w)
        first = violation if first is None else first
        if first == 0 or violation / first <= tol:
            break
    return w, ht.T


def deep_feature_factorization(feats: np.ndarray, n_concepts: int = 4,
                               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deep Feature Factorization (ref ``visualize_dff.py``): NMF over the
    (N, D) tile features -> per-tile concept weights (N, K) + concept bases
    (K, D). Features are shifted non-negative first. ``seed`` is JAX's
    signature's: the port's NMF draws nothing."""
    del seed
    x = np.asarray(feats, np.float64)
    return nmf(x - x.min(), n_concepts)


def export_topk_tiles(scores: np.ndarray, coords: np.ndarray, slide_name: str,
                      out_csv: str | Path, k: int = 10) -> Path:
    """Top-k attended tiles of a slide as CSV (ref ``test_visualize.py``
    top-k tile export during trainer.test): columns slide, rank, x, y, score."""
    import pandas as pd

    scores = np.asarray(scores).reshape(-1)
    coords = np.asarray(coords)
    k = min(k, len(scores), len(coords))
    order = np.argsort(-scores)[:k]
    df = pd.DataFrame({"slide": slide_name, "rank": np.arange(k), "x": coords[order, 0],
                       "y": coords[order, 1], "score": scores[order]})
    out_csv = Path(out_csv)
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out_csv, index=False)
    return out_csv


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


class Visualizer:
    """Per-slide heatmap driver (the reference's ``Visualize.run``,
    ``visualize_mil.py:439-626``): the forward with attention, attention and
    GradCAM maps, ``{slide}_mil_{attn,gradcam}.jpg`` and the top-k CSV. A
    coord-aware head (RoFormerMIL) gets the slide's coords."""

    def __init__(self, model: torch.nn.Module, out_dir: str | Path,
                 target_class: int = 1) -> None:
        self.model = model
        self.out_dir = Path(out_dir)
        self.target_class = target_class
        self._coord_aware = bool(getattr(model, "coord_aware", False))

    def run_slide(self, bag: np.ndarray, coords: np.ndarray, slide_name: str) -> dict:
        dev = _device(self.model)
        x = torch.from_numpy(np.asarray(bag[None] if bag.ndim == 2 else bag)).to(dev)
        cargs = ((torch.from_numpy(np.asarray(coords, np.float32)[None]).to(dev),)
                 if self._coord_aware else ())
        self.model.eval()
        with torch.inference_mode():
            logits, attn = self.model(x, *cargs, return_attn=True)
            attn_scores = attention_tile_scores(attn)
            logits = logits.float().cpu().numpy()
        cam_scores = gradcam_tile_scores(lambda b: head_logits(self.model, b, *cargs), x,
                                         self.target_class)

        attn_map = assemble_heatmap(coords, attn_scores)
        cam_map = assemble_heatmap(coords, cam_scores)
        mask = roi_mask(assemble_heatmap(coords, np.ones(len(coords)), blur_sigma=0))
        attn_path = save_heatmap_jpeg(attn_map * mask, self.out_dir / f"{slide_name}_mil_attn.jpg")
        cam_path = save_heatmap_jpeg(cam_map * mask, self.out_dir / f"{slide_name}_mil_gradcam.jpg")
        export_topk_tiles(attn_scores, coords, slide_name,
                          self.out_dir / f"{slide_name}_topk_tiles.csv")
        return {"logits": logits, "attention": attn_scores, "gradcam": cam_scores,
                "paths": [attn_path, cam_path]}


class ImageVisualizer:
    """Raw-tile slide driver (the reference's fused-model visualizations,
    ``visualize_feature.py`` / ``visualize_classic.py``): tiles stream
    through the frozen backbone in chunks (ref ``visualize_mil.py:560-583``),
    the MIL head gives attention scores, and pixel-level CAM through the
    backbone (``cam_method``, any of ``visualize.cam.CAM_METHODS``) gives
    sub-tile saliency stitched into a slide heatmap."""

    def __init__(self, backbone: torch.nn.Module, head: torch.nn.Module, out_dir: str | Path,
                 target_class: int = 1, chunk: int = 64, tile_size: int = 224,
                 cam_method: str = "gradcam") -> None:
        self.backbone = backbone
        self.head = head
        self.out_dir = Path(out_dir)
        self.target_class = target_class
        self.chunk = chunk
        self.tile_size = tile_size
        self.cam_method = cam_method

    def run_slide(self, tiles: np.ndarray, coords: np.ndarray, slide_name: str) -> dict:
        from transmil_deepgraft_tpu_torch.visualize.gradcam import (
            assemble_pixel_heatmap, pixel_gradcam_image_mil)

        dev = _device(self.backbone)
        t = torch.from_numpy(np.asarray(tiles, np.float32)).to(dev)
        self.backbone.eval()
        self.head.eval()
        with torch.inference_mode():
            feats = torch.cat([self.backbone(t[s:s + self.chunk])
                               for s in range(0, t.shape[0], self.chunk)])
            logits, attn = self.head(feats[None], return_attn=True)
            attn_scores = attention_tile_scores(attn)
            logits = logits.float().cpu().numpy()
        attn_map = assemble_heatmap(coords, attn_scores)
        attn_path = save_heatmap_jpeg(attn_map, self.out_dir / f"{slide_name}_mil_attn.jpg")

        cams = pixel_gradcam_image_mil(self.backbone, self.head, t, self.target_class,
                                       method=self.cam_method)
        pixel_map = assemble_pixel_heatmap(cams, coords, tile_size=self.tile_size)
        pixel_path = save_heatmap_jpeg(pixel_map,
                                       self.out_dir / f"{slide_name}_pixel_gradcam.jpg")
        export_topk_tiles(attn_scores, coords, slide_name,
                          self.out_dir / f"{slide_name}_topk_tiles.csv")
        return {"logits": logits, "attention": attn_scores, "pixel_cams": cams,
                "paths": [attn_path, pixel_path]}
