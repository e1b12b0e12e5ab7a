"""Slide-inference pipeline: int8 PTQ backbone + TransMIL head (port of
``inference.py``).

Raw tiles stream through the int8 post-training-quantized ResNet50
(``models/resnet_int8``) in fixed chunks, the features stay on the device,
and the bag goes through the head (the port's TransMIL, whose TransLayers run
the K1/K2 kernels at inference). On a CUDA device the backbone's bottleneck
stages run the int8 stage/entry kernels (``ops/qstage_kernel``).

Left for later slices: decoding tiles from disk (``decode_tile_paths``,
``embed_paths_device``, ``predict_slide_paths*``), the multi-device ``mesh``
and coord-aware heads.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from transmil_deepgraft_tpu_torch.device import resolve_device

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def chunked_device_embed(
    call: Callable[[np.ndarray], torch.Tensor], tiles: np.ndarray, chunk: int
) -> torch.Tensor:
    """Run ``call`` over ``tiles`` in fixed ``chunk``-size batches (zero-pad
    the last) and concatenate the features on the device."""
    n = tiles.shape[0]
    if n == 0:
        raise ValueError("empty tile batch")
    outs = []
    for start in range(0, n, chunk):
        batch = tiles[start:start + chunk]
        pad = chunk - batch.shape[0]
        if pad:
            batch = np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
        outs.append(call(batch))
    return torch.cat(outs, dim=0)[:n] if len(outs) > 1 else outs[0][:n]


class SlideInferencePipeline:
    """tiles (N, H, W, 3) -> slide probabilities (and attention scores).

    Args:
      backbone_variables: fp32 ResNet50 ``{'params','batch_stats'}`` in flax
        layout (numpy leaves), e.g. converted from ``retccl_best_ckpt.pth``.
      head_model: the bag-level head, an ``nn.Module`` with its weights (the
        port's TransMIL); it is moved to the device and put in eval mode.
      calib_tiles: representative tiles for int8 activation calibration;
        None runs the backbone in bf16 instead.
      chunk: tile batch per backbone call.
      fused_backbone / fused_t_cfg: the JAX package's segment control
        (``apply_qresnet50_fused``); every non-zero entry must divide
        ``chunk``, and a 0 sends that segment through the plain block loop.
        With ``fused_backbone=False`` the int8 stages run the kernels too, as
        ``apply_qresnet50`` does on the card.
      device: None means CUDA; pass "cpu" to run the plain versions.
    """

    def __init__(
        self,
        backbone_variables: dict,
        head_model: nn.Module,
        *,
        calib_tiles: Optional[np.ndarray] = None,
        truncate_after: int = 4,
        chunk: int = 128,
        fused_backbone: bool = False,
        fused_t_cfg: tuple = (1, 2, 4, 4, 4, 4, 4),
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.head = head_model.to(self.device).eval()
        self.chunk = chunk
        if calib_tiles is not None:
            from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
                apply_qresnet50,
                apply_qresnet50_fused,
                build_qresnet50,
                prepare_qresnet50_fused,
            )

            self._q = build_qresnet50(backbone_variables, calib_tiles,
                                      truncate_after=truncate_after, device=self.device)
            if fused_backbone:
                for t in fused_t_cfg:
                    if t and chunk % t:  # 0 = the plain loop for that segment
                        raise ValueError(f"t={t} does not divide chunk={chunk}")
                self._q = prepare_qresnet50_fused(self._q)
                self._embed_core = lambda x: apply_qresnet50_fused(self._q, x, t_cfg=fused_t_cfg)
            else:
                self._embed_core = lambda x: apply_qresnet50(self._q, x)
        else:
            from transmil_deepgraft_tpu_torch.models.resnet import ResNet
            from transmil_deepgraft_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

            model = ResNet(truncate_after=truncate_after)
            model.load_state_dict(resnet_state_dict_from_jax(backbone_variables))
            model = model.to(self.device, torch.bfloat16).eval()
            self._embed_core = lambda x: model(x.to(torch.bfloat16)).float()
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    def _embed_chunk(self, batch: np.ndarray) -> torch.Tensor:
        """One host chunk -> (chunk, D) float32 features on the device. Raw
        uint8 tiles ship 4x fewer bytes and are normalized on the device."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self._mean) / self._std
        with torch.inference_mode():
            return self._embed_core(x)

    def embed(self, tiles: np.ndarray) -> np.ndarray:
        """Chunked tile embedding -> (N, D) float32 features on the host.
        Accepts normalized float32 tiles or raw uint8 tiles."""
        return self.embed_device(tiles).cpu().numpy()

    def embed_device(self, tiles: np.ndarray) -> torch.Tensor:
        """Chunked tile embedding -> (N, D) float32 features left on the
        device, for the head to consume without a round trip."""
        return chunked_device_embed(self._embed_chunk, tiles, self.chunk)

    def predict_slide(self, tiles: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) tiles -> (C,) slide class probabilities."""
        feats = self.embed_device(tiles)
        with torch.inference_mode():
            probs = torch.softmax(self.head(feats[None]), dim=-1)
        return probs.cpu().numpy()[0]

    def predict_slide_with_attention(self, tiles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (probs (C,), per-tile attention scores (N,))."""
        n_tiles = len(tiles)
        feats = self.embed_device(tiles)
        with torch.inference_mode():
            logits, attn = self.head(feats[None], return_attn=True)
            probs = torch.softmax(logits, dim=-1).cpu().numpy()[0]
            # TransMIL-family heads return a payload with tile_scores()
            # (B, heads, n); gated heads return the (B, n) weights directly
            raw = attn.tile_scores() if hasattr(attn, "tile_scores") else attn
            if raw.numel() % n_tiles != 0:
                raise ValueError(
                    f"head attention shape {tuple(raw.shape)} is not a multiple of the "
                    f"tile count {n_tiles}; heads must return per-tile scores with a "
                    f"trailing length equal to the (unpadded) tile count"
                )
            scores = raw.reshape(1, -1, n_tiles).mean(dim=1)[0]
        return probs, scores.cpu().numpy()
