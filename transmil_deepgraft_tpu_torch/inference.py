"""Slide-inference pipeline: int8 PTQ backbone + a MIL head (port of
``inference.py``).

Raw tiles stream through the int8 post-training-quantized ResNet50
(``models/resnet_int8``), or a ViT tile encoder given as a module (UNI2-h,
``models/vit``: bf16 on the card), in fixed chunks, the features stay on
the device, and the bag goes through the head (the port's TransMIL, whose
TransLayers run the K1/K2 kernels at inference, or another ported head). A coord-aware head
(RoFormerMIL) gets the tiles' (N, 2) grid coordinates as its second
argument, or its square-grid fallback when there are none; for the other
heads ``coords`` are accepted and not used, as in the JAX package. On a
CUDA device the backbone's bottleneck stages run the int8 stage/entry
kernels (``ops/qstage_kernel``).

Tiles come as arrays (``predict_slide*``) or as image files streamed from
disk (``predict_slide_paths*``): the next chunk decodes on a host thread
while this one embeds on the device.

With a ``mesh`` (``parallel.mesh.make_mesh``, one process a card) the embed
is tile-parallel (``parallel/tile_parallel``): each chunk holds ``chunk``
tiles per process, every process embeds its contiguous shard (on the card
through the int8 stage kernels, as ``apply_qresnet50`` runs them) and the
features are all-gathered before the head, which then runs on every process
(each returns the same probabilities, with no further collective). From disk
each process decodes only its shard of each chunk.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from transmil_deepgraft_tpu_torch.data.tiles import IMAGENET_MEAN, IMAGENET_STD, _load_tile
from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models import head_logits
from transmil_deepgraft_tpu_torch.models.vit import VisionTransformer
from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, axis_size
from transmil_deepgraft_tpu_torch.utils import profiling


def decode_tile_paths(paths, size: int = 224, scaled_dct: bool = True) -> np.ndarray:
    """Decode a chunk of tile image paths -> raw (n, size, size, 3) uint8.

    An all-JPEG chunk goes through the native threaded loader
    (``data/native_tiles``) when it is available; anything else (PNGs, a
    tile that fails to decode, no loader) decodes tile by tile with PIL.
    ``scaled_dct`` decodes JPEG sources of at least 2x ``size`` at a reduced
    DCT scale (sources under 2x decode the same either way). Normalization
    happens on the device."""
    from transmil_deepgraft_tpu_torch.data import native_tiles as nt

    if nt.available() and all(str(p).lower().endswith((".jpg", ".jpeg")) for p in paths):
        batch, n_ok = nt.load_tiles_u8(paths, size, scaled_dct=scaled_dct)
        if n_ok == len(paths):
            return batch
    return np.stack([_load_tile(p, size) for p in paths])


def _broadcast_tensors(obj, group):
    """A NamedTuple of tensors (nested, None leaves kept) with every tensor
    replaced by the group's first process's value, broadcast in place."""
    import torch.distributed as dist

    src = dist.get_global_rank(group, 0)

    def walk(x):
        if torch.is_tensor(x):
            x = x.contiguous()
            dist.broadcast(x, src=src, group=group)
            return x
        if isinstance(x, tuple):
            vals = [walk(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    return walk(obj)


def _pad_chunk(batch: np.ndarray, chunk: int) -> np.ndarray:
    """Zero-pad a short last batch to ``chunk`` tiles."""
    pad = chunk - batch.shape[0]
    if pad:
        batch = np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
    return batch


def chunked_device_embed(
    call: Callable[[np.ndarray], torch.Tensor], tiles: np.ndarray, chunk: int
) -> torch.Tensor:
    """Run ``call`` over ``tiles`` in fixed ``chunk``-size batches (zero-pad
    the last) and concatenate the features on the device."""
    n = tiles.shape[0]
    if n == 0:
        raise ValueError("empty tile batch")
    outs = [call(_pad_chunk(tiles[start:start + chunk], chunk)) for start in range(0, n, chunk)]
    return torch.cat(outs, dim=0)[:n] if len(outs) > 1 else outs[0][:n]


def embed_chunk(core: Callable[[torch.Tensor], torch.Tensor], batch: np.ndarray,
                mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """One host chunk -> (chunk, D) float32 features from the backbone
    ``core`` on the device of ``mean``. Raw uint8 tiles ship 4x fewer bytes
    and are ImageNet-normalized on the device (``mean``, ``std``)."""
    with profiling.span("slide.copy"):
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(mean.device)
    if x.dtype == torch.uint8:
        x = (x.float() / 255.0 - mean) / std
    with torch.inference_mode():
        return core(x)


class SlideInferencePipeline:
    """tiles (N, H, W, 3) -> slide probabilities (and attention scores).

    Args:
      backbone_variables: fp32 ResNet50 ``{'params','batch_stats'}`` in flax
        layout (numpy leaves), e.g. converted from ``retccl_best_ckpt.pth``.
      head_model: the bag-level head, an ``nn.Module`` with its weights (a
        ported head); it is moved to the device and put in eval mode.
      backbone: instead of ``backbone_variables``, a ViT tile encoder
        (``models/vit.VisionTransformer``, e.g. ``models/backbones.
        uni2_h_from_timm``) with its weights; it is moved to the device, put
        in eval mode and, on CUDA, given bf16 matmuls (``cast_matmuls``:
        float32 residual stream, LayerNorm and LayerScale). Its features
        come back float32. It takes no ``calib_tiles`` or ``fused_backbone``
        (int8 is the ResNet50 family's).
      calib_tiles: representative tiles for int8 activation calibration;
        None runs the backbone in bf16 instead.
      chunk: tile batch per backbone call.
      fused_backbone / fused_t_cfg: the JAX package's segment control
        (``apply_qresnet50_fused``); every non-zero entry must divide
        ``chunk``, and a 0 sends that segment through the plain block loop.
        With ``fused_backbone=False`` the int8 stages run the kernels too, as
        ``apply_qresnet50`` does on the card.
      device: None means CUDA; pass "cpu" to run the plain versions.
      mesh / mesh_axis: a ``DeviceMesh`` makes the embed tile-parallel over
        its ``mesh_axis`` dim: ``chunk`` tiles per process a chunk, so
        ``self.chunk`` is ``chunk`` times the dim's size; features are
        gathered before the head. Every process of the mesh makes the same
        calls. ``fused_backbone=True`` with a mesh raises, as in JAX.
    """

    def __init__(
        self,
        backbone_variables: Optional[dict],
        head_model: nn.Module,
        *,
        backbone: Optional[nn.Module] = None,
        calib_tiles: Optional[np.ndarray] = None,
        truncate_after: int = 4,
        chunk: int = 128,
        fused_backbone: bool = False,
        fused_t_cfg: tuple = (1, 2, 4, 4, 4, 4, 4),
        device: str | torch.device | None = None,
        mesh=None,
        mesh_axis: str = "dp",
    ) -> None:
        self.coord_aware = bool(getattr(head_model, "coord_aware", False))
        self.device = resolve_device(device)
        self.head = head_model.to(self.device).eval()
        self.mesh = mesh
        self._shards, self._shard = axis_size(mesh, mesh_axis), axis_rank(mesh, mesh_axis)
        self._group = mesh.get_group(mesh_axis) if mesh is not None else None
        self.rank_chunk = chunk
        self.chunk = chunk * self._shards
        self._vit = backbone is not None
        if self._vit:
            self._embed_core = self._vit_core(backbone, calib_tiles, fused_backbone)
        elif calib_tiles is not None:
            from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
                apply_qresnet50,
                apply_qresnet50_fused,
                build_qresnet50,
                prepare_qresnet50_fused,
            )

            self._q = build_qresnet50(backbone_variables, calib_tiles,
                                      truncate_after=truncate_after, device=self.device)
            if fused_backbone and mesh is not None:
                raise ValueError(
                    "fused_backbone (experimental Pallas kernels) does not "
                    "compose with tile-parallel mesh embedding; the XLA int8 "
                    "path is the production multi-chip path"
                )
            if mesh is not None:  # every process embeds with rank 0's constants
                self._q = _broadcast_tensors(self._q, self._group)
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

    def _vit_core(self, backbone: nn.Module, calib_tiles, fused_backbone: bool):
        """The embed of a ViT module: bf16 matmuls on CUDA, float32 on the
        CPU; float32 features."""
        if not isinstance(backbone, VisionTransformer):
            raise TypeError(f"backbone must be a models/vit.VisionTransformer, got "
                            f"{type(backbone).__name__}")
        if calib_tiles is not None or fused_backbone:
            raise ValueError("int8 (calib_tiles, fused_backbone) quantizes the ResNet50 family; "
                             "a ViT backbone runs in bf16")
        model = backbone.to(self.device).eval()
        if self.device.type == "cuda":
            model.cast_matmuls(torch.bfloat16)
        return lambda x: model(x).float()

    def _embed_chunk(self, batch: np.ndarray) -> torch.Tensor:
        """One chunk of ``self.chunk`` tiles -> its (chunk, D) features; with
        a mesh this process embeds its shard and the shards are gathered."""
        if self.mesh is None:
            return embed_chunk(self._embed_core, batch, self._mean, self._std)
        c, r = self.rank_chunk, self._shard
        return self._gather(self._embed_shard(batch[r * c:(r + 1) * c]))

    def _embed_shard(self, batch: np.ndarray) -> torch.Tensor:
        return embed_chunk(self._embed_core, batch, self._mean, self._std)

    def _gather(self, feats: torch.Tensor) -> torch.Tensor:
        from transmil_deepgraft_tpu_torch.parallel.tile_parallel import gather_rows

        return gather_rows(feats, self._group)

    def embed(self, tiles: np.ndarray) -> np.ndarray:
        """Chunked tile embedding -> (N, D) float32 features on the host.
        Accepts normalized float32 tiles or raw uint8 tiles."""
        return self.embed_device(tiles).cpu().numpy()

    def embed_device(self, tiles: np.ndarray) -> torch.Tensor:
        """Chunked tile embedding -> (N, D) float32 features left on the
        device, for the head to consume without a round trip. On the ViT
        route the ragged last chunk's zero tiles count in
        ``backbone.vit_pad_tiles`` while a profiler runs."""
        if self._vit and len(tiles) % self.chunk:
            profiling.count("backbone.vit_pad_tiles", self.chunk - len(tiles) % self.chunk)
        return chunked_device_embed(self._embed_chunk, tiles, self.chunk)

    def embed_paths_device(self, paths, *, tile_size: int = 224) -> torch.Tensor:
        """Tile image paths -> (N, D) float32 features on the device,
        streamed: the next chunk decodes on a host thread while this chunk
        embeds, so the host holds at most two decoded chunks. The last chunk
        is zero-padded; features concatenate on the device."""
        n = len(paths)
        if n == 0:
            raise ValueError("empty tile path list")
        chunks = [paths[i:i + self.chunk] for i in range(0, n, self.chunk)]
        if self.mesh is not None:  # this process's shard of each chunk
            c, r = self.rank_chunk, self._shard
            chunks = [ch[r * c:(r + 1) * c] for ch in chunks]

        def decode(ch):
            if not len(ch):  # a short last chunk leaves this shard empty
                return np.zeros((0, tile_size, tile_size, 3), np.uint8)
            return decode_tile_paths(ch, tile_size)

        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(decode, chunks[0])
            for ci in range(len(chunks)):
                batch = fut.result()
                if ci + 1 < len(chunks):  # decode the next chunk during this embed
                    fut = pool.submit(decode, chunks[ci + 1])
                if self.mesh is None:
                    outs.append(self._embed_chunk(_pad_chunk(batch, self.chunk)))
                else:
                    outs.append(self._gather(self._embed_shard(_pad_chunk(batch,
                                                                          self.rank_chunk))))
        return torch.cat(outs, dim=0)[:n] if len(outs) > 1 else outs[0][:n]

    def predict_slide_paths(self, paths, coords: Optional[np.ndarray] = None, *,
                            tile_size: int = 224) -> np.ndarray:
        """Tile image paths on disk -> (C,) slide probabilities, streamed
        (see :meth:`embed_paths_device`)."""
        with self._allocs_counted():
            return self._probs(self.embed_paths_device(paths, tile_size=tile_size), coords)

    def predict_slide_paths_with_attention(
        self, paths, coords: Optional[np.ndarray] = None, *, tile_size: int = 224
    ) -> tuple[np.ndarray, np.ndarray]:
        """Streamed :meth:`predict_slide_with_attention`."""
        with self._allocs_counted():
            feats = self.embed_paths_device(paths, tile_size=tile_size)
            return self._attention_from_feats(feats, len(paths), coords)

    def predict_slide(self, tiles: np.ndarray, coords: Optional[np.ndarray] = None) -> np.ndarray:
        """(N, H, W, 3) tiles -> (C,) slide class probabilities. ``coords``
        ((N, 2) tile grid positions) feed a coord-aware head."""
        with self._allocs_counted():
            return self._probs(self.embed_device(tiles), coords)

    def predict_slide_with_attention(
        self, tiles: np.ndarray, coords: Optional[np.ndarray] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (probs (C,), per-tile attention scores (N,))."""
        with self._allocs_counted():
            return self._attention_from_feats(self.embed_device(tiles), len(tiles), coords)

    @contextlib.contextmanager
    def _allocs_counted(self):
        """Count the slide's device allocations (``slide.device_allocs``)
        while a profiler runs: the allocator's count at its entry and exit."""
        if not profiling.enabled():
            yield
            return
        before = profiling.device_allocs(self.device)
        try:
            yield
        finally:
            profiling.count("slide.device_allocs", profiling.device_allocs(self.device) - before)

    def _head(self, feats: torch.Tensor, coords, **kw):
        """The head's logits on one (N, D) bag (with ``return_attn=True``
        its (logits, attention)); a coord-aware one also gets the (1, N, 2)
        coords (None: its square-grid fallback)."""
        args = (feats[None],)
        if self.coord_aware:
            if coords is not None:
                coords = np.asarray(coords, np.float32)
                if coords.shape != (feats.shape[0], 2):
                    raise ValueError(f"coords must be ({feats.shape[0]}, 2), got "
                                     f"{coords.shape}")
                coords = torch.from_numpy(coords[None]).to(self.device)
            args += (coords,)
        return self.head(*args, **kw) if kw else head_logits(self.head, *args)

    def _probs(self, feats: torch.Tensor, coords=None) -> np.ndarray:
        with profiling.span("slide.head"), torch.inference_mode():
            probs = torch.softmax(self._head(feats, coords), dim=-1)
            return probs.cpu().numpy()[0]

    def _attention_from_feats(self, feats: torch.Tensor, n_tiles: int,
                              coords=None) -> tuple[np.ndarray, np.ndarray]:
        with profiling.span("slide.head"), torch.inference_mode():
            logits, attn = self._head(feats, coords, return_attn=True)
            probs = torch.softmax(logits, dim=-1).cpu().numpy()[0]
            # TransMIL-family heads return a payload with tile_scores()
            # (B, heads, n); gated heads return the (B, n) weights directly
            if attn is None:
                raise ValueError(f"the {type(self.head).__name__} head gives no attention "
                                 "scores")
            raw = attn.tile_scores() if hasattr(attn, "tile_scores") else attn
            if raw.numel() % n_tiles != 0:
                raise ValueError(
                    f"head attention shape {tuple(raw.shape)} is not a multiple of the "
                    f"tile count {n_tiles}; heads must return per-tile scores with a "
                    f"trailing length equal to the (unpadded) tile count"
                )
            scores = raw.reshape(1, -1, n_tiles).mean(dim=1)[0]
        return probs, scores.cpu().numpy()
