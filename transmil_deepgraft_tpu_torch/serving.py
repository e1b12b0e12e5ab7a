"""Serving bundles and cross-request micro-batching (port of ``serving.py``).

A bundle is one zip file holding ``meta.json`` and ``params.npz``, the
flax-layout parameters flattened to ``"a/b/c"`` keys (:mod:`utils.jax_params`),
so one set of trained weights serves from either package. :meth:`ServingBundle.load`
also reads the bundles the JAX package exports (``variables.msgpack``, read by
:mod:`utils.flax_msgpack`): it rebuilds the head (and a slide bundle's
backbone) from the weights and never reads their ``exported/*.jexp``
programs.

    export_serving_bundle(params, "head.tdx", model_name="TransMIL",
                          in_features=2048, n_classes=2)
    bundle = ServingBundle.load("head.tdx")          # on the card
    probs = bundle.predict(features)                 # (n, D) -> (1, C)

Every ported bag head serves (TransMIL, TransformerMIL, AttMIL, Chowder,
RoFormerMIL, AttTrans/MonaiMILModel, CLAM_SB/MB, DTFD, MDMIL, DSMIL; the
logits of DTFD's slide prediction, of MDMIL without its attention row, as
JAX's ``_eval_forward`` takes them), and so do CTMIL and ``resnet50``, as
JAX's bundles serve them: a bag is lifted to a 1 x n grid, and their
BatchNorm statistics travel beside the params. The meta names
the head, whether it is coord-aware, and its knobs (``knobs``:
RoFormerMIL's ``num_landmarks``, MONAI's ``mil_mode``, ...); the widths and
depths come from the weights, and a JAX bundle (whose meta has no knobs) gets the heads' defaults for the
knobs its weights do not show (a MONAI 'mean' or 'max' head, whose weights
are the same, needs its ``mil_mode``). A coord-aware bundle takes
``coords``, the tiles' (n, 2) grid positions, normalized and zero-padded
with the bag (``data/coords.normalize_pad_coords``), or the square grid of
the padded length when there are none; the other bundles refuse coords, as
JAX's do.

Bags are zero-padded to the next bucket length, as the JAX bundles' bucketed
mode (and the trainer's ``eval_pad='bucket'`` policy) do, so each bucket is
one shape. The pad is made on the device: only the real rows cross from the
host (padding a 40,960-tile bag to 65,536 rows in numpy cost more than the
forward).

A slide bundle (:func:`export_slide_bundle`, ``meta["kind"] == "slide"``)
also holds the tile backbone, the int8 ResNet50 (``backbone: "int8"``) or the
float ResNet50 run in bf16, as the flat leaf list the JAX package writes
(``backbone_leaves``): ``predict_slide(tiles)`` embeds raw tiles in chunks on
the device and runs the head on the bag.
"""

from __future__ import annotations

import bisect
import io
import json
import time
import zipfile
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.data.coords import grid_coords, normalize_pad_coords
from transmil_deepgraft_tpu_torch.data.tiles import IMAGENET_MEAN, IMAGENET_STD
from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models import (
    MODEL_REGISTRY, SPATIAL_HEADS, create_model, head_logits)
from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
    EXPANSION, PLANES, QBlock, QResNet50, _block_plan)
from transmil_deepgraft_tpu_torch.utils.flax_msgpack import read_flax_msgpack
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    flatten, head_knobs_from_params, head_state_dict_from_jax, unflatten)
from transmil_deepgraft_tpu_torch.utils.profiling import span

FORMAT_VERSION = 1
# bounds (seconds) of the serving daemon's latency histograms: each
# request's, and each bag's wait in the MicroBatcher's queue
LATENCY_BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0)

# Serving buckets default to the mid-range of ops.padding.DEFAULT_BUCKETS.
DEFAULT_SERVING_BUCKETS: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
# Slide bundles serve whole slides, so their head buckets reach the tile
# counts of large slides (a 40,960-tile slide pads to 65,536).
SLIDE_SERVING_BUCKETS: tuple[int, ...] = DEFAULT_SERVING_BUCKETS + (32768, 65536)


def classifier_shape(model_name: str, params: Mapping[str, Any]) -> tuple[int, int]:
    """(width, n_classes) of a head's flax-layout ``params``, read from its
    ``flax_classifier``: one (width, n_classes) kernel, or one (width, 1)
    kernel a class (``classifier_{}``, CLAM_MB's)."""
    classifier = MODEL_REGISTRY[model_name].flax_classifier
    first = classifier.format(0)
    if first not in params:
        raise ValueError(f"the params hold no {model_name} head (no {first!r}; "
                         f"top-level keys {sorted(params)[:8]})")
    width, n_classes = np.shape(params[first]["kernel"])
    if "{}" in classifier:
        n_classes = sum(1 for k in params if k.startswith(classifier.format("")))
    return int(width), int(n_classes)


def head_from_params(model_name: str, params: Mapping[str, Any], in_features: int,
                     knobs: Mapping[str, Any] | None = None,
                     device: str | torch.device | None = None) -> torch.nn.Module:
    """A ported head with its flax-layout ``params``, in eval mode on
    ``device`` (None = CUDA): n_classes and the widths and depths from the
    weights, the other knobs from ``knobs`` or the head's defaults. A
    BatchNorm head's running statistics (CTMIL, ``resnet50``) are under
    ``params['batch_stats']``, as a flax variables tree holds them beside
    its ``params``.

    The spatial heads serve as JAX's bundles serve them: a (B, n, D) bag is
    lifted to one (1, B, n, D) grid (``models/ctmil.py``, as JAX's
    ``models/ctmil.py:35-36``), so a batch-1 bag is a 1 x n strip."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"the port serves the heads {sorted(MODEL_REGISTRY)}, not "
                         f"{model_name!r}")
    stats = params.get("batch_stats")
    params = {k: v for k, v in params.items() if k != "batch_stats"}
    if model_name in SPATIAL_HEADS and stats is None:
        raise ValueError(f"a {model_name} bundle needs its BatchNorm statistics "
                         "('batch_stats' beside the params)")
    width, n_classes = classifier_shape(model_name, params)
    model = create_model(model_name, int(n_classes), in_features, int(width), device=device,
                         **head_knobs_from_params(model_name, params, knobs))
    model.load_state_dict(head_state_dict_from_jax(model_name, params, in_features, stats))
    return model.eval()


def _head_meta(model_name: str, params: Mapping[str, Any], in_features: int, n_classes: int,
               knobs: Mapping[str, Any] | None) -> dict:
    """The head's part of a bundle's meta, checked by building the head from
    ``params`` on the CPU."""
    model = head_from_params(model_name, params, in_features, knobs, device="cpu")
    classes = classifier_shape(model_name, params)[1]
    if classes != n_classes:
        raise ValueError(f"n_classes={n_classes} but the {model_name} weights give {classes}")
    return {"model_name": model_name, "in_features": int(in_features),
            "n_classes": int(n_classes), "attention": bool(model.gives_attention),
            "coord_aware": bool(getattr(model, "coord_aware", False)),
            "knobs": dict(knobs or {})}


def export_serving_bundle(
    params: Mapping[str, Any],
    path: str | Path,
    *,
    model_name: str,
    in_features: int,
    n_classes: int,
    batch: int = 1,
    buckets: Sequence[int] = DEFAULT_SERVING_BUCKETS,
    knobs: Mapping[str, Any] | None = None,
) -> dict:
    """Write a ``.tdx`` bundle from a ported head's flax-layout ``params``
    and its constructor ``knobs`` (those the weights do not show); returns
    its meta."""
    meta = {
        "format_version": FORMAT_VERSION,
        **_head_meta(model_name, params, in_features, n_classes, knobs),
        "batch": int(batch),
        "mode": "bucketed",
        "buckets": sorted(int(b) for b in buckets),
    }
    _write_bundle(path, meta, flatten(params))
    return meta


def _write_bundle(path: str | Path, meta: dict, arrays: Mapping[str, np.ndarray]) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        # float weights deflate by a few percent at ~70 ms a MB: stored as they are
        z.writestr("params.npz", buf.getvalue(), compress_type=zipfile.ZIP_STORED)


# ------------------------------------------------------- backbone leaves
#
# A slide bundle holds its backbone as the flat leaf list of
# ``jax.tree.flatten`` over the JAX package's backbone tree, in its order, so
# one routine rebuilds the backbone from either package's bundle. int8: the
# fields of ``QResNet50`` (the stem's four, each ``QBlock``'s twelve with the
# downsample's two only where the block has one, ``final_scale``); the depth
# and feature width are not leaves and follow from the leaf count and the
# last block's conv3. bf16: the leaves of the float ResNet50's
# ``{'batch_stats', 'params'}`` tree in sorted-key order, as JAX sorts dict
# keys; the JAX package stores them in bfloat16, the port in float32, and
# both run in bfloat16.

def _qresnet_leaf_specs(truncate_after: int) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of each int8 backbone leaf, in leaf order."""
    i8, f32 = torch.int8, torch.float32
    specs = [("stem_w", (4, 4, 12, 64), i8), ("stem_m", (64,), f32), ("stem_z", (64,), f32),
             ("input_scale", (), f32)]
    cin = 64
    for name, _, has_ds in _block_plan(truncate_after):
        mid = PLANES[int(name[5]) - 1]
        cout = mid * EXPANSION
        shapes = {"w1": ((1, 1, cin, mid), i8), "m1": ((mid,), f32), "z1": ((mid,), f32),
                  "w2": ((3, 3, mid, mid), i8), "m2": ((mid,), f32), "z2": ((mid,), f32),
                  "w3": ((1, 1, mid, cout), i8), "m3": ((cout,), f32), "z3": ((cout,), f32),
                  "wd": ((1, 1, cin, cout), i8), "md": ((cout,), f32), "id_mult": ((), f32)}
        for field in QBlock._fields:
            if field in ("wd", "md") and not has_ds:
                continue
            specs.append((f"{name}.{field}", *shapes[field]))
        cin = cout
    specs.append(("final_scale", (), f32))
    return specs


def _resnet_leaf_paths(truncate_after: int) -> list[tuple[str, ...]]:
    """The flax paths of the float ResNet50's leaves, in JAX's leaf order."""
    from transmil_deepgraft_tpu_torch.models.resnet import resnet50

    fields = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    paths = []
    for key, value in resnet50(truncate_after).state_dict().items():
        *modules, field = key.split(".")
        if field == "num_batches_tracked":
            continue
        if value.dim() == 4:  # a conv's weight
            paths.append(("params", *modules, "kernel"))
        else:
            top, leaf = fields[field]
            paths.append((top, *modules, leaf))
    return sorted(paths)


def _depth_from_leaves(count: int, lengths: Mapping[int, int], what: str) -> int:
    for depth, n in lengths.items():
        if n == count:
            return depth
    raise ValueError(f"{count} {what} backbone leaves match no ResNet50 depth "
                     f"(expected one of {sorted(lengths.values())})")


def qresnet_leaves(q: QResNet50) -> list[np.ndarray]:
    """The int8 backbone's leaves (numpy, on the host) in JAX's order."""
    leaves = [q.stem_w, q.stem_m, q.stem_z, q.input_scale]
    for blk in q.blocks:
        leaves += [t for t in blk if t is not None]
    leaves.append(q.final_scale)
    return [t.cpu().numpy() for t in leaves]


def qresnet_from_leaves(leaves, device: torch.device) -> QResNet50:
    """An int8 backbone from its leaves (either package's), bit for bit;
    every leaf's shape and dtype is checked."""
    depth = _depth_from_leaves(len(leaves), {t: len(_qresnet_leaf_specs(t)) for t in (1, 2, 3, 4)},
                               "int8")
    tensors = []
    for (name, shape, dtype), leaf in zip(_qresnet_leaf_specs(depth), leaves):
        t = torch.from_numpy(np.array(leaf))
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"int8 backbone leaf {name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        tensors.append(t)
    it = iter(tensors)
    stem = [next(it) for _ in range(4)]
    blocks = []
    for _, _, has_ds in _block_plan(depth):
        fields = {f: (next(it) if has_ds or f not in ("wd", "md") else None)
                  for f in QBlock._fields}
        blocks.append(QBlock(**fields))
    final_scale = next(it)
    return QResNet50(*stem, blocks=tuple(blocks), final_scale=final_scale,
                     truncate_after=depth,
                     feature_dim=int(blocks[-1].w3.shape[-1])).to(device)


def resnet_leaves(variables: Mapping[str, Any], truncate_after: int) -> list[np.ndarray]:
    """The float ResNet50's leaves (float32 numpy) in JAX's order."""
    out = []
    for path in _resnet_leaf_paths(truncate_after):
        node = variables
        for key in path:
            node = node[key]
        out.append(np.asarray(node, np.float32))
    return out


def resnet_from_leaves(leaves, device: torch.device):
    """The float ResNet50 from its leaves (either package's: bfloat16 or
    float32), in bfloat16 on ``device``."""
    from transmil_deepgraft_tpu_torch.models.resnet import resnet50
    from transmil_deepgraft_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

    depth = _depth_from_leaves(len(leaves), {t: len(_resnet_leaf_paths(t)) for t in (1, 2, 3, 4)},
                               "bf16")
    tree: dict = {}
    for path, leaf in zip(_resnet_leaf_paths(depth), leaves):
        value = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.issubdtype(value.dtype, np.floating):
            raise ValueError(f"bf16 backbone leaf {'/'.join(path)} is {value.dtype}, not a float")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    model = resnet50(depth)
    model.load_state_dict(resnet_state_dict_from_jax(tree))
    return model.to(device, torch.bfloat16).eval()


def export_slide_bundle(
    backbone_variables: Mapping[str, Any],
    head_params: Mapping[str, Any],
    path: str | Path,
    *,
    model_name: str,
    in_features: int,
    n_classes: int,
    calib_tiles: np.ndarray | None = None,
    chunk: int = 128,
    tile_hw: int = 224,
    truncate_after: int = 4,
    head_buckets: Sequence[int] = SLIDE_SERVING_BUCKETS,
    device: str | torch.device | None = None,
    knobs: Mapping[str, Any] | None = None,
) -> dict:
    """Write a ``.tdx`` bundle that serves the whole pipeline, raw tiles ->
    slide probabilities (:meth:`ServingBundle.predict_slide`); returns its
    meta.

    ``backbone_variables``: the float ResNet50 ``{'params', 'batch_stats'}``
    in flax layout (numpy). With ``calib_tiles`` the backbone is the int8
    ResNet50 calibrated on them on ``device`` (None = CUDA), else the float
    one, served in bf16. ``head_params``: the head's flax-layout params,
    ``knobs`` its constructor knobs. The backbone's feature width is checked
    against ``in_features`` before the build."""
    last = [name for name, _, _ in _block_plan(truncate_after)][-1]
    feature_dim = int(np.shape(backbone_variables["params"][last]["conv3"]["kernel"])[-1])
    if feature_dim != in_features:
        raise ValueError(f"backbone produces {feature_dim}-d features but the head expects "
                         f"in_features={in_features}")
    head = _head_meta(model_name, head_params, in_features, n_classes, knobs)
    if calib_tiles is not None:
        from transmil_deepgraft_tpu_torch.models.resnet_int8 import build_qresnet50

        q = build_qresnet50(backbone_variables, calib_tiles, truncate_after=truncate_after,
                            device=device)
        leaves, precision = qresnet_leaves(q), "int8"
    else:
        leaves, precision = resnet_leaves(backbone_variables, truncate_after), "bf16"
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "slide",
        **head,
        "batch": 1,
        "mode": "bucketed",
        "buckets": sorted(int(b) for b in head_buckets),
        "chunk": int(chunk),
        "tile_hw": int(tile_hw),
        "backbone": precision,
        "truncate_after": int(truncate_after),
    }
    arrays = {f"backbone_leaves/{i:03d}": leaf for i, leaf in enumerate(leaves)}
    arrays.update(flatten({"head": {"params": head_params}}))
    _write_bundle(path, meta, arrays)
    return meta


def _refuse_coords(coords, what: str = "bundle's") -> None:
    if coords is not None:
        raise ValueError(
            f"this {what} head is not coord-aware; re-export from a "
            "coord-aware head (e.g. RoFormerMIL) to use coords"
        )


class ServingBundle:
    """A loaded bundle: ``predict(feats)`` on one device, and for a slide
    bundle ``predict_slide(tiles)``. The weights are staged on the device
    once, at load."""

    def __init__(self, meta: dict, params: Mapping[str, Any],
                 device: str | torch.device | None = None, backbone_leaves=None) -> None:
        """``params``: the head's flax-layout params; ``backbone_leaves``: a
        slide bundle's backbone leaves."""
        self.meta = meta
        self.device = resolve_device(device)
        self.model = head_from_params(meta["model_name"], params, meta["in_features"],
                                      meta.get("knobs"), device=self.device)
        self.coord_aware = bool(getattr(self.model, "coord_aware", False))
        if self.coord_aware != bool(meta.get("coord_aware")):
            raise ValueError(f"meta says coord_aware={meta.get('coord_aware')}, but the "
                             f"{meta['model_name']} head is {'' if self.coord_aware else 'not '}"
                             "coord-aware")
        if meta.get("kind") == "slide":
            if meta["backbone"] == "int8":
                from transmil_deepgraft_tpu_torch.models.resnet_int8 import apply_qresnet50

                self._q = qresnet_from_leaves(backbone_leaves, self.device)
                self._embed_core = lambda x: apply_qresnet50(self._q, x)
            else:
                backbone = resnet_from_leaves(backbone_leaves, self.device)
                self._embed_core = lambda x: backbone(x.to(torch.bfloat16)).float()
            self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
            self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device | None = None) -> "ServingBundle":
        """Load a bundle of either package: the port's ``params.npz`` or the
        JAX package's ``variables.msgpack`` (its ``batch_stats`` go to a
        BatchNorm head; ``n_classes`` comes from the head's weights when the
        meta has none). A slide bundle's backbone is rebuilt
        from its leaves; ``device`` None means CUDA."""
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"bundle format {meta['format_version']} is newer than "
                    f"this loader ({FORMAT_VERSION})"
                )
            names = z.namelist()
            if "params.npz" in names:
                with np.load(io.BytesIO(z.read("params.npz"))) as npz:
                    tree = unflatten({k: npz[k] for k in npz.files})
                if "backbone_leaves" in tree:
                    leaves = tree["backbone_leaves"]
                    tree["backbone_leaves"] = [leaves[k] for k in sorted(leaves)]
            elif "variables.msgpack" in names:
                tree = read_flax_msgpack(z.read("variables.msgpack"))
            else:
                raise ValueError(f"{path} holds neither params.npz (a bundle of the port) nor "
                                 "variables.msgpack (a bundle of the JAX package)")
        if meta.get("kind") == "slide":
            params, leaves = tree["head"]["params"], tree["backbone_leaves"]
        elif "params.npz" in names:  # the port writes a head's params (and batch_stats)
            params, leaves = tree, None
        else:  # JAX writes its variables
            params, leaves = tree["params"], None
            if tree.get("batch_stats"):
                params = {**params, "batch_stats": tree["batch_stats"]}
        if meta["model_name"] in MODEL_REGISTRY:
            meta.setdefault("n_classes", classifier_shape(meta["model_name"], params)[1])
        return cls(meta, params, device, leaves)

    def _pad_target(self, n: int) -> int:
        for b in self.meta["buckets"]:
            if n <= b:
                return b
        raise ValueError(
            f"bag of {n} tiles exceeds the largest exported bucket "
            f"({self.meta['buckets'][-1]}); re-export with larger buckets"
        )

    def _prepare_one(self, feats: np.ndarray) -> tuple[int, int, np.ndarray]:
        """The single-bag input contract shared by the batched predict and
        :class:`MicroBatcher`: validate dims and pick the serving bucket.
        Returns ``(n_real, target, (n_real, D) float32 feats)``; the zero pad
        to ``target`` rows is made on the device by :meth:`_device_bags`."""
        feats = np.ascontiguousarray(feats, np.float32)
        if feats.ndim != 2:
            raise ValueError(f"each bag must be (n, D), got {feats.shape}")
        n, d = feats.shape
        if d != self.meta["in_features"]:
            raise ValueError(f"expected in_features={self.meta['in_features']}, got {d}")
        return n, self._pad_target(n), feats

    def _bag_coords(self, coords, n: int, target: int, what: str = "bundle's"):
        """A bag's head-input coords (JAX ``serving.py:452-490``): for a
        coord-aware head, the (n, 2) coords normalized and zero-padded to
        ``target`` rows, or the square grid of ``target`` when there are
        none; for the other heads None, and coords are refused."""
        if not self.coord_aware:
            _refuse_coords(coords, what)
            return None
        if coords is None:
            return grid_coords(target, 1)[0]
        coords = np.asarray(coords, np.float32)
        if coords.shape != (n, 2):
            raise ValueError(f"coords must be ({n}, 2), got {coords.shape}")
        return normalize_pad_coords(coords, target)

    def _prepare_inputs(self, feats: np.ndarray, coords=None):
        """Validate a (n, D) or (B, n, D) request (with (n, 2) or (B, n, 2)
        coords); returns (n_real, target, B bags, B coords or None)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
            coords = None if coords is None else np.asarray(coords)[None]
        if feats.ndim != 3:
            raise ValueError(f"features must be (n, D) or (B, n, D), got {feats.shape}")
        if feats.shape[0] != self.meta["batch"]:
            raise ValueError(f"bundle exported for batch={self.meta['batch']}, got {feats.shape[0]}")
        n, target, _ = self._prepare_one(feats[0])
        bag_coords = [self._bag_coords(None if coords is None else coords[i], n, target)
                      for i in range(len(feats))]
        return n, target, list(feats), None if bag_coords[0] is None else bag_coords

    def _device_bags(self, bags: Sequence[np.ndarray], target: int, batch: int) -> torch.Tensor:
        """(batch, target, D) zeros on the device holding ``bags`` in its
        first rows: the bucket zero pad, with only real rows copied over.
        Rows past ``len(bags)`` stay zero bags."""
        x = torch.zeros((batch, target, self.meta["in_features"]), dtype=torch.float32,
                        device=self.device)
        for i, bag in enumerate(bags):
            x[i, :len(bag)] = torch.from_numpy(bag)
        return x

    def _device_coords(self, coords, target: int, batch: int) -> torch.Tensor | None:
        """(batch, target, 2) padded coords on the device (zero rows for the
        batch's filler bags), or None for a head that takes none."""
        if coords is None:
            return None
        c = np.zeros((batch, target, 2), np.float32)
        c[:len(coords)] = np.stack(coords)
        return torch.from_numpy(c).to(self.device)

    def _forward(self, x: torch.Tensor, c: torch.Tensor | None, **kw):
        """The head's logits, or with ``return_attn=True`` its (logits,
        attention)."""
        args = (x,) if c is None else (x, c)
        return self.model(*args, **kw) if kw else head_logits(self.model, *args)

    def _logits(self, bags: Sequence[np.ndarray], target: int, batch: int,
                coords=None) -> np.ndarray:
        """Bags of at most ``target`` rows (and their padded coords) ->
        (batch, C) logits."""
        with torch.inference_mode():
            return self._forward(self._device_bags(bags, target, batch),
                                 self._device_coords(coords, target, batch)).cpu().numpy()

    def predict_logits(self, feats: np.ndarray, coords=None) -> np.ndarray:
        """(n, D) or (B, n, D) float32 features (with the tiles' (n, 2) grid
        coords for a coord-aware head) -> (B, C) logits."""
        _, target, bags, bag_coords = self._prepare_inputs(feats, coords)
        return self._logits(bags, target, len(bags), bag_coords)

    def predict(self, feats: np.ndarray, coords=None) -> np.ndarray:
        """(n, D) or (B, n, D) features -> (B, C) class probabilities."""
        return _softmax(self.predict_logits(feats, coords))

    def predict_logits_with_attention(self, feats: np.ndarray,
                                      coords=None) -> tuple[np.ndarray, np.ndarray]:
        """(n, D) or (B, n, D) features -> ((B, C) logits, (B, n) per-tile
        attention scores): heads averaged, padding scores stripped."""
        n, target, bags, bag_coords = self._prepare_inputs(feats, coords)
        return self._attention_logits(self._device_bags(bags, target, len(bags)), n,
                                      self._device_coords(bag_coords, target, len(bags)))

    def _attention_logits(self, x: torch.Tensor, n: int,
                          c: torch.Tensor | None = None) -> tuple[np.ndarray, np.ndarray]:
        """The head's ``return_attn`` forward on the padded device bags ``x``
        -> (logits, scores of the first n tiles): a payload's
        ``tile_scores()`` or the raw weights, any axis between the batch and
        the tiles averaged (JAX ``_attn_forward``)."""
        if not self.meta.get("attention"):
            raise ValueError("bundle exported without attention; re-export with attention=True")
        with torch.inference_mode():
            logits, attn = self._forward(x, c, return_attn=True)
            raw = attn.tile_scores() if hasattr(attn, "tile_scores") else attn
            scores = raw.reshape(x.shape[0], -1, x.shape[1]).mean(dim=1)
            return logits.cpu().numpy(), scores[:, :n].cpu().numpy()

    # ------------------------------------------------------- slide bundles
    def embed_tiles(self, tiles: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) float32 (normalized) or uint8 (raw) tiles -> (N, D)
        float32 features left on the device: the backbone in fixed chunks,
        the last one zero-padded, features concatenated on the device."""
        if self.meta.get("kind") != "slide":
            raise ValueError("not a slide bundle: export with export_slide_bundle")
        from transmil_deepgraft_tpu_torch.inference import chunked_device_embed, embed_chunk

        hw = int(self.meta["tile_hw"])
        tiles = np.asarray(tiles)
        if np.issubdtype(tiles.dtype, np.integer) and tiles.dtype != np.uint8:
            # raw pixels sent as wider integers (JSON) take the uint8 path;
            # read as float32 they would be taken for normalized tiles
            if tiles.size and (tiles.min() < 0 or tiles.max() > 255):
                raise ValueError(
                    "integer tiles must be raw pixels in [0, 255] (uint8 "
                    "path); send float32 for pre-normalized tiles"
                )
            tiles = tiles.astype(np.uint8)
        elif tiles.dtype != np.uint8:
            tiles = tiles.astype(np.float32, copy=False)
        if tiles.ndim != 4 or tiles.shape[1:] != (hw, hw, 3):
            raise ValueError(f"expected tiles (N, {hw}, {hw}, 3), got {tiles.shape}")
        return chunked_device_embed(
            lambda batch: embed_chunk(self._embed_core, batch, self._mean, self._std),
            tiles, int(self.meta["chunk"]))

    def _slide_bag(self, tiles: np.ndarray, coords):
        """(n, the (1, bucket, D) bag on the device, its (1, bucket, 2)
        coords or None): the bucket is chosen before the embed, so a slide
        beyond the largest bucket fails at once; the zero pad is made on the
        device."""
        n = int(np.shape(tiles)[0])
        target = self._pad_target(n)
        c = self._bag_coords(coords, n, target, "slide bundle's")
        feats = self.embed_tiles(tiles)
        return (n, torch.nn.functional.pad(feats, (0, 0, 0, target - n))[None],
                self._device_coords(None if c is None else [c], target, 1))

    def predict_slide_logits(self, tiles: np.ndarray, coords=None) -> np.ndarray:
        """(N, H, W, 3) tiles (float32 normalized or uint8 raw), with their
        (N, 2) grid coords for a coord-aware head -> (C,) slide logits."""
        _, x, c = self._slide_bag(tiles, coords)
        with torch.inference_mode():
            return self._forward(x, c).cpu().numpy()[0]

    def predict_slide(self, tiles: np.ndarray, coords=None) -> np.ndarray:
        """(N, H, W, 3) tiles -> (C,) slide class probabilities."""
        return _softmax(self.predict_slide_logits(tiles, coords))

    def predict_slide_logits_with_attention(self, tiles: np.ndarray,
                                            coords=None) -> tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) tiles -> ((C,) logits, (N,) per-tile attention scores)."""
        n, x, c = self._slide_bag(tiles, coords)
        logits, scores = self._attention_logits(x, n, c)
        return logits[0], scores[0]

    def predict_slide_with_attention(self, tiles: np.ndarray,
                                     coords=None) -> tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) tiles -> ((C,) probs, (N,) per-tile attention
        scores), for heatmaps and top-k tiles from the bundle alone."""
        logits, scores = self.predict_slide_logits_with_attention(tiles, coords)
        return _softmax(logits), scores


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


class QueueFullError(RuntimeError):
    """MicroBatcher admission control: the pending-request queue is at its
    bound; the caller should shed (HTTP 503 + Retry-After) rather than let
    latency grow without limit."""

    def __init__(self, depth: int, max_queue: int, retry_after_s: float) -> None:
        super().__init__(
            f"serving queue full ({depth}/{max_queue} pending); retry in "
            f"~{retry_after_s:.1f}s"
        )
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class MicroBatcher:
    """Cross-request micro-batching for a :class:`ServingBundle`.

    One dispatcher thread owns the device; request threads validate and
    bucket-pad their own bags, enqueue them and block on a future. The
    dispatcher coalesces up to ``meta['batch']`` queued bags OF THE SAME
    BUCKET into one forward, waiting at most ``max_wait_ms`` for stragglers
    once the first bag is in hand. Bags for other buckets wait for the next
    dispatch. At ``max_queue`` admitted-but-unanswered requests, new ones are
    shed with :class:`QueueFullError`.

    :meth:`stats` counts, from the start: each request's queue wait (its
    enqueue to the start of its dispatch, once that has the device) in
    :data:`LATENCY_BUCKETS`, the bags a dispatch, and the requests shed.
    """

    _CLOSE = object()

    def __init__(self, bundle: ServingBundle, max_wait_ms: float = 2.0,
                 device_lock=None, max_queue: int = 128) -> None:
        import queue as _queue
        import threading

        self.bundle = bundle
        self.eb = int(bundle.meta.get("batch", 1))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self._depth = 0
        self._depth_lock = threading.Lock()  # also guards the counters below
        self._wait_counts = [0] * (len(LATENCY_BUCKETS) + 1)  # the last: beyond them
        self._wait_s = 0.0
        self._dispatches = self._bags = self._shed = 0
        self._q: "_queue.Queue" = _queue.Queue()
        self._queue_mod = _queue
        # serializes device use with other device users; held per dispatch
        self._device_lock = device_lock or threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet answered (queued + in dispatch)."""
        with self._depth_lock:
            return self._depth

    def stats(self) -> dict:
        """``wait_counts`` (per bucket of :data:`LATENCY_BUCKETS`, then beyond),
        ``wait_s`` (their sum), ``dispatches``, ``bags`` and ``shed``."""
        with self._depth_lock:
            return {"wait_counts": list(self._wait_counts), "wait_s": self._wait_s,
                    "dispatches": self._dispatches, "bags": self._bags, "shed": self._shed}

    def _count_dispatch(self, group: list, start: float) -> None:
        """Each bag's queue wait (its enqueue stamp to ``start``, when the
        dispatch has the device) and the dispatch's bags."""
        with self._depth_lock:
            for g in group:
                wait = start - g[3]
                self._wait_counts[bisect.bisect_left(LATENCY_BUCKETS, wait)] += 1
                self._wait_s += wait
            self._dispatches += 1
            self._bags += len(group)

    def _release(self, k: int = 1) -> None:
        with self._depth_lock:
            self._depth -= k

    def predict_logits(self, feats: np.ndarray, coords=None) -> np.ndarray:
        """(n, D) / (B, n, D) features, with (n, 2) / (B, n, 2) coords for a
        coord-aware bundle -> (B, C) logits (B bags enqueue as B independent
        micro-batchable requests)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
            coords = None if coords is None else np.asarray(coords)[None]
        if feats.ndim != 3:
            raise ValueError(f"features must be (n, D) or (B, n, D), got {feats.shape}")
        futures = [self._enqueue(f, None if coords is None else coords[i])
                   for i, f in enumerate(feats)]
        return np.stack([f.result() for f in futures])

    def predict(self, feats: np.ndarray, coords=None) -> np.ndarray:
        return _softmax(self.predict_logits(feats, coords))

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5)

    def _enqueue(self, feats: np.ndarray, coords=None):
        """Admission-check, then validate on the request thread; returns a
        Future."""
        from concurrent.futures import Future

        with self._depth_lock:
            if self._depth >= self.max_queue:
                self._shed += 1
                raise QueueFullError(
                    self._depth, self.max_queue,
                    retry_after_s=max(1.0, self._depth * self.max_wait_s),
                )
            self._depth += 1
        try:
            n, target, feats = self.bundle._prepare_one(feats)
            coords = self.bundle._bag_coords(coords, n, target)
        except BaseException:
            self._release()
            raise
        fut: Future = Future()
        self._q.put((target, feats, coords, time.perf_counter(), fut))
        return fut

    def _run(self) -> None:
        from collections import deque

        pending: deque = deque()

        def shutdown(final_group=None):
            """Dispatch what is in hand, then fail every undelivered future."""
            if final_group:
                self._dispatch(final_group)
            leftovers = list(pending)
            while True:
                try:
                    it = self._q.get_nowait()
                except self._queue_mod.Empty:
                    break
                if it is not self._CLOSE:
                    leftovers.append(it)
            for it in leftovers:
                fut = it[-1]
                if not fut.done():
                    fut.set_exception(RuntimeError("MicroBatcher closed before dispatch"))
            self._release(len(leftovers))

        while True:
            item = pending.popleft() if pending else self._q.get()
            if item is self._CLOSE:
                shutdown()
                return
            key = item[0]
            group = [item]
            for other in list(pending):  # compatible bags already deferred, oldest first
                if len(group) >= self.eb:
                    break
                if other[0] == key:
                    pending.remove(other)
                    group.append(other)
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.eb:  # then stragglers on the live queue
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except self._queue_mod.Empty:
                    break
                if nxt is self._CLOSE:
                    shutdown(final_group=group)
                    return
                if nxt[0] == key and len(group) < self.eb:
                    group.append(nxt)
                else:
                    pending.append(nxt)
            self._dispatch(group)

    def _dispatch(self, group: list) -> None:
        try:
            coords = None if group[0][2] is None else [g[2] for g in group]
            with self._device_lock:
                self._count_dispatch(group, time.perf_counter())
                with span("serve.dispatch"):  # the batch is filled with zero bags
                    logits = self.bundle._logits([g[1] for g in group], group[0][0], self.eb,
                                                 coords)
            for i, (*_, fut) in enumerate(group):
                fut.set_result(logits[i])
        except Exception as e:  # noqa: BLE001 - deliver to every waiter
            for *_, fut in group:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._release(len(group))
