"""Flax-layout TransMIL params -> the port's ``state_dict`` (the inverse of the
JAX package's ``utils/torch_weights.convert_transmil_state_dict``).

The flax tree arrives as nested dicts of numpy arrays (``params["layer1"]
["attn"]["to_qkv"]["kernel"]``), e.g. from :func:`unflatten` of an ``.npz``
written with :func:`flatten`. Dense kernels (in, out) are transposed to torch
(out, in); ``res_conv`` (33, heads) becomes (heads, 1, 33, 1); the PPEG
kernels (k, k, 1, C) become (C, 1, k, k).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, f"{path}/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten(flat: Mapping[str, Any]) -> dict:
    """``{"a/b/c": array}`` -> nested dicts."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _fc1_layout(in_features: int) -> dict[str, str]:
    """flax fc1 module name -> index in the reference's ``_fc1`` Sequential."""
    if in_features == 2048:
        return {"fc1_0": "0", "fc1_norm0": "2", "fc1_1": "3"}
    if in_features in (1024, 768):
        return {"fc1_0": "0", "fc1_norm0": "3", "fc1_1": "4", "fc1_norm1": "7"}
    return {"fc1_0": "0"}


def state_dict_from_jax(params: Mapping[str, Any], in_features: int) -> dict[str, torch.Tensor]:
    """Flax TransMIL ``params`` -> the port's TransMIL ``state_dict`` (CPU
    float32 tensors)."""
    sd: dict[str, np.ndarray] = {}

    def dense(dst: str, p: Mapping[str, Any]) -> None:
        sd[f"{dst}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            sd[f"{dst}.bias"] = np.asarray(p["bias"])

    def norm(dst: str, p: Mapping[str, Any]) -> None:
        sd[f"{dst}.weight"] = np.asarray(p["scale"])
        sd[f"{dst}.bias"] = np.asarray(p["bias"])

    for name, idx in _fc1_layout(in_features).items():
        (norm if "norm" in name else dense)(f"_fc1.{idx}", params[name])
    sd["cls_token"] = np.asarray(params["cls_token"])
    for layer in ("layer1", "layer2"):
        p = params[layer]
        norm(f"{layer}.norm", p["norm"])
        sd[f"{layer}.attn.to_qkv.weight"] = np.asarray(p["attn"]["to_qkv"]["kernel"]).T
        dense(f"{layer}.attn.to_out.0", p["attn"]["to_out"])
        sd[f"{layer}.attn.res_conv.weight"] = np.asarray(p["attn"]["res_conv"]).T[:, None, :, None]
    for name in ("proj", "proj1", "proj2"):
        pos = params["pos_layer"]
        sd[f"pos_layer.{name}.weight"] = np.asarray(pos[name]).transpose(3, 2, 0, 1)
        sd[f"pos_layer.{name}.bias"] = np.asarray(pos[f"{name}_bias"])
    norm("norm", params["norm"])
    dense("_fc", params["fc"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}
