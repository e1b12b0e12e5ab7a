"""Flax-layout weights -> the port's models.

TransMIL (:func:`state_dict_from_jax`, the inverse of the JAX package's
``utils/torch_weights.convert_transmil_state_dict``): the flax tree arrives as
nested dicts of numpy arrays (``params["layer1"]["attn"]["to_qkv"]["kernel"]``),
e.g. from :func:`unflatten` of an ``.npz`` written with :func:`flatten`. Dense
kernels (in, out) are transposed to torch (out, in); ``res_conv`` (33, heads)
becomes (heads, 1, 33, 1); the PPEG kernels (k, k, 1, C) become (C, 1, k, k).

ResNet (:func:`resnet_state_dict_from_jax`) and the int8 ResNet50
(:func:`qresnet_from_jax`) likewise. :func:`optimizer_state_from_jax` carries
the optax state of ``create_optimizer`` (moments, slow weights, counters, the
gradient accumulator and the plateau scale) onto the port's optimizer.
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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ResNet ``{'params', 'batch_stats'}`` (numpy leaves) -> the port's
    ``models/resnet.ResNet`` ``state_dict``: HWIO conv kernels become OIHW,
    BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, np.ndarray] = {}

    def walk(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str) -> None:
        for name, sub in p.items():
            key = f"{prefix}{name}"
            if "kernel" in sub:
                sd[f"{key}.weight"] = np.asarray(sub["kernel"]).transpose(3, 2, 0, 1)
            elif "scale" in sub:
                sd[f"{key}.weight"] = np.asarray(sub["scale"])
                sd[f"{key}.bias"] = np.asarray(sub["bias"])
                sd[f"{key}.running_mean"] = np.asarray(s[name]["mean"])
                sd[f"{key}.running_var"] = np.asarray(s[name]["var"])
            else:
                walk(sub, s[name], f"{key}.")

    walk(params, stats, "")
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    return out


def qresnet_from_jax(q: Any):
    """A JAX ``QResNet50`` with numpy leaves (``jax.device_get``) -> the port's
    ``QResNet50`` on the CPU, with the same constants bit for bit."""
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import QBlock, QResNet50

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    return QResNet50(
        stem_w=t(q.stem_w), stem_m=t(q.stem_m), stem_z=t(q.stem_z),
        input_scale=t(q.input_scale),
        blocks=tuple(QBlock(*(t(a) for a in b)) for b in q.blocks),
        final_scale=t(q.final_scale), truncate_after=int(q.truncate_after),
        feature_dim=int(q.feature_dim),
    )


def _optax_fields(node: Any, found: dict) -> None:
    """Collect the fields of the optax states in ``node`` (NamedTuples or
    their msgpack maps, the ``{'lr_scale': x}`` dict, tuples of chained
    states); the first of each name wins, outermost first."""
    if hasattr(node, "_asdict"):
        fields = node._asdict()
        for key, value in fields.items():
            found.setdefault(key, value)
        for value in fields.values():
            _optax_fields(value, found)
    elif isinstance(node, Mapping) and set(node) == {"lr_scale"}:
        found.setdefault("lr_scale", node["lr_scale"])
    elif isinstance(node, Mapping):  # a state as flax msgpack writes it: a map of its fields
        for key, value in node.items():
            found.setdefault(key, value)
        for value in node.values():
            _optax_fields(value, found)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _optax_fields(value, found)


def optimizer_state_from_jax(opt_state: Any, in_features: int, names: list[str]) -> dict:
    """The optax state of the JAX package's ``create_optimizer`` (numpy
    leaves, e.g. after ``jax.device_get``, or the ``opt_state`` map of a JAX
    ``last.ckpt``) -> a state for the port's
    ``Optimizer.load_state_dict``, each per-parameter list ordered as
    ``names`` (the model's ``named_parameters`` order).

    Reads ``ScaleByAdamState`` (count, mu, nu), ``TraceState`` (trace),
    ``LookaheadState`` (slow_params, step), ``MultiStepsState`` (mini_step,
    acc_grads) and the mutable lr scale; a missing piece keeps its initial
    value."""
    found: dict = {}
    _optax_fields(opt_state, found)

    def per_param(tree: Any) -> list[torch.Tensor]:
        sd = state_dict_from_jax(tree, in_features)
        return [sd[name] for name in names]

    state = {"count": int(np.asarray(found.get("count", 0))),
             "mini_step": int(np.asarray(found.get("mini_step", 0))),
             "lookahead_step": int(np.asarray(found.get("step", 0))),
             "lr_scale": float(np.asarray(found.get("lr_scale", 1.0)))}
    for port_key, jax_key in (("mu", "mu"), ("nu", "nu"), ("trace", "trace"),
                              ("slow", "slow_params"), ("acc", "acc_grads")):
        state[port_key] = per_param(found[jax_key]) if jax_key in found else []
    return state
