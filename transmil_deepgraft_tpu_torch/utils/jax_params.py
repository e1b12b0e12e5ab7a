"""Flax-layout weights -> the port's models.

TransMIL (:func:`state_dict_from_jax`, the inverse of the JAX package's
``utils/torch_weights.convert_transmil_state_dict``): the flax tree arrives as
nested dicts of numpy arrays (``params["layer1"]["attn"]["to_qkv"]["kernel"]``),
e.g. from :func:`unflatten` of an ``.npz`` written with :func:`flatten`. Dense
kernels (in, out) are transposed to torch (out, in); ``res_conv`` (33, heads)
becomes (heads, 1, 33, 1); the PPEG kernels (k, k, 1, C) become (C, 1, k, k).

The other heads (:func:`head_state_dict_from_jax`): one table a head,
:func:`head_layout`, pairs each flax leaf with its key in the port's
``state_dict`` and the transform between them (a BatchNorm head's running
statistics are ``batch_stats`` leaves); ``utils/torch_weights`` reads the
same tables backwards for the reference's ``.pth`` converters.

The ResNets, the tile backbones of ``models/backbones`` (ViT, EfficientNet,
InceptionV3, the projections) and the classic tile classifiers, whose port
modules carry the flax names: :func:`backbone_state_dict_from_jax` walks the
flax tree, :func:`variables_from_module` walks the module back. The int8
ResNet50 (:func:`qresnet_from_jax`) likewise. :func:`optimizer_state_from_jax` carries
the optax state of ``create_optimizer`` (moments, slow weights, counters, the
gradient accumulator and the plateau scale) onto the port's optimizer, and
that of ``create_dtfd_optimizer`` (two masked Adams) onto its
``TwoTierOptimizer``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

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


# (flax leaf path "a/b/c", port state_dict key, transform) of one head; the
# transforms: "id", "T" (a Dense kernel (in, out) <-> a Linear weight
# (out, in)), "conv1d" (Chowder's scorer kernel (L, 1) <-> Conv1d (1, L, 1)),
# "conv" (an HWIO conv kernel, PPEG's depthwise (k, k, 1, C) included <->
# OIHW), "res_conv" (the value residual's (ks, heads) <-> (heads, 1, ks, 1)).
# BatchNorm running statistics are leaves of the flax ``batch_stats``,
# written "batch_stats/<path>".
Layout = list[tuple[str, str, str]]
TO_TORCH = {"id": lambda a: a, "T": lambda a: a.T, "conv1d": lambda a: a.T[:, :, None],
            "conv": lambda a: a.transpose(3, 2, 0, 1), "res_conv": lambda a: a.T[:, None, :, None]}
TO_FLAX = {"id": lambda w: w, "T": lambda w: w.T, "conv1d": lambda w: w[:, :, 0].T,
           "conv": lambda w: w.transpose(2, 3, 1, 0), "res_conv": lambda w: w[:, 0, :, 0].T}
BATCH_STATS = "batch_stats/"


def _dense(flax: str, key: str, bias: bool = True) -> Layout:
    return [(f"{flax}/kernel", f"{key}.weight", "T")] + (
        [(f"{flax}/bias", f"{key}.bias", "id")] if bias else [])


def _norm(flax: str, key: str) -> Layout:
    return [(f"{flax}/scale", f"{key}.weight", "id"), (f"{flax}/bias", f"{key}.bias", "id")]


def _gated_attention_layout(prefix: str = "", flax: str = "") -> Layout:
    """The raw gated-attention params of ``ops/pooling.gated_attention_pool``
    (weight (in, out) plus a separate bias) <-> the reference's
    ``attention_V.0`` / ``attention_U.0`` / ``attention_weights`` Linears."""
    out: Layout = []
    for name in ("attention_V", "attention_U"):
        out += [(f"{flax}{name}", f"{prefix}{name}.0.weight", "T"),
                (f"{flax}{name}_bias", f"{prefix}{name}.0.bias", "id")]
    return out + [(f"{flax}attention_weights", f"{prefix}attention_weights.weight", "T"),
                  (f"{flax}attention_weights_bias", f"{prefix}attention_weights.bias", "id")]


def _batchnorm(flax: str, key: str) -> Layout:
    """A flax BatchNorm (params and ``batch_stats``) <-> ``nn.BatchNorm2d``."""
    return _norm(flax, key) + [(f"{BATCH_STATS}{flax}/mean", f"{key}.running_mean", "id"),
                               (f"{BATCH_STATS}{flax}/var", f"{key}.running_var", "id")]


def _transmil_body_layout(classifier: tuple[str, str]) -> Layout:
    """TransMIL's body (``models/transmil.TransMILBody``): the cls token, the
    two TransLayers, PPEG, the LayerNorm and the (flax, port) classifier."""
    out: Layout = [("cls_token", "cls_token", "id")]
    for layer in ("layer1", "layer2"):
        out += _norm(f"{layer}/norm", f"{layer}.norm")
        out += _dense(f"{layer}/attn/to_qkv", f"{layer}.attn.to_qkv", bias=False)
        out += _dense(f"{layer}/attn/to_out", f"{layer}.attn.to_out.0")
        out += [(f"{layer}/attn/res_conv", f"{layer}.attn.res_conv.weight", "res_conv")]
    for name in ("proj", "proj1", "proj2"):
        out += [(f"pos_layer/{name}", f"pos_layer.{name}.weight", "conv"),
                (f"pos_layer/{name}_bias", f"pos_layer.{name}.bias", "id")]
    return out + _norm("norm", "norm") + _dense(*classifier)


def _resnet_layout(flax: str, key: str, layers=(3, 4, 6, 3)) -> Layout:
    """The bottleneck ResNet of ``models/resnet.ResNet`` (flax module names
    on both sides)."""
    out = [(f"{flax}/conv1/kernel", f"{key}.conv1.weight", "conv")]
    out += _batchnorm(f"{flax}/bn1", f"{key}.bn1")
    in_planes = 64
    for stage, n_blocks in enumerate(layers):
        planes = (64, 128, 256, 512)[stage]
        for b in range(n_blocks):
            f, k = f"{flax}/layer{stage + 1}_{b}", f"{key}.layer{stage + 1}_{b}"
            for i in (1, 2, 3):
                out += [(f"{f}/conv{i}/kernel", f"{k}.conv{i}.weight", "conv")]
                out += _batchnorm(f"{f}/bn{i}", f"{k}.bn{i}")
            if b == 0 and ((1, 2, 2, 2)[stage] != 1 or in_planes != planes * 4):
                out += [(f"{f}/downsample_conv/kernel", f"{k}.downsample_conv.weight", "conv")]
                out += _batchnorm(f"{f}/downsample_bn", f"{k}.downsample_bn")
            in_planes = planes * 4
    return out


def _clam_layout(multi_branch: bool, n_classes: int, instance_classifiers: bool,
                 dropout: bool = False) -> Layout:
    """CLAM (``models/clam.py``): with ``dropout`` the gate sits at index 3
    of ``attention_net``."""
    gate = f"attention_net.{3 if dropout else 2}"
    out = _dense("fc", "attention_net.0")
    out += _dense("attention_net/attention_a", f"{gate}.attention_a.0")
    out += _dense("attention_net/attention_b", f"{gate}.attention_b.0")
    out += _dense("attention_net/attention_c", f"{gate}.attention_c")
    if multi_branch:
        for c in range(n_classes):
            out += _dense(f"classifier_{c}", f"classifiers.{c}")
    else:
        out += _dense("classifiers", "classifiers")
    if instance_classifiers:
        for c in range(n_classes):
            out += _dense(f"instance_classifier_{c}", f"instance_classifiers.{c}")
    return out


def _torch_encoder_layout(flax: str, key: str, num_layers: int) -> Layout:
    """``TorchTransformerEncoder`` <-> torch ``nn.TransformerEncoder``."""
    out: Layout = []
    for i in range(num_layers):
        f, k = f"{flax}/layers_{i}", f"{key}.layers.{i}"
        out += [(f"{f}/in_proj/kernel", f"{k}.self_attn.in_proj_weight", "T"),
                (f"{f}/in_proj/bias", f"{k}.self_attn.in_proj_bias", "id")]
        out += _dense(f"{f}/out_proj", f"{k}.self_attn.out_proj")
        out += _dense(f"{f}/linear1", f"{k}.linear1") + _dense(f"{f}/linear2", f"{k}.linear2")
        out += _norm(f"{f}/norm1", f"{k}.norm1") + _norm(f"{f}/norm2", f"{k}.norm2")
    return out


def _head_fc1_layout(key: str, two_stage: bool, mid_norm: bool) -> Layout:
    """The heads' fc1 MLP, Sequential indices 0 (Linear), 3 (LayerNorm),
    4 (Linear): ``two_stage`` the 2048 branch, ``mid_norm`` a LayerNorm
    after the first Linear."""
    out = _dense("fc1_0", f"{key}.0")
    if two_stage or mid_norm:
        out += _norm("fc1_norm0", f"{key}.3")
    if two_stage:
        out += _dense("fc1_1", f"{key}.4")
    return out


def head_layout(model_name: str, in_features: int, *, depth: int = 4,
                mil_mode: str = "att_trans", trans_blocks: int = 4, n_classes: int = 2,
                instance_classifiers: bool = False, dropout: bool = False) -> Layout:
    """The carry-over table of a head other than TransMIL: ``depth`` is
    RoFormerMIL's, ``mil_mode`` and ``trans_blocks`` MonaiMIL's,
    ``n_classes``, ``instance_classifiers`` and ``dropout`` CLAM's."""
    if model_name in ("CLAM_SB", "CLAM_MB"):
        return _clam_layout(model_name == "CLAM_MB", n_classes, instance_classifiers, dropout)
    if model_name in ("DTFD", "DTFDMIL"):
        return ([("dimreduction/fc1/kernel", "dimreduction.fc1.weight", "T")]
                + _gated_attention_layout("attention.", "attention/")
                + _dense("classifier", "classifier.fc")
                + _gated_attention_layout("attCls.attention.", "attCls/attention/")
                + _dense("attCls/classifier", "attCls.classifier.fc"))
    if model_name == "MDMIL":
        return _dense("fc1", "_fc1.0") + _transmil_body_layout(("fc2", "_fc2"))
    if model_name == "CTMIL":
        out: Layout = []
        for i in (1, 2):
            out += [(f"conv{i}/kernel", f"conv{i}.0.weight", "conv")]
            out += _batchnorm(f"bn{i}", f"conv{i}.1")
        return out + _transmil_body_layout(("fc", "_fc2"))
    if model_name == "resnet50":
        return _resnet_layout("resnet", "resnet") + _dense("fc", "fc")
    if model_name == "DSMIL":
        return [row for name in ("i_classifier", "q0", "q1", "v", "fcc")
                for row in _dense(name, name)]
    if model_name == "AttMIL":
        return (_head_fc1_layout("_fc1", in_features == 2048, True)
                + _gated_attention_layout() + _dense("classifier", "classifier.0"))
    if model_name == "TransformerMIL":
        out = [("cls_token", "cls_token", "id")]
        out += _head_fc1_layout("fc1", in_features == 2048, in_features == 1024)
        for t in ("transformer1", "transformer2"):
            for i in range(2):
                k = f"{t}.layers.{i}"
                out += _norm(f"{t}/attn_norm_{i}", f"{k}.0.norm")
                out += _dense(f"{t}/attn_{i}/to_qkv", f"{k}.0.fn.to_qkv", bias=False)
                out += _dense(f"{t}/attn_{i}/to_out", f"{k}.0.fn.to_out.0")
                out += _norm(f"{t}/ff_norm_{i}", f"{k}.1.norm")
                out += _dense(f"{t}/ff_{i}/Dense_0", f"{k}.1.fn.net.0")
                out += _dense(f"{t}/ff_{i}/Dense_1", f"{k}.1.fn.net.3")
        return out + _norm("norm", "norm") + _dense("fc2", "_fc2")
    if model_name == "Chowder":
        out = [("f1/kernel", "f1.0.weight", "conv1d"), ("f1/bias", "f1.0.bias", "id")]
        for j in range(3):
            out += _dense(f"f2_{j}", f"f2.{j}")
        return out
    if model_name in ("AttTrans", "MonaiMILModel"):
        out = _dense("myfc", "myfc")
        if mil_mode not in ("mean", "max"):
            out += _dense("attention_0", "attention.0") + _dense("attention_1", "attention.2")
        if mil_mode == "att_trans":
            out += _torch_encoder_layout("transformer", "transformer", trans_blocks)
        if mil_mode == "att_trans_pyramid":  # the cascade, ref MonaiMILModel.py:127-155
            out += _torch_encoder_layout("transformer_0", "transformer.0", trans_blocks)
            for i in (1, 2):
                out += _dense(f"transformer_{i}_proj", f"transformer.{i}.0")
                out += _torch_encoder_layout(f"transformer_{i}", f"transformer.{i}.1",
                                             trans_blocks)
            out += _torch_encoder_layout("transformer_3", "transformer.3", trans_blocks)
        return out
    if model_name == "RoFormerMIL":
        out = [("cls_token", "cls_token", "id")]
        out += _head_fc1_layout("fc1", in_features >= 2048, False)
        for i in range(depth):
            out += _norm(f"attn_norm_{i}", f"attn_norm_{i}")
            out += _dense(f"attn_{i}/to_qkv", f"attn_{i}.to_qkv", bias=False)
            out += _dense(f"attn_{i}/to_out", f"attn_{i}.to_out")
            out += _norm(f"ff_norm_{i}", f"ff_norm_{i}")
            out += _dense(f"Dense_{2 * i}", f"ff_{i}.0") + _dense(f"Dense_{2 * i + 1}", f"ff_{i}.2")
        return out + _norm("norm", "norm") + _dense("fc2", "fc2")
    raise KeyError(f"no weight layout for model '{model_name}'")


def _layout_knobs(model_name: str, params: Mapping[str, Any]) -> dict:
    """The :func:`head_layout` knobs a head's flax params show: RoFormerMIL's
    depth, MonaiMIL's parts (mean and max hold the same ``myfc`` alone),
    CLAM's class count and instance classifiers."""
    if model_name in ("CLAM_SB", "CLAM_MB"):
        return {"n_classes": int(np.shape(params["attention_net"]["attention_c"]["kernel"])[1])
                if model_name == "CLAM_MB" else int(np.shape(params["classifiers"]["kernel"])[1]),
                "instance_classifiers": "instance_classifier_0" in params}
    if model_name == "RoFormerMIL":
        return {"depth": sum(1 for k in params if k.startswith("attn_norm_"))}
    if model_name in ("AttTrans", "MonaiMILModel"):
        if "transformer" in params:
            return {"mil_mode": "att_trans", "trans_blocks": len(params["transformer"])}
        if "transformer_0" in params:
            return {"mil_mode": "att_trans_pyramid", "trans_blocks": len(params["transformer_0"])}
        return {"mil_mode": "att" if "attention_0" in params else "mean"}
    return {}


def head_knobs_from_params(model_name: str, params: Mapping[str, Any],
                           knobs: Mapping[str, Any] | None = None) -> dict:
    """The constructor knobs of the head that ``params`` hold: the given
    ``knobs`` (those the weights do not show) over the structural ones the
    weights show (RoFormerMIL's depth, mlp_dim and its dim_head for the
    given ``heads``, MonaiMIL's mil_mode and trans_blocks). MonaiMIL's
    'mean' and 'max' hold the same weights: their ``mil_mode`` must be given."""
    knobs = dict(knobs or {})
    shown = _layout_knobs(model_name, params)
    shown.pop("n_classes", None)  # CLAM's: an argument of its own, not a knob
    if model_name == "RoFormerMIL":
        shown["mlp_dim"] = int(np.shape(params["Dense_0"]["kernel"])[1])
        inner = int(np.shape(params["attn_0"]["to_qkv"]["kernel"])[1]) // 3
        shown["dim_head"] = inner // int(knobs.get("heads", 8))
    if model_name in ("AttTrans", "MonaiMILModel") and shown["mil_mode"] == "mean":
        if knobs.get("mil_mode") not in ("mean", "max"):
            raise ValueError(f"{model_name} weights without attention are a 'mean' or a 'max' "
                             "head, which the weights do not tell apart: give the mil_mode "
                             "knob")
        del shown["mil_mode"]
    return {**shown, **knobs}


def head_state_dict_from_jax(model_name: str, params: Mapping[str, Any], in_features: int,
                             batch_stats: Mapping[str, Any] | None = None
                             ) -> dict[str, torch.Tensor]:
    """Flax ``params`` of a ported head -> the port's ``state_dict`` (CPU
    float32 tensors): TransMIL through :func:`state_dict_from_jax`, the
    others through their :func:`head_layout`. A BatchNorm head (CTMIL,
    ``resnet50``) also takes its ``batch_stats``."""
    if model_name == "TransMIL":
        return state_dict_from_jax(params, in_features)
    flat = flatten(params)
    if batch_stats is not None:
        flat.update(flatten(batch_stats, BATCH_STATS))
    layout = head_layout(model_name, in_features, **_layout_knobs(model_name, params))
    sd = {key: torch.from_numpy(np.array(TO_TORCH[kind](flat[path]), dtype=np.float32))
          for path, key, kind in layout}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    return sd


def backbone_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` (numpy leaves) of a module whose
    port names its submodules as flax does (the ResNets, the tile backbones
    of ``models/backbones``, the ViT, EfficientNet, InceptionV3, the classic
    tile classifiers) -> the port module's ``state_dict``, by walking the
    tree: a node with a ``kernel`` is a Conv (HWIO -> OIHW, the depthwise
    HW1C -> C1HW alike) or a Dense ((in, out) -> (out, in)); a node with a
    ``scale`` is a BatchNorm when ``batch_stats`` has it (weight, bias,
    running_mean, running_var), else a LayerNorm; any other leaf (the ViT's
    ``cls_token`` and ``pos_embed``, ``NormedLinear``'s (in, out) weight) is a
    parameter as it is."""
    sd: dict[str, np.ndarray] = {}

    def walk(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str) -> None:
        for name, sub in p.items():
            key = f"{prefix}{name}"
            if not isinstance(sub, Mapping):
                sd[key] = np.asarray(sub)
            elif "kernel" in sub:
                k = np.asarray(sub["kernel"])
                sd[f"{key}.weight"] = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
                if "bias" in sub:
                    sd[f"{key}.bias"] = np.asarray(sub["bias"])
            elif "scale" in sub:
                sd[f"{key}.weight"] = np.asarray(sub["scale"])
                sd[f"{key}.bias"] = np.asarray(sub["bias"])
                if name in s:
                    sd[f"{key}.running_mean"] = np.asarray(s[name]["mean"])
                    sd[f"{key}.running_var"] = np.asarray(s[name]["var"])
            else:
                walk(sub, s.get(name, {}), f"{key}.")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    return out


resnet_state_dict_from_jax = backbone_state_dict_from_jax  # the ResNets' is the same walk


def variables_from_module(module: torch.nn.Module) -> dict:
    """The inverse of :func:`backbone_state_dict_from_jax`: a module's
    weights -> flax-layout ``{'params', 'batch_stats'}`` (numpy), the form
    ``models/resnet_int8.build_qresnet50`` takes. Conv kernels become HWIO,
    Linear weights (in, out), BatchNorm weight/bias/running statistics
    scale/bias and batch_stats mean/var, LayerNorm weight/bias scale/bias,
    the other parameters stay as they are."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: list[str], leaf: str, t: torch.Tensor) -> None:
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy().copy()

    for name, m in module.named_modules():
        path = name.split(".") if name else []
        if isinstance(m, torch.nn.Conv2d):
            put(params, path, "kernel", m.weight.permute(2, 3, 1, 0))
        elif isinstance(m, torch.nn.Linear):
            put(params, path, "kernel", m.weight.t())
        elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
            put(params, path, "scale", m.weight)
            if isinstance(m, torch.nn.BatchNorm2d):
                put(stats, path, "mean", m.running_mean)
                put(stats, path, "var", m.running_var)
        else:
            for leaf, p in m.named_parameters(recurse=False):
                put(params, path, leaf, p)
            continue
        if m.bias is not None:
            put(params, path, "bias", m.bias)
    return {"params": params, "batch_stats": stats}


def _classic_names(backbone: torch.nn.Module) -> tuple[str, Optional[str]]:
    """Flax's names of a classic classifier's network and of its projection
    (None without one): the class names, numbered 0."""
    from transmil_deepgraft_tpu_torch.models.backbones import ProjectedBackbone

    if isinstance(backbone, ProjectedBackbone):
        return f"{type(backbone.backbone).__name__}_0", "ProjectedBackbone_0"
    return f"{type(backbone).__name__}_0", None


def classic_state_dict_from_jax(variables: Mapping[str, Any],
                                model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Flax variables of ``models/classic.ClassicTileClassifier`` -> the
    port model's ``state_dict``: flax's ``<Network>_0`` (and
    ``ProjectedBackbone_0/proj``, a sibling there) become ``backbone``."""
    net, proj = _classic_names(model.backbone)

    def regroup(tree: Mapping[str, Any]) -> dict:
        out = {k: v for k, v in tree.items() if k not in (net, proj)}
        if net in tree:
            out["backbone"] = ({"backbone": tree[net], **(tree.get(proj) or {})} if proj
                               else tree[net])
        return out

    return backbone_state_dict_from_jax({"params": regroup(variables["params"]),
                                       "batch_stats": regroup(variables.get("batch_stats", {}))})


def classic_variables_from_module(model: torch.nn.Module) -> dict:
    """The inverse of :func:`classic_state_dict_from_jax`: flax's tree of
    the classic classifier (numpy)."""
    net, proj = _classic_names(model.backbone)
    variables = variables_from_module(model)
    for tree in variables.values():
        inner = tree.pop("backbone", None)
        if inner is None:
            continue
        if proj:
            tree[net] = inner.pop("backbone")
            if inner:
                tree[proj] = inner
        else:
            tree[net] = inner
    return variables


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


def _optax_all(node: Any, name: str, out: list) -> list:
    """Every value of the field ``name`` in ``node``'s optax states,
    outermost first (two masked instances of one rule hold one each)."""
    if hasattr(node, "_asdict"):
        node = node._asdict()
    if isinstance(node, Mapping):
        if name in node:
            out.append(node[name])
        for value in node.values():
            _optax_all(value, name, out)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _optax_all(value, name, out)
    return out


def _adafactor_state(node: Any) -> Optional[list]:
    """JAX ``adafactor_ref``'s positional state ``(count, v_row, v_col, v,
    mu)`` in ``node``: a 5-tuple (or its msgpack map ``{'0'..'4'}``) of a
    scalar count and four trees."""
    if hasattr(node, "_asdict"):
        node = node._asdict()
    items = None
    if isinstance(node, (list, tuple)):
        items = list(node)
    elif isinstance(node, Mapping) and set(node) == {str(i) for i in range(5)}:
        items = [node[str(i)] for i in range(5)]
    if (items is not None and len(items) == 5 and np.ndim(items[0]) == 0
            and not isinstance(items[0], Mapping)
            and all(isinstance(t, Mapping) for t in items[1:])):
        return items
    children = node.values() if isinstance(node, Mapping) else (
        node if isinstance(node, (list, tuple)) else ())
    for value in children:
        found = _adafactor_state(value)
        if found is not None:
            return found
    return None


def _merged(trees: list) -> dict:
    """One tree from the states of disjoint ``optax.masked`` instances: each
    leaf from the instance that holds it (a masked-out leaf is an empty
    ``MaskedNode``)."""
    flat: dict[str, np.ndarray] = {}
    for tree in trees:
        flat.update({k: v for k, v in flatten(_plain(tree)).items() if np.size(v)})
    return unflatten(flat)


def _plain(tree: Any) -> Any:
    """Nested dicts with ``MaskedNode`` leaves (NamedTuples without fields)
    as empty dicts, as flax msgpack writes them."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return {}
    return tree


def optimizer_state_from_jax(opt_state: Any, in_features: int, names: list[str],
                             model_name: str = "TransMIL",
                             state_dict_of: Optional[Callable[[Any], dict]] = None,
                             rule: str = "radam", params: Any = None) -> dict:
    """The optax state of the JAX package's ``create_optimizer`` (numpy
    leaves, e.g. after ``jax.device_get``, or the ``opt_state`` map of a JAX
    ``last.ckpt``) -> a state for the port's
    ``Optimizer.load_state_dict`` of ``rule`` (the port's rule name), each
    per-parameter list ordered as ``names`` (the model's
    ``named_parameters`` order); the moment trees have the params' layout,
    so ``model_name``'s carry-over maps them (or ``state_dict_of``, a params
    tree -> state dict, for a model that is no head: the classic tile
    classifiers).

    Reads the states of every rule: ``ScaleByAdamState`` (adam, adamw,
    radam, lamb), ``NadamRefState`` (with ``m_schedule``), ``AdamPState``,
    ``AdaHessianState``, ``TraceState``/``SGDPState`` (the momentum trace),
    ``ScaleByRmsState``, ``ScaleByAdaDeltaState``, novograd's (its halves
    under two ``optax.masked`` merged by leaf), adafactor's ``(count, v_row,
    v_col, v, mu)``; and ``LookaheadState`` (slow_params, step),
    ``MultiStepsState`` (mini_step, acc_grads) and the mutable lr scale. A
    missing piece keeps its initial value. novograd's per-tensor ``nu`` and
    adafactor's moments are not elementwise: they are carried as they are,
    in the flax layout the port's rules keep them in, matched to ``names``
    through ``params`` (the JAX params tree, required for those two rules).
    DTFD's state (``create_dtfd_optimizer``) goes to
    :func:`_dtfd_optimizer_state_from_jax`."""
    if model_name in ("DTFD", "DTFDMIL"):
        return _dtfd_optimizer_state_from_jax(opt_state, names)
    found: dict = {}
    _optax_fields(opt_state, found)

    def convert(tree: Any) -> dict:
        return (state_dict_of(tree) if state_dict_of is not None
                else head_state_dict_from_jax(model_name, tree, in_features))

    def per_param(tree: Any) -> list[torch.Tensor]:
        sd = convert(tree)
        return [sd[name] for name in names]

    def as_is(tree: Any) -> list[torch.Tensor]:
        """Leaves matched to ``names`` without a layout change: each
        parameter's leaf path is found by carrying a marker of its index
        over with the weights."""
        flat_params = flatten(_plain(params))
        paths = sorted(flat_params)
        sd = convert(unflatten({path: np.full(np.shape(flat_params[path]), i, np.float32)
                                for i, path in enumerate(paths)}))
        flat = flatten(_plain(tree))
        return [torch.from_numpy(np.array(flat[paths[int(sd[name].flatten()[0])]], np.float32))
                for name in names]

    state = {"count": int(np.asarray(found.get("count", 0))),
             "mini_step": int(np.asarray(found.get("mini_step", 0))),
             "lookahead_step": int(np.asarray(found.get("step", 0))),
             "lr_scale": float(np.asarray(found.get("lr_scale", 1.0))),
             "m_schedule": float(np.asarray(found.get("m_schedule", 1.0)))}
    for key in ("slow", "acc"):
        jax_key = {"slow": "slow_params", "acc": "acc_grads"}[key]
        state[key] = per_param(found[jax_key]) if jax_key in found else []
    if rule == "adafactor":
        count, v_row, v_col, v, mu = _adafactor_state(opt_state)
        state["count"] = int(np.asarray(count))
        state.update({"v_row": as_is(v_row), "v_col": as_is(v_col), "v": as_is(v),
                      "mu": as_is(mu)})
    elif rule == "novograd":
        state["mu"] = per_param(_merged(_optax_all(opt_state, "mu", [])))
        state["nu"] = [t.reshape(()) for t in as_is(_merged(_optax_all(opt_state, "nu", [])))]
    else:
        for port_key, jax_key in (("mu", "mu"), ("nu", "nu"), ("trace", "trace"),
                                  ("trace", "momentum"), ("e_g", "e_g"), ("e_x", "e_x")):
            if jax_key in found:
                state[port_key] = per_param(found[jax_key])
    return state


def _dtfd_optimizer_state_from_jax(opt_state: Any, names: list[str]) -> dict:
    """The optax state of JAX's ``create_dtfd_optimizer`` (a
    ``multi_transform`` of two masked Adams, numpy leaves or the
    ``opt_state`` map of a JAX ``last.ckpt``) -> a state for the port's
    ``TwoTierOptimizer.load_state_dict``; ``names`` is the DTFD model's
    ``named_parameters`` order, tier 2 the ``attCls.`` ones. Each tier's
    moment trees hold its own leaves (the other tier's are masked out)."""
    found: dict = {}
    _optax_fields(opt_state, found)
    layout = head_layout("DTFDMIL", 0)
    lr_scale = float(np.asarray(found.get("lr_scale", 1.0)))
    state = {}
    for tier in ("tier1", "tier2"):
        fields: dict = {}
        _optax_fields(found["inner_states"][tier], fields)
        tier_names = [n for n in names if n.startswith("attCls.") == (tier == "tier2")]

        def per_param(tree: Any) -> list[torch.Tensor]:
            flat = {k: v for k, v in flatten(tree).items() if np.size(v)}
            sd = {key: torch.from_numpy(np.array(TO_TORCH[kind](flat[path]), dtype=np.float32))
                  for path, key, kind in layout if path in flat}
            return [sd[n] for n in tier_names]

        state[tier] = {"count": int(np.asarray(fields["count"])), "mini_step": 0,
                       "lookahead_step": 0, "lr_scale": lr_scale, "mu": per_param(fields["mu"]),
                       "nu": per_param(fields["nu"]), "acc": [], "trace": [], "slow": []}
    return state
