"""Torch state dicts -> flax-layout parameter trees (the port's copy of the
TransMIL, ResNet, EfficientNet, ViT, Inception, AttMIL, TransformerMIL,
Chowder, MONAI MIL, CLAM, DTFD, MDMIL and CTMIL converters of
``utils/torch_weights.py``, and a RoFormerMIL and a timm ViT (UNI2-h) one
of its own; the other ported heads read their carry-over table).

The reference's checkpoints (``retccl_best_ckpt.pth``, torchvision ResNets,
TransMIL Lightning checkpoints, the port's own trainer checkpoints, which use
the reference's TransMIL names) convert to the nested-dict layout that the
port's bundles and pipelines take (``utils/jax_params`` maps it onto the
port's modules). Pure name and transpose mapping on numpy arrays: torch
``Conv2d.weight (O,I,H,W)`` -> ``kernel (H,W,I,O)``, ``Linear.weight (O,I)``
-> ``kernel (I,O)``, BatchNorm weight/bias/running_mean/running_var ->
scale/bias + batch_stats mean/var. The heads other than TransMIL read the
carry-over tables of ``utils/jax_params.head_layout`` backwards, so a
converter and :func:`~transmil_deepgraft_tpu_torch.utils.jax_params.head_state_dict_from_jax`
are each other's inverse; the port's modules of those heads use the
reference's names, so their state dicts convert the same way.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from transmil_deepgraft_tpu_torch.utils.flax_msgpack import read_flax_msgpack
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    BATCH_STATS, TO_FLAX, head_layout, unflatten)


def _np(t: Any) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def convert_resnet_state_dict(
    state_dict: Mapping[str, Any], truncate_after: int = 4
) -> dict:
    """torch ResNet state dict -> flax-layout {'params': ..., 'batch_stats': ...}
    (``utils/jax_params.resnet_state_dict_from_jax`` maps it onto the port's
    ``models/resnet.ResNet``).

    Handles torchvision naming (``layer1.0.conv1.weight``) and the RetCCL ckpt's
    extras (fc/instDis/groupDis heads are skipped in feature mode).
    """
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: list[str], value: np.ndarray) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for key, value in state_dict.items():
        v = _np(value)
        parts = key.split(".")
        if parts[0].startswith("module"):  # DataParallel prefix
            parts = parts[1:]
        head = parts[0]

        if head == "conv1":
            put(params, ["conv1", "kernel"], v.transpose(2, 3, 1, 0))
        elif head == "bn1":
            _put_bn(params, stats, ["bn1"], parts[1], v)
        elif head.startswith("layer"):
            stage = int(head[5:])
            if stage > truncate_after:
                continue
            block_idx = parts[1]
            mod = parts[2]
            name = f"layer{stage}_{block_idx}"
            if mod.startswith("conv"):
                put(params, [name, mod, "kernel"], v.transpose(2, 3, 1, 0))
            elif mod.startswith("bn"):
                _put_bn(params, stats, [name, mod], parts[3], v)
            elif mod == "downsample":
                sub = "downsample_conv" if parts[3] == "0" else "downsample_bn"
                if sub == "downsample_conv":
                    put(params, [name, sub, "kernel"], v.transpose(2, 3, 1, 0))
                else:
                    _put_bn(params, stats, [name, sub], parts[4], v)
        # heads (fc / instDis / groupDis) are intentionally skipped: backbones run
        # in feature mode (fc = Identity, ref model_interface.py:247).

    return {"params": params, "batch_stats": stats}


def _put_bn(params: dict, stats: dict, path: list[str], field: str, v: np.ndarray) -> None:
    def put(tree: dict, p: list[str], value: np.ndarray) -> None:
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = value

    if field == "weight":
        put(params, path + ["scale"], v)
    elif field == "bias":
        put(params, path + ["bias"], v)
    elif field == "running_mean":
        put(stats, path + ["mean"], v)
    elif field == "running_var":
        put(stats, path + ["var"], v)
    # num_batches_tracked ignored


def convert_transmil_state_dict(state_dict: Mapping[str, Any], in_features: int = 2048) -> dict:
    """torch TransMIL state dict -> ``{'params': ...}`` in flax layout
    (``utils/jax_params.state_dict_from_jax`` is its inverse).

    Key layout of the reference model (``models/TransMIL.py:78-155`` with the
    lucidrains NystromAttention submodule; Lightning ckpts prefix everything
    with ``model.``):
      _fc1.{i}.weight/bias            input MLP (Linear / LayerNorm indices vary
                                      by in_features variant)
      cls_token                       (1, 1, 512)
      layer{1,2}.norm.weight/bias     pre-norm LN
      layer{1,2}.attn.to_qkv.weight   (1536, 512)
      layer{1,2}.attn.to_out.0.weight/bias
      layer{1,2}.attn.res_conv.weight (heads, 1, ks, 1) depthwise value conv
      pos_layer.proj{,1,2}.weight     (512, 1, k, k) depthwise PPEG convs + bias
      norm.weight/bias; _fc.weight/bias
    """
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    p: dict = {}

    def lin(dst: str, src: str) -> None:
        p[dst] = {"kernel": _np(sd[f"{src}.weight"]).T}
        if f"{src}.bias" in sd:
            p[dst]["bias"] = _np(sd[f"{src}.bias"])

    def ln(dst: str, src: str) -> None:
        p[dst] = {"scale": _np(sd[f"{src}.weight"]), "bias": _np(sd[f"{src}.bias"])}

    # fc1 variants (ref TransMIL.py:100-133): sequential indices of Linear/LN.
    if in_features == 2048:
        lin("fc1_0", "_fc1.0")
        ln("fc1_norm0", "_fc1.2")
        lin("fc1_1", "_fc1.3")
    elif in_features in (1024, 768):
        lin("fc1_0", "_fc1.0")
        ln("fc1_norm0", "_fc1.3")
        lin("fc1_1", "_fc1.4")
        if "_fc1.7.weight" in sd:
            ln("fc1_norm1", "_fc1.7")
    else:
        lin("fc1_0", "_fc1.0")

    p["cls_token"] = _np(sd["cls_token"])
    _map_translayer(sd, p, "layer1")
    _map_translayer(sd, p, "layer2")
    _map_ppeg(sd, p, "pos_layer")
    ln("norm", "norm")
    lin("fc", "_fc")
    return {"params": _nest(p)}


def _map_translayer(sd: Mapping[str, Any], p: dict, layer: str) -> None:
    """Map one reference TransLayer (norm + NystromAttention) into ``p``."""
    p[f"{layer}.norm"] = {
        "scale": _np(sd[f"{layer}.norm.weight"]), "bias": _np(sd[f"{layer}.norm.bias"]),
    }
    attn: dict = {}
    attn["to_qkv"] = {"kernel": _np(sd[f"{layer}.attn.to_qkv.weight"]).T}
    attn["to_out"] = {
        "kernel": _np(sd[f"{layer}.attn.to_out.0.weight"]).T,
        "bias": _np(sd[f"{layer}.attn.to_out.0.bias"]),
    }
    # torch res_conv weight (heads, 1, ks, 1) -> flax param (ks, heads)
    rc = _np(sd[f"{layer}.attn.res_conv.weight"])
    attn["res_conv"] = rc[:, 0, :, 0].T
    p[f"{layer}.attn"] = attn


def _map_ppeg(sd: Mapping[str, Any], p: dict, src: str, dst: str = "pos_layer") -> None:
    """Map a reference PPEG (proj/proj1/proj2 depthwise convs) into ``p``."""
    pos: dict = {}
    for name in ("proj", "proj1", "proj2"):
        w = _np(sd[f"{src}.{name}.weight"])  # (C, 1, k, k)
        pos[name] = w.transpose(2, 3, 1, 0)  # (k, k, 1, C)
        pos[f"{name}_bias"] = _np(sd[f"{src}.{name}.bias"])
    p[dst] = pos


def _nest(flat: Mapping[str, Any]) -> dict:
    """Nest dotted keys, merging shared prefixes (layer1.norm / layer1.attn)."""
    nested: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if parts[-1] in node and isinstance(node[parts[-1]], dict) and isinstance(v, dict):
            node[parts[-1]].update(v)
        else:
            node[parts[-1]] = v
    return nested


def _nest_paths(flat: Mapping[str, Any]) -> dict:
    """``{"a.b.c": leaf}`` -> nested dicts (``_nest`` without merging)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def convert_efficientnet_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torchvision-layout EfficientNet-B0 state dict (``features.{i}.{b}.block.
    {j}...``) -> flax-layout ``{'params', 'batch_stats'}`` of
    ``models/efficientnet.EfficientNet``. Shape-agnostic: the standard B0 SE
    widths and NVIDIA's 'widese' ones convert alike (whether the backbone
    takes them is another matter, ROADMAP C14)."""
    from transmil_deepgraft_tpu_torch.models.efficientnet import B0_STAGES

    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}

    def conv(dst: str, src: str) -> None:
        params[dst] = {"kernel": _np(sd[f"{src}.weight"]).transpose(2, 3, 1, 0)}
        if f"{src}.bias" in sd:
            params[dst]["bias"] = _np(sd[f"{src}.bias"])

    def bn(dst: str, src: str) -> None:
        params[dst] = {"scale": _np(sd[f"{src}.weight"]), "bias": _np(sd[f"{src}.bias"])}
        stats[dst] = {"mean": _np(sd[f"{src}.running_mean"]), "var": _np(sd[f"{src}.running_var"])}

    conv("stem_conv", "features.0.0")
    bn("stem_bn", "features.0.1")
    for si, (e, _k, _s, _c, r) in enumerate(B0_STAGES):
        for b in range(r):
            t, f = f"features.{si + 1}.{b}.block", f"stage{si}_block{b}"
            idx = 0
            if e != 1:
                conv(f"{f}.expand_conv", f"{t}.{idx}.0")
                bn(f"{f}.expand_bn", f"{t}.{idx}.1")
                idx += 1
            conv(f"{f}.dw_conv", f"{t}.{idx}.0")
            bn(f"{f}.dw_bn", f"{t}.{idx}.1")
            conv(f"{f}.se.reduce", f"{t}.{idx + 1}.fc1")
            conv(f"{f}.se.expand", f"{t}.{idx + 1}.fc2")
            conv(f"{f}.project_conv", f"{t}.{idx + 2}.0")
            bn(f"{f}.project_bn", f"{t}.{idx + 2}.1")
    conv("head_conv", "features.8.0")
    bn("head_bn", "features.8.1")
    if "classifier.1.weight" in sd:
        params["classifier"] = {"kernel": _np(sd["classifier.1.weight"]).T,
                                "bias": _np(sd["classifier.1.bias"])}
    return {"params": _nest_paths(params), "batch_stats": _nest_paths(stats)}


def convert_vit_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """DINO / timm ViT state dict (``facebook/dino-vitb16``'s names:
    ``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1`` ...)
    -> flax-layout ``{'params'}`` of ``models/vit.VisionTransformer``."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def lin(src: str) -> dict:
        return {"kernel": _np(sd[f"{src}.weight"]).T, "bias": _np(sd[f"{src}.bias"])}

    def ln(src: str) -> dict:
        return {"scale": _np(sd[f"{src}.weight"]), "bias": _np(sd[f"{src}.bias"])}

    p: dict = {
        "cls_token": _np(sd["cls_token"]),
        "pos_embed": _np(sd["pos_embed"]),
        "patch_embed": {"kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
                        "bias": _np(sd["patch_embed.proj.bias"])},
        "norm": ln("norm"),
    }
    for i in range(_count(sd, "blocks.{}.norm1.weight")):
        b = f"blocks.{i}"
        p[f"block{i}"] = {"norm1": ln(f"{b}.norm1"), "norm2": ln(f"{b}.norm2"),
                          "qkv": lin(f"{b}.attn.qkv"), "proj": lin(f"{b}.attn.proj"),
                          "fc1": lin(f"{b}.mlp.fc1"), "fc2": lin(f"{b}.mlp.fc2")}
    if "head.weight" in sd:
        p["head"] = lin("head")
    return {"params": p}


def convert_timm_vit_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """A timm ViT with register tokens, LayerScale and no class position
    embedding (UNI2-h's ``pytorch_model.bin``: ``cls_token`` (1, 1, D),
    ``reg_token`` (1, R, D), ``pos_embed`` (1, gh * gw, D),
    ``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma,
    norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``) -> flax-layout
    ``{'params'}`` of ``models/vit.VisionTransformer`` built with the same
    options (``models/vit.uni2_h``). ``mlp.fc1`` (H, D) is the packed
    SwiGLU's (gate rows first) and ``mlp.fc2`` (D, H / 2). Raises ValueError
    naming the first key that is missing or whose shape does not fit the
    width ``cls_token`` gives."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def get(key: str, *shape) -> np.ndarray:
        """``key`` as numpy; ``shape`` entries of None are free."""
        if key not in sd:
            raise ValueError(f"the checkpoint has no {key!r} (timm ViT names expected)")
        v = _np(sd[key])
        if v.ndim != len(shape) or any(s is not None and s != d for s, d in zip(shape, v.shape)):
            want = tuple("*" if s is None else s for s in shape)
            raise ValueError(f"{key!r} is {tuple(v.shape)}, expected {want}")
        return v

    dim = get("cls_token", 1, 1, None).shape[-1]

    def lin(src: str, n_out, n_in) -> dict:
        kernel = get(f"{src}.weight", n_out, n_in)
        return {"kernel": kernel.T, "bias": get(f"{src}.bias", kernel.shape[0])}

    def ln(src: str) -> dict:
        return {"scale": get(f"{src}.weight", dim), "bias": get(f"{src}.bias", dim)}

    p: dict = {
        "cls_token": get("cls_token", 1, 1, dim),
        "reg_token": get("reg_token", 1, None, dim),
        "pos_embed": get("pos_embed", 1, None, dim),
        "patch_embed": {"kernel": get("patch_embed.proj.weight", dim, 3, None, None)
                        .transpose(2, 3, 1, 0),
                        "bias": get("patch_embed.proj.bias", dim)},
        "norm": ln("norm"),
    }
    get("blocks.0.norm1.weight", dim)  # at least one block
    for i in range(_count(sd, "blocks.{}.norm1.weight")):
        b = f"blocks.{i}"
        fc1 = lin(f"{b}.mlp.fc1", None, dim)
        hidden = fc1["kernel"].shape[1]
        p[f"block{i}"] = {"norm1": ln(f"{b}.norm1"), "norm2": ln(f"{b}.norm2"),
                          "qkv": lin(f"{b}.attn.qkv", 3 * dim, dim),
                          "proj": lin(f"{b}.attn.proj", dim, dim),
                          "ls1": {"gamma": get(f"{b}.ls1.gamma", dim)},
                          "ls2": {"gamma": get(f"{b}.ls2.gamma", dim)},
                          "fc1": fc1, "fc2": lin(f"{b}.mlp.fc2", dim, hidden // 2)}
    return {"params": p}


def convert_inception_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torchvision ``inception_v3`` state dict -> flax-layout ``{'params',
    'batch_stats'}`` of ``models/inception.InceptionV3``, whose module names
    are torchvision's: a conv/bn/fc walk. ``AuxLogits.*`` (the train-time
    classifier) and ``num_batches_tracked`` are not read."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: list[str], value) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("module") or parts[0] == "model":
            parts = parts[1:]
        if parts[0] == "AuxLogits":
            continue
        v = _np(value)
        leaf = parts[-1]
        mod = parts[-2] if len(parts) >= 2 else ""
        if mod == "conv" and leaf == "weight":
            put(params, parts[:-1] + ["kernel"], v.transpose(2, 3, 1, 0))
        elif mod == "bn":
            _put_bn(params, stats, parts[:-1], leaf, v)
        elif parts[0] == "fc" and leaf == "weight":
            put(params, ["fc", "kernel"], v.T)
        elif parts[0] == "fc":
            put(params, ["fc", "bias"], v)
    return {"params": params, "batch_stats": stats}


def _from_layout(state_dict: Mapping[str, Any], model_name: str, in_features: int,
                 **knobs: Any) -> dict:
    """``{'params': ...}`` through the head's carry-over table, and
    ``'batch_stats'`` for a BatchNorm head."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    flat = {path: TO_FLAX[kind](_np(sd[key]))
            for path, key, kind in head_layout(model_name, in_features, **knobs)}
    out = {"params": unflatten({k: v for k, v in flat.items() if not k.startswith(BATCH_STATS)})}
    stats = {k.removeprefix(BATCH_STATS): v for k, v in flat.items() if k.startswith(BATCH_STATS)}
    if stats:
        out["batch_stats"] = unflatten(stats)
    return out


def _count(sd: Mapping[str, Any], fmt: str) -> int:
    """How many consecutive i have ``fmt.format(i)`` among the keys."""
    keys = {k.removeprefix("model.") for k in sd}
    i = 0
    while fmt.format(i) in keys:
        i += 1
    return i


def convert_attmil_state_dict(state_dict: Mapping[str, Any], in_features: int = 2048) -> dict:
    """torch AttMIL (ref ``AttMIL.py:20-110``) -> ``{'params': ...}``."""
    return _from_layout(state_dict, "AttMIL", in_features)


def convert_transformer_mil_state_dict(state_dict: Mapping[str, Any],
                                       in_features: int = 2048) -> dict:
    """torch TransformerMIL (ref ``TransformerMIL.py:74-152``, the active
    forward) -> ``{'params': ...}``."""
    return _from_layout(state_dict, "TransformerMIL", in_features)


def convert_chowder_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torch Chowder (ref ``Chowder.py:19-50``: a Conv1d(L, 1, 1) scorer and
    a 3-layer MLP) -> ``{'params': ...}``."""
    return _from_layout(state_dict, "Chowder", 0)


def convert_monai_mil_state_dict(state_dict: Mapping[str, Any],
                                 mil_mode: str = "att_trans") -> dict:
    """torch MONAI MILModel head (ref ``MonaiMILModel.py:11-232``) ->
    ``{'params': ...}``; the encoder's depth comes from the keys. Backbone
    keys (``net.*``) are not read."""
    prefix = "transformer.0." if mil_mode == "att_trans_pyramid" else "transformer."
    blocks = _count(state_dict, prefix + "layers.{}.self_attn.in_proj_weight")
    if mil_mode in ("att_trans", "att_trans_pyramid") and not blocks:
        raise KeyError(f"no encoder layers under '{prefix}'")
    return _from_layout(state_dict, "AttTrans", 0, mil_mode=mil_mode, trans_blocks=blocks)


def convert_roformer_mil_state_dict(state_dict: Mapping[str, Any],
                                    in_features: int = 2048) -> dict:
    """The port's RoFormerMIL state dict -> ``{'params': ...}`` (the JAX
    package has no torch RoFormerMIL); the depth comes from the keys."""
    return _from_layout(state_dict, "RoFormerMIL", in_features,
                        depth=_count(state_dict, "attn_norm_{}.weight"))


def convert_clam_state_dict(state_dict: Mapping[str, Any], n_classes: int = 2) -> dict:
    """torch CLAM_SB / CLAM_MB (ref ``model_clam.py:71-280``) ->
    ``{'params': ...}``: single or multi branch, the gate at index 2 or 3
    (with dropout) and the instance classifiers as the keys show."""
    keys = {k.removeprefix("model.") for k in state_dict}
    name = "CLAM_SB" if "classifiers.weight" in keys else "CLAM_MB"
    return _from_layout(state_dict, name, 0, n_classes=n_classes,
                        instance_classifiers="instance_classifiers.0.weight" in keys,
                        dropout="attention_net.3.attention_a.0.weight" in keys)


def convert_dtfd_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torch DTFD modules (ref ``DTFDMIL.py:14-108`` wired as in
    ``model_interface_dtfd.py:160-165``) -> ``{'params': ...}``."""
    return _from_layout(state_dict, "DTFDMIL", 0)


def convert_mdmil_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torch MDMIL (ref ``models/MDMIL.py:60-115``) -> ``{'params': ...}``."""
    return _from_layout(state_dict, "MDMIL", 0)


def convert_ctmil_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """torch CTMIL (ref ``models/CTMIL.py:74-165``) -> ``{'params': ...,
    'batch_stats': ...}``. The reference's PPEG ``pos_layer_0`` is the
    port's ``pos_layer``; its dead ``_fc1`` (declared, never run) is not
    read."""
    sd = {k.removeprefix("model.").replace("pos_layer_0.", "pos_layer."): v
          for k, v in state_dict.items()}
    return _from_layout(sd, "CTMIL", 0)


def convert_head_state_dict(state_dict: Mapping[str, Any], model_name: str,
                            in_features: int) -> dict:
    """A torch state dict of any ported head -> ``{'params': ...}`` (and
    ``'batch_stats'`` for CTMIL and ``resnet50``)."""
    if model_name == "TransMIL":
        return convert_transmil_state_dict(state_dict, in_features)
    if model_name == "Chowder":
        return convert_chowder_state_dict(state_dict)
    if model_name in ("AttTrans", "MonaiMILModel"):
        # the parts the keys hold; 'mean' and 'max' hold the same myfc alone,
        # so the layout of one is the other's (the mode is a knob of the head)
        keys = {k.removeprefix("model.") for k in state_dict}
        parts = ("att_trans" if "transformer.layers.0.norm1.weight" in keys
                 else "att_trans_pyramid" if "transformer.0.layers.0.norm1.weight" in keys
                 else "att" if "attention.0.weight" in keys else "mean")
        return convert_monai_mil_state_dict(state_dict, parts)
    if model_name in ("CLAM_SB", "CLAM_MB"):  # the class count of the gate's last Linear
        gate = [v for k, v in state_dict.items() if k.endswith("attention_c.bias")]
        n_classes = (len(_np(gate[0])) if model_name == "CLAM_MB" else
                     len(_np(next(v for k, v in state_dict.items()
                                  if k.removeprefix("model.") == "classifiers.bias"))))
        return convert_clam_state_dict(state_dict, n_classes)
    converters = {"AttMIL": convert_attmil_state_dict,
                  "TransformerMIL": convert_transformer_mil_state_dict,
                  "RoFormerMIL": convert_roformer_mil_state_dict,
                  "DTFD": lambda sd, _: convert_dtfd_state_dict(sd),
                  "DTFDMIL": lambda sd, _: convert_dtfd_state_dict(sd),
                  "MDMIL": lambda sd, _: convert_mdmil_state_dict(sd),
                  "CTMIL": lambda sd, _: convert_ctmil_state_dict(sd)}
    if model_name in converters:
        return converters[model_name](state_dict, in_features)
    return _from_layout(state_dict, model_name, in_features)  # DSMIL, resnet50


def load_torch_checkpoint(path: str) -> dict:
    """Load a .pth/.ckpt with torch (CPU); returns the raw state dict
    (unwraps Lightning's ``state_dict`` key). Unpickles: load only files
    from a trusted source."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


def _is_torch_file(path: str | Path) -> bool:
    """``torch.save`` writes a zip archive (and older ``.pth``/``.pt`` files
    a pickle); flax writes msgpack."""
    return str(path).endswith((".pth", ".pt")) or zipfile.is_zipfile(path)


def load_head_params(path: str | Path, in_features: int, model_name: str = "TransMIL") -> dict:
    """A head's weights from a checkpoint -> flax-layout params: a torch
    state dict in the reference's names (a ``.pth``, a Lightning ``.ckpt``,
    the port's trainer checkpoints, whose weights are under ``model``),
    converted by ``model_name``, or a flax msgpack tree (a variables tree or
    the JAX trainer's checkpoint, whose ``params`` are taken). A BatchNorm
    head's running statistics (CTMIL, ``resnet50``) come under
    ``params['batch_stats']`` (from a variables tree's ``batch_stats`` or a
    trainer checkpoint's ``model_state``), as ``serving.head_from_params``
    reads them."""
    if _is_torch_file(path):
        sd = load_torch_checkpoint(str(path))
        if isinstance(sd.get("model"), Mapping):  # the port's trainer checkpoints
            sd = sd["model"]
        variables = convert_head_state_dict(sd, model_name, in_features)
    else:
        variables = read_flax_msgpack(Path(path).read_bytes())
        if not (isinstance(variables, dict) and "params" in variables):
            raise ValueError(f"no 'params' in the flax checkpoint {path} (top-level keys: "
                             f"{list(variables)[:8] if isinstance(variables, dict) else type(variables).__name__})")
        variables = {**(variables.get("model_state") or {}), **variables}
    stats = variables.get("batch_stats")
    return {**variables["params"], "batch_stats": stats} if stats else variables["params"]


def load_backbone_variables(path: str | Path) -> dict:
    """ResNet50 weights -> flax-layout ``{'params', 'batch_stats'}``: a torch
    state dict (torchvision or RetCCL names) or a flax msgpack variables tree."""
    if _is_torch_file(path):
        return convert_resnet_state_dict(load_torch_checkpoint(str(path)))
    tree = read_flax_msgpack(Path(path).read_bytes())
    if isinstance(tree, dict) and "params" in tree and "batch_stats" in tree:
        return tree
    raise ValueError(f"unrecognized backbone checkpoint structure in {path}")


def convert_backbone_state_dict(state_dict: Mapping[str, Any], backbone_name: str) -> dict:
    """A tile backbone's torch state dict -> flax-layout ``{'params',
    'batch_stats'}``, converted by backbone (JAX ``cli/train.py``
    ``_load_backbone_variables``): ResNet names for 'retccl', 'resnet50' and
    'resnet18', torchvision's EfficientNet-B0 for 'efficientnet', DINO/timm
    for 'vit'/'dino', timm's with registers and LayerScale for 'uni2_h',
    torchvision's Inception-v3 for 'inception'."""
    converters = {"retccl": convert_resnet_state_dict, "resnet50": convert_resnet_state_dict,
                  "resnet18": convert_resnet_state_dict,
                  "efficientnet": convert_efficientnet_state_dict,
                  "vit": convert_vit_state_dict, "dino": convert_vit_state_dict,
                  "uni2_h": convert_timm_vit_state_dict,
                  "inception": convert_inception_state_dict}
    if backbone_name not in converters:
        raise ValueError(f"no torch converter for backbone {backbone_name!r}")
    return converters[backbone_name](state_dict)


def load_image_backbone_variables(path: str | Path, backbone_name: str) -> dict:
    """A tile backbone's weights for the ``images`` variant: a torch
    ``.pth``/``.pt`` state dict through :func:`convert_backbone_state_dict`,
    or a flax msgpack variables tree as it is."""
    if str(path).endswith((".pth", ".pt")):
        return convert_backbone_state_dict(load_torch_checkpoint(str(path)), backbone_name)
    return read_flax_msgpack(Path(path).read_bytes())
