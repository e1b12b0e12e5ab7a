"""Seeded UNI2-h weights in timm's names, and TransMIL weights for its
1536-d features, made on the device in one draw each.

:func:`uni2h_state_dict` gives what MahmoodLab/UNI2-h's ``pytorch_model.bin``
holds, drawn from the seed: Linear and patch-embed weights N / sqrt(fan-in),
biases 0.02 N, LayerNorm scales 1 + 0.1 N and shifts 0.1 N, the cls and
register tokens and the position embedding 0.02 N, and the LayerScale
gammas 1 + 0.1 N. The gammas are of order one, not timm's 1e-5 init: at
1e-5 every block's branch would be scaled away and no check could see a
fault in it (trained UNI2-h gammas are far from 1e-5). The program converts
the dict as ``cli.infer --backbone uni2_h`` converts a checkpoint; the
reference (``reference/vit``) loads it as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights


def _scale(name: str, shape: tuple) -> tuple[float, float]:
    """(offset, scale) of the leaf ``name``: leaf = offset + scale * N."""
    if name.endswith("gamma") or (name.endswith("weight") and len(shape) == 1):
        return 1.0, 0.1  # LayerScale gammas, LayerNorm scales
    if name.endswith("bias"):
        return 0.0, 0.1 if "norm" in name else 0.02
    if name.endswith("weight"):
        return 0.0, 1.0 / np.sqrt(np.prod(shape[1:]))
    return 0.0, 0.02  # cls_token, reg_token, pos_embed


def uni2h_state_dict(seed: int, device: torch.device, widths: dict) -> dict:
    """UNI2-h's state dict in timm's names as float32 CPU tensors, drawn on
    ``device``; ``widths`` are ``reference/vit.UNI2h``'s keyword arguments
    (the configuration's ``backbone`` section)."""
    from portbench.reference.vit import UNI2h

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in UNI2h(**widths).state_dict().items()}
    sizes = [int(np.prod(s)) for s in shapes.values()]
    g = weights.generator(seed, device, tag=11)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    at = 0
    for (name, shape), size in zip(shapes.items(), sizes):
        offset, scale = _scale(name, shape)
        flat[at:at + size].mul_(scale).add_(offset)
        at += size
    flat = flat.cpu()
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        out[name] = flat[at:at + size].view(shape)
        at += size
    return out


def transmil_params(seed: int, device: torch.device, in_features: int,
                    n_classes: int = 2, dim: int = 512) -> dict:
    """Flax-layout TransMIL params (numpy) for ``in_features`` other than
    2048, 1024 and 768, whose fc1 is one Dense ``fc1_0`` (in, 512):
    ``weights.transmil_params``'s tree with its fc1 drawn again in that
    shape (kernel N / sqrt(in), bias 0.02 N)."""
    p = weights.transmil_params(seed, device, in_features, n_classes, dim)
    for key in ("fc1_0", "fc1_norm0", "fc1_1"):
        del p[key]
    kernel, bias = weights._fill([((in_features, dim), "n", 1.0 / np.sqrt(in_features)),
                                  ((dim,), "n", 0.02)], seed, device, tag=12)
    p["fc1_0"] = {"kernel": kernel, "bias": bias}
    return p
