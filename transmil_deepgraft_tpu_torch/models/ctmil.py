"""CTMIL: conv-tokenized TransMIL over spatial feature volumes (port of
``models/ctmil.py``).

Ref ``code/models/CTMIL.py:74-165``: the input is a (B, 50, 50, D) volume of
tile features (``data/local_features.py``, NHWC as in JAX); two stages of
conv 3x3 (no bias) -> BatchNorm -> exact GELU -> max-pool 3/2 pad 1 (D ->
D/2 -> 512, 50 -> 25 -> 13) tokenize the grid into (B, 169, 512) tokens in
row-major (H, W) order, then TransMIL's body
(:class:`~.transmil.TransMILBody`), the TransLayers fused at inference.

BatchNorm is :class:`~.resnet.BatchNorm2d` at flax's default momentum 0.99
(train mode: batch statistics, the running ones updated by flax's rule).
Parameter names follow the reference's ``conv{1,2}.0`` (conv) and
``conv{1,2}.1`` (BatchNorm) and ``_fc2``; the PPEG is ``pos_layer``
(the reference's ``pos_layer_0``, and its dead ``_fc1``, convert through
``utils/torch_weights.convert_ctmil_state_dict``).
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import GELU, PPEG, TransLayer
from transmil_deepgraft_tpu_torch.models.resnet import BatchNorm2d
from transmil_deepgraft_tpu_torch.models.transmil import TransMILBody


def _stage(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), BatchNorm2d(cout),
                         GELU(), nn.MaxPool2d(3, stride=2, padding=1))


class CTMIL(TransMILBody):
    flax_classifier = "fc"  # the flax name of the (width, n_classes) classifier
    # return_attn gives layer 2's row over the pooled grid's tokens, which a
    # bundle and the slide pipeline average into the tile count's shape as
    # JAX's do (its serving bundles export CTMIL with attention)
    gives_attention = True

    def __init__(self, n_classes: int, in_features: int = 2048, out_features: int = 512) -> None:
        super().__init__()
        self.out_features = out_features
        self.fused_inference = True  # False: the standard layers at inference too
        self.pos_layer = PPEG(dim=out_features)
        self.conv1 = _stage(in_features, in_features // 2)
        self.conv2 = _stage(in_features // 2, out_features)
        self.cls_token = nn.Parameter(torch.randn(1, 1, out_features))
        self.layer1 = TransLayer(dim=out_features)
        self.layer2 = TransLayer(dim=out_features)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)
        self._fc2 = nn.Linear(out_features, n_classes)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, H, W, D) or (H, W, D) -> (B, C) logits; ``return_attn`` adds
        the layer-2 attention row of the cls token (B, heads, padded keys)."""
        if x.dim() == 3:
            x = x[None]
        h = self.conv2(self.conv1(x.float().permute(0, 3, 1, 2)))  # NCHW
        tokens = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1, h.shape[1])
        logits, attn_row, _, _ = self._body(tokens, self._fc2, 0 if return_attn else None)
        return (logits, attn_row) if return_attn else logits
