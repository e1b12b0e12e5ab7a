"""Operations of the ViT tile encoder (UNI2-h) and of TransMIL on its
features, for the slide-ViT cell's mfu share (the peak rule of
``portbench/costs``).

A tile through a ViT of width D, patch p, depth L, MLP hidden H (fc2 takes
H / 2 for the packed SwiGLU, H for a GELU MLP) on n = 1 + R + (hw / p)^2
tokens: the patch embed (2 (hw / p)^2 * 3 p^2 * D), and each block's qkv
(2 n D 3D), q k^T and the probabilities times v over all heads (2 n^2 D
each), the out projection (2 n D^2), fc1 (2 n D H) and fc2 (2 n (H / 2) D).
LayerNorm, softmax, SiLU, LayerScale and the residual adds are not counted.
At UNI2-h's widths that is 370.94 GFLOP a 224 x 224 tile.
"""

from __future__ import annotations

from portbench import costs

UNI2H = {"img_size": 224, "patch_size": 14, "embed_dim": 1536, "depth": 24, "num_heads": 24,
         "mlp_ratio": 5.33334, "reg_tokens": 8}


def vit_tile_ops(hw: int = 224, patch_size: int = 14, embed_dim: int = 1536, depth: int = 24,
                 mlp_ratio: float = 5.33334, reg_tokens: int = 8, swiglu: bool = True,
                 **_) -> float:
    """Float operations of one hw x hw tile through the ViT."""
    d, grid = embed_dim, (hw // patch_size) ** 2
    n = 1 + reg_tokens + grid
    hidden = int(d * mlp_ratio)
    fc2_in = hidden // 2 if swiglu else hidden
    block = 2.0 * n * d * 3 * d + 2 * 2.0 * n * n * d + 2.0 * n * d * d \
        + 2.0 * n * d * hidden + 2.0 * n * fc2_in * d
    return 2.0 * grid * 3 * patch_size ** 2 * d + depth * block


def transmil_ops(n: int, in_features: int = 1536, dim: int = 512, n_classes: int = 2) -> float:
    """``costs.transmil_ops`` with the fc1 of widths other than 2048, 1024
    and 768: one Dense (in, 512) on the real rows."""
    half = in_features // 2
    two_dense = 2.0 * n * (in_features * half + half * dim)
    return costs.transmil_ops(n, in_features, dim, n_classes) - two_dense \
        + 2.0 * n * in_features * dim
