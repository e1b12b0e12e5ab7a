"""Seeded weights and inputs, made on the device in a few large calls.

Each maker draws one flat buffer from a ``torch.Generator`` on the device
seeded by the run's seed, cuts it into leaves, scales each leaf, and hands
the tree over as numpy in the flax layout the port's entry points take
(``build_qresnet50``, ``head_from_params``, ``head_state_dict_from_jax``). The
reference reads the same trees. The scales follow the smoke run's makers:
fan-in scaled kernels, BatchNorm with non-trivial scale, bias, mean and
variance so that the fold matters, LayerNorms with non-zero biases.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import costs


def generator(seed: int, device: torch.device, tag: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``tag``) of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + tag) % 2 ** 63)


def _fill(specs: list, seed: int, device: torch.device, tag: int) -> list[np.ndarray]:
    """specs: (shape, kind, scale) a leaf; kind 'n' draws N(0, 1), 'u' U(0, 1).
    Returns float32 numpy leaves ``offset + scale * draw``; offset is 1 for
    kinds 'n1'/'u1'."""
    sizes = [int(np.prod(s)) for s, _, _ in specs]
    g = generator(seed, device, tag)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, at = [], 0
    for (shape, kind, scale), size in zip(specs, sizes):
        draw = (uniform if kind.startswith("u") else normal)[at:at + size]
        leaf = draw * scale + (1.0 if kind.endswith("1") else 0.0)
        out.append(leaf.reshape(shape))
        at += size
    flat = torch.cat([t.reshape(-1) for t in out]).cpu().numpy()
    leaves, at = [], 0
    for (shape, _, _), size in zip(specs, sizes):
        leaves.append(flat[at:at + size].reshape(shape))
        at += size
    return leaves


def _tree(paths: list[tuple], leaves: list[np.ndarray]) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def resnet50_variables(seed: int, device: torch.device) -> dict:
    """Flax-layout ResNet50 ``{'params', 'batch_stats'}`` (numpy): lecun
    normal convs (HWIO), BatchNorm scale 1 + 0.1 N, bias 0.05 N, mean 0.05 N,
    variance 1 + 0.1 U."""
    paths, specs = [], []

    def conv(path, k, cin, cout):
        paths.append(("params", *path, "kernel"))
        specs.append(((k, k, cin, cout), "n", 1.0 / np.sqrt(k * k * cin)))

    def bn(ppath, spath, c):
        for key, spec in (("scale", ("n1", 0.1)), ("bias", ("n", 0.05))):
            paths.append(("params", *ppath, key))
            specs.append(((c,), *spec))
        for key, spec in (("mean", ("n", 0.05)), ("var", ("u1", 0.1))):
            paths.append(("batch_stats", *spath, key))
            specs.append(((c,), *spec))

    conv(("conv1",), 7, 3, 64)
    bn(("bn1",), ("bn1",), 64)
    counts = [0, 0, 0, 0]
    for stage, _, cin, mid, cout, has_ds in costs.r50_blocks():
        name = f"layer{stage + 1}_{counts[stage]}"
        counts[stage] += 1
        for i, (k, a, b) in enumerate(((1, cin, mid), (3, mid, mid), (1, mid, cout)), 1):
            conv((name, f"conv{i}"), k, a, b)
            bn((name, f"bn{i}"), (name, f"bn{i}"), b)
        if has_ds:
            conv((name, "downsample_conv"), 1, cin, cout)
            bn((name, "downsample_bn"), (name, "downsample_bn"), cout)
    return _tree(paths, _fill(specs, seed, device, tag=1))


def transmil_params(seed: int, device: torch.device, in_features: int = 2048,
                    n_classes: int = 2, dim: int = 512, heads: int = 8,
                    residual_taps: int = 33) -> dict:
    """Flax-layout TransMIL params (numpy): Dense kernels (in, out) scaled by
    1/sqrt(in), biases 0.02 N, LayerNorm scale 1 + 0.1 N and bias 0.1 N, the
    value residual (taps, heads) by 1/sqrt(taps), PPEG kernels (k, k, 1, dim)
    by 1/k, the cls token N."""
    paths, specs = [], []

    def add(path, shape, kind, scale):
        paths.append(path)
        specs.append((shape, kind, scale))

    def dense(path, i, o, bias=True):
        add((*path, "kernel"), (i, o), "n", 1.0 / np.sqrt(i))
        if bias:
            add((*path, "bias"), (o,), "n", 0.02)

    def norm(path, c):
        add((*path, "scale"), (c,), "n1", 0.1)
        add((*path, "bias"), (c,), "n", 0.1)

    half = in_features // 2
    dense(("fc1_0",), in_features, half)
    norm(("fc1_norm0",), half)
    dense(("fc1_1",), half, dim)
    add(("cls_token",), (1, 1, dim), "n", 1.0)
    for layer in ("layer1", "layer2"):
        norm((layer, "norm"), dim)
        dense((layer, "attn", "to_qkv"), dim, 3 * dim, bias=False)
        dense((layer, "attn", "to_out"), dim, dim)
        add((layer, "attn", "res_conv"), (residual_taps, heads), "n",
            1.0 / np.sqrt(residual_taps))
    for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        add(("pos_layer", name), (k, k, 1, dim), "n", 1.0 / k)
        add(("pos_layer", f"{name}_bias"), (dim,), "n", 0.02)
    norm(("norm",), dim)
    dense(("fc",), dim, n_classes)
    return _tree(paths, _fill(specs, seed, device, tag=2))


def uint8_tiles(seed: int, device: torch.device, count: int, hw: int,
                block: int = 4096) -> np.ndarray:
    """(count, hw, hw, 3) uint8 tiles in pageable host memory, drawn on the
    device ``block`` tiles a call (so the device never holds the pool)."""
    g = generator(seed, device, tag=3)
    out = np.empty((count, hw, hw, 3), np.uint8)
    host = torch.from_numpy(out)
    for start in range(0, count, block):
        stop = min(count, start + block)
        host[start:stop].copy_(torch.randint(0, 256, (stop - start, hw, hw, 3), generator=g,
                                             device=device, dtype=torch.uint8))
    return out


def feature_rows(seed: int, device: torch.device, rows: int, dim: int, tag: int = 4) -> np.ndarray:
    """(rows, dim) float32 N(0, 1) feature rows in pageable host memory."""
    g = generator(seed, device, tag)
    return torch.randn(rows, dim, generator=g, device=device).cpu().numpy()
