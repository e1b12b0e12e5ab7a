"""Host-side augmentation and normalization of histopathology tiles (port of
``data/transforms.py``; the reference's ``datasets/utils/myTransforms.py``).

Stain-space jitter (HEDJitter, the Ruifrok-Johnston H&E-DAB deconvolution,
ref ``myTransforms.py:1233``), flips and 90-degree rotations, Gaussian blur,
colour jitter, the affine and elastic warps (scipy, nearest neighbour), the
ImageNet normalization, and ``train_augment``, the classic pipeline's stack.
Pure numpy/scipy functions of an explicit ``numpy.random.Generator``: the
same seed gives the JAX package's uint8 arrays byte for byte.
"""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston H&E-DAB stain matrix (rows: H, E, DAB) - the same constants
# scikit-image ships as rgb_from_hed.
RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ],
    dtype=np.float64,
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)


def rgb_to_hed(rgb: np.ndarray) -> np.ndarray:
    rgb = np.maximum(rgb.astype(np.float64) / 255.0, 1e-6)
    return (-np.log(rgb)) @ HED_FROM_RGB


def hed_to_rgb(hed: np.ndarray) -> np.ndarray:
    rgb = np.exp(-(hed @ RGB_FROM_HED))
    return np.clip(rgb * 255.0, 0, 255)


def hed_jitter(img: np.ndarray, theta: float, rng: np.random.Generator) -> np.ndarray:
    """Per-channel stain perturbation: s' = alpha * s + beta with
    alpha ~ U(1-theta, 1+theta), beta ~ U(-theta, theta) (ref HEDJitter)."""
    hed = rgb_to_hed(img)
    alpha = rng.uniform(1 - theta, 1 + theta, size=(1, 1, 3))
    beta = rng.uniform(-theta, theta, size=(1, 1, 3))
    return hed_to_rgb(hed * alpha + beta).astype(img.dtype)


def random_flip_rotate(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random H/V flip + random multiple-of-90 rotation (ref AutoRandomRotation)."""
    if rng.random() < 0.5:
        img = img[:, ::-1]
    if rng.random() < 0.5:
        img = img[::-1]
    k = int(rng.integers(0, 4))
    return np.rot90(img, k, axes=(0, 1)).copy()


def random_gauss_blur(img: np.ndarray, rng: np.random.Generator,
                      radius: tuple[float, float] = (0.5, 1.5), p: float = 0.5) -> np.ndarray:
    if rng.random() >= p:
        return img
    from scipy.ndimage import gaussian_filter

    sigma = rng.uniform(*radius)
    out = np.stack([gaussian_filter(img[..., c].astype(np.float64), sigma) for c in range(img.shape[-1])], -1)
    return out.astype(img.dtype)


def color_jitter(img: np.ndarray, rng: np.random.Generator, brightness: float = 0.2, contrast: float = 0.2) -> np.ndarray:
    out = img.astype(np.float64)
    out = out * rng.uniform(1 - brightness, 1 + brightness)
    mean = out.mean()
    out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    return np.clip(out, 0, 255).astype(img.dtype)


def random_affine(img: np.ndarray, alpha: float, rng: np.random.Generator) -> np.ndarray:
    """Random affine warp (ref ``myTransforms.py:1336`` RandomAffineCV2): three
    anchor points around the image center are jittered by U(-alpha*W, alpha*W)
    and the induced affine map is applied with nearest-neighbor sampling and
    reflect-101 border handling. Pure scipy (no cv2 dependency)."""
    from scipy.ndimage import affine_transform

    assert 0.0 <= alpha <= 0.15, "pathology tiles: alpha in (0, 0.15)"
    a = img.shape[1] * alpha
    size = np.float32(img.shape[:2])
    center = size // 2
    cen = min(img.shape[:2]) // 3
    pts1 = np.float32([center + cen, [center[0] + cen, center[1] - cen], center - cen])
    pts2 = pts1 + rng.uniform(-a, a, size=pts1.shape).astype(np.float32)

    # solve the affine map pts1 -> pts2 (cv2.getAffineTransform equivalent),
    # then apply its inverse as the output->input coordinate map
    src = np.concatenate([pts1, np.ones((3, 1), np.float32)], axis=1)  # (3,3)
    m = np.linalg.solve(src, pts2).T  # (2,3): out = M @ [y, x, 1]
    m_full = np.eye(3)
    m_full[:2] = m
    inv = np.linalg.inv(m_full)

    out = np.stack(
        [
            affine_transform(
                img[..., c].astype(np.float64), inv[:2, :2], offset=inv[:2, 2],
                order=0, mode="mirror",
            )
            for c in range(img.shape[-1])
        ],
        axis=-1,
    )
    return out.astype(img.dtype)


def random_elastic(
    img: np.ndarray, alpha: float, sigma: float, rng: np.random.Generator
) -> np.ndarray:
    """Elastic deformation (ref ``myTransforms.py:1375`` RandomElastic):
    gaussian-filtered random displacement fields dx, dy scaled by alpha*W,
    nearest-neighbor sampling with reflect borders."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    assert 0.05 <= sigma <= 0.1, "pathology tiles: sigma in (0.05, 0.1)"
    a = img.shape[1] * alpha
    s = img.shape[1] * sigma
    shape = img.shape
    dx = gaussian_filter(rng.random(shape) * 2 - 1, s) * a
    dy = gaussian_filter(rng.random(shape) * 2 - 1, s) * a
    x, y, z = np.meshgrid(np.arange(shape[1]), np.arange(shape[0]), np.arange(shape[2]))
    indices = (
        np.reshape(y + dy, (-1, 1)),
        np.reshape(x + dx, (-1, 1)),
        np.reshape(z, (-1, 1)),
    )
    out = map_coordinates(img, indices, order=0, mode="reflect").reshape(shape)
    return out.astype(img.dtype)


IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC (or a batch of them) -> float32 ImageNet-normalized (the
    reference's ToTensor + Normalize)."""
    return ((img.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def train_augment(
    img: np.ndarray,
    rng: np.random.Generator,
    hed_theta: float = 0.05,
    affine_alpha: float = 0.1,
    elastic: tuple[float, float] = (2.0, 0.06),
    geometric_p: float = 0.5,
) -> np.ndarray:
    """The classic-pipeline stain-augmentation stack
    (ref ``classic_jpg_dataloader.py:100-125``): color jitter + HED jitter +
    flips/rotations + gaussian blur + (probabilistic) affine and elastic warps
    (ref RandomAffineCV2 / RandomElastic)."""
    img = color_jitter(img, rng)
    img = hed_jitter(img, hed_theta, rng)
    img = random_flip_rotate(img, rng)
    img = random_gauss_blur(img, rng)
    if rng.random() < geometric_p:
        img = random_affine(img, affine_alpha, rng)
    if rng.random() < geometric_p:
        img = random_elastic(img, elastic[0], elastic[1], rng)
    return img
