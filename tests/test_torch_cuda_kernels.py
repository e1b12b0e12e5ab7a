"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. The repo's tests/conftest.py
sets up JAX, which the GPU machine does not have, so run this file alone:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 3000])
def test_cuda_kernels_match_plain_versions(cuda_device, n):
    """Both kernels against their plain versions at full width (D 512, 8
    heads, 256 landmarks), with a front pad and a non-zero LN bias."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)

    dim = 512
    x = t(rng.standard_normal((1, n, dim)))
    ln_w, ln_b = t(1 + 0.1 * rng.standard_normal(dim)), t(0.5 * rng.standard_normal(dim))
    w_qkv = t(rng.standard_normal((3 * dim, dim)) / np.sqrt(dim))
    n_pad = tk.landmark_pad(n, 256)
    q_lm, k_lm, pinv = tk.landmark_glue(x, n_pad, ln_w, ln_b, w_qkv, heads=8, dim_head=64,
                                        num_landmarks=256, pinv_iterations=6)
    tk.reset_launch_counts()
    k1_args = (x, n_pad, ln_w, ln_b, w_qkv[dim:], q_lm)
    for got, want in zip(tk.translayer_k1(*k1_args), tk.k1_reference(*k1_args)):
        assert (got - want).abs().max().item() <= 1e-3
    bmat = (pinv @ tk.k1_reference(*k1_args)[0]).contiguous()
    res = t(rng.standard_normal((1, n, dim)))
    k2_args = (x, res, ln_w, ln_b, w_qkv[:dim], k_lm, bmat,
               t(rng.standard_normal((dim, dim)) / np.sqrt(dim)), t(rng.standard_normal(dim)), 0.125)
    assert (tk.translayer_k2(*k2_args) - tk.k2_reference(*k2_args)).abs().max().item() <= 1e-3
    assert tk.LAUNCHES == {"translayer_k1": 1, "translayer_k2": 1}
