"""The port's float ResNet50 (feature mode) against ``models/resnet.py`` of the
JAX package, with the flax variables carried across by
``resnet_state_dict_from_jax``. Tolerance: relative 1e-4 of the largest
feature (float32 convolutions summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.models.resnet import Bottleneck, ResNet as JaxResNet
from transmil_deepgraft_tpu_torch.models import resnet50, resnet50_baseline
from transmil_deepgraft_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

REL_TOL = 1e-4


def perturbed_resnet_variables(seed: int, size: int = 64) -> dict:
    """Flax ResNet50 variables (numpy) with non-trivial BatchNorm statistics,
    so that folding and eval-mode BN matter."""
    rng = np.random.default_rng(seed)
    model = JaxResNet(Bottleneck, (3, 4, 6, 3), num_classes=0)
    init = jax.jit(lambda key: model.init({"params": key}, jnp.zeros((1, size, size, 3))))
    v = jax.device_get(init(jax.random.key(seed)))

    def perturb(tree):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out[k] = perturb(val)
            elif k == "mean":
                out[k] = val + 0.05 * rng.standard_normal(val.shape).astype(np.float32)
            elif k == "var":
                out[k] = val * (1.0 + 0.1 * rng.random(val.shape).astype(np.float32))
            else:
                out[k] = val
        return out

    return {"params": v["params"], "batch_stats": perturb(v["batch_stats"])}


@pytest.fixture(scope="module")
def variables():
    return perturbed_resnet_variables(0)


@pytest.mark.parametrize("truncate_after", [4, 3])
def test_resnet_features_match_jax(variables, truncate_after):
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxResNet(Bottleneck, (3, 4, 6, 3), num_classes=0, truncate_after=truncate_after)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    port = resnet50() if truncate_after == 4 else resnet50_baseline()
    loaded = port.load_state_dict(resnet_state_dict_from_jax(variables), strict=False)
    assert not loaded.missing_keys
    assert all(k.startswith("layer4") for k in loaded.unexpected_keys)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048 if truncate_after == 4 else 1024)
    assert port.feature_dim == got.shape[1]
    np.testing.assert_allclose(got, want, atol=REL_TOL * np.abs(want).max(), rtol=0)


def test_state_dict_conversion_covers_every_tensor(variables):
    sd = resnet_state_dict_from_jax(variables)
    model = resnet50()
    assert set(sd) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert sd[key].shape == value.shape, key
    # HWIO (7, 7, 3, 64) -> OIHW (64, 3, 7, 7)
    np.testing.assert_array_equal(
        sd["conv1.weight"].numpy(),
        np.asarray(variables["params"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
