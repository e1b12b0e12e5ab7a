"""The port's TransMIL head against ``TransMIL.apply`` of the JAX package on
the same flax params (moved across with ``state_dict_from_jax``), and against
the frozen torch-parity fixture."""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.models.transmil import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.utils.torch_weights import convert_transmil_state_dict
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.utils.jax_params import flatten, state_dict_from_jax, unflatten

LOGIT_TOL = 1e-3  # the PARITY.md bar
FIXTURE = Path(__file__).parent / "fixtures" / "parity_transmil_2048.npz"


def _jax_params(in_features, out_features, n_classes, seed):
    """Seeded flax-layout params (every leaf random, so LayerNorm and Dense
    biases are non-zero), made through the JAX package's torch converter."""
    rng = np.random.default_rng(seed)
    shapes = create_model("TransMIL", n_classes, in_features, out_features, device="cpu")
    sd = {k: torch.from_numpy((0.1 * rng.standard_normal(v.shape)
                               + (k.endswith("norm.weight") or k.endswith(".2.weight"))
                               ).astype(np.float32))
          for k, v in shapes.state_dict().items()}
    return convert_transmil_state_dict(sd, in_features=in_features)["params"]


def _port(params, n_classes, in_features, out_features, fused):
    model = create_model("TransMIL", n_classes, in_features, out_features, device="cpu",
                         fused_inference=fused)
    model.load_state_dict(state_dict_from_jax(params, in_features))
    return model.eval()


@functools.lru_cache(maxsize=None)
def _jax_reference(in_features, out_features, n, n_classes):
    """(bag, params, logits, attention logits, attention payload) of the JAX
    model, computed once per configuration for both port paths."""
    x = np.random.default_rng(n).standard_normal((1, n, in_features)).astype(np.float32)
    jmodel = JaxTransMIL(n_classes=n_classes, in_features=in_features, out_features=out_features)
    params = _jax_params(in_features, out_features, n_classes, seed=n)
    logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    attn_logits, attn = jmodel.apply({"params": params}, jnp.asarray(x), return_attn=True)
    return x, params, logits, np.asarray(attn_logits), attn


@pytest.mark.parametrize("fused", [True, False], ids=["fused_cpu_path", "plain"])
@pytest.mark.parametrize("in_features,out_features,n,n_classes", [
    (128, 64, 90, 3),   # front pad 59 before layer 1 (91 tokens, m 32)
    (2048, 512, 40, 2),  # full width, short bag
])
def test_transmil_matches_jax(in_features, out_features, n, n_classes, fused):
    x, params, want_plain, want_logits, want_attn = _jax_reference(
        in_features, out_features, n, n_classes)
    model = _port(params, n_classes, in_features, out_features, fused)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_logits, attn = model(torch.from_numpy(x), return_attn=True)
    np.testing.assert_allclose(got, want_plain, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=0)
    assert attn.pad == want_attn.pad and attn.n_tokens == want_attn.n_tokens == n
    np.testing.assert_allclose(attn.tile_scores().numpy(), np.asarray(want_attn.tile_scores()),
                               atol=1e-4, rtol=0)


def test_transmil_matches_frozen_torch_fixture():
    """tests/fixtures/parity_transmil_2048.npz: flax params + the recorded
    torch reference forward on a 237-tile bag."""
    with np.load(FIXTURE) as z:
        params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
        bag = z["bag"]
        want = {k[4:]: z[k] for k in z.files if k.startswith("out:")}
    for fused in (True, False):
        model = _port(params, 2, 2048, 512, fused)
        with torch.no_grad():
            logits = model(torch.from_numpy(bag)).numpy()
            attn_logits, attn = model(torch.from_numpy(bag), return_attn=True)
        np.testing.assert_allclose(logits, want["logits"], atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(attn_logits.numpy(), want["logits"], atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(attn.row[0].numpy(), want["attn_row"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(attn.tile_scores()[0].numpy(), want["tile_scores"],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("in_features", [2048, 1024, 768, 384])
def test_state_dict_round_trips_through_the_jax_converter(in_features):
    """state_dict_from_jax is the inverse of the JAX package's
    convert_transmil_state_dict, and fits the port's module exactly."""
    rng = np.random.default_rng(in_features)
    model = create_model("TransMIL", 3, in_features, device="cpu")
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in model.state_dict().items()}
    params = convert_transmil_state_dict(sd, in_features=in_features)["params"]
    back = state_dict_from_jax(params, in_features)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
    model.load_state_dict(back)  # strict


def test_flatten_unflatten_round_trip():
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros(3)}}, "e": np.arange(4)}
    flat = flatten(tree)
    assert sorted(flat) == ["a/b", "a/c/d", "e"]
    back = unflatten(flat)
    np.testing.assert_array_equal(back["a"]["c"]["d"], tree["a"]["c"]["d"])


def test_create_model_rejects_other_heads():
    with pytest.raises(KeyError):
        create_model("AttMIL", 2, device="cpu")


def test_training_mode_runs_the_plain_layers():
    """Dropout applies in train mode, so the kernels (inference only) are
    not used: two train-mode forwards differ, eval-mode ones agree."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 20, 384)).astype(np.float32))
    model = create_model("TransMIL", 2, 384, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        model.train()
        a, b = model(x), model(x)
        model.eval()
        c, d = model(x), model(x)
    assert not torch.allclose(a, b)
    assert torch.equal(c, d)
