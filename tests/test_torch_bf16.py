"""The port's bfloat16 TransMIL (``precision: 16-mixed``) against the JAX
package's, on the CPU.

The bar is measured first: the largest per-logit gap between JAX's bfloat16
and float32 forwards of the same weights on the test inputs. The port's
bfloat16 forward must be within twice that gap of JAX's bfloat16 forward,
and never looser than 5e-2. TransMIL at in_features 64 and out_features 64
(8 heads of 8, 32 landmarks), two bags of 120 tiles.

The JAX side runs op by op, not under ``jax.jit``: each bfloat16 op then
returns the rounded result the model code asks for. Under jit, XLA:CPU keeps
some of those intermediates wider (its bfloat16 forward lands 4x closer to
float32 on this input), which no op-by-op implementation reproduces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

IN_F, OUT_F, N_CLS = 64, 64, 2
MAX_BAR = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 120, IN_F)).astype(np.float32)
    x2 = r.standard_normal((2, 120, IN_F)).astype(np.float32)
    labels = np.array([0, 1], np.int32)
    jm32 = jax_create_model("TransMIL", N_CLS, IN_F, OUT_F)
    jm16 = jax_create_model("TransMIL", N_CLS, IN_F, OUT_F, precision="16-mixed")
    params = jax.jit(jm32.init)({"params": jax.random.key(0)}, jnp.asarray(x))["params"]
    l32 = np.asarray(jm32.apply({"params": params}, jnp.asarray(x)))
    j16 = jm16.apply({"params": params}, jnp.asarray(x))
    l16 = np.asarray(j16, np.float32)
    gap = float(np.abs(l16 - l32).max())

    # one RAdam step (lr 1e-3, dropout off): its loss, then the loss of the
    # next batch after the update
    tx = jax_create_optimizer("radam", lr=1e-3, weight_decay=0.01)
    onehot = jax.nn.one_hot(labels, N_CLS)

    def loss_of(p, x):
        return jlosses.cross_entropy(jm16.apply({"params": p}, x, deterministic=True), onehot)

    # the losses op by op; the gradient only moves the weights for the second
    # loss, so it may come from jit (op by op it is the slowest step of the fixture)
    loss1 = jlosses.cross_entropy(j16, onehot)  # the eval forward is the train forward here
    grads = jax.jit(jax.grad(loss_of))(params, jnp.asarray(x))
    updates, _ = tx.update(grads, tx.init(params), params)
    loss2 = loss_of(optax.apply_updates(params, updates), jnp.asarray(x2))
    return {"x": x, "x2": x2, "labels": labels, "params": params, "jax16": l16,
            "jax_losses": (float(loss1), float(loss2)), "bar": min(2 * gap, MAX_BAR), "gap": gap}


def _port(case, **kw):
    model = create_model("TransMIL", N_CLS, IN_F, OUT_F, device="cpu", precision="16-mixed", **kw)
    model.load_state_dict(state_dict_from_jax(jax.device_get(case["params"]), IN_F))
    return model


def test_bf16_is_what_precision_asks_for(case):
    assert 0 < case["gap"] < MAX_BAR  # bfloat16 moves the logits, and not by much
    for precision in (16, "16", "bf16", "16-mixed"):
        assert create_model("TransMIL", 2, IN_F, OUT_F, device="cpu",
                            precision=precision).dtype == torch.bfloat16
    for precision in (None, 32, "32"):
        assert create_model("TransMIL", 2, IN_F, OUT_F, device="cpu",
                            precision=precision).dtype == torch.float32
    model = _port(case)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("fused", [False, True], ids=["layers", "fused"])
def test_bf16_forward_within_the_bar(case, fused):
    """Eval mode: the standard layers (what JAX runs on the CPU) and the
    fused TransLayer route (K1/K2 on the card; its float32 residual stream
    makes it a float32 layer, as JAX's fused path on the TPU)."""
    model = _port(case, fused_inference=fused).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(case["x"]))
    assert logits.dtype == torch.float32
    err = np.abs(logits.numpy() - case["jax16"]).max()
    assert err <= case["bar"], (err, case["bar"], case["gap"])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "landmark_kernels"])
def test_bf16_train_step_within_the_bar(case, use_pallas):
    """Dropout off, RAdam at lr 1e-3: the loss of a step, then of the next
    batch after the update (so the bfloat16 backward counts too)."""
    model = _port(case, use_pallas=use_pallas)
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    ttx = create_optimizer("radam", lr=1e-3, weight_decay=0.01)
    ttx.init(model.parameters())
    target = torch.eye(N_CLS)[torch.from_numpy(case["labels"]).long()]
    loss1 = tlosses.cross_entropy(model(torch.from_numpy(case["x"])), target)
    loss1.backward()
    ttx.step()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        loss2 = tlosses.cross_entropy(model(torch.from_numpy(case["x2"])), target)
    for got, want in zip((loss1.item(), loss2.item()), case["jax_losses"]):
        assert abs(got - want) <= case["bar"], (got, want, case["bar"])
