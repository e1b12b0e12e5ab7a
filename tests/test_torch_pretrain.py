"""The port's SimCLR pretraining and ConvMixer against the JAX package's, on
the CPU.

- ``nt_xent`` and ``_ranking_metrics`` on the same projections, float64:
  the loss within 1e-12, the metrics (float32 means in both, whose last bit
  depends on how the mean divides) within 1e-7;
- ``fit_simclr``: three steps (8 tiles of 32 px, batch 8, three epochs,
  ResNet18) in float64 on both sides (JAX's initial variables cast to
  float64 and carried to the port), fed the same numpy views (the port's
  ``two_view_batch`` on the same ``default_rng`` draws the JAX loop's
  augmentation stream): each epoch's loss and ranking metrics, and the
  final parameters and BatchNorm statistics, within 1e-6; JAX's
  ``simclr_last.ckpt`` (flax msgpack) read by the port's loader within 1e-6
  of the port's own final weights;
- the cosine schedule and the scheduled AdamW against optax step for step
  (float64, five updates, within 1e-12);
- ConvMixer (dim 32, depth 2, kernel 5, patch 7 with flax's 'SAME' pad at
  33 px): the eval forward within 1e-5 (float32); one train-mode forward and
  backward in float64: loss within 1e-10, the moved running statistics
  within 1e-10, gradients within 1e-7 (JAX's depthwise VJP accumulates in
  float32, ``ops/depthwise.py:61``: 5e-7 relative);
- ``cli.pretrain`` of both packages on the same 8 JPEG tiles: the same JSON
  keys, tile count and epochs, finite losses, and the port's checkpoint
  reloads.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from transmil_deepgraft_tpu.cli import pretrain as jcli
from transmil_deepgraft_tpu.models import convmixer as jconvmixer
from transmil_deepgraft_tpu.models import simclr as jsimclr_model
from transmil_deepgraft_tpu.models.resnet import resnet18 as jresnet18
from transmil_deepgraft_tpu.train import simclr as jsimclr
from transmil_deepgraft_tpu_torch.cli import pretrain as tcli
from transmil_deepgraft_tpu_torch.models import simclr as tsimclr_model
from transmil_deepgraft_tpu_torch.models.convmixer import ConvMixer
from transmil_deepgraft_tpu_torch.models.resnet import resnet18
from transmil_deepgraft_tpu_torch.train import optimizers as topt
from transmil_deepgraft_tpu_torch.train import simclr as tsimclr
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    backbone_state_dict_from_jax,
    variables_from_module,
)

FIT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(n: int = 8, size: int = 32, seed: int = 0) -> np.ndarray:
    r = np.random.default_rng(seed)
    base = r.integers(40, 200, (n, size, size, 3))
    base[: n // 2, ..., 0] += 40
    return np.clip(base, 0, 255).astype(np.uint8)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_nt_xent_and_ranking_metrics_match_jax():
    r = np.random.default_rng(1)
    z1, z2 = r.standard_normal((2, 6, 16))
    z2[:3] = z1[:3] + 0.1 * z2[:3]  # some positives rank first, others do not
    with jax.enable_x64(True):
        want = float(jsimclr_model.nt_xent(jnp.asarray(z1), jnp.asarray(z2), 0.2))
        want_m = {k: float(v) for k, v in
                  jsimclr._ranking_metrics(jnp.asarray(z1), jnp.asarray(z2), 0.2).items()}
    t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
    assert abs(float(tsimclr_model.nt_xent(t1, t2, 0.2)) - want) <= 1e-12
    got_m = {k: float(v) for k, v in tsimclr._ranking_metrics(t1, t2, 0.2).items()}
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= 1e-7, k


class _Float64Init:
    """A flax SimCLRModel whose ``init`` gives float64 variables (kept in
    ``inits``); ``apply`` and ``backbone`` as the model's."""

    inits: list = []

    def __init__(self, *args, **kw):
        self.model = jsimclr_model.SimCLRModel(*args, **kw)
        self.backbone = self.model.backbone

    def init(self, *args, **kw):
        v = jax.tree.map(lambda t: t.astype(jnp.float64), self.model.init(*args, **kw))
        self.inits.append(jax.device_get(v))
        return v

    def apply(self, *args, **kw):
        return self.model.apply(*args, **kw)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Three SimCLR steps of each package in float64 from the same weights."""
    images = _images()
    kw = dict(hidden_dim=16, epochs=3, batch_size=8, lr=1e-3, weight_decay=1e-2,
              temperature=0.1, seed=0)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    _Float64Init.inits.clear()
    orig = jsimclr.SimCLRModel
    jsimclr.SimCLRModel = _Float64Init
    try:
        with jax.enable_x64(True):
            _, jvars, jhist = jsimclr.fit_simclr(images, backbone=jresnet18(num_classes=0),
                                                 log_dir=jdir, **kw)
    finally:
        jsimclr.SimCLRModel = orig
    model, hist = tsimclr.fit_simclr(images, backbone=resnet18(num_classes=0).double(),
                                     log_dir=tdir, init_variables=_Float64Init.inits[0], **kw)
    return {"jax": (jvars, jhist, jdir), "port": (model, hist, tdir)}


def test_fit_simclr_matches_jax_in_float64(fits):
    jvars, jhist, _ = fits["jax"]
    model, hist, _ = fits["port"]
    assert len(hist) == len(jhist) == 3
    for got, want in zip(hist, jhist):
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= FIT_TOL, (k, got[k], want[k])
    assert hist[-1]["train_loss"] != hist[0]["train_loss"]
    got, want = _leaves(variables_from_module(model)), _leaves(jax.device_get(jvars))
    assert got.keys() == want.keys()
    init = _leaves(_Float64Init.inits[0])
    moved = 0
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= FIT_TOL, k
        moved += np.abs(want[k] - init[k]).max() > 1e-4
    assert moved > len(want) // 2  # the weights and statistics did move


def test_port_reads_the_jax_simclr_checkpoint(fits):
    model, _, tdir = fits["port"]
    _, _, jdir = fits["jax"]
    own = {k: v.clone() for k, v in model.state_dict().items()}
    reloaded = resnet18(num_classes=0).double()
    fresh = tsimclr_model.SimCLRModel(reloaded, 512, proj_dim=16, hidden_dim=64).double()
    tsimclr.load_simclr_checkpoint(fresh, Path(jdir) / "simclr_last.ckpt")
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert (v - own[k]).abs().max().item() <= FIT_TOL, k
    tsimclr.load_simclr_checkpoint(fresh, Path(tdir) / "simclr_last.ckpt")
    assert all(torch.equal(v, own[k]) for k, v in fresh.state_dict().items())
    feats = tsimclr.backbone_features(fresh, _images(3), batch_size=2)
    assert feats.shape == (3, 512) and np.isfinite(feats).all()


def test_schedule_and_adamw_follow_optax_step_for_step():
    sched = optax.cosine_decay_schedule(1e-3, 4, alpha=1.0 / 50)
    mine = topt.cosine_decay_schedule(1e-3, 4, alpha=1.0 / 50)
    with jax.enable_x64(True):
        for count in range(7):
            assert abs(mine(count) - float(sched(count))) <= 1e-15
        r = np.random.default_rng(2)
        params = [r.standard_normal((3, 4)), r.standard_normal(4)]
        grads = [[r.standard_normal(p.shape) for p in params] for _ in range(5)]
        tx = optax.adamw(sched, weight_decay=1e-2)
        jp = [jnp.asarray(p) for p in params]
        state = tx.init(jp)
        tp = [torch.tensor(p, requires_grad=True) for p in params]
        ttx = topt.create_scheduled_adamw(tp, mine, 1e-2)
        for g in grads:
            updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, updates)
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x)
            ttx.step()
            for a, b in zip(tp, jp):
                assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-12


CONVMIXER = dict(dim=32, depth=2, kernel_size=5, patch_size=7, n_classes=3)


@pytest.fixture(scope="module")
def convmixer():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        module = ConvMixer(**CONVMIXER)
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
                m.weight.data.uniform_(0.8, 1.2)
                m.bias.data.normal_(0.0, 0.05)
    x = np.random.default_rng(6).standard_normal((2, 33, 33, 3)).astype(np.float32)
    jmodel = jconvmixer.ConvMixer(**CONVMIXER)
    variables = variables_from_module(module)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    assert jax.tree.map(np.shape, variables) == jax.tree.map(lambda s: s.shape, dict(shapes))
    back = backbone_state_dict_from_jax(variables)
    assert all(torch.equal(back[k], v) for k, v in module.state_dict().items()
               if not k.endswith("batches_tracked"))
    return module, jmodel, variables, x


def test_convmixer_eval_matches_jax(convmixer):
    module, jmodel, variables, x = convmixer
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_convmixer_train_step_matches_jax_in_float64(convmixer):
    module, jmodel, variables, x = convmixer
    target = np.eye(3)[[0, 2]]
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params):
            logits, state = jmodel.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                         x.astype(np.float64), train=True,
                                         mutable=["batch_stats"])
            return -jnp.mean(jnp.sum(target * jax.nn.log_softmax(logits), -1)), state

        (want_loss, state), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
    port = ConvMixer(**CONVMIXER).double()
    port.load_state_dict({k: v.double() if v.is_floating_point() else v
                          for k, v in module.state_dict().items()})
    logits = port.train()(torch.from_numpy(x).double())
    loss = -(torch.from_numpy(target) * torch.log_softmax(logits, -1)).sum(-1).mean()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-10
    moved = _leaves(variables_from_module(port)["batch_stats"])
    with torch.no_grad():  # the gradients in the parameters' places, for the flax layout
        for p in port.parameters():
            p.copy_(p.grad)
    grads = _leaves(variables_from_module(port)["params"])
    for path, g in _leaves(jax.device_get(want_grads)).items():
        np.testing.assert_allclose(grads[path], g, atol=1e-7, rtol=0, err_msg=path)
    for path, leaf in _leaves(jax.device_get(state["batch_stats"])).items():
        np.testing.assert_allclose(moved[path], leaf, atol=1e-10, rtol=0, err_msg=path)


def _write_tiles(root: Path, n: int = 8, size: int = 32) -> None:
    for i, img in enumerate(_images(n, size, seed=3)):
        d = root / f"slide_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(d / f"tile_({i}-0).jpg", quality=95)


def test_pretrain_cli_runs_in_both_packages(tmp_path, capsys):
    _write_tiles(tmp_path / "tiles")
    argv = ["--tiles_dir", str(tmp_path / "tiles"), "--tile_size", "32", "--epochs", "1",
            "--batch_size", "4", "--hidden_dim", "16"]
    want = jcli.main(argv + ["--log_dir", str(tmp_path / "jax")])
    got = tcli.main(argv + ["--log_dir", str(tmp_path / "port"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got.keys() == want.keys()
    assert got["tiles"] == want["tiles"] == 8 and got["epochs"] == want["epochs"] == 1
    assert np.isfinite([got["final_loss"], want["final_loss"]]).all()
    model = tsimclr_model.SimCLRModel(resnet18(num_classes=0), 512, proj_dim=16, hidden_dim=64)
    tsimclr.load_simclr_checkpoint(model, got["ckpt"])
