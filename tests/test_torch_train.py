"""The port's training slice against the JAX package's, on the CPU: losses,
batches, the optimizer step for step, and a short Trainer.fit epoch for
epoch.

TransMIL at in_features 64 and out_features 64 (8 heads of 8, 32 landmarks)
with dropout off (torch and flax dropout masks cannot be shared). The port's
TransLayers run with ``use_pallas=True``: on the CPU that is the plain
versions of the landmark kernels with the analytic backward; the JAX side
runs its XLA path. Tolerances: per-step loss and parameters within 1e-4
(float32 sums taken in another order); the fit as
tests/test_composed_fit_parity.py holds it (lr_scale rtol 1e-6, the same
number of epochs), val_loss within 1e-4 and val / patient AUC within 0.005
(the BASELINE bar).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JaxDataModule
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu.train.trainer import Trainer as JaxTrainer
from transmil_deepgraft_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
from transmil_deepgraft_tpu_torch.utils.jax_params import optimizer_state_from_jax, state_dict_from_jax

IN_F, OUT_F, N_CLS = 64, 64, 2
LR, WD, ACC = 2e-4, 0.01, 2
AUC_TOL = 0.005


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tiny model runs thousands of small ops a step: with one intra-op
    thread each costs microseconds whatever else loads the CPU (with a thread
    a core, every op waits for descheduled peers when the cores are busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _synthetic(**over):
    cfg = {"n_train": 6, "n_val": 6, "n_test": 4, "bag_size": 40, "feature_size": IN_F,
           "signal": 0.8, "variable_bags": False}
    cfg.update(over)
    return cfg


def _modules(seed=0, **dm_over):
    args = dict(n_classes=N_CLS, max_bag_size=32, batch_size=1, synthetic=_synthetic(), seed=seed)
    args.update(dm_over)
    return JaxDataModule(**args), MILDataModule(**args)


def _jax_params(seed=0):
    x = jnp.zeros((1, 32, IN_F), jnp.float32)
    init = jax.jit(JaxTransMIL(N_CLS, IN_F, OUT_F).init)  # one compile, not one an op
    return init({"params": jax.random.key(seed)}, x)["params"]


def _port_model(params):
    model = create_model("TransMIL", N_CLS, IN_F, OUT_F, device="cpu", use_pallas=True)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), IN_F))
    return model


# ----------------------------------------------------------------- losses

_LOSS_NAMES = sorted(jlosses._LOSSES) + ["bce+lovasz", "bce+jaccard", "bce+log_jaccard",
                                         "bce+log_dice"]


@pytest.mark.parametrize("name", _LOSS_NAMES)
def test_losses_match_jax(name):
    rng = np.random.default_rng(len(name))
    logits = (2 * rng.standard_normal((6, 3))).astype(np.float32)
    targets = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    want = jlosses.create_loss(name)(jnp.asarray(logits), jnp.asarray(targets))
    got = tlosses.create_loss(name)(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name, error", [("topk", NotImplementedError),
                                         ("hausdorff", NotImplementedError),
                                         ("bce+nothing", KeyError), ("NoSuchLoss", KeyError)])
def test_losses_the_reference_rejects_still_raise(name, error):
    for create in (jlosses.create_loss, tlosses.create_loss):
        with pytest.raises(error):
            create(name)


# ------------------------------------------------------------------- data

def test_batches_are_byte_identical_to_jax():
    """synthetic bags, the imbalanced sampler, the train subsample / pad /
    shuffle and collate replay the JAX module's numpy draws."""
    jdm, tdm = _modules(seed=5, synthetic=_synthetic(variable_bags=True), max_bag_size=24)
    pairs = [(jdm.train_batches(e), tdm.train_batches(e)) for e in (0, 1)]
    pairs += [(jdm.eval_batches(m, batch_size=2), tdm.eval_batches(m, batch_size=2))
              for m in ("val", "test")]
    for jb_iter, tb_iter in pairs:
        jbs, tbs = list(jb_iter), list(tb_iter)
        assert len(jbs) == len(tbs) > 0
        for jb, tb in zip(jbs, tbs):
            assert jb.bags.tobytes() == tb.bags.tobytes() and jb.bags.shape == tb.bags.shape
            np.testing.assert_array_equal(jb.labels, tb.labels)
            np.testing.assert_array_equal(jb.lengths, tb.lengths)
            assert (jb.names, jb.patients) == (tb.names, tb.patients)
            assert jb.padded_coords.tobytes() == tb.padded_coords.tobytes()
    assert jdm.steps_per_epoch() == tdm.steps_per_epoch()
    # feature bags from data_dir are ported; the other variants and Camelyon are not
    for over in ({"variant": "spatial"}, {"variant": "images"}, {"variant": "tiles"},
                 {"variant": "image_bags"}, {"dataset_name": "camelyon"}):
        with pytest.raises(NotImplementedError):
            MILDataModule("/nonexistent", n_classes=2, **over)


# -------------------------------------------------------------- optimizer

def test_optimizer_follows_optax_step_for_step():
    """lookahead_radam (wd 0.01, grad_acc 2): 8 JAX micro-steps, then the
    JAX state (weights, moments, slow weights, counters) carried onto the
    port, then 8 more micro-steps on both sides in lockstep. The carried run
    crosses RAdam's rectification (inner step 6) and lookahead's first sync
    (inner step 6)."""
    jdm, _ = _modules()
    bags = [b for e in (0, 1, 2) for b in jdm.train_batches(e)][:16]
    model = JaxTransMIL(N_CLS, IN_F, OUT_F)
    tx = jax_create_optimizer("lookahead_radam", lr=LR, weight_decay=WD, grad_accum_steps=ACC)
    params = _jax_params()
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, x, y):
        def loss_of(p):
            logits = model.apply({"params": p}, x, deterministic=True)
            return jlosses.cross_entropy(logits, jax.nn.one_hot(y, N_CLS))

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for b in bags[:8]:
        params, opt_state, _ = jax_step(params, opt_state, jnp.asarray(b.bags), jnp.asarray(b.labels))

    tmodel = _port_model(params)
    names = [n for n, _ in tmodel.named_parameters()]
    ttx = create_optimizer("lookahead_radam", lr=LR, weight_decay=WD, grad_accum_steps=ACC)
    ttx.init(tmodel.parameters())
    ttx.load_state_dict(optimizer_state_from_jax(jax.device_get(opt_state), IN_F, names))
    assert (ttx.count, ttx.lookahead_step, ttx.mini_step) == (4, 4, 0)
    tmodel.train()
    for m in tmodel.modules():  # dropout off, as deterministic=True on the JAX side
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    for b in bags[8:]:
        params, opt_state, jloss = jax_step(params, opt_state, jnp.asarray(b.bags),
                                            jnp.asarray(b.labels))
        for p in tmodel.parameters():
            p.grad = None
        logits = tmodel(torch.from_numpy(b.bags))
        loss = tlosses.cross_entropy(logits, torch.eye(N_CLS)[torch.from_numpy(b.labels).long()])
        loss.backward()
        ttx.step()
        assert abs(loss.item() - float(jloss)) <= 1e-4
    assert (ttx.count, ttx.lookahead_step) == (8, 8)

    want = state_dict_from_jax(jax.device_get(params), IN_F)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-4, rtol=0)
    want_state = optimizer_state_from_jax(jax.device_get(opt_state), IN_F, names)
    for key in ("mu", "slow"):
        for got, exp in zip(ttx.state_dict()[key], want_state[key]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=1e-4, rtol=0)


def test_create_optimizer_names():
    for name in ("radam", "lookahead_adam", "adamw", "sgd", "momentum", "lookahead_fusedradam"):
        create_optimizer(name)
    for name in ("nadam", "lamb", "adafactor", "lookahead_novograd"):
        with pytest.raises(KeyError):
            create_optimizer(name)


# -------------------------------------------------------------------- fit

def _fit_config(cls, log_dir):
    # min_delta 1.0 and a plateau threshold of 0.5 make every epoch after the
    # first count as "not improved", so the plateau reduction (epoch 2) and
    # the early stop (after epoch 3) both fire inside a 4-epoch run
    return cls(epochs=20, patience=3, min_delta=1.0, reduce_lr_every=1, reduce_lr_patience=0,
               plateau_threshold=0.5, reduce_lr_factor=0.5, min_lr_scale=1e-9, log_dir=str(log_dir),
               train_deterministic=True, epoch_figures=False, export_topk_tiles=False, seed=3)


def _rows(log_dir):
    lines = (Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "val_loss" in r]


def test_fit_matches_the_jax_trainer(tmp_path):
    """Trainer.fit from the same carried weights on identical batches: the
    metrics.jsonl rows agree epoch for epoch, and both control-flow events
    (a plateau reduction, the early stop) fire inside the run."""
    jdm, tdm = _modules(seed=11, synthetic=_synthetic(n_train=6, n_val=10))
    params = jax.device_get(_jax_params(seed=1))  # numpy: the JAX step donates its inputs
    jtx = jax_create_optimizer("lookahead_radam", lr=LR, weight_decay=WD, grad_accum_steps=ACC)
    jtr = JaxTrainer(JaxTransMIL(N_CLS, IN_F, OUT_F), jtx, jdm, n_classes=N_CLS,
                     loss_fn=jlosses.create_loss(),
                     config=_fit_config(JaxTrainerConfig, tmp_path / "jax"))
    jtr.params = jax.tree.map(jnp.asarray, params)  # TransMIL has no other collection
    jtr.opt_state = jtr.tx.init(params)
    jtr.fit()

    ttx = create_optimizer("lookahead_radam", lr=LR, weight_decay=WD, grad_accum_steps=ACC)
    ttr = Trainer(_port_model(params), ttx, tdm, n_classes=N_CLS, loss_fn=tlosses.create_loss(),
                  config=_fit_config(TrainerConfig, tmp_path / "port"))
    ttr.fit()
    summary = ttr.test()

    jrows, trows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(jrows) == len(trows) == 4, (len(jrows), len(trows))
    scales = [r["lr_scale"] for r in trows]
    np.testing.assert_allclose(scales, [r["lr_scale"] for r in jrows], rtol=1e-6)
    assert min(scales) < 1.0, "no plateau reduction inside the run"
    for jr, tr in zip(jrows, trows):
        assert set(jr) == set(tr)
        assert abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4
        assert abs(jr["loss"] - tr["loss"]) <= 1e-4
        assert abs(jr["val_auc"] - tr["val_auc"]) <= AUC_TOL
        assert abs(jr["val_patient_auc"] - tr["val_patient_auc"]) <= AUC_TOL
    assert np.isfinite(summary["test_loss"]) and 0.0 <= summary["test_auc"] <= 1.0
    for name in ("TEST_RESULT_PATIENT.csv", "TEST_RESULT_SLIDE.csv", "val_thresholds.csv",
                 "test_metrics.json", "checkpoints/last.ckpt"):
        assert (tmp_path / "port" / name).exists(), name


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, tdm = _modules()
    model = create_model("TransMIL", N_CLS, IN_F, OUT_F, device="cpu")
    for over in ({"swa": True}, {"autosave_steps": 5}, {"use_tensorboard": True},
                 {"tile_level": True}, {"ckpt_backend": "orbax"}):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            Trainer(model, create_optimizer(), tdm, n_classes=N_CLS,
                    loss_fn=tlosses.create_loss(),
                    config=TrainerConfig(log_dir=str(tmp_path), **over))


def test_trainer_config_has_the_jax_fields_and_defaults():
    import dataclasses

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(TrainerConfig) == fields(JaxTrainerConfig)
