"""The port's config reader, k-fold splits and optimizer-from-config against
the JAX package's, on the CPU.

- every YAML file under ``transmil_deepgraft_tpu/configs/`` reads and
  finalizes to the same tree (``to_dict()`` equal);
- ``kfold_splits`` equals scikit-learn's ``KFold(shuffle=True)``, which the
  JAX package calls (the port does not depend on scikit-learn);
- ``create_optimizer_from_config`` follows the JAX optax chain step for step
  within 1e-6 for every ``opt`` spelling the configs use, on fixed gradients
  (so that only the update rule is compared).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.model_selection import KFold

from transmil_deepgraft_tpu.train.optimizers import (
    create_optimizer_from_config as jax_optimizer_from_config,
)
from transmil_deepgraft_tpu.utils import config as jconfig
from transmil_deepgraft_tpu_torch.train.kfold import kfold_splits
from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer_from_config
from transmil_deepgraft_tpu_torch.utils import config as tconfig

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "transmil_deepgraft_tpu" / "configs")
                 .rglob("*.yaml"))


def test_every_config_is_found():
    assert len(CONFIGS) == 77


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_config_reads_and_finalizes_as_jax(path):
    for stage, fold in (("train", None), ("test", 2)):
        trees = [mod.finalize_config(mod.read_yaml(path), config_path=path, stage=stage, fold=fold,
                                     fine_tune=stage == "test").to_dict()
                 for mod in (jconfig, tconfig)]
        assert trees[0] == trees[1]


def test_config_semantics_match_jax():
    for mod in (jconfig, tconfig):
        cfg = mod.Config({"General": {"seed": 1}, "Data": {"data_dir": "/homeStor1/x/data",
                                                          "label_file": "/data/l.json"}})
        assert not cfg.Model.name and "Model" not in cfg  # missing reads empty, stores nothing
        assert (cfg.General.missing or 7) == 7
        mod.check_home(cfg, home="data")
        assert cfg.Data.data_dir == "/data/x/data" and cfg.Data.label_file == "/data/l.json"
        assert mod.derive_task_from_config_path("a/TransMIL_feat_norm_rest-v2.yaml") == "norm_rest"
        assert mod.in_features_for_extractor("ctranspath") == 784
    assert tconfig.FEATURE_EXTRACTOR_DIMS == jconfig.FEATURE_EXTRACTOR_DIMS


@pytest.mark.parametrize("n, k", [(5, 3), (5, 5), (7, 3), (7, 5), (32, 3), (32, 5)])
def test_kfold_splits_equal_sklearn(n, k):
    for seed in (0, 2021):
        want = list(KFold(n_splits=k, shuffle=True, random_state=seed).split(np.arange(n)))
        got = kfold_splits(n, k, seed)
        assert len(got) == len(want) == k
        for (gt, gv), (wt, wv) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)


OPT_SECTIONS = {
    "lookahead_radam": {"opt": "lookahead_radam", "lr": 2e-4, "weight_decay": 0.01},
    "radam": {"opt": "radam", "lr": 1e-4, "weight_decay": 0.01},
    "Adam": {"opt": "Adam", "lr": 2e-4, "weight_decay": 0.01},
    "adam": {"opt": "adam", "lr": 2e-4, "weight_decay": 0.01, "opt_betas": [0.8, 0.99]},
    "adamw": {"opt": "adamw", "lr": 1e-3, "weight_decay": 0.05, "opt_eps": 1e-6},
}


@pytest.mark.parametrize("spelling", list(OPT_SECTIONS))
def test_optimizer_from_config_follows_jax(spelling):
    """14 micro-steps at grad_acc 2 on fixed gradients: RAdam's rectified
    branch starts at inner step 6, lookahead syncs at step 6."""
    section = {"opt_eps": None, "opt_betas": None, "momentum": None, **OPT_SECTIONS[spelling]}
    r = np.random.default_rng(3)
    params = {"w": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal(3).astype(np.float32)}
    grads = [{k: r.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(14)]
    jtx = jax_optimizer_from_config(jconfig.Config(section), grad_accum_steps=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jtx.init(jp)
    tp = [torch.tensor(params[k]) for k in ("w", "b")]
    ttx = create_optimizer_from_config(tconfig.Config(section), grad_accum_steps=2)
    ttx.init(tp)
    @jax.jit
    def jax_step(g, state, jp):
        updates, state = jtx.update(g, state, jp)
        return optax.apply_updates(jp, updates), state

    for g in grads:
        jp, state = jax_step({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.tensor(g[k])
        ttx.step()
        for p, k in zip(tp, ("w", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_optimizer_from_config_refuses_unported_rules():
    for name in ("nadam", "lamb", "lookahead_adafactor"):
        with pytest.raises(KeyError, match="ROADMAP A5"):
            create_optimizer_from_config(tconfig.Config({"opt": name, "lr": 1e-3}))
