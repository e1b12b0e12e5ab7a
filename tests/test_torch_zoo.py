"""The rest of the bag-head zoo (CLAM_SB/MB, DTFD, MDMIL, DSMIL) and the
spatial heads (CTMIL, SpatialResNetMIL) against the JAX package's modules,
on the CPU.

Each head runs on the same numpy-seeded input and the same flax params,
carried across with ``head_state_dict_from_jax``: eval logits, the
``return_attn`` outputs and CLAM's instance losses within 1e-5 in float32
(the PARITY.md bar is 1e-3); the BatchNorm heads' train-mode forward and
running statistics within the bounds stated at their test. Also: the frozen
torch-parity fixtures and the reference ``.pth`` converters, the spatial
dataset's volumes byte for byte, a DTFD fit against JAX's Trainer +
``create_dtfd_optimizer`` across the LR milestone, and the two reference
faults the port does not copy (ROADMAP C8, C9).
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ref import builders
from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JaxDataModule
from transmil_deepgraft_tpu.data.local_features import LocalFeatureBagDataset as JaxLocal
from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.models.spatial_resnet import SpatialResNetMIL as JaxSpatialResNet
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.optimizers import create_dtfd_optimizer as jax_dtfd_optimizer
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu.train.trainer import Trainer as JaxTrainer
from transmil_deepgraft_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from transmil_deepgraft_tpu.train.trainer import _get_lr_scale
from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.data.local_features import LocalFeatureBagDataset
from transmil_deepgraft_tpu_torch.models import create_model, head_logits
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.optimizers import create_dtfd_optimizer, create_optimizer
from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
from transmil_deepgraft_tpu_torch.utils import torch_weights as ttw
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    head_knobs_from_params, head_state_dict_from_jax, optimizer_state_from_jax, unflatten)

TOL = 1e-5
FIXTURE_TOL = 1e-3
FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_tree(shapes, rng):
    """Random leaves on ``shapes``: scales and variances around 1 (so biases
    and statistics count), conv kernels at flax's lecun-normal scale (so a
    ResNet's activations stay O(1)), the rest at 0.1."""
    def leaf(path, a):
        if path[-1].key == "kernel" and len(a.shape) == 4:
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(
                np.float32)
        base = 1.0 if path[-1].key in ("scale", "var") else 0.0
        noise = rng.random(a.shape) if path[-1].key == "var" else rng.standard_normal(a.shape)
        return (base + 0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port(name, params, in_f, out_f, n_classes=3, stats=None, **knobs):
    """The port's head on the flax ``params`` (and ``stats``), with the
    knobs the params show (CLAM's instance classifiers) and ``knobs``."""
    model = create_model(name, n_classes, in_f, out_f, device="cpu",
                         **head_knobs_from_params(name, params, knobs))
    model.load_state_dict(head_state_dict_from_jax(name, params, in_f, stats))
    return model.eval()


# --------------------------------------------------------------- bag heads

# name: (in_features, out_features, input shape, flax init kwargs)
BAG_CASES = {
    "CLAM_SB": (48, 512, (1, 40, 48), {"label": jnp.asarray(1), "instance_eval": True}),
    "CLAM_MB": (48, 512, (1, 40, 48), {"label": jnp.asarray(1), "instance_eval": True}),
    # 300 real rows in the 512 bucket: 4 pseudo-bags of 120, 180 rows of them zero pads
    "DTFD": (48, 512, (1, 512, 48), {}),
    "MDMIL": (48, 64, (1, 70, 48), {}),
    "DSMIL": (48, 512, (2, 30, 48), {}),
}


def _bag_input(name):
    x = np.random.default_rng(0).standard_normal(BAG_CASES[name][2]).astype(np.float32)
    if name == "DTFD":
        x[:, 300:] = 0.0
    return x


@functools.lru_cache(maxsize=None)
def _jax_bag_case(name, subtyping=False):
    """(input, params, jitted apply) of the JAX head, built once a case."""
    in_f, out_f, _, init_kw = BAG_CASES[name]
    knobs = {"subtyping": subtyping} if name.startswith("CLAM") else {}
    model = jax_create_model(name, 3, in_f, out_f, **knobs)
    x = _bag_input(name)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.asarray(x), **init_kw))
    params = _random_tree(shapes["params"], np.random.default_rng(1))
    apply = jax.jit(functools.partial(model.apply), static_argnames=(
        "return_attn", "instance_eval", "deterministic"))
    return x, params, apply


@pytest.mark.parametrize("name", sorted(BAG_CASES))
def test_bag_head_matches_jax(name):
    """Eval logits (through ``head_logits``, as serving and the Trainer
    take them) and the ``return_attn`` outputs."""
    in_f, out_f, _, _ = BAG_CASES[name]
    x, params, apply = _jax_bag_case(name)
    v = {"params": params}
    model = _port(name, jax.device_get(params), in_f, out_f)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if name == "DTFD":
            want_sub, want = apply(v, x)
            sub, got = model(xt)
            np.testing.assert_allclose(sub.numpy(), np.asarray(want_sub), atol=TOL, rtol=0)
            _, _, want_attn = apply(v, x, return_attn=True)
            assert sub.shape == (4, 3)
            np.testing.assert_allclose(model(xt, return_attn=True)[2].numpy(),
                                       np.asarray(want_attn), atol=TOL, rtol=0)
        else:
            want_logits, want_attn = apply(v, x, return_attn=True)
            logits, attn = model(xt, return_attn=True)
            if name == "MDMIL":
                want = want_logits  # JAX's default forward returns the attention too
                attn, want_attn = attn.tile_scores(), want_attn.tile_scores()
            else:
                want = apply(v, x)
            np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=0)
            np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=TOL, rtol=0)
        got = head_logits(model, xt)  # MDMIL: the fused TransLayers' plain versions here
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("subtyping", [False, True], ids=["plain", "subtyping"])
@pytest.mark.parametrize("name", ["CLAM_SB", "CLAM_MB"])
def test_clam_instance_eval_matches_jax(name, subtyping):
    """The top-k / bottom-k instance losses for every label. The seeded
    normal bag has no tied attention scores (``lax.top_k`` and
    ``torch.topk`` may order ties differently)."""
    in_f, out_f, _, _ = BAG_CASES[name]
    x, params, apply = _jax_bag_case(name, subtyping)
    model = _port(name, jax.device_get(params), in_f, out_f, subtyping=subtyping)
    scores = model.attention_net(torch.from_numpy(x[0]))
    assert len(torch.unique(scores)) == scores.numel()  # tie-free
    for label in range(3):
        want_logits, want_loss = apply({"params": params}, x, label=jnp.asarray(label),
                                       instance_eval=True)
        with torch.no_grad():
            logits, loss = model(torch.from_numpy(x), label=torch.tensor(label),
                                 instance_eval=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=0)
        assert abs(loss.item() - float(want_loss)) <= TOL, (label, loss.item(), want_loss)


def test_dsmil_lengths_and_the_bucket_pad_match_jax():
    """With ``lengths`` the pad rows are masked; without, zero pad rows share
    the instance classifier's bias as their logit and take part in the
    argmax, in both packages alike."""
    in_f, out_f, _, _ = BAG_CASES["DSMIL"]
    x, params, apply = _jax_bag_case("DSMIL")
    padded = np.concatenate([x, np.zeros((2, 34, in_f), np.float32)], axis=1)  # bucket 64
    lengths = np.array([30, 21], np.int32)
    padded[1, 21:30] = 0.0
    model = _port("DSMIL", jax.device_get(params), in_f, out_f)
    for kw in ({"lengths": lengths}, {}):
        want, want_attn = apply({"params": params}, padded, return_attn=True, **kw)
        with torch.no_grad():
            got, attn = model(torch.from_numpy(padded), return_attn=True,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=TOL, rtol=0)
    with torch.no_grad():
        masked = model(torch.from_numpy(padded), lengths=torch.from_numpy(lengths))
        exact = model(torch.from_numpy(x[:1]))
    np.testing.assert_allclose(masked[:1].numpy(), exact.numpy(), atol=TOL, rtol=0)


def test_clam_refuses_a_batch_where_jax_keeps_bag_0():
    """ROADMAP C8: JAX's CLAM takes ``h[0]`` of a (3, N, D) batch and
    returns one bag's logits; the port raises."""
    x, params, apply = _jax_bag_case("CLAM_SB")
    batch = np.repeat(x, 3, axis=0)
    assert np.asarray(apply({"params": params}, batch)).shape == (1, 3)
    model = _port("CLAM_SB", jax.device_get(params), 48, 512)
    with pytest.raises(ValueError, match="one bag at a time"):
        model(torch.from_numpy(batch))


def test_jax_trainer_cannot_train_mdmil(tmp_path):
    """ROADMAP C9: MDMIL's forward returns (logits, attention) by default,
    and JAX's Trainer hands the tuple to the loss; the port's Trainer
    refuses MDMIL up front."""
    dm_args = dict(n_classes=2, max_bag_size=9, batch_size=1, seed=0,
                   synthetic={"n_train": 2, "n_val": 2, "n_test": 2, "bag_size": 9,
                              "feature_size": 8})
    jmodel = jax_create_model("MDMIL", 2, 8, 16)
    jtr = JaxTrainer(jmodel, jax_create_optimizer("adam"), JaxDataModule(**dm_args), n_classes=2,
                     loss_fn=jlosses.create_loss(), model_name="MDMIL",
                     config=JaxTrainerConfig(epochs=1, log_dir=str(tmp_path / "jax"),
                                             epoch_figures=False, export_topk_tiles=False))
    jtr.params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 9, 8)))["params"]
    jtr.opt_state = jtr.tx.init(jtr.params)
    with pytest.raises(TypeError, match="log_softmax"):
        jtr.fit()
    with pytest.raises(NotImplementedError, match="ROADMAP C9"):
        Trainer(create_model("MDMIL", 2, 8, 16, device="cpu"), create_optimizer("adam"),
                MILDataModule(**dm_args), n_classes=2, loss_fn=tlosses.create_loss(),
                model_name="MDMIL", config=TrainerConfig(log_dir=str(tmp_path / "port")))


@pytest.mark.parametrize("name", ["CLAM_SB", "CLAM_MB", "DTFD", "DTFDMIL", "MDMIL", "DSMIL",
                                  "CTMIL", "resnet50"])
def test_create_model_builds_on_cuda_by_default(name):
    """No device means CUDA, which this machine lacks: the entry point
    raises instead of falling back to the CPU; asked for, the CPU builds."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(name, 2, 32)
    model = create_model(name, 2, 32, 64, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


# ------------------------------------------------------------ spatial heads

@functools.lru_cache(maxsize=None)
def _jax_spatial_case(name):
    """(volume, variables, eval apply, train apply) of a spatial head:
    CTMIL 32 -> 16 -> 64 on 12 x 12 (3 x 3 tokens), SpatialResNetMIL at
    16 channels on the configs' 50 x 50 (stages at 25, 13, 7, 4, 2). The
    train apply returns (logits, new batch_stats, the BatchNorm outputs of
    CTMIL's two stages)."""
    if name == "CTMIL":
        model, shape = jax_create_model("CTMIL", 3, 32, 64), (2, 12, 12, 32)
    else:
        model, shape = JaxSpatialResNet(n_classes=3, in_features=16), (2, 50, 50, 16)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.asarray(x)))
    variables = _random_tree(dict(shapes), np.random.default_rng(3))
    evaluate = jax.jit(lambda v, x: model.apply(v, x))

    @jax.jit
    def train(v, x):
        out, new = model.apply(v, x, deterministic=False, rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats", "intermediates"],
                               capture_intermediates=lambda m, _: m.name in ("bn1", "bn2"))
        bn = [new["intermediates"][k]["__call__"][0] for k in ("bn1", "bn2")
              if k in new["intermediates"]]
        return out, new["batch_stats"], bn

    return x, variables, evaluate, train


def _spatial_port(name, variables):
    params, stats = jax.device_get(variables["params"]), jax.device_get(variables["batch_stats"])
    return _port(name, params, 32 if name == "CTMIL" else 16, 64, stats=stats)


@pytest.mark.parametrize("name", ["CTMIL", "resnet50"])
def test_spatial_head_eval_matches_jax(name):
    """Eval mode: the running statistics carried across."""
    x, variables, evaluate, _ = _jax_spatial_case(name)
    model = _spatial_port(name, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(evaluate(variables, x)), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["CTMIL", "resnet50"])
def test_spatial_head_train_mode_matches_jax_batch_stats(name):
    """Train mode against JAX's ``mutable=['batch_stats']`` apply (the JAX
    Trainer cannot train these heads, ROADMAP C6): the batch statistics
    normalize, and the new running mean and biased variance follow flax's
    momentum (0.99 CTMIL, 0.9 ResNet). CTMIL's TransLayers drop out in train
    mode (masks the packages cannot share), so its two BatchNorm stages'
    outputs are held, within 1e-5. SpatialResNetMIL's logits: its last stage
    normalizes over 8 values a channel (batch 2 at 2 x 2), which amplifies
    float32 rounding, so both packages land ~1e-3 from a float64 forward of
    the same weights; the bound is 5e-3 to JAX, and the port no farther from
    float64 than twice JAX's own distance. The new running statistics (of
    order 0.1 to 1) within 1e-5 (CTMIL) and 1e-4 (the ResNet's deep
    layers, whose batch variances carry the same amplification)."""
    x, variables, _, train = _jax_spatial_case(name)
    want, new_stats, want_bn = train(variables, x)
    model = _spatial_port(name, variables).train()
    got_bn = []
    if name == "CTMIL":
        for stage in (model.conv1, model.conv2):
            stage[1].register_forward_hook(
                lambda m, i, o: got_bn.append(o.permute(0, 2, 3, 1).numpy()))
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if name == "CTMIL":
        assert len(got_bn) == len(want_bn) == 2
        for g, w in zip(got_bn, want_bn):
            np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)
    else:
        with torch.no_grad():  # the referee: the same weights and formulas in float64
            ref64 = _spatial_port(name, variables).double().train()
            f64 = ref64.fc(ref64.resnet(torch.from_numpy(x).double())).numpy()
        port_err, jax_err = np.abs(got.numpy() - f64).max(), np.abs(np.asarray(want) - f64).max()
        assert port_err <= 2 * jax_err + TOL, (port_err, jax_err)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=0)
    ref = head_state_dict_from_jax(name, jax.device_get(variables["params"]),
                                   32 if name == "CTMIL" else 16, jax.device_get(new_stats))
    sd = model.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == (4 if name == "CTMIL" else 106)
    tol = TOL if name == "CTMIL" else 1e-4
    for key in stats:
        np.testing.assert_allclose(sd[key].numpy(), ref[key].numpy(), rtol=0, atol=tol,
                                   err_msg=key)
    assert int(sd[stats[0].replace("running_mean", "num_batches_tracked")]) == 1


# ---------------------------------------------- fixtures and the converters

@pytest.mark.parametrize("fixture", ["clam_sb", "clam_mb", "dtfd", "mdmil", "ctmil"])
def test_frozen_fixture_and_converter(fixture):
    """The recorded torch reference forward through the port on the
    fixture's flax params (1e-3), and the port's ``.pth`` converter on the
    torch reference model: the same flax tree as JAX's converter, which the
    port's head then runs to the reference's logits."""
    name = {"clam_sb": "CLAM_SB", "clam_mb": "CLAM_MB", "dtfd": "DTFD", "mdmil": "MDMIL",
            "ctmil": "CTMIL"}[fixture]
    with np.load(FIXTURES / f"parity_{fixture}.npz") as z:
        params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
        stats = unflatten({k[5:]: z[k] for k in z.files if k.startswith("stat:")}) or None
        bag, want = z["bag"], z["out:logits"]
        inst = z["out:inst_loss"] if "out:inst_loss" in z.files else None
    in_f, n_classes = bag.shape[-1], want.shape[-1]
    model = _port(name, params, in_f, 512, n_classes=n_classes, stats=stats,
                  **({"subtyping": True} if fixture.startswith("clam") else {}))
    with torch.no_grad():
        if inst is not None:
            got, loss = model(torch.from_numpy(bag), label=torch.tensor(1 % n_classes),
                              instance_eval=True)
            assert abs(loss.item() - float(inst)) <= FIXTURE_TOL
        else:
            got = head_logits(model, torch.from_numpy(bag))
    np.testing.assert_allclose(got.numpy(), want, atol=FIXTURE_TOL, rtol=0)

    ref = builders.build_torch(fixture, seed=5)
    sd = ref.state_dict()
    port = {"clam_sb": lambda: ttw.convert_clam_state_dict(sd, n_classes),
            "clam_mb": lambda: ttw.convert_clam_state_dict(sd, n_classes),
            "dtfd": lambda: ttw.convert_dtfd_state_dict(sd),
            "mdmil": lambda: ttw.convert_mdmil_state_dict(sd),
            "ctmil": lambda: ttw.convert_ctmil_state_dict(sd)}[fixture]()
    jax_tree = builders.convert(fixture, sd)
    for part in jax_tree:
        want_leaves = jax.tree_util.tree_leaves_with_path(jax_tree[part])
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(port[part]))
        assert len(want_leaves) == len(got_leaves), part
        for path, leaf in want_leaves:
            np.testing.assert_array_equal(np.asarray(got_leaves[path]), np.asarray(leaf))
    model = _port(name, port["params"], in_f, 512, n_classes=n_classes,
                  stats=port.get("batch_stats"))
    with torch.no_grad():
        got = head_logits(model, torch.from_numpy(bag))
    np.testing.assert_allclose(got.numpy(), builders.torch_forward(fixture, ref, bag)["logits"],
                               atol=FIXTURE_TOL, rtol=0)


# ---------------------------------------------------------- spatial dataset

def _h5_cohort(root, rng, n_slides=6, dim=8):
    """Per-slide .h5 bags with tile grid coords (some past the 12-wide
    window), a label JSON, a patient map."""
    import h5py

    data = root / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels = {"train": [], "val": [], "test": []}
    for i in range(n_slides):
        split = ("train", "train", "train", "train", "val", "test")[i]
        n = int(rng.integers(20, 60))
        coords = np.stack([rng.choice(30, n), rng.choice(20, n)], -1).astype(np.int64)
        with h5py.File(data / f"s{i}.h5", "w") as f:
            f["features"] = rng.standard_normal((n, dim)).astype(np.float32)
            f["coords"] = coords
        labels[split].append([f"FEATURES_RETCCL_2048/s{i}.h5", i % 2])
    (root / "labels.json").write_text(json.dumps(labels))
    return root, root / "labels.json"


def test_local_feature_volumes_are_byte_identical_to_jax(tmp_path):
    """The spatial variant: a random window in train mode, centred in val,
    the same numpy draws; the datamodule's batches too."""
    data_dir, labels = _h5_cohort(tmp_path, np.random.default_rng(4))
    for mode in ("train", "val"):
        jds = JaxLocal(data_dir, labels, mode, 2, window=12)
        tds = LocalFeatureBagDataset(data_dir, labels, mode, 2, window=12)
        jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
        for i in range(len(jds)):
            (jv, jy, (jn, jc, _)), (tv, ty, (tn, tc, _)) = (jds.get_item(i, jrng),
                                                            tds.get_item(i, trng))
            assert jv.shape == (12, 12, 8) and jv.tobytes() == tv.tobytes()
            assert (jy, jn) == (ty, tn) and np.array_equal(jc, tc)
    args = dict(n_classes=2, batch_size=2, seed=5, variant="spatial")
    jdm = JaxDataModule(str(data_dir), str(labels), **args)
    tdm = MILDataModule(str(data_dir), str(labels), **args)
    for jb, tb in zip(jdm.train_batches(1), tdm.train_batches(1)):
        assert jb.bags.shape == (2, 50, 50, 8) and jb.bags.tobytes() == tb.bags.tobytes()
        assert jb.names == tb.names and np.array_equal(jb.labels, tb.labels)


# --------------------------------------------------------------- DTFD fit

DTFD_IN = 32


def _dtfd_fit_config(cls, log_dir):
    return cls(epochs=4, patience=10, reduce_lr_every=1, reduce_lr_patience=0,
               plateau_threshold=0.5, reduce_lr_factor=0.5, min_lr_scale=1e-9,
               log_dir=str(log_dir), train_deterministic=True, epoch_figures=False,
               export_topk_tiles=False, seed=3)


def test_dtfd_fit_matches_the_jax_trainer(tmp_path):
    """DTFD through both Trainers with ``create_dtfd_optimizer`` (lr 1e-3,
    the milestone at epoch 2 of 4: 5 steps an epoch, boundary at update 10)
    under ``train_deterministic`` (pseudo-bags in order): per-epoch loss and
    val_loss within 1e-4, lr_scale (the plateau on top) exactly, final
    parameters within 1e-4; JAX's ``last.ckpt`` then resumes in the port
    with its two Adam states."""
    syn = {"n_train": 5, "n_val": 6, "n_test": 4, "bag_size": 260, "feature_size": DTFD_IN,
           "signal": 0.8, "variable_bags": False}
    args = dict(n_classes=2, max_bag_size=256, batch_size=1, synthetic=syn, seed=11)
    jmodel = jax_create_model("DTFD", 2, DTFD_IN)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 256, DTFD_IN))))
    params = _random_tree(shapes["params"], np.random.default_rng(6))
    jtx = jax_dtfd_optimizer(5, lr=1e-3, milestone_epochs=(2,))
    jtr = JaxTrainer(jmodel, jtx, JaxDataModule(**args), n_classes=2,
                     loss_fn=jlosses.create_loss(), model_name="DTFD",
                     config=_dtfd_fit_config(JaxTrainerConfig, tmp_path / "jax"))
    jtr.params = jax.tree.map(jnp.asarray, params)
    jtr.opt_state = jtr.tx.init(jtr.params)
    jtr.fit()

    model = _port("DTFD", params, DTFD_IN, 512, n_classes=2)
    ttr = Trainer(model, create_dtfd_optimizer(5, lr=1e-3, milestone_epochs=(2,)),
                  MILDataModule(**args), n_classes=2, loss_fn=tlosses.create_loss(),
                  model_name="DTFD", config=_dtfd_fit_config(TrainerConfig, tmp_path / "port"))
    ttr.fit()

    def rows(d):
        return [r for r in map(json.loads, (d / "metrics.jsonl").read_text().splitlines())
                if "val_loss" in r]

    jrows, trows = rows(tmp_path / "jax"), rows(tmp_path / "port")
    assert len(jrows) == len(trows) == 4
    for jr, tr in zip(jrows, trows):
        assert abs(jr["loss"] - tr["loss"]) <= 1e-4 and abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4
        assert jr["lr_scale"] == pytest.approx(tr["lr_scale"], rel=1e-6)
    want = head_state_dict_from_jax("DTFD", jax.device_get(jtr.params), DTFD_IN)
    for key, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
    assert ttr.tx.tiers[0].count == ttr.tx.tiers[1].count == 20

    resumed = Trainer(_port("DTFD", params, DTFD_IN, 512, n_classes=2),
                      create_dtfd_optimizer(5, lr=1e-3, milestone_epochs=(2,)),
                      MILDataModule(**args), n_classes=2, loss_fn=tlosses.create_loss(),
                      model_name="DTFD", config=_dtfd_fit_config(TrainerConfig, tmp_path / "r"))
    assert resumed.load_train_state(tmp_path / "jax" / "checkpoints" / "last.ckpt")
    names = [n for n, _ in resumed.model.named_parameters()]
    state = optimizer_state_from_jax(jax.device_get(jtr.opt_state), DTFD_IN, names, "DTFD")
    for tier, key in zip(resumed.tx.tiers, ("tier1", "tier2")):
        assert tier.count == state[key]["count"] == 20
        for got, ref in zip(tier.mu + tier.nu, state[key]["mu"] + state[key]["nu"]):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert resumed.tx.lr_scale == pytest.approx(_get_lr_scale(jtr.opt_state), rel=1e-6)
    assert resumed.tx.lr_scale < 1.0  # the plateau fired inside the run
