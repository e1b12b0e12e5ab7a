"""The port's MIL heads besides TransMIL (AttMIL, TransformerMIL, Chowder,
RoFormerMIL, AttTrans/MonaiMIL) against the JAX package's modules, on the CPU.

Each head runs on the same numpy-seeded bag and the same flax params, carried
across with ``head_state_dict_from_jax``: logits and ``return_attn`` within
1e-5 in float32 (the PARITY.md bar is 1e-3), for every fc1 branch, both
RoFormerMIL modes and the four MONAI modes. Also: the frozen torch-parity
fixtures (1e-3), one lookahead_radam step per head after a carried optimizer
state (loss and parameters within 1e-4), the pooling ops, the reference
``.pth`` converters, RoFormerMIL's coordinate invariances, and
``create_model``'s rules.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.ops import pooling as jpool
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu.utils import torch_weights as jtw
from transmil_deepgraft_tpu_torch.data.coords import grid_coords, normalize_pad_coords
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.ops import pooling as tpool
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
from transmil_deepgraft_tpu_torch.utils import torch_weights as ttw
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    head_state_dict_from_jax, optimizer_state_from_jax, unflatten)

TOL = 1e-5
# TransformerMIL's four full-width pre-norm layers: the float32 sums of the two
# packages drift apart by a few 1e-5 at these weights (each is as far from a
# float64 forward of the same weights), a tenth of the PARITY.md bar
TRANSFORMER_TOL = 1e-4
FIXTURE_TOL = 1e-3
STEP_TOL = 1e-4
FIXTURES = Path(__file__).parent / "fixtures"
SMALL_ROFORMER = {"depth": 2, "heads": 4, "dim_head": 16, "mlp_dim": 64}

# (model name, in_features, out_features, knobs, n tiles)
CASES = {
    "attmil_2048": ("AttMIL", 2048, 512, {}, 24),
    "attmil_96": ("AttMIL", 96, 64, {}, 31),
    "transformer_mil_2048": ("TransformerMIL", 2048, 512, {}, 20),
    "transformer_mil_1024": ("TransformerMIL", 1024, 512, {}, 17),
    "transformer_mil_768": ("TransformerMIL", 768, 512, {}, 23),
    "transformer_mil_512_mean": ("TransformerMIL", 512, 1024, {"pool": "mean"}, 19),
    "chowder": ("Chowder", 512, 512, {}, 33),
    "roformer_2048_exact": ("RoFormerMIL", 2048, 64, SMALL_ROFORMER, 29),
    "roformer_96_nystrom": ("RoFormerMIL", 96, 64, {**SMALL_ROFORMER, "num_landmarks": 8}, 37),
    **{f"monai_{m}": ("AttTrans", 64, 512, {"mil_mode": m, "trans_blocks": 2}, 21)
       for m in ("mean", "max", "att", "att_trans")},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_params(model, args, rng):
    """The head's params, every leaf random (LayerNorm scales around 1, so
    biases count), on the shapes of its init (traced, not run)."""
    def leaf(path, a):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(name, n, in_features, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n, in_features)).astype(np.float32)
    coords = rng.integers(30, 90, (batch, n, 2)).astype(np.float32)
    return x, (coords if name == "RoFormerMIL" else None)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(bag, coords, params, logits, attention logits, attention scores) of
    the JAX head, computed once per case."""
    name, in_f, out_f, knobs, n = CASES[case]
    x, coords = _inputs(name, n, in_f)
    model = jax_create_model(name, 3, in_f, out_f, **knobs)
    args = (jnp.asarray(x),) + (() if coords is None else (jnp.asarray(coords),))
    params = _random_params(model, args, np.random.default_rng(1))
    # jitted: one compile a forward, where op-by-op dispatch compiles each op
    logits = np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(params, *args))
    attn_logits, attn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, return_attn=True))(
        params, *args)
    if attn is not None:
        attn = np.asarray(attn.tile_scores() if hasattr(attn, "tile_scores") else attn)
    return x, coords, params, logits, np.asarray(attn_logits), attn


def _port(name, params, in_f, out_f, knobs, n_classes=3):
    model = create_model(name, n_classes, in_f, out_f, device="cpu", **knobs)
    model.load_state_dict(head_state_dict_from_jax(name, params, in_f))
    return model.eval()


@pytest.mark.parametrize("case", sorted(CASES))
def test_head_matches_jax(case):
    name, in_f, out_f, knobs, _ = CASES[case]
    x, coords, params, want, want_attn_logits, want_attn = _jax_case(case)
    tol = TRANSFORMER_TOL if name == "TransformerMIL" else TOL
    model = _port(name, params, in_f, out_f, knobs)
    args = (torch.from_numpy(x),) + (() if coords is None else (torch.from_numpy(coords),))
    with torch.no_grad():
        got = model(*args).numpy()
        logits, attn = model(*args, return_attn=True)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(logits.numpy(), want_attn_logits, atol=tol, rtol=0)
    if want_attn is None:
        assert attn is None
    else:
        scores = attn.tile_scores() if hasattr(attn, "tile_scores") else attn
        assert tuple(scores.shape) == want_attn.shape
        np.testing.assert_allclose(scores.numpy(), want_attn, atol=TOL, rtol=0)


@pytest.mark.parametrize("fixture", ["attmil_2048", "attmil_1024", "transformer_mil_2048",
                                     "transformer_mil_1024", "chowder"])
def test_frozen_torch_fixture(fixture):
    """The recorded torch reference forward of each fixture, through the
    port on the fixture's converted flax params."""
    name = {"attmil": "AttMIL", "transformer": "TransformerMIL", "chowder": "Chowder"}[
        fixture.split("_")[0]]
    with np.load(FIXTURES / f"parity_{fixture}.npz") as z:
        params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
        bag, want = z["bag"], z["out:logits"]
    in_f = bag.shape[-1]
    model = create_model(name, want.shape[-1], in_f, device="cpu")
    model.load_state_dict(head_state_dict_from_jax(name, params, in_f))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(bag)).numpy()
    np.testing.assert_allclose(got, want, atol=FIXTURE_TOL, rtol=0)


# ------------------------------------------------------------ train step

STEP_HEADS = {
    "AttMIL": (48, 32, {}),
    "TransformerMIL": (48, 64, {}),
    "Chowder": (48, 512, {}),
    "RoFormerMIL": (48, 32, {"depth": 2, "heads": 2, "dim_head": 16, "mlp_dim": 32}),
    "AttTrans": (32, 512, {"trans_blocks": 1}),
}


@pytest.mark.parametrize("name", sorted(STEP_HEADS))
def test_train_step_matches_jax(name):
    """lookahead_radam (wd 0.01, grad_acc 2), dropout off: two JAX
    micro-steps, the JAX state carried onto the port with
    ``optimizer_state_from_jax``, then two more on both sides. Loss and
    parameters within 1e-4."""
    in_f, out_f, knobs = STEP_HEADS[name]
    rng = np.random.default_rng(3)
    bags = [rng.standard_normal((2, 16, in_f)).astype(np.float32) for _ in range(4)]
    labels = [rng.integers(0, 2, 2) for _ in range(4)]
    coords = [rng.integers(0, 20, (2, 16, 2)).astype(np.float32) for _ in range(4)]
    coord_aware = name == "RoFormerMIL"
    jmodel = jax_create_model(name, 2, in_f, out_f, **knobs)
    args0 = (jnp.asarray(bags[0]),) + ((jnp.asarray(coords[0]),) if coord_aware else ())
    params = _random_params(jmodel, args0, np.random.default_rng(4))
    tx = jax_create_optimizer("lookahead_radam", lr=2e-3, weight_decay=0.01, grad_accum_steps=2)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, x, y, c):
        def loss_of(p):
            args = (x, c) if coord_aware else (x,)
            logits = jmodel.apply({"params": p}, *args, deterministic=True)
            return jlosses.cross_entropy(logits, jax.nn.one_hot(y, 2))

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(2):
        params, opt_state, _ = jax_step(params, opt_state, bags[i], labels[i], coords[i])
    model = _port(name, jax.device_get(params), in_f, out_f, knobs, n_classes=2)
    names = [n for n, _ in model.named_parameters()]
    ttx = create_optimizer("lookahead_radam", lr=2e-3, weight_decay=0.01, grad_accum_steps=2)
    ttx.init(model.parameters())
    ttx.load_state_dict(optimizer_state_from_jax(jax.device_get(opt_state), in_f, names, name))
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    for i in range(2, 4):
        params, opt_state, jloss = jax_step(params, opt_state, bags[i], labels[i], coords[i])
        for p in model.parameters():
            p.grad = None
        args = (torch.from_numpy(bags[i]),) + ((torch.from_numpy(coords[i]),)
                                               if coord_aware else ())
        loss = tlosses.cross_entropy(model(*args), torch.eye(2)[torch.from_numpy(labels[i])])
        loss.backward()
        ttx.step()
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
    want = head_state_dict_from_jax(name, jax.device_get(params), in_f)
    for key, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=STEP_TOL, rtol=0)


# ------------------------------------------------------------------- ops

def test_gated_attention_pool_with_mask_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 3, 11, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) for s in ((16, 8), (16, 8), (8, 2))]
    b = [rng.standard_normal(s).astype(np.float32) for s in ((8,), (8,), (2,))]
    mask = rng.random((2, 3, 11)) > 0.3
    mask[..., 0] = True
    want = jpool.gated_attention_pool(*map(jnp.asarray, [h, *w]), v_b=b[0], u_b=b[1],
                                      w_b=b[2], mask=jnp.asarray(mask))
    got = tpool.gated_attention_pool(*map(torch.from_numpy, [h, *w]),
                                     v_b=torch.from_numpy(b[0]), u_b=torch.from_numpy(b[1]),
                                     w_b=torch.from_numpy(b[2]), mask=torch.from_numpy(mask))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-6, rtol=0)
    assert (got[1].numpy()[np.broadcast_to(~mask[:, :, None], got[1].shape)] == 0).all()


def test_topk_minmax_scores_with_ties_matches_jax():
    rng = np.random.default_rng(6)
    scores = rng.integers(-3, 4, (4, 30)).astype(np.float32)  # many ties
    scores[0] = 1.0  # all tied
    want = np.asarray(jpool.topk_minmax_scores(jnp.asarray(scores), 5))
    got = tpool.topk_minmax_scores(torch.from_numpy(scores), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got[:, :5], axis=1) >= 0).all() and (np.diff(got[:, 5:], axis=1) <= 0).all()


# ------------------------------------------------------------- converters

def _random_state_dict(model, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name, in_f, knobs", [
    ("AttMIL", 2048, {}), ("AttMIL", 256, {}), ("TransformerMIL", 2048, {}),
    ("TransformerMIL", 1024, {}), ("TransformerMIL", 768, {}), ("Chowder", 512, {}),
    ("AttTrans", 64, {"trans_blocks": 2}), ("AttTrans", 64, {"mil_mode": "att"}),
    ("RoFormerMIL", 2048, SMALL_ROFORMER), ("RoFormerMIL", 96, SMALL_ROFORMER),
])
def test_torch_converters_round_trip(name, in_f, knobs):
    """A state dict of the port (the reference's names) -> the reference
    converter -> ``head_state_dict_from_jax`` gives it back; where the JAX
    package has the converter, the port's gives the same flax tree."""
    model = create_model(name, 2, in_f, device="cpu", **knobs)
    sd = _random_state_dict(model, 7)
    params = ttw.convert_head_state_dict({f"model.{k}": v for k, v in sd.items()}, name,
                                         in_f)["params"]
    back = head_state_dict_from_jax(name, params, in_f)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy())
    jax_conv = {"AttMIL": lambda: jtw.convert_attmil_state_dict(sd, in_f),
                "TransformerMIL": lambda: jtw.convert_transformer_mil_state_dict(sd, in_f),
                "Chowder": lambda: jtw.convert_chowder_state_dict(sd),
                "AttTrans": lambda: jtw.convert_monai_mil_state_dict(
                    sd, knobs.get("mil_mode", "att_trans"))}.get(name)
    if jax_conv is not None:
        want = jax.tree_util.tree_leaves_with_path(jax_conv()["params"])
        got = dict(jax.tree_util.tree_leaves_with_path(params))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize("ref, name, in_f", [("attmil_2048", "AttMIL", 2048),
                                             ("transformer_mil_1024", "TransformerMIL", 1024),
                                             ("chowder", "Chowder", 512)])
def test_port_state_dict_has_the_reference_names(ref, name, in_f):
    """The torch reference heads (the reference's state-dict layout) and the
    port's heads hold the same keys and shapes, so a reference ``.pth``
    loads into the port as it is."""
    from tests.torch_ref import builders

    want = builders.build_torch(ref).state_dict()
    got = create_model(name, builders.CONFIGS[ref][2], in_f, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------- RoFormerMIL

@pytest.mark.parametrize("landmarks", [0, 8], ids=["exact", "nystrom"])
def test_roformer_logits_padded_or_exact_and_translated(landmarks):
    """A bag's logits are the same with its coords as they are (the pad rows
    at the bag's minimum) or normalized and zero-padded
    (``normalize_pad_coords``), and with the whole bag translated."""
    torch.manual_seed(0)
    model = create_model("RoFormerMIL", 3, 48, 64, device="cpu", num_landmarks=landmarks,
                         **SMALL_ROFORMER).eval()
    rng = np.random.default_rng(8)
    n, target = 27, 32
    x = np.zeros((1, target, 48), np.float32)
    x[0, :n] = rng.standard_normal((n, 48))
    c = rng.integers(40, 80, (n, 2)).astype(np.float32)
    raw = np.concatenate([c, np.broadcast_to(c.min(0), (target - n, 2))])[None]
    with torch.no_grad():
        def run(coords):
            return model(torch.from_numpy(x), torch.from_numpy(np.asarray(coords, np.float32)))

        base = run(raw)
        np.testing.assert_array_equal(run(normalize_pad_coords(c, target)[None]).numpy(),
                                      base.numpy())
        np.testing.assert_array_equal(run(normalize_pad_coords(c + [300, -35], target)[None]),
                                      base.numpy())
        np.testing.assert_array_equal(run(raw + np.float32(1000)).numpy(), base.numpy())
        grid = run(grid_coords(target, 1))  # the fallback is another layout
        assert np.abs(grid.numpy() - base.numpy()).max() > 1e-4
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(), grid.numpy())


def test_create_model_rules():
    """out_features goes to the heads that take it; precision 16 makes a
    bfloat16 TransMIL and leaves the other heads in float32, as JAX does;
    att_trans_pyramid builds (its 2,304-d cascade, held to JAX in
    test_torch_backbones.py) and use_pallas off TransMIL raises."""
    x = torch.zeros(1, 12, 64)
    for name in ("AttMIL", "TransformerMIL", "Chowder", "RoFormerMIL", "AttTrans",
                 "MonaiMILModel"):
        model = create_model(name, 2, 64, 32, device="cpu", precision=16).eval()
        assert all(p.dtype == torch.float32 for p in model.parameters())
        with torch.no_grad():
            assert model(x).dtype == torch.float32
    assert create_model("TransMIL", 2, 64, 64, device="cpu", precision="16-mixed").dtype == \
        torch.bfloat16
    assert create_model("AttMIL", 2, 64, 32, device="cpu").classifier[0].in_features == 32
    assert create_model("RoFormerMIL", 2, 64, 48, device="cpu").fc2.in_features == 48
    pyramid = create_model("AttTrans", 2, 64, device="cpu", mil_mode="att_trans_pyramid",
                           trans_blocks=1)
    assert pyramid.myfc.in_features == 2304 and pyramid.gives_attention
    with pytest.raises(ValueError, match="use_pallas"):
        create_model("AttMIL", 2, 64, device="cpu", use_pallas=True)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_monai_mean_max_bundle_needs_its_mode(mode, tmp_path):
    """MONAI 'mean' and 'max' heads hold the same weights (``myfc`` alone):
    built from weights without a ``mil_mode`` knob they raise, and with it
    the bundle serves the head's own logits and says it gives no attention."""
    from transmil_deepgraft_tpu_torch.serving import (
        ServingBundle, export_serving_bundle, head_from_params)

    torch.manual_seed(4)
    model = create_model("AttTrans", 2, 64, device="cpu", mil_mode=mode).eval()
    params = ttw.convert_head_state_dict(model.state_dict(), "AttTrans", 64)["params"]
    with pytest.raises(ValueError, match="mil_mode"):
        head_from_params("AttTrans", params, 64, device="cpu")
    export_serving_bundle(params, tmp_path / "b.tdx", model_name="AttTrans", in_features=64,
                          n_classes=2, buckets=(32,), knobs={"mil_mode": mode})
    bundle = ServingBundle.load(tmp_path / "b.tdx", device="cpu")
    assert bundle.model.mil_mode == mode and not bundle.meta["attention"]
    bag = np.random.default_rng(5).standard_normal((20, 64)).astype(np.float32)
    x = torch.zeros(1, 32, 64)
    x[0, :20] = torch.from_numpy(bag)
    with torch.no_grad():
        want = model(x).numpy()
    np.testing.assert_allclose(bundle.predict_logits(bag), want, atol=TOL, rtol=0)
