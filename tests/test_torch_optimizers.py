"""The rest of the port's training against the JAX package's, on the CPU:
the other optimizer rules step for step, AdaHessian's Hutchinson diagonal
and where it cannot be taken (ROADMAP C18, C19), and the Trainer's SWA,
autosave, resume and TensorBoard scalars.

The rules run on a tiny TransMIL's parameter tree (in_features 8, width 16),
whose leaves take every flax layout the port carries over (Dense kernels,
HWIO depthwise kernels, the value residual, biases and norms), under seeded
gradients: a third of the >1-d gradients are orthogonal to their weights row
by row and a third as a whole, so that AdamP's and SGDP's projections fire
on both views. Tolerances: weights and optimizer state within 1e-4 (float32
sums in another order), the Hessian diagonal within 1e-4 of its scale, the
fit as ``test_torch_train.py`` holds it.
"""

import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JaxDataModule
from transmil_deepgraft_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.models.convmixer import ConvMixer as JaxConvMixer
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.adahessian import hutchinson_diag_hessian as jax_hutchinson
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu.train.optimizers import \
    create_optimizer_from_config as jax_optimizer_from_config
from transmil_deepgraft_tpu.train.trainer import Trainer as JaxTrainer
from transmil_deepgraft_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from transmil_deepgraft_tpu.train.trainer import mutable_lr_scale
from transmil_deepgraft_tpu.utils.config import Config
from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.models import MODEL_REGISTRY, create_model
from transmil_deepgraft_tpu_torch.models.convmixer import ConvMixer
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.adahessian import (
    refuse_custom_vjp_heads, value_grad_and_diag_hessian)
from transmil_deepgraft_tpu_torch.train.optimizers import (
    create_optimizer, create_optimizer_from_config)
from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    head_state_dict_from_jax, optimizer_state_from_jax, state_dict_from_jax)

IN_F, OUT_F, LR, WD, TOL = 8, 16, 1e-3, 0.01, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _orthogonal(g: np.ndarray, p: np.ndarray, rows: bool) -> np.ndarray:
    """``g`` with its component along ``p`` removed, row by row of the flax
    layout (``rows``) or over the whole tensor."""
    shape = (p.shape[0], -1) if rows else (1, -1)
    gv, pv = g.reshape(shape), p.reshape(shape)
    coef = (gv * pv).sum(1, keepdims=True) / (pv * pv).sum(1, keepdims=True)
    return (gv - coef * pv).reshape(g.shape).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    """(params, 16 gradient trees, 16 Hessian-diagonal trees) of the tiny
    TransMIL, numpy, from one seed; shapes from ``jax.eval_shape``."""
    shapes = jax.eval_shape(JaxTransMIL(2, IN_F, OUT_F).init, {"params": jax.random.key(0)},
                            jax.ShapeDtypeStruct((1, 8, IN_F), jnp.float32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32),
                          shapes)
    leaves, treedef = jax.tree.flatten(params)

    def draw(orthogonalize: bool):
        out = []
        for i, p in enumerate(leaves):
            g = (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
            if orthogonalize and p.ndim > 1 and i % 3 < 2:
                g = _orthogonal(g, p, rows=i % 3 == 0)
            out.append(g)
        return jax.tree.unflatten(treedef, out)

    return params, [draw(True) for _ in range(16)], [draw(False) for _ in range(16)]


def _port(tree_):
    return state_dict_from_jax(tree_, IN_F)


# (opt, grad_accum_steps, weight_decay): every rule the port added, with
# lookahead, accumulation and decay on across the cases; "config" builds
# adafactor from a config section with lr null (the relative step) and
# opt_betas (its beta1)
RULE_CASES = [("nadam", 1, WD), ("lookahead_adamp", 2, WD), ("sgdp", 1, WD),
              ("adadelta", 2, WD), ("adafactor", 1, WD), ("config", 2, WD),
              ("rmsprop", 1, WD), ("lookahead_rmsproptf", 1, WD), ("novograd", 2, WD),
              ("lookahead_nvnovograd", 1, 0.0), ("lamb", 1, WD), ("adahessian", 1, WD)]


@pytest.mark.parametrize("opt, acc, wd", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_follows_optax_step_for_step(tree, opt, acc, wd):
    """8 JAX micro-steps, then JAX's state (weights, the rule's moments,
    slow weights, the accumulator, counters) carried onto the port, then 8
    more micro-steps on both sides with the same gradients (and Hessian
    diagonals): weights and every state slot within 1e-4."""
    params, grads, diags = tree
    if opt == "config":
        section = Config({"opt": "adafactor", "lr": None, "weight_decay": wd,
                          "opt_betas": [0.9, 0.999]})
        jtx = jax_optimizer_from_config(section, grad_accum_steps=acc)
        ttx = create_optimizer_from_config(section, grad_accum_steps=acc)
        assert ttx.lr == 0.0 and ttx.betas[0] == 0.9
    else:
        jtx = jax_create_optimizer(opt, lr=LR, weight_decay=wd, grad_accum_steps=acc)
        ttx = create_optimizer(opt, lr=LR, weight_decay=wd, grad_accum_steps=acc)
    if not ttx.lookahead:  # the JAX Trainer's own lr scale
        jtx = optax.chain(jtx, mutable_lr_scale())
    hessian = ttx.rule == "adahessian"
    update = jax.jit(lambda g, s, p, d: jtx.update(g, s, p, **({"hessian_diag": d} if hessian
                                                               else {})))
    state = jtx.init(params)
    p = params
    for g, d in zip(grads[:8], diags[:8]):
        u, state = update(g, state, p, d)
        p = optax.apply_updates(p, u)
    p = jax.device_get(p)

    model = create_model("TransMIL", 2, IN_F, OUT_F, device="cpu")
    model.load_state_dict(_port(p))
    names = [n for n, _ in model.named_parameters()]
    ttx.init(model)
    ttx.load_state_dict(optimizer_state_from_jax(jax.device_get(state), IN_F, names,
                                                 rule=ttx.rule, params=p))
    counted = ttx.rule not in ("sgdp", "adadelta", "rmsprop", "rmsproptf")  # JAX keeps none
    assert (ttx.count if counted else 8 // acc, ttx.mini_step) == (8 // acc, 0)
    for g, d in zip(grads[8:], diags[8:]):
        u, state = update(g, state, p, d)
        p = optax.apply_updates(p, u)
        tg, td = _port(g), _port(d)
        for name, param in model.named_parameters():
            param.grad = tg[name]
        ttx.step(hessian=[td[n] for n in names] if hessian else None)
    p = jax.device_get(p)

    want = _port(p)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(), atol=TOL, rtol=0,
                                   err_msg=name)
    want_state = optimizer_state_from_jax(jax.device_get(state), IN_F, names, rule=ttx.rule,
                                          params=p)
    got_state = ttx.state_dict()
    if counted:
        assert got_state["count"] == want_state["count"] == 16 // acc
    slots = [k for k in got_state if isinstance(got_state[k], list) and got_state[k]]
    assert set(ttx.slots) <= set(slots)
    for key in slots:
        if key == "acc" and acc == 1:  # JAX has no MultiSteps then; the port's is zeros
            continue
        assert len(want_state[key]) == len(got_state[key]), key
        for name, got, exp in zip(names, got_state[key], want_state[key]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{key} {name}")


# ---------------------------------------------------------------- AdaHessian

def _bag(rng, name, n=24, d=32):
    shape = (1, 8, 8, d) if name in ("CTMIL", "resnet50") else (1, n, d)
    return rng.standard_normal(shape).astype(np.float32)


def _logits(out, name):
    if isinstance(out, tuple):  # DTFD: (sub, slide); MDMIL: (logits, attention)
        return out[1] if name in ("DTFD", "DTFDMIL") else out[0]
    return out


def _jax_raises(model, x, name: str) -> bool:
    """Whether JAX's Hutchinson diagonal of ``sum(logits)`` raises on
    ``model``: lowered from abstract shapes (the forward-mode rule fails
    while lowering; ``eval_shape`` alone does not reach it)."""
    kw = {} if name == "ConvMixer" else {"deterministic": True}
    variables = jax.eval_shape(model.init, {"params": jax.random.key(0),
                                            "dropout": jax.random.key(1),
                                            "shuffle": jax.random.key(2)}, x)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def diag(params, rest):
        def loss(p):
            return _logits(model.apply({"params": p, **rest}, x, **kw), name).sum()
        return jax_hutchinson(loss, params, jax.random.key(3))

    try:
        jax.jit(diag).lower(variables["params"], rest)
    except TypeError as e:
        assert "custom_vjp" in str(e), e
        return True
    return False


HEADS = sorted(set(MODEL_REGISTRY) & set(JAX_REGISTRY)) + ["ConvMixer"]


@pytest.mark.parametrize("name", HEADS)
def test_adahessian_refuses_the_heads_jax_cannot_differentiate(name, tmp_path):
    """ROADMAP C18: JAX's forward-over-reverse Hessian cannot enter its
    depthwise convolutions' custom VJP; the port's AdaHessian (the check
    the Trainer makes for it) raises a TypeError naming C18 exactly on the
    heads where JAX raises, and takes a finite diagonal on the others."""
    rng = np.random.default_rng(len(name))
    x = _bag(rng, name) if name != "ConvMixer" else rng.standard_normal(
        (2, 14, 14, 3)).astype(np.float32)
    if name == "ConvMixer":
        jax_model, model = (JaxConvMixer(dim=8, depth=1, kernel_size=3, patch_size=7),
                            ConvMixer(dim=8, depth=1, kernel_size=3, patch_size=7))
    else:
        jax_model = jax_create_model(name, 2, 32, 16)
        model = create_model(name, 2, 32, 16, device="cpu")
    model.eval()
    raises = _jax_raises(jax_model, jnp.asarray(x), name)
    xt = torch.from_numpy(x)

    def loss():
        return _logits(model(xt), name).sum()

    if raises:
        with pytest.raises(TypeError, match="C18"):
            refuse_custom_vjp_heads(model)
        if name in ("TransMIL", "CTMIL"):  # the Trainer refuses it when it is built
            dm = MILDataModule(n_classes=2, max_bag_size=8, batch_size=1, seed=0,
                               synthetic={"n_train": 2, "n_val": 2, "n_test": 2,
                                          "bag_size": 8, "feature_size": 32})
            with pytest.raises(TypeError, match="C18"):
                Trainer(model, create_optimizer("adahessian"), dm, n_classes=2,
                        loss_fn=tlosses.create_loss(), model_name=name,
                        config=TrainerConfig(log_dir=str(tmp_path)))
    else:
        refuse_custom_vjp_heads(model)
        _, _, diag = value_grad_and_diag_hessian(loss, list(model.parameters()),
                                                 generator=torch.Generator().manual_seed(0))
        assert all(torch.isfinite(d).all() for d in diag)
    assert raises == (name in ("TransMIL", "MDMIL", "CTMIL", "ConvMixer"))


def _jax_zs(params, key):
    """The probes JAX's ``hutchinson_diag_hessian`` draws: one key a leaf
    in flatten order."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [jax.random.rademacher(k, leaf.shape, dtype=leaf.dtype)
                                        for k, leaf in zip(keys, leaves)])


# the gated attention's score bias adds one constant to every tile's score
# before the softmax over tiles: its gradient and Hessian are exactly zero,
# so both packages hold float32 noise there, and AdaHessian's first step
# divides one noise by the other
SHIFT_INVARIANT = ("attention_weights.bias",)


@pytest.mark.parametrize("name", ["AttMIL", "TransformerMIL"])
def test_adahessian_diagonal_and_step_match_jax(name):
    """Given JAX's probes, the port's Hutchinson diagonal of the train loss
    (reverse-over-reverse, the dense attention on its plain route) and its
    gradient equal JAX's (forward-over-reverse), and the port's AdaHessian
    step lands on JAX's weights. The step takes JAX's diagonal: the first
    step divides by |diag|, which float32 noise in a near-zero entry would
    blow up."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(_bag(rng, name))
    y = jax.nn.one_hot(jnp.asarray([1]), 2)
    jmodel = jax_create_model(name, 2, 32, 16)
    params = jax.device_get(jax.jit(jmodel.init)({"params": jax.random.key(1)}, x)["params"])
    loss_fn = jlosses.create_loss()

    def jloss(p):
        return loss_fn(jmodel.apply({"params": p}, x, deterministic=True), y)

    key = jax.random.key(5)
    jtx = jax_create_optimizer("adahessian", lr=LR, weight_decay=WD)

    @jax.jit
    def jax_step(params):
        diag = jax_hutchinson(jloss, params, key)
        grads = jax.grad(jloss)(params)
        upd, _ = jtx.update(grads, jtx.init(params), params, hessian_diag=diag)
        return diag, grads, optax.apply_updates(params, upd)

    jdiag, grads, jnew = jax.device_get(jax_step(params))

    model = create_model(name, 2, 32, 16, device="cpu")
    model.load_state_dict(head_state_dict_from_jax(name, params, 32))
    model.eval()
    names = [n for n, _ in model.named_parameters()]
    zs = head_state_dict_from_jax(name, jax.device_get(_jax_zs(params, key)), 32)
    xt, yt = torch.from_numpy(np.asarray(x)), torch.tensor([[0.0, 1.0]])
    (_, _), grads_t, diag = value_grad_and_diag_hessian(
        lambda: (tlosses.create_loss()(model(xt), yt), None), list(model.parameters()),
        zs=[zs[n] for n in names], has_aux=True)
    want = head_state_dict_from_jax(name, jdiag, 32)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n, d in zip(names, diag):
        np.testing.assert_allclose(d.numpy(), want[n].numpy(), atol=TOL * max(scale, 1.0),
                                   rtol=0, err_msg=n)
    want_grads = head_state_dict_from_jax(name, jax.device_get(grads), 32)
    for n, g in zip(names, grads_t):
        if n not in SHIFT_INVARIANT:
            np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), atol=TOL, rtol=0,
                                       err_msg=n)
    ttx = create_optimizer("adahessian", lr=LR, weight_decay=WD)
    ttx.init(model)
    for p, g in zip(model.parameters(), grads_t):
        p.grad = g
    ttx.step(hessian=[want[n] for n in names])
    want = head_state_dict_from_jax(name, jnew, 32)
    for n, p in model.named_parameters():
        if n not in SHIFT_INVARIANT:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=TOL, rtol=0,
                                       err_msg=n)


@pytest.mark.parametrize("opt, acc, error", [("lookahead_adahessian", 1, TypeError),
                                             ("lookahead_adahessian", 2, ValueError),
                                             ("adahessian", 2, ValueError)])
def test_adahessian_fails_where_jax_fails(opt, acc, error):
    """ROADMAP C19: JAX's ``hessian_diag=`` reaches neither lookahead's
    update (a TypeError) nor, through ``optax.chain``, the rule inside
    ``MultiSteps`` (adahessian's ValueError); the port's step raises the
    same errors at the first micro-step."""
    p = {"w": jnp.ones((3, 2)), "b": jnp.ones(2)}
    jtx = jax_create_optimizer(opt, lr=LR, grad_accum_steps=acc)
    if "lookahead" not in opt:
        jtx = optax.chain(jtx, mutable_lr_scale())
    with pytest.raises(error):
        jtx.update(p, jtx.init(p), p, hessian_diag=p)
    w = torch.nn.Parameter(torch.ones(2, 3))
    w.grad = torch.ones(2, 3)
    ttx = create_optimizer(opt, lr=LR, grad_accum_steps=acc)
    ttx.init([w])
    with pytest.raises(error, match="C19"):
        ttx.step(hessian=[torch.ones(2, 3)])
    assert torch.equal(w.detach(), torch.ones(2, 3)) and ttx.mini_step == 0


# --------------------------------------------------- SWA, autosave, resume

class _Crash(Exception):
    pass


def _events(log_dir: Path) -> list[tuple[str, int, float]]:
    """(tag, step, value) of every scalar in the tensorboardX event files
    under ``log_dir/tb`` (TFRecord framing read by hand)."""
    from tensorboardX.proto import event_pb2

    out = []
    for path in sorted((log_dir / "tb").glob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 16 + length
            out += [(v.tag, int(event.step), float(v.simple_value))
                    for v in event.summary.value]
    return sorted(out)


def _fit_config(cls, log_dir, **over):
    return cls(epochs=3, swa=True, swa_start_frac=0.34, autosave_steps=2, use_tensorboard=True,
               log_dir=str(log_dir), train_deterministic=True, epoch_figures=False,
               export_topk_tiles=False, seed=3, **over)


def _rows(log_dir):
    lines = (Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "val_loss" in r]


def _crash_after(step_fn, n):
    calls = []

    def step(*args, **kw):
        if len(calls) == n:
            raise _Crash
        calls.append(1)
        return step_fn(*args, **kw)

    return step


def test_swa_autosave_resume_and_tensorboard_match_the_jax_trainer(tmp_path):
    """AttMIL, 3 epochs of 6 bags, SWA from epoch 1, an autosave every 2
    micro-steps, TensorBoard on, on both packages from the same weights:
    each run dies at the 10th micro-step (epoch 1, after the autosave at its
    2nd step), a new Trainer resumes from that ``last.ckpt`` and finishes.
    The metric rows, the TensorBoard scalars, the final (SWA) weights and
    the weights-only ``last.ckpt`` agree with JAX's."""
    synth = {"n_train": 6, "n_val": 4, "n_test": 2, "bag_size": 24, "feature_size": 32,
             "signal": 0.8, "variable_bags": False}
    args = dict(n_classes=2, max_bag_size=16, batch_size=1, synthetic=synth, seed=4)
    jmodel = jax_create_model("AttMIL", 2, 32, 16)
    params = jax.device_get(jax.jit(jmodel.init)({"params": jax.random.key(2)},
                                                 jnp.zeros((1, 16, 32)))["params"])

    def jax_trainer(log_dir):
        jtx = jax_create_optimizer("radam", lr=LR, weight_decay=WD)
        jtr = JaxTrainer(jmodel, jtx, JaxDataModule(**args), n_classes=2,
                         loss_fn=jlosses.create_loss(), config=_fit_config(JaxTrainerConfig,
                                                                           log_dir),
                         model_name="AttMIL")
        jtr.params = jax.tree.map(jnp.asarray, params)
        jtr.opt_state = jtr.tx.init(params)
        return jtr

    jtr = jax_trainer(tmp_path / "jax_a")
    build = jtr._build_train_step
    jtr._build_train_step = lambda: _crash_after(build(), 9)
    with pytest.raises(_Crash):
        jtr.fit()
    jtr._autosave_join()
    jtr.logger._tb.close()  # JAX's writer queues events for a thread
    jtr = jax_trainer(tmp_path / "jax_b")
    assert jtr.load_train_state(tmp_path / "jax_a" / "checkpoints" / "last.ckpt")
    assert jtr._resume_fit_state["epoch"] == 1
    jtr.fit()
    jtr.logger._tb.close()  # JAX's writer queues events for a thread

    def port_trainer(log_dir):
        model = create_model("AttMIL", 2, 32, 16, device="cpu")
        model.load_state_dict(head_state_dict_from_jax("AttMIL", params, 32))
        return Trainer(model, create_optimizer("radam", lr=LR, weight_decay=WD),
                       MILDataModule(**args), n_classes=2, loss_fn=tlosses.create_loss(),
                       config=_fit_config(TrainerConfig, log_dir), model_name="AttMIL")

    ttr = port_trainer(tmp_path / "port_a")
    ttr.train_step = _crash_after(ttr.train_step, 9)
    with pytest.raises(_Crash):
        ttr.fit()
    ttr._autosave_join()
    ckpt = read_checkpoint(tmp_path / "port_a" / "checkpoints" / "last.ckpt")
    assert ckpt["fit"]["epoch"] == 1 and ckpt["optimizer"]["count"] == 8
    ttr = port_trainer(tmp_path / "port_b")
    assert ttr.load_train_state(tmp_path / "port_a" / "checkpoints" / "last.ckpt")
    ttr.fit()

    for run, epochs in (("a", [0]), ("b", [1, 2])):
        jrows, trows = _rows(tmp_path / f"jax_{run}"), _rows(tmp_path / f"port_{run}")
        assert [r["step"] for r in jrows] == [r["step"] for r in trows] == epochs
        for jr, tr in zip(jrows, trows):
            for key in ("loss", "val_loss"):
                assert abs(jr[key] - tr[key]) <= TOL, key
        jev, tev = _events(tmp_path / f"jax_{run}"), _events(tmp_path / f"port_{run}")
        assert [e[:2] for e in jev] == [e[:2] for e in tev] and len(tev) == 8 * len(epochs)
        for (tag, _, jv), (_, _, tv) in zip(jev, tev):
            if tag in ("loss", "val_loss", "lr_scale"):
                assert abs(jv - tv) <= TOL, tag

    want = head_state_dict_from_jax("AttMIL", jax.device_get(jtr.params), 32)
    for n, p in ttr.model.named_parameters():
        if n not in SHIFT_INVARIANT:  # float32 noise under RAdam's normalised steps
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=TOL, rtol=0,
                                       err_msg=n)
    last = read_checkpoint(tmp_path / "port_b" / "checkpoints" / "last.ckpt")
    assert set(last) == {"model"}
    assert set(read_checkpoint(tmp_path / "jax_b" / "checkpoints" / "last.ckpt")) == {"params"}
    for n, p in ttr.model.named_parameters():
        assert torch.equal(last["model"][n], p.detach())


def test_a_failed_autosave_raises_at_the_next_join(tmp_path, monkeypatch):
    """A write that fails on the autosave thread is not silent: the next
    join (the next autosave, the epoch's checkpoints) raises, as JAX's."""
    synth = {"n_train": 4, "n_val": 2, "n_test": 2, "bag_size": 8, "feature_size": 16}
    dm = MILDataModule(n_classes=2, max_bag_size=8, batch_size=1, synthetic=synth, seed=0)
    trainer = Trainer(create_model("AttMIL", 2, 16, 8, device="cpu"), create_optimizer("adam"),
                      dm, n_classes=2, loss_fn=tlosses.create_loss(), model_name="AttMIL",
                      config=TrainerConfig(epochs=1, autosave_steps=1, log_dir=str(tmp_path),
                                           epoch_figures=False, export_topk_tiles=False))

    def fail(obj):
        raise OSError("disk full")

    monkeypatch.setattr(trainer.ckpts, "save_last", fail)
    with pytest.raises(RuntimeError, match="background autosave") as info:
        trainer.fit()
    assert isinstance(info.value.__cause__, OSError)
    assert trainer._autosave_thread is None


@pytest.mark.parametrize("power", [1.0, 0.5])
def test_adahessian_rule_takes_the_hessian_power(power):
    """``train/adahessian.adahessian`` against JAX's, its ``hessian_power``
    included: three steps on a two-leaf tree, decay on the >1-d leaf."""
    from transmil_deepgraft_tpu.train.adahessian import adahessian as jax_adahessian
    from transmil_deepgraft_tpu.train.optimizers import weight_decay_mask
    from transmil_deepgraft_tpu_torch.train.adahessian import adahessian

    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    jtx = jax_adahessian(lr=1e-2, weight_decay=WD, hessian_power=power, mask=weight_decay_mask)
    state = jtx.init(p)
    params = [torch.nn.Parameter(torch.from_numpy(p[k].copy())) for k in ("w", "b")]
    ttx = adahessian(lr=1e-2, weight_decay=WD, hessian_power=power)
    ttx.init(params)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        d = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        u, state = jtx.update(g, state, p, hessian_diag=d)
        p = jax.device_get(optax.apply_updates(p, u))
        for t, k in zip(params, ("w", "b")):
            t.grad = torch.from_numpy(g[k])
        ttx.step(hessian=[torch.from_numpy(d[k]) for k in ("w", "b")])
    for t, k in zip(params, ("w", "b")):
        np.testing.assert_allclose(t.detach().numpy(), p[k], atol=1e-6, rtol=0)
