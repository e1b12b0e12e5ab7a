"""The port's multi-process paths (``parallel/*``, the Trainer's ``mesh=``)
against the JAX package on its 8-device CPU mesh.

One module fixture starts 4 gloo processes once: this file run as a script,
one process a rank. They build a dp = 4 mesh, a dp 2 x sp 2 mesh, a dp 1 x
sp 4 mesh and a dp 2 x tp 2 mesh, run every check on them and write their
results to ``.npz``/JSON files; meanwhile this process computes the JAX
package's results on the same numpy inputs and weights. Bars, the JAX
package's own: the tile-parallel embed bit-exact
(``tests/test_tile_parallel.py``); ``sp_nystrom_attention`` within
rtol/atol 2e-4 (``tests/test_sp_nystrom.py``); tensor parallelism's logits
within 2e-5, loss rtol 1e-5, gradients within 5e-4 (``tests/test_tp.py``);
dp training's loss within 1e-4 (AttMIL) / 5e-4 (TransMIL) and val AUC
within 1e-6 (``tests/test_trainer_mesh.py``). The reduced Newton-Schulz
divisor is held to the one-process forward within 1e-6, the data-parallel
BatchNorm within 1e-5 (its float32 sums are taken in another order).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
TILE = 32
# name: (sp, (b, h, n, d), landmarks); the last at the kernels' shape
SP_SHAPES = {"sp2": (2, (1, 2, 512, 32), 16), "sp4": (4, (1, 2, 512, 32), 16),
             "sp2_kernel_shape": (2, (1, 2, 1024, 64), 256)}


def _bags(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# bags of one length: JAX compiles its eval step once, not once a length
def _attmil_dm(dm_cls):
    return dm_cls(n_classes=2, max_bag_size=32, batch_size=8, seed=0,
                  synthetic={"n_train": 16, "n_val": 8, "n_test": 8, "bag_size": 32,
                             "feature_size": 32, "signal": 2.0, "variable_bags": False})


def _transmil_dm(dm_cls):
    # a strong class signal makes the bags' landmark softmaxes, and so the
    # Newton-Schulz divisors of the two dp slices, differ: without the
    # divisor's all_reduce this run misses the 5e-4 loss bar
    return dm_cls(n_classes=2, max_bag_size=32, batch_size=4, seed=0,
                  synthetic={"n_train": 16, "n_val": 8, "n_test": 8, "bag_size": 32,
                             "feature_size": 32, "signal": 4.0, "variable_bags": False})


def _fit_config(cls, log_dir, epochs):
    return cls(epochs=epochs, log_dir=str(log_dir), task="norm_rest", train_deterministic=True,
               epoch_figures=False, export_topk_tiles=False)


# ------------------------------------------------------------- the ranks

def _rank_main(rank: int, world: int, port: int, work: Path) -> None:
    """One process of the fixture's group: every check, results to
    ``work/rank<r>.npz`` and ``.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from transmil_deepgraft_tpu_torch.parallel.mesh import init_multihost, make_mesh

    torch.set_num_threads(1)
    init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    meshes = {"dp4": make_mesh(dp=4, device_type="cpu"),
              "dp2sp2": make_mesh(dp=2, sp=2, device_type="cpu"),
              "sp4": make_mesh(dp=1, sp=4, device_type="cpu"),
              "tp": init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "tp"))}
    arrays, scalars = {}, {}
    for check in (_tile_parallel, _batch_norm, _divisor, _sp_nystrom, _tensor_parallel,
                  _fit_attmil, _fit_transmil):
        check(rank, meshes, inputs, work, arrays, scalars)
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(scalars))
    dist.barrier()
    dist.destroy_process_group()


def _tile_parallel(rank, meshes, inputs, work, arrays, scalars):
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import apply_qresnet50
    from transmil_deepgraft_tpu_torch.parallel.tile_parallel import (
        make_tile_parallel_embed, tile_parallel_slide_embed)

    def embed(q, x):
        return apply_qresnet50(q, torch.from_numpy(np.ascontiguousarray(x)))

    q, tiles, mesh = inputs["q"], _bags(1, (13, TILE, TILE, 3)), meshes["dp4"]
    arrays["tile_gather"] = make_tile_parallel_embed(embed, mesh)(q, tiles).numpy()
    arrays["tile_chunked"] = tile_parallel_slide_embed(embed, q, tiles, mesh, chunk=2).numpy()
    arrays["tile_shard"] = make_tile_parallel_embed(embed, mesh, gather=False)(q, tiles).numpy()
    if rank == 0:
        arrays["tile_single"] = embed(q, tiles).numpy()


def _batch_norm(rank, meshes, inputs, work, arrays, scalars):
    """A train-mode flax-rule BatchNorm over dp = 4 slices of 2 against the
    whole batch in one process: outputs, summed gradients, running stats."""
    import torch.distributed as dist

    from transmil_deepgraft_tpu_torch.models.resnet import BatchNorm2d, batch_stats_reduced_over

    x, w = torch.from_numpy(_bags(3, (8, 6, 4, 4))), torch.from_numpy(_bags(4, (8, 6, 4, 4)))

    def run(xs, ws, group):
        torch.manual_seed(0)
        bn = BatchNorm2d(6).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
        xs = xs.clone().requires_grad_(True)
        with batch_stats_reduced_over(group):
            y = bn(xs)
            (y * ws).sum().backward()
        return y.detach(), xs.grad, bn

    y_all, gx_all, bn_all = run(x, w, None)
    sl = slice(2 * rank, 2 * rank + 2)
    y, gx, bn = run(x[sl], w[sl], meshes["dp4"].get_group("dp"))
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads, group=meshes["dp4"].get_group("dp"))
    want = torch.stack([bn_all.weight.grad, bn_all.bias.grad])
    scalars["bn_out"] = float((y - y_all[sl]).abs().max())
    scalars["bn_input_grad"] = float((gx - gx_all[sl]).abs().max())
    scalars["bn_param_grad"] = float((grads - want).abs().max())
    scalars["bn_running"] = max(float((bn.running_mean - bn_all.running_mean).abs().max()),
                                float((bn.running_var - bn_all.running_var).abs().max()))


def _divisor(rank, meshes, inputs, work, arrays, scalars):
    """A TransMIL forward over dp = 2 slices whose Newton-Schulz divisors
    differ, against the one-process forward of the whole batch."""
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops.pinv import divisor_reduced_over
    from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank

    torch.manual_seed(5)
    model = create_model("TransMIL", 2, 32, 32, device="cpu").eval()
    x = _bags(6, (4, 24, 32))
    x[2:] *= 4.0  # the second slice's landmarks, and so its divisor, differ
    x = torch.from_numpy(x)
    i = axis_rank(meshes["dp2sp2"], "dp")
    sl = slice(2 * i, 2 * i + 2)
    with torch.no_grad():
        whole = model(x)[sl]
        with divisor_reduced_over(meshes["dp2sp2"].get_group("dp")):
            reduced = model(x[sl])
        alone = model(x[sl])
    scalars["divisor_reduced"] = float((reduced - whole).abs().max())
    scalars["divisor_alone"] = float((alone - whole).abs().max())


def _sp_nystrom(rank, meshes, inputs, work, arrays, scalars):
    from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank
    from transmil_deepgraft_tpu_torch.parallel.sp_nystrom import sp_nystrom_attention

    for name, (sp, shape, m) in SP_SHAPES.items():
        mesh = meshes["sp4"] if sp == 4 else meshes["dp2sp2"]
        j = axis_rank(mesh, "sp")
        n_loc = shape[2] // sp
        q, k, v = (torch.from_numpy(_bags(7 + i, shape)[:, :, j * n_loc:(j + 1) * n_loc])
                   for i in range(3))
        arrays[name] = sp_nystrom_attention(q, k, v, mesh, num_landmarks=m).numpy()


def _tensor_parallel(rank, meshes, inputs, work, arrays, scalars):
    """dp 2 x tp 2 TransMIL, the JAX test's inputs: this dp slice's logits,
    the global loss and the gradients of this process's shards."""
    import torch.distributed as dist

    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops.pinv import divisor_reduced_over
    from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank
    from transmil_deepgraft_tpu_torch.parallel.tp import tp_shard

    mesh = meshes["tp"]
    rng = np.random.default_rng(0)
    bags = rng.standard_normal((4, 32, 64)).astype(np.float32)
    labels = rng.integers(0, 2, 4)
    model = create_model("TransMIL", 2, 64, 64, device="cpu")
    model.load_state_dict(inputs["tp_state"])
    model = tp_shard(model, mesh).eval()
    i = axis_rank(mesh, "dp")
    sl = slice(2 * i, 2 * i + 2)
    dp_group = mesh.get_group("dp")
    with divisor_reduced_over(dp_group):
        logits = model(torch.from_numpy(bags[sl]))
        one_hot = torch.nn.functional.one_hot(torch.from_numpy(labels[sl]), 2).float()
        loss = -(torch.log_softmax(logits, -1) * one_hot).sum(-1).mean()
        loss.backward()
    for name, p in model.named_parameters():  # the global batch's gradient: the dp mean
        g = p.grad.clone()
        dist.all_reduce(g, group=dp_group)
        arrays[f"tp_grad/{name}"] = (g / 2).numpy()
    total = loss.detach().clone()
    dist.all_reduce(total, group=dp_group)
    scalars["tp_loss"] = float(total) / 2
    arrays["tp_logits"] = logits.detach().numpy()


def _fit(rank, mesh, inputs, work, scalars, name, model, dm, epochs):
    from transmil_deepgraft_tpu_torch.train import losses
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    model.load_state_dict(inputs[f"{name}_state"])
    tx = create_optimizer("adam", lr=1e-3, weight_decay=0.0)
    trainer = Trainer(model, tx, dm, n_classes=2, loss_fn=losses.create_loss(),
                      config=_fit_config(TrainerConfig, work / name, epochs), mesh=mesh,
                      model_name=type(model).__name__)
    history = trainer.fit()
    for key in ("loss", "val_loss", "val_auc"):
        scalars[f"{name}_{key}"] = history[key]


def _fit_attmil(rank, meshes, inputs, work, arrays, scalars):
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.models import create_model

    model = create_model("AttMIL", 2, 32, 16, device="cpu", attn_dim=8)
    _fit(rank, meshes["dp4"], inputs, work, scalars, "attmil", model, _attmil_dm(MILDataModule), 2)


def _fit_transmil(rank, meshes, inputs, work, arrays, scalars):
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.models import create_model

    model = create_model("TransMIL", 2, 32, 32, device="cpu", use_pallas=True)
    _fit(rank, meshes["dp2sp2"], inputs, work, scalars, "transmil", model,
         _transmil_dm(MILDataModule), 3)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    sys.exit(0)


# --------------------------------------------------------- the JAX side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _draw(model, x_shape, seed: int) -> dict:
    """Flax params of ``model`` at ``jax.eval_shape``'s shapes (no compile),
    drawn with numpy: fan-in scaled kernels, LayerNorm scales near 1, small
    biases."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.key(0)},
                            jnp.zeros(x_shape))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_inputs(work: Path) -> dict:
    """The weights of every check (numpy): the heads' drawn at JAX's shapes
    (the dp-trained TransMIL's from JAX's init), the
    int8 ResNet50 calibrated by the port on seeded random weights (its
    constants carried into JAX's QResNet50 as they are); the port's copies
    in ``work/inputs.pt`` for the ranks."""
    from chip_smoke import random_resnet50_variables
    from transmil_deepgraft_tpu.models import AttMIL as JAttMIL, TransMIL as JTransMIL, create_model
    from transmil_deepgraft_tpu.models import resnet_int8 as J
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import build_qresnet50
    from transmil_deepgraft_tpu_torch.utils.jax_params import (
        head_state_dict_from_jax, state_dict_from_jax)

    port_q = build_qresnet50(random_resnet50_variables(np.random.default_rng(0)),
                             _bags(0, (4, TILE, TILE, 3)), device="cpu")

    def arr(t):
        return None if t is None else t.numpy()

    q = J.QResNet50(*(arr(t) for t in port_q[:4]),
                    tuple(J.QBlock(*(arr(t) for t in b)) for b in port_q.blocks),
                    arr(port_q.final_scale), port_q.truncate_after, port_q.feature_dim)
    tp_model = create_model("TransMIL", n_classes=2, in_features=64, out_features=64)
    tp_bags = np.random.default_rng(0).standard_normal((4, 32, 64)).astype(np.float32)
    tp_params = _draw(tp_model, (1, 32, 64), 0)
    att = _draw(JAttMIL(n_classes=2, in_features=32, out_features=16, attn_dim=8), (1, 32, 32), 1)
    # JAX's own init: from it the run without the divisor's reduce misses the bar
    tm = jax.device_get(jax.jit(JTransMIL(n_classes=2, in_features=32, out_features=32).init)(
        {"params": jax.random.key(2)}, jnp.zeros((1, 32, 32)))["params"])
    torch.save({"q": port_q, "tp_state": state_dict_from_jax(tp_params, 64),
                "attmil_state": head_state_dict_from_jax("AttMIL", att, 32),
                "transmil_state": state_dict_from_jax(tm, 32)}, work / "inputs.pt")
    return {"q": q, "tp_model": tp_model, "tp_params": tp_params, "tp_bags": tp_bags,
            "attmil": att, "transmil": tm}


def _jax_results(inp: dict, work: Path) -> dict:
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JDM
    from transmil_deepgraft_tpu.models import AttMIL as JAttMIL, TransMIL as JTransMIL
    from transmil_deepgraft_tpu.models.resnet_int8 import apply_qresnet50
    from transmil_deepgraft_tpu.parallel.mesh import make_mesh
    from transmil_deepgraft_tpu.parallel.sp_nystrom import sp_nystrom_attention
    from transmil_deepgraft_tpu.parallel.tile_parallel import make_tile_parallel_embed
    from transmil_deepgraft_tpu.parallel.tp import tp_shardings
    from transmil_deepgraft_tpu.train.losses import create_loss
    from transmil_deepgraft_tpu.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu.train.trainer import Trainer, TrainerConfig

    out: dict = {}
    devices = jax.devices()
    run = make_tile_parallel_embed(apply_qresnet50, make_mesh(devices[:4], dp=4))
    out["tiles"] = np.asarray(run(inp["q"], jnp.asarray(_bags(1, (13, TILE, TILE, 3)))))
    for name, (sp, shape, m) in SP_SHAPES.items():
        q, k, v = (_bags(7 + i, shape) for i in range(3))
        if name == "sp2_kernel_shape":  # the port's one-process op (JAX's bar)
            from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention

            qkv = (torch.from_numpy(x) for x in (q, k, v))
            out[name] = nystrom_attention(*qkv, num_landmarks=m).out.numpy()
            continue
        mesh = make_mesh(devices[:sp], dp=1, sp=sp)
        out[name] = np.asarray(sp_nystrom_attention(*map(jnp.asarray, (q, k, v)), mesh,
                                                    num_landmarks=m))

    # tests/test_tp.py's dp 4 x tp 2 step, on its inputs
    model, params, bags = inp["tp_model"], inp["tp_params"], inp["tp_bags"]
    labels = jnp.asarray(_tp_labels(), jnp.int32)

    def loss_fn(p, x, y):
        logits = model.apply({"params": p}, x, deterministic=True)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(y, 2), -1)), logits

    mesh = Mesh(np.asarray(devices[:8]).reshape(4, 2), ("dp", "tp"))
    p_shard, data = tp_shardings(mesh, params), NamedSharding(mesh, P("dp"))
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), in_shardings=(p_shard, data, data),
                   out_shardings=((NamedSharding(mesh, P()), data), p_shard))
    (loss, logits), grads = step(jax.device_put(params, p_shard), jax.device_put(bags, data),
                                 jax.device_put(labels, data))
    out["tp_loss"], out["tp_logits"] = float(loss), np.asarray(logits)
    out["tp_grads"] = jax.device_get(grads)

    # the JAX Trainer on its dp mesh, from the same weights
    for name, model, dm, dp, sp, epochs in (
            ("attmil", JAttMIL(n_classes=2, in_features=32, out_features=16, attn_dim=8),
             _attmil_dm(JDM), 4, 1, 2),
            ("transmil", JTransMIL(n_classes=2, in_features=32, out_features=32),
             _transmil_dm(JDM), 2, 2, 3)):
        tr = Trainer(model, create_optimizer(opt="adam", lr=1e-3, weight_decay=0.0), dm,
                     n_classes=2, loss_fn=create_loss(),
                     config=_fit_config(TrainerConfig, work / f"jax_{name}", epochs),
                     mesh=make_mesh(devices[:dp * sp], dp=dp, sp=sp),
                     model_name=type(model).__name__)
        tr.params = jax.tree.map(jnp.asarray, inp[name])
        tr.opt_state = tr.tx.init(tr.params)
        out[name] = tr.fit()
    return out


def _tp_labels() -> np.ndarray:
    rng = np.random.default_rng(0)
    rng.standard_normal((4, 32, 64))
    return rng.integers(0, 2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' arrays by rank, their scalars by rank, the JAX results)."""
    work = tmp_path_factory.mktemp("ranks")
    inputs = _jax_inputs(work)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "OMP_NUM_THREADS": "1"}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(work)],
                              cwd=REPO, env=env, stdout=open(work / f"log{r}.txt", "w"),
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        jax_out = _jax_results(inputs, work)
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = "\n".join((work / f"log{r}.txt").read_text()[-3000:] for r in range(WORLD))
    assert codes == [0] * WORLD, logs
    arrays = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    scalars = [json.loads((work / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return arrays, scalars, jax_out


def test_tile_parallel_embed_is_bit_exact(results):
    """The dp = 4 embed of 13 tiles (padded to 16), gathered and chunked
    (chunk 2 a process), equals JAX's dp-sharded embed and the port's
    one-process embed bit for bit; each shard is its rows of the padded
    batch."""
    arrays, _, jax_out = results
    want = jax_out["tiles"]
    assert want.shape == (13, 2048)
    np.testing.assert_array_equal(arrays[0]["tile_single"], want)
    for r in range(WORLD):
        np.testing.assert_array_equal(arrays[r]["tile_gather"], want)
        np.testing.assert_array_equal(arrays[r]["tile_chunked"], want)
        shard = arrays[r]["tile_shard"]
        assert shard.shape == (4, 2048)
        np.testing.assert_array_equal(shard[:max(0, 13 - 4 * r)], want[4 * r:4 * r + 4])


@pytest.mark.parametrize("name", sorted(SP_SHAPES))
def test_sp_nystrom_matches_jax(results, name):
    """Each process's output rows, in sp order, are JAX's sp_nystrom_attention
    of the whole sequence; at 256 landmarks and dim_head 64 the port takes
    the kernels' route (their plain versions on the CPU, B3 with its row
    statistics), held to the port's one-process ``nystrom_attention``."""
    arrays, _, jax_out = results
    sp = SP_SHAPES[name][0]
    ranks = range(WORLD) if sp == 4 else (0, 1)  # the sp group of ranks 0, 1 (dp 2 x sp 2)
    got = np.concatenate([arrays[r][name] for r in ranks], axis=2)
    np.testing.assert_allclose(got, jax_out[name], rtol=2e-4, atol=2e-4)


def test_tensor_parallel_matches_jax(results):
    """dp 2 x tp 2: logits within 2e-5, the loss within rtol 1e-5, and every
    process's shard of to_qkv / to_out (and each replicated gradient) within
    5e-4 of JAX's dp 4 x tp 2 step."""
    arrays, scalars, jax_out = results
    logits = np.concatenate([arrays[0]["tp_logits"], arrays[2]["tp_logits"]])  # dp 0, dp 1
    np.testing.assert_allclose(logits, jax_out["tp_logits"], atol=2e-5)
    for r in range(WORLD):
        np.testing.assert_allclose(scalars[r]["tp_loss"], jax_out["tp_loss"], rtol=1e-5)
    from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

    want = state_dict_from_jax(jax_out["tp_grads"], 64)  # the gradients in torch layout
    checked = 0
    for r in range(WORLD):
        tp_rank = r % 2
        for key, got in arrays[r].items():
            if not key.startswith("tp_grad/"):
                continue
            name = key[len("tp_grad/"):]
            full = want[name].numpy()
            if name.endswith("to_qkv.weight"):
                full = np.split(full, 2, axis=0)[tp_rank]
            elif name.endswith("to_out.0.weight"):
                full = np.split(full, 2, axis=1)[tp_rank]
            np.testing.assert_allclose(got, full, atol=5e-4, err_msg=name)
            checked += 1
    assert checked == WORLD * len(want)


def test_dp_fit_matches_the_jax_trainer(results):
    """The Trainer with mesh=: AttMIL at dp 4 (batch 8) and TransMIL with
    use_pallas at dp 2 (batch 4, on the dp 2 x sp 2 mesh) against the JAX
    Trainer on its dp mesh from the same weights; every process reports the
    same history."""
    _, scalars, jax_out = results
    for name, tol in (("attmil", 1e-4), ("transmil", 5e-4)):
        want = jax_out[name]
        for r in range(WORLD):
            assert abs(scalars[r][f"{name}_loss"] - want["loss"]) < tol, (name, r)
            assert abs(scalars[r][f"{name}_val_loss"] - want["val_loss"]) < tol, (name, r)
            assert abs(scalars[r][f"{name}_val_auc"] - want["val_auc"]) < 1e-6, (name, r)


def test_reduced_divisor_and_batch_norm_equal_one_process(results):
    """Under dp the Newton-Schulz divisor (max over the global batch) and the
    flax-rule BatchNorm's moments are reduced over the group: each slice's
    TransMIL forward equals the one-process run's within 1e-6, the
    BatchNorm's outputs, gradients and running statistics within 1e-5;
    without the reduce the divisor check differs, so it can fail."""
    _, scalars, _ = results
    for r in range(WORLD):
        s = scalars[r]
        assert s["divisor_reduced"] <= 1e-6, s["divisor_reduced"]
        assert s["divisor_alone"] > 1e-5, s["divisor_alone"]
        for key in ("bn_out", "bn_input_grad", "bn_param_grad", "bn_running"):
            assert s[key] <= 1e-5, (key, s[key])
