"""The port's ``parallel/`` package in one process, against the JAX package:
``init_multihost``'s refusals and its single-process no-op, ``make_mesh``'s
errors, ``sp_nystrom_attention``'s ValueErrors, ``transmil_tp_specs`` against
JAX's spec per parameter, the data module's dp slices byte for byte against
the one-process batches (the draws of the other slices replayed), and
``cli.infer --n_chips 2 --device cpu`` (two gloo processes it starts itself)
against ``--n_chips 1``. The multi-process checks are
``tests/test_torch_distributed.py``."""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.data.pipeline import device_prefetch
from transmil_deepgraft_tpu_torch.parallel import mesh as pm
from transmil_deepgraft_tpu_torch.parallel.sp_nystrom import sp_nystrom_attention
from transmil_deepgraft_tpu_torch.parallel.tile_parallel import pad_to_multiple


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Mesh:
    """A stand-in for a DeviceMesh's dims, sizes and this process's place."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self._dims = dims

    def size(self, i):
        return self._dims[self.mesh_dim_names[i]][0]

    def get_local_rank(self, axis):
        return self._dims[axis][1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CLUSTER = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
            "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for var in _CLUSTER:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


def test_init_multihost_single_process_is_a_no_op(clean_env):
    assert pm.init_multihost() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost first"):
        pm.make_mesh()


@pytest.mark.parametrize("env, kwargs", [
    ({"WORLD_SIZE": "2"}, {}),  # torchrun's world without a rank or coordinator
    ({"SLURM_NTASKS": "4"}, {}),  # a cluster detected, nothing to join it with
    ({"PMI_SIZE": "2"}, {}),
    ({}, {"num_processes": 2}),  # asked for, with no coordinator
    ({}, {"coordinator_address": "127.0.0.1:1", "num_processes": 2, "process_id": 0,
          "backend": "nccl"}),  # NCCL with more processes than cards (none here)
], ids=["torchrun-world", "slurm", "pmi", "asked", "nccl-without-cards"])
def test_init_multihost_refuses_a_join_it_cannot_make(clean_env, env, kwargs):
    """As JAX's: a join that was asked for or whose cluster was detected
    raises instead of carrying on as independent one-process jobs."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL|rank or coordinator"):
        pm.init_multihost(**kwargs)
    assert not dist.is_initialized()


def test_one_process_group_mesh_and_shard_batch(clean_env):
    """An explicit join of one gloo process: the group, JAX's ValueError for
    a mesh that does not fill the world, a (1, 1) mesh whose shard_batch is
    the whole batch, and the descriptors."""
    assert pm.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo") == (0, 1)
    try:
        assert pm.init_multihost() == (0, 1)  # joined already
        with pytest.raises(ValueError, match=r"dp\(2\) \* sp\(1\) != device count \(1\)"):
            pm.make_mesh(dp=2)
        mesh = pm.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("dp", "sp")
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        out = pm.shard_batch({"x": x, "pair": (x, torch.from_numpy(x))}, mesh, torch.device("cpu"))
        np.testing.assert_array_equal(out["x"].numpy(), x)
        assert pm.batch_sharding(mesh) == pm.Sharding(mesh, "dp")
        assert pm.replicated_sharding(mesh).axis is None
    finally:
        dist.destroy_process_group()


def test_shard_rows_and_prefetch_take_this_process_slice():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(pm.shard_rows(x, 4, 2), x[4:6])
    with pytest.raises(ValueError, match="does not split evenly"):
        pm.shard_rows(x[:7], 4, 0)
    mesh = _Mesh(dp=(2, 1), sp=(1, 0))
    (_, got), = device_prefetch([x], torch.device("cpu"), lambda b: (b,), mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), x[4:])
    padded, n = pad_to_multiple(x[:5], 4)
    assert n == 5 and padded.shape == (8, 3) and not padded[5:].any()
    padded, n = pad_to_multiple(torch.from_numpy(x[:5]), 4)
    assert n == 5 and padded.shape == (8, 3) and not padded[5:].any()


@pytest.mark.parametrize("sp, n, m", [(4, 64, 2), (2, 100, 16)],
                         ids=["landmarks-over-sp", "tokens-not-a-multiple"])
def test_sp_nystrom_raises_jax_value_errors(sp, n, m):
    """The shape checks run before any collective, with JAX's messages: the
    same shapes raise in JAX's sp_nystrom_attention."""
    from transmil_deepgraft_tpu.parallel.mesh import make_mesh
    from transmil_deepgraft_tpu.parallel.sp_nystrom import sp_nystrom_attention as jax_sp

    q = torch.zeros(1, 1, n // sp, 8)
    with pytest.raises(ValueError) as port:
        sp_nystrom_attention(q, q, q, _Mesh(dp=(1, 0), sp=(sp, 0)), num_landmarks=m)
    jq = jnp.zeros((1, 1, n, 8))
    with pytest.raises(ValueError) as jax_err:
        jax_sp(jq, jq, jq, make_mesh(jax.devices()[:sp], dp=1, sp=sp), num_landmarks=m)
    assert str(port.value) == str(jax_err.value)


def test_transmil_tp_specs_match_jax():
    """Every parameter's spec, in the flax layout: the to_qkv kernels column
    parallel, the to_out kernels row parallel, the rest replicated; the
    port's names mapped onto flax paths give JAX's spec for each."""
    from jax.sharding import PartitionSpec as P

    from transmil_deepgraft_tpu.models import create_model as jax_create
    from transmil_deepgraft_tpu.parallel.tp import transmil_tp_specs as jax_specs
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.parallel.tp import transmil_tp_specs

    model = jax_create("TransMIL", n_classes=2, in_features=64, out_features=64)
    shapes = jax.eval_shape(model.init, {"params": jax.random.key(0)}, jnp.zeros((1, 16, 64)))
    want = {"/".join(str(k.key) for k in path): spec for path, spec in
            jax.tree_util.tree_leaves_with_path(jax_specs(shapes["params"]),
                                                is_leaf=lambda x: isinstance(x, P))}
    got = transmil_tp_specs(create_model("TransMIL", 2, 64, 64, device="cpu"))
    sharded = {k: v for k, v in got.items() if v}
    assert sharded == {f"{layer}.attn.{name}": spec for layer in ("layer1", "layer2")
                       for name, spec in (("to_qkv.weight", (None, "tp")),
                                          ("to_out.0.weight", ("tp", None)))}
    for name, spec in sharded.items():
        flax = name.replace(".", "/").replace("/0/weight", "/kernel").replace("/weight", "/kernel")
        assert tuple(want[flax]) == spec, name
    assert {k for k, v in want.items() if tuple(v)} == {
        n.replace(".", "/").replace("/0/weight", "/kernel").replace("/weight", "/kernel")
        for n in sharded}


def _npy_cohort(tmp_path, n_slides=6):
    rng = np.random.default_rng(3)
    data = tmp_path / "feats"
    (data / "FEATURES_RETCCL_2048").mkdir(parents=True)
    labels = {"train": [], "val": [], "test": []}
    for i in range(n_slides):
        np.save(data / "FEATURES_RETCCL_2048" / f"s{i}.npy", rng.standard_normal((int(rng.integers(5, 30)), 8))
                .astype(np.float32))
        labels["train"].append([f"FEATURES_RETCCL_2048/s{i}", i % 2])
    labels["val"] = labels["test"] = labels["train"][:3]
    path = tmp_path / "labels.json"
    path.write_text(json.dumps(labels))
    return str(data), str(path)


@pytest.mark.parametrize("source", ["synthetic", "npy-mixup"])
def test_dp_slices_are_the_one_process_batches(tmp_path, source):
    """Each process's train batch is its contiguous slice of the
    one-process batch, byte for byte: every process walks the shared order
    and draws (the others' items replayed from their tile counts), and
    loads only its own bags; eval batches go to processes whole, in bag
    order."""
    if source == "synthetic":
        kw = dict(synthetic={"n_train": 12, "n_val": 5, "n_test": 4, "bag_size": 20,
                             "feature_size": 8})
    else:
        data, labels = _npy_cohort(tmp_path)
        kw = dict(data_dir=data, label_path=labels, mixup=True)
    dm = MILDataModule(n_classes=2, max_bag_size=16, batch_size=4, seed=7, **kw)
    whole = list(dm.train_batches(1))
    for parts in (2, 4):
        slices = [list(dm.train_batches(1, shard=(i, parts))) for i in range(parts)]
        for b, batch in enumerate(whole):
            got = [s[b] for s in slices]
            np.testing.assert_array_equal(np.concatenate([g.bags for g in got]), batch.bags)
            np.testing.assert_array_equal(np.concatenate([g.labels for g in got]), batch.labels)
            assert sum((g.names for g in got), []) == batch.names
    with pytest.raises(ValueError, match="does not split"):
        next(dm.train_batches(1, shard=(0, 3)))
    evals = list(dm.eval_batches("val", batch_size=2))
    shards = [list(dm.eval_batches("val", batch_size=2, shard=(i, 2))) for i in range(2)]
    assert [b.names for b in shards[0] + shards[1]] == [b.names for b in evals]


def test_cli_infer_n_chips_matches_one_process(tmp_path, monkeypatch):
    """``cli.infer --n_chips 2 --device cpu`` starts two gloo processes
    (one shard of each chunk each, features gathered, rank 0 writing) and
    gives the one-process run's probabilities and top-k tiles; a ragged
    slide leaves one process's shard of the last chunk empty."""
    from flax import serialization
    from PIL import Image

    from tests.test_torch_resnet import perturbed_resnet_variables
    from transmil_deepgraft_tpu_torch.cli.infer import main
    from transmil_deepgraft_tpu_torch.models import create_model

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for var in _CLUSTER:
        monkeypatch.delenv(var, raising=False)
    rng = np.random.default_rng(0)
    root = tmp_path / "BLOCKS"
    for slide, count in (("slideA", 8), ("slideB", 5)):
        (root / slide).mkdir(parents=True)
        for t in range(count):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(
                root / slide / f"tile_({t}-{count}).jpg")
    (tmp_path / "bb.msgpack").write_bytes(
        serialization.msgpack_serialize(perturbed_resnet_variables(2, size=32)))
    torch.manual_seed(0)
    torch.save(create_model("TransMIL", 2, 2048, 32, device="cpu").state_dict(),
               tmp_path / "head.pth")

    def run(k):
        return main(["--tiles_root", str(root), "--backbone_ckpt", str(tmp_path / "bb.msgpack"),
                     "--head_ckpt", str(tmp_path / "head.pth"), "--chunk", "2",
                     "--tile_size", "32", "--topk", "3", "--n_chips", str(k), "--device", "cpu",
                     "--out_dir", str(tmp_path / f"out{k}")])

    one, two = run(1), run(2)
    assert [r["slide"] for r in two] == ["slideA", "slideB"]
    for a, b in zip(one, two):
        assert a["probs"] == b["probs"] and a["pred"] == b["pred"]
        assert ((tmp_path / "out1" / f"{a['slide']}_topk_tiles.csv").read_text()
                == (tmp_path / "out2" / f"{a['slide']}_topk_tiles.csv").read_text())
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="available devices"):  # JAX's check
        main(["--tiles_root", str(root), "--backbone_ckpt", "x", "--head_ckpt", "y",
              "--n_chips", "64", "--device", "cuda"])
