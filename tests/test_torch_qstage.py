"""The port's int8 stage wrappers (``ops/qstage_kernel``) against the JAX
package's Pallas kernels run in interpret mode, at the small shapes of
``tests/test_qstage_kernel.py``: int8 codes equal, and the same ValueErrors.
On the CPU the wrappers take their plain versions; the CUDA kernels are held
to those in ``tests/test_torch_cuda_kernels.py`` on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.models.resnet_int8 import QBlock as JaxQBlock
from transmil_deepgraft_tpu.ops.pallas import qstage_kernel as jk
from transmil_deepgraft_tpu_torch.models.resnet_int8 import QBlock
from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk


def rand_block(rng, cin, cmid, cout, has_ds):
    """The same random block for both packages: (JAX QBlock, port QBlock)."""
    def w(*shape):
        return rng.integers(-127, 128, shape, dtype=np.int8)

    def sc(c):
        return rng.uniform(5e-3, 2e-2, c).astype(np.float32)

    def z(c):
        return rng.uniform(-128.0, -30.0, c).astype(np.float32)

    leaves = [w(1, 1, cin, cmid), sc(cmid), z(cmid), w(3, 3, cmid, cmid), sc(cmid), z(cmid),
              w(1, 1, cmid, cout), sc(cout), z(cout),
              w(1, 1, cin, cout) if has_ds else None, sc(cout) if has_ds else None,
              np.float32(rng.uniform(0.5, 1.5))]
    jax_blk = JaxQBlock(*(None if a is None else jnp.asarray(a) for a in leaves))
    port_blk = QBlock(*(None if a is None else torch.from_numpy(np.array(a)) for a in leaves))
    return jax_blk, port_blk


def codes(rng, shape):
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    return jnp.asarray(x), torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def interior_case():
    rng = np.random.default_rng(0)
    jx, px = codes(rng, (4, 8, 8, 32))
    blocks = [rand_block(rng, 32, 8, 32, True), rand_block(rng, 32, 8, 32, False),
              rand_block(rng, 32, 8, 32, False)]
    want = np.asarray(jk.fused_bottleneck_stage(jx, [b[0] for b in blocks], interpret=True))
    return px, [b[1] for b in blocks], want


@pytest.mark.parametrize("tiles_per_step", [1, 2])
def test_interior_run_matches_jax_kernel(tiles_per_step):
    x, blocks, want = interior_case()
    qk.reset_launch_counts()
    got = qk.fused_bottleneck_stage(x, blocks, tiles_per_step=tiles_per_step)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(qk.stage_reference(x, blocks).numpy(), want)
    assert qk.LAUNCHES == {"qstage_run": 0, "qentry_run": 0, "qstem_run": 0}  # no kernel on the CPU


@pytest.mark.parametrize("tiles_per_step", [1, 3])
def test_entry_block_matches_jax_kernel(tiles_per_step):
    rng = np.random.default_rng(1)
    jx, px = codes(rng, (3, 10, 10, 16))
    jblk, pblk = rand_block(rng, 16, 8, 24, True)
    want = np.asarray(jk.fused_entry_block(jx, jblk, tiles_per_step=tiles_per_step,
                                           interpret=True))
    got = qk.fused_entry_block(px, pblk, tiles_per_step=tiles_per_step)
    assert got.shape == (3, 5, 5, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(qk.entry_reference(px, pblk).numpy(), want)


@pytest.mark.parametrize("tiles_per_step", [1, 2])
def test_wpair_packed_stage_matches_jax_kernel(tiles_per_step):
    rng = np.random.default_rng(4)
    jx, px = codes(rng, (4, 6, 8, 16))
    blocks = [rand_block(rng, 16, 8, 32, True), rand_block(rng, 32, 8, 32, False)]
    want = np.asarray(jk.fused_stage_wpacked(jx, [b[0] for b in blocks],
                                             tiles_per_step=tiles_per_step, interpret=True))
    got = qk.fused_stage_wpacked(px, [b[1] for b in blocks], tiles_per_step=tiles_per_step)
    np.testing.assert_array_equal(got.numpy(), want)
    # the packing is a layout change only: the unpacked stage gives the same codes
    np.testing.assert_array_equal(qk.stage_reference(px, [b[1] for b in blocks]).numpy(), want)


@pytest.mark.parametrize("has_ds", [True, False])
def test_weight_packing_matches_jax(has_ds):
    rng = np.random.default_rng(8)
    jblk, pblk = rand_block(rng, 16, 8, 16, has_ds)
    got, got_ds = qk._pack_block(pblk)
    want, want_ds = jk._pack_block(jblk)
    assert got_ds == want_ds == has_ds
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(qk.pack_wpair_block(pblk), jk.pack_wpair_block(jblk)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_value_errors_match_jax():
    rng = np.random.default_rng(2)
    _, pblk = rand_block(rng, 16, 8, 16, False)
    x = torch.from_numpy(rng.integers(-128, 128, (3, 8, 8, 16), dtype=np.int8))
    with pytest.raises(ValueError, match="downsample"):
        qk.fused_entry_block(x, pblk)
    with pytest.raises(ValueError, match="divisible"):
        qk.fused_bottleneck_stage(x, [pblk], tiles_per_step=2)
    _, ds_blk = rand_block(rng, 16, 8, 16, True)
    with pytest.raises(ValueError, match="divisible"):
        qk.fused_entry_block(x, ds_blk, tiles_per_step=2)
    with pytest.raises(ValueError, match="even"):
        qk.fused_stage_wpacked(x[:, :, :7], [pblk])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        qk.fused_bottleneck_stage(x.to("meta"), [pblk])


# ------------------------------------------- the CUDA kernels' host-side layout

@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("has_ds", [True, False])
def test_prepared_weights_unpack_to_the_jax_packing(one_thread, has_ds):
    """_prepare_block's K-major weights are _pack_block's (K, Cout) arrays
    transposed; the scales are the same stacks; conv2's column sums are the
    sums of its weights; a second call with the same block reuses the
    preparation, one whose tensor changed in place makes a new one."""
    rng = np.random.default_rng(11)
    _, blk = rand_block(rng, 16, 8, 24 if has_ds else 16, has_ds)
    arrays, _ = qk._pack_block(blk)
    prep = qk._prepare_block(blk)
    for got, want in ((prep.w1, arrays[0]), (prep.w2, arrays[2]), (prep.w3, arrays[4])):
        assert got.is_contiguous() and got.dtype == torch.int8
        np.testing.assert_array_equal(got.t().numpy(), want.numpy())
    for got, want in ((prep.sc1, arrays[1]), (prep.sc2, arrays[3]), (prep.sc3, arrays[5])):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if has_ds:
        np.testing.assert_array_equal(prep.wd.t().numpy(), arrays[6].numpy())
        np.testing.assert_array_equal(prep.md.numpy(), arrays[7].numpy().ravel())
    else:
        assert prep.wd is None and prep.md is None
    np.testing.assert_array_equal(prep.id_mult.numpy(), blk.id_mult.numpy().reshape(1))
    assert prep.cs2.dtype == torch.int32
    np.testing.assert_array_equal(prep.cs2.numpy(), arrays[2].numpy().astype(np.int64).sum(0))
    assert (prep.args.cin, prep.args.cmid, prep.args.cout) == (16, 8, 24 if has_ds else 16)

    before = qk.PREPARES["blocks"]
    first = qk._prepared(blk)
    assert qk._prepared(blk) is first and qk.PREPARES["blocks"] == before + 1
    blk.m2.mul_(1.0)  # an in-place change: the block is prepared again
    assert qk._prepared(blk) is not first and qk.PREPARES["blocks"] == before + 2


@pytest.mark.parametrize("stride", [1, 2])
def test_u8_offset_conv2_matches_the_minus_128_pad(one_thread, stride):
    """conv2 as the kernels compute it: h1 stored as u8 = code + 128, the 3x3
    pad filled with the byte 0, the int32 sum less 128 * colsum(w2), gives the
    same sums and codes as the plain block's conv2 over a -128 pad, at every
    pixel of a small image (most of them on its border)."""
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import _conv_q, _rq

    rng = np.random.default_rng(12 + stride)
    _, blk = rand_block(rng, 16, 16, 16, False)
    h1 = torch.from_numpy(rng.integers(-128, 128, (2, 6, 8, 16), dtype=np.int8))
    h1[0, :, 0] = -128  # a column of pad-valued codes next to the pad
    want = _conv_q(torch.nn.functional.pad(h1, (0, 0, 1, 1, 1, 1), value=-128), blk.w2, stride)

    cmid = blk.w2.shape[-1]
    prep = qk._prepare_block(blk)
    u8 = (h1.to(torch.int64) + 128).numpy()
    padded = np.zeros((2, 8, 10, cmid), np.int64)
    padded[:, 1:-1, 1:-1] = u8
    ho, wo = 6 // stride, 8 // stride
    cols = np.concatenate([padded[:, di:di + (ho - 1) * stride + 1:stride,
                                  dj:dj + (wo - 1) * stride + 1:stride]
                           for di in range(3) for dj in range(3)], axis=-1)
    acc = cols @ prep.w2.numpy().astype(np.int64).T  # u8 x s8, K-major weights
    acc -= 128 * prep.cs2.numpy().astype(np.int64)
    assert np.abs(acc).max() < 2 ** 31
    np.testing.assert_array_equal(acc, want.numpy().astype(np.int64))
    got_q = _rq(torch.from_numpy(acc).double(), blk.m2, blk.z2)
    np.testing.assert_array_equal(got_q.numpy(), _rq(want, blk.m2, blk.z2).numpy())
