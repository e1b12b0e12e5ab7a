"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. The repo's tests/conftest.py
sets up JAX, which the GPU machine does not have, so run this file alone:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu_torch.models.resnet_int8 import QBlock
from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 3000, 4096], ids=["n257", "n3000", "n4096-no-pad"])
@pytest.mark.parametrize("b", [1, 2], ids=["batch1", "batch2"])
def test_cuda_kernels_match_plain_versions(cuda_device, b, n):
    """K1 and K2 against their plain versions at full width (D 512, 8 heads,
    256 landmarks), batch 1 and 2, with a front pad (none at n = 4,096) and a
    non-zero LN bias: within 1e-3 and within 1e-4, the bar of the 3xTF32
    split. Then w_qkv and w_out change in place and a second call is held to
    the plain version on the new weights (the split is made per call). K1/K2
    count one launch a call; the landmark kernels they run count none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n + b)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)

    dim = 512
    x = t(rng.standard_normal((b, n, dim)))
    ln_w, ln_b = t(1 + 0.1 * rng.standard_normal(dim)), t(0.5 * rng.standard_normal(dim))
    w_qkv = t(rng.standard_normal((3 * dim, dim)) / np.sqrt(dim))
    w_out, b_out = t(rng.standard_normal((dim, dim)) / np.sqrt(dim)), t(rng.standard_normal(dim))
    res = t(rng.standard_normal((b, n, dim)))
    n_pad = tk.landmark_pad(n, 256)
    assert (n_pad == 0) == (n == 4096)
    tk.reset_launch_counts()
    nk.reset_launch_counts()
    for call in range(2):
        q_lm, k_lm, pinv = tk.landmark_glue(x, n_pad, ln_w, ln_b, w_qkv, heads=8, dim_head=64,
                                            num_landmarks=256, pinv_iterations=6)
        k1_args = (x, n_pad, ln_w, ln_b, w_qkv[dim:], q_lm)
        want_a, want_v = tk.k1_reference(*k1_args)
        bmat = (pinv @ want_a).contiguous()
        k2_args = (x, res, ln_w, ln_b, w_qkv[:dim], k_lm, bmat, w_out, b_out, 0.125)
        got = (*tk.translayer_k1(*k1_args), tk.translayer_k2(*k2_args))
        torch.cuda.synchronize()
        for g, want in zip(got, (want_a, want_v, tk.k2_reference(*k2_args))):
            assert (g - want).abs().max().item() <= 1e-3
            assert (g - want).abs().max().item() <= 1e-4
        with torch.no_grad():  # as an optimizer step does, between two calls
            w_qkv.mul_(0.9).add_(0.01)
            w_out.mul_(1.1)
    assert tk.LAUNCHES == {"translayer_k1": 2, "translayer_k2": 2}
    assert nk.LAUNCHES == {"nystrom_landmark_attn": 0, "nystrom_query_lm": 0}


@pytest.mark.cuda
def test_translayer_gemm_matches_float64_linear(cuda_device):
    """The projections' GEMM alone (the out projection with res, x and b_out
    zero: y = O W^T) at a ragged M = 1,000 (not a multiple of its 128-row
    tile) against float64 ``F.linear``, within 1e-4; rows past M untouched."""
    rng = np.random.default_rng(11)
    rows, dim = 1000, 512
    o = torch.from_numpy(rng.standard_normal((1, rows, dim), dtype=np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32))
    w = w.to(cuda_device)
    zeros = torch.zeros_like(o)
    y = torch.full((1, rows + 1, dim), 7.0, device=cuda_device)
    tk._out_projection(o, zeros, zeros, w, zeros[0, 0], y[:, :rows])
    torch.cuda.synchronize()
    want = torch.nn.functional.linear(o.double(), w.double())
    assert (y[:, :rows].double() - want).abs().max().item() <= 1e-4
    assert bool((y[:, rows:] == 7.0).all())


def _rand_qblock(rng, dev, cin, cmid, cout, has_ds):
    """Random int8 block with fma constants that spread the codes over the
    whole int8 range."""
    def w(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)

    def sc(c, k):  # |acc| ~ sqrt(K) * 73^2 for uniform codes -> ~60 code units
        m = rng.uniform(0.5, 1.5, c) * 60 / (np.sqrt(k) * 73 * 73)
        return torch.from_numpy(m.astype(np.float32)).to(dev)

    def z(c):
        return torch.from_numpy(rng.uniform(-30.0, 30.0, c).astype(np.float32)).to(dev)

    return QBlock(w(1, 1, cin, cmid), sc(cmid, cin), z(cmid),
                  w(3, 3, cmid, cmid), sc(cmid, 9 * cmid), z(cmid),
                  w(1, 1, cmid, cout), sc(cout, cmid), z(cout),
                  w(1, 1, cin, cout) if has_ds else None,
                  sc(cout, cin) if has_ds else None,
                  torch.tensor(rng.uniform(0.5, 1.5), dtype=torch.float32, device=dev))


def _check_repeat_call(run, first, kernel: str) -> None:
    """A second call gives the same codes bit for bit, prepares no block
    again, and launches the kernel once more."""
    prepared = qk.PREPARES["blocks"]
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(again, first)
    assert qk.PREPARES["blocks"] == prepared
    assert qk.LAUNCHES == {"qstage_run": 0, "qentry_run": 0, "qstem_run": 0, kernel: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 56, 64, 64, 256), (2, 14, 1024, 256, 1024),
                                   (1, 28, 512, 128, 512), (1, 7, 2048, 512, 2048)],
                         ids=["stage1", "stage3", "stage2_batch1", "stage4_batch1"])
def test_qstage_kernel_matches_plain_version(cuda_device, shape):
    """B7: a run of stride-1 bottlenecks (the first with a downsample when the
    width changes) at the widths of s1, i2, i3 and i4; every case's row count
    (N*H*W) is not a multiple of the 128-row tile. int8 codes equal to the
    plain version's; a second call agrees bit for bit and prepares nothing."""
    n, hw, cin, cmid, cout = shape
    rng = np.random.default_rng(hw)
    x = torch.from_numpy(rng.integers(-128, 128, (n, hw, hw, cin), dtype=np.int8)).to(cuda_device)
    blocks = [_rand_qblock(rng, cuda_device, cin, cmid, cout, cin != cout),
              _rand_qblock(rng, cuda_device, cout, cmid, cout, False)]
    assert (n * hw * hw) % 128
    qk.reset_launch_counts()
    got = qk.fused_bottleneck_stage(x, blocks)
    torch.cuda.synchronize()
    want = qk.stage_reference(x, blocks)
    assert torch.unique(want).numel() > 200  # the check sees the whole code range
    assert int((got != want).sum()) == 0
    assert qk.LAUNCHES == {"qstage_run": 1, "qentry_run": 0, "qstem_run": 0}
    _check_repeat_call(lambda: qk.fused_bottleneck_stage(x, blocks), got, "qstage_run")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 56, 256, 128, 512), (2, 28, 512, 256, 1024),
                                   (1, 14, 1024, 512, 2048)],
                         ids=["layer2_0", "layer3_0", "layer4_0_batch1"])
def test_qentry_kernel_matches_plain_version(cuda_device, shape):
    """B8: one stride-2 stage-entry bottleneck with its downsample, at the
    widths of e2, e3 and e4 (output rows 2,352, 392 and 49: none a multiple
    of 128); a second call agrees bit for bit and prepares nothing."""
    n, hw, cin, cmid, cout = shape
    rng = np.random.default_rng(hw + 1)
    x = torch.from_numpy(rng.integers(-128, 128, (n, hw, hw, cin), dtype=np.int8)).to(cuda_device)
    blk = _rand_qblock(rng, cuda_device, cin, cmid, cout, True)
    qk.reset_launch_counts()
    got = qk.fused_entry_block(x, blk)
    torch.cuda.synchronize()
    want = qk.entry_reference(x, blk)
    assert got.shape == (n, hw // 2, hw // 2, cout)
    assert torch.unique(want).numel() > 200
    assert int((got != want).sum()) == 0
    assert qk.LAUNCHES == {"qstage_run": 0, "qentry_run": 1, "qstem_run": 0}
    _check_repeat_call(lambda: qk.fused_entry_block(x, blk), got, "qentry_run")


@pytest.mark.cuda
def test_qstage_kernel_exact_on_large_sums(cuda_device):
    """Sums past 2^22 (inputs and weights near 127 at K = 4,608) take the
    epilogue's exact int-to-float path; the codes still equal the plain
    version's."""
    rng = np.random.default_rng(3)
    n, hw, c = 1, 7, 512
    x = torch.from_numpy(rng.integers(100, 128, (n, hw, hw, c), dtype=np.int8)).to(cuda_device)
    blk = _rand_qblock(rng, cuda_device, c, c, c, False)

    def near_max(*shape):
        return torch.from_numpy(rng.integers(100, 128, shape, dtype=np.int8)).to(cuda_device)

    blk = blk._replace(w1=near_max(1, 1, c, c), w2=near_max(3, 3, c, c),
                       m1=torch.full_like(blk.m1, 1e-4), z1=torch.full_like(blk.z1, 100.0),
                       m2=torch.full_like(blk.m2, 1e-5))
    got = qk.fused_bottleneck_stage(x, [blk])
    torch.cuda.synchronize()
    want = qk.stage_reference(x, [blk])
    assert torch.unique(want).numel() > 100
    assert int((got != want).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("real", [100, 37], ids=["batch-100", "ragged-37-of-100"])
def test_int8_resnet_at_the_extraction_batch(cuda_device, real):
    """The int8 ResNet50 at feature extraction's batch: 100 tiles of 224x224
    (the ragged last batch: 37 real tiles, zero-padded to 100), through
    ``apply_qresnet50`` (the kernels, one tile per step) and
    ``apply_qresnet50_fused`` with extraction's t_cfg (1, 1, 2, 1, 2, 1, 2):
    both give the all-plain route's features (the torch-op stem, then the
    plain block loop) bit for bit (the same codes), each with 1 stem, 4 stage
    and 3 entry launches."""
    from transmil_deepgraft_tpu_torch.data.feature_extractor import FUSED_T_CFG
    from transmil_deepgraft_tpu_torch.models import resnet_int8 as qr
    from transmil_deepgraft_tpu_torch.models.resnet import resnet50
    from transmil_deepgraft_tpu_torch.utils.jax_params import variables_from_module

    rng = np.random.default_rng(real)
    torch.manual_seed(real)
    net = resnet50()
    with torch.no_grad():  # non-trivial BatchNorm, so that the fold matters
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.05, 0.05)
                m.running_mean.uniform_(-0.05, 0.05)
                m.running_var.uniform_(0.9, 1.1)
    tiles = rng.standard_normal((100, 224, 224, 3)).astype(np.float32)
    tiles[real:] = 0.0
    q = qr.build_qresnet50(variables_from_module(net), tiles[:8], device=cuda_device)
    prep = qr.prepare_qresnet50_fused(q)
    x = torch.from_numpy(tiles).to(cuda_device)
    stage1 = qr._plain_blocks(qk.stem_reference(x, q), q.blocks[0:3], [1] * 3)
    want = qr._pool(q, qr._later_stages(q, stage1, (0,) * 6))
    for run in (lambda: qr.apply_qresnet50(q, x),
                lambda: qr.apply_qresnet50_fused(prep, x, t_cfg=FUSED_T_CFG)):
        qk.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        assert qk.LAUNCHES == {"qstage_run": 4, "qentry_run": 3, "qstem_run": 1}
        assert torch.equal(got, want)


# (N, H, W, what the tiles and the stem hold); every case's codes are held
# to the torch-op stem on the same CUDA tensors
STEM_CASES = {
    "batch1-224": (1, 224, 224, "normal"),
    "extraction-100-224": (100, 224, 224, "normal"),
    "chunk-128-224": (128, 224, 224, "normal"),
    "small-32": (3, 32, 32, "normal"),
    "ragged-36x68": (2, 36, 68, "normal"),
    "ties-at-half": (4, 64, 64, "ties"),
    "clamped": (4, 64, 64, "clamped"),
    "largest-sums": (4, 64, 64, "largest"),
    "floor-rows": (4, 64, 64, "floor"),
}


def _stem_case(rng, dev, n, h, w, kind):
    """A ``QResNet50`` that carries only a stem, and (N, H, W, 3) float32
    tiles, for one of ``STEM_CASES``:
      normal   tiles N(0, 1), input scale 4/127, random int8 weights;
      ties     input scale 2^-5 and tiles (k + 1/2) * scale, so that every
               quotient lies exactly half-way (round half to even);
      clamped  tiles up to 300 * scale, so that most codes clamp to +-127;
      largest  weights all +127 (even channels) or -127 (odd), tiles of
               300 * scale in half the images: sums up to 192 * 127^2;
      floor    the lower half of each tile zero and z = -140 for every
               channel, so that its pooled rows are all -128.
    The fma constants spread the other codes over the int8 range."""
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import QResNet50

    s = np.float32(2.0 ** -5 if kind == "ties" else 4.0 / 127)
    x = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    wq = rng.integers(-127, 128, (4, 4, 12, 64), dtype=np.int8)
    if kind == "ties":
        x = ((rng.integers(-131, 131, x.shape) + 0.5) * s).astype(np.float32)
        assert np.all(x / s - np.floor(x / s) == 0.5)
    elif kind in ("clamped", "largest"):
        x = (rng.uniform(-300.0, 300.0, x.shape) * s).astype(np.float32)
    if kind == "largest":
        x[::2] = 300.0 * s
        wq = np.broadcast_to(np.where(np.arange(64) % 2, -127, 127), wq.shape).astype(np.int8)
    elif kind == "floor":
        x[:, h // 2:] = 0.0
    codes = np.clip(np.round(x / s), -127, 127)
    if kind == "largest":  # the largest sum lands near the clip
        spread = 192.0 * 127 ** 2
    else:  # the sums' rms
        spread = np.sqrt(192.0 * np.mean(codes ** 2) * np.mean(wq.astype(np.float64) ** 2))
    m = rng.uniform(0.5, 1.5, 64) * {"largest": 100.0, "floor": 150.0}.get(kind, 60.0) / spread
    z = np.full(64, -140.0) if kind == "floor" else rng.uniform(-30.0, 30.0, 64)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype, order="C")).to(dev)

    q = QResNet50(stem_w=t(wq, np.int8), stem_m=t(m), stem_z=t(z), input_scale=t(s),
                  blocks=(), final_scale=t(1.0), truncate_after=4, feature_dim=2048)
    return q, t(x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEM_CASES))
def test_stem_kernel_matches_plain_stem(cuda_device, case):
    """The stem kernel (``_stem_q`` on a CUDA tensor) against the torch-op
    stem on the same tensors: every int8 code equal, at extraction's 100 and
    the slide's 128 tiles of 224x224, one tile, small and ragged tiles
    (pooled sizes 8x8 and 9x17: partial blocks), quotients exactly half-way,
    inputs far past the clamp, the largest sums, and pooled rows all at the
    -128 floor. One launch, counted in ``LAUNCHES`` and, under a profiler,
    as ``backbone.stem_kernel`` inside one ``backbone.stem`` span."""
    from transmil_deepgraft_tpu_torch.models import resnet_int8 as qr
    from transmil_deepgraft_tpu_torch.utils import profiling

    n, h, w, kind = STEM_CASES[case]
    rng = np.random.default_rng(list(STEM_CASES).index(case))
    q, x = _stem_case(rng, cuda_device, n, h, w, kind)
    qk.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = qr._stem_q(q, x)
    seen = profiling.snapshot()
    torch.cuda.synchronize()
    want = qk.stem_reference(x, q)
    assert got.shape == want.shape == (n, h // 4, w // 4, 64)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert int((got != want).sum()) == 0
    assert qk.LAUNCHES == {"qstage_run": 0, "qentry_run": 0, "qstem_run": 1}
    assert seen["counters"] == {"backbone.stem_kernel": 1}
    assert seen["spans"]["backbone.stem"]["calls"] == 1
    if kind == "floor":  # pooled rows past h/8 + 2 read only zero tiles
        assert bool((want[:, h // 8 + 2:] == -128).all())
        assert torch.unique(want[:, :h // 8]).numel() > 100
    else:  # the check sees much of the code range
        assert torch.unique(want).numel() > 120


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(2, 1280), (1, 41472), (2, 1000)],
                         ids=["train-1280", "bag-41472", "ragged-1000"])
@pytest.mark.parametrize("form", ["packed", "bh"])
def test_nystrom_kernels_match_plain_versions(cuda_device, form, b, n):
    """B5/B6 on a packed qkv and B3/B4 on (b*h, n, d) arrays, 8 heads of 64,
    256 landmarks: at the training shape (n = 1,280), at a 40,960-tile bag
    (n = 41,472) and at a ragged n = 1,000 (not a multiple of the 64-key
    tile). Each within 1e-3 and within 1e-4, the bar of the 3xTF32 split
    (measured up to 9.9e-6; one-pass TF32 is off by ~7e-4 at the training
    shape). The landmark kernel leaves its per-tile counters at zero, so a
    second call gives the same result bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    h, d, m = 8, 64, 256

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(cuda_device)

    qkv, q_lm = t(b, n, 3, h, d), t(b, h, m, d, scale=0.125)
    k_lm, bmat = t(b, h, m, d, scale=0.125), t(b, h, m, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, d) views
    nk.reset_launch_counts()
    if form == "packed":
        def landmark():
            return nk.landmark_attention_packed(q_lm, qkv)
        got_q = nk.query_landmark_attention_packed(qkv, k_lm, bmat).transpose(1, 2)
    else:
        flat = [x.reshape(b * h, -1, d).contiguous() for x in (q_lm, q, k, v, k_lm, bmat)]

        def landmark():
            return nk.landmark_attention(flat[0], flat[2], flat[3]).reshape(b, h, m, d)
        got_q = nk.query_landmark_attention(flat[1], flat[4], flat[5]).reshape(b, h, n, d)
    got_a, again = landmark(), landmark()
    torch.cuda.synchronize()
    want_a = nk.landmark_attention_reference(q_lm, k, v)
    want_q = nk.query_landmark_attention_reference(q, k_lm, bmat)
    assert (got_a - want_a).abs().max().item() <= 1e-3
    assert (got_q - want_q).abs().max().item() <= 1e-3
    assert (got_a - want_a).abs().max().item() <= 1e-4
    assert (got_q - want_q).abs().max().item() <= 1e-4
    assert torch.equal(got_a, again)
    for buf, words in nk._SCRATCH.values():
        assert int(buf[:words].view(torch.int32).abs().max()) == 0
    assert nk.LAUNCHES == {"nystrom_landmark_attn": 2, "nystrom_query_lm": 1}


def layernormed_qkv(rng, b: int, n: int, device, h: int = 8, d: int = 64):
    """A packed (b, n, 3, h, d) qkv as a TransLayer makes it: LayerNorm rows
    whose bias is 0.5 * N(0, 1) per column, so V's columns have a non-zero
    mean; and the scaled q landmarks (segment means of the q plane)."""
    x = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d), dtype=np.float32)).to(device)
    bias = torch.from_numpy((0.5 * rng.standard_normal(3 * h * d)).astype(np.float32)).to(device)
    qkv = torch.nn.functional.layer_norm(x, (3 * h * d,), None, bias).view(b, n, 3, h, d)
    q = qkv[:, :, 0].transpose(1, 2)
    q_lm = (q.reshape(b, h, 256, n // 256, d).mean(3) * d ** -0.5).contiguous()
    return qkv, q_lm


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 41472), (2, 1280)], ids=["bag-41472", "train-1280"])
def test_landmark_kernel_holds_long_splits_with_biased_values(cuda_device, b, n):
    """B5 on a LayerNorm'd qkv (V's columns carry a 0.5 * N(0, 1) bias) at a
    40,960-tile bag (81 key tiles a split on 132 SMs) and at the training
    shape: within 1e-4 of the plain version. Accumulating P V onto the
    running sum on the tensor cores, which truncate, was off by 1.9e-4 at
    n = 41,472 on an H100."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, q_lm = layernormed_qkv(np.random.default_rng(7), b, n, cuda_device)
    got = nk.landmark_attention_packed(q_lm, qkv)
    torch.cuda.synchronize()
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    want = nk.landmark_attention_reference(q_lm, k, v)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n", [(16, 1280), (8, 41472), (128, 512)],
                         ids=["splits-1280", "splits-41472", "one-split-512"])
def test_landmark_kernel_row_statistics_match_plain_version(cuda_device, bh, n):
    """B3 with its row statistics, as sequence parallelism calls it: each
    landmark row's log-sum-exp of the scores (natural base) within 1e-4 of
    the plain version's ``torch.logsumexp``, written by the merging block
    (several splits) and by the block of a lone split; the rows within 1e-4
    as without statistics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bh + n)
    q_lm = torch.from_numpy((0.125 * rng.standard_normal((bh, 256, 64))).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((bh, n, 64)).astype(np.float32))
            for _ in range(2))
    q_lm, k, v = q_lm.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    per, splits = nk.landmark_plan(bh, n, nk._sm_count(cuda_device.index or 0))
    assert (splits == 1) == (n == 512)
    got, lse = nk.landmark_attention(q_lm, k, v, return_stats=True)
    torch.cuda.synchronize()
    want, want_lse = nk.landmark_attention_reference(q_lm, k, v, return_stats=True)
    assert lse.shape == (bh, 256)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1280, 512])
def test_landmark_kernel_without_statistics_is_unchanged(cuda_device, n):
    """The statistics pointer is null by default: the rows of a call without
    it are bit for bit those of a call with it, and the packed route (B5),
    which never asks for them, repeats itself bit for bit."""
    rng = np.random.default_rng(n)
    bh = 16 if n == 1280 else 128
    q_lm = torch.from_numpy((0.125 * rng.standard_normal((bh, 256, 64))).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((bh, n, 64)).astype(np.float32))
            for _ in range(2))
    q_lm, k, v = q_lm.to(cuda_device), k.to(cuda_device), v.to(cuda_device)
    plain = nk.landmark_attention(q_lm, k, v)
    with_stats, _ = nk.landmark_attention(q_lm, k, v, return_stats=True)
    qkv = torch.stack([k.view(2, bh // 2, n, 64)] * 3, dim=2).permute(0, 3, 2, 1, 4).contiguous()
    packed = [nk.landmark_attention_packed(q_lm.view(2, bh // 2, 256, 64), qkv)
              for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(plain, with_stats)
    assert torch.equal(packed[0], packed[1])


@pytest.mark.cuda
def test_nystrom_landmark_launcher_refuses_a_bad_plan(cuda_device):
    """The landmark kernel's C launcher checks the plan it is given: a split
    plan that misses a key tile, or scratch too small for its partials or
    counters, returns cudaErrorInvalidValue and launches nothing. A plan
    from landmark_plan with the wrappers' scratch is taken."""
    b, h, n, d, m = 2, 8, 1280, 64, 256
    lib = nk._library()  # raises if the library's tiling is not the wrappers'
    q_lm = torch.zeros(b, h, m, d, device=cuda_device)
    kv = torch.zeros(b, h, n, d, device=cuda_device)
    out = torch.empty_like(q_lm)
    tiles = b * h * m // nk.LANDMARK_ROWS
    per, splits = nk.landmark_plan(b * h, n, 132)
    assert splits > 1
    part = torch.empty(tiles * splits * nk._PARTIAL, device=cuda_device)
    counters = torch.zeros(tiles, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(per, splits, part_floats, counter_words):
        return lib.nystrom_landmark_attn(
            q_lm.data_ptr(), kv.data_ptr(), kv.data_ptr(), h * n * d, n * d, d, out.data_ptr(),
            None, part.data_ptr(), part_floats, counters.data_ptr(), counter_words, b, h, n, per,
            splits, stream)

    invalid = 1  # cudaErrorInvalidValue
    assert launch(per, splits - 1, part.numel(), tiles) == invalid  # the last key tiles missed
    assert launch(per, splits, part.numel() - 1, tiles) == invalid
    assert launch(per, splits, part.numel(), tiles - 1) == invalid
    assert launch(per, splits, part.numel(), tiles) == 0
    torch.cuda.synchronize()
    assert int(counters.abs().max()) == 0


@pytest.mark.cuda
def test_hutchinson_diagonal_takes_a_twice_differentiable_attention_route(cuda_device):
    """AdaHessian's Hessian-vector product through TransformerMIL on the card:
    outside the Hessian route its dense attention is SDPA's memory-efficient
    backend, which has no double backward; ``value_grad_and_diag_hessian``
    runs the plain formula, and the diagonal equals the CPU's with the same
    probes within 1e-3 of its largest entry (float32 sums in another
    order)."""
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.train.adahessian import (
        rademacher, value_grad_and_diag_hessian)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    cpu = create_model("TransformerMIL", 2, 64, 32, device="cpu").eval()
    card = create_model("TransformerMIL", 2, 64, 32, device=cuda_device).eval()
    card.load_state_dict({k: v.to(cuda_device) for k, v in cpu.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 300, 64), np.float32))
    zs = rademacher(list(cpu.parameters()), torch.Generator().manual_seed(1))
    diags = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        xd = x.to(dev)
        _, _, diag = value_grad_and_diag_hessian(lambda: model(xd)[0, 1] - model(xd)[0, 0],
                                                 list(model.parameters()),
                                                 zs=[z.to(dev) for z in zs])
        diags.append([d.cpu() for d in diag])
    scale = max(d.abs().max().item() for d in diags[0])
    assert scale > 0
    for want, got in zip(*diags):
        assert (want - got).abs().max().item() <= 1e-3 * scale
    with pytest.raises(RuntimeError):  # SDPA's route has no double backward
        loss = card(x.to(cuda_device))[0, 1]
        (g,) = torch.autograd.grad(loss, [next(card.parameters())], create_graph=True)
        torch.autograd.grad(g.sum(), [next(card.parameters())])
