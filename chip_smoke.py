#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``transmil_deepgraft_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still builds and serves.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``transmil_deepgraft_tpu_torch/csrc`` with nvcc;
2. holds K1/K2 against their plain PyTorch versions (within 1e-3 and 1e-4)
   on one full-width TransLayer (D 512, 8 heads, 256 landmarks) at
   n = 65,537 + 255 front pad (the 40,960-tile request's layer) with a
   non-zero LayerNorm bias, times both with CUDA events (a call, back to
   back) beside the split-TF32 and float32-SIMT bounds, logs the device time
   of each part, the projections' work as one ``F.linear``, and the card's
   TF32 tensor-core ceilings (``tools/mma_tf32_peak.cu``);
3. serves four feature bags (300, 3,000, 12,000 and 40,960 tiles of 2048-d
   features) through a ``ServingBundle`` + ``MicroBatcher`` of a TransMIL head
   with seeded random weights, checks that each kernel ran twice per request
   and that the logits match the same model's plain path on the card, then one
   ``predict_logits_with_attention``;
4. checks the port against the frozen torch-parity fixture
   ``tests/fixtures/parity_transmil_2048.npz`` on the card;
5. makes a full-width ResNet50 from seeded random weights, builds its int8
   model (``build_qresnet50``, 8 calibration tiles of 224x224) on the card,
   holds the stage and entry kernels against their plain versions on the
   seven segments of one chunk (stage 1, then entry + interior of stages 2-4),
   code for code, logs the share of saturated codes, and times each at 128
   tiles beside its bound and the kernels' traffic floor;
6. serves 300 uint8 tiles (3 chunks of 128, the last ragged) through
   ``SlideInferencePipeline`` -> int8 ResNet50 -> TransMIL, checks the launch
   counts of all four kernels, the probabilities against the same pipeline on
   the all-plain route, and the int8 features against the float ResNet50;
7. holds the Nystrom landmark kernels (B5/B6 on a packed qkv, B3/B4 on
   (b*h, n, d) arrays) against their plain versions at the training shape
   (n = 1,280), at a 40,960-tile bag (n = 41,472) and at the configs' train
   batch (64 bags of 200 tiles, n = 256), B3/B4 also at a ragged n = 1,000,
   checks that two landmark-kernel calls in a row agree, checks the
   fused attention's forward and analytic backward against autograd through
   the plain op, and times the kernels (per call, back to back, the host's
   enqueue and the device's time), their plain versions and the one PyTorch
   call that computes the same function, beside two bounds (split-TF32 tensor
   cores, float32 SIMT); B5 also on a LayerNorm'd qkv (V's columns biased) at
   both shapes, within 1e-4;
8. serves through the port's entry points: ``cli.export_model`` writes a
   TransMIL-2048 head bundle and an int8 slide bundle (224x224, chunk 128)
   from .pth checkpoints, ``cli.serve``'s daemon answers /health, /predict
   (a 12,000-tile bag, within 1e-5 of the bundle in-process), /predict_slide
   (300 uint8 tiles, with and without attention, within 1e-3 of the pipeline
   after the same bucket pad), sheds a burst past its queue with 503 +
   Retry-After and counts it all in /metrics; ``cli.infer`` streams 2 slides x
   256 JPEG tiles from disk (within 1e-3 and the same top-10 as
   ``predict_slide_with_attention`` on the decoded tiles); exact launch counts
   of B7/B8 and K1/K2 on every route; request ms, slide s, decode tiles/s;
9. trains TransMIL-2048 with ``use_pallas=True`` through ``MILDataModule`` ->
   ``Trainer.fit`` (2 epochs of 32 synthetic 1,000-tile bags, lookahead_radam,
   grad_acc 2) and ``Trainer.test``, checks the launch counts of B5/B6 and
   K1/K2, holds 8 optimizer steps against the all-plain route, times the
   optimizer step by part, and runs one forward + backward at 40,960 tiles;
10. trains through the port's ``cli.train`` from 192 slides of 200-1,000
   2048-d tiles written as .npy files, with the repository's
   ``configs/DeepGraft/TransMIL_feat_norm_rest.yaml`` (train batch 64 x 200
   tiles, grad_acc 2, radam, precision 16-mixed) cut to 2 epochs: run 1 as
   written (bf16) and ``--stage test`` over its checkpoints, run 2 with
   ``use_pallas`` in float32 and a 2-fold run, run 3 all plain (held to run
   2 within 1e-4), bf16 against float32 at run 1's weights (within 5e-2),
   exact launch counts of B5/B6 and K1/K2 on each run, the optimizer step at
   64 x 200 by part with the device's busy share (torch.profiler), and one
   epoch's train batches from the .npy files against the bag store.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero; without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (data sheet)
H100_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor-core rate (data sheet)
H100_INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor-core rate (data sheet)
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
TOL = 1e-3
# The split-TF32 kernels (TransLayer projections, Nystrom landmark kernels)
# against their plain versions: their 3xTF32 split keeps float32 accuracy
# (max |err| up to 9.9e-6 for the Nystrom kernels on an H100), where one-pass
# TF32 is off by ~7e-4 at the training shape, inside TOL.
SPLIT_TOL = 1e-4
REQUEST_TILES = (300, 3000, 12000, 40960)
ATTENTION_TILES = 3000
LAYER_TOKENS = 256 * 256 + 1  # the 40,960-tile request: bucket 65,536 -> 256^2 grid + cls
SMOKE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
KERNEL_SOURCE = "transmil_deepgraft_tpu_torch/csrc/translayer.cu"
QSTAGE_SOURCE = "transmil_deepgraft_tpu_torch/csrc/qstage.cu"
NYSTROM_SOURCE = "transmil_deepgraft_tpu_torch/csrc/nystrom.cu"
REPLACES = {
    "translayer_k1": "transmil_deepgraft_tpu/ops/pallas/translayer_kernel.py:52",
    "translayer_k2": "transmil_deepgraft_tpu/ops/pallas/translayer_kernel.py:112",
    "qstage_run": "transmil_deepgraft_tpu/ops/pallas/qstage_kernel.py:54",
    "qentry_run": "transmil_deepgraft_tpu/ops/pallas/qstage_kernel.py:254",
    # B5 (pallas_call at :297; B3, the (b*h, n, d) form, at :102)
    "nystrom_landmark_attn": "transmil_deepgraft_tpu/ops/pallas/nystrom_kernel.py:297",
    # B6 (pallas_call at :319; B4 at :151)
    "nystrom_query_lm": "transmil_deepgraft_tpu/ops/pallas/nystrom_kernel.py:319",
}
TILE = 224  # the tile size of the slide pipeline
CHUNK = 128  # tiles per backbone call (bench.py's chunk)
CALIB_TILES = 8
COMPARE_TILES = 32  # tiles on which each int8 segment is held to its plain version
SLIDE_TILES = 300  # 3 chunks, the last one ragged
FP32_CHECK_TILES = 64
TRAIN_N = 1280  # a 1,000-tile train bag: 32^2 grid + cls, landmark-padded
RAGGED_N = 1000  # B3/B4 take any n: not a multiple of the 64-key tile
BIG_N = 41472  # a 40,960-tile bag: 203^2 grid + cls, landmark-padded
TRAIN_BAG = 1000  # the JAX CLI's default bag_size
TRAIN_SPLITS = {"n_train": 32, "n_val": 16, "n_test": 16}
TRAIN_EPOCHS = 2
GRAD_ACC = 2
PARITY_STEPS = 8  # optimizer steps held against the all-plain route
BIG_BAG = 40960
SERVE_BAG = 12000  # the /predict request of the serve phase
DISK_TILES = 256  # JPEG tiles a slide on disk (two slides)
# the cli_train cohort: 2048-d feature bags of 200-1,000 tiles as .npy files
CLI_CONFIG = "transmil_deepgraft_tpu/configs/DeepGraft/TransMIL_feat_norm_rest.yaml"
CLI_SPLITS = {"train": 128, "val": 32, "test": 32}
CLI_TILES = (200, 1000)
CLI_EPOCHS = 2
CLI_BATCH, CLI_BAG = 64, 200  # the config's train batch and bag_size
CLI_N = 256  # a 200-tile bag: 15^2 grid + cls, landmark-padded
BF16_BAR = 5e-2  # the bfloat16 bar's cap per logit (PERF.md section 2)
TIMED_STEPS = 6  # optimizer steps timed at 64 x 200 after a warm-up one


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between two
    CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def cuda_ms_back_to_back(fn, calls: int = 50, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``calls`` back-to-back runs between
    one pair of CUDA events: the device's share, where ``cuda_ms`` also holds
    the host's work of one call."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int = 200) -> float:
    """Mean microseconds of the host's clock to enqueue ``fn()`` (no
    synchronize inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, calls: int = 20) -> float:
    """Mean microseconds of device time of ``fn()`` (``torch.profiler``: the
    kernels' own time, no launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls


def kernel_costs(n: int, n_pad: int, dim: int = 512, landmarks: int = 256) -> dict:
    """(float operations, least bytes) of each kernel on one (1, n, dim) input:
    every input read once, every output written once, float32."""
    act, w, lm, vec = n * dim * 4, dim * dim * 4, landmarks * dim * 4, dim * 4
    return {
        # LN -> [K|V] = LN(x) W_kv^T (2*dim outputs) -> q_lm K^T and P V over n+n_pad keys
        "translayer_k1": (2 * n * dim * 2 * dim + 2 * 2 * landmarks * (n + n_pad) * dim,
                          act + 2 * vec + 2 * w + lm + lm + act),
        # LN -> Q -> Q k_lm^T and P B -> W_out over n rows
        "translayer_k2": (2 * n * dim * dim * 2 + 2 * 2 * landmarks * n * dim,
                          2 * act + 3 * vec + 2 * w + 2 * lm + act),
    }


def random_transmil_params(rng, in_features: int, n_classes: int, dim: int = 512) -> dict:
    """Flax-layout TransMIL params (nested numpy dicts) from ``rng``, fan-in
    scaled, with non-zero LayerNorm biases."""
    import numpy as np

    def dense(i, o, bias=True):
        p = {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p["bias"] = (0.02 * rng.standard_normal(o)).astype(np.float32)
        return p

    def norm(c):
        return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    def layer():
        return {"norm": norm(dim), "attn": {
            "to_qkv": dense(dim, 3 * dim, bias=False), "to_out": dense(dim, dim),
            "res_conv": (rng.standard_normal((33, 8)) / np.sqrt(33)).astype(np.float32)}}

    pos = {}
    for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        pos[name] = (rng.standard_normal((k, k, 1, dim)) / k).astype(np.float32)
        pos[f"{name}_bias"] = (0.02 * rng.standard_normal(dim)).astype(np.float32)
    assert in_features == 2048, "the smoke run serves the 2048-d fc1 variant"
    return {
        "fc1_0": dense(in_features, in_features // 2), "fc1_norm0": norm(in_features // 2),
        "fc1_1": dense(in_features // 2, dim),
        "cls_token": rng.standard_normal((1, 1, dim)).astype(np.float32),
        "layer1": layer(), "layer2": layer(), "pos_layer": pos, "norm": norm(dim),
        "fc": dense(dim, n_classes),
    }


def random_resnet50_variables(rng) -> dict:
    """Flax-layout ResNet50 {'params', 'batch_stats'} (nested numpy dicts) from
    ``rng``: lecun-normal convs, BatchNorm with non-trivial scale, bias, mean
    and variance, so that the fold matters."""
    import numpy as np

    from transmil_deepgraft_tpu_torch.models.resnet_int8 import EXPANSION, PLANES, _block_plan

    def conv(k, cin, cout):
        w = rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)
        return {"kernel": w.astype(np.float32)}

    def bn(c):
        return ({"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                 "bias": (0.05 * rng.standard_normal(c)).astype(np.float32)},
                {"mean": (0.05 * rng.standard_normal(c)).astype(np.float32),
                 "var": (1 + 0.1 * rng.random(c)).astype(np.float32)})

    params, stats = {"conv1": conv(7, 3, 64)}, {}
    params["bn1"], stats["bn1"] = bn(64)
    cin = 64
    for name, _, has_ds in _block_plan(4):
        stage = int(name[5]) - 1
        mid, cout = PLANES[stage], PLANES[stage] * EXPANSION
        p, st = {}, {}
        for i, (k, a, b) in enumerate(((1, cin, mid), (3, mid, mid), (1, mid, cout)), 1):
            p[f"conv{i}"] = conv(k, a, b)
            p[f"bn{i}"], st[f"bn{i}"] = bn(b)
        if has_ds:
            p["downsample_conv"] = conv(1, cin, cout)
            p["downsample_bn"], st["downsample_bn"] = bn(cout)
        params[name], stats[name] = p, st
        cin = cout
    return {"params": params, "batch_stats": stats}


def normalize_tiles(tiles_u8):
    """uint8 tiles -> ImageNet-normalized float32, as the pipeline does."""
    from transmil_deepgraft_tpu_torch.inference import IMAGENET_MEAN, IMAGENET_STD

    return (tiles_u8.astype("float32") / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def segments(q) -> list:
    """The seven segments of the int8 forward after the stem, in order:
    (name, blocks, is_entry) for s1, then e/i of stages 2-4."""
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import _STAGE_SLICES

    lo, hi = _STAGE_SLICES[0]
    out = [("s1", q.blocks[lo:hi], False)]
    for stage, (lo, hi) in enumerate(_STAGE_SLICES[1:], 2):
        out += [(f"e{stage}", q.blocks[lo:lo + 1], True), (f"i{stage}", q.blocks[lo + 1:hi], False)]
    return out


def segment_runs(q) -> list:
    """(name, kernel name, run on the kernel, run on the plain version) of
    each segment, in order."""
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk

    runs = []
    for name, blocks, entry in segments(q):
        if entry:
            runs.append((name, "qentry_run", lambda x, b=blocks[0]: qk.fused_entry_block(x, b),
                         lambda x, b=blocks[0]: qk.entry_reference(x, b)))
        else:
            runs.append((name, "qstage_run", lambda x, b=blocks: qk.fused_bottleneck_stage(x, b),
                         lambda x, b=blocks: qk.stage_reference(x, b)))
    return runs


def segment_costs(blocks, entry: bool, x_shape) -> tuple[int, int]:
    """(int8 operations = 2 * MACs, least bytes) of one segment on an
    (n, h, w, c) int8 input: the input and every weight and fma constant read
    once, the output written once."""
    n, h, w, _ = x_shape
    macs, nbytes = 0, n * h * w * x_shape[3]
    stride = 2 if entry else 1
    for blk in blocks:
        cin, mid = blk.w1.shape[-2:]
        cout = blk.w3.shape[-1]
        full, out = n * h * w, n * (h // stride) * (w // stride)
        macs += full * cin * mid + out * 9 * mid * mid + out * mid * cout
        nbytes += blk.w1.numel() + blk.w2.numel() + blk.w3.numel() + 4 * (4 * mid + 2 * cout)
        if blk.wd is not None:
            macs += out * cin * cout
            nbytes += blk.wd.numel() + 4 * cout
        h, w = h // stride, w // stride
    return 2 * macs, nbytes + n * h * w * cout


def segment_floor(blocks, entry: bool, x_shape) -> int:
    """Least bytes of one segment as ``csrc/qstage.cu`` runs it: per block,
    conv1 reads the block input and writes h1, conv2 reads h1 and writes h2,
    conv3 reads h2 and the block input again (the identity, or the
    downsample's pixels) and writes the output; weights and constants once."""
    n, h, w, cin = x_shape
    stride = 2 if entry else 1
    nbytes = 0
    for blk in blocks:
        cin, mid = blk.w1.shape[-2:]
        cout = blk.w3.shape[-1]
        full, out = n * h * w, n * (h // stride) * (w // stride)
        nbytes += full * cin + 2 * full * mid + 2 * out * mid + out * cin + out * cout
        nbytes += blk.w1.numel() + blk.w2.numel() + blk.w3.numel() + 4 * (5 * mid + 3 * cout)
        if blk.wd is not None:
            nbytes += blk.wd.numel()
        h, w = h // stride, w // stride
    return nbytes


PEAK_TOOL = ROOT / "build" / "mma_tf32_peak"


def phase_build() -> None:
    """The three kernel sources (one nvcc each, started together) and, beside
    them, the TF32 tensor-core peak tool (``tools/mma_tf32_peak.cu``)."""
    from transmil_deepgraft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    PEAK_TOOL.parent.mkdir(parents=True, exist_ok=True)
    peak = subprocess.Popen([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                             "-o", str(PEAK_TOOL), str(ROOT / "tools" / "mma_tf32_peak.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        reports = _build.build()
    finally:
        peak_log = peak.communicate(timeout=300)[0]
    if peak.returncode:
        raise RuntimeError(f"nvcc failed on tools/mma_tf32_peak.cu:\n{peak_log}")
    log(f"[build] nvcc built {sorted(reports) or 'nothing (cached)'} and the TF32 peak tool in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(k in line.lower() for k in ("registers", "spill", "error", "wgmma", "warning")):
                log(f"[build] {name}: {line.strip()}")


def device_parts(fn, calls: int = 10) -> dict:
    """Device microseconds a call of ``fn()`` by kernel (``torch.profiler``),
    the kernel's name cut to its function."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0][:60]
            parts[name] = parts.get(name, 0.0) + e.self_device_time_total / calls
    return parts


def phase_kernels(rng, results: dict, dev) -> None:
    """K1/K2 against their plain versions on one full-width TransLayer, within
    TOL and SPLIT_TOL; times a call and back to back beside the split-TF32
    and float32-SIMT bounds, the device time by part, the GEMM part's work as
    one ``F.linear`` (TF32 off; timed only), and the card's TF32 ceilings.

    Run alone, it times whichever ``transmil_deepgraft_tpu_torch`` comes
    first on ``sys.path``, so two checkouts can be timed in turns on one card
    (see the verify notes)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv1d

    dim, heads, dh, m = 512, 8, 64, 256
    n = LAYER_TOKENS
    n_pad = tk.landmark_pad(n, m)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    x = t(rng.standard_normal((1, n, dim)))
    ln_w = t(1 + 0.1 * rng.standard_normal(dim))
    ln_b = t(0.5 * rng.standard_normal(dim))  # non-zero: pad rows must be zeros after LN
    w_qkv = t(rng.standard_normal((3 * dim, dim)) / np.sqrt(dim))
    w_out = t(rng.standard_normal((dim, dim)) / np.sqrt(dim))
    b_out = t(0.1 * rng.standard_normal(dim))
    res_w = t(rng.standard_normal((heads, 1, 33, 1)) / np.sqrt(33))
    log(f"[kernels] one TransLayer at n={n} (+{n_pad} front pad = {n + n_pad}), D={dim}")

    with torch.inference_mode():
        q_lm, k_lm, attn2_inv = tk.landmark_glue(
            x, n_pad, ln_w, ln_b, w_qkv, heads=heads, dim_head=dh, num_landmarks=m,
            pinv_iterations=6)
        w_kv, w_q = w_qkv[dim:], w_qkv[:dim]
        k1_args = (x, n_pad, ln_w, ln_b, w_kv, q_lm)
        got_a, got_v = tk.translayer_k1(*k1_args)
        sync(dev)  # a fault in the kernel surfaces here, not in a later op
        want_a, want_v = tk.k1_reference(*k1_args)
        err1 = max((got_a - want_a).abs().max().item(), (got_v - want_v).abs().max().item())

        bmat = (attn2_inv @ want_a).contiguous()
        res = depthwise_conv1d(want_v, tk.value_residual_kernel(res_w, dh)).contiguous()
        k2_args = (x, res, ln_w, ln_b, w_q, k_lm, bmat, w_out, b_out, dh ** -0.5)
        got_y = tk.translayer_k2(*k2_args)
        sync(dev)
        want_y = tk.k2_reference(*k2_args)
        err2 = (got_y - want_y).abs().max().item()

        runs = {"translayer_k1": (lambda: tk.translayer_k1(*k1_args),
                                  lambda: tk.k1_reference(*k1_args)),
                "translayer_k2": (lambda: tk.translayer_k2(*k2_args),
                                  lambda: tk.k2_reference(*k2_args))}
        timing = {name: (cuda_ms(kernel), cuda_ms_back_to_back(kernel, 20),
                         cuda_ms(plain, reps=3, warmup=1), device_parts(kernel),
                         host_us(kernel, 50))
                  for name, (kernel, plain) in runs.items()}
        rows = x[0]
        linear_ms = {"[K|V] (1,024 columns)": cuda_ms(lambda: F.linear(rows, w_kv)),
                     "Q or out (512 columns)": cuda_ms(lambda: F.linear(rows, w_q))}
    costs = kernel_costs(n, n_pad)
    for name, err in (("translayer_k1", err1), ("translayer_k2", err2)):
        flops, nbytes = costs[name]
        bound_ms, by = bound(3 * flops, nbytes, H100_TF32_FLOPS)
        simt_ms = bound(flops, nbytes)[0]
        ms, ms_b2b, plain_ms, parts, enqueue_us = timing[name]
        results[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None, "ms_back_to_back": ms_b2b,
        }
        log(f"[kernels] {name}: max|err| {err:.3e} (tol {SPLIT_TOL}, and {TOL}), kernel "
            f"{ms:.4f} ms a call, {ms_b2b:.4f} back to back, host {enqueue_us:.1f} us + device "
            f"{sum(parts.values()):.1f} us; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({by}, split TF32), float32 SIMT {simt_ms:.4f} ({flops:.3e} FLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        log(f"[kernels] {name} device us a call by part: "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
        if not (err <= TOL and err <= SPLIT_TOL):
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {SPLIT_TOL}")
    log("[kernels] the projections' work as one F.linear (TF32 off, timed only): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in linear_ms.items()))
    if PEAK_TOOL.exists():
        peak = subprocess.run([str(PEAK_TOOL)], capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for line in peak.splitlines():
            if line.startswith("wgmma") or "32 warps" in line:
                log(f"[kernels] TF32 ceiling: {line}")


def phase_serving(rng, results: dict, workdir: Path, dev) -> None:
    """Feature bags through ServingBundle + MicroBatcher at full width."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.serving import (
        MicroBatcher, ServingBundle, export_serving_bundle)

    params = random_transmil_params(rng, 2048, 2)
    path = workdir / "transmil_head.tdx"
    export_serving_bundle(params, path, model_name="TransMIL", in_features=2048,
                          n_classes=2, buckets=SMOKE_BUCKETS)
    bundle = ServingBundle.load(path, device=dev)
    batcher = MicroBatcher(bundle)
    bags = [rng.standard_normal((n, 2048)).astype(np.float32) for n in REQUEST_TILES]
    try:
        batcher.predict_logits(bags[0])  # warm-up, outside the counted run
        tk.reset_launch_counts()
        served = []
        for n, bag in zip(REQUEST_TILES, bags):
            before = dict(tk.LAUNCHES)
            t0 = time.perf_counter()
            logits = batcher.predict_logits(bag)
            ms = (time.perf_counter() - t0) * 1e3
            rose = {k: tk.LAUNCHES[k] - before[k] for k in before}
            log(f"[serving] {n} tiles: {ms:.2f} ms, logits {logits.ravel().tolist()}, "
                f"launches {rose}")
            if rose != {"translayer_k1": 2, "translayer_k2": 2}:
                raise AssertionError(f"expected 2 launches of each kernel per request, got {rose}")
            if logits.shape != (1, 2) or not np.isfinite(logits).all():
                raise AssertionError(f"bad logits {logits}")
            served.append(logits)
        launches = dict(tk.LAUNCHES)
    finally:
        batcher.close()
    for name, count in launches.items():
        results[name]["launches"] = count
    log(f"[serving] launches over {len(REQUEST_TILES)} requests: {launches}")

    bundle.model.fused_inference = False  # the plain path, same weights, same card
    for n, bag, logits in zip(REQUEST_TILES, bags, served):
        plain = bundle.predict_logits(bag)
        err = float(np.abs(plain - logits).max())
        log(f"[serving] {n} tiles: kernel vs plain path max|dlogit| {err:.3e} (tol {TOL})")
        if not err <= TOL:
            raise AssertionError(f"served logits disagree with the plain path: {err}")
    bundle.model.fused_inference = True

    t0 = time.perf_counter()
    logits, scores = bundle.predict_logits_with_attention(bags[1][:ATTENTION_TILES])
    ms = (time.perf_counter() - t0) * 1e3
    log(f"[serving] attention request, {ATTENTION_TILES} tiles: {ms:.2f} ms, "
        f"scores {scores.shape}, sum {float(scores.sum()):.4f}")
    if scores.shape != (1, ATTENTION_TILES) or not np.isfinite(scores).all():
        raise AssertionError(f"bad attention scores {scores.shape}")
    if not np.isfinite(logits).all():
        raise AssertionError("bad attention-request logits")


def phase_fixture(dev) -> None:
    """The frozen torch-parity fixture (2048-d TransMIL, 237 tiles) on the card."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax, unflatten

    with np.load(ROOT / "tests" / "fixtures" / "parity_transmil_2048.npz") as z:
        params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
        bag, want = z["bag"], z["out:logits"]
    model = create_model("TransMIL", want.shape[-1], 2048, device=dev)
    model.load_state_dict(state_dict_from_jax(params, 2048))
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(bag).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"[fixture] parity_transmil_2048: max|dlogit| {err:.3e} vs the recorded torch "
        f"reference (tol {TOL})")
    if not err <= TOL:
        raise AssertionError(f"fixture logits disagree: {err}")


def phase_qstage(rng, results: dict, dev) -> tuple:
    """B7/B8 on the seven segments of one chunk of a full-width ResNet50 at
    224x224: int8 codes against the plain versions (with the share of codes
    at -128 or 127), then times at 128 tiles beside the bound and the
    kernels' traffic floor.

    Run alone, it times whichever ``transmil_deepgraft_tpu_torch`` comes
    first on ``sys.path``, so two checkouts can be timed in turns on one card
    (see the verify notes)."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.models.resnet_int8 import _stem_q, build_qresnet50

    variables = random_resnet50_variables(rng)
    tiles_u8 = rng.integers(0, 256, (SLIDE_TILES, TILE, TILE, 3), dtype=np.uint8)
    calib = normalize_tiles(tiles_u8[:CALIB_TILES])
    t0 = time.perf_counter()
    q = build_qresnet50(variables, calib, device=dev)
    sync(dev)
    log(f"[qstage] build_qresnet50 on {CALIB_TILES} tiles of {TILE}x{TILE}: "
        f"{time.perf_counter() - t0:.2f} s")
    runs = segment_runs(q)
    worst = {"qstage_run": 0, "qentry_run": 0}  # max |code difference| by kernel
    with torch.inference_mode():
        x = _stem_q(q, torch.from_numpy(normalize_tiles(tiles_u8[:COMPARE_TILES])).to(dev))
        for name, kernel, run, plain in runs:
            got = run(x)
            sync(dev)
            want = plain(x)
            bad = int((got != want).sum())
            worst[kernel] = max(worst[kernel], int((got.int() - want.int()).abs().max()))
            saturated = float(((want == -128) | (want == 127)).float().mean())
            log(f"[qstage] {name} ({kernel}) on {COMPARE_TILES} tiles {tuple(x.shape)} -> "
                f"{tuple(want.shape)}: {bad} differing int8 codes of {want.numel()}; "
                f"{saturated:.2%} of the codes at -128 or 127")
            if bad:
                raise AssertionError(f"{kernel} disagrees with its plain version on {name}")
            x = want

        x = _stem_q(q, torch.from_numpy(normalize_tiles(tiles_u8[:CHUNK])).to(dev))
        totals = {k: [0.0] * 6 for k in ("qstage_run", "qentry_run")}
        for (name, kernel, run, plain), (_, blocks, entry) in zip(runs, segments(q)):
            ms = cuda_ms(lambda: run(x))
            plain_ms = cuda_ms(lambda: plain(x), reps=3, warmup=1)
            ops, nbytes = segment_costs(blocks, entry, tuple(x.shape))
            t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            floor = segment_floor(blocks, entry, tuple(x.shape))
            t_floor = floor / H100_BYTES_PER_S * 1e3
            log(f"[qstage] {name} ({kernel}) at {CHUNK} tiles: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms ({ops:.3e} int8 OP, "
                f"{nbytes / 1e6:.1f} MB), traffic floor {t_floor:.3f} ms ({floor / 1e6:.1f} MB), "
                f"{ops / ms / 1e9:.1f} TOP/s")
            for i, v in enumerate((ms, plain_ms, max(t_ops, t_bytes), t_ops, t_bytes, t_floor)):
                totals[kernel][i] += v
            x = run(x)
    for kernel, (ms, plain_ms, bound, t_ops, t_bytes, t_floor) in totals.items():
        results[kernel] = {
            "name": kernel, "route": "cuda", "source": QSTAGE_SOURCE,
            "replaces": REPLACES[kernel], "launches": None, "max_abs_err": float(worst[kernel]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        }
        log(f"[qstage] {kernel}, all its launches of one {CHUNK}-tile chunk: {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms, traffic floor {t_floor:.3f} ms")
    return variables, tiles_u8, calib


def phase_pipeline(rng, results: dict, dev, variables, tiles_u8, calib) -> None:
    """uint8 tiles through SlideInferencePipeline -> int8 ResNet50 -> TransMIL."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.models.resnet import resnet50
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import prepare_qresnet50_fused
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.utils.jax_params import (
        resnet_state_dict_from_jax, state_dict_from_jax)

    head_params = random_transmil_params(rng, 2048, 2)

    def head(fused: bool):
        model = create_model("TransMIL", 2, 2048, device=dev, fused_inference=fused)
        model.load_state_dict(state_dict_from_jax(head_params, 2048))
        return model

    t0 = time.perf_counter()
    pipe = SlideInferencePipeline(variables, head(True), calib_tiles=calib, chunk=CHUNK,
                                  device=dev)
    log(f"[pipeline] built (int8 calibration on the card) in {time.perf_counter() - t0:.2f} s")
    pipe.predict_slide(tiles_u8[:CHUNK])  # warm-up, outside the counted run

    tk.reset_launch_counts()
    qk.reset_launch_counts()
    t0 = time.perf_counter()
    probs = pipe.predict_slide(tiles_u8)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {**qk.LAUNCHES, **tk.LAUNCHES}
    chunks = -(-SLIDE_TILES // CHUNK)
    log(f"[pipeline] predict_slide, {SLIDE_TILES} uint8 tiles ({chunks} chunks): {ms:.2f} ms, "
        f"probs {probs.tolist()}, launches {launches}")
    expected = {"qstage_run": 4 * chunks, "qentry_run": 3 * chunks,
                "translayer_k1": 2, "translayer_k2": 2}
    if launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    if probs.shape != (2,) or not np.isfinite(probs).all() or abs(probs.sum() - 1) > 1e-5:
        raise AssertionError(f"bad probabilities {probs}")
    for name in ("qstage_run", "qentry_run"):
        results[name]["launches"] = launches[name]

    batch = tiles_u8[:CHUNK]
    chunk_ms = cuda_ms(lambda: pipe._embed_chunk(batch), reps=5, warmup=1)
    log(f"[pipeline] one {CHUNK}-tile chunk's embed (uint8 host->device copy, normalize, "
        f"stem, 7 segments, pool): {chunk_ms:.3f} ms")

    t0 = time.perf_counter()
    attn_probs, scores = pipe.predict_slide_with_attention(tiles_u8)
    log(f"[pipeline] predict_slide_with_attention: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
        f"scores {scores.shape}, probs {attn_probs.tolist()}")
    if scores.shape != (SLIDE_TILES,) or not np.isfinite(scores).all():
        raise AssertionError(f"bad attention scores {scores.shape}")
    if not np.abs(attn_probs - probs).max() <= TOL:
        raise AssertionError(f"attention probabilities {attn_probs} differ from {probs}")

    # the same constants on the all-plain route: plain segments, plain head
    plain = SlideInferencePipeline(variables, head(False), calib_tiles=calib, chunk=CHUNK,
                                   device=dev, fused_backbone=True, fused_t_cfg=(0,) * 7)
    plain._q = prepare_qresnet50_fused(pipe._q)
    feats = pipe.embed(tiles_u8)
    plain_feats = plain.embed(tiles_u8)
    plain_probs = plain.predict_slide(tiles_u8)
    half_share = float(pipe._q.final_scale) / (2 * (TILE // 32) ** 2)
    err_f = float(np.abs(feats - plain_feats).max())
    err_p = float(np.abs(probs - plain_probs).max())
    log(f"[pipeline] kernel vs all-plain route: max|dfeature| {err_f:.3e} (tol {half_share:.3e},"
        f" half a code's share), max|dprob| {err_p:.3e} (tol {TOL})")
    if not (err_f <= half_share and err_p <= TOL):
        raise AssertionError("the pipeline disagrees with its all-plain route")

    model = resnet50()
    model.load_state_dict(resnet_state_dict_from_jax(variables))
    model = model.to(dev).eval()
    with torch.inference_mode():
        x = torch.from_numpy(normalize_tiles(tiles_u8[:FP32_CHECK_TILES])).to(dev)
        ref = model(x).cpu().numpy()
    got = feats[:FP32_CHECK_TILES]
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    log(f"[pipeline] int8 vs float32 ResNet50 (TF32 off) on {FP32_CHECK_TILES} tiles: "
        f"cosine min {cos.min():.6f}, mean {cos.mean():.6f} (bar 0.999)")
    if not cos.min() > 0.999:
        raise AssertionError(f"int8 features too far from float32: cosine {cos.min()}")


def torchvision_state_dict(variables) -> dict:
    """Flax ResNet50 variables -> a torch state dict in torchvision's names
    (the inverse of ``utils/torch_weights.convert_resnet_state_dict``)."""
    from transmil_deepgraft_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

    out = {}
    for key, value in resnet_state_dict_from_jax(variables).items():
        if key.startswith("layer"):  # layer2_0.conv1.weight -> layer2.0.conv1.weight
            block, rest = key.split(".", 1)
            key = block.replace("_", ".") + "." + rest
        out[key.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                    "downsample.1")] = value
    return out


def http(port: int, method: str, path: str, body: bytes | None = None,
         ctype: str = "application/octet-stream") -> tuple[int, dict, dict]:
    """(status, JSON body, headers) of one request to the local daemon."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=body, headers={"Content-Type": ctype} if body else {})
    r = conn.getresponse()
    raw = r.read()
    conn.close()
    doc = json.loads(raw) if r.getheader("Content-Type", "").startswith("application/json") else {
        "text": raw.decode()}
    return r.status, doc, dict(r.getheaders())


def npy(arr) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def quiet(main, argv: list[str], tag: str = "serve"):
    """A CLI's ``main(argv)``, its printed output logged on one line under
    ``[tag]`` (the last lines of this script's output stay its own)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = main(argv)
    text = " | ".join(out.getvalue().strip().splitlines())
    log(f"[{tag}] {main.__module__.rsplit('.', 1)[-1]}: {text}")
    return result


def counted(run):
    """(run's result, the launches of B7/B8 and K1/K2 during it): every
    count is set to 0 just before and read just after."""
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk

    qk.reset_launch_counts()
    tk.reset_launch_counts()
    out = run()
    return out, {**qk.LAUNCHES, **tk.LAUNCHES}


def expect_launches(route: str, got: dict, chunks: int, head_calls: int) -> None:
    want = {"qstage_run": 4 * chunks, "qentry_run": 3 * chunks,
            "translayer_k1": 2 * head_calls, "translayer_k2": 2 * head_calls}
    log(f"[serve] {route}: launches {got}")
    if got != want:
        raise AssertionError(f"{route}: expected launches {want}, got {got}")


def phase_serve(rng, results: dict, dev, variables, tiles_u8, calib) -> None:
    """The port's entry points at full width: ``cli.export_model`` writes a
    TransMIL-2048 head bundle and an int8 slide bundle (224x224, chunk 128)
    from .pth checkpoints; ``cli.serve``'s daemon answers /health, /predict
    (a 12,000-tile bag), /predict_slide (300 uint8 tiles, with and without
    attention), sheds a burst past its queue with 503 + Retry-After, and
    /metrics; ``cli.infer`` streams 2 slides x 256 JPEG tiles from disk.
    Each route is held to the in-process result and to exact launch counts
    of B7/B8 and K1/K2."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from transmil_deepgraft_tpu_torch.cli import export_model, infer
    from transmil_deepgraft_tpu_torch.cli.serve import make_server
    from transmil_deepgraft_tpu_torch.data import native_tiles
    from transmil_deepgraft_tpu_torch.data.tiles import imagenet_normalize
    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline, decode_tile_paths
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.serving import ServingBundle
    from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

    t_phase = time.perf_counter()
    head_params = random_transmil_params(rng, 2048, 2)
    head_sd = state_dict_from_jax(head_params, 2048)  # the reference's TransMIL names

    def head_model():
        model = create_model("TransMIL", 2, 2048, device=dev)
        model.load_state_dict(head_sd)
        return model.eval()

    buckets = ",".join(map(str, SMOKE_BUCKETS))
    totals = {k: 0 for k in ("qstage_run", "qentry_run", "translayer_k1", "translayer_k2")}

    def add(launches: dict) -> None:
        for k in totals:
            totals[k] += launches[k]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save(torchvision_state_dict(variables), tmp / "backbone.pth")
        torch.save(head_sd, tmp / "head.pth")
        np.save(tmp / "calib.npy", calib)
        t0 = time.perf_counter()
        quiet(export_model.main, ["--model", "TransMIL", "--ckpt", str(tmp / "head.pth"),
                                  "--out", str(tmp / "head.tdx"), "--buckets", buckets])
        quiet(export_model.main, ["--model", "TransMIL", "--ckpt", str(tmp / "head.pth"),
                                  "--out", str(tmp / "slide.tdx"), "--backbone_ckpt",
                                  str(tmp / "backbone.pth"), "--calib_tiles",
                                  str(tmp / "calib.npy"), "--chunk", str(CHUNK), "--tile_hw",
                                  str(TILE), "--buckets", buckets, "--device", str(dev)])
        head_bundle = ServingBundle.load(tmp / "head.tdx", device=dev)
        bundle = ServingBundle.load(tmp / "slide.tdx", device=dev)
        log(f"[serve] cli.export_model (head bundle; int8 slide bundle calibrated on the card "
            f"on {len(calib)} tiles) and both loads: {time.perf_counter() - t0:.2f} s, "
            f"slide bundle {(tmp / 'slide.tdx').stat().st_size / 1e6:.1f} MB")

        bag = rng.standard_normal((SERVE_BAG, 2048)).astype(np.float32)
        slide = tiles_u8[:SLIDE_TILES]
        chunks = -(-SLIDE_TILES // CHUNK)
        want_logits = bundle.predict_logits(bag)  # in-process; also warms the bucket
        np.testing.assert_allclose(head_bundle.predict_logits(bag), want_logits, atol=1e-6)
        bundle.predict_slide(slide[:CHUNK])  # warm-up of the backbone, outside the counts

        srv = make_server(bundle, "127.0.0.1", 0, max_queue=16)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        try:
            status, doc, _ = http(port, "GET", "/health")
            if status != 200 or doc["status"] != "ok":
                raise AssertionError(f"/health: {status} {doc}")

            body = npy(bag)
            t0 = time.perf_counter()
            (status, doc, _), launches = counted(lambda: http(port, "POST", "/predict", body))
            request_ms = (time.perf_counter() - t0) * 1e3
            err = float(np.abs(np.asarray(doc.get("logits")) - want_logits).max())
            log(f"[serve] /predict, {SERVE_BAG} tiles x 2048 (.npy, {len(body) / 1e6:.1f} MB): "
                f"{request_ms:.2f} ms, max|dlogit| vs in-process {err:.3e} (tol 1e-5)")
            if status != 200 or not err <= 1e-5:
                raise AssertionError(f"/predict: {status}, {err}")
            expect_launches("/predict", launches, 0, 1)
            add(launches)

            body = npy(slide)
            x = bundle.embed_tiles(slide)  # the yardstick: the same backbone, a fresh head
            x = torch.nn.functional.pad(x, (0, 0, 0, bundle._pad_target(SLIDE_TILES) - SLIDE_TILES))
            with torch.inference_mode():
                want_probs = torch.softmax(head_model()(x[None]), -1).cpu().numpy()[0]
            for attention in (True, False):
                bundle.meta["attention"] = attention
                t0 = time.perf_counter()
                (status, doc, _), launches = counted(
                    lambda: http(port, "POST", "/predict_slide", body))
                slide_s = time.perf_counter() - t0
                err = float(np.abs(np.asarray(doc.get("probs")) - want_probs).max())
                log(f"[serve] /predict_slide, {SLIDE_TILES} uint8 tiles ({len(body) / 1e6:.1f} "
                    f"MB), attention {attention}: {slide_s:.3f} s, max|dprob| vs the pipeline "
                    f"after the same bucket pad {err:.3e} (tol {TOL}), top tiles "
                    f"{doc.get('topk_tiles', [])[:5]}")
                if status != 200 or not err <= TOL or ("topk_tiles" in doc) != attention:
                    raise AssertionError(f"/predict_slide: {status} {err} {list(doc)}")
                # return_attn runs the head's layers on their plain path, as in JAX
                expect_launches(f"/predict_slide (attention {attention})", launches, chunks,
                                0 if attention else 1)
                add(launches)

            # a burst past the queue bound: a slowed device (a sleep in the
            # bundle's forward) and max_queue 1 in a second daemon
            logits = bundle._logits

            def slow(*args):
                time.sleep(0.3)
                return logits(*args)

            bundle._logits = slow
            small = npy(bag[:SMOKE_BUCKETS[0]])
            shed = make_server(bundle, "127.0.0.1", 0, max_queue=1)
            threading.Thread(target=shed.serve_forever, daemon=True).start()
            try:
                with ThreadPoolExecutor(max_workers=6) as ex:
                    burst = list(ex.map(lambda _: http(shed.server_address[1], "POST",
                                                       "/predict", small), range(6)))
            finally:
                shed.shutdown()
                shed.server_close()
                del bundle._logits
            statuses = sorted(st for st, _, _ in burst)
            retry = [int(h["Retry-After"]) for st, _, h in burst if st == 503]
            log(f"[serve] burst of 6 at max_queue 1: statuses {statuses}, Retry-After {retry}")
            if 200 not in statuses or 503 not in statuses or not all(r >= 1 for r in retry):
                raise AssertionError(f"the burst was not shed: {statuses}")

            status, doc, _ = http(port, "GET", "/metrics")
            lines = [x for x in doc["text"].splitlines() if x.startswith("transmil_requests_total")]
            log(f"[serve] /metrics: {lines}")
            if status != 200 or not any('"/predict_slide",status="200"' in x for x in lines):
                raise AssertionError("/metrics does not count the requests")
        finally:
            srv.shutdown()
            srv.server_close()

        # the disk path: 2 slides x 256 JPEG tiles through cli.infer
        root = tmp / "tiles"
        paths = {}
        for s_i, name in enumerate(("slideA", "slideB")):
            (root / name).mkdir(parents=True)
            paths[name] = []
            for t_i in range(DISK_TILES):
                tile = rng.integers(0, 256, (TILE, TILE, 3), dtype=np.uint8)
                path = root / name / f"tile_({t_i % 16}-{t_i // 16}).jpg"
                Image.fromarray(tile).save(path, quality=90)
                paths[name].append(path)
        t0 = time.perf_counter()
        (results_cli, launches) = counted(lambda: quiet(infer.main, [
            "--tiles_root", str(root), "--backbone_ckpt", str(tmp / "backbone.pth"),
            "--head_ckpt", str(tmp / "head.pth"), "--quantize", "int8", "--chunk", str(CHUNK),
            "--tile_size", str(TILE), "--topk", "10", "--out_dir", str(tmp / "out"),
            "--device", str(dev)]))
        infer_s = time.perf_counter() - t0
        disk_chunks = 2 * -(-DISK_TILES // CHUNK)
        expect_launches("cli.infer (2 slides, attention)", launches, disk_chunks, 0)
        add(launches)

        all_paths = paths["slideA"] + paths["slideB"]
        decode_tile_paths(all_paths[:8], TILE)  # the loader's build, if any, outside the time
        t0 = time.perf_counter()
        decoded = decode_tile_paths(all_paths, TILE)
        decode_s = time.perf_counter() - t0
        ordered = sorted(paths["slideA"])  # cli.infer sorts a slide's tiles by name
        calib_disk = imagenet_normalize(decode_tile_paths(ordered[:64], TILE))
        pipe = SlideInferencePipeline(variables, head_model(), calib_tiles=calib_disk,
                                      chunk=CHUNK, device=dev)
        for s_i, (name, got) in enumerate(zip(("slideA", "slideB"), results_cli)):
            order = sorted(range(DISK_TILES), key=lambda i: paths[name][i].name)
            tiles = decoded[s_i * DISK_TILES:(s_i + 1) * DISK_TILES][order]
            probs, scores = pipe.predict_slide_with_attention(tiles)
            err = float(np.abs(np.asarray(got["probs"]) - probs).max())
            top = [row.split(",")[0] for row in
                   Path(got["topk_csv"]).read_text().splitlines()[1:]]
            ranked = np.argsort(scores)[::-1]
            names = [paths[name][order[i]].name for i in ranked[:10]]
            ranked_scores = scores[ranked]
            # a rank whose score is within 1e-4 of a neighbour's may swap
            same = all(top[i] == names[i] for i in range(10)
                       if min(ranked_scores[i - 1] - ranked_scores[i] if i else np.inf,
                              ranked_scores[i] - ranked_scores[i + 1]) > 1e-4)
            log(f"[serve] cli.infer {name}: probs {got['probs']}, max|dprob| vs "
                f"predict_slide_with_attention on the decoded tiles {err:.3e} (tol {TOL}), "
                f"top-10 {'the same' if same else 'DIFFERENT'}")
            if not (err <= TOL and same):
                raise AssertionError(f"cli.infer disagrees on {name}: {err}, {top} vs {names}")
        _, launches = counted(lambda: [pipe.predict_slide_paths(sorted(paths[n]), tile_size=TILE)
                                       for n in ("slideA", "slideB")])
        expect_launches("predict_slide_paths (2 slides)", launches, disk_chunks, 2)
        add(launches)
        t0 = time.perf_counter()
        for name in ("slideA", "slideB"):
            pipe.predict_slide_paths(sorted(paths[name]), tile_size=TILE)
        sync(dev)
        paths_s = time.perf_counter() - t0
    decoder = "native libjpeg" if native_tiles.available() else "PIL"
    how = "tile by tile on one thread" if decoder == "PIL" else "the loader's thread pool"
    log(f"[serve] disk path: decoder {decoder}, decode {len(all_paths) / decode_s:.1f} tiles/s "
        f"({len(all_paths)} JPEG tiles of {TILE}x{TILE}, {how}), "
        f"predict_slide_paths {2 / paths_s:.3f} slides/s of {DISK_TILES} tiles "
        f"({paths_s / 2:.3f} s a slide), cli.infer {infer_s:.2f} s for 2 slides (calibration "
        f"included)")
    for name, count in totals.items():
        results.setdefault(name, {})["launches"] = count
    log(f"[serve] launches over the serve phase's routes: {totals}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def nystrom_costs(b: int, n: int, heads: int = 8, d: int = 64, m: int = 256) -> dict:
    """(float operations, least bytes) of each landmark kernel on one call:
    2 * 2 * m * n * d a head (scores and the weighted sum), every input read
    once, every output written once, float32."""
    flops = 4 * m * n * heads * d * b
    plane, lm = b * n * heads * d * 4, b * heads * m * d * 4
    return {"nystrom_landmark_attn": (flops, lm + 2 * plane + lm),  # q_lm, k, v -> out
            "nystrom_query_lm": (flops, plane + 2 * lm + plane)}  # q, k_lm, B -> out


def bound(flops: float, nbytes: float, rate: float = H100_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nystrom_bounds(b: int, n: int, name: str) -> tuple[float, str, float]:
    """(bound ms, bound by, float32-SIMT bound ms) of a landmark kernel: the
    kernels do each float32 product as three TF32 tensor-core products (the
    3xTF32 split), so their bound is 3x the operations at the TF32 rate; the
    SIMT bound is the operations at the float32 rate."""
    flops, nbytes = nystrom_costs(b, n)[name]
    ms, by = bound(3 * flops, nbytes, H100_TF32_FLOPS)
    return ms, by, bound(flops, nbytes)[0]


def layernormed_qkv(rng, b: int, n: int, dev, h: int = 8, d: int = 64):
    """A packed (b, n, 3, h, d) qkv as a TransLayer makes it, LayerNorm rows
    with a 0.5 * N(0, 1) bias a column (V's columns have a non-zero mean),
    and the scaled q landmarks (segment means of the q plane)."""
    import numpy as np
    import torch

    x = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d), dtype=np.float32)).to(dev)
    bias = torch.from_numpy((0.5 * rng.standard_normal(3 * h * d)).astype(np.float32)).to(dev)
    qkv = torch.nn.functional.layer_norm(x, (3 * h * d,), None, bias).view(b, n, 3, h, d)
    q = qkv[:, :, 0].transpose(1, 2)
    return qkv, (q.reshape(b, h, 256, n // 256, d).mean(3) * d ** -0.5).contiguous()


def phase_nystrom(rng, results: dict, dev) -> None:
    """B5/B6 (packed) and B3/B4 ((b*h, n, d)) against their plain versions at
    the training shape and at a 40,960-tile bag, B3/B4 also at a ragged n;
    two landmark-kernel calls in a row agree (its counters are left at zero);
    the fused attention and its backward against autograd through the plain
    op; times per call, back to back, host and device, beside SDPA's.

    Run alone, it times whichever ``transmil_deepgraft_tpu_torch`` comes
    first on ``sys.path``, so two checkouts can be timed in turns on one card
    (see the verify notes)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention

    h, d, m = 8, 64, 256

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def check(label: str, got, want, tol: float = TOL) -> float:
        sync(dev)
        err = (got - want).abs().max().item()
        log(f"[nystrom] {label}: max|err| {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{label} disagrees with its plain version: {err} > {tol}")
        return err

    worst = {"nystrom_landmark_attn": 0.0, "nystrom_query_lm": 0.0}
    timing = {}
    with torch.inference_mode():
        for b, n in ((2, TRAIN_N), (1, BIG_N), (CLI_BATCH, CLI_N)):
            qkv = t(b, n, 3, h, d)
            q_lm, k_lm, bmat = t(b, h, m, d, scale=0.125), t(b, h, m, d, scale=0.125), t(b, h, m, d)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, d) views
            flat = [x.reshape(b * h, -1, d).contiguous() for x in (q_lm, q, k, v, k_lm, bmat)]
            runs = {  # name: (form, kernel call, plain call, the one PyTorch call), ...
                "nystrom_landmark_attn": (
                    ("B5", lambda: nk.landmark_attention_packed(q_lm, qkv),
                     lambda: nk.landmark_attention_reference(q_lm, k, v),
                     lambda: F.scaled_dot_product_attention(q_lm, k, v, scale=1.0)),
                    ("B3", lambda: nk.landmark_attention(flat[0], flat[2], flat[3]),
                     lambda: nk.landmark_attention_reference(flat[0], flat[2], flat[3]),
                     lambda: F.scaled_dot_product_attention(flat[0], flat[2], flat[3], scale=1.0))),
                "nystrom_query_lm": (
                    ("B6", lambda: nk.query_landmark_attention_packed(qkv, k_lm, bmat),
                     lambda: nk.query_landmark_attention_reference(q, k_lm, bmat).transpose(1, 2),
                     lambda: F.scaled_dot_product_attention(q, k_lm, bmat, scale=1.0)),
                    ("B4", lambda: nk.query_landmark_attention(flat[1], flat[4], flat[5]),
                     lambda: nk.query_landmark_attention_reference(flat[1], flat[4], flat[5]),
                     lambda: F.scaled_dot_product_attention(flat[1], flat[4], flat[5], scale=1.0))),
            }
            for name, forms in runs.items():
                for form, kernel, plain, library in forms:
                    err = check(f"{form} ({name}) b={b} n={n}", kernel(), plain(), SPLIT_TOL)
                    worst[name] = max(worst[name], err)
                    if name == "nystrom_landmark_attn" and not torch.equal(kernel(), kernel()):
                        raise AssertionError(f"{form}: two calls in a row disagree")
                    ms, ms_b2b = cuda_ms(kernel), cuda_ms_back_to_back(kernel)
                    plain_ms = cuda_ms(plain, reps=3, warmup=1)
                    library_ms, library_b2b = cuda_ms(library), cuda_ms_back_to_back(library)
                    bound_ms, by, simt_ms = nystrom_bounds(b, n, name)
                    timing[(name, form, n)] = dict(
                        ms=ms, ms_back_to_back=ms_b2b, plain_ms=plain_ms, library_ms=library_ms,
                        library_ms_back_to_back=library_b2b, bound_ms=bound_ms, bound_by=by)
                    log(f"[nystrom] {form} ({name}) b={b} n={n}: kernel {ms:.4f} ms a call, "
                        f"{ms_b2b:.4f} back to back, host {host_us(kernel):.1f} us + device "
                        f"{device_us(kernel):.1f} us; plain {plain_ms:.4f}; SDPA {library_ms:.4f} "
                        f"a call, {library_b2b:.4f} back to back, host {host_us(library):.1f} us + "
                        f"device {device_us(library):.1f} us; bound {bound_ms:.4f} ms ({by}, "
                        f"split TF32), float32 SIMT {simt_ms:.4f}")
        # B5 on a LayerNorm'd qkv: V's columns carry a 0.5 * N(0, 1) bias, so
        # a long key split is where truncating accumulation would show
        for b, n in ((1, BIG_N), (2, TRAIN_N)):
            qkv, q_lm = layernormed_qkv(rng, b, n, dev)
            k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
            worst["nystrom_landmark_attn"] = max(worst["nystrom_landmark_attn"], check(
                f"B5 (nystrom_landmark_attn) b={b} n={n}, LayerNorm'd qkv (biased V)",
                nk.landmark_attention_packed(q_lm, qkv), nk.landmark_attention_reference(q_lm, k, v),
                SPLIT_TOL))
            del qkv, q_lm, k, v
        # B3/B4 at a ragged n
        b, n = 2, RAGGED_N
        q_lm, k, v = t(b * h, m, d, scale=0.125), t(b * h, n, d), t(b * h, n, d)
        q, k_lm, bmat = t(b * h, n, d), t(b * h, m, d, scale=0.125), t(b * h, m, d)
        for form, name, got, want in (
                ("B3", "nystrom_landmark_attn", nk.landmark_attention(q_lm, k, v),
                 nk.landmark_attention_reference(q_lm, k, v)),
                ("B4", "nystrom_query_lm", nk.query_landmark_attention(q, k_lm, bmat),
                 nk.query_landmark_attention_reference(q, k_lm, bmat))):
            worst[name] = max(worst[name],
                              check(f"{form} ({name}) b*h={b * h} n={n}", got, want, SPLIT_TOL))

    # the fused attention and its analytic backward against autograd through
    # the plain op, at the training shape
    b, n = 2, TRAIN_N
    qkv, g = t(b, n, 3, h, d), t(b, n, h, d)
    x = qkv.clone().requires_grad_(True)
    out = nk.nystrom_attention_fused_packed(x, m, 6)
    out.backward(g)
    xr = qkv.clone().requires_grad_(True)
    ref = nystrom_attention(*(xr[:, :, i].transpose(1, 2) for i in range(3)),
                            num_landmarks=m, pinv_iterations=6).out.transpose(1, 2)
    ref.backward(g)
    check(f"nystrom_attention_fused_packed forward b={b} n={n}", out.detach(), ref.detach())
    check(f"nystrom_attention_fused_packed backward (dq, dk, dv) b={b} n={n}", x.grad, xr.grad)

    for name, form in (("nystrom_landmark_attn", "B5"), ("nystrom_query_lm", "B6")):
        tm = timing[(name, form, BIG_N)]
        results[name] = {
            "name": name, "route": "cuda", "source": NYSTROM_SOURCE, "replaces": REPLACES[name],
            "launches": None, "max_abs_err": worst[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"], "ms_back_to_back": tm["ms_back_to_back"],
            "library_ms_back_to_back": tm["library_ms_back_to_back"],
            **{key: {k: v for k, v in timing[(name, form, n)].items()
                     if k not in ("bound_ms", "bound_by")}
               for key, n in (("train_shape", TRAIN_N), ("cli_train_shape", CLI_N))},
        }


def phase_train(results: dict, dev) -> None:
    """TransMIL-2048 with use_pallas through MILDataModule -> Trainer.fit ->
    Trainer.test; launch counts; kernel vs all-plain training; the step by
    part; one forward + backward at 40,960 tiles."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    def datamodule():
        return MILDataModule(n_classes=2, max_bag_size=TRAIN_BAG, batch_size=1, seed=2021,
                             synthetic={**TRAIN_SPLITS, "bag_size": TRAIN_BAG,
                                        "feature_size": 2048, "signal": 0.8})

    torch.manual_seed(0)
    init = create_model("TransMIL", 2, 2048, device=dev).state_dict()

    def trainer(use_pallas: bool, log_dir: Path, **cfg) -> Trainer:
        model = create_model("TransMIL", 2, 2048, device=dev, use_pallas=use_pallas)
        model.load_state_dict(init)
        tx = create_optimizer("lookahead_radam", lr=2e-4, weight_decay=0.01,
                              grad_accum_steps=GRAD_ACC)
        config = TrainerConfig(epochs=TRAIN_EPOCHS, log_dir=str(log_dir), epoch_figures=False,
                               export_topk_tiles=False, **cfg)
        return Trainer(model, tx, datamodule(), n_classes=2, loss_fn=create_loss(), config=config)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tr = trainer(True, tmp / "fit")
        dm = tr.dm
        micro = TRAIN_EPOCHS * TRAIN_SPLITS["n_train"]
        evals = TRAIN_EPOCHS * TRAIN_SPLITS["n_val"] + TRAIN_SPLITS["n_test"]
        tk.reset_launch_counts()
        nk.reset_launch_counts()
        t0 = time.perf_counter()
        history = tr.fit()
        summary = tr.test()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = {**nk.LAUNCHES, **tk.LAUNCHES}
        rows = [json.loads(line) for line in (tmp / "fit" / "metrics.jsonl").read_text().splitlines()]
        log(f"[train] fit ({TRAIN_EPOCHS} epochs x {micro // TRAIN_EPOCHS} bags of {TRAIN_BAG} "
            f"tiles, grad_acc {GRAD_ACC}) + test: {fit_s:.2f} s, launches {launches}")
        for r in rows:
            log(f"[train] {json.dumps({k: v for k, v in r.items() if k != 'time'})}")
        expected = {"nystrom_landmark_attn": 2 * micro, "nystrom_query_lm": 2 * micro,
                    "translayer_k1": 2 * evals, "translayer_k2": 2 * evals}
        if launches != expected:
            raise AssertionError(f"expected launches {expected}, got {launches}")
        losses = [r[k] for r in rows for k in ("loss", "val_loss", "test_loss") if k in r]
        if len(rows) != TRAIN_EPOCHS + 1 or not np.isfinite(losses).all():
            raise AssertionError(f"bad training rows {rows}")
        for name in ("nystrom_landmark_attn", "nystrom_query_lm"):
            results[name]["launches"] = launches[name]
        log(f"[train] last epoch {history['loss']:.4f} / val {history['val_loss']:.4f}, "
            f"test AUC {summary['test_auc']:.4f}")

        # the step by part, on the next epoch's bags: 8 optimizer steps after a warm-up one
        batches = list(dm.train_batches(TRAIN_EPOCHS))
        parts = []
        for i in range(0, 9 * GRAD_ACC, GRAD_ACC):
            step = [0.0, 0.0, 0.0]
            for batch in batches[i:i + GRAD_ACC]:
                bags, labels = tr._batch_tensors(batch)
                for p in tr.model.parameters():
                    p.grad = None
                sync(dev)
                t0 = time.perf_counter()
                loss, _ = tr.loss(bags, labels)
                sync(dev)
                t1 = time.perf_counter()
                loss.backward()
                sync(dev)
                t2 = time.perf_counter()
                tr.tx.step()
                sync(dev)
                t3 = time.perf_counter()
                for j, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                    step[j] += dt * 1e3
            parts.append(step)
        parts = np.array(parts[1:])  # the first step warms up
        med = np.median(parts, axis=0)
        log(f"[train] one optimizer step ({GRAD_ACC} micro-steps at n={TRAIN_N}), median of "
            f"{len(parts)}: {np.median(parts.sum(1)):.3f} ms = forward {med[0]:.3f} + backward "
            f"{med[1]:.3f} + optimizer update {med[2]:.3f} ms")

        # kernel route vs all-plain route from the same weights, dropout off
        kern = trainer(True, tmp / "kernel", train_deterministic=True)
        plain = trainer(False, tmp / "plain", train_deterministic=True)
        kern.tx.init(kern.model.parameters())
        plain.tx.init(plain.model.parameters())
        worst_loss = 0.0
        for batch in list(dm.train_batches(0))[:PARITY_STEPS * GRAD_ACC]:
            lk, _ = kern.train_step(*kern._batch_tensors(batch))
            lp, _ = plain.train_step(*plain._batch_tensors(batch))
            worst_loss = max(worst_loss, abs(lk - lp))
        worst_param = max((a - b).abs().max().item() for a, b in
                          zip(kern.model.parameters(), plain.model.parameters()))
        log(f"[train] {PARITY_STEPS} optimizer steps, kernel vs all-plain route: max|dloss| "
            f"{worst_loss:.3e}, max|dparam| {worst_param:.3e} (tol 1e-4)")
        if not (worst_loss <= 1e-4 and worst_param <= 1e-4):
            raise AssertionError("kernel training disagrees with the all-plain route")

    # one forward + backward at a 40,960-tile bag through the kernels
    model = tr.model
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, BIG_BAG, 2048), dtype=np.float32)).to(dev)
    labels = torch.ones(1, dtype=torch.long, device=dev)
    for p in model.parameters():
        p.grad = None
    torch.cuda.reset_peak_memory_stats(dev)
    nk.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    loss, _ = tr.loss(x, labels)
    loss.backward()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    grads_ok = all(torch.isfinite(p.grad).all().item() for p in model.parameters())
    log(f"[train] forward + backward at {BIG_BAG} tiles (n={BIG_N}): {ms:.2f} ms, peak "
        f"{peak:.2f} GiB, loss {loss.item():.4f}, launches {dict(nk.LAUNCHES)}")
    if nk.LAUNCHES != {"nystrom_landmark_attn": 2, "nystrom_query_lm": 2} or not grads_ok:
        raise AssertionError("the 40,960-tile step missed the kernels or gave non-finite grads")


def write_cohort(root: Path, rng) -> dict:
    """The cli_train cohort under ``root``: per-slide 2048-d float32 .npy
    bags (a class signal on 64 features), a label JSON whose paths carry
    ``FEATURES_RETCCL_2048``, a patient map of two slides (one label) a
    patient. Returns the config's ``Data`` paths."""
    import numpy as np

    data = root / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels, patients, total = {}, {}, 0
    for split, count in CLI_SPLITS.items():
        labels[split] = []
        for i in range(count):
            name, y = f"{split}_{i:03d}", (i // 2) % 2
            x = rng.standard_normal((int(rng.integers(CLI_TILES[0], CLI_TILES[1] + 1)), 2048),
                                    dtype=np.float32)
            x[:, :64] += 0.25 * y
            np.save(data / f"{name}.npy", x)
            total += x.nbytes
            labels[split].append([f"FEATURES_RETCCL_2048/{name}.npy", y])
            patients[name] = f"{split}_patient_{i // 2:03d}"
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    log(f"[cli_train] cohort: {sum(CLI_SPLITS.values())} slides of {CLI_TILES[0]}-"
        f"{CLI_TILES[1]} tiles, {total / 2**30:.2f} GiB of .npy")
    return {"data_dir": str(root / "data"), "label_file": str(root / "labels.json"),
            "patient_dict": str(root / "patients.json")}


def cli_config(root: Path, name: str, data: dict, general: dict | None = None,
               model: dict | None = None) -> Path:
    """The repository's ``TransMIL_feat_norm_rest.yaml`` with the cohort's
    paths, a log path, ``epochs`` and the given changes, under
    ``root/name/DeepGraft/`` (the file name gives the task)."""
    import yaml

    cfg = yaml.safe_load((ROOT / CLI_CONFIG).read_text())
    if (cfg["Data"]["train_dataloader"]["batch_size"], cfg["Data"]["bag_size"]) != (CLI_BATCH,
                                                                                     CLI_BAG):
        raise AssertionError(f"{CLI_CONFIG} no longer trains {CLI_BATCH} bags of {CLI_BAG}")
    cfg["Data"].update(data)
    cfg["General"].update({"log_path": str(root / "logs"), "epochs": CLI_EPOCHS, **(general or {})})
    cfg["Model"].update(model or {})
    path = root / name / "DeepGraft" / Path(CLI_CONFIG).name
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def launch_counts(run):
    """(run's result, the launches of B5/B6 and K1/K2 during it): every count
    is set to 0 just before and read just after."""
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk

    nk.reset_launch_counts()
    tk.reset_launch_counts()
    out = run()
    return out, {**nk.LAUNCHES, **tk.LAUNCHES}


def expect(label: str, got: dict, landmark: int, translayer: int) -> None:
    want = {"nystrom_landmark_attn": landmark, "nystrom_query_lm": landmark,
            "translayer_k1": translayer, "translayer_k2": translayer}
    log(f"[cli_train] {label}: launches {got}")
    if got != want:
        raise AssertionError(f"{label}: expected launches {want}, got {got}")


def metric_rows(log_dir: Path) -> list[dict]:
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "val_loss" in r]


def time_steps(trainer, batches: list, label: str) -> None:
    """Optimizer steps at 64 x 200 on the card: the median step and its
    forward / backward / update parts (host clock, synchronized), then the
    device's busy share of three steps from a torch.profiler trace."""
    import numpy as np
    import torch

    dev, acc = trainer.device, trainer.tx.grad_accum_steps
    trainer.tx.init(trainer.model.parameters())
    staged = [trainer._batch_tensors(b) for b in batches]
    parts = []
    for i in range(0, len(staged) - acc + 1, acc):
        step = np.zeros(3)
        for bags, labels in staged[i:i + acc]:
            for p in trainer.model.parameters():
                p.grad = None
            sync(dev)
            t0 = time.perf_counter()
            loss, _ = trainer.loss(bags, labels)
            sync(dev)
            t1 = time.perf_counter()
            loss.backward()
            sync(dev)
            t2 = time.perf_counter()
            trainer.tx.step()
            sync(dev)
            step += np.array([t1 - t0, t2 - t1, time.perf_counter() - t2]) * 1e3
        parts.append(step)
    parts = np.array(parts[1:])  # the first step warms up
    med = np.median(parts, axis=0)
    log(f"[cli_train] {label}: one optimizer step ({acc} micro-steps of {CLI_BATCH} x {CLI_BAG} "
        f"tiles), median of {len(parts)}: {np.median(parts.sum(1)):.3f} ms = forward "
        f"{med[0]:.3f} + backward {med[1]:.3f} + optimizer update {med[2]:.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    steps = staged[:3 * acc]
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bags, labels in steps:
            trainer.train_step(bags, labels)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device's kernels: their time ranges on the card (one stream, so
    # they do not overlap), summed by name
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_us = sum(by_name.values())
    busy = f"{device_us / wall_us:.3f}" if device_us > 0 else "not measured (no device time)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[cli_train] {label}: 3 optimizer steps under torch.profiler: wall {wall_us / 1e3:.2f} ms, "
        f"device kernels {device_us / 1e3:.2f} ms ({len(by_name)} kernel names), busy share "
        f"{busy}; top: " + "; ".join(f"{name[:70]} {us / 1e3:.2f} ms" for name, us in top))


def phase_cli_train(rng, results: dict, dev) -> None:
    """The port's ``cli.train`` on the card over a 192-slide cohort of .npy
    feature bags, with the repository's TransMIL_feat_norm_rest.yaml (train
    batch 64, bag 200, grad_acc 2, radam, precision 16-mixed): run 1 as
    written (bfloat16; K1/K2 at every eval bag) and its --stage test; run 2
    with use_pallas and float32 (B5/B6 in training) and a 2-fold run; run 3
    all plain, held to run 2 within 1e-4; bfloat16 against float32 at run 1's
    weights; exact launch counts; the epoch and the step at 64 x 200; the
    bag store's batches against the .npy path."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml

    micro = CLI_EPOCHS * (CLI_SPLITS["train"] // CLI_BATCH)
    evals = CLI_EPOCHS * CLI_SPLITS["val"] + CLI_SPLITS["test"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = write_cohort(root, rng)
        log(f"[cli_train] cohort written in {time.perf_counter() - t0:.2f} s")

        def train(config: Path, log_dir: Path, *extra: str):
            return quiet(cli.main, ["--config", str(config), "--log_dir", str(log_dir),
                                    "--device", dev.type, *extra], tag="cli_train")

        # run 1: the config as written (bfloat16; plain attention in training)
        run1 = cli_config(root, "run1", data)
        t0 = time.perf_counter()
        summary1, launches = launch_counts(lambda: train(run1, root / "run1" / "log"))
        run1_s = time.perf_counter() - t0
        expect("run 1 (bf16, as written): fit + test", launches, 0, 2 * evals)
        rows1 = metric_rows(root / "run1" / "log")
        ckpts = sorted((root / "run1" / "log" / "checkpoints").glob("*.ckpt"))
        tested, launches = launch_counts(lambda: train(run1, root / "run1" / "log",
                                                       "--stage", "test"))
        expect(f"run 1 --stage test over {len(ckpts)} checkpoints", launches, 0,
               2 * CLI_SPLITS["test"] * len(ckpts))
        if sorted(tested) != [c.name for c in ckpts]:
            raise AssertionError(f"--stage test evaluated {sorted(tested)}, not {ckpts}")

        # run 2: use_pallas, float32
        run2 = cli_config(root, "run2", data, {"precision": 32}, {"use_pallas": True})
        summary2, launches = launch_counts(lambda: train(run2, root / "run2" / "log"))
        expect(f"run 2 (use_pallas, float32): fit + test, {micro // 2} optimizer steps", launches,
               2 * micro, 2 * evals)
        for name in launches:
            results[name]["launches"] = launches[name]
        rows2 = metric_rows(root / "run2" / "log")
        kfold = cli_config(root, "kfold", {**data, "cross_val": True, "nfold": 2},
                           {"precision": 32, "epochs": 1}, {"use_pallas": True})
        ensemble, launches = launch_counts(lambda: train(kfold, root / "kfold" / "log"))
        log(f"[cli_train] 2-fold run: ensemble AUC {ensemble['ensemble_auc']:.4f}, patient AUC "
            f"{ensemble['ensemble_patient_auc']:.4f}, launches {launches}")
        if not (root / "kfold" / "log" / "kfold" / "model.1.pt").exists():
            raise AssertionError("the k-fold run wrote no second fold model")

        # run 3: all plain, held to run 2
        run3 = cli_config(root, "run3", data, {"precision": 32},
                          {"use_pallas": False, "fused_inference": False})
        summary3, launches = launch_counts(lambda: train(run3, root / "run3" / "log"))
        expect("run 3 (all plain): fit + test", launches, 0, 0)
        rows3 = metric_rows(root / "run3" / "log")
        worst = max(abs(a[k] - b[k]) for a, b in zip(rows2, rows3)
                    for k in ("loss", "val_loss", "val_auc", "val_patient_auc"))
        worst = max(worst, *(abs(summary2[k] - summary3[k])
                             for k in ("test_loss", "test_auc", "test_patient_auc")))
        for label, rows in (("run 1 (bf16)", rows1), ("run 2 (kernels)", rows2),
                            ("run 3 (plain)", rows3)):
            for r in rows:
                log(f"[cli_train] {label} epoch {r['step']}: " + ", ".join(
                    f"{k} {r[k]:.6f}" for k in ("loss", "val_loss", "val_auc", "val_patient_auc",
                                                "epoch_time_s")))
        log(f"[cli_train] test AUC: run 1 {summary1['test_auc']:.4f}, run 2 "
            f"{summary2['test_auc']:.4f}, run 3 {summary3['test_auc']:.4f}; run 1 fit + test "
            f"{run1_s:.2f} s")
        log(f"[cli_train] run 2 (kernels) vs run 3 (all plain): max |diff| of loss, val_loss, "
            f"val AUCs and test metrics {worst:.3e} (tol 1e-4)")
        if not (len(rows2) == len(rows3) == CLI_EPOCHS and worst <= 1e-4):
            raise AssertionError("the kernel route's training disagrees with the all-plain route")

        # bfloat16 against float32 at run 1's weights: eval bags (K1/K2) and
        # one train-mode batch at 64 x 200, dropout off
        cfg = finalize_config(read_yaml(run1), config_path=run1)
        trainer = cli.build(cfg, str(root / "probe"), dev.type)
        weights = read_checkpoint(root / "run1" / "log" / "checkpoints" / "last.ckpt")["model"]
        model16 = trainer.model
        model16.load_state_dict(weights)
        model32 = create_model("TransMIL", 2, 2048, device=dev)
        model32.load_state_dict(weights)
        gaps = []
        with torch.inference_mode():
            for batch in list(trainer.dm.eval_batches("val"))[:16]:
                bags = torch.from_numpy(batch.bags).to(dev)
                gaps.append((model16.eval()(bags) - model32.eval()(bags)).abs().max().item())
            batch = next(iter(trainer.dm.train_batches(0)))
            bags = torch.from_numpy(batch.bags).to(dev)
            for m in (model16, model32):
                m.train()
                for mod in m.modules():
                    if isinstance(mod, torch.nn.Dropout):
                        mod.eval()
            train_gap = (model16(bags) - model32(bags)).abs().max().item()
        log(f"[cli_train] bf16 vs float32 at run 1's weights: eval bags max |dlogit| "
            f"{max(gaps):.3e}, train batch ({CLI_BATCH} x {CLI_BAG}) {train_gap:.3e} "
            f"(bar {BF16_BAR})")
        if not max(max(gaps), train_gap) <= BF16_BAR:
            raise AssertionError("bfloat16 is outside its bar against float32")

        # the step at 64 x 200, bf16 as written and float32 with use_pallas
        batches = [b for e in range(1 + TIMED_STEPS) for b in trainer.dm.train_batches(e)]
        time_steps(trainer, batches, "bf16 (as written)")
        cfg2 = finalize_config(read_yaml(run2), config_path=run2)
        time_steps(cli.build(cfg2, str(root / "probe2"), dev.type), batches, "float32, use_pallas")

        # one epoch's train batches: per-file .npy reads against the bag store
        dm = trainer.dm
        t0 = time.perf_counter()
        files = list(dm.train_batches(0))
        files_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dm.enable_bagstore(str(root / "train.bags"))
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stored = list(dm.train_batches(0))
        store_s = time.perf_counter() - t0
        if [b.names for b in files] != [b.names for b in stored]:
            raise AssertionError("the bag store's epoch draws other slides")
        log(f"[cli_train] one epoch's {len(files)} train batches of {CLI_BATCH} x {CLI_BAG}: .npy "
            f"files {files_s:.3f} s, bag store {store_s:.3f} s (packing the store once "
            f"{pack_s:.2f} s)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "transmil_deepgraft_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout that holds transmil_deepgraft_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    results: dict = {}
    phase_build()
    dev = torch.device("cuda")
    phase_kernels(rng, results, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_serving(rng, results, Path(tmp), dev)
    phase_fixture(dev)
    t_new = time.perf_counter()
    variables, tiles_u8, calib = phase_qstage(rng, results, dev)
    phase_pipeline(rng, results, dev, variables, tiles_u8, calib)
    log(f"[env] int8 embed phases {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    phase_nystrom(rng, results, dev)
    phase_serve(rng, results, dev, variables, tiles_u8, calib)
    phase_train(results, dev)
    log(f"[env] Nystrom, serve and training phases {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    phase_cli_train(rng, results, dev)
    log(f"[env] cli_train phase {time.perf_counter() - t_new:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
