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
   epoch's train batches from the .npy files against the bag store;
11. the MIL heads the configs train besides TransMIL: the five frozen
   torch-parity fixtures of AttMIL, TransformerMIL and Chowder; the dense
   attention's card path (``scaled_dot_product_attention``) against its
   plain formula at (1, 8, 65,537, 64) and (128, 8, 1,001, 64); feature bags
   of 300, 12,000 and 40,960 tiles through ServingBundle + MicroBatcher of
   AttMIL-2048, TransformerMIL (512 -> 1,024), RoFormerMIL-2048 with slide
   coordinates (exact to 12,000 tiles, 256 landmarks at 40,960), Chowder-512
   and AttTrans-512, the heads with a card route of their own (the dense
   attention's) held to their plain route within 1e-4 up to 12,000 tiles;
   ``cli.train`` of AttMIL_feat_norm_rest.yaml, TransformerMIL_feat_norm_rest
   .yaml (held to its all-plain route within 1e-4) and
   synthetic_roformer_norm_rest.yaml, as written but for paths and 2 epochs,
   with the optimizer step at each config's batch; ``cli.export_model`` of
   AttMIL and RoFormerMIL, ``cli.serve``'s /predict with coords, and
   ``cli.infer --model RoFormerMIL`` on 256 JPEG tiles named with their
   coordinates, within 1e-3 of the in-process slide bundle. No head runs one
   of the eight kernels; the launch counts of every route are checked;
12. the rest of the bag-head zoo and the spatial heads: the five frozen
   torch-parity fixtures of CLAM_SB/MB, DTFD, MDMIL and CTMIL; feature bags
   of 300, 12,000 and 40,960 tiles through ServingBundle + MicroBatcher of
   CLAM_SB-1024, CLAM_MB-1024, DTFD-512, MDMIL-1024 and DSMIL-2048, MDMIL's
   TransLayers through K1/K2 (2 launches each a request) and held to its
   plain route within 1e-4 up to 12,000 tiles; CTMIL-2048 (K1/K2) and
   SpatialResNetMIL-768 eval forwards on 50 x 50 volumes at their configs'
   train batch (128, 8), CTMIL held to its plain route; ``cli.train`` of
   DTFDMIL_resnet50_tcmr_viral.yaml (two tier-wise Adams, batch 1),
   CTMIL_feat_norm_rest.yaml and Resnet50_feat_norm_rest.yaml (the spatial
   variant's volumes) as written but for paths and 2 epochs, with exact
   K1/K2 counts and the optimizer step at each config's batch;
13. from tile files to feature bags and image bags (``phase_extract``):
   ``cli.extract_features`` of 8 slides of JPEG tiles on the float32 and
   int8 routes, B7/B8 at extraction's batch, and ``cli.train`` on the
   extracted cohort and with ``Data.variant: images``;
14. the other tile backbones (``phase_backbones``): ViT-B/16 (at 224 and
   256 px), EfficientNet-B0 + its GELU projection, InceptionV3 at 299 px,
   ResNet34 and the projected ResNet18 timed at 100 tiles beside their
   FLOP-rate bound and held to float64 on the CPU; ``cli.extract_features
   --backbone dino|efficientnet`` from .pth files in the reference's names;
   ``cli.train`` of TransMIL_dino.yaml on the ``images`` variant (exact
   K1/K2 counts, logits held to the plain route); the classic per-tile route
   (``Data.variant: tiles``) for vit, resnet18, efficientnet and inception;
15. pretraining, heatmaps and the analysis CLIs (``phase_tools``):
   ``cli.train`` with use_pallas and its test stage's top-k tiles,
   ``cli.visualize`` of 4 slides of 2,000-12,000 tiles (exact B5/B6 counts,
   no K1/K2 under GradCAM, the scores held to the all-plain route),
   ``ImageVisualizer`` over ResNet50 (gradcam, eigencam) held to float64,
   ``cli.pretrain`` (ResNet18, 64 tiles, batch 32) and ConvMixer,
   ``cli.sustainability`` in both modes at the card's power limit,
   ``cli.export_metrics``, and whether matplotlib is installed;
16. the rest of training (``phase_train_rest``): the nine other optimizer
   rules on TransMIL-2048 with ``use_pallas`` held to the all-plain route
   (the first gradients, then the weights; exact B5/B6 counts, each rule's
   step time), AdaHessian on AttMIL-2048
   and TransformerMIL-2048 (its diagonal held to the CPU's, its step against
   Adam's; TransMIL raises ROADMAP C18's error), and ``Trainer.fit`` with
   SWA, a mid-epoch autosave and its resume, and TensorBoard;
17. the multi-process paths (``phase_parallel``): NCCL as a world of one
   (the join, an all_reduce, a data-parallel step); the int8 ResNet50's
   layout variants on one chunk (``apply_qresnet50_wpack1`` bit-exact to
   ``apply_qresnet50``, ``apply_qresnet50_bf16s1`` at cosine > 0.999 to
   float32, their B7/B8 launches and chunk ms); then two gloo processes on
   the one card: the tile-parallel embed of 1,024 uint8 tiles (chunk 128 a
   process) bit for bit the one-process pipeline's, with B7/B8 4/3 a
   process's chunk and the all_gather's ms; TransMIL-2048 ``use_pallas``
   trained data-parallel (batch 4, 2 a process, 4 optimizer steps) within
   1e-4 of the one-process fit, with B5/B6 and K1/K2 counted a process;
   sequence-parallel Nystrom (sp 2, n 81,920, B3 with its row statistics
   held to their plain version, B4) within 1e-4 of ``nystrom_attention``;
   tensor-parallel TransMIL-2048 (tp 2, a 12,000-tile bag) within
   tests/test_tp.py's bars. Their times are two processes sharing one card:
   overhead, not scaling.

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
# the heads phase: the configs' heads at full width, from seeded random weights
HEAD_FIXTURES = ("attmil_2048", "attmil_1024", "transformer_mil_2048", "transformer_mil_1024",
                 "chowder")
HEAD_TILES = (300, 12000, 40960)
# label: (Model.name, in_features, out_features, knobs, bag sizes, whether the
# head's path has a card route of its own: the dense attention's)
HEAD_SERVED = {
    "AttMIL-2048": ("AttMIL", 2048, 512, {}, HEAD_TILES, False),
    "TransformerMIL-512": ("TransformerMIL", 512, 1024, {}, HEAD_TILES, True),  # retccl's
    "RoFormerMIL-2048 exact": ("RoFormerMIL", 2048, 512, {}, HEAD_TILES[:2], True),
    "RoFormerMIL-2048 landmarks 256": ("RoFormerMIL", 2048, 512, {"num_landmarks": 256},
                                       HEAD_TILES[2:], False),
    "Chowder-512": ("Chowder", 512, 512, {}, HEAD_TILES, False),
    "AttTrans-512": ("AttTrans", 512, 512, {}, HEAD_TILES, True),
}
# the requests held to the plain route: up to 12,000 tiles (the dense
# attention itself is held at 40,960 tiles' 65,537 tokens in DENSE_SHAPES)
HEAD_HELD_TILES = 12000
# the dense attention at the served bags' widest token count (40,960 tiles:
# bucket 65,536 + the cls token) and at TransformerMIL_feat's train batch
DENSE_SHAPES = ((1, 65537), (128, 1001))
HEAD_CONFIGS = ("DeepGraft/AttMIL_feat_norm_rest.yaml",
                "DeepGraft/TransformerMIL_feat_norm_rest.yaml",
                "synthetic_roformer_norm_rest.yaml")
HEAD_SPLITS = {2048: {"train": 32, "val": 16, "test": 16},
               768: {"train": 128, "val": 16, "test": 16}}  # one micro-step of 128 an epoch
HEAD_STEPS = 3  # optimizer steps timed a config after a warm-up one
# the zoo phase: the rest of the bag heads and the two spatial heads, at full
# width from seeded random weights
ZOO_FIXTURES = ("clam_sb", "clam_mb", "dtfd", "mdmil", "ctmil")
ZOO_SERVED = {"CLAM_SB-1024": ("CLAM_SB", 1024), "CLAM_MB-1024": ("CLAM_MB", 1024),
              "DTFD-512": ("DTFD", 512), "MDMIL-1024": ("MDMIL", 1024),
              "DSMIL-2048": ("DSMIL", 2048)}
ZOO_HELD = "MDMIL-1024"  # its TransLayers run K1/K2, held to the plain route to 12,000 tiles
# the spatial heads' eval forward at their configs' train batch on 50 x 50 volumes
ZOO_VOLUMES = {"CTMIL-2048": ("CTMIL", 2048, 128), "SpatialResNetMIL-768": ("resnet50", 768, 8)}
ZOO_CONFIGS = ("DeepGraft/DTFDMIL_resnet50_tcmr_viral.yaml", "DeepGraft/CTMIL_feat_norm_rest.yaml",
               "DeepGraft/Resnet50_feat_norm_rest.yaml")
# the cohorts by in_features: one micro-step of CTMIL's batch of 128 an
# epoch (its grad_acc 2 completes one optimizer step in the 2 epochs), one
# optimizer step of Resnet50's 2 x 8 an epoch
ZOO_SPLITS = {512: {"train": 32, "val": 16, "test": 16},
              2048: {"train": 128, "val": 16, "test": 16},
              768: {"train": 16, "val": 16, "test": 16}}
# the spatial cohorts' tiles a slide: .npy bags carry no coordinates, so
# every tile of a volume sits at grid (0, 0) and the count only costs writing
ZOO_SPATIAL_TILES = (20, 40)
# the extraction phase: 8 slides of 450-550 224x224 JPEG tiles (most end in a
# ragged batch), the CLI's batch of 100, one small slide for --augment (the
# augmentation stack costs ~0.1 s a tile on the host); tiles are drawn from a
# pool of seeded JPEGs (a smooth texture with noise, ~19 KB each)
EXTRACT_SLIDES = 8
EXTRACT_TILES = (450, 550)
EXTRACT_BATCH = 100
AUG_TILES = 24
TILE_POOL = 512
EXTRACT_CONFIG = "DeepGraft/TransMIL_retccl_norm_rest.yaml"
EXTRACT_SPLITS = {"train": 5, "val": 2, "test": 1}  # one train batch of the config's 5
# the images run: 200 JPEG tiles a slide, each bag padded to the config's
# 1,000; 10 train slides make two batches of 5, one grad_acc-2 optimizer step
IMAGE_SPLITS = {"train": 10, "val": 4, "test": 4}
IMAGE_TILES = 200
# phase 14 (the other tile backbones): (name, tile size) of each backbone
# timed at extraction's batch of 100 tiles, 4 of them held to float64 on the CPU
BACKBONES = (("dino", 224), ("dino", 256), ("efficientnet", 224), ("inception", 299),
             ("resnet34", 224), ("resnet18", 224))
HELD_TILES = 4
HELD_TOL = 1e-3  # relative to the largest feature, float32 on the card vs float64
BACKBONE_EXTRACT = ("dino", "efficientnet")
BACKBONE_SPLITS = {"train": 6, "val": 2, "test": 2}
DINO_CONFIG = "DeepGraft/TransMIL_dino.yaml"
CLASSIC_CONFIGS = {"vit": "DeepGraft/Vit_classic_norm_rest.yaml",
                   "resnet18": "DeepGraft/Resnet18_classic_norm_rest.yaml",
                   "efficientnet": "DeepGraft/EfficientNet_classic_norm_rest.yaml",
                   "inception": "DeepGraft/Inception_norm_rest.yaml"}
CLASSIC_TILES = 64  # tiles a slide, and the train batch (the ViT config's 3,000 do not fit)
CLASSIC_HEAD = "AttMIL"  # a bag head in Model.name: the tiles route JAX can run (ROADMAP C13)
CLASSIC_HELD = 8  # tiles of the first step held to float64 on the CPU

# the tools phase (phase 15)
TOOLS_SPLITS = {"train": 8, "val": 4}  # 200-1,000-tile .npy bags
TOOLS_TEST_TILES = (2000, 5333, 8666, 12000)  # the test slides: .h5 bags with grid coords
TOOLS_BATCH = 4  # the train batch (the config's 64 bags would need 64 slides)
IMAGE_VIZ_TILES = 64  # one slide of 224 px tiles through ResNet50 + TransMIL
PRETRAIN_TILES, PRETRAIN_BATCH = 64, 32
CONVMIXER = {"dim": 256, "depth": 8, "kernel_size": 9, "patch_size": 7}
CONVMIXER_TILES = 32

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


def stem_costs(n: int, h: int, w: int) -> tuple[int, int]:
    """The int8 stem's operations (the 7x7x3 window of 64 channels at every
    stride-2 position) and bytes (float32 tiles in, pooled codes out)."""
    ops = 2 * n * (h // 2) * (w // 2) * 64 * 7 * 7 * 3
    return ops, n * h * w * 3 * 4 + n * (h // 4) * (w // 4) * 64


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
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk

    variables = random_resnet50_variables(rng)
    tiles_u8 = rng.integers(0, 256, (SLIDE_TILES, TILE, TILE, 3), dtype=np.uint8)
    calib = normalize_tiles(tiles_u8[:CALIB_TILES])
    t0 = time.perf_counter()
    q = build_qresnet50(variables, calib, device=dev)
    sync(dev)
    log(f"[qstage] build_qresnet50 on {CALIB_TILES} tiles of {TILE}x{TILE}: "
        f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        for n_tiles in (EXTRACT_BATCH, CHUNK):
            xs = torch.from_numpy(normalize_tiles(tiles_u8[:n_tiles])).to(dev)
            got = qk.fused_stem(xs, q)
            sync(dev)
            want = qk.stem_reference(xs, q)
            bad = int((got != want).sum())
            ms = cuda_ms(lambda: qk.fused_stem(xs, q))
            plain_ms = cuda_ms(lambda: qk.stem_reference(xs, q), reps=3, warmup=1)
            ops, nbytes = stem_costs(n_tiles, TILE, TILE)
            t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            log(f"[qstage] stem (qstem_run) at {n_tiles} tiles: {bad} differing int8 codes of "
                f"{want.numel()}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{max(t_ops, t_bytes):.4f} ms by {'operations' if t_ops > t_bytes else 'bytes'} "
                f"({ops:.3e} int8 OP, {nbytes / 1e6:.1f} MB)")
            if bad:
                raise AssertionError(f"the stem kernel disagrees with the plain stem at {n_tiles}")
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
    expected = {"qstage_run": 4 * chunks, "qentry_run": 3 * chunks, "qstem_run": chunks,
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
    want = {"qstage_run": 4 * chunks, "qentry_run": 3 * chunks, "qstem_run": chunks,
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


def write_cohort(root: Path, rng, dim: int = 2048, splits: dict | None = None,
                 tag: str = "cli_train", tiles: tuple[int, int] = CLI_TILES) -> dict:
    """A cohort under ``root``: per-slide ``dim``-d float32 .npy bags of
    ``tiles`` tiles (a class signal on 64 features), ``splits`` (default
    ``CLI_SPLITS``) slides a split, a label JSON whose paths carry
    ``FEATURES_RETCCL_2048``, a patient map of two slides (one label) a
    patient. Returns the config's ``Data`` paths."""
    import numpy as np

    splits = splits or CLI_SPLITS
    data = root / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels, patients, total = {}, {}, 0
    for split, count in splits.items():
        labels[split] = []
        for i in range(count):
            name, y = f"{split}_{i:03d}", (i // 2) % 2
            x = rng.standard_normal((int(rng.integers(tiles[0], tiles[1] + 1)), dim),
                                    dtype=np.float32)
            x[:, :64] += 0.25 * y
            np.save(data / f"{name}.npy", x)
            total += x.nbytes
            labels[split].append([f"FEATURES_RETCCL_2048/{name}.npy", y])
            patients[name] = f"{split}_patient_{i // 2:03d}"
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    log(f"[{tag}] cohort: {sum(splits.values())} slides of {tiles[0]}-{tiles[1]} "
        f"tiles x {dim}, {total / 2**30:.2f} GiB of .npy")
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
    trainer.tx.init(trainer.model)
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
    # the val bags run the fused eval forward (K1/K2); the test stage's bags
    # the return_attn forward of the top-k tile export (the standard layers:
    # B5/B6 under use_pallas), as JAX's test stage does
    evals = CLI_EPOCHS * CLI_SPLITS["val"]
    tests = CLI_SPLITS["test"]
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
        if len(list((root / "run1" / "log" / "topk_tiles").glob("*_topk_tiles.csv"))) != tests:
            raise AssertionError("run 1's test stage wrote no top-k tiles of every test slide")
        rows1 = metric_rows(root / "run1" / "log")
        ckpts = sorted((root / "run1" / "log" / "checkpoints").glob("*.ckpt"))
        tested, launches = launch_counts(lambda: train(run1, root / "run1" / "log",
                                                       "--stage", "test"))
        expect(f"run 1 --stage test over {len(ckpts)} checkpoints", launches, 0, 0)
        if sorted(tested) != [c.name for c in ckpts]:
            raise AssertionError(f"--stage test evaluated {sorted(tested)}, not {ckpts}")

        # run 2: use_pallas, float32
        run2 = cli_config(root, "run2", data, {"precision": 32}, {"use_pallas": True})
        summary2, launches = launch_counts(lambda: train(run2, root / "run2" / "log"))
        expect(f"run 2 (use_pallas, float32): fit + test, {micro // 2} optimizer steps", launches,
               2 * micro + 2 * tests, 2 * evals)
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


def head_bags(rng, n: int, dim: int):
    """A feature bag of ``n`` tiles and its slide coordinates: distinct grid
    positions in a tissue region away from the origin."""
    import numpy as np

    side = int(np.ceil(np.sqrt(1.5 * n)))
    cells = rng.choice(side * side, n, replace=False)
    coords = np.stack([cells % side, cells // side], axis=-1).astype(np.float32) + [1200, 800]
    return rng.standard_normal((n, dim), dtype=np.float32), coords


def random_head_params(name: str, in_features: int, out_features: int, knobs: dict,
                       seed: int) -> dict:
    """A head's flax-layout params from its seeded PyTorch init (on the CPU),
    through the reference converter of its state dict."""
    import torch

    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.utils.torch_weights import convert_head_state_dict

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(name, 2, in_features, out_features, device="cpu", **knobs)
    return convert_head_state_dict(model.state_dict(), name, in_features)["params"]


def heads_config(root: Path, name: str, config: str, data: dict | None = None,
                 model: dict | None = None, epochs: int = CLI_EPOCHS) -> Path:
    """A repository config as written but for its paths, log path and
    ``epochs``, under ``root/name/`` with its own file name."""
    import yaml

    cfg = yaml.safe_load((ROOT / "transmil_deepgraft_tpu" / "configs" / config).read_text())
    cfg["Data"].update(data or {})
    cfg["General"].update({"log_path": str(root / "logs"), "epochs": epochs})
    cfg["Model"].update(model or {})
    path = root / name / Path(config).parent.name / Path(config).name
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def head_step_ms(trainer, batches: list) -> tuple[float, float]:
    """(median ms, min ms) of one optimizer step at the config's batch: the
    grad_acc micro-batches ``batches``, staged on the device once, stepped
    ``HEAD_STEPS`` times after a warm-up step, host clock with the device
    synchronized."""
    import numpy as np

    dev = trainer.device
    trainer.tx.init(trainer.model)
    staged = [(*trainer._batch_tensors(b), trainer._batch_coords(b)) for b in batches]
    steps = []
    for _ in range(1 + HEAD_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        for bags, labels, coords in staged:
            trainer.train_step(bags, labels, coords)
        sync(dev)
        steps.append((time.perf_counter() - t0) * 1e3)
    steps = steps[1:]
    return float(np.median(steps)), float(min(steps))


def all_launch_counts(run):
    """(run's result, the launches of all eight kernels during it): every
    count is set to 0 just before and read just after."""
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk

    for mod in (nk, qk, tk):
        mod.reset_launch_counts()
    out = run()
    return out, {**nk.LAUNCHES, **qk.LAUNCHES, **tk.LAUNCHES}


def expect_launches_exactly(label: str, got: dict, **want) -> None:
    """Each kernel launched ``want[name]`` times during the run (0 if not named)."""
    wanted = {k: want.get(k, 0) for k in got}
    if got != wanted:
        raise AssertionError(f"{label}: expected launches {wanted}, got {got}")


def phase_heads(rng, results: dict, dev, variables) -> None:
    """The MIL heads the configs train besides TransMIL, on the card: the
    five frozen torch-parity fixtures; feature bags of 300, 12,000 and
    40,960 tiles through ServingBundle + MicroBatcher of AttMIL-2048,
    TransformerMIL (512 -> 1024), RoFormerMIL-2048 with slide coordinates
    (exact up to 12,000 tiles, 256 landmarks at 40,960), Chowder-512 and
    AttTrans-512, the requests of the heads with a card route of their own
    (TransformerMIL, exact RoFormerMIL, AttTrans) held to the plain route
    up to 12,000 tiles;
    the dense attention's card path (scaled_dot_product_attention) against
    its plain version; ``cli.train`` of AttMIL_feat_norm_rest.yaml,
    TransformerMIL_feat_norm_rest.yaml (held to its all-plain route) and
    synthetic_roformer_norm_rest.yaml cut to 2 epochs, with the optimizer
    step at each config's batch; ``cli.export_model`` of AttMIL and
    RoFormerMIL, ``cli.serve``'s /predict with coords and ``cli.infer
    --model RoFormerMIL`` on JPEG tiles named with their coordinates. None
    of the eight kernels is on a head's path (the backbone's B7/B8 are, in
    cli.infer): the launch counts of each route are checked."""
    import io
    import threading
    from itertools import chain, islice

    import numpy as np
    import torch
    from PIL import Image

    from transmil_deepgraft_tpu_torch.cli import export_model, infer
    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.cli.serve import make_server
    from transmil_deepgraft_tpu_torch.data.tiles import imagenet_normalize, parse_coords
    from transmil_deepgraft_tpu_torch.inference import decode_tile_paths
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops.attention import plain_route, softmax_attention
    from transmil_deepgraft_tpu_torch.serving import (
        MicroBatcher, ServingBundle, export_serving_bundle)
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
    from transmil_deepgraft_tpu_torch.utils.jax_params import head_state_dict_from_jax, unflatten

    t_phase = time.perf_counter()
    parts: dict = {}

    def part(name: str) -> None:
        """Close the phase's part ``name``: its seconds since the last one."""
        now = time.perf_counter()
        parts[name] = now - sum(parts.values()) - t_phase

    # 1. the frozen torch-parity fixtures on the card
    for fixture in HEAD_FIXTURES:
        name = {"attmil": "AttMIL", "transformer": "TransformerMIL", "chowder": "Chowder"}[
            fixture.split("_")[0]]
        with np.load(ROOT / "tests" / "fixtures" / f"parity_{fixture}.npz") as z:
            params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
            bag, want = z["bag"], z["out:logits"]
        model = create_model(name, want.shape[-1], bag.shape[-1], device=dev)
        model.load_state_dict(head_state_dict_from_jax(name, params, bag.shape[-1]))
        with torch.inference_mode():
            got = model.eval()(torch.from_numpy(bag).to(dev)).cpu().numpy()
        err = float(np.abs(got - want).max())
        log(f"[heads] fixture parity_{fixture} ({name}, {bag.shape[0]} tiles x "
            f"{bag.shape[1]}): max|dlogit| {err:.3e} vs the recorded torch reference (tol {TOL})")
        if not err <= TOL:
            raise AssertionError(f"fixture {fixture} disagrees: {err}")
    part("fixtures")

    # 2. the dense attention: the card path against its plain version
    for b, n in DENSE_SHAPES:
        q, k, v = (torch.randn(b, 8, n, 64, device=dev) for _ in range(3))
        outs: list = []
        card_ms = cuda_ms(lambda: outs.append(softmax_attention(q, k, v, 0.125)), reps=3,
                          warmup=0)
        with plain_route():  # one call: the plain formula at 65,537 tokens takes 0.6 s
            plain_ms = cuda_ms(lambda: outs.append(softmax_attention(q, k, v, 0.125)), reps=1,
                               warmup=0)
        card, plain = outs[0], outs[-1]
        err = float((card - plain).abs().max())
        log(f"[heads] dense attention ({b}, 8, {n}, 64): scaled_dot_product_attention "
            f"{card_ms:.3f} ms, plain blocked formula {plain_ms:.3f} ms, max|diff| {err:.3e} "
            f"(tol {SPLIT_TOL})")
        if not err <= SPLIT_TOL:
            raise AssertionError(f"the dense attention's card path disagrees: {err}")
        del q, k, v, outs, card, plain
    part("dense attention")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 3. feature bags through ServingBundle + MicroBatcher; the bags of a
        # width are drawn once and served to each head of that width
        bags: dict = {}
        for i, (label, (name, in_f, out_f, knobs, sizes, card_route)) in enumerate(
                HEAD_SERVED.items()):
            t0 = time.perf_counter()
            params = random_head_params(name, in_f, out_f, knobs, seed=100 + i)
            path = tmp / f"head{i}.tdx"
            export_serving_bundle(params, path, model_name=name, in_features=in_f, n_classes=2,
                                  buckets=SMOKE_BUCKETS, knobs=knobs)
            bundle = ServingBundle.load(path, device=dev)
            batcher = MicroBatcher(bundle)
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for n in sizes:
                if (n, in_f) not in bags:
                    bags[n, in_f] = head_bags(rng, n, in_f)
            bags_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                warm, warm_c = bags[sizes[0], in_f]
                batcher.predict_logits(warm, warm_c if bundle.coord_aware else None)
                for n in sizes:
                    bag, coords = bags[n, in_f]
                    c = coords if bundle.coord_aware else None
                    sync(dev)
                    t1 = time.perf_counter()
                    (logits, launches) = all_launch_counts(lambda: batcher.predict_logits(bag, c))
                    ms = (time.perf_counter() - t1) * 1e3
                    expect_launches_exactly(f"[heads] {label} request", launches)
                    if not (logits.shape == (1, 2) and np.isfinite(logits).all()):
                        raise AssertionError(f"{label} at {n} tiles: {logits}")
                    held = ("no card route of its own: its plain route is the same code"
                            if not card_route else
                            "the dense attention at this size is held in step 2")
                    if card_route and n <= HEAD_HELD_TILES:
                        sync(dev)
                        t1 = time.perf_counter()
                        with plain_route():
                            plain = bundle.predict_logits(bag, c)
                        plain_ms = (time.perf_counter() - t1) * 1e3
                        err = float(np.abs(plain - logits).max())
                        held = (f"plain route {plain_ms:.2f} ms, max|dlogit| vs the plain "
                                f"route {err:.3e} (tol {SPLIT_TOL})")
                        if not err <= SPLIT_TOL:
                            raise AssertionError(f"{label} at {n} tiles: the card route "
                                                 f"disagrees: {err}")
                    log(f"[heads] {label}, {n} tiles{' with coords' if c is not None else ''}: "
                        f"{ms:.2f} ms a request, logits {logits.ravel().tolist()}; {held}")
                    if n == sizes[0] and bundle.coord_aware:  # the coords reach the head
                        moved = float(np.abs(batcher.predict_logits(bag) - logits).max())
                        if not moved > 1e-6:
                            raise AssertionError(f"{label}: coords do not change the logits")
            finally:
                batcher.close()
            log(f"[heads] {label}: params, export and load {setup_s:.2f} s, drawing its bags "
                f"{bags_s:.2f} s, requests {time.perf_counter() - t0:.2f} s")
            del bundle, batcher
            torch.cuda.empty_cache()
        del bags
        part("feature bags")

        # 4. cli.train on the repository's configs, 2 epochs each
        def train(config: Path, log_dir: Path, *extra: str):
            return quiet(cli.main, ["--config", str(config), "--log_dir", str(log_dir),
                                    "--device", dev.type, *extra], tag="heads")

        cohorts = {dim: write_cohort(tmp / f"cohort{dim}", rng, dim, splits, tag="heads")
                   for dim, splits in HEAD_SPLITS.items()}
        part("cohorts")
        for config in HEAD_CONFIGS:
            raw = read_yaml(ROOT / "transmil_deepgraft_tpu" / "configs" / config)
            synthetic = bool(raw.Data.synthetic)
            data = None if synthetic else cohorts[int(raw.Model.in_features)]
            path = heads_config(tmp, Path(config).stem, config, data)
            t0 = time.perf_counter()
            summary, launches = all_launch_counts(
                lambda: train(path, tmp / Path(config).stem / "log"))
            fit_s = time.perf_counter() - t0
            expect_launches_exactly(f"[heads] cli.train {config}", launches)
            rows = metric_rows(tmp / Path(config).stem / "log")
            t0 = time.perf_counter()
            cfg = finalize_config(read_yaml(path), config_path=path)
            trainer = cli.build(cfg, str(tmp / Path(config).stem / "probe"), dev.type)
            if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
                raise AssertionError(f"{config}: the head is not float32")
            epochs = chain.from_iterable(trainer.dm.train_batches(e) for e in range(1000))
            batches = list(islice(epochs, trainer.tx.grad_accum_steps))
            step_ms, step_min = head_step_ms(trainer, batches)
            batch = batches[0].bags.shape
            log(f"[heads] cli.train {config} ({raw.Model.name}, precision "
                f"{raw.General.precision or 32} -> float32, batch {batch[0]} x {batch[1]} x "
                f"{batch[2]}, grad_acc {trainer.tx.grad_accum_steps}): {CLI_EPOCHS} epochs + "
                f"test {fit_s:.2f} s; " + "; ".join(
                    f"epoch {r['step']} loss {r['loss']:.6f} val_loss {r['val_loss']:.6f} "
                    f"val_auc {r['val_auc']:.4f}" for r in rows)
                + f"; test_auc {summary['test_auc']:.4f}; optimizer step median {step_ms:.2f} "
                f"ms (min {step_min:.2f}) of {HEAD_STEPS} (timing them "
                f"{time.perf_counter() - t0:.2f} s)")
            if len(rows) != CLI_EPOCHS or not np.isfinite(summary["test_loss"]):
                raise AssertionError(f"{config}: {rows}, {summary}")
            if raw.Model.name == "TransformerMIL":  # its card path against the plain route
                with plain_route():
                    summary_p = train(path, tmp / Path(config).stem / "plain")
                rows_p = metric_rows(tmp / Path(config).stem / "plain")
                worst = max(abs(a[k] - b[k]) for a, b in zip(rows, rows_p)
                            for k in ("loss", "val_loss", "val_auc", "val_patient_auc"))
                worst = max(worst, *(abs(summary[k] - summary_p[k])
                                     for k in ("test_loss", "test_auc", "test_patient_auc")))
                log(f"[heads] {config}: scaled_dot_product_attention vs the all-plain route, "
                    f"max |diff| of loss, val_loss, val AUCs and test metrics {worst:.3e} "
                    f"(tol 1e-4)")
                if not (len(rows_p) == CLI_EPOCHS and worst <= 1e-4):
                    raise AssertionError(f"{config}: the card path's training disagrees")
            del trainer, batches
            torch.cuda.empty_cache()
        part("cli.train")

        # 5. the entry points: cli.export_model, cli.serve, cli.infer
        sds = {}
        for name in ("AttMIL", "RoFormerMIL"):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(7)
                sds[name] = create_model(name, 2, 2048, device="cpu").state_dict()
            torch.save(sds[name], tmp / f"{name}.pth")
            quiet(export_model.main, ["--model", name, "--ckpt", str(tmp / f"{name}.pth"),
                                      "--out", str(tmp / f"{name}.tdx"), "--buckets",
                                      ",".join(map(str, SMOKE_BUCKETS))], tag="heads")
        bag, coords = head_bags(rng, SERVE_BAG, 2048)
        for name in ("AttMIL", "RoFormerMIL"):
            bundle = ServingBundle.load(tmp / f"{name}.tdx", device=dev)
            c = coords if bundle.coord_aware else None
            want = bundle.predict_logits(bag, c)
            srv = make_server(bundle, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                port = srv.server_address[1]
                buf = io.BytesIO()
                np.savez(buf, features=bag, coords=coords)
                body = buf.getvalue()
                t0 = time.perf_counter()
                status, doc, _ = http(port, "POST", "/predict", body)
                ms = (time.perf_counter() - t0) * 1e3
                if bundle.coord_aware:
                    err = float(np.abs(np.asarray(doc.get("logits")) - want).max())
                    log(f"[heads] cli.serve {name} /predict, {SERVE_BAG} tiles with coords "
                        f"(.npz, {len(body) / 1e6:.1f} MB): {ms:.2f} ms, max|dlogit| vs "
                        f"in-process {err:.3e} (tol 1e-5)")
                    if status != 200 or not err <= 1e-5:
                        raise AssertionError(f"/predict with coords: {status} {err}")
                else:
                    log(f"[heads] cli.serve {name} /predict with coords: {status} "
                        f"{doc.get('error', '')[:60]}")
                    if status != 400:
                        raise AssertionError(f"{name} took coords: {status}")
                    status, doc, _ = http(port, "POST", "/predict", npy(bag))
                    err = float(np.abs(np.asarray(doc.get("logits")) - want).max())
                    if status != 200 or not err <= 1e-5:
                        raise AssertionError(f"{name} /predict: {status} {err}")
            finally:
                srv.shutdown()
                srv.server_close()
        part("export, serve")

        if DISK_TILES not in SMOKE_BUCKETS:  # the bundle's bag is then cli.infer's, unpadded
            raise AssertionError(f"DISK_TILES {DISK_TILES} is not a serving bucket")
        slide = tmp / "tiles" / "slideR"
        slide.mkdir(parents=True)
        for t in range(DISK_TILES):
            x, y = 400 + t % 16 + (t // 64), 900 + t // 16
            Image.fromarray(rng.integers(0, 256, (TILE, TILE, 3), dtype=np.uint8)).save(
                slide / f"tile_({x}-{y}).jpg", quality=90)
        paths = sorted(slide.glob("*.jpg"))  # cli.infer's order
        tiles = decode_tile_paths(paths, TILE)
        np.save(tmp / "calib.npy", imagenet_normalize(tiles[:64]))  # cli.infer's calibration
        torch.save(torchvision_state_dict(variables), tmp / "backbone.pth")
        quiet(export_model.main, ["--model", "RoFormerMIL", "--ckpt", str(tmp / "RoFormerMIL.pth"),
                                  "--out", str(tmp / "slide.tdx"), "--backbone_ckpt",
                                  str(tmp / "backbone.pth"), "--calib_tiles",
                                  str(tmp / "calib.npy"), "--chunk", str(CHUNK), "--tile_hw",
                                  str(TILE), "--buckets", ",".join(map(str, SMOKE_BUCKETS)),
                                  "--device", str(dev)], tag="heads")
        slide_bundle = ServingBundle.load(tmp / "slide.tdx", device=dev)
        part("slide tiles, export")
        file_coords = np.asarray([parse_coords(p.name) for p in paths], np.float32)
        want_probs, want_scores = slide_bundle.predict_slide_with_attention(tiles, file_coords)
        t0 = time.perf_counter()
        (got,), launches = all_launch_counts(lambda: quiet(infer.main, [
            "--tiles_root", str(tmp / "tiles"), "--backbone_ckpt", str(tmp / "backbone.pth"),
            "--head_ckpt", str(tmp / "RoFormerMIL.pth"), "--model", "RoFormerMIL",
            "--quantize", "int8", "--chunk", str(CHUNK), "--tile_size", str(TILE),
            "--out_dir", str(tmp / "out"), "--device", str(dev)], tag="heads"))
        infer_s = time.perf_counter() - t0
        chunks = -(-DISK_TILES // CHUNK)
        expect_launches_exactly("[heads] cli.infer --model RoFormerMIL", launches,
                                qstage_run=4 * chunks, qentry_run=3 * chunks,
                                qstem_run=chunks)
        err = float(np.abs(np.asarray(got["probs"]) - want_probs).max())
        grid = slide_bundle.predict_slide(tiles)
        log(f"[heads] cli.infer --model RoFormerMIL, one slide of {DISK_TILES} JPEG tiles named "
            f"with their coordinates: {infer_s:.2f} s (int8 calibration included), probs "
            f"{got['probs']}, max|dprob| vs the in-process slide bundle with the file-name "
            f"coords {err:.3e} (tol {TOL}); the square-grid fallback would give "
            f"{grid.tolist()}; launches {launches}")
        if not err <= TOL:
            raise AssertionError(f"cli.infer RoFormerMIL disagrees: {err}")
    part("cli.infer")
    log(f"[heads] phase {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"{name} {s:.1f} s" for name, s in parts.items()))


def phase_zoo(rng, results: dict, dev) -> None:
    """The rest of the bag-head zoo and the spatial heads, on the card: the
    five frozen torch-parity fixtures; feature bags of 300, 12,000 and
    40,960 tiles through ServingBundle + MicroBatcher of CLAM_SB-1024,
    CLAM_MB-1024, DTFD-512, MDMIL-1024 and DSMIL-2048 (MDMIL's TransLayers
    through K1/K2, 2 launches each a request, held to its plain route up to
    12,000 tiles); CTMIL-2048 (K1/K2) and SpatialResNetMIL-768 eval forwards
    on 50 x 50 volumes at their configs' train batch (128, 8), CTMIL held to
    its plain route; ``cli.train`` of DTFDMIL_resnet50_tcmr_viral.yaml,
    CTMIL_feat_norm_rest.yaml and Resnet50_feat_norm_rest.yaml as written
    but for paths and 2 epochs, with the optimizer step at each config's
    batch. The launch counts of every route are checked."""
    from itertools import chain, islice

    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.models import create_model, head_logits
    from transmil_deepgraft_tpu_torch.serving import (
        MicroBatcher, ServingBundle, export_serving_bundle)
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
    from transmil_deepgraft_tpu_torch.utils.jax_params import (
        head_knobs_from_params, head_state_dict_from_jax, unflatten)

    t_phase = time.perf_counter()
    parts: dict = {}

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - sum(parts.values()) - t_phase

    # 1. the frozen torch-parity fixtures on the card
    for fixture in ZOO_FIXTURES:
        name = {"clam": fixture.upper(), "dtfd": "DTFD", "mdmil": "MDMIL",
                "ctmil": "CTMIL"}[fixture.split("_")[0]]
        with np.load(ROOT / "tests" / "fixtures" / f"parity_{fixture}.npz") as z:
            params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("param:")})
            stats = unflatten({k[5:]: z[k] for k in z.files if k.startswith("stat:")}) or None
            bag, want = z["bag"], z["out:logits"]
        model = create_model(name, want.shape[-1], bag.shape[-1], device=dev,
                             **head_knobs_from_params(name, params))
        model.load_state_dict(head_state_dict_from_jax(name, params, bag.shape[-1], stats))
        with torch.inference_mode():
            got = head_logits(model.eval(), torch.from_numpy(bag).to(dev)).cpu().numpy()
        err = float(np.abs(got - want).max())
        log(f"[zoo] fixture parity_{fixture} ({name}, input {bag.shape}): max|dlogit| "
            f"{err:.3e} vs the recorded torch reference (tol {TOL})")
        if not err <= TOL:
            raise AssertionError(f"fixture {fixture} disagrees: {err}")
    part("fixtures")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 2. feature bags through ServingBundle + MicroBatcher, drawn once a width
        bags: dict = {}
        for i, (label, (name, in_f)) in enumerate(ZOO_SERVED.items()):
            t0 = time.perf_counter()
            params = random_head_params(name, in_f, 512, {}, seed=200 + i)
            path = tmp / f"zoo{i}.tdx"
            export_serving_bundle(params, path, model_name=name, in_features=in_f, n_classes=2,
                                  buckets=SMOKE_BUCKETS)
            bundle = ServingBundle.load(path, device=dev)
            batcher = MicroBatcher(bundle)
            for n in HEAD_TILES:
                if (n, in_f) not in bags:
                    bags[n, in_f] = rng.standard_normal((n, in_f), dtype=np.float32)
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            per_forward = 2 if label == ZOO_HELD else 0
            try:
                batcher.predict_logits(bags[HEAD_TILES[0], in_f])  # warm-up
                for n in HEAD_TILES:
                    bag = bags[n, in_f]
                    sync(dev)
                    t1 = time.perf_counter()
                    logits, launches = all_launch_counts(lambda: batcher.predict_logits(bag))
                    ms = (time.perf_counter() - t1) * 1e3
                    expect_launches_exactly(f"[zoo] {label} request", launches,
                                            translayer_k1=per_forward,
                                            translayer_k2=per_forward)
                    if not (logits.shape == (1, 2) and np.isfinite(logits).all()):
                        raise AssertionError(f"{label} at {n} tiles: {logits}")
                    held = "no card route of its own"
                    if label == ZOO_HELD and n <= HEAD_HELD_TILES:
                        bundle.model.fused_inference = False
                        sync(dev)
                        t1 = time.perf_counter()
                        plain, plain_launches = all_launch_counts(
                            lambda: bundle.predict_logits(bag))
                        plain_ms = (time.perf_counter() - t1) * 1e3
                        bundle.model.fused_inference = True
                        expect_launches_exactly(f"[zoo] {label} plain route", plain_launches)
                        err = float(np.abs(plain - logits).max())
                        held = (f"K1/K2 {launches['translayer_k1']}/"
                                f"{launches['translayer_k2']} launches; plain route "
                                f"{plain_ms:.2f} ms, max|dlogit| {err:.3e} (tol {SPLIT_TOL})")
                        if not err <= SPLIT_TOL:
                            raise AssertionError(f"{label} at {n} tiles disagrees: {err}")
                    elif per_forward:
                        held = (f"K1/K2 {launches['translayer_k1']}/"
                                f"{launches['translayer_k2']} launches")
                    log(f"[zoo] {label}, {n} tiles: {ms:.2f} ms a request, logits "
                        f"{logits.ravel().tolist()}; {held}")
            finally:
                batcher.close()
            log(f"[zoo] {label}: params, export and load {setup_s:.2f} s (its bags drawn "
                f"there), requests {time.perf_counter() - t0:.2f} s")
            del bundle, batcher
            torch.cuda.empty_cache()
        del bags
        part("feature bags")

        # 3. the spatial heads on 50 x 50 volumes at their configs' train batch
        gen = torch.Generator(device=dev).manual_seed(0)
        for label, (name, in_f, batch) in ZOO_VOLUMES.items():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(300)
                model = create_model(name, 2, in_f, device=dev).eval()
            x = torch.randn(batch, 50, 50, in_f, device=dev, generator=gen)
            with torch.inference_mode():
                outs: list = []
                ms = cuda_ms(lambda: outs.append(model(x)), reps=3, warmup=1)
                got, launches = all_launch_counts(lambda: model(x))
                per_forward = 2 if name == "CTMIL" else 0
                expect_launches_exactly(f"[zoo] {label} forward", launches,
                                        translayer_k1=per_forward, translayer_k2=per_forward)
                held = "no card route of its own"
                if name == "CTMIL":
                    model.fused_inference = False
                    plain_ms = cuda_ms(lambda: outs.append(model(x)), reps=2, warmup=0)
                    err = float((outs[-1] - got).abs().max())
                    held = (f"K1/K2 2/2 launches; plain route {plain_ms:.2f} ms, max|dlogit| "
                            f"{err:.3e} (tol {SPLIT_TOL})")
                    if not err <= SPLIT_TOL:
                        raise AssertionError(f"{label}: the card route disagrees: {err}")
            if not (got.shape == (batch, 2) and torch.isfinite(got).all()):
                raise AssertionError(f"{label}: {got}")
            log(f"[zoo] {label} eval forward, batch {batch} x 50 x 50 x {in_f}: {ms:.2f} ms; "
                f"{held}")
            del model, x, outs, got
            torch.cuda.empty_cache()
        part("volumes")

        # 4. cli.train of the repository's configs, 2 epochs each
        def train(config: Path, log_dir: Path):
            return quiet(cli.main, ["--config", str(config), "--log_dir", str(log_dir),
                                    "--device", dev.type], tag="zoo")

        cohorts = {dim: write_cohort(tmp / f"cohort{dim}", rng, dim, splits, tag="zoo",
                                     tiles=CLI_TILES if dim == 512 else ZOO_SPATIAL_TILES)
                   for dim, splits in ZOO_SPLITS.items()}
        part("cohorts")
        for config in ZOO_CONFIGS:
            raw = read_yaml(ROOT / "transmil_deepgraft_tpu" / "configs" / config)
            dim = int(raw.Model.in_features)
            path = heads_config(tmp, Path(config).stem, config, cohorts[dim])
            t0 = time.perf_counter()
            summary, launches = all_launch_counts(
                lambda: train(path, tmp / Path(config).stem / "log"))
            fit_s = time.perf_counter() - t0
            # CTMIL's eval forwards (val each epoch, then test; batch 1) run K1/K2
            evals = CLI_EPOCHS * ZOO_SPLITS[dim]["val"] + ZOO_SPLITS[dim]["test"]
            per_eval = 2 if raw.Model.name == "CTMIL" else 0
            expect_launches_exactly(f"[zoo] cli.train {config}", launches,
                                    translayer_k1=per_eval * evals,
                                    translayer_k2=per_eval * evals)
            rows = metric_rows(tmp / Path(config).stem / "log")
            t0 = time.perf_counter()
            cfg = finalize_config(read_yaml(path), config_path=path)
            trainer = cli.build(cfg, str(tmp / Path(config).stem / "probe"), dev.type)
            if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
                raise AssertionError(f"{config}: the head is not float32")
            epochs = chain.from_iterable(trainer.dm.train_batches(e) for e in range(1000))
            batches = list(islice(epochs, trainer.tx.grad_accum_steps))
            step_ms, step_min = head_step_ms(trainer, batches)
            shape = "x".join(map(str, batches[0].bags.shape))
            log(f"[zoo] cli.train {config} ({raw.Model.name}, precision "
                f"{raw.General.precision or 32} -> float32, batch {shape}, grad_acc "
                f"{trainer.tx.grad_accum_steps}, {type(trainer.tx).__name__}): {CLI_EPOCHS} "
                f"epochs + test {fit_s:.2f} s; " + "; ".join(
                    f"epoch {r['step']} loss {r['loss']:.6f} val_loss {r['val_loss']:.6f} "
                    f"val_auc {r['val_auc']:.4f}" for r in rows)
                + f"; test_auc {summary['test_auc']:.4f}; K1/K2 launches "
                f"{launches['translayer_k1']}/{launches['translayer_k2']}; optimizer step "
                f"median {step_ms:.2f} ms (min {step_min:.2f}) of {HEAD_STEPS} (timing them "
                f"{time.perf_counter() - t0:.2f} s)")
            if len(rows) != CLI_EPOCHS or not np.isfinite(summary["test_loss"]):
                raise AssertionError(f"{config}: {rows}, {summary}")
            del trainer, batches
            torch.cuda.empty_cache()
        part("cli.train")
    log(f"[zoo] phase {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"{name} {s:.1f} s" for name, s in parts.items()))


def jpeg_pool(rng, n: int = TILE_POOL, size: int = TILE) -> list[bytes]:
    """``n`` seeded ``size`` x ``size`` JPEG tiles: crops of a smooth random
    texture with noise (about the size and decode cost of a tissue tile)."""
    import io

    import numpy as np
    from PIL import Image

    small = rng.integers(0, 256, (160, 160, 3), dtype=np.uint8)
    tex = np.asarray(Image.fromarray(small).resize((2048, 2048), Image.BICUBIC), np.int16)
    tex = (tex + rng.integers(-12, 13, tex.shape)).clip(0, 255).astype(np.uint8)
    pool = []
    for y, x in rng.integers(0, 2048 - size, (n, 2)):
        buf = io.BytesIO()
        Image.fromarray(tex[y:y + size, x:x + size]).save(buf, format="JPEG", quality=90)
        pool.append(buf.getvalue())
    return pool


def write_slides(root: Path, rng, pool: list[bytes], counts: dict) -> int:
    """``root/BLOCKS/<slide>/tile_(x-y).jpg`` for each ``{slide: tiles}``,
    tiles drawn from ``pool``; returns the bytes written."""
    total = 0
    for name, n in counts.items():
        folder = root / "BLOCKS" / name
        folder.mkdir(parents=True)
        for t, k in enumerate(rng.integers(0, len(pool), n)):
            (folder / f"tile_({t % 32}-{t // 32}).jpg").write_bytes(pool[k])
            total += len(pool[k])
    return total


def prefetched_step_parts(trainer, tag: str, label: str) -> None:
    """One epoch's optimizer steps as the Trainer runs them: the prefetch
    thread decodes a batch (JPEG decode, normalize, pad, collate) and copies
    it, pinned, on a side stream, while the device steps on the one before.
    Decode is timed on the thread, the device in the loop; what the wall
    time falls short of decode + copy + device is what the thread hid."""
    import torch

    from transmil_deepgraft_tpu_torch.data.pipeline import to_device

    dev = trainer.device
    spent = {"decode": 0.0, "device": 0.0}

    def timed(batches):  # runs on the prefetch thread
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            spent["decode"] += time.perf_counter() - t0
            if b is None:
                return
            yield b

    trainer.model.train()
    trainer.tx.init(trainer.model)
    sync(dev)
    t_step = time.perf_counter()
    for batch, bags, labels, _ in trainer._staged(timed(trainer.dm.train_batches(0))):
        t0 = time.perf_counter()
        trainer.train_step(bags, labels)
        sync(dev)
        spent["device"] += time.perf_counter() - t0
    wall = time.perf_counter() - t_step
    del bags, labels
    # the last batch's copy, pageable (in the loop) and pinned on a side stream (the thread)
    t0 = time.perf_counter()
    trainer._batch_tensors(batch)
    sync(dev)
    pageable = time.perf_counter() - t0
    stream = torch.cuda.Stream(dev)
    t0 = time.perf_counter()
    to_device(trainer._batch_arrays(batch)[:2], dev, stream)
    stream.synchronize()
    pinned = time.perf_counter() - t0
    acc = trainer.tx.grad_accum_steps
    parts = spent["decode"] + acc * pinned + spent["device"]
    log(f"[{tag}] {label} ({acc} micro-steps of {tuple(batch.bags.shape)} "
        f"float32 tiles) through the Trainer's prefetch thread: {wall * 1e3:.1f} ms; "
        f"decode {spent['decode'] * 1e3:.1f} ms on the thread + pinned side-stream copy "
        f"{pinned * 1e3:.1f} a batch (pageable {pageable * 1e3:.1f}) + device (forward, "
        f"backward, update) {spent['device'] * 1e3:.1f} ms = {parts * 1e3:.1f} ms, "
        f"{(parts - wall) * 1e3:.1f} ms ({(parts - wall) / parts:.1%}) hidden")


def phase_extract(rng, results: dict, dev, variables) -> None:
    """From tile files to feature bags and image bags, on the card, through
    the port's entry points: ``cli.extract_features`` of a cohort of 8
    slides of 450-550 224x224 JPEG tiles with a seeded RetCCL ResNet50 .pth
    at the CLI's batch of 100, on the float32, ``--quantize int8`` and
    ``--quantize int8_fused --bagstore`` routes (exact B7/B8 launch counts:
    4 and 3 a batch, none on float32), and ``--augment 1`` of one slide;
    int8 and int8_fused features identical, int8 against float32 at cosine
    > 0.999, the .h5 files read back by ``FeatureBagDataset`` and the bag
    store equal to them byte for byte; B7/B8 at 100 tiles (a full batch and
    the ragged last one) held code for code to the plain path and timed
    beside their bound. Then ``cli.train`` of TransMIL_retccl_norm_rest.yaml
    as written but for paths and 1 epoch, (A) on the extracted .h5 cohort and
    (B) with ``Data.variant: images`` on JPEG tile folders (bags of 5 x
    1,000 224x224 tiles through the frozen ResNet50), exact K1/K2 counts;
    B's logits on one batch against the all-plain route (float32), its
    backbone's weights against the coupled-L2 rule (ROADMAP C11), and its
    optimizer step as the Trainer runs it (the prefetch thread decoding and
    copying the next batch, pinned, on a side stream, while the device steps
    on this one), split into decode, copy and device time and what the
    thread hid of them."""
    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.cli import extract_features as cli_extract
    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.data import feature_extractor as fe
    from transmil_deepgraft_tpu_torch.data.bagstore import BagStore
    from transmil_deepgraft_tpu_torch.data.feature_bags import FeatureBagDataset
    from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
    from transmil_deepgraft_tpu_torch.data.tiles import parse_coords
    from transmil_deepgraft_tpu_torch.models import resnet_int8 as qr
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.utils import h5
    from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pool = jpeg_pool(rng)
        counts = {f"slide_{i}": int(rng.integers(EXTRACT_TILES[0], EXTRACT_TILES[1] + 1))
                  for i in range(EXTRACT_SLIDES)}
        nbytes = write_slides(root / "cohort", rng, pool, {**counts, "aug_slide": AUG_TILES})
        names = list(counts)
        (root / "labels.json").write_text(json.dumps({"test": [[n, i % 2] for i, n in
                                                                enumerate(names)]}))
        (root / "aug.json").write_text(json.dumps({"test": [["aug_slide", 0]]}))
        torch.save(torchvision_state_dict(variables), root / "retccl.pth")
        n_tiles = sum(counts.values())
        batches = sum(-(-n // EXTRACT_BATCH) for n in counts.values())
        log(f"[extract] cohort: {EXTRACT_SLIDES} slides, {n_tiles} tiles ({batches} batches of "
            f"{EXTRACT_BATCH}), {nbytes / 1e6:.1f} MB of JPEG, written in "
            f"{time.perf_counter() - t_phase:.2f} s")

        # the three routes, each timed: its streaming part, and decode within it
        clock = {"decode": 0.0, "stream": 0.0}
        decode_batch, stream = fe.decode_batch, fe.extract_slide_features

        def timed(fn, key):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                sync(dev)
                clock[key] += time.perf_counter() - t0
                return out
            return run

        fe.decode_batch, fe.extract_slide_features = (timed(decode_batch, "decode"),
                                                      timed(stream, "stream"))
        argv = ["--data_dir", str(root / "cohort"), "--label_file", str(root / "labels.json"),
                "--backbone", "retccl", "--ckpt", str(root / "retccl.pth"),
                "--batch_size", str(EXTRACT_BATCH), "--device", dev.type]
        routes = {"float32": [], "int8": ["--quantize", "int8"],
                  "int8_fused": ["--quantize", "int8_fused", "--bagstore"]}
        feats: dict = {}
        try:
            for route, extra in routes.items():
                clock.update(decode=0.0, stream=0.0)
                t0 = time.perf_counter()
                _, launches = all_launch_counts(lambda: quiet(
                    cli_extract.main, [*argv, *extra, "--out_dir", str(root / route)],
                    tag="extract"))
                wall = time.perf_counter() - t0
                int8 = route != "float32"
                log(f"[extract] {route}: {wall:.2f} s in all (model, calibration, writes), "
                    f"streaming {clock['stream']:.2f} s = {n_tiles / clock['stream']:.1f} tiles/s, "
                    f"decode {clock['decode']:.2f} s on the decode thread "
                    f"({clock['decode'] / clock['stream']:.1%} of the streaming time); "
                    f"launches {launches}")
                expect_launches_exactly(f"extract {route}", launches,
                                        qstage_run=4 * batches if int8 else 0,
                                        qentry_run=3 * batches if int8 else 0,
                                        qstem_run=batches if int8 else 0)
                feats[route] = {n: h5.read(root / route / f"{n}.h5") for n in names}
            clock.update(decode=0.0, stream=0.0)
            _, launches = all_launch_counts(lambda: quiet(cli_extract.main, [
                *argv, "--label_file", str(root / "aug.json"), "--augment", "1",
                "--out_dir", str(root / "aug")], tag="extract"))
            expect_launches_exactly("extract --augment", launches)
            log(f"[extract] --augment 1 on one slide of {AUG_TILES} tiles: {AUG_TILES} plain + "
                f"{AUG_TILES} augmented tiles streamed in {clock['stream']:.2f} s, decode and "
                f"augmentation {clock['decode']:.2f} s")
        finally:
            fe.decode_batch, fe.extract_slide_features = decode_batch, stream
        aug = [h5.read(root / "aug" / f"aug_slide{s}.h5")["features"] for s in ("", "_aug0")]
        if not (aug[0].shape == aug[1].shape == (AUG_TILES, 2048) and np.isfinite(aug).all()
                and np.abs(aug[0] - aug[1]).max() > 1e-3):
            raise AssertionError("the augmented copy is not a distinct finite bag")

        # the outputs: shapes, coords, int8 == int8_fused, int8 ~ float32
        cos_min = 1.0
        for n in names:
            want_coords = np.array([parse_coords(f.name) for f in sorted(
                (root / "cohort" / "BLOCKS" / n).iterdir())], np.int32)  # in file-name order
            for route in routes:
                f = feats[route][n]
                if (f["features"].shape != (counts[n], 2048) or f["features"].dtype != np.float32
                        or not np.isfinite(f["features"]).all()
                        or f["coords"].tobytes() != want_coords.tobytes()):
                    raise AssertionError(f"{route} {n}: bad features or coords")
            int8, fused = feats["int8"][n]["features"], feats["int8_fused"][n]["features"]
            if int8.tobytes() != fused.tobytes():
                raise AssertionError(f"{n}: int8 and int8_fused features differ")
            ref = feats["float32"][n]["features"]
            cos = (int8 * ref).sum(-1) / (np.linalg.norm(int8, axis=-1)
                                          * np.linalg.norm(ref, axis=-1))
            cos_min = min(cos_min, float(cos.min()))
        log(f"[extract] int8 == int8_fused on all {n_tiles} tiles; int8 vs float32 cosine min "
            f"{cos_min:.6f} (bar 0.999)")
        if not cos_min > 0.999:
            raise AssertionError(f"int8 features too far from float32: cosine {cos_min}")
        bag_labels = {"test": [[f"{n}.h5", 0] for n in names]}
        (root / "bags.json").write_text(json.dumps(bag_labels))
        bags = FeatureBagDataset(root / "int8_fused", root / "bags.json", "test", 2)
        t0 = time.perf_counter()
        for n in names:
            h5.read(root / "int8_fused" / f"{n}.h5")
        h5_ms = (time.perf_counter() - t0) * 1e3
        store = BagStore(root / "int8_fused" / "cohort.bags")
        n_stored = store.n_slides
        t0 = time.perf_counter()
        for i in range(n_stored):
            store.read_bag(i)
        store_ms = (time.perf_counter() - t0) * 1e3
        try:
            for i, n in enumerate(names):  # the store packs the .h5 files in name order
                want = feats["int8_fused"][n]
                if (bags._load(i)[0].tobytes() != want["features"].tobytes()
                        or store.read_bag(i).tobytes() != want["features"].tobytes()
                        or store.read_coords(i).tobytes() != want["coords"].tobytes()):
                    raise AssertionError(f"{n}: the dataset or the bag store differs from the .h5")
        finally:
            store.close()
        log(f"[extract] FeatureBagDataset and the bag store ({n_stored} slides) read the "
            f".h5 files back byte for byte; reading the {n_tiles} x 2048 features (files just "
            f"written, page cache warm): utils/h5 {h5_ms:.1f} ms, the bag store {store_ms:.1f} ms")

        # B7/B8 at the extraction batch: a full batch and the ragged last one
        ds = JPGMILDataset(root / "cohort", root / "labels.json", "test", 2)
        q = qr.build_qresnet50(variables, fe._calibration_tiles(ds, EXTRACT_BATCH), device=dev)
        prep = qr.prepare_qresnet50_fused(q)
        held = next(i for i, n in enumerate(names) if counts[n] % EXTRACT_BATCH)  # a ragged slide
        tiles = ds.tiles_of(held)
        last = len(tiles) - len(tiles) % EXTRACT_BATCH
        mean = torch.from_numpy(fe.IMAGENET_MEAN).to(dev)
        std = torch.from_numpy(fe.IMAGENET_STD).to(dev)
        for label, paths, rows in (("batch 1", tiles[:EXTRACT_BATCH], slice(0, EXTRACT_BATCH)),
                                   ("the ragged last batch", tiles[last:], slice(last, None))):
            # decoded as the CLI decodes it: raw uint8 normalized on the card
            # with the native loader, normalized on the host with PIL
            batch = torch.from_numpy(fe.decode_batch(paths, TILE, fe.nt.available(), None))
            if batch.dtype == torch.uint8:
                batch = (batch.to(dev).float() / 255.0 - mean) / std
            x = torch.zeros((EXTRACT_BATCH, TILE, TILE, 3), device=dev)
            x[:len(paths)] = batch.to(dev)
            with torch.inference_mode():
                stage1 = qr._plain_blocks(qk.stem_reference(x, q), q.blocks[0:3], [1] * 3)
                plain = qr._pool(q, qr._later_stages(q, stage1, (0,) * 6))
                for route, run in (("apply_qresnet50", lambda: qr.apply_qresnet50(q, x)), (
                        "apply_qresnet50_fused", lambda: qr.apply_qresnet50_fused(
                            prep, x, t_cfg=fe.FUSED_T_CFG))):
                    qk.reset_launch_counts()
                    got = run()
                    sync(dev)
                    if dict(qk.LAUNCHES) != {"qstage_run": 4, "qentry_run": 3, "qstem_run": 1}:
                        raise AssertionError(f"{route}: launches {qk.LAUNCHES}")
                    if not torch.equal(got, plain):
                        raise AssertionError(f"{route} at {EXTRACT_BATCH} tiles ({label}) "
                                             "differs from the plain int8 path")
            cli_rows = feats["int8"][names[held]]["features"][rows]
            diff = float(np.abs(plain[:len(paths)].cpu().numpy() - cli_rows).max())
            log(f"[extract] {label} of {names[held]} ({len(paths)} tiles, padded to "
                f"{EXTRACT_BATCH}): "
                f"both int8 routes == the plain path, 4 + 3 launches each; max |dfeature| vs "
                f"the CLI's int8 features (its own calibration of the same tiles) {diff:.3e}")
        with torch.inference_mode():
            x = qr._stem_q(q, torch.from_numpy(normalize_tiles(np.stack(
                [fe._load_tile(p, TILE) for p in tiles[:EXTRACT_BATCH]]))).to(dev))
            totals = {k: [0.0, 0.0, 0.0] for k in ("qstage_run", "qentry_run")}
            for (name, kernel, run, plain), (_, blocks, entry) in zip(segment_runs(q),
                                                                       segments(q)):
                ms = cuda_ms(lambda: run(x))
                plain_ms = cuda_ms(lambda: plain(x), reps=3, warmup=1)
                ops, nb = segment_costs(blocks, entry, tuple(x.shape))
                bound = max(ops / H100_INT8_OPS, nb / H100_BYTES_PER_S) * 1e3
                for i, v in enumerate((ms, plain_ms, bound)):
                    totals[kernel][i] += v
                x = run(x)
        for kernel, (ms, plain_ms, bound) in totals.items():
            log(f"[extract] {kernel}, all its launches of one {EXTRACT_BATCH}-tile batch: "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms")

        # cli.train A: the extracted cohort (the .h5 files of the int8_fused route)
        bag_dir = root / "int8_fused"
        split_names = iter(names)
        labels = {split: [[f"{next(split_names)}.h5", i % 2] for i in range(k)]
                  for split, k in EXTRACT_SPLITS.items()}
        (root / "train_labels.json").write_text(json.dumps(labels))
        (root / "patients.json").write_text(json.dumps({n: n for n in names}))
        data = {"data_dir": str(bag_dir), "label_file": str(root / "train_labels.json"),
                "patient_dict": str(root / "patients.json")}
        config_a = heads_config(root, "run_a", EXTRACT_CONFIG, data, epochs=1)

        def train(config: Path, log_dir: Path):
            return quiet(cli.main, ["--config", str(config), "--log_dir", str(log_dir),
                                    "--device", dev.type], tag="extract")

        t0 = time.perf_counter()
        summary, launches = all_launch_counts(lambda: train(config_a, root / "run_a" / "log"))
        evals = EXTRACT_SPLITS["val"]  # the test slide runs the top-k export's return_attn forward
        log(f"[extract] cli.train A ({EXTRACT_CONFIG}, the extracted .h5 cohort "
            f"{EXTRACT_SPLITS}, 1 epoch): {time.perf_counter() - t0:.2f} s, test AUC "
            f"{summary['test_auc']:.4f}, launches {launches}")
        expect_launches_exactly("cli.train A", launches, translayer_k1=2 * evals,
                                translayer_k2=2 * evals)

        # cli.train B: Data.variant images on JPEG tile folders
        img_counts = {f"{split}_{i}": IMAGE_TILES for split, k in IMAGE_SPLITS.items()
                      for i in range(k)}
        write_slides(root / "images", rng, pool, img_counts)
        labels = {split: [[f"{split}_{i}", i % 2] for i in range(k)]
                  for split, k in IMAGE_SPLITS.items()}
        (root / "image_labels.json").write_text(json.dumps(labels))
        data = {"data_dir": str(root / "images"), "label_file": str(root / "image_labels.json"),
                "variant": "images"}
        model = {"backbone_weights": str(root / "retccl.pth")}
        config_b = heads_config(root, "run_b", EXTRACT_CONFIG, data, model, epochs=1)
        t0 = time.perf_counter()
        summary, launches = all_launch_counts(lambda: train(config_b, root / "run_b" / "log"))
        evals = IMAGE_SPLITS["val"] + IMAGE_SPLITS["test"]
        row = metric_rows(root / "run_b" / "log")[0]
        log(f"[extract] cli.train B (variant images, {IMAGE_SPLITS} slides of {IMAGE_TILES} "
            f"tiles, bags of 1,000 through the frozen ResNet50, 1 epoch): "
            f"{time.perf_counter() - t0:.2f} s, epoch {row['epoch_time_s']:.2f} s, loss "
            f"{row['loss']:.4f}, test AUC {summary['test_auc']:.4f}, launches {launches}")
        expect_launches_exactly("cli.train B", launches, translayer_k1=2 * evals,
                                translayer_k2=2 * evals)

        # B's frozen backbone after its one optimizer step: coupled L2 on zero
        # gradients moved each conv kernel by -lr * wd * w (RAdam's first,
        # unrectified step; no lookahead sync), its BatchNorm not at all
        cfg = finalize_config(read_yaml(config_b), config_path=config_b)
        lr, wd = float(cfg.Optimizer.lr), float(cfg.Optimizer.weight_decay)
        after = read_checkpoint(root / "run_b" / "log" / "checkpoints" / "last.ckpt")["model"]
        start = torch.load(root / "retccl.pth")
        w0, w1 = start["layer3.2.conv2.weight"], after["backbone.layer3_2.conv2.weight"].cpu()
        rule = float((w1 - w0 * (1 - lr * wd)).abs().max() / w0.abs().max())
        moved = float((w1 - w0).abs().max() / w0.abs().max())
        bn_same = torch.equal(start["bn1.weight"], after["backbone.bn1.weight"].cpu())
        log(f"[extract] B's frozen backbone after one step: conv kernel moved by {moved:.3e} of "
            f"its largest weight, {rule:.3e} off w * (1 - lr * wd) = w * {1 - lr * wd}; "
            f"BatchNorm unchanged: {bn_same} (ROADMAP C11)")
        if not (moved > 0.5 * lr * wd and rule < 1e-6 and bn_same):
            raise AssertionError("the frozen backbone did not follow JAX's coupled-L2 rule")

        # B's logits on one batch, kernel route vs the all-plain route (float32)
        cfg.General.precision = 32
        probe = cli.build(cfg, str(root / "run_b" / "probe"), dev.type)
        probe.model.load_state_dict(after)
        batch = next(probe.dm.eval_batches("val", batch_size=1))
        bags = torch.from_numpy(batch.bags).to(dev)
        with torch.inference_mode():
            probe.model.eval()
            _, launches = all_launch_counts(lambda: probe.forward(bags))
            fused = probe.forward(bags)
            probe.model.head.fused_inference = False
            plain = probe.forward(bags)
        err = float((fused - plain).abs().max())
        log(f"[extract] B's logits on one val bag ({batch.bags.shape[1]} tiles), K1/K2 route vs "
            f"all plain (float32): max|dlogit| {err:.3e} (tol {TOL}), launches {launches}")
        expect_launches_exactly("B logits", launches, translayer_k1=2, translayer_k2=2)
        if not err <= TOL:
            raise AssertionError("the images model's kernel route disagrees with the plain route")

        # B's optimizer step (grad_acc 2 micro-steps of 5 x 1,000 tiles) as the
        # Trainer runs it
        prefetched_step_parts(probe, "extract", "B's optimizer step")
    log(f"[env] extract phase {time.perf_counter() - t_phase:.1f} s")


def backbone_module(name: str, seed: int):
    """A tile backbone of ``models/backbones`` ('resnet34': the bare
    ResNet34) from ``torch.manual_seed(seed)`` on the CPU, its BatchNorm
    running statistics drawn too, in eval mode."""
    import torch

    from transmil_deepgraft_tpu_torch.models.backbones import create_backbone
    from transmil_deepgraft_tpu_torch.models.resnet import resnet34

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = resnet34() if name == "resnet34" else create_backbone(name)[0]
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    return module.eval()


def dino_state_dict(vit) -> dict:
    """The port's ViT -> a state dict in DINO/timm's names (the inverse of
    ``utils/torch_weights.convert_vit_state_dict``)."""
    sub = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    out = {}
    for key, value in vit.state_dict().items():
        if key.startswith("block"):
            block, mod, leaf = key.split(".")
            key = f"blocks.{block[5:]}.{sub.get(mod, mod)}.{leaf}"
        elif key.startswith("patch_embed."):
            key = "patch_embed.proj." + key.split(".", 1)[1]
        out[key] = value
    return out


def torchvision_efficientnet_state_dict(net) -> dict:
    """The port's EfficientNet-B0 -> a state dict in torchvision's names
    (the inverse of ``utils/torch_weights.convert_efficientnet_state_dict``)."""
    from transmil_deepgraft_tpu_torch.models.efficientnet import B0_STAGES

    names = {"stem_conv": "features.0.0", "stem_bn": "features.0.1",
             "head_conv": "features.8.0", "head_bn": "features.8.1"}
    for si, (expand, _, _, _, repeats) in enumerate(B0_STAGES):
        for b in range(repeats):
            t, f = f"features.{si + 1}.{b}.block", f"stage{si}_block{b}"
            i = 0
            if expand != 1:
                names.update({f"{f}.expand_conv": f"{t}.0.0", f"{f}.expand_bn": f"{t}.0.1"})
                i = 1
            names.update({f"{f}.dw_conv": f"{t}.{i}.0", f"{f}.dw_bn": f"{t}.{i}.1",
                          f"{f}.se.reduce": f"{t}.{i + 1}.fc1",
                          f"{f}.se.expand": f"{t}.{i + 1}.fc2",
                          f"{f}.project_conv": f"{t}.{i + 2}.0",
                          f"{f}.project_bn": f"{t}.{i + 2}.1"})
    out = {}
    for key, value in net.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        out[f"{names[module]}.{leaf}"] = value
    return out


def slide_auroc(result_csv: Path) -> float:
    """The AUROC of a ``*_RESULT_SLIDE.csv``'s aggregated slide scores."""
    import csv

    import numpy as np

    from transmil_deepgraft_tpu_torch.train.metrics import auroc

    with open(result_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    classes = [k for k in rows[0] if k not in ("", "SLIDE", "yTrue")]
    probs = np.array([[float(r[c]) for c in classes] for r in rows])
    return auroc(probs, np.array([int(r["yTrue"]) for r in rows]), len(classes))


def phase_backbones(rng, results: dict, dev) -> None:
    """The other tile backbones, on the card, through the port's entry
    points, from seeded random weights:

    (a) ViT-B/16 (dino, at 224 px and at 256 px, where the position grid is
    resized on the card), EfficientNet-B0 behind its 512-d GELU projection,
    InceptionV3 at 299 px, ResNet34 and the projected ResNet18, each timed on
    a batch of 100 tiles (CUDA events) beside its FLOP-rate bound, 4 of the
    tiles held to the same module on the CPU in float64;
    (b) ``cli.extract_features --backbone dino`` and ``efficientnet`` from
    seeded .pth files in the reference's names on two slides of 450-550 JPEG
    tiles: the .h5 features read back with ``utils/h5`` and held to the
    in-process backbone on the CLI's first batch within 1e-5, tiles/s;
    (c) ``cli.train`` of ``TransMIL_dino.yaml`` with ``Data.variant: images``
    (as written but for paths and 1 epoch; 6/2/2 slides of 200 tiles, the
    DINO .pth as ``Model.backbone_weights``, the head rebuilt at 768-d):
    exact K1/K2 counts, 2 each an eval forward; the eval logits against the
    all-plain route within the bf16 bar; the optimizer step by part;
    (d) the classic per-tile route, ``Data.variant: tiles``, for vit,
    resnet18, efficientnet and inception with the fields of their configs:
    each config as written raises JAX's KeyError (ROADMAP C13); cut to paths,
    1 epoch, ``Model.name`` a bag head, a train batch of 64 tiles, 6/2/2
    slides of 64 tiles (299 px for inception): tile-level slide and patient
    AUROC, ms a step, tiles/s; the BatchNorm backbones' running statistics
    moved (the ViT has none); the first step's loss at 8 tiles held to the
    CPU in float64 (vit, resnet18)."""
    import copy
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    from transmil_deepgraft_tpu_torch.cli import extract_features as cli_extract
    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.data import feature_extractor as fe
    from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
    from transmil_deepgraft_tpu_torch.models.backbones import (
        create_backbone, load_backbone_variables)
    from transmil_deepgraft_tpu_torch.models.vit import _interpolate_pos_embed
    from transmil_deepgraft_tpu_torch.utils import h5
    from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
    from transmil_deepgraft_tpu_torch.utils.torch_weights import convert_backbone_state_dict

    t_phase = time.perf_counter()
    device_arg = [] if dev.type == "cuda" else ["--device", dev.type]  # the CLIs' default: cuda
    # (a) each backbone at extraction's batch of 100 tiles
    modules: dict = {}
    for name, size in BACKBONES:
        if name not in modules:
            modules[name] = backbone_module(name, seed=len(modules)).to(dev)
        net = modules[name]
        x = torch.from_numpy(rng.standard_normal((EXTRACT_BATCH, size, size, 3),
                                                 dtype=np.float32)).to(dev)
        with torch.inference_mode():
            with FlopCounterMode(display=False) as counter:
                out = net(x)
            flops = counter.get_total_flops()
            ms = cuda_ms(lambda: net(x), reps=5)
        nbytes = 4 * (x.numel() + out.numel() + sum(p.numel() for p in net.parameters()))
        bound_ms, by = bound(flops, nbytes)
        ref = copy.deepcopy(net).cpu().double()
        with torch.no_grad():
            want = ref(x[:HELD_TILES].cpu().double())
        del ref
        err = float((out[:HELD_TILES].cpu().double() - want).abs().max()
                    / want.abs().max().clamp_min(1.0))
        log(f"[backbones] {name} at {size} px, {EXTRACT_BATCH} tiles -> {tuple(out.shape)}: "
            f"{ms:.2f} ms = {EXTRACT_BATCH / ms * 1e3:.0f} tiles/s; {flops / EXTRACT_BATCH / 1e9:.2f} "
            f"GFLOP a tile, bound {bound_ms:.2f} ms by {by} (float32 peak, TF32 off) = "
            f"{EXTRACT_BATCH / bound_ms * 1e3:.0f} tiles/s, {bound_ms / ms:.1%} of it; "
            f"{HELD_TILES} tiles vs float64 on the CPU: max |d| {err:.2e} of the largest "
            f"(tol {HELD_TOL})")
        if not (np.isfinite(out.cpu().numpy()).all() and err <= HELD_TOL):
            raise AssertionError(f"{name} at {size} px: the card disagrees with float64")
        if name == "dino" and size != 224:  # the bicubic resize ran on the card
            grid = size // 16
            with torch.no_grad():
                pos = net.pos_embed[:, 1:]
                card = _interpolate_pos_embed(pos, grid, grid)
                cpu = _interpolate_pos_embed(pos.cpu().double(), grid, grid)
            err = float((card.cpu().double() - cpu).abs().max())
            log(f"[backbones] position grid 14x14 -> {grid}x{grid} (antialiased bicubic) on the "
                f"card vs float64 on the CPU: max |d| {err:.2e} (tol 1e-5)")
            if not err <= 1e-5:
                raise AssertionError("the position-embedding resize disagrees on the card")
        del x, out
    log(f"[env] backbones (a) {time.perf_counter() - t_phase:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pool = jpeg_pool(rng)
        torch.save(dino_state_dict(modules["dino"]), root / "dino.pth")
        torch.save(torchvision_efficientnet_state_dict(modules["efficientnet"].backbone),
                   root / "efficientnet.pth")
        del modules
        torch.cuda.empty_cache()

        # (b) extraction from the .pth files
        counts = {f"slide_{i}": int(rng.integers(EXTRACT_TILES[0], EXTRACT_TILES[1] + 1))
                  for i in range(2)}
        write_slides(root / "cohort", rng, pool, counts)
        names = list(counts)
        (root / "labels.json").write_text(json.dumps({"test": [[n, i % 2] for i, n in
                                                                enumerate(names)]}))
        ds = JPGMILDataset(root / "cohort", root / "labels.json", "test", 2)
        first = fe.decode_batch(ds.tiles_of(0)[:EXTRACT_BATCH], TILE, fe.nt.available(), None)
        first = torch.from_numpy(first).to(dev)
        if first.dtype == torch.uint8:  # the native loader's: normalized on the card
            first = ((first.float() / 255.0 - torch.from_numpy(fe.IMAGENET_MEAN).to(dev))
                     / torch.from_numpy(fe.IMAGENET_STD).to(dev))
        stream, clock = fe.extract_slide_features, {"stream": 0.0}

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = stream(*args, **kw)
            sync(dev)
            clock["stream"] += time.perf_counter() - t0
            return out

        fe.extract_slide_features = timed
        try:
            for name in BACKBONE_EXTRACT:
                clock["stream"] = 0.0
                t0 = time.perf_counter()
                _, launches = all_launch_counts(lambda: quiet(cli_extract.main, [
                    "--data_dir", str(root / "cohort"), "--label_file", str(root / "labels.json"),
                    "--backbone", name, "--ckpt", str(root / f"{name}.pth"), "--batch_size",
                    str(EXTRACT_BATCH), *device_arg, "--out_dir", str(root / name)],
                    tag="backbones"))
                wall = time.perf_counter() - t0
                expect_launches_exactly(f"extract {name}", launches)
                with torch.random.fork_rng(devices=[]):  # the CLI's module: key(0), the .pth
                    torch.manual_seed(0)
                    net, dim = create_backbone(name)
                load_backbone_variables(net, convert_backbone_state_dict(
                    torch.load(root / f"{name}.pth"), name))
                with torch.inference_mode():
                    want = net.to(dev).eval()(first).cpu().numpy()
                del net
                got = [h5.read(root / name / f"{n}.h5")["features"] for n in names]
                err = float(np.abs(got[0][:EXTRACT_BATCH] - want).max() / np.abs(want).max())
                log(f"[backbones] cli.extract_features --backbone {name} --ckpt {name}.pth: "
                    f"{sum(counts.values())} tiles in {wall:.2f} s, streaming "
                    f"{clock['stream']:.2f} s = {sum(counts.values()) / clock['stream']:.1f} "
                    f"tiles/s; .h5 vs the in-process backbone on the first batch: max |d| "
                    f"{err:.2e} of the largest (tol 1e-5); launches {launches}")
                if not (all(g.shape == (counts[n], dim) and np.isfinite(g).all()
                            for g, n in zip(got, names)) and err <= 1e-5):
                    raise AssertionError(f"extract {name}: bad features")
        finally:
            fe.extract_slide_features = stream
        del first
        log(f"[env] backbones (a)+(b) {time.perf_counter() - t_phase:.1f} s")

        def train(config: Path, log_dir: Path):
            return quiet(cli.main, ["--config", str(config), "--log_dir", str(log_dir),
                                    *device_arg], tag="backbones")

        # (c) the images route over the ViT
        img_counts = {f"{split}_{i}": IMAGE_TILES for split, k in BACKBONE_SPLITS.items()
                      for i in range(k)}
        write_slides(root / "images", rng, pool, img_counts)
        labels = {split: [[f"{split}_{i}", i % 2] for i in range(k)]
                  for split, k in BACKBONE_SPLITS.items()}
        (root / "image_labels.json").write_text(json.dumps(labels))
        data = {"data_dir": str(root / "images"), "label_file": str(root / "image_labels.json"),
                "variant": "images"}
        config = heads_config(root, "dino", DINO_CONFIG, data,
                              {"backbone_weights": str(root / "dino.pth")}, epochs=1)
        t0 = time.perf_counter()
        summary, launches = all_launch_counts(lambda: train(config, root / "dino" / "log"))
        evals = BACKBONE_SPLITS["val"] + BACKBONE_SPLITS["test"]
        row = metric_rows(root / "dino" / "log")[0]
        log(f"[backbones] cli.train {DINO_CONFIG} (variant images, {BACKBONE_SPLITS} slides of "
            f"{IMAGE_TILES} tiles through the frozen ViT-B/16, 1 epoch): "
            f"{time.perf_counter() - t0:.2f} s, epoch {row['epoch_time_s']:.2f} s, loss "
            f"{row['loss']:.4f}, test AUC {summary['test_auc']:.4f}, launches {launches}")
        expect_launches_exactly("images over the ViT", launches, translayer_k1=2 * evals,
                                translayer_k2=2 * evals)
        probe = cli.build(finalize_config(read_yaml(config), config_path=config),
                          str(root / "dino" / "probe"), dev.type)
        if probe.model.head._fc1[0].in_features != 768:
            raise AssertionError("the head was not rebuilt for the ViT's 768-d features")
        probe.model.load_state_dict(
            read_checkpoint(root / "dino" / "log" / "checkpoints" / "last.ckpt")["model"])
        bags = [torch.from_numpy(b.bags).to(dev) for mode in ("val", "test")
                for b in probe.dm.eval_batches(mode, batch_size=1)]
        probe.model.eval()
        with torch.inference_mode():
            fused, launches = all_launch_counts(lambda: [probe.forward(b) for b in bags])
            probe.model.head.fused_inference = False
            plain = [probe.forward(b) for b in bags]
            probe.model.head.fused_inference = True
        err = max(float((f - p).float().abs().max()) for f, p in zip(fused, plain))
        log(f"[backbones] the images model's eval logits ({len(bags)} bags of {IMAGE_TILES} "
            f"tiles, bf16 TransMIL as written), K1/K2 route vs all plain: max |dlogit| "
            f"{err:.3e} (bar {BF16_BAR}), launches {launches}")
        expect_launches_exactly("images logits", launches, translayer_k1=2 * len(bags),
                                translayer_k2=2 * len(bags))
        if not err <= BF16_BAR:
            raise AssertionError("the images model's kernel route disagrees with the plain route")
        del bags, fused, plain
        prefetched_step_parts(probe, "backbones", "the images route's optimizer step")
        del probe
        torch.cuda.empty_cache()
        log(f"[env] backbones (a)-(c) {time.perf_counter() - t_phase:.1f} s")

        # (d) the classic per-tile route
        pools = {TILE: pool, 299: jpeg_pool(rng, n=256, size=299)}
        for net_name, config in CLASSIC_CONFIGS.items():
            size = 299 if net_name == "inception" else TILE
            folder = root / f"tiles_{size}"
            if not folder.exists():
                write_slides(folder, rng, pools[size], {n: CLASSIC_TILES for n in img_counts})
            paths = {"data_dir": str(folder), "label_file": str(root / "image_labels.json")}
            written = heads_config(root, f"{net_name}_as_written", config, paths, epochs=1)
            try:
                cli.build(finalize_config(read_yaml(written), config_path=written),
                          str(root / f"{net_name}_as_written" / "log"), dev.type)
            except KeyError as e:
                if "C13" not in str(e):
                    raise
            else:
                raise AssertionError(f"{config} as written did not raise JAX's KeyError (C13)")
            data = {**paths, "variant": "tiles",
                    "train_dataloader": {"batch_size": CLASSIC_TILES, "num_workers": 4},
                    **({"tile_size": 299} if size == 299 else {})}
            config_t = heads_config(root, f"{net_name}_tiles", config, data,
                                    {"name": CLASSIC_HEAD}, epochs=1)
            cfg = finalize_config(read_yaml(config_t), config_path=config_t)
            probe = cli.build(cfg, str(root / f"{net_name}_tiles" / "probe"), dev.type)
            init = {k: v.detach().clone() for k, v in probe.model.state_dict().items()}
            acc = probe.tx.grad_accum_steps
            # the step's batches: 64 val tiles each, as train's but without the
            # host's stain augmentation (~90 ms a tile), which the epoch below pays
            batches = list(itertools.islice(probe.dm.eval_batches("val", CLASSIC_TILES), acc))
            held = ""
            if net_name in ("vit", "resnet18"):  # the first step's loss, card vs float64
                bags, labels = probe._batch_tensors(batches[0])
                bags, labels = bags[:CLASSIC_HELD], labels[:CLASSIC_HELD]
                cpu = copy.deepcopy(probe.model).cpu().double().train()
                with torch.no_grad():
                    want = float(probe.loss_fn(cpu(bags.cpu().double()), F.one_hot(
                        labels.cpu(), 2).double()))
                    got = float(probe.loss(bags, labels)[0])
                del cpu
                held = (f"; first step's loss at {CLASSIC_HELD} tiles {got:.6f} vs float64 on "
                        f"the CPU {want:.6f} (tol 1e-3)")
                if not abs(got - want) <= 1e-3:
                    raise AssertionError(f"{net_name}: the card's loss disagrees with float64")
            ms, ms_min = head_step_ms(probe, batches)
            del probe, batches
            t0 = time.perf_counter()
            summary, launches = all_launch_counts(
                lambda: train(config_t, root / f"{net_name}_tiles" / "log"))
            wall = time.perf_counter() - t0
            expect_launches_exactly(f"tiles {net_name}", launches)
            log_dir = root / f"{net_name}_tiles" / "log"
            after = read_checkpoint(log_dir / "checkpoints" / "last.ckpt")["model"]
            stats = [k for k in after if k.endswith("running_mean")]
            moved = sum(not torch.equal(after[k].cpu(), init[k].cpu()) for k in stats)
            row = metric_rows(log_dir)[0]
            n_train = BACKBONE_SPLITS["train"] * CLASSIC_TILES
            log(f"[backbones] cli.train {config} (variant tiles, Model.name {CLASSIC_HEAD}, "
                f"{BACKBONE_SPLITS} slides of {CLASSIC_TILES} {size}-px tiles, batch "
                f"{CLASSIC_TILES}, grad_acc {acc}, 1 epoch): {wall:.2f} s, epoch "
                f"{row['epoch_time_s']:.2f} s ({n_train} augmented train tiles, "
                f"{n_train / row['epoch_time_s']:.1f} tiles/s with the evals), loss "
                f"{row['loss']:.4f}; tile-level test AUROC: "
                f"tiles {summary['test_auc']:.4f}, slides "
                f"{slide_auroc(log_dir / 'TEST_RESULT_SLIDE.csv'):.4f}, patients "
                f"{summary['test_patient_auc']:.4f}; optimizer step {ms:.1f} ms (min "
                f"{ms_min:.1f}) = {acc * CLASSIC_TILES / ms * 1e3:.0f} tiles/s; BatchNorm "
                f"running means moved: {moved} of {len(stats)}{held}; launches {launches}")
            if (net_name == "vit") != (not stats) or moved != len(stats):
                raise AssertionError(f"{net_name}: the BatchNorm statistics did not train")
            torch.cuda.empty_cache()
    log(f"[env] backbones phase {time.perf_counter() - t_phase:.1f} s")


def phase_tools(rng, results: dict, dev) -> None:
    """Pretraining, heatmaps and the analysis CLIs on the card:

    (a) ``cli.train`` of TransMIL_feat_norm_rest.yaml with ``use_pallas``,
    float32, 1 epoch, a train batch of 4, over 8/4 .npy bags and 4 test
    slides of 2,000-12,000 tiles with grid coords (.h5): the test stage's
    top-k tile CSVs, exact B5/B6 and K1/K2 counts; ``cli.visualize`` of its
    last.ckpt over the 4 test slides (their bags the reference's 10% draw,
    200-1,200 tiles): JPEGs, top-k CSVs and ``heatmap_index.json``, B5/B6 4
    a slide (the attention forward and the GradCAM forward; the backward is
    torch ops), K1/K2 none; on the whole 12,000-tile slide the attention and
    GradCAM tile scores held to the all-plain route within 1e-3 and timed:
    the attention forward, GradCAM's forward and backward, the assembly
    (heatmaps, ROI, JPEGs, CSV);
    (b) ``ImageVisualizer`` over a seeded ResNet50 + TransMIL-2048 on one
    slide of 64 tiles at 224 px, gradcam and eigencam: pixel CAMs held within
    1e-3 to the CPU's (the ResNet50 in float64, the head's plain route), the
    time;
    (c) ``cli.pretrain`` (ResNet18, 224 px, 64 JPEG tiles, batch 32, 1
    epoch): a finite loss, the checkpoint reloads; a step split into the
    two views' augmentation (host) and the update (device); ConvMixer
    (256, 8, 9, 7) on 32 tiles in eval mode, held to float64 on the CPU
    within 1e-3 of its largest logit, timed beside its float32 bound;
    (d) ``cli.sustainability`` in both modes at its default models and bags,
    watts from the card's power limit: kWh held to seconds x watts / 3.6e6,
    K1/K2 counts exact (TransMIL's eval forwards); (e) ``cli.export_metrics``
    over (a)'s log tree; (f) whether matplotlib is installed (figures and the
    regional plot need it; a heatmap JPEG does not)."""
    import copy
    import importlib.util
    import io
    import math

    import numpy as np
    import torch
    from PIL import Image

    from transmil_deepgraft_tpu_torch.cli import export_metrics as cli_export
    from transmil_deepgraft_tpu_torch.cli import pretrain as cli_pretrain
    from transmil_deepgraft_tpu_torch.cli import sustainability as cli_sus
    from transmil_deepgraft_tpu_torch.cli import train as cli
    from transmil_deepgraft_tpu_torch.cli import visualize as cli_viz
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.models.convmixer import ConvMixer
    from transmil_deepgraft_tpu_torch.models.resnet import resnet18, resnet50
    from transmil_deepgraft_tpu_torch.models.simclr import SimCLRModel
    from transmil_deepgraft_tpu_torch.train.optimizers import (
        cosine_decay_schedule, create_scheduled_adamw)
    from transmil_deepgraft_tpu_torch.train.simclr import (
        load_simclr_checkpoint, simclr_step, two_view_batch)
    from transmil_deepgraft_tpu_torch.utils import h5
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
    from transmil_deepgraft_tpu_torch.utils.export_metrics import (
        bootstrap_auroc, read_patient_results)
    from transmil_deepgraft_tpu_torch.utils.jax_params import backbone_state_dict_from_jax
    from transmil_deepgraft_tpu_torch.utils.sustainability import card_watts
    from transmil_deepgraft_tpu_torch.visualize.cam import compute_cam, normalize_cam
    from transmil_deepgraft_tpu_torch.visualize.heatmap import (
        ImageVisualizer, assemble_heatmap, attention_tile_scores, export_topk_tiles,
        gradcam_tile_scores, roi_mask, save_heatmap_jpeg)

    t_phase = time.perf_counter()
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"[tools] matplotlib on this machine: {'installed' if has_mpl else 'not installed'} "
        f"(figures and the regional plot need it; heatmap JPEGs and DFF do not)")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # (a) a cohort: small train/val bags, test slides with grid coords
        data = write_cohort(root, rng, splits=TOOLS_SPLITS, tag="tools")
        labels = json.loads(Path(data["label_file"]).read_text())
        patients = json.loads(Path(data["patient_dict"]).read_text())
        labels["test"] = []
        for i, n in enumerate(TOOLS_TEST_TILES):
            name, side = f"test_{i:03d}", math.ceil(math.sqrt(n))
            cells = rng.permutation(side * side)[:n]
            x = rng.standard_normal((n, 2048), dtype=np.float32)
            x[:, :64] += 0.25 * (i % 2)
            h5.write(root / "data" / "FEATURES_RETCCL_2048" / f"{name}.h5",
                     {"features": x, "coords": np.stack([cells % side, cells // side], 1)})
            labels["test"].append([f"FEATURES_RETCCL_2048/{name}.h5", i % 2])
            patients[name] = f"test_patient_{i:03d}"
        Path(data["label_file"]).write_text(json.dumps(labels))
        Path(data["patient_dict"]).write_text(json.dumps(patients))
        config = cli_config(root, "tools", {**data, "train_dataloader": {"batch_size": TOOLS_BATCH}},
                            {"precision": 32, "epochs": 1}, {"use_pallas": True})
        log_dir = root / "tools" / "log"
        micro, n_test = TOOLS_SPLITS["train"] // TOOLS_BATCH, len(TOOLS_TEST_TILES)
        t0 = time.perf_counter()
        summary, launches = all_launch_counts(lambda: quiet(cli.main, [
            "--config", str(config), "--log_dir", str(log_dir), "--device", dev.type], "tools"))
        log(f"[tools] cli.train (use_pallas, float32, 1 epoch, {TOOLS_SPLITS} + {n_test} test "
            f"slides of {TOOLS_TEST_TILES} tiles): {time.perf_counter() - t0:.2f} s, test AUC "
            f"{summary['test_auc']:.4f}, launches {launches}")
        expect_launches_exactly("[tools] cli.train", launches,
                                nystrom_landmark_attn=2 * micro + 2 * n_test,
                                nystrom_query_lm=2 * micro + 2 * n_test,
                                translayer_k1=2 * TOOLS_SPLITS["val"],
                                translayer_k2=2 * TOOLS_SPLITS["val"])
        if len(list((log_dir / "topk_tiles").glob("*_topk_tiles.csv"))) != n_test:
            raise AssertionError("the test stage wrote no top-k tiles of every test slide")

        ckpt = log_dir / "checkpoints" / "last.ckpt"
        out_dir = root / "heatmaps"
        t0 = time.perf_counter()
        index, launches = all_launch_counts(lambda: quiet(cli_viz.main, [
            "--config", str(config), "--ckpt", str(ckpt), "--log_dir", str(root / "viz_log"),
            "--out_dir", str(out_dir), "--device", dev.type], "tools"))
        viz_s = time.perf_counter() - t0
        log(f"[tools] cli.visualize over {len(index)} test slides: {viz_s:.2f} s "
            f"({viz_s / max(1, len(index)) * 1e3:.1f} ms a slide, the build and checkpoint "
            f"included), launches {launches}")
        expect_launches_exactly("[tools] cli.visualize", launches,
                                nystrom_landmark_attn=4 * n_test, nystrom_query_lm=4 * n_test)
        written = [Path(p) for r in index for p in r["paths"]]
        if not (len(index) == n_test and all(p.stat().st_size > 0 for p in written)
                and json.loads((out_dir / "heatmap_index.json").read_text()) == index
                and len(list(out_dir.glob("*_topk_tiles.csv"))) == n_test):
            raise AssertionError("cli.visualize did not write every slide's heatmaps")

        # the largest slide: the kernel route against the all-plain route, timed
        trainer = cli.build(finalize_config(read_yaml(config), config_path=config),
                            str(root / "probe"), dev.type)
        trainer.load_checkpoint(ckpt)
        model = trainer.model.eval()
        plain = create_model("TransMIL", 2, 2048, device=dev, use_pallas=False,
                             fused_inference=False).eval()
        plain.load_state_dict(model.state_dict())
        # the whole slide (the test split's bags are the reference's 10% draw)
        name = f"test_{n_test - 1:03d}"
        slide = h5.read(root / "data" / "FEATURES_RETCCL_2048" / f"{name}.h5")
        bag, coords = np.asarray(slide["features"]), np.asarray(slide["coords"])
        x = torch.from_numpy(bag[None]).to(dev)

        def attention(m):
            with torch.inference_mode():
                return attention_tile_scores(m(x, return_attn=True)[1])

        def scores(m):
            return attention(m), gradcam_tile_scores(m, x, 1)

        (att, cam), launches = all_launch_counts(lambda: scores(model))
        expect_launches_exactly("[tools] attention + GradCAM", launches, nystrom_landmark_attn=4,
                                nystrom_query_lm=4)
        (att_p, cam_p), launches = all_launch_counts(lambda: scores(plain))
        expect_launches_exactly("[tools] attention + GradCAM, all plain", launches)
        err_a, err_c = float(np.abs(att - att_p).max()), float(np.abs(cam - cam_p).max())

        def grad_forward():
            with torch.enable_grad():
                model(x.detach().requires_grad_(True))

        def assembly():
            a_map, c_map = assemble_heatmap(coords, att), assemble_heatmap(coords, cam)
            mask = roi_mask(assemble_heatmap(coords, np.ones(len(coords)), blur_sigma=0))
            save_heatmap_jpeg(a_map * mask, root / "probe" / "a.jpg")
            save_heatmap_jpeg(c_map * mask, root / "probe" / "c.jpg")
            export_topk_tiles(att, coords, name, root / "probe" / "topk.csv")

        attn_ms = cuda_ms(lambda: attention(model), reps=5, warmup=1)
        fwd_ms = cuda_ms(grad_forward, reps=5, warmup=1)
        cam_ms = cuda_ms(lambda: gradcam_tile_scores(model, x, 1), reps=5, warmup=1)
        t0 = time.perf_counter()
        assembly()
        asm_ms = (time.perf_counter() - t0) * 1e3
        log(f"[tools] {name} ({len(bag)} tiles): attention vs the all-plain route max|d| "
            f"{err_a:.3e}, GradCAM {err_c:.3e} (tol {TOL}); ms a slide: attention forward "
            f"{attn_ms:.3f}, GradCAM {cam_ms:.3f} (its forward {fwd_ms:.3f}, backward + scores "
            f"{cam_ms - fwd_ms:.3f}), assembly {asm_ms:.1f} (host); total "
            f"{attn_ms + cam_ms + asm_ms:.1f} ms")
        if not max(err_a, err_c) <= TOL:
            raise AssertionError("the heatmap scores disagree with the all-plain route")
        del trainer, model, plain, x

        # (b) ImageVisualizer: ResNet50 + TransMIL on one slide of 224 px tiles
        backbone = resnet50()
        backbone.load_state_dict(backbone_state_dict_from_jax(random_resnet50_variables(rng)))
        backbone = backbone.to(dev).eval()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(7)
            head = create_model("TransMIL", 2, 2048, device=dev, use_pallas=True).eval()
        pool = jpeg_pool(rng, n=max(IMAGE_VIZ_TILES, PRETRAIN_TILES))
        tiles_u8 = np.stack([np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
                             for b in pool[:IMAGE_VIZ_TILES]])
        tiles = normalize_tiles(tiles_u8)
        grid = np.stack(np.unravel_index(np.arange(IMAGE_VIZ_TILES), (8, 8)), 1)[:, ::-1]
        # the reference: the backbone in float64 on the CPU, the head's plain
        # route there (TransMIL's residual stream is float32 by design)
        backbone64 = copy.deepcopy(backbone).cpu().double()
        head_cpu = create_model("TransMIL", 2, 2048, device="cpu", use_pallas=False).eval()
        head_cpu.load_state_dict(head.state_dict())
        with torch.no_grad():
            maps = backbone64(torch.from_numpy(tiles).double(), return_spatial=True)
        maps.requires_grad_(True)
        (grads,) = torch.autograd.grad(head_cpu(maps.mean(dim=(1, 2))[None])[0, 1], maps)
        for method in ("gradcam", "eigencam"):
            viz = ImageVisualizer(backbone, head, root / f"image_{method}", chunk=IMAGE_VIZ_TILES,
                                  tile_size=TILE, cam_method=method)
            sync(dev)
            t0 = time.perf_counter()
            got, launches = all_launch_counts(lambda: viz.run_slide(tiles, grid, "slide"))
            sec = time.perf_counter() - t0
            expect_launches_exactly(f"[tools] ImageVisualizer {method}", launches,
                                    nystrom_landmark_attn=4, nystrom_query_lm=4)
            want = normalize_cam(compute_cam(method, maps.detach(), grads))
            err = float(np.abs(got["pixel_cams"] - want).max())
            log(f"[tools] ImageVisualizer ({method}, ResNet50 + TransMIL-2048, 1 slide of "
                f"{IMAGE_VIZ_TILES} tiles at {TILE} px): {sec * 1e3:.1f} ms, pixel CAMs "
                f"{got['pixel_cams'].shape} vs the CPU's (ResNet50 in float64) max|d| {err:.3e} "
                f"(tol {TOL})")
            if not err <= TOL:
                raise AssertionError(f"the {method} pixel CAMs disagree with float64")
        del backbone, head, backbone64, head_cpu, maps, grads

        # (c) SimCLR pretraining and ConvMixer
        tile_dir = root / "pretrain" / "BLOCKS" / "slide"
        tile_dir.mkdir(parents=True)
        for i, b in enumerate(pool[:PRETRAIN_TILES]):
            (tile_dir / f"tile_({i % 8}-{i // 8}).jpg").write_bytes(b)
        t0 = time.perf_counter()
        out = quiet(cli_pretrain.main, ["--tiles_dir", str(tile_dir.parent), "--epochs", "1",
                                        "--batch_size", str(PRETRAIN_BATCH), "--log_dir",
                                        str(root / "simclr"), "--device", dev.type], "tools")
        pretrain_s = time.perf_counter() - t0
        sim = SimCLRModel(resnet18(num_classes=0), 512, proj_dim=128, hidden_dim=512)
        load_simclr_checkpoint(sim, out["ckpt"])
        if not (out["tiles"] == PRETRAIN_TILES and np.isfinite(out["final_loss"])):
            raise AssertionError(f"cli.pretrain: {out}")
        images = np.stack([np.asarray(Image.open(p).convert("RGB"))
                           for p in sorted(tile_dir.glob("*.jpg"))])
        aug = np.random.default_rng(0)
        t0 = time.perf_counter()
        v1, v2 = two_view_batch(images, np.arange(PRETRAIN_BATCH), aug)
        aug_ms = (time.perf_counter() - t0) * 1e3
        sim = sim.to(dev)
        tx = create_scheduled_adamw(sim, cosine_decay_schedule(5e-4, 100, 1.0 / 50), 1e-4)
        d1, d2 = (torch.from_numpy(v).to(dev) for v in (v1, v2))
        step_ms = cuda_ms(lambda: simclr_step(sim, tx, d1, d2, 0.07), reps=5, warmup=1)
        log(f"[tools] cli.pretrain (ResNet18, {PRETRAIN_TILES} tiles at {TILE} px, batch "
            f"{PRETRAIN_BATCH}, 1 epoch): {pretrain_s:.2f} s, final loss {out['final_loss']:.4f}, "
            f"checkpoint reloads; a step: two views' augmentation {aug_ms:.1f} ms (host, one "
            f"thread), update {step_ms:.3f} ms (device); host share "
            f"{aug_ms / (aug_ms + step_ms):.3f}")
        del sim, tx, d1, d2

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(11)
            mixer = ConvMixer(**CONVMIXER, n_classes=2)
            for m in mixer.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.05)
                    m.running_var.uniform_(0.8, 1.2)
        xs = torch.from_numpy(normalize_tiles(tiles_u8[:CONVMIXER_TILES]))
        mixer64 = copy.deepcopy(mixer).double().eval()
        with torch.inference_mode():
            want = mixer64(xs.double()).numpy()
            mixer = mixer.to(dev).eval()
            xd = xs.to(dev)
            got = mixer(xd).cpu().numpy()
            mixer_ms = cuda_ms(lambda: mixer(xd), reps=5, warmup=1)
        err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
        d, depth, k, p = (CONVMIXER[key] for key in ("dim", "depth", "kernel_size", "patch_size"))
        cells = CONVMIXER_TILES * (TILE // p) ** 2
        flops = 2 * cells * d * (p * p * 3 + depth * (k * k + d))
        nbytes = 4 * (xs.numel() + sum(t.numel() for t in mixer.state_dict().values()) +
                      CONVMIXER_TILES * 2)
        bound_ms, by = bound(flops, nbytes)
        log(f"[tools] ConvMixer{tuple(CONVMIXER.values())} eval forward on {CONVMIXER_TILES} "
            f"tiles at {TILE} px: {mixer_ms:.3f} ms, float32 bound {bound_ms:.3f} ms ({by}), "
            f"{bound_ms / mixer_ms:.3f} of it; vs float64 on the CPU {err:.3e} of the largest "
            f"logit (tol {TOL})")
        if not err <= TOL:
            raise AssertionError("ConvMixer disagrees with float64")
        del mixer, xd

        # (d) the energy sweep, watts from the card
        watts = card_watts(dev)
        sus_dir = root / "sustainability"
        for mode in ("inference", "train"):
            t0 = time.perf_counter()
            _, launches = all_launch_counts(lambda: quiet(cli_sus.main, [
                "--out_dir", str(sus_dir), "--mode", mode, "--device", dev.type,
                *(["--regions"] if has_mpl else [])], "tools"))
            sweep_s = time.perf_counter() - t0
            rows = json.loads((sus_dir / f"sustainability_{mode}.json").read_text())
            # TransMIL's eval forwards (a warm-up + the reps, a bag size) run K1/K2
            sweep = cli_sus.make_parser().parse_args([])
            per = 2 * (sweep.reps + 1) * len(sweep.bag_sizes) if mode == "inference" else 0
            expect_launches_exactly(f"[tools] cli.sustainability {mode}", launches,
                                    translayer_k1=per, translayer_k2=per)
            worst = max(abs(r["kwh"] - r["seconds"] * watts / 3.6e6) for r in rows)
            log(f"[tools] cli.sustainability {mode} at {watts} W: {sweep_s:.2f} s, seconds "
                + ", ".join(f"{r['model']}/{r['bag_size']} {r['seconds']}" for r in rows)
                + f"; kWh off seconds x watts / 3.6e6 by {worst:.3e}, launches {launches}")
            if not worst <= 5e-5 * watts / 3.6e6:  # the rows' seconds are rounded to 4 decimals
                raise AssertionError("the sweep's kWh is not seconds x watts / 3.6e6")

        # (e) the metric export over (a)'s log tree
        if has_mpl:
            quiet(cli_export.main, ["--log_root", str(root / "tools"), "--task", "norm_rest", "--out_csv",
                                    str(root / "combined.csv")], "tools")
            log(f"[tools] cli.export_metrics: {(root / 'combined.csv').read_text().count(chr(10))} "
                f"lines")
        else:
            try:
                quiet(cli_export.main, ["--log_root", str(root / "tools"), "--task", "norm_rest", "--out_csv",
                                        str(root / "combined.csv")], "tools")
            except ImportError as e:
                if "matplotlib" not in str(e):
                    raise
                log(f"[tools] cli.export_metrics without matplotlib: ImportError ({e}), as JAX's")
            else:
                raise AssertionError("cli.export_metrics drew figures without matplotlib")
        probs, targets, _ = read_patient_results(log_dir / "TEST_RESULT_PATIENT.csv",
                                                 "norm_rest", 2)
        log(f"[tools] bootstrap patient AUROC of (a)'s test stage: "
            f"{bootstrap_auroc(probs, targets, 2, n_boot=200)}")
    log(f"[env] tools phase {time.perf_counter() - t_phase:.1f} s")


REST_RULES = ("nadam", "lookahead_adamp", "sgdp", "adadelta", "adafactor", "rmsprop",
              "rmsproptf", "lookahead_novograd", "lamb")  # the nine rules, two with lookahead
REST_STEPS = 4  # optimizer steps a rule, held to the all-plain route
REST_GRAD_TOL = 1e-4  # the two routes' first gradients, relative to each tensor's largest entry
HESSIAN_BAGS = {"AttMIL": 40960, "TransformerMIL": 1000}
HESSIAN_STEPS = 3
HESSIAN_TOL = 1e-3  # the diagonal vs the CPU's, relative to its largest entry
SWA_SPLITS = {"n_train": 16, "n_val": 8, "n_test": 8}
SWA_AUTOSAVE = 4  # micro-steps between autosaves
REST_BUDGET_S = 90.0


def phase_train_rest(rng, results: dict, dev) -> None:
    """The rest of training on the card (phase 16):

    (a) TransMIL-2048 with ``use_pallas`` at the training cell's settings
    (``configs/synthetic_transmil_norm_rest.yaml``: 1,000-tile bags, batch 1,
    grad_acc 2): the first micro-step's gradients of the kernel route held
    to the all-plain route's within 1e-4 of each tensor's largest entry;
    then each of the nine other rules (lookahead on adamp and novograd)
    from one init: 4 optimizer steps held to the all-plain route within
    1e-4 or, where larger, the rule's own spread under gradient noise of
    the size the two routes' gradients differ by, the losses within 1e-4,
    B5/B6 2 launches each a micro-step, each rule's median step time (the
    last 3 steps);
    (b) AdaHessian on AttMIL-2048 (a 40,960-tile bag) and TransformerMIL-2048
    (1,000 tiles): the first step's Hutchinson diagonal held to the same
    step on the CPU with the same probes (within 1e-3 of its largest entry),
    3 steps timed against 3 Adam steps on the same bag; TransMIL raises
    ROADMAP C18's TypeError on the card too;
    (c) ``Trainer.fit`` of TransMIL-2048 with ``use_pallas``, 2 epochs of 16
    bags, SWA from epoch 1 (``swa_start_frac`` 0.5), an autosave every 4
    micro-steps, TensorBoard on where tensorboardX is installed: the final
    weights are the mean of the averaged epochs' end weights, ``last.ckpt``
    holds them alone; a run that dies in epoch 1 resumes from its mid-epoch
    autosave (the epoch restarts on the autosaved weights, as JAX's); the
    autosave's cost a micro-step, with against without."""
    import importlib.util

    import numpy as np
    import torch

    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.train.adahessian import rademacher, \
        value_grad_and_diag_hessian
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
    from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint

    t_phase = time.perf_counter()
    loss_fn = create_loss()

    def datamodule(splits):
        return MILDataModule(n_classes=2, max_bag_size=TRAIN_BAG, batch_size=1, seed=2021,
                             synthetic={**splits, "bag_size": TRAIN_BAG, "feature_size": 2048,
                                        "signal": 0.8})

    torch.manual_seed(1)
    init = create_model("TransMIL", 2, 2048, device=dev).state_dict()

    def transmil(use_pallas: bool):
        model = create_model("TransMIL", 2, 2048, device=dev, use_pallas=use_pallas)
        model.load_state_dict(init)
        return model

    # (a) the nine rules against the all-plain route. First the kernels'
    # backward alone: the first micro-step's gradients of the two routes, from
    # one init and one bag, each tensor within REST_GRAD_TOL of its largest
    # entry. Then the weights after 4 steps of each rule. A rule that divides
    # each element's step by that element's own gradient scale (nadam, adamp,
    # rmsprop, ...) turns a sign flip of a gradient at the float32 noise floor
    # into a step of ~lr, so the bar is 1e-4 or, where larger, the rule's own
    # spread: the all-plain route against itself with each micro-step's
    # gradient moved by Gaussian noise of the RMS by which the two routes'
    # first gradients differ, tensor by tensor, relative to its largest entry
    dm = datamodule(TRAIN_SPLITS)
    batches = list(dm.train_batches(0))[:REST_STEPS * GRAD_ACC]

    def first_grads(use_pallas: bool, tmp: str) -> list[torch.Tensor]:
        tr = Trainer(transmil(use_pallas), create_optimizer("adam", grad_accum_steps=GRAD_ACC),
                     dm, n_classes=2, loss_fn=loss_fn,
                     config=TrainerConfig(log_dir=f"{tmp}/grads{use_pallas}",
                                          train_deterministic=True, epoch_figures=False))
        tr.tx.init(tr.model)
        tr.train_step(*tr._batch_tensors(batches[0]))  # accumulates: the weights stay
        return [p.grad.clone() for p in tr.model.parameters()]

    with tempfile.TemporaryDirectory() as tmp:
        gk, gp = first_grads(True, tmp), first_grads(False, tmp)
    names = [n for n, _ in transmil(False).named_parameters()]
    scales = [g.abs().max().clamp_min(1e-30) for g in gp]
    grad_err, grad_where = max((((a - b).abs().max() / s).item(), n)
                               for a, b, s, n in zip(gk, gp, scales, names))
    noise_rel = [((a - b).pow(2).mean().sqrt() / s).item() for a, b, s in zip(gk, gp, scales)]
    log(f"[train_rest] the first micro-step's gradients, kernel route vs all-plain route: max "
        f"err {grad_err:.3e} of the tensor's largest entry ({grad_where}; tol {REST_GRAD_TOL}); "
        f"RMS of the difference {min(noise_rel):.3e} to {max(noise_rel):.3e} of the tensor's "
        f"largest entry, the noise of each rule's spread")
    if not grad_err <= REST_GRAD_TOL:
        raise AssertionError("the kernel route's gradients disagree with the all-plain route's")

    def noisy(tx, seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        step = tx.step

        def perturbed_step(**kw):
            with torch.no_grad():
                for p, rel in zip(tx.params, noise_rel):
                    if p.grad is not None:
                        p.grad += rel * p.grad.abs().max() * torch.randn(
                            p.grad.shape, generator=gen, device=dev)
            return step(**kw)

        tx.step = perturbed_step

    with tempfile.TemporaryDirectory() as tmp:
        for opt in REST_RULES:
            runs = []
            for use_pallas, perturb in ((True, False), (False, False), (False, True)):
                tr = Trainer(transmil(use_pallas),
                             create_optimizer(opt, lr=2e-4, weight_decay=0.01,
                                              grad_accum_steps=GRAD_ACC),
                             dm, n_classes=2, loss_fn=loss_fn,
                             config=TrainerConfig(log_dir=f"{tmp}/{opt}{use_pallas}{perturb}",
                                                  train_deterministic=True,
                                                  epoch_figures=False))
                tr.tx.init(tr.model)
                if perturb:
                    noisy(tr.tx, 7)
                nk.reset_launch_counts()
                step_ms, losses = [], []
                for i in range(0, len(batches), GRAD_ACC):
                    sync(dev)
                    t0 = time.perf_counter()
                    for batch in batches[i:i + GRAD_ACC]:
                        losses.append(tr.train_step(*tr._batch_tensors(batch))[0])
                    sync(dev)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                runs.append((tr, step_ms, losses, dict(nk.LAUNCHES)))
            (kern, ms, lk, launches), (plain, plain_ms, lp, _), (noise, *_) = runs

            def worst(a, b):
                return max(((x - y).abs().max().item(), n) for (n, x), y in
                           zip(a.model.named_parameters(), b.model.parameters()))

            (diff, where), (spread, _) = worst(kern, plain), worst(noise, plain)
            bar = max(1e-4, spread)
            want = {"nystrom_landmark_attn": 2 * len(batches), "nystrom_query_lm": 2 * len(batches)}
            log(f"[train_rest] {opt}: step {np.median(ms[1:]):.3f} ms (median of the last "
                f"{len(ms) - 1}; all-plain route {np.median(plain_ms[1:]):.3f} ms), "
                f"max|dloss| {max(abs(a - b) for a, b in zip(lk, lp)):.3e}, max|dparam| "
                f"{diff:.3e} ({where}); the rule's own spread {spread:.3e}, bar {bar:.3e}; "
                f"launches {launches}")
            if launches != want:
                raise AssertionError(f"{opt}: expected launches {want}, got {launches}")
            worst_loss = max(abs(a - b) for a, b in zip(lk, lp))
            if not (diff <= bar and worst_loss <= 1e-4 and np.isfinite(lk).all()):
                raise AssertionError(f"{opt}: the kernel route disagrees with the all-plain route")

    # (b) AdaHessian: the diagonal against the CPU's, the step against Adam's
    for name, n in HESSIAN_BAGS.items():
        torch.manual_seed(2)
        model = create_model(name, 2, 2048, device=dev)
        cpu = create_model(name, 2, 2048, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        x = torch.from_numpy(rng.standard_normal((1, n, 2048), dtype=np.float32))
        y = torch.tensor([[0.0, 1.0]])
        zs = rademacher(list(cpu.parameters()), torch.Generator().manual_seed(3))
        diags = []
        for m, d in ((model, dev), (cpu, torch.device("cpu"))):
            m.eval()  # dropout off: the two devices draw other masks
            xd, yd = x.to(d), y.to(d)
            _, _, diag = value_grad_and_diag_hessian(
                lambda: loss_fn(m(xd), yd), list(m.parameters()), zs=[z.to(d) for z in zs])
            diags.append([t.cpu() for t in diag])
        scale = max(t.abs().max().item() for t in diags[1])
        err = max((a - b).abs().max().item() for a, b in zip(*diags)) / max(scale, 1e-30)
        log(f"[train_rest] AdaHessian {name}-2048 at {n} tiles: the diagonal vs the CPU's with "
            f"the same probes, max err {err:.3e} of its largest entry {scale:.3e} "
            f"(tol {HESSIAN_TOL})")
        if not err <= HESSIAN_TOL:
            raise AssertionError(f"{name}: the card's Hessian diagonal disagrees with the CPU's")
        xd, labels = x.to(dev), torch.ones(1, dtype=torch.long, device=dev)
        times = {}
        for opt in ("adahessian", "adam"):
            m = create_model(name, 2, 2048, device=dev)
            m.load_state_dict(model.state_dict())
            with tempfile.TemporaryDirectory() as tmp:
                tr = Trainer(m, create_optimizer(opt, lr=2e-4, weight_decay=0.01), dm,
                             n_classes=2, loss_fn=loss_fn, model_name=name,
                             config=TrainerConfig(log_dir=tmp, epoch_figures=False))
                tr.tx.init(tr.model)
                ms = []
                for _ in range(HESSIAN_STEPS + 1):
                    sync(dev)
                    t0 = time.perf_counter()
                    loss, _ = tr.train_step(xd, labels)
                    sync(dev)
                    ms.append((time.perf_counter() - t0) * 1e3)
                if not np.isfinite(loss):
                    raise AssertionError(f"{name} {opt}: non-finite loss")
            times[opt] = float(np.median(ms[1:]))
        log(f"[train_rest] {name}-2048 at {n} tiles: AdaHessian step {times['adahessian']:.3f} "
            f"ms, Adam step {times['adam']:.3f} ms (median of {HESSIAN_STEPS} after a warm-up "
            f"one), ratio {times['adahessian'] / times['adam']:.2f}")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            Trainer(transmil(True), create_optimizer("adahessian"), dm, n_classes=2,
                    loss_fn=loss_fn, config=TrainerConfig(log_dir=tmp, epoch_figures=False))
        raise AssertionError("TransMIL's AdaHessian did not raise (ROADMAP C18)")
    except TypeError as e:
        if "C18" not in str(e):
            raise
        log(f"[train_rest] TransMIL-2048 AdaHessian raises on the card: {str(e)[:90]}...")

    # (c) fit with SWA and autosave; a run that dies mid-epoch resumes
    tb = importlib.util.find_spec("tensorboardX") is not None
    log(f"[train_rest] tensorboardX installed: {tb}")

    class Died(Exception):
        pass

    def fit_trainer(log_dir, autosave: int):
        tx = create_optimizer("lookahead_radam", lr=2e-4, weight_decay=0.01,
                              grad_accum_steps=GRAD_ACC)
        config = TrainerConfig(epochs=TRAIN_EPOCHS, log_dir=str(log_dir), swa=True,
                               swa_start_frac=0.5, autosave_steps=autosave,
                               use_tensorboard=tb, epoch_figures=False, export_topk_tiles=False)
        return Trainer(transmil(True), tx, datamodule(SWA_SPLITS), n_classes=2,
                       loss_fn=loss_fn, config=config)

    def timed(tr, die_at=None):
        """Host time between micro-steps (a step and what follows it: the
        autosave's snapshot), and the end weights of each averaged epoch."""
        marks, ends = [], []
        step, swa_update = tr.train_step, tr._swa_update

        def train_step(*args):
            if die_at is not None and len(marks) == die_at:
                raise Died
            sync(dev)
            marks.append(time.perf_counter())
            return step(*args)

        def on_swa():
            ends.append([p.detach().double().clone() for p in tr.model.parameters()])
            swa_update()

        tr.train_step, tr._swa_update = train_step, on_swa
        return marks, ends

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        per_step = {}
        for autosave in (0, SWA_AUTOSAVE):
            tr = fit_trainer(tmp / f"fit{autosave}", autosave)
            marks, ends = timed(tr)
            tr.fit()
            gaps = np.diff(marks[:SWA_SPLITS["n_train"]]) * 1e3  # epoch 0's micro-steps
            per_step[autosave] = (float(np.mean(gaps)), float(np.median(gaps)))
        mean = [torch.stack(ws).mean(0) for ws in zip(*ends)]
        worst = max((p.detach().double() - m).abs().max().item()
                    for p, m in zip(tr.model.parameters(), mean))
        last = read_checkpoint(tmp / f"fit{SWA_AUTOSAVE}" / "checkpoints" / "last.ckpt")
        log(f"[train_rest] fit with SWA over {len(ends)} epoch end(s): max|final - mean| "
            f"{worst:.3e}; last.ckpt keys {sorted(last)}")
        if worst > 1e-6 or set(last) != {"model"}:
            raise AssertionError("SWA's final weights or last.ckpt are wrong")
        if tb and not list((tmp / f"fit{SWA_AUTOSAVE}" / "tb").glob("events.out.tfevents.*")):
            raise AssertionError("no TensorBoard events were written")
        (m0, d0), (m1, d1) = per_step[0], per_step[SWA_AUTOSAVE]
        log(f"[train_rest] a micro-step of epoch 0, mean / median: {m0:.3f} / {d0:.3f} ms "
            f"without autosave, {m1:.3f} / {d1:.3f} ms with one every {SWA_AUTOSAVE}: "
            f"{m1 - m0:+.3f} ms a micro-step")

        # dies at epoch 1's 11th micro-step: the autosave after its 8th holds
        # 8 + 4 optimizer steps and epoch 1 as the one to rerun
        die_at = SWA_SPLITS["n_train"] + 10
        tr = fit_trainer(tmp / "died", SWA_AUTOSAVE)
        timed(tr, die_at)
        try:
            tr.fit()
            raise AssertionError("the run did not die")
        except Died:
            tr._autosave_join()
        saved = read_checkpoint(tmp / "died" / "checkpoints" / "last.ckpt")
        count = (SWA_SPLITS["n_train"] + 8) // GRAD_ACC
        resumed = fit_trainer(tmp / "died", SWA_AUTOSAVE)
        if not resumed.load_train_state(tmp / "died" / "checkpoints" / "last.ckpt"):
            raise AssertionError("the autosave holds no train state")
        same = all(torch.equal(a.cpu(), b.detach().cpu()) for a, b in
                   zip(saved["model"].values(), resumed.model.state_dict().values()))
        rows_before = len(metric_rows(tmp / "died"))
        resumed.fit()
        rows = metric_rows(tmp / "died")
        log(f"[train_rest] died at micro-step {die_at}: autosave of epoch "
            f"{saved['fit']['epoch']} with {saved['optimizer']['count']} optimizer steps; the "
            f"resume reran epoch {rows[-1]['step']} to {resumed.tx.count} steps, val_loss "
            f"{rows[-1]['val_loss']:.4f}")
        if not (saved["fit"]["epoch"] == 1 and saved["optimizer"]["count"] == count and same
                and resumed.tx.count == count + SWA_SPLITS["n_train"] // GRAD_ACC
                and len(rows) == rows_before + 1 and np.isfinite(rows[-1]["val_loss"])):
            raise AssertionError("the mid-epoch autosave did not resume as JAX's does")
    spent = time.perf_counter() - t_phase
    log(f"[train_rest] phase {spent:.1f} s (budget {REST_BUDGET_S:.0f} s)")



PAR_SEED = 17  # weights and inputs of phase 17, made alike in every process
PAR_WORLD = 2  # gloo processes on the one card
PAR_TILES = 1024  # the tile-parallel slide: 4 steps of 128 tiles a process
PAR_TRAIN = {"n_train": 16, "n_val": 4, "n_test": 4}  # 4 optimizer steps at batch 4
PAR_BATCH = 4  # 2 a process
SP_N = 81920  # sequence-parallel Nystrom: 40,960 tokens a process
TP_BAG = 12000
TP_LOGIT_TOL, TP_GRAD_TOL = 2e-5, 5e-4  # tests/test_tp.py's bars
LAYOUT_TILES = 128  # one chunk through the layout variants
PAR_CHUNK_MS = "14.40-14.69"  # PERF.md section 5: a 128-tile chunk of apply_qresnet50


def _par_inputs(dev):
    """(ResNet50 variables, calibration tiles (normalized), the slide's uint8
    tiles, TransMIL-2048 params) of phase 17, from PAR_SEED."""
    import numpy as np

    rng = np.random.default_rng(PAR_SEED)
    variables = random_resnet50_variables(rng)
    tiles = rng.integers(0, 256, (PAR_TILES, TILE, TILE, 3), dtype=np.uint8)
    calib = normalize_tiles(tiles[:CALIB_TILES])
    return variables, calib, tiles, random_transmil_params(rng, 2048, 2)


def _par_head(params, dev, **kw):
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

    model = create_model("TransMIL", 2, 2048, device=dev, **kw)
    model.load_state_dict(state_dict_from_jax(params, 2048))
    return model


def _par_datamodule():
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule

    return MILDataModule(n_classes=2, max_bag_size=TRAIN_BAG, batch_size=PAR_BATCH, seed=PAR_SEED,
                         synthetic={**PAR_TRAIN, "bag_size": TRAIN_BAG, "feature_size": 2048,
                                    "signal": 0.5})


def _par_fit(params, dev, log_dir: Path, mesh=None):
    """TransMIL-2048 with use_pallas, lookahead_radam, one epoch of 4
    optimizer steps at batch 4 (dropout off); returns (history, weights,
    launches of the fit)."""
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.train import losses
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = _par_head(params, dev, use_pallas=True)
    cfg = TrainerConfig(epochs=1, log_dir=str(log_dir), train_deterministic=True,
                        epoch_figures=False, export_topk_tiles=False, seed=PAR_SEED)
    trainer = Trainer(model, create_optimizer("lookahead_radam"), _par_datamodule(), n_classes=2,
                      loss_fn=losses.create_loss(), config=cfg, mesh=mesh)
    nk.reset_launch_counts()
    tk.reset_launch_counts()
    history = trainer.fit()
    sync(dev)
    launches = {**nk.LAUNCHES, **tk.LAUNCHES}
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return history, weights, launches


def _par_rank(rank: int, world: int, port: int, work: str, device_type: str) -> None:
    """One gloo process of phase 17 on the parent's card (``device_type``
    "cuda": cuda:0): the tile-parallel embed, dp training, sequence- and
    tensor-parallel Nystrom; results to ``work/rank<r>.json`` (the parent
    checks them)."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
    from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention
    from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, init_multihost, make_mesh
    from transmil_deepgraft_tpu_torch.parallel.sp_nystrom import sp_nystrom_attention
    from transmil_deepgraft_tpu_torch.parallel.tile_parallel import gather_rows
    from transmil_deepgraft_tpu_torch.parallel.tp import tp_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0)
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    work = Path(work)
    init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    out: dict = {"rank": rank}
    variables, calib, tiles, head_params = _par_inputs(dev)

    # (a) the tile-parallel slide embed: CHUNK tiles a process a step
    mesh = make_mesh(dp=world, device_type=device_type)
    pipe = SlideInferencePipeline(variables, _par_head(head_params, dev), calib_tiles=calib,
                                  chunk=CHUNK, device=dev, mesh=mesh)
    pipe.predict_slide(tiles[:CHUNK * world])  # warm-up, outside the counted run
    qk.reset_launch_counts()
    tk.reset_launch_counts()
    feats = pipe.embed_device(tiles)
    probs = pipe._probs(feats)
    sync(dev)
    out["embed_launches"] = {**qk.LAUNCHES, **tk.LAUNCHES}
    want = np.load(work / "one_rank_features.npy")
    got = feats.cpu().numpy()
    out["embed_equal"] = bool(np.array_equal(got, want))
    out["embed_codes_differing"] = int((got != want).sum())
    out["probs"] = probs.tolist()
    block = torch.zeros(CHUNK, 2048, device=dev)
    out["all_gather_ms"] = cuda_ms(lambda: gather_rows(block, mesh.get_group("dp")))
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        pipe.embed_device(tiles)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["embed_ms"] = sorted(times)[1]
    del pipe, feats

    # (b) data-parallel training, batch 4 = 2 a process
    history, weights, launches = _par_fit(head_params, dev, work / "dp_fit", mesh=mesh)
    one = torch.load(work / "one_rank_fit.pt", weights_only=False)
    out["fit_loss"], out["fit_loss_one_rank"] = history["loss"], one["history"]["loss"]
    out["fit_val_loss"], out["fit_val_loss_one_rank"] = history["val_loss"], one["history"]["val_loss"]
    out["fit_weight_err"] = max(float((weights[k] - one["weights"][k]).abs().max())
                                for k in weights)
    out["fit_launches"] = launches

    # (c) sequence-parallel Nystrom, sp = world, at the kernels' shape
    sp_mesh = make_mesh(dp=1, sp=world, device_type=device_type)
    j = axis_rank(sp_mesh, "sp")
    rng = np.random.default_rng(PAR_SEED + 1)
    qkv = [torch.from_numpy(rng.standard_normal((1, 8, SP_N, 64), dtype=np.float32)).to(dev)
           for _ in range(3)]
    n_loc = SP_N // world
    local = [x[:, :, j * n_loc:(j + 1) * n_loc].contiguous() for x in qkv]
    with torch.inference_mode():
        nk.reset_launch_counts()
        sp_out = sp_nystrom_attention(*local, sp_mesh, num_landmarks=256)
        sync(dev)
        out["sp_launches"] = dict(nk.LAUNCHES)
        want_sp = nystrom_attention(*qkv, num_landmarks=256).out[:, :, j * n_loc:(j + 1) * n_loc]
        out["sp_err"] = float((sp_out - want_sp).abs().max())
        out["sp_ms"] = cuda_ms(lambda: sp_nystrom_attention(*local, sp_mesh, num_landmarks=256),
                               reps=5)
        out["one_rank_fused_ms"] = cuda_ms(lambda: nk.nystrom_attention_fused(*qkv, 256, 6), reps=5)
        # B3's row statistics against their plain version on this segment
        q_lm = torch.from_numpy((0.125 * rng.standard_normal((8, 256, 64))).astype(np.float32))
        q_lm = q_lm.to(dev)
        k_flat, v_flat = local[1].reshape(8, n_loc, 64), local[2].reshape(8, n_loc, 64)
        got_a, got_lse = nk.landmark_attention(q_lm, k_flat, v_flat, return_stats=True)
        want_a, want_lse = nk.landmark_attention_reference(q_lm, k_flat, v_flat, return_stats=True)
        out["stats_err"] = float((got_lse - want_lse).abs().max())
        out["stats_rows_err"] = float((got_a - want_a).abs().max())
        out["stats_ms"] = cuda_ms(lambda: nk.landmark_attention(q_lm, k_flat, v_flat,
                                                                return_stats=True))
        out["no_stats_ms"] = cuda_ms(lambda: nk.landmark_attention(q_lm, k_flat, v_flat))
    del qkv, local, sp_out, want_sp

    # (d) tensor parallelism, tp = world, over a 12,000-tile bag
    tp_mesh = init_device_mesh(device_type, (1, world), mesh_dim_names=("dp", "tp"))
    bag = torch.from_numpy(np.random.default_rng(PAR_SEED + 2).standard_normal(
        (1, TP_BAG, 2048), dtype=np.float32)).to(dev)
    ref, sharded = (_par_head(head_params, dev, use_pallas=True).eval() for _ in range(2))
    sharded = tp_shard(sharded, tp_mesh)
    results = []
    for model in (ref, sharded):
        logits = model(bag)
        torch.log_softmax(logits, -1)[:, 1].sum().neg().backward()
        results.append((logits.detach(), dict(model.named_parameters())))
    sync(dev)
    (ref_logits, ref_p), (tp_logits, tp_p) = results
    r = axis_rank(tp_mesh, "tp")
    grad_err = 0.0
    for name, p in tp_p.items():
        full = ref_p[name].grad
        if name.endswith("to_qkv.weight"):
            full = full.chunk(world, dim=0)[r]
        elif name.endswith("to_out.0.weight"):
            full = full.chunk(world, dim=1)[r]
        grad_err = max(grad_err, float((p.grad - full).abs().max()))
    out["tp_logit_err"] = float((tp_logits - ref_logits).abs().max())
    out["tp_grad_err"] = grad_err
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel(rng, results: dict, dev) -> None:
    """Phase 17: the multi-process paths on the one card. Parent: the
    one-process references (the slide's features, the fit), NCCL as a world
    of one (the join, an all_reduce, a data-parallel step), the int8
    ResNet50's layout variants on one chunk. Then two gloo processes on
    cuda:0 (``_par_rank``): the tile-parallel embed (bit for bit), dp
    training (within 1e-4), sp = 2 Nystrom with B3's row statistics (within
    1e-4), tp = 2 TransMIL (tests/test_tp.py's bars). Two processes on one
    card share it: their times are overhead, not scaling."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.models.resnet import resnet50
    from transmil_deepgraft_tpu_torch.models import resnet_int8 as ri
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk
    from transmil_deepgraft_tpu_torch.ops.pinv import divisor_reduced_over
    from transmil_deepgraft_tpu_torch.parallel.mesh import init_multihost, make_mesh
    from transmil_deepgraft_tpu_torch.train.trainer import _mean_over
    from transmil_deepgraft_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

    t_phase = time.perf_counter()
    variables, calib, tiles, head_params = _par_inputs(dev)

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # NCCL as a world of one: the join, an all_reduce, a data-parallel step
    rank, world = init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != backend or (rank, world) != (0, 1):
        raise AssertionError(f"expected an {backend} world of one, got {dist.get_backend()} "
                             f"{rank}/{world}")
    mesh = make_mesh(dp=1, device_type=dev.type)
    group = mesh.get_group("dp")
    x = torch.arange(4.0, device=dev)
    dist.all_reduce(x, group=group)
    model = _par_head(head_params, dev, use_pallas=True).eval()  # dropout off, B5/B6 kept
    bag = torch.from_numpy(np.random.default_rng(PAR_SEED).standard_normal(
        (1, TRAIN_BAG, 2048), dtype=np.float32)).to(dev)
    grads = []
    for reduce in (False, True):
        model.zero_grad()
        with divisor_reduced_over(group if reduce else None):
            torch.log_softmax(model(bag), -1)[:, 0].sum().neg().backward()
        g = [p.grad.clone() for p in model.parameters()]
        if reduce:
            _mean_over(g, group)
        grads.append(g)
    sync(dev)
    if not (torch.equal(x, torch.arange(4.0, device=dev))
            and all(torch.equal(a, b) for a, b in zip(*grads))):
        raise AssertionError("the NCCL world of one changed a value")
    dist.destroy_process_group()
    log(f"[parallel] {backend} world of one: joined, all_reduce, a data-parallel step (divisor "
        "MAX-reduced, gradients mean-reduced) bit for bit the plain step's")

    # the layout variants on one chunk, on the card
    q = ri.build_qresnet50(variables, calib, device=dev)
    x = torch.from_numpy(normalize_tiles(tiles[:LAYOUT_TILES])).to(dev)
    prep = ri.prepare_qresnet50_fused(q)
    s1 = ri.build_bf16_stage1(variables, calib, device=dev)
    with torch.inference_mode():
        full = ri.apply_qresnet50(q, x)
        qk.reset_launch_counts()
        wpack = ri.apply_qresnet50_wpack1(prep, x)
        sync(dev)
        wpack_launches = dict(qk.LAUNCHES)
        qk.reset_launch_counts()
        mixed = ri.apply_qresnet50_bf16s1(q, s1, x)
        sync(dev)
        bf16_launches = dict(qk.LAUNCHES)
        model = resnet50()
        model.load_state_dict(resnet_state_dict_from_jax(variables))
        ref = model.to(dev).eval()(x)
        times = {name: cuda_ms(fn, reps=5) for name, fn in (
            ("apply_qresnet50", lambda: ri.apply_qresnet50(q, x)),
            ("apply_qresnet50_wpack1", lambda: ri.apply_qresnet50_wpack1(prep, x)),
            ("apply_qresnet50_bf16s1", lambda: ri.apply_qresnet50_bf16s1(q, s1, x)))}

    def cos(a, b):
        return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())

    cos_mixed, cos_full = cos(ref, mixed), cos(ref, full)
    log(f"[parallel] layout variants on {LAYOUT_TILES} tiles: wpack1 bit-exact "
        f"{torch.equal(wpack, full)}, launches {wpack_launches}; bf16s1 cosine to float32 "
        f"{cos_mixed:.6f} (full int8 {cos_full:.6f}), launches {bf16_launches}; chunk ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" (PERF.md section 5's pipeline chunk: {PAR_CHUNK_MS} ms)")
    if not torch.equal(wpack, full):
        raise AssertionError("apply_qresnet50_wpack1 is not bit-exact to apply_qresnet50")
    if wpack_launches != {"qstage_run": 4, "qentry_run": 3, "qstem_run": 1}:
        raise AssertionError(f"wpack1 launches {wpack_launches}")
    if bf16_launches != {"qstage_run": 3, "qentry_run": 3, "qstem_run": 0}:
        raise AssertionError(f"bf16s1 launches {bf16_launches}")
    if not (cos_mixed > 0.999 and cos_mixed >= cos_full - 1e-4):
        raise AssertionError(f"bf16s1 cosine {cos_mixed} (full int8 {cos_full})")
    del q, prep, s1, model, full, wpack, mixed, ref, x

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # the one-process references
        pipe = SlideInferencePipeline(variables, _par_head(head_params, dev), calib_tiles=calib,
                                      chunk=CHUNK, device=dev)
        feats = pipe.embed_device(tiles)
        probs = pipe._probs(feats)
        np.save(work / "one_rank_features.npy", feats.cpu().numpy())
        one_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe.embed_device(tiles)
            sync(dev)
            one_ms.append((time.perf_counter() - t0) * 1e3)
        del pipe, feats
        history, weights, one_launches = _par_fit(head_params, dev, work / "one_fit")
        torch.save({"history": history, "weights": weights}, work / "one_rank_fit.pt")
        log(f"[parallel] one process: {PAR_TILES}-tile embed {sorted(one_ms)[1]:.2f} ms, probs "
            f"{probs.tolist()}; fit loss {history['loss']:.6f}, launches {one_launches}")

        t0 = time.perf_counter()
        mp.spawn(_par_rank, args=(PAR_WORLD, free_port(), str(work), dev.type),
                 nprocs=PAR_WORLD, join=True)
        log(f"[parallel] {PAR_WORLD} gloo processes on cuda:0: {time.perf_counter() - t0:.1f} s "
            "with their start")
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(PAR_WORLD)]

    steps = -(-PAR_TILES // (CHUNK * PAR_WORLD))
    per_step = PAR_TRAIN["n_train"] // PAR_BATCH
    val_bags = PAR_TRAIN["n_val"] // PAR_WORLD
    want_embed = {"qstage_run": 4 * steps, "qentry_run": 3 * steps, "qstem_run": steps,
                  "translayer_k1": 2, "translayer_k2": 2}
    want_fit = {"nystrom_landmark_attn": 2 * per_step, "nystrom_query_lm": 2 * per_step,
                "translayer_k1": 2 * val_bags, "translayer_k2": 2 * val_bags}
    for r in ranks:
        log(f"[parallel] rank {r['rank']}: embed bit-exact {r['embed_equal']} "
            f"({r['embed_codes_differing']} features differ), launches {r['embed_launches']}, "
            f"all_gather of ({CHUNK}, 2048) {r['all_gather_ms']:.3f} ms, {PAR_TILES}-tile embed "
            f"{r['embed_ms']:.2f} ms (one process: {sorted(one_ms)[1]:.2f}); dp fit loss "
            f"{r['fit_loss']:.6f} vs {r['fit_loss_one_rank']:.6f}, weights max|d| "
            f"{r['fit_weight_err']:.3e}, launches {r['fit_launches']}; sp={PAR_WORLD} n={SP_N} "
            f"max|err| {r['sp_err']:.3e}, launches {r['sp_launches']}, {r['sp_ms']:.3f} ms "
            f"(one process, fused: {r['one_rank_fused_ms']:.3f}); B3 statistics max|err| "
            f"{r['stats_err']:.3e} (rows {r['stats_rows_err']:.3e}), {r['stats_ms']:.4f} ms "
            f"vs {r['no_stats_ms']:.4f} without; tp={PAR_WORLD} logits max|d| "
            f"{r['tp_logit_err']:.3e}, gradients {r['tp_grad_err']:.3e}")
        checks = {
            "the tile-parallel embed is bit-exact": r["embed_equal"],
            "its probabilities": np.abs(np.asarray(r["probs"]) - probs).max() <= 1e-6,
            "its launches": r["embed_launches"] == want_embed,
            "dp loss within 1e-4": abs(r["fit_loss"] - r["fit_loss_one_rank"]) <= 1e-4,
            "dp val loss within 1e-4": abs(r["fit_val_loss"] - r["fit_val_loss_one_rank"]) <= 1e-4,
            "dp weights within 1e-4": r["fit_weight_err"] <= 1e-4,
            "dp launches": r["fit_launches"] == want_fit,
            "sp within 1e-4": r["sp_err"] <= SPLIT_TOL,
            "sp launches": r["sp_launches"] == {"nystrom_landmark_attn": 1, "nystrom_query_lm": 1},
            "B3 statistics within 1e-4": max(r["stats_err"], r["stats_rows_err"]) <= SPLIT_TOL,
            "tp logits": r["tp_logit_err"] <= TP_LOGIT_TOL,
            "tp gradients": r["tp_grad_err"] <= TP_GRAD_TOL,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"phase 17, rank {r['rank']}: {failed}")
    r0 = ranks[0]
    results["nystrom_landmark_attn"].update(
        sp_stats_max_abs_err=max(r["stats_err"] for r in ranks), sp_stats_ms=r0["stats_ms"],
        sp_no_stats_ms=r0["no_stats_ms"], sp_launches=r0["sp_launches"]["nystrom_landmark_attn"],
        dp_launches_per_process=r0["fit_launches"]["nystrom_landmark_attn"])
    results["nystrom_query_lm"].update(
        sp_launches=r0["sp_launches"]["nystrom_query_lm"],
        dp_launches_per_process=r0["fit_launches"]["nystrom_query_lm"])
    for name in ("qstage_run", "qentry_run"):
        results[name].update(tile_parallel_launches_per_process=r0["embed_launches"][name],
                             wpack1_launches=wpack_launches[name],
                             bf16s1_launches=bf16_launches[name])
    results["qstage_run"].update(chunk_ms=times)
    for name in ("translayer_k1", "translayer_k2"):
        results[name].update(dp_val_launches_per_process=r0["fit_launches"][name])
    log(f"[env] parallel phase {time.perf_counter() - t_phase:.1f} s")


def card_name_and_limit(attempts: int = 3, timeout_s: int = 20) -> str:
    """The card's name and power limit as nvidia-smi prints them, read once at
    the start. nvidia-smi can stall on a busy machine: a stalled query is
    asked again."""
    def query() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=timeout_s,
        ).stdout.strip().splitlines()[0]

    for _ in range(attempts - 1):
        try:
            return query()
        except subprocess.TimeoutExpired:
            log(f"[env] nvidia-smi stalled for {timeout_s} s; asking again")
    return query()


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
    smi = card_name_and_limit()
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
    t_new = time.perf_counter()
    phase_heads(rng, results, dev, variables)
    log(f"[env] heads phase {time.perf_counter() - t_new:.1f} s")
    phase_zoo(rng, results, dev)
    phase_extract(rng, results, dev, variables)
    phase_backbones(rng, results, dev)
    phase_tools(rng, results, dev)
    phase_train_rest(rng, results, dev)
    phase_parallel(rng, results, dev)
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
