"""Whole slides through ``SlideInferencePipeline.predict_slide`` with the
UNI2-h ViT as the tile encoder: one client in a closed loop, as ``cli.infer
--backbone uni2_h`` runs a cohort.

Set-up: the seeded UNI2-h weights in timm's names and TransMIL weights for
its 1536-d features, a pool of uint8 tiles in pageable host memory, the
pipeline built as ``cli.infer --backbone uni2_h`` builds it (the checkpoint
converted by ``models/backbones.uni2_h_from_timm``; bf16 matmuls on the
card), one warm ragged slide and the head at the largest slide. The window
sends the traffic's slide sizes in the seed's order, each slide a
contiguous view of the pool, until the window's seconds are up and a whole
block of sizes is done. ``slide_tiles_per_s`` is their tiles over the time
from the first slide's start to the last one's end.

The check: the window's shortest slide and others in the seed's order, up
to the traffic's ``check_tiles`` in all. The encoder works tile by tile, so
slide length adds nothing the check could catch in it (the head's long-n
path is the ResNet cell's to guard). Two numbers are compared:

- ``feature_gap``: the worst checked tile's relative feature gap
  ``|f - f_ref| / |f_ref|``, ``f`` from the pipeline's own ``embed_device``
  (what ``predict_slide`` calls), ``f_ref`` from ``reference/vit`` in
  float32, in chunks;
- ``logit_gap``: the widest gap of any class's log-probability against
  class 0's between the slide's answer from the window and the reference's
  features through the plain float32 TransMIL (``reference/transmil_fc1``).

``Cell.side == "control"`` puts the reference with its products in float8
e4m3 (per-tensor scales, float32 sums) in the program's place. The faults
``Cell.plant`` names are planted in the encoder the window runs:
``no_registers`` (the register tokens dropped), ``swiglu_swapped`` (the
SwiGLU gate taken from fc1's second half) and ``no_ls2`` (each block's MLP
branch added without its LayerScale).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, trace, weights, weights_vit
from portbench.reference import vit as ref_vit
from portbench.reference.transmil import precision
from portbench.reference.transmil_fc1 import Fc1Head
from portbench.runners import Cell, Outcome, memory_peak, release, tensors

MAX_SLIDES = 4096  # more than any window sends
PLANTS = ("no_registers", "swiglu_swapped", "no_ls2")


def run(cell: Cell) -> Outcome:
    # first, so that a program without UNI2-h fails before any set-up
    from transmil_deepgraft_tpu_torch.models.backbones import uni2_h_from_timm

    if cell.plant not in (None, *PLANTS):
        raise ValueError(f"unknown fault {cell.plant!r}; the cell plants {PLANTS}")
    cfg, tr, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    hw, chunk, widths = int(cfg["tile_hw"]), int(cfg["chunk"]), _widths(cfg)
    t0 = time.perf_counter()
    state = weights_vit.uni2h_state_dict(seed, dev, widths)
    head_params = weights_vit.transmil_params(seed, dev, cfg["in_features"], cfg["n_classes"])
    pool = weights.uint8_tiles(seed, dev, int(tr["pool_tiles"]), hw)
    sizes = generator.sizes(tr["sizes"], seed, MAX_SLIDES)
    offsets = generator.offsets_into(len(pool), sizes, seed)
    log = [f"[slide_vit] set-up: weights and {len(pool)} pool tiles "
           f"{time.perf_counter() - t0:.1f} s"]

    answers, window, feats = [], {}, {}
    if cell.side == "program":
        encoder = uni2_h_from_timm(state)
        _plant(encoder, cell.plant)
        answers, window, pipe = _window(cell, encoder, head_params, pool, sizes, offsets, log)
    mem = memory_peak(dev)
    # the window's shortest slide, then others in the seed's order while
    # they fit the budget
    done = len(answers) if answers else int(tr["sizes"]["count"])
    shortest = min(range(done), key=lambda i: sizes[i])
    budget, picked, total = int(tr["check_tiles"]), [], 0
    for i in generator.sample(done, seed, done, keep=(shortest,)):
        if i == shortest or total + sizes[i] <= budget:
            picked.append(i)
            total += sizes[i]
    t_check = time.perf_counter()
    if answers:
        for i in picked:
            feats[i] = pipe.embed_device(pool[offsets[i]:offsets[i] + sizes[i]]).cpu()
        del pipe, encoder
    release(dev)

    model = _reference_model(state, widths, dev)
    head = Fc1Head(tensors(head_params, dev), "float32")
    feature_gap, logit_gap, each = 0.0, 0.0, []
    for i in picked:
        tiles = pool[offsets[i]:offsets[i] + sizes[i]]
        want_f = _features(model, tiles, chunk, "float32", dev)
        want = _log_ratios(head, want_f)
        if cell.side == "control":
            got_f = _features(model, tiles, chunk, "fp8", dev)
            got = _log_ratios(head, got_f)
        else:
            got_f = feats[i].to(dev)
            got = np.log(answers[i][1:]) - np.log(answers[i][0])
        f_gap = float(((got_f - want_f).norm(dim=-1) / want_f.norm(dim=-1)).max())
        l_gap = float(np.max(np.abs(got - want)))
        each.append((sizes[i], f_gap, l_gap))
        feature_gap, logit_gap = max(feature_gap, f_gap), max(logit_gap, l_gap)
    log.append(f"[slide_vit] check: {len(picked)} slides, {total} tiles, "
               f"{time.perf_counter() - t_check:.1f} s")
    log.append(f"[slide_vit] gaps (tiles, feature, logit): {each}")
    work = {"slides": [s for s, _ in window.get("slides", [])], "chunk": chunk, "hw": hw,
            "in_features": cfg["in_features"], "backbone": widths,
            "checked": [sizes[i] for i in picked]}
    metrics = {}
    if window:
        metrics["slide_tiles_per_s"] = sum(work["slides"]) / window["seconds"]
    limits = cfg["limits"][tr["runner"]]
    return Outcome(metrics=metrics, window_start=window.get("setup_done", 0.0),
                   attempted=len(answers), failed=0,
                   checks={"feature_gap": (feature_gap, float(limits["feature_gap"])),
                           "logit_gap": (logit_gap, float(limits["logit_gap"]))},
                   work=work, trace=window.get("trace"), memory_peak_bytes=mem, log=log)


def _widths(cfg: dict) -> dict:
    """``reference/vit.UNI2h``'s keyword arguments from the configuration."""
    b = cfg["backbone"]
    return {k: b[k] for k in ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
                              "mlp_ratio", "reg_tokens", "init_values")}


def _plant(encoder, plant) -> None:
    """Plant the fault ``plant`` (None: none) in the port's encoder."""
    blocks = [getattr(encoder, f"block{i}") for i in range(encoder.depth)]
    with torch.no_grad():
        if plant == "no_registers":
            encoder.reg_token = None
        elif plant == "swiglu_swapped":
            for blk in blocks:
                for p in (blk.fc1.weight, blk.fc1.bias):
                    p.copy_(torch.cat(p.chunk(2)[::-1]))
        elif plant == "no_ls2":
            for blk in blocks:
                blk.ls2 = None


def _window(cell, encoder, head_params, pool, sizes, offsets, log):
    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.serving import head_from_params

    cfg, dev = cell.config, cell.device
    chunk = int(cfg["chunk"])
    t0 = time.perf_counter()
    head = head_from_params("TransMIL", head_params, cfg["in_features"], device=dev)
    pipe = SlideInferencePipeline(None, head, backbone=encoder, chunk=chunk, device=dev)
    log.append(f"[slide_vit] set-up: pipeline {time.perf_counter() - t0:.1f} s")
    # warm: a ragged two-chunk slide, then the head at the largest slide
    pipe.predict_slide(pool[:chunk + 1])
    with torch.inference_mode():
        head(torch.zeros(1, max(sizes), cfg["in_features"], device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_done = time.perf_counter()
    answers, slides = [], []
    block = int(cell.traffic["sizes"]["count"])
    with trace.Window(cell.trace) as win:
        start = time.perf_counter()
        while True:
            i = len(answers)
            n, off = sizes[i], offsets[i]
            with trace.span("slide.predict"):
                answers.append(pipe.predict_slide(pool[off:off + n]))
            slides.append((n, off))
            if len(slides) % block == 0 and time.perf_counter() - start >= cell.seconds:
                break
        seconds = time.perf_counter() - start
    log.append(f"[slide_vit] window: {len(slides)} slides, {sum(s for s, _ in slides)} tiles, "
               f"{seconds:.3f} s")
    return answers, {"slides": slides, "seconds": seconds, "setup_done": setup_done,
                     "trace": win.view()}, pipe


def _reference_model(state: dict, widths: dict, dev: torch.device) -> ref_vit.UNI2h:
    with torch.device("meta"):
        model = ref_vit.UNI2h(**widths)
    model.load_state_dict(state, assign=True)
    return model.to(dev)


def _features(model, tiles: np.ndarray, chunk: int, gemm: str, dev) -> torch.Tensor:
    """(n, D) float32 reference features of uint8 tiles, ``chunk`` at a time."""
    out = [ref_vit.forward_features(
        model, ref_vit.normalize(torch.from_numpy(tiles[s:s + chunk]).to(dev)), gemm)
        for s in range(0, len(tiles), chunk)]
    return torch.cat(out)


@torch.no_grad()
def _log_ratios(head: Fc1Head, feats: torch.Tensor) -> np.ndarray:
    """Logit of every class less class 0's."""
    with precision("float32"):
        z = head(feats[None])[0].double().cpu().numpy()
    return z[1:] - z[0]
