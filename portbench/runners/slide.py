"""Whole slides through ``SlideInferencePipeline.predict_slide``: one client
in a closed loop, as ``cli.infer`` runs a cohort.

Set-up: the seeded ResNet50 and TransMIL weights, a pool of uint8 tiles in
pageable host memory, the int8 calibration on the pool's first tiles (the
first slide's, as ``cli.infer`` calibrates), one warm ragged slide and the
head at the largest slide. The window sends the traffic's slide sizes in
the seed's order, each slide a contiguous view of the pool, until the
window's seconds are up and a whole block of sizes is done: every run times
whole blocks, the same multiset of slides in the seed's order.
``slide_tiles_per_s`` is their tiles over the time from the first slide's
start to the last one's end.

The check: the window's longest slide and others drawn from the seed, up to
the traffic's ``check_tiles`` in all, through the plain int8 ResNet50 and
the float32 head; the number compared is the largest gap of any class's
log-probability against class 0's, between the slide's answer and the
reference's logits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, trace, weights
from portbench.runners import Cell, Outcome, memory_peak, release, tensors
from portbench.reference import resnet_int8 as ref_r50
from portbench.reference.transmil import Head, precision


MAX_SLIDES = 4096  # more than any window sends


def run(cell: Cell) -> Outcome:
    cfg, tr, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    hw, chunk = int(cfg["tile_hw"]), int(cfg["chunk"])
    t0 = time.perf_counter()
    variables = weights.resnet50_variables(seed, dev)
    head_params = weights.transmil_params(seed, dev, cfg["in_features"], cfg["n_classes"])
    pool = weights.uint8_tiles(seed, dev, int(tr["pool_tiles"]), hw)
    calib = ref_r50.normalize(pool[:int(cfg["calib_tiles"])])
    sizes = generator.sizes(tr["sizes"], seed, MAX_SLIDES)
    offsets = generator.offsets_into(len(pool), sizes, seed)
    log = [f"[slide] set-up: weights and {len(pool)} pool tiles {time.perf_counter() - t0:.1f} s"]

    answers, window = [], {}
    if cell.side == "program":
        answers, window, pipe = _window(cell, variables, head_params, pool, calib, sizes,
                                        offsets, log)
        del pipe
    mem = memory_peak(dev)
    release(dev)

    # the window's longest slide, then others in the seed's order while they
    # fit the budget
    done = len(answers) if answers else int(tr["sizes"]["count"])
    longest = max(range(done), key=lambda i: sizes[i])
    budget, picked, total = int(tr["check_tiles"]), [], 0
    for i in generator.sample(done, seed, done, keep=(longest,)):
        n = sizes[i]
        if i == longest or total + n <= budget:
            picked.append(i)
            total += n
    t_ref = time.perf_counter()
    ref = _Reference(variables, head_params, calib, dev, "float32", 8)
    low = None
    if cell.side == "control":  # int4 weights and TF32: the next precision down
        low = _Reference(variables, head_params, calib, dev, "tf32", 4)
    gap, each = 0.0, []
    for i in picked:
        n, off = sizes[i], offsets[i]
        tiles = pool[off:off + n]
        want = ref.log_ratios(tiles, chunk)
        if low is not None:
            got = low.log_ratios(tiles, chunk)
        else:
            got = np.log(answers[i][1:]) - np.log(answers[i][0])
        each.append((n, float(np.max(np.abs(got - want)))))
        gap = max(gap, each[-1][1])
    log.append(f"[slide] check: {len(picked)} slides, {total} tiles, "
               f"{time.perf_counter() - t_ref:.1f} s")
    log.append(f"[slide] gaps (tiles, gap): {each}")
    work = {"slides": [s for s, _ in window.get("slides", [])], "chunk": chunk, "hw": hw,
            "in_features": cfg["in_features"], "checked": [sizes[i] for i in picked]}
    metrics = {}
    if window:
        metrics["slide_tiles_per_s"] = sum(work["slides"]) / window["seconds"]
    return Outcome(metrics=metrics, window_start=window.get("setup_done", 0.0),
                   attempted=len(answers), failed=0,
                   checks={"logit_gap": (gap, cell.limit("logit_gap"))},
                   work=work, trace=window.get("trace"), memory_peak_bytes=mem, log=log)


def _window(cell, variables, head_params, pool, calib, sizes, offsets, log):
    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.serving import head_from_params

    cfg, dev = cell.config, cell.device
    chunk = int(cfg["chunk"])
    t0 = time.perf_counter()
    head = head_from_params("TransMIL", head_params, cfg["in_features"], device=dev)
    pipe = SlideInferencePipeline(variables, head, calib_tiles=calib, chunk=chunk, device=dev)
    log.append(f"[slide] set-up: pipeline (calibration, kernels) {time.perf_counter() - t0:.1f} s")
    predict = pipe.predict_slide
    if cell.plant == "answer":  # every answer altered where it is produced
        def predict(tiles, _inner=pipe.predict_slide):
            p = _inner(tiles)
            z = np.log(p) + np.eye(len(p))[0]
            return np.exp(z) / np.exp(z).sum()
    # warm: a ragged two-chunk slide, then the head at the largest slide
    predict(pool[:chunk + 1])
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
                answers.append(predict(pool[off:off + n]))
            slides.append((n, off))
            if len(slides) % block == 0 and time.perf_counter() - start >= cell.seconds:
                break
        seconds = time.perf_counter() - start
    log.append(f"[slide] window: {len(slides)} slides, {sum(s for s, _ in slides)} tiles, "
               f"{seconds:.3f} s")
    return answers, {"slides": slides, "seconds": seconds, "setup_done": setup_done,
                     "trace": win.view()}, pipe


class _Reference:
    """The plain int8 ResNet50 and head at one precision."""

    def __init__(self, variables, head_params, calib, dev, mode: str, weight_bits: int) -> None:
        self.mode = mode
        with precision(mode):
            self.q = ref_r50.QResNet50(variables, calib, dev, weight_bits)
        self.head = Head(tensors(head_params, dev), mode)

    @torch.no_grad()
    def log_ratios(self, tiles: np.ndarray, chunk: int) -> np.ndarray:
        """Logit of every class less class 0's."""
        with precision(self.mode):
            feats = torch.cat([self.q.features(tiles[s:s + chunk])
                               for s in range(0, len(tiles), chunk)])
            z = self.head(feats[None])[0].double().cpu().numpy()
        return z[1:] - z[0]
