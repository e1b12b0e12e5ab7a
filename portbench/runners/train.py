"""Training steps through ``Trainer.train_step``, as ``cli.train`` runs them.

Set-up builds one training step object: the seeded TransMIL at the
configuration's precision, its optimizer and a ``Trainer``, and batches of
bags drawn from a seeded in-memory pool, staged onto the device by the
port's ``data/pipeline.device_prefetch`` as the Trainer stages them. It drives
that object through its first ``check_steps`` optimizer steps (the
micro-steps on bags that all differ), keeping each micro-step's loss, the
first gradient as the optimizer took it (its first moment after one step)
and the parameters after the last; then the window goes on with the same
object and the same feed. ``train_bags_per_s`` is the bags of every
optimizer step over the window's time.

The check: the reference follows the same steps from the same weights on
the same bags, with the same dropout masks (its own generator, seeded as the
Trainer seeds its dropout stream). Compared: each micro-step's loss; by the
worst leaf, the gap between the norms of the program's and the reference's
first gradient, and of their change over the steps, each against the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's take no part.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, trace, weights
from portbench.runners import Cell, Outcome, memory_peak, release, scratch_dir
from portbench.reference.radam import RAdam
from portbench.reference.transmil import Head, cross_entropy, precision

# the port's parameter names (models/transmil.py) -> the flax-layout leaves
PARAM_LEAVES = {
    "_fc1.0.weight": ("fc1_0", "kernel"), "_fc1.0.bias": ("fc1_0", "bias"),
    "_fc1.2.weight": ("fc1_norm0", "scale"), "_fc1.2.bias": ("fc1_norm0", "bias"),
    "_fc1.3.weight": ("fc1_1", "kernel"), "_fc1.3.bias": ("fc1_1", "bias"),
    "cls_token": ("cls_token",),
    "pos_layer.proj.weight": ("pos_layer", "proj"),
    "pos_layer.proj.bias": ("pos_layer", "proj_bias"),
    "pos_layer.proj1.weight": ("pos_layer", "proj1"),
    "pos_layer.proj1.bias": ("pos_layer", "proj1_bias"),
    "pos_layer.proj2.weight": ("pos_layer", "proj2"),
    "pos_layer.proj2.bias": ("pos_layer", "proj2_bias"),
    "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
    "_fc.weight": ("fc", "kernel"), "_fc.bias": ("fc", "bias"),
    **{f"{layer}.{name}": (layer, *path) for layer in ("layer1", "layer2") for name, path in {
        "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
        "attn.to_qkv.weight": ("attn", "to_qkv", "kernel"),
        "attn.to_out.0.weight": ("attn", "to_out", "kernel"),
        "attn.to_out.0.bias": ("attn", "to_out", "bias"),
        "attn.res_conv.weight": ("attn", "res_conv")}.items()},
}
DROPOUT = 0.7  # the out projection's (the reference dependency's TransLayer)


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


class Feed:
    """Micro-batches of ``batch`` bags from a seeded pool: bag ``j`` of the
    run is ``order[j % pool]``, so the first ``pool`` bags all differ."""

    def __init__(self, cell: Cell) -> None:
        cfg, tr = cell.config, cell.traffic
        self.batch, self.bag = (int(cfg["training"][k]) for k in ("batch_size", "bag_size"))
        pool = int(tr["pool_bags"])
        self.bags = weights.feature_rows(cell.seed, cell.device, pool * self.bag,
                                         int(cfg["in_features"])).reshape(pool, self.bag, -1)
        rng = generator.stream(cell.seed, 5)
        self.labels = rng.integers(0, int(cfg["n_classes"]), pool).astype(np.int64)
        self.order = rng.permutation(pool)

    def micro_batch(self, j: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.order[(np.arange(self.batch) + j * self.batch) % len(self.order)]
        return self.bags[idx], self.labels[idx]

    def __iter__(self):
        j = 0
        while True:
            yield self.micro_batch(j)
            j += 1


def run(cell: Cell) -> Outcome:
    cfg, tr, dev = cell.config["training"], cell.traffic, cell.device
    acc = int(cfg["grad_acc"])
    steps_checked = int(tr["check_steps"])
    params = weights.transmil_params(cell.seed, dev, cell.config["in_features"],
                                     cell.config["n_classes"])
    feed = Feed(cell)
    drop_seed = generator.stream(cell.seed, 6).integers(0, 2 ** 62)
    log: list = []
    if cell.side == "program":
        got, window = _program(cell, params, feed, int(drop_seed), log)
    else:
        got = _reference(cell, params, feed, int(drop_seed), "fp8")
        window = {}
    mem = memory_peak(dev)
    release(dev)
    t_ref = time.perf_counter()
    want = _reference(cell, params, feed, int(drop_seed), "bf16" if cfg["precision"] == "16-mixed"
                      else "float32")
    log.append(f"[train] check: {steps_checked} steps, {time.perf_counter() - t_ref:.1f} s")
    checks = compare(got, want, cell)
    micro = window.get("steps", 0) * acc
    work = {"steps": window.get("steps", 0), "micro_steps": micro, "batch": feed.batch,
            "bag": feed.bag, "in_features": int(cell.config["in_features"])}
    metrics = {}
    if window:
        metrics["train_bags_per_s"] = window["steps"] * acc * feed.batch / window["seconds"]
    return Outcome(metrics=metrics, window_start=window.get("setup_done", 0.0),
                   attempted=window.get("steps", 0), failed=0, checks=checks, work=work,
                   trace=window.get("trace"), memory_peak_bytes=mem, log=log)


def _program(cell: Cell, params: dict, feed: Feed, drop_seed: int, log: list):
    from transmil_deepgraft_tpu_torch.data.pipeline import device_prefetch
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
    from transmil_deepgraft_tpu_torch.utils.jax_params import head_state_dict_from_jax

    cfg, tr, dev = cell.config["training"], cell.traffic, cell.device
    n_classes, in_features = int(cell.config["n_classes"]), int(cell.config["in_features"])
    acc = int(cfg["grad_acc"])
    model = create_model("TransMIL", n_classes, in_features, device=dev,
                         use_pallas=bool(cfg["use_pallas"]), precision=cfg["precision"])
    model.load_state_dict(head_state_dict_from_jax("TransMIL", params, in_features, None))
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(PARAM_LEAVES):
        raise RuntimeError(f"the model's parameters are not TransMIL's: {sorted(names)}")
    opt = cfg["optimizer"]
    tx = create_optimizer(opt["opt"], lr=float(opt["lr"]), weight_decay=float(opt["weight_decay"]),
                          grad_accum_steps=acc)
    tx.init(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if cell.plant == "unchanged":  # a step that leaves the state as it was
        tx.step = lambda *a, **k: False
    tmp = scratch_dir()
    trainer = Trainer(model, tx, None, n_classes=n_classes,
                      loss_fn=create_loss(cfg["loss"]),
                      config=TrainerConfig(seed=drop_seed - 1, grad_acc=acc, log_dir=tmp.name),
                      model_name="TransMIL")
    staged = device_prefetch(iter(feed), dev, lambda b: b, 2)
    half = feed.batch // 2

    def micro_step():
        _, bags, labels = next(staged)
        if cell.plant == "half_batch":  # half of the batch left out
            bags, labels = bags[:half], labels[:half]
        return trainer.train_step(bags, labels)[0]

    losses, first = [], None
    for j in range(int(tr["check_steps"]) * acc):
        losses.append(micro_step())
        if j == acc - 1:
            b1 = tx.betas[0]
            first = {n: (m / (1 - b1)).detach().clone() for n, m in zip(names, tx.mu)}
    got = {"losses": losses, "first": {n: float(g.norm()) for n, g in first.items()},
           "change": {n: float((p.detach() - before[n]).norm())
                      for n, p in model.named_parameters()}}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_done = time.perf_counter()
    steps = 0
    with trace.Window(cell.trace) as win:
        start = time.perf_counter()
        while True:
            with trace.span("train.step"):
                for _ in range(acc):
                    micro_step()
            steps += 1
            if time.perf_counter() - start >= cell.seconds:
                break
        seconds = time.perf_counter() - start
    staged.close()
    tmp.cleanup()
    log.append(f"[train] window: {steps} optimizer steps, {seconds:.3f} s")
    return got, {"steps": steps, "seconds": seconds, "setup_done": setup_done,
                 "trace": win.view()}


def _reference(cell: Cell, params: dict, feed: Feed, drop_seed: int, mode: str) -> dict:
    cfg, tr, dev = cell.config["training"], cell.traffic, cell.device
    acc = int(cfg["grad_acc"])
    leaves = {n: torch.from_numpy(np.array(_leaf(params, path))).to(dev).requires_grad_()
              for n, path in PARAM_LEAVES.items()}
    tree: dict = {}
    for n, path in PARAM_LEAVES.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaves[n]
    start = {n: t.detach().clone() for n, t in leaves.items()}
    gen = torch.Generator(device=dev).manual_seed(drop_seed)
    head = Head(tree, mode, dropout=(DROPOUT, gen))
    opt = RAdam(list(leaves.values()), lr=float(cfg["optimizer"]["lr"]),
                weight_decay=float(cfg["optimizer"]["weight_decay"]))
    losses, first, raw_first = [], None, None
    for step in range(int(tr["check_steps"])):
        mean = [torch.zeros_like(t) for t in leaves.values()]
        for k in range(acc):
            bags, labels = feed.micro_batch(step * acc + k)
            with precision(mode):
                loss = cross_entropy(head(torch.from_numpy(bags).to(dev)),
                                     torch.from_numpy(labels).to(dev),
                                     int(cell.config["n_classes"]))
                grads = torch.autograd.grad(loss, list(leaves.values()))
                loss = loss.detach()
            losses.append(loss.item())
            mean = [m + g.float() / acc for m, g in zip(mean, grads)]
        taken = opt.step(mean)
        if step == 0:
            first = {n: float(g.norm()) for n, g in zip(leaves, taken)}
            raw_first = {n: float(g.norm()) for n, g in zip(leaves, mean)}
    change = {n: float((leaves[n].detach() - start[n]).norm()) for n in leaves}
    return {"losses": losses, "first": first, "change": change, "raw_first": raw_first}


def compare(got: dict, want: dict, cell: Cell) -> dict:
    """The three numbers compared, each with its limit."""
    raw = want["raw_first"]
    med = float(np.median(list(raw.values())))
    leaves = [n for n in raw if raw[n] >= 1e-3 * med]

    def worst(key: str) -> float:
        ref_med = float(np.median([want[key][n] for n in leaves]))
        return max(abs(got[key][n] - want[key][n]) / max(want[key][n], ref_med) for n in leaves)

    loss_gap = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap": (loss_gap, cell.limit("loss_gap")),
            "grad_gap": (worst("first"), cell.limit("grad_gap")),
            "update_gap": (worst("change"), cell.limit("update_gap"))}
