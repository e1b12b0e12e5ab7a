"""Stream time an optimizer step of the model's forward and loss
(``Trainer.train_step``'s ``self.loss``), from the program's
``train.forward`` span, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("train.forward")
    if not s or not ctx.work["steps"]:
        return None
    return s["device_s"] / ctx.work["steps"] * 1e3
