"""Stream time an optimizer step of the optimizer's update
(``Trainer.train_step``'s ``self.tx.step()``, gradient accumulation in it),
from the program's ``train.update`` span, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("train.update")
    if not s or not ctx.work["steps"]:
        return None
    return s["device_s"] / ctx.work["steps"] * 1e3
