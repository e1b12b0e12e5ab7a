"""Stream time an optimizer step of reading the loss and the probabilities
back (``Trainer.train_step``'s ``loss.item()`` and ``.cpu()``, the
program's ``train.readback`` span): the softmax and the device-to-host
copies, ms. The span's host time is not read: ``loss.item()`` blocks until
the device has run the whole micro-step, so it is the host's wait for the
device's queue to drain, which grows as the host gets further ahead."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("train.readback")
    if not s or not ctx.work["steps"]:
        return None
    return s["device_s"] / ctx.work["steps"] * 1e3
