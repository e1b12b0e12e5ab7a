"""TransMIL in plain PyTorch for features of another width than 2048, 1024
or 768: ``reference/transmil.Head`` with the DeepGraft reference's fc1 for
such widths, one Linear to 512 and GELU (github.com/Ycblue/TransMIL-DeepGraft
``code/models/TransMIL.py``; flax's ``fc1_0``). Everything after fc1 is
``Head``'s."""

from __future__ import annotations

import torch

from portbench.reference.transmil import Head


class Fc1Head(Head):
    def fc1(self, x: torch.Tensor) -> torch.Tensor:
        return self.gelu(self.dense(x.to(self.dt), self.p["fc1_0"]))
