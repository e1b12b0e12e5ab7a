"""CLAM: attention MIL with instance-level clustering (port of
``models/clam.py``).

Ref ``code/models/model_clam.py:22-280``: a 512-d projection, a gated
attention net (one head, or one a class for CLAM_MB), the bag classifier
over the attention-pooled feature (CLAM_MB: one 1-logit classifier a class),
and per-class instance classifiers trained on the top-k / bottom-k attended
instances (``instance_eval``).

Parameter names are the reference's (``attention_net.0`` the projection,
``attention_net.{2,3}.attention_{a,b,c}`` the gate, ``classifiers``,
``instance_classifiers.<c>``). As in flax, whose instance classifiers exist
only when the model is initialized with ``instance_eval``, the port makes
them only with ``instance_classifiers=True``: the JAX Trainer never passes
``instance_eval``, so the heads it trains hold none, and the port's trains
the same tree on the bag loss alone.

One bag a call: a (1, N, D) input is squeezed, and a batch of more raises
(JAX keeps bag 0 of a batch without a word, ROADMAP C8).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import Dropout

SIZE_DICT = {"small": (1024, 512, 256), "big": (1024, 512, 384)}


def _instance_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None]).mean()


class AttnNetGated(nn.Module):
    """Gated attention scorer (ref ``model_clam.py:42-66``): (N, L) -> (N, heads)."""

    def __init__(self, l_dim: int = 512, d_dim: int = 256, n_heads: int = 1,
                 dropout: bool = False) -> None:
        super().__init__()
        drop = [Dropout(0.25)] if dropout else []
        self.attention_a = nn.Sequential(nn.Linear(l_dim, d_dim), nn.Tanh(), *drop)
        drop = [Dropout(0.25)] if dropout else []
        self.attention_b = nn.Sequential(nn.Linear(l_dim, d_dim), nn.Sigmoid(), *drop)
        self.attention_c = nn.Linear(d_dim, n_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_c(self.attention_a(x) * self.attention_b(x))


class CLAM_SB(nn.Module):
    """Single-branch CLAM (ref ``model_clam.py:71-193``) on one bag."""

    flax_classifier = "classifiers"  # the flax name of the (width, n_classes) classifier
    gives_attention = True  # return_attn gives the (heads, N) attention
    multi_branch = False

    def __init__(self, n_classes: int = 2, in_features: int = 1024, size_arg: str = "small",
                 k_sample: int = 8, dropout: bool = False, subtyping: bool = False,
                 instance_classifiers: bool = False) -> None:
        super().__init__()
        _, width, d_dim = SIZE_DICT[size_arg]
        self.n_classes, self.k_sample = n_classes, k_sample
        self.dropout, self.subtyping = dropout, subtyping
        heads = n_classes if self.multi_branch else 1
        self.attention_net = nn.Sequential(
            nn.Linear(in_features, width), nn.ReLU(), *([Dropout(0.25)] if dropout else []),
            AttnNetGated(width, d_dim, heads, dropout))
        if self.multi_branch:
            self.classifiers = nn.ModuleList(nn.Linear(width, 1) for _ in range(n_classes))
        else:
            self.classifiers = nn.Linear(width, n_classes)
        if instance_classifiers:
            self.instance_classifiers = nn.ModuleList(
                nn.Linear(width, 2) for _ in range(n_classes))

    def forward(self, h: torch.Tensor, label: Optional[torch.Tensor] = None,
                instance_eval: bool = False, return_attn: bool = False):
        """(N, D) or (1, N, D) -> (1, C) logits; ``return_attn`` adds the
        (heads, N) attention, ``instance_eval`` the instance loss of
        ``label`` (a class index)."""
        if h.dim() == 3:
            if h.shape[0] != 1:
                raise ValueError(f"CLAM processes one bag at a time (got batch={h.shape[0]}); "
                                 "the JAX head keeps bag 0 of a batch (ROADMAP C8)")
            h = h[0]
        h = self.attention_net[:-1](h.float())
        a = self.attention_net[-1](h).t()  # (heads, N)
        attn = torch.softmax(a, dim=-1)
        m = attn @ h  # (heads, width)
        if self.multi_branch:
            logits = torch.stack([clf(m[c])[0] for c, clf in enumerate(self.classifiers)])[None]
        else:
            logits = self.classifiers(m[0])[None]

        inst_loss = h.new_zeros(())
        if instance_eval:
            inst_loss = self._instance_loss(h, a, label)
        if return_attn:
            return logits, attn
        if instance_eval:
            return logits, inst_loss
        return logits

    def _instance_loss(self, h: torch.Tensor, a: torch.Tensor,
                       label: Optional[torch.Tensor]) -> torch.Tensor:
        """The instance classifiers on the top-k / bottom-k attended
        instances: in-class top -> 1, bottom -> 0; out-of-class top -> 0
        (with ``subtyping``). Ties in the scores rank as ``torch.topk``
        ranks them (JAX's ``lax.top_k`` may pick other tied rows)."""
        if not hasattr(self, "instance_classifiers"):
            raise ValueError("instance_eval needs the instance classifiers: build the head "
                             "with instance_classifiers=True")
        k = min(self.k_sample, h.shape[0])
        one_hot = (F.one_hot(torch.as_tensor(label, device=h.device).reshape(()),
                             self.n_classes).float()
                   if label is not None else h.new_zeros(self.n_classes))
        ones = torch.ones(k, dtype=torch.long, device=h.device)
        losses = []
        for c, clf in enumerate(self.instance_classifiers):
            scores = a[c if self.multi_branch else 0]
            top = h[torch.topk(scores, k).indices]
            bottom = h[torch.topk(-scores, k).indices]
            loss_in = _instance_ce(clf(torch.cat([top, bottom])), torch.cat([ones, 0 * ones]))
            loss_out = _instance_ce(clf(top), 0 * ones)
            if self.subtyping:
                losses.append(one_hot[c] * loss_in + (1.0 - one_hot[c]) * loss_out)
            else:
                losses.append(one_hot[c] * loss_in)
        loss = torch.stack(losses).sum()
        return loss / self.n_classes if self.subtyping else loss


class CLAM_MB(CLAM_SB):
    """Multi-branch CLAM (ref ``model_clam.py:195-280``): one attention head
    and one 1-logit classifier a class."""

    flax_classifier = "classifier_{}"  # one (width, 1) classifier a class
    multi_branch = True
