"""AdaHessian's second-order piece (port of ``train/adahessian.py``): the
Hutchinson estimate of the Hessian's diagonal, ``E_z[z * (H z)]`` with
Rademacher ``z``, and :func:`adahessian`, the rule that takes it (an
``Optimizer`` of ``train/optimizers.py``, whose ``step`` takes the diagonal
as ``hessian=``; ``create_optimizer("adahessian")`` builds the same).

JAX takes ``H z`` forward-over-reverse (``jax.jvp`` of ``jax.grad``). The
port takes it reverse-over-reverse: the gradient with ``create_graph=True``,
then the gradient of ``<g, z>``, which is the same ``H z`` for the
symmetric Hessian of a scalar loss. The dense attention
(``ops/attention.softmax_attention``) runs its plain formula on the way,
since SDPA's memory-efficient backend has no double backward.

JAX's depthwise convolutions are ``jax.custom_vjp`` functions, which
forward-mode AD cannot enter, so the JAX package cannot take the diagonal of
any head that reaches them: TransMIL's, MDMIL's and CTMIL's PPEG and value
residual, ConvMixer's mixing convolutions. :func:`refuse_custom_vjp_heads`
raises the TypeError JAX raises there, on the modules that call the port's
``ops/depthwise`` (ROADMAP C18); the Trainer calls it for ``adahessian``.

The draw of ``z`` comes from a ``torch.Generator``; ``zs=`` hands in given
draws instead (the tests pass JAX's).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from transmil_deepgraft_tpu_torch.models.convmixer import DepthwiseConv2d
from transmil_deepgraft_tpu_torch.models.layers import PPEG, NystromAttentionLayer
from transmil_deepgraft_tpu_torch.ops.attention import plain_route
from transmil_deepgraft_tpu_torch.train.optimizers import Optimizer

# the modules whose forward calls ops/depthwise, as their JAX counterparts
# call its jax.custom_vjp convolutions
_CUSTOM_VJP_MODULES = (NystromAttentionLayer, PPEG, DepthwiseConv2d)


def adahessian(lr: float = 1e-1, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, hessian_power: float = 1.0) -> Optimizer:
    """JAX's ``adahessian``: Adam's moments over the gradient and the
    Hessian diagonal, the step ``-lr * mu_hat / (sqrt(nu_hat) **
    hessian_power + eps)``, decoupled weight decay on the >1-d tensors."""
    return Optimizer("adahessian", lr, weight_decay, betas=betas, eps=eps, momentum=0.9,
                     lookahead=False, grad_accum_steps=1, hessian_power=hessian_power)


def refuse_custom_vjp_heads(model: torch.nn.Module) -> None:
    """Raise the TypeError JAX's AdaHessian raises on ``model`` when it
    holds a module whose JAX counterpart calls a depthwise custom VJP
    (ROADMAP C18)."""
    found = sorted({type(m).__name__ for m in model.modules()
                    if isinstance(m, _CUSTOM_VJP_MODULES)})
    if found:
        raise TypeError(f"can't apply forward-mode autodiff (jvp) to a custom_vjp function: "
                        f"{', '.join(found)} call the JAX package's depthwise convolution "
                        f"(ops/depthwise.py), a jax.custom_vjp, so its AdaHessian cannot take "
                        f"this model's Hessian diagonal (ROADMAP C18)")


def rademacher(params: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None) -> list[torch.Tensor]:
    """One +-1 draw of each parameter's shape and dtype, from ``generator``
    (on the parameters' device)."""
    return [(torch.randint(0, 2, p.shape, generator=generator, device=p.device) * 2 - 1)
            .to(p.dtype) for p in params]


def _hvp_diag(grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor],
              zs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``z * (H z)`` from gradients taken with ``create_graph=True``; a
    parameter the loss does not reach has a zero diagonal."""
    reached = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
    diag = [torch.zeros_like(p) for p in params]
    if not reached:  # a loss linear in every parameter
        return diag
    hz = torch.autograd.grad([grads[i] for i in reached], [params[i] for i in reached],
                             grad_outputs=[zs[i] for i in reached], allow_unused=True)
    for i, h in zip(reached, hz):
        if h is not None:
            diag[i] = (h * zs[i]).detach()
    return diag


def value_grad_and_diag_hessian(loss_fn: Callable[[], torch.Tensor],
                                params: Sequence[torch.Tensor], *,
                                generator: Optional[torch.Generator] = None,
                                zs: Optional[Sequence[torch.Tensor]] = None,
                                has_aux: bool = False):
    """(loss, grads, diag) of ``loss_fn()`` (a closure over ``params``) in
    one forward and two backwards, the forward on the plain attention route.
    ``zs`` are the probes (default: :func:`rademacher` from ``generator``).
    With ``has_aux`` the closure returns ``(loss, aux)`` and the result is
    ``((loss, aux), grads, diag)``. Gradients are detached; a parameter the
    loss does not reach, or one that is frozen, gets zeros."""
    params = list(params)
    with plain_route():
        out = loss_fn()
    loss = out[0] if has_aux else out
    live = [i for i, p in enumerate(params) if p.requires_grad]
    taken = torch.autograd.grad(loss, [params[i] for i in live], create_graph=True,
                                allow_unused=True)
    grads: list[Optional[torch.Tensor]] = [None] * len(params)
    for i, g in zip(live, taken):
        grads[i] = g
    zs = list(zs) if zs is not None else rademacher(params, generator)
    diag = _hvp_diag(grads, params, zs)
    grads = [torch.zeros_like(p) if g is None else g.detach() for g, p in zip(grads, params)]
    return (tuple(t.detach() if torch.is_tensor(t) else t for t in out) if has_aux
            else loss.detach()), grads, diag


def hutchinson_diag_hessian(loss_fn: Callable[[], torch.Tensor], params: Sequence[torch.Tensor],
                            *, generator: Optional[torch.Generator] = None,
                            zs: Optional[Sequence[torch.Tensor]] = None) -> list[torch.Tensor]:
    """Single-probe Hutchinson estimate of diag(H) at ``params`` for the
    scalar ``loss_fn()``."""
    return value_grad_and_diag_hessian(loss_fn, params, generator=generator, zs=zs)[2]
