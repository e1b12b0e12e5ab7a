"""RAdam with coupled L2 and gradient accumulation, in plain PyTorch.

The configuration's optimizer (``radam``, lr 1e-4, weight decay 0.01,
grad_acc 2) as optax builds it (Liu et al., ICLR 2020, optax's
``scale_by_radam``): the mean of the micro-steps' gradients; the decay
added to the gradient of every parameter of more than one dimension; Adam's
moments (0.9, 0.999); the rectified step when rho_t >= 5, else the
bias-corrected first moment alone; eps 1e-8 outside the square root.
"""

from __future__ import annotations

import math

import torch


class RAdam:
    def __init__(self, params: list[torch.Tensor], lr: float = 1e-4, weight_decay: float = 0.01,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8) -> None:
        self.params = params
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Apply one step on the accumulated (mean) gradients; returns the
        gradients as the rule takes them (decay included)."""
        b1, b2 = self.betas
        self.count += 1
        t = self.count
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        taken = []
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.wd and p.dim() > 1:
                g = g + self.wd * p
            taken.append(g)
            self.mu[i] = b1 * self.mu[i] + (1 - b1) * g
            self.nu[i] = b2 * self.nu[i] + (1 - b2) * g * g
            mu_hat = self.mu[i] / (1 - b1 ** t)
            if rho >= 5.0:
                nu_hat = self.nu[i] / (1 - b2 ** t)
                r = math.sqrt((rho - 4) * (rho - 2) * rho_inf
                              / ((rho_inf - 4) * (rho_inf - 2) * rho))
                u = r * mu_hat / (nu_hat.sqrt() + self.eps)
            else:
                u = mu_hat
            p.add_(-self.lr * u)
        return taken
