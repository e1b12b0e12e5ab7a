"""Optimizer factory (port of ``train/optimizers.py``).

The JAX package builds an optax chain; :func:`create_optimizer` builds the
same arithmetic in torch, written out so that it follows optax step for step:

  [MultiSteps: average the gradients of ``grad_accum_steps`` micro-steps]
    -> [lookahead_wrap (k 6, alpha 0.5):
         rule (with weight decay on the >1-d parameters) -> lr_scale]
    -> p + update

``lr_scale`` is the plateau scale the trainer mutates (``mutable_lr_scale``
in JAX); with lookahead it scales the inner update, not the sync jump, as in
the reference (timm Lookahead exposes the inner param_groups). Every
micro-step that does not complete an accumulation leaves the parameters as
they are, and the inner step counter advances once per completed
accumulation, as ``optax.MultiSteps`` does.

The rules: ``radam`` (coupled L2 weight decay, then optax's
``scale_by_radam``: rectification threshold 5 on the variance tractability
``rho_t``, eps outside the square root, ``rho_t`` and the bias corrections in
float32; the Adams' bias corrections are float64 for a float64 parameter),
``adam`` (coupled L2), ``adamw`` (decoupled), ``sgd`` (alias
``nesterov``) and ``momentum`` (coupled L2, optax's ``trace``). A ``lookahead_`` prefix
wraps any of them; any other name raises ``KeyError`` (the other rules are
ROADMAP A5). :func:`create_optimizer_from_config` reads a config's
``Optimizer`` section.

:func:`create_dtfd_optimizer` is DTFD's pair of Adams, one a tier
(:class:`TwoTierOptimizer`), as JAX's ``optax.multi_transform``: coupled L2
on every parameter, biases included, and a step schedule.
:func:`create_scheduled_adamw` is ``optax.adamw`` over a schedule such as
:func:`cosine_decay_schedule` (SimCLR pretraining).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

RULES = ("radam", "adam", "adamw", "sgd", "momentum")
LOOKAHEAD_SYNC_PERIOD, LOOKAHEAD_ALPHA = 6, 0.5  # the reference's timm Lookahead


def weight_decay_mask(params: Sequence[torch.Tensor]) -> list[bool]:
    """True for parameters that receive weight decay: ndim > 1 (the
    reference's ``add_weight_decay`` skips 1-d tensors and biases)."""
    return [p.dim() > 1 for p in params]


def _f32_pow(base: float, count: int) -> np.float32:
    """``base ** count`` in float32, as XLA computes a float32 power."""
    return np.float32(np.float64(np.float32(base)) ** count)


class Optimizer:
    """One optimizer of :func:`create_optimizer`: ``init(params)`` once,
    then ``step()`` after each micro-step's backward (it reads ``p.grad``;
    None is a zero gradient, on which weight decay still acts)."""

    def __init__(self, rule: str, lr: float, weight_decay: float, betas: tuple[float, float],
                 eps: float, momentum: float, lookahead: bool, grad_accum_steps: int) -> None:
        if rule not in RULES:
            raise KeyError(f"unknown optimizer rule '{rule}'; the port has {RULES}")
        self.rule, self.lr, self.weight_decay = rule, lr, weight_decay
        self.betas, self.eps, self.momentum = betas, eps, momentum
        self.lookahead = lookahead
        self.grad_accum_steps = max(1, int(grad_accum_steps or 1))
        self.lr_scale = 1.0
        self.params: list[torch.Tensor] = []

    def init(self, params: Iterable[torch.Tensor] | torch.nn.Module) -> None:
        """Bind the parameters (a module's, or an iterable of them) and
        create the state: moments (or the momentum trace), lookahead slow
        weights, the accumulator, counters."""
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        self.params = list(params)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mask = weight_decay_mask(self.params)
        self.count = 0  # inner steps (completed accumulations)
        self.mini_step = 0
        self.acc = zeros()
        self.mu, self.nu = (zeros(), zeros()) if self.rule in ("radam", "adam", "adamw") else ([], [])
        self.trace = zeros() if self.rule in ("sgd", "momentum") else []
        self.slow = [p.detach().clone() for p in self.params] if self.lookahead else []
        self.lookahead_step = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Take one micro-step's gradients. Returns True when this micro-step
        completed an accumulation and the parameters moved."""
        n = self.mini_step
        for acc, p in zip(self.acc, self.params):
            # optax.MultiSteps' running mean; a parameter the loss does not
            # reach (a frozen backbone) has the zero gradient JAX gives it
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        if n < self.grad_accum_steps - 1:
            self.mini_step += 1
            return False
        self.mini_step = 0
        self.count += 1
        updates = self._rule_updates(self.acc)
        if self.lookahead:
            self._apply_lookahead(updates)
        else:
            for p, u in zip(self.params, updates):
                p.add_(u)
        for acc in self.acc:
            acc.zero_()
        return True

    def _rule_updates(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The inner update of each parameter (lr and lr_scale applied)."""
        wd, lr = self.weight_decay, self.lr
        coupled = self.rule != "adamw"
        grads = [g + wd * p if (wd and decay and coupled) else g
                 for g, p, decay in zip(grads, self.params, self.mask)]
        if self.rule in ("sgd", "momentum"):
            out = []
            for i, g in enumerate(grads):
                self.trace[i] = g + self.momentum * self.trace[i]
                u = g + self.momentum * self.trace[i] if self.rule != "momentum" else self.trace[i]
                out.append(u * -lr * self.lr_scale)
            return out
        b1, b2 = self.betas
        # the bias corrections in float32, as XLA computes them for float32
        # parameters; a float64 parameter takes them in float64 (optax under x64)
        bc = {torch.float64: (1 - b1 ** self.count, 1 - b2 ** self.count)}
        bc32 = (torch.tensor(1 - _f32_pow(b1, self.count)),
                torch.tensor(1 - _f32_pow(b2, self.count)))
        r = None
        if self.rule == "radam":
            ro_inf = np.float32(2.0 / (1.0 - b2) - 1.0)
            b2t = _f32_pow(b2, self.count)
            ro = ro_inf - np.float32(2 * self.count) * b2t / (np.float32(1) - b2t)
            if ro >= 5.0:  # optax's variance tractability threshold
                r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
        out = []
        for i, g in enumerate(grads):
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * g ** 2 + b2 * self.nu[i]
            bc1, bc2 = bc.get(g.dtype) or (bc32[0].to(g.device), bc32[1].to(g.device))
            mu_hat, nu_hat = self.mu[i] / bc1, self.nu[i] / bc2
            if self.rule == "radam":
                u = mu_hat if r is None else float(r) * mu_hat / (torch.sqrt(nu_hat) + self.eps)
            else:
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.rule == "adamw" and wd and self.mask[i]:
                u = u + wd * self.params[i]
            out.append(u * -lr * self.lr_scale)
        return out

    def _apply_lookahead(self, updates: list[torch.Tensor]) -> None:
        """Lookahead (Zhang 2019): every 6th inner step the fast weights land
        at ``slow + 0.5 * (fast - slow)`` and the slow weights sync there."""
        self.lookahead_step += 1
        sync = self.lookahead_step % LOOKAHEAD_SYNC_PERIOD == 0
        for i, (p, u) in enumerate(zip(self.params, updates)):
            fast = p + u
            if sync:
                fast = self.slow[i] + LOOKAHEAD_ALPHA * (fast - self.slow[i])
                self.slow[i] = fast.clone()
            p.add_(fast - p)

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "acc": self.acc,
                "mu": self.mu, "nu": self.nu, "trace": self.trace, "slow": self.slow,
                "lookahead_step": self.lookahead_step, "lr_scale": self.lr_scale}

    def load_state_dict(self, state: dict) -> None:
        """Restore a state of :meth:`state_dict`'s layout (tensors are copied
        onto the parameters' devices)."""
        for key in ("count", "mini_step", "lookahead_step"):
            setattr(self, key, int(state[key]))
        self.lr_scale = float(state["lr_scale"])
        for key in ("acc", "mu", "nu", "trace", "slow"):
            if getattr(self, key) and len(state[key]):
                setattr(self, key, [torch.as_tensor(t, dtype=p.dtype).to(p.device).clone()
                                    for t, p in zip(state[key], self.params)])


class _ScheduledAdam(Optimizer):
    """Adam (``rule`` 'adam': coupled L2, optax's ``add_decayed_weights ->
    scale_by_adam``; 'adamw': decoupled, ``optax.adamw``) with weight decay on
    every parameter and the learning rate of ``schedule(count)`` (count = the
    updates before this one, so the first update takes ``schedule(0)``), as
    optax's ``scale_by_schedule``."""

    def __init__(self, schedule, weight_decay: float, rule: str = "adam") -> None:
        super().__init__(rule, 0.0, weight_decay, betas=(0.9, 0.999), eps=1e-8,
                         momentum=0.9, lookahead=False, grad_accum_steps=1)
        self.schedule = schedule

    def init(self, params) -> None:
        super().init(params)
        self.mask = [True] * len(self.params)  # biases and norms decay too

    def _rule_updates(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        self.lr = self.schedule(self.count - 1)
        return super()._rule_updates(grads)


class TwoTierOptimizer:
    """DTFD's two optimizers (ref ``model_interface_dtfd.py:594-607``): one
    :class:`_ScheduledAdam` over tier 1 (dimreduction, attention,
    classifier) and one over tier 2 (``attCls``), split by the model's
    ``parameter_groups()``, so :meth:`init` takes the model. The trainer's
    plateau ``lr_scale`` scales both."""

    grad_accum_steps = 1  # no accumulation, as JAX's (General.grad_acc is not applied)

    def __init__(self, schedule, weight_decay: float) -> None:
        self.tiers = (_ScheduledAdam(schedule, weight_decay),
                      _ScheduledAdam(schedule, weight_decay))
        self.params: list[torch.Tensor] = []

    def init(self, model: torch.nn.Module) -> None:
        if not hasattr(model, "parameter_groups"):
            raise TypeError("the DTFD optimizer takes the DTFD model, whose parameter_groups() "
                            "split its two tiers")
        for tier, params in zip(self.tiers, model.parameter_groups()):
            tier.init(params)
        self.params = [p for tier in self.tiers for p in tier.params]

    @property
    def lr_scale(self) -> float:
        return self.tiers[0].lr_scale

    @lr_scale.setter
    def lr_scale(self, value: float) -> None:
        for tier in self.tiers:
            tier.lr_scale = value

    def step(self) -> bool:
        return all([tier.step() for tier in self.tiers])

    def state_dict(self) -> dict:
        return {"tier1": self.tiers[0].state_dict(), "tier2": self.tiers[1].state_dict()}

    def load_state_dict(self, state: dict) -> None:
        for tier, key in zip(self.tiers, ("tier1", "tier2")):
            tier.load_state_dict(state[key])


def create_dtfd_optimizer(steps_per_epoch: int, lr: float = 1e-4, weight_decay: float = 1e-2,
                          milestone_epochs: Sequence[float] = (100,),
                          gamma: float = 0.2) -> TwoTierOptimizer:
    """DTFD's two-tier Adam (JAX ``create_dtfd_optimizer``): Adam(lr, coupled
    L2 ``weight_decay`` on every parameter) a tier, each with
    MultiStepLR(``milestone_epochs``, ``gamma``) as optax's
    ``piecewise_constant_schedule``: from update ``int(e * steps_per_epoch)``
    on (counting from 0) the rate is multiplied by ``gamma``, in float32."""
    boundaries = sorted(int(e * steps_per_epoch) for e in milestone_epochs)

    def schedule(count: int) -> float:
        v = np.float32(lr)
        for b in boundaries:
            if count >= b:
                v = np.float32(v * np.float32(gamma))
        return float(v)

    return TwoTierOptimizer(schedule, weight_decay)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + np.cos(np.pi * c / decay_steps)) + alpha)

    return schedule


def create_scheduled_adamw(params: Iterable[torch.Tensor] | torch.nn.Module, schedule,
                           weight_decay: float) -> Optimizer:
    """``optax.adamw(schedule, weight_decay)`` over ``params``: decoupled
    weight decay on every parameter (optax's default mask), the learning
    rate of ``schedule(count)``."""
    tx = _ScheduledAdam(schedule, weight_decay, rule="adamw")
    tx.init(params)
    return tx


def create_optimizer(opt: str = "lookahead_radam", lr: float = 2e-4, weight_decay: float = 0.01,
                     momentum: Optional[float] = 0.9, opt_eps: Optional[float] = None,
                     opt_betas: Optional[tuple[float, float]] = None, grad_accum_steps: int = 1,
                     **_) -> Optimizer:
    """Build an optimizer from config fields (``cfg.Optimizer``), with the
    JAX package's names and defaults: ``lookahead_`` wraps the rule, weight
    decay is masked to >1-d parameters, ``grad_accum_steps > 1`` averages
    that many micro-steps' gradients into one step."""
    parts = opt.lower().split("_")
    use_lookahead = len(parts) > 1 and parts[0] == "lookahead"
    name = parts[-1].removeprefix("fused") or parts[-1]
    name = {"nesterov": "sgd"}.get(name, name)  # the same rule under two names
    if name not in RULES:
        raise KeyError(f"optimizer '{opt}' is not ported yet (ROADMAP A5); the port has "
                       f"{RULES} (with a lookahead_ prefix)")
    return Optimizer(
        name, lr, weight_decay,
        betas=tuple(opt_betas) if opt_betas else (0.9, 0.999),
        eps=opt_eps if opt_eps is not None else 1e-8,
        momentum=momentum if momentum is not None else 0.9,
        lookahead=use_lookahead, grad_accum_steps=grad_accum_steps,
    )


def create_optimizer_from_config(optimizer_cfg, grad_accum_steps: int = 1) -> Optimizer:
    """Build from a ``cfg.Optimizer`` section (``opt``, ``lr``, ``opt_eps``,
    ``opt_betas``, ``momentum``, ``weight_decay``), with the JAX package's
    defaults for the keys that are missing or null."""
    return create_optimizer(
        opt=str(optimizer_cfg.opt or "lookahead_radam"),
        lr=float(optimizer_cfg.lr or 2e-4),
        weight_decay=float(optimizer_cfg.weight_decay or 0.0),
        momentum=optimizer_cfg.momentum or 0.9,
        opt_eps=optimizer_cfg.opt_eps or None,
        opt_betas=optimizer_cfg.opt_betas or None,
        grad_accum_steps=grad_accum_steps,
    )
