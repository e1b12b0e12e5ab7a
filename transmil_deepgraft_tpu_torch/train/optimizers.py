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

The rules (:data:`RULES`), each the JAX package's transformation:

- ``radam`` (coupled L2, then optax's ``scale_by_radam``: rectification
  threshold 5 on ``rho_t``, eps outside the square root), ``adam`` (coupled
  L2), ``adamw`` (decoupled), ``nadam`` (coupled L2, the reference's Nadam
  with its warming momentum schedule, ``nadam_ref``), ``lamb`` (optax's:
  Adam, decoupled decay, the per-tensor trust ratio);
- ``sgd`` (alias ``nesterov``) and ``momentum`` (coupled L2, optax's
  ``trace``); ``adamp`` and ``sgdp`` (the radial projection over the channel
  view, then the layer view, scaling the decay by ``wd_ratio``);
- ``adadelta`` (coupled L2, rho 0.9, eps 1e-6 unless ``opt_eps``),
  ``rmsprop`` (torch's: eps outside the square root, a zero-initialised RMS)
  and ``rmsproptf`` (eps inside, the RMS initialised to 1), both with the
  momentum trace;
- ``adafactor`` (fairseq's, ``adafactor_ref``: every >= 2-d tensor
  factored, the relative step when ``lr`` is 0, decoupled decay scaled by
  the step size);
- ``novograd``/``nvnovograd`` (optax's: per-tensor second moment, which
  the first step sets to ``||g||^2``; betas (0.95, 0.98) unless given; the
  decay inside the update, on the >1-d tensors only);
- ``adahessian`` (``train/adahessian.py``): Adam over the gradient and a
  Hutchinson estimate of the Hessian's diagonal, which :meth:`Optimizer.step`
  takes as ``hessian=``.

Scalars (bias corrections, schedules) are float32, as XLA computes them for
float32 parameters; a float64 parameter takes the Adams' bias corrections in
float64 (optax under x64). The rules whose arithmetic depends on a tensor's
layout (adafactor's factored moments, adamp/sgdp's channel view) see each
parameter in the flax layout of the JAX package (:func:`jax_layouts`): a
Linear weight as its (in, out) kernel, a conv weight as HWIO. They are
initialised with the module, which gives those layouts.

A ``lookahead_`` prefix wraps any rule. :func:`create_optimizer_from_config`
reads a config's ``Optimizer`` section.

:func:`create_dtfd_optimizer` is DTFD's pair of Adams, one a tier
(:class:`TwoTierOptimizer`), as JAX's ``optax.multi_transform``: coupled L2
on every parameter, biases included, and a step schedule.
:func:`create_scheduled_adamw` is ``optax.adamw`` over a schedule such as
:func:`cosine_decay_schedule` (SimCLR pretraining).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

RULES = ("radam", "adam", "adamw", "nadam", "lamb", "sgd", "momentum", "adamp", "sgdp",
         "adadelta", "rmsprop", "rmsproptf", "adafactor", "novograd", "adahessian")
LOOKAHEAD_SYNC_PERIOD, LOOKAHEAD_ALPHA = 6, 0.5  # the reference's timm Lookahead
_ADAMS = ("radam", "adam", "adamw", "nadam", "lamb", "adamp", "adahessian")
_COUPLED_L2 = ("radam", "adam", "nadam", "sgd", "momentum", "adadelta", "rmsprop", "rmsproptf")
# the per-parameter state of each rule besides the accumulator and lookahead
_SLOTS = {**{r: ("mu", "nu") for r in _ADAMS + ("novograd",)},
          "sgd": ("trace",), "momentum": ("trace",), "sgdp": ("trace",),
          "rmsprop": ("nu", "trace"), "rmsproptf": ("nu", "trace"),
          "adadelta": ("e_g", "e_x"), "adafactor": ("v_row", "v_col", "v", "mu")}
_DEFAULT_EPS = {"adadelta": 1e-6, "adafactor": 1e-30}
# the rules that factor or project each tensor in its flax layout
_LAYOUT_RULES = ("adafactor", "adamp", "sgdp")

# a parameter <-> its leaf in the JAX package's flax layout (the transforms
# of utils/jax_params.TO_TORCH / TO_FLAX)
_TO_JAX = {"id": lambda w: w, "T": lambda w: w.t(), "conv1d": lambda w: w[:, :, 0].t(),
           "conv": lambda w: w.permute(2, 3, 1, 0), "res_conv": lambda w: w[:, 0, :, 0].t()}
_FROM_JAX = {"id": lambda a: a, "T": lambda a: a.t(), "conv1d": lambda a: a.t()[:, :, None],
             "conv": lambda a: a.permute(3, 2, 0, 1),
             "res_conv": lambda a: a.t()[:, None, :, None]}


def weight_decay_mask(params: Sequence[torch.Tensor]) -> list[bool]:
    """True for parameters that receive weight decay: ndim > 1 (the
    reference's ``add_weight_decay`` skips 1-d tensors and biases)."""
    return [p.dim() > 1 for p in params]


def jax_layouts(module: torch.nn.Module) -> list[str]:
    """The flax layout of each of ``module``'s parameters (its
    ``parameters()`` order), as ``utils/jax_params`` carries weights across:
    a Linear weight (and a torch encoder's ``in_proj_weight``) is a Dense
    kernel ("T"), a kernel-1 Conv1d a Dense kernel too ("conv1d"), the
    Nystrom value residual's Conv2d a (ks, heads) array ("res_conv"), any
    other conv weight HWIO ("conv"), everything else as it is ("id")."""
    kinds = []
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            kind = "id"
            if name == "weight" and isinstance(mod, torch.nn.Linear) or name == "in_proj_weight":
                kind = "T"
            elif name == "weight" and isinstance(mod, torch.nn.Conv1d) and mod.kernel_size == (1,):
                kind = "conv1d"
            elif name == "weight" and isinstance(mod, torch.nn.Conv2d):
                kind = "res_conv" if mod_name.endswith("res_conv") else "conv"
            kinds.append(kind)
    return kinds


def _f32_pow(base: float, count) -> np.float32:
    """``base ** count`` in float32, as XLA computes a float32 power."""
    return np.float32(np.float64(np.float32(base)) ** np.float64(count))


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t) / math.sqrt(t.numel())


def _projection(p: torch.Tensor, g: torch.Tensor, perturb: torch.Tensor, delta: float,
                wd_ratio: float, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """AdamP/SGDP's radial projection (JAX ``_adamp_projection``, Heo 2021),
    tensors in the flax layout: the channel view (rows = the first axis),
    then the layer view, each firing when max |cos(g, p)| < delta /
    sqrt(view width); the first that fires projects the perturbation off p's
    radial direction and scales the weight decay by ``wd_ratio``."""
    picks = []
    for channel in (True, False):
        view = (lambda x: x.reshape(x.shape[0], -1)) if channel else (lambda x: x.reshape(1, -1))
        shape = (-1,) + (1,) * (p.dim() - 1) if channel else (1,) * p.dim()
        gv, pv = view(g), view(p)
        p_norm = torch.linalg.vector_norm(pv, dim=1)
        cos = (gv * pv).sum(1).abs() / ((torch.linalg.vector_norm(gv, dim=1) + eps)
                                        * (p_norm + eps))
        p_n = p / (p_norm.reshape(shape) + eps)
        picks.append((cos.max() < delta / math.sqrt(pv.shape[1]),
                      perturb - p_n * view(p_n * perturb).sum(1).reshape(shape)))
    (fires_c, proj_c), (fires_l, proj_l) = picks
    out = torch.where(fires_c, proj_c, torch.where(fires_l, proj_l, perturb))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    return out, torch.where(fires_c | fires_l, one * wd_ratio, one)


class Optimizer:
    """One optimizer of :func:`create_optimizer`: ``init(params)`` once,
    then ``step()`` after each micro-step's backward (it reads ``p.grad``;
    None is a zero gradient, on which weight decay still acts).
    ``grad_reduce``, when set, takes the accumulated gradients in place at
    each optimizer step before the rule (the Trainer averages them over
    data-parallel processes there)."""

    grad_reduce = None

    def __init__(self, rule: str, lr: float, weight_decay: float, betas: tuple[float, float],
                 eps: float, momentum: float, lookahead: bool, grad_accum_steps: int,
                 hessian_power: float = 1.0) -> None:
        if rule not in RULES:
            raise KeyError(f"unknown optimizer rule '{rule}'; the port has {RULES}")
        self.rule, self.lr, self.weight_decay = rule, lr, weight_decay
        self.betas, self.eps, self.momentum = betas, eps, momentum
        self.lookahead = lookahead
        self.grad_accum_steps = max(1, int(grad_accum_steps or 1))
        self.hessian_power = hessian_power  # adahessian's
        self.lr_scale = 1.0
        self.params: list[torch.Tensor] = []
        self.slots: dict[str, list[torch.Tensor]] = {}

    def init(self, params: Iterable[torch.Tensor] | torch.nn.Module) -> None:
        """Bind the parameters (a module's, or an iterable of them) and
        create the state: the rule's slots, lookahead slow weights, the
        accumulator, counters. The rules whose arithmetic depends on a
        tensor's layout (:data:`_LAYOUT_RULES`) take the module, whose
        :func:`jax_layouts` they read, and refuse bare parameters."""
        if isinstance(params, torch.nn.Module):
            layouts = jax_layouts(params)
            params = params.parameters()
        elif self.rule in _LAYOUT_RULES:
            raise TypeError(f"{self.rule} sees each tensor in its flax layout, which only the "
                            "module gives: init it with the module, not bare parameters")
        else:
            layouts = None
        self.params = list(params)
        self.layouts = layouts or ["id"] * len(self.params)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mask = weight_decay_mask(self.params)
        self.count = 0  # inner steps (completed accumulations)
        self.mini_step = 0
        self.acc = zeros()
        self.slots = {name: self._init_slot(name) for name in _SLOTS[self.rule]}
        self.m_schedule = 1.0  # nadam's running product of the momentum schedule
        self.slow = [p.detach().clone() for p in self.params] if self.lookahead else []
        self.lookahead_step = 0

    def _init_slot(self, name: str) -> list[torch.Tensor]:
        """One slot's initial tensors, in JAX's shapes: novograd's second
        moment is one scalar a tensor; adafactor's moments live in the flax
        layout (``v_row``/``v_col`` for a >= 2-d tensor, ``v`` for the
        others, ``mu`` only with a beta1), its unused ones are scalars."""
        out = []
        for p, kind in zip(self.params, self.layouts):
            full = torch.zeros_like(p)
            scalar = p.new_zeros(())
            if self.rule == "novograd" and name == "nu":
                out.append(scalar)
            elif self.rule == "rmsproptf" and name == "nu":
                out.append(torch.ones_like(p))
            elif self.rule == "adafactor":
                shape = _TO_JAX[kind](p).shape
                factored = len(shape) >= 2
                out.append({"v_row": p.new_zeros(shape[:-1]) if factored else scalar,
                            "v_col": p.new_zeros(shape[:-2] + shape[-1:]) if factored else scalar,
                            "v": scalar if factored else p.new_zeros(shape),
                            "mu": p.new_zeros(shape) if self.betas[0] is not None else scalar,
                            }[name])
            else:
                out.append(full)
        return out

    @property
    def mu(self) -> list[torch.Tensor]:
        return self.slots.get("mu", [])

    @property
    def nu(self) -> list[torch.Tensor]:
        return self.slots.get("nu", [])

    @torch.no_grad()
    def step(self, hessian: Optional[Sequence[torch.Tensor]] = None) -> bool:
        """Take one micro-step's gradients (and, for ``adahessian``, the
        micro-step's Hessian diagonal). Returns True when this micro-step
        completed an accumulation and the parameters moved.

        ``hessian`` reaches the rule as JAX's ``hessian_diag=`` reaches
        optax: lookahead's update takes no such argument (a TypeError, as
        ``lookahead_wrap.update`` raises), and under accumulation
        ``optax.chain`` drops it before ``MultiSteps`` (so adahessian then
        raises its ValueError) (ROADMAP C19)."""
        if hessian is not None and self.lookahead and self.grad_accum_steps == 1:
            raise TypeError("lookahead_wrap.<locals>.update() got an unexpected keyword "
                            "argument 'hessian_diag' (ROADMAP C19)")
        if self.grad_accum_steps > 1:
            hessian = None
        if self.rule == "adahessian" and hessian is None:
            raise ValueError("adahessian.update needs hessian_diag= (use "
                             "value_grad_and_diag_hessian; ROADMAP C19)")
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
        if self.grad_reduce is not None:  # data parallelism: the global batch's mean
            self.grad_reduce(self.acc)
        updates = [u * self.lr_scale for u in self._rule_updates(self.acc, hessian)]
        if self.lookahead:
            self._apply_lookahead(updates)
        else:
            for p, u in zip(self.params, updates):
                p.add_(u)
        for acc in self.acc:
            acc.zero_()
        return True

    # --------------------------------------------------------------- rules
    def _bias_corrections(self, g: torch.Tensor, *betas: float) -> list[float]:
        """``1 - b ** count`` for each beta: in float64 for a float64
        parameter, else the float32 value XLA computes (a Python float that
        a float32 tensor op takes exactly)."""
        if g.dtype == torch.float64:
            return [1 - b ** self.count for b in betas]
        return [float(np.float32(1) - _f32_pow(b, self.count)) for b in betas]

    def _rule_updates(self, grads: list[torch.Tensor],
                      hessian: Optional[Sequence[torch.Tensor]]) -> list[torch.Tensor]:
        """The inner update of each parameter (lr applied, lr_scale not)."""
        wd = self.weight_decay
        if wd and self.rule in _COUPLED_L2:
            grads = [g + wd * p if decay else g
                     for g, p, decay in zip(grads, self.params, self.mask)]
        return getattr(self, f"_{self.rule}")(grads, hessian)

    def _sgd(self, grads, _):
        trace, lr = self.slots["trace"], self.lr
        for i, g in enumerate(grads):
            trace[i] = g + self.momentum * trace[i]
        if self.rule == "momentum":
            return [t * -lr for t in trace]
        return [(g + self.momentum * t) * -lr for g, t in zip(grads, trace)]

    _momentum = _sgd

    def _moments(self, grads, second=None) -> None:
        """Adam's moment updates (the second over ``second``, default the
        gradients: AdaHessian's is over the Hessian diagonal)."""
        b1, b2 = self.betas
        mu, nu = self.slots["mu"], self.slots["nu"]
        for i, (g, s) in enumerate(zip(grads, second if second is not None else grads)):
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * s ** 2 + b2 * nu[i]

    def _adam(self, grads, _):
        b1, b2 = self.betas
        wd = self.weight_decay
        r = None
        if self.rule == "radam":
            ro_inf = np.float32(2.0 / (1.0 - b2) - 1.0)
            b2t = _f32_pow(b2, self.count)
            ro = ro_inf - np.float32(2 * self.count) * b2t / (np.float32(1) - b2t)
            if ro >= 5.0:  # optax's variance tractability threshold
                r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
        self._moments(grads)
        out = []
        for i, g in enumerate(grads):
            bc1, bc2 = self._bias_corrections(g, b1, b2)
            mu_hat, nu_hat = self.slots["mu"][i] / bc1, self.slots["nu"][i] / bc2
            if self.rule == "radam":
                u = mu_hat if r is None else float(r) * mu_hat / (torch.sqrt(nu_hat) + self.eps)
            else:
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.rule in ("adamw", "lamb") and wd and self.mask[i]:
                u = u + wd * self.params[i]
            if self.rule == "lamb":  # optax's scale_by_trust_ratio
                p_norm, u_norm = (torch.linalg.vector_norm(t) for t in (self.params[i], u))
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                u = u * ratio
            out.append(u * -self.lr)
        return out

    _radam = _adamw = _lamb = _adam

    def _nadam(self, grads, _):
        """The reference's Nadam (JAX ``nadam_ref``): the warming momentum
        schedule ``mu_t = b1 (1 - 0.5 * 0.96^(t * 0.004))`` and its running
        product, the gradient and momentum terms de-biased separately."""
        b1, b2 = self.betas
        f32 = np.float32
        t = f32(self.count)
        mu_t = f32(b1) * (f32(1) - f32(0.5) * f32(0.96) ** (t * f32(4e-3)))
        mu_t1 = f32(b1) * (f32(1) - f32(0.5) * f32(0.96) ** ((t + f32(1)) * f32(4e-3)))
        m_new = f32(self.m_schedule) * mu_t
        m_next = m_new * mu_t1
        self.m_schedule = float(m_new)
        self._moments(grads)
        bc2 = f32(1) - f32(b2) ** t
        c_g = float(f32(self.lr) * (f32(1) - mu_t) / (f32(1) - m_new))
        c_m = float(f32(self.lr) * mu_t1 / (f32(1) - m_next))
        out = []
        for g, m, v in zip(grads, self.slots["mu"], self.slots["nu"]):
            denom = torch.sqrt(v / float(bc2)) + self.eps
            out.append(-c_g * g / denom - c_m * m / denom)
        return out

    def _adahessian(self, grads, hessian):
        """AdaHessian (JAX ``train/adahessian.adahessian``): Adam's step with
        the second moment over the Hessian diagonal, its root raised to
        ``hessian_power``, the decay decoupled on the >1-d tensors."""
        b1, b2 = self.betas
        self._moments(grads, hessian)
        out = []
        for i, g in enumerate(grads):
            bc1, bc2 = self._bias_corrections(g, b1, b2)
            u = -self.lr * (self.slots["mu"][i] / bc1) / (
                torch.sqrt(self.slots["nu"][i] / bc2) ** self.hessian_power + self.eps)
            if self.weight_decay and self.mask[i]:
                u = u - self.lr * self.weight_decay * self.params[i]
            out.append(u)
        return out

    def _adamp(self, grads, _):
        """AdamP (JAX ``adamp``): Nesterov momentum over Adam's moments, the
        radial projection for >1-d tensors (wd_ratio 0.01, delta 0.1)."""
        b1, b2 = self.betas
        self._moments(grads)
        out = []
        for i, (g, p, kind) in enumerate(zip(grads, self.params, self.layouts)):
            bc1, bc2 = self._bias_corrections(g, b1, b2)
            m, v = self.slots["mu"][i], self.slots["nu"][i]
            perturb = (b1 * m + (1 - b1) * g) / (torch.sqrt(v / bc2) + self.eps)
            ratio = 1.0
            if p.dim() > 1:
                to, back = _TO_JAX[kind], _FROM_JAX[kind]
                proj, ratio = _projection(to(p), to(g), to(perturb), 0.1, 0.01, self.eps)
                perturb = back(proj)
            u = -(self.lr / bc1) * perturb
            if self.weight_decay and self.mask[i]:
                u = u - self.lr * self.weight_decay * ratio * p
            out.append(u)
        return out

    def _sgdp(self, grads, _):
        """SGDP (JAX ``sgdp``): Nesterov momentum, the radial projection
        (wd_ratio 0.1), decay scaled by ``1 / (1 - momentum)``."""
        mom, trace = self.momentum, self.slots["trace"]
        out = []
        for i, (g, p, kind) in enumerate(zip(grads, self.params, self.layouts)):
            trace[i] = mom * trace[i] + g
            d_p = g + mom * trace[i]
            ratio = 1.0
            if p.dim() > 1:
                to, back = _TO_JAX[kind], _FROM_JAX[kind]
                proj, ratio = _projection(to(p), to(g), to(d_p), 0.1, 0.1, self.eps)
                d_p = back(proj)
            u = -self.lr * d_p
            if self.weight_decay and self.mask[i]:
                u = u - (self.lr * self.weight_decay * ratio / (1.0 - mom)) * p
            out.append(u)
        return out

    def _adadelta(self, grads, _):
        """optax's ``scale_by_adadelta`` (rho 0.9), then ``-lr``."""
        rho, e_g, e_x = 0.9, self.slots["e_g"], self.slots["e_x"]
        out = []
        for i, g in enumerate(grads):
            e_g[i] = (1 - rho) * g ** 2 + rho * e_g[i]
            u = torch.sqrt(e_x[i] + self.eps) / torch.sqrt(e_g[i] + self.eps) * g
            e_x[i] = (1 - rho) * u ** 2 + rho * e_x[i]
            out.append(u * -self.lr)
        return out

    def _rmsprop(self, grads, _):
        """optax's ``scale_by_rms`` (decay 0.9; ``rmsprop``: eps outside the
        root over a zero-initialised RMS, ``rmsproptf``: eps inside over an
        RMS of ones), the momentum trace, ``-lr``."""
        nu, trace = self.slots["nu"], self.slots["trace"]
        out = []
        for i, g in enumerate(grads):
            nu[i] = (1 - 0.9) * g ** 2 + 0.9 * nu[i]
            if self.rule == "rmsproptf":
                u = torch.rsqrt(nu[i] + self.eps) * g
            else:
                u = g / (torch.sqrt(nu[i]) + self.eps)
            if self.momentum:
                trace[i] = u + self.momentum * trace[i]
                u = trace[i]
            out.append(u * -self.lr)
        return out

    _rmsproptf = _rmsprop

    def _novograd(self, grads, _):
        """optax's ``scale_by_novograd``: ``nu`` is one scalar a tensor (the
        first step's ``||g||^2``, then its moving average), ``mu =
        b1 mu + g / (sqrt(nu) + eps) + wd p`` (wd on the >1-d tensors: JAX's
        two disjoint masked instances), then ``-lr``."""
        b1, b2 = self.betas
        mu, nu = self.slots["mu"], self.slots["nu"]
        out = []
        for i, (g, p) in enumerate(zip(grads, self.params)):
            sq = torch.linalg.vector_norm(g) ** 2
            nu[i] = sq if self.count == 1 else (1 - b2) * sq + b2 * nu[i]
            step = g / (torch.sqrt(nu[i]) + self.eps)
            if self.weight_decay and self.mask[i]:
                step = step + self.weight_decay * p
            mu[i] = step if self.count == 1 else b1 * mu[i] + step
            out.append(mu[i] * -self.lr)
        return out

    def _adafactor(self, grads, _):
        """The reference's fairseq Adafactor (JAX ``adafactor_ref``), each
        tensor in its flax layout: ``beta2_t = 1 - t^-0.8``, eps added to
        g^2 before the factored means, the update clipped to RMS 1, the step
        ``lr`` (or, when ``lr`` is 0, ``min(1e-2, 1/sqrt(t)) * max(1e-3,
        RMS(p))``), an optional beta1 momentum, decoupled decay ``wd * lr_t *
        p`` on the >1-d tensors."""
        f32 = np.float32
        t = f32(self.count)
        beta2t = float(f32(1) - t ** f32(-0.8))
        beta1 = self.betas[0]
        s = self.slots
        out = []
        for i, (g, p, kind) in enumerate(zip(grads, self.params, self.layouts)):
            to = _TO_JAX[kind]
            g, pj = to(g), to(p)
            if self.lr:
                lr_t = self.lr
            else:
                lr_t = float(min(f32(1e-2), f32(1) / np.sqrt(t))) * torch.clamp(_rms(pj), min=1e-3)
            u = g * g + self.eps
            if g.dim() >= 2:
                s["v_row"][i] = beta2t * s["v_row"][i] + (1 - beta2t) * u.mean(-1)
                s["v_col"][i] = beta2t * s["v_col"][i] + (1 - beta2t) * u.mean(-2)
                row = s["v_row"][i]
                r_factor = torch.rsqrt(row / row.mean(-1, keepdim=True))[..., None]
                u = r_factor * torch.rsqrt(s["v_col"][i])[..., None, :] * g
            else:
                s["v"][i] = beta2t * s["v"][i] + (1 - beta2t) * u
                u = torch.rsqrt(s["v"][i]) * g
            u = u / torch.clamp(_rms(u) / 1.0, min=1.0)
            u = u * lr_t
            if beta1 is not None:
                s["mu"][i] = beta1 * s["mu"][i] + (1 - beta1) * u
                u = s["mu"][i]
            if self.weight_decay and self.mask[i]:
                u = u + self.weight_decay * lr_t * pj
            out.append(_FROM_JAX[kind](-u))
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
                "slow": self.slow, "lookahead_step": self.lookahead_step,
                "lr_scale": self.lr_scale, "m_schedule": self.m_schedule, **self.slots}

    def load_state_dict(self, state: dict) -> None:
        """Restore a state of :meth:`state_dict`'s layout (tensors are copied
        onto the parameters' devices; a slot the state lacks keeps its
        initial value)."""
        for key in ("count", "mini_step", "lookahead_step"):
            setattr(self, key, int(state[key]))
        self.lr_scale = float(state["lr_scale"])
        self.m_schedule = float(state.get("m_schedule", 1.0))

        def copied(key: str) -> list[torch.Tensor]:
            return [torch.as_tensor(t, dtype=p.dtype).to(p.device).clone()
                    for t, p in zip(state[key], self.params)]

        for key in ("acc", "slow"):
            if getattr(self, key) and len(state.get(key) or []):
                setattr(self, key, copied(key))
        for key in self.slots:
            if len(state.get(key) or []):
                self.slots[key] = copied(key)


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

    def _rule_updates(self, grads: list[torch.Tensor], hessian=None) -> list[torch.Tensor]:
        self.lr = self.schedule(self.count - 1)
        return super()._rule_updates(grads, hessian)


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
    JAX package's names and defaults: ``lookahead_`` wraps the rule, an apex
    ``fused`` prefix is dropped, weight decay is masked to >1-d parameters,
    ``grad_accum_steps > 1`` averages that many micro-steps' gradients into
    one step. ``adafactor`` with ``lr`` 0 takes the relative step; its
    ``opt_betas[0]`` is its beta1 (none by default)."""
    parts = opt.lower().split("_")
    use_lookahead = len(parts) > 1 and parts[0] == "lookahead"
    name = parts[-1].removeprefix("fused") or parts[-1]
    # one rule under two names each (JAX maps timm's novograd to NvNovoGrad)
    name = {"nesterov": "sgd", "nvnovograd": "novograd"}.get(name, name)
    if name not in RULES:
        raise KeyError(f"unknown optimizer '{opt}'")
    if name == "adafactor":
        betas = (opt_betas[0] if opt_betas else None, None)
    else:
        betas = tuple(opt_betas) if opt_betas else (
            (0.95, 0.98) if name == "novograd" else (0.9, 0.999))
    return Optimizer(
        name, lr, weight_decay, betas=betas,
        eps=opt_eps if opt_eps is not None else _DEFAULT_EPS.get(name, 1e-8),
        momentum=momentum if momentum is not None else 0.9,
        lookahead=use_lookahead, grad_accum_steps=grad_accum_steps,
    )


def create_optimizer_from_config(optimizer_cfg, grad_accum_steps: int = 1) -> Optimizer:
    """Build from a ``cfg.Optimizer`` section (``opt``, ``lr``, ``opt_eps``,
    ``opt_betas``, ``momentum``, ``weight_decay``), with the JAX package's
    defaults for the keys that are missing or null: a falsy ``lr`` is 2e-4,
    except for adafactor, where it selects the relative step (the
    reference's ``optim_factory.py:86-88``)."""
    opt = str(optimizer_cfg.opt or "lookahead_radam")
    relative = opt.lower().endswith("adafactor") and not optimizer_cfg.lr
    return create_optimizer(
        opt=opt,
        lr=0.0 if relative else float(optimizer_cfg.lr or 2e-4),
        weight_decay=float(optimizer_cfg.weight_decay or 0.0),
        momentum=optimizer_cfg.momentum or 0.9,
        opt_eps=optimizer_cfg.opt_eps or None,
        opt_betas=optimizer_cfg.opt_betas or None,
        grad_accum_steps=grad_accum_steps,
    )
