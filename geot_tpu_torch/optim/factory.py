"""The optimizer family (``geot_tpu/optim/factory.py:85-224``,
``optim/extra.py``, ``optim/adahessian.py``) and the epoch-indexed
learning-rate schedules (``:228-398``).

``build_optimizer_from_cfg(module, lr, NAME=..., every_k=1, **kw)`` returns
a ``ChainOptimizer`` over ``module``'s trainable parameters. Its
``step()`` runs, for every name that ``geot_tpu``'s factory registers,
optax's algorithm (not torch's namesake), with ``geot_tpu``'s defaults and
weight-decay masks, as a chain of transforms over the parameter list:

- the optimizer of ``NAME`` (``adamw``, ``adam``, ``sgd``/``momentum``,
  ``lamb``, ``lars``, ``adabelief``, ``radam``, ``nadam``,
  ``novograd``/``nvnovograd``, ``adafactor``, ``rmsprop``/``rmsprop_tf``/
  ``rmsproptf``, and ``adamp``, ``sgdp``, ``madgrad``, ``adahessian`` of
  ``optim/extra.py`` and ``optim/adahessian.py``), the learning rate
  included;
- ``lookahead`` for a ``lookahead_<name>`` / ``lookahead<name>``;
- the layer-decay scale for ``0 < layer_decay < 1``, which also scales a
  lookahead sync step, as ``geot_tpu``'s chain does;
- ``every_k > 1`` (``cfg.step_per_update``) wraps the chain as
  ``optax.MultiSteps`` does: the running mean of each group of k
  gradients is applied at the group's last step, and the other steps
  change nothing but the accumulator.

The learning rate is a param group's ``lr``, rounded to float32 as
``inject_hyperparams`` stores it; ``set_learning_rate`` sets it per epoch.
Scalars that ``geot_tpu`` computes in float32 (the bias corrections of the
``extra.py`` optimizers, adafactor's decay) are rounded alike. The
parameters are split into two param groups, decayed and not, each with its
``weight_decay`` (0 where the optimizer's mask leaves a parameter out).
The state is per parameter (``opt.state[p]``): ``step`` (the updates
applied), the transforms' buffers, and under ``every_k`` ``mini_step`` and
``acc``; ``state_dict`` / ``load_state_dict`` carry all of it.
"""
from __future__ import annotations

import bisect
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]


@dataclass
class Ctx:
    """What one update of the chain sees: its number (1 for the first),
    the learning rate, each parameter's weight decay (0 where the mask
    leaves it out), each parameter's permutation into ``geot_tpu``'s
    layout (None where it is the port's; ``kernel_axes``) and, for
    AdaHessian, each parameter's Hessian diagonal."""
    count: int
    lr: float
    wd: List[float]
    axes: List[Optional[Tuple[int, ...]]]
    hessian: Optional[Sequence[torch.Tensor]] = None


class Transform:
    """One optax transform over the parameter list: ``init(p)`` gives its
    state entries for one parameter; ``update(us, ps, sts, ctx)`` returns
    the transformed updates and updates the entries in place."""

    def init(self, p: torch.Tensor) -> Dict[str, Any]:
        return {}

    def update(self, us: Tensors, ps: Tensors, sts: List[Dict[str, Any]],
               ctx: Ctx) -> Tensors:
        raise NotImplementedError


def np_float(dtype: torch.dtype):
    """The numpy scalar type that rounds like ``dtype``'s arithmetic."""
    return np.float64 if dtype == torch.float64 else np.float32


def bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """``1 - decay ** count`` in the parameters' precision, as optax's
    ``tree_bias_correction`` computes it."""
    f = np_float(dtype)
    return float(f(1) - f(decay) ** f(count))


def f32_bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as ``geot_tpu``'s own optimizers
    compute it (``count.astype(float32)``) whatever the parameters'
    dtype."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class ScaleByAdam(Transform):
    """``optax.scale_by_adam`` (``nesterov``: NAdam's look-ahead first
    moment)."""

    def __init__(self, b1: float, b2: float, eps: float,
                 eps_root: float = 0.0, nesterov: bool = False):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.eps_root, self.nesterov = eps_root, nesterov

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        b1, b2 = self.b1, self.b2
        mu = [s["exp_avg"] for s in sts]
        nu = [s["exp_avg_sq"] for s in sts]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(us, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(us, us), 1 - b2))
        dt = ps[0].dtype
        c = ctx.count
        if self.nesterov:
            mu_hat = torch._foreach_add(
                torch._foreach_mul(torch._foreach_div(
                    mu, bias_correction(b1, c + 1, dt)), b1),
                torch._foreach_mul(torch._foreach_div(
                    us, bias_correction(b1, c, dt)), 1 - b1))
        else:
            mu_hat = torch._foreach_div(mu, bias_correction(b1, c, dt))
        nu_hat = torch._foreach_div(nu, bias_correction(b2, c, dt))
        if self.eps_root:
            torch._foreach_add_(nu_hat, self.eps_root)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        return torch._foreach_div(mu_hat, denom)


class AddDecayedWeights(Transform):
    """``optax.add_decayed_weights`` with the factory's mask: ``u + wd *
    p`` for each parameter whose group decays."""

    def update(self, us, ps, sts, ctx):
        return [u + wd * p if wd else u
                for u, p, wd in zip(us, ps, ctx.wd)]


class ScaleByLearningRate(Transform):
    """``optax.scale_by_learning_rate``: ``-lr * u`` (``sign=1``: adafactor's
    unflipped ``lr * u``)."""

    def __init__(self, sign: float = -1.0):
        self.sign = sign

    def update(self, us, ps, sts, ctx):
        return torch._foreach_mul(us, self.sign * ctx.lr)


class Trace(Transform):
    """``optax.trace``: ``t = u + decay * t``; the update is ``t``, or
    ``u + decay * t`` with Nesterov."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, p):
        return {"momentum_buffer": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        out = []
        for u, s in zip(us, sts):
            t = u + self.decay * s["momentum_buffer"]
            s["momentum_buffer"] = t
            out.append(u + self.decay * t if self.nesterov else t)
        return out


def safe_norm(x: torch.Tensor, min_norm: float = 0.0) -> torch.Tensor:
    """``numerics.safe_norm``: the norm, or ``min_norm`` where it is not
    above it."""
    n = torch.linalg.vector_norm(x)
    return torch.where(n <= min_norm, n.new_tensor(min_norm), n)


class ScaleByTrustRatio(Transform):
    """``optax.scale_by_trust_ratio``: ``u * coef * |p| / (|u| + eps)``,
    or ``u`` where either norm is 0."""

    def __init__(self, trust_coefficient: float = 1.0, eps: float = 0.0):
        self.coef, self.eps = trust_coefficient, eps

    def update(self, us, ps, sts, ctx):
        out = []
        for u, p in zip(us, ps):
            pn, un = safe_norm(p), safe_norm(u)
            ratio = self.coef * pn / (un + self.eps)
            zero = (pn == 0.0) | (un == 0.0)
            out.append(u * torch.where(zero, torch.ones_like(ratio), ratio))
        return out


class ScaleByBelief(Transform):
    """``optax.scale_by_belief`` (AdaBelief): the second moment of the
    gradient's distance from its mean, with ``eps_root`` added to it."""

    def __init__(self, b1: float, b2: float, eps: float, eps_root: float):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        b1, b2, dt = self.b1, self.b2, ps[0].dtype
        out = []
        for u, s in zip(us, sts):
            mu = (1 - b1) * u + b1 * s["exp_avg"]
            err = u - mu
            nu = (1 - b2) * (err * err) + b2 * s["exp_avg_sq"] + self.eps_root
            s["exp_avg"], s["exp_avg_sq"] = mu, nu
            mu_hat = mu / bias_correction(b1, ctx.count, dt)
            nu_hat = nu / bias_correction(b2, ctx.count, dt)
            out.append(mu_hat / (nu_hat.sqrt() + self.eps))
        return out


class ScaleByRAdam(Transform):
    """``optax.scale_by_radam``: Adam's step times the rectification ``r``
    where the variance's length ``ro`` reaches ``threshold``, else the
    bias-corrected first moment alone."""

    def __init__(self, b1: float, b2: float, eps: float,
                 eps_root: float = 0.0, threshold: float = 5.0):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.eps_root, self.threshold = eps_root, threshold

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        b1, b2, c = self.b1, self.b2, ctx.count
        f = np_float(ps[0].dtype)
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        b2t = f(b2) ** f(c)
        ro = ro_inf - f(2) * f(c) * b2t / (f(1) - b2t)
        r = np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                    / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro)) \
            if ro >= self.threshold else None
        out = []
        for u, s in zip(us, sts):
            mu = (1 - b1) * u + b1 * s["exp_avg"]
            nu = (1 - b2) * (u * u) + b2 * s["exp_avg_sq"]
            s["exp_avg"], s["exp_avg_sq"] = mu, nu
            mu_hat = mu / bias_correction(b1, c, ps[0].dtype)
            if r is None:
                out.append(mu_hat)
                continue
            nu_hat = nu / bias_correction(b2, c, ps[0].dtype)
            out.append(float(r) * mu_hat
                       / ((nu_hat + self.eps_root).sqrt() + self.eps))
        return out


class ScaleByNovograd(Transform):
    """``optax.scale_by_novograd``: a per-tensor second moment of the
    gradient's squared norm (the first update takes it whole) and a first
    moment of ``g / (sqrt(nu) + eps) + wd * p``."""

    def __init__(self, b1: float, b2: float, eps: float,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.eps_root, self.wd = eps_root, weight_decay

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "grad_norm_sq": p.new_zeros(())}

    def update(self, us, ps, sts, ctx):
        out = []
        for u, p, s in zip(us, ps, sts):
            sq = torch.linalg.vector_norm(u) ** 2
            nu = sq if ctx.count == 1 else \
                (1 - self.b2) * sq + self.b2 * s["grad_norm_sq"]
            add = u / ((nu + self.eps_root).sqrt() + self.eps) + self.wd * p
            mu = add if ctx.count == 1 else self.b1 * s["exp_avg"] + add
            s["grad_norm_sq"], s["exp_avg"] = nu, mu
            out.append(mu)
        return out


def factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes (second largest, largest) of a parameter with
    at least two axes of ``min_dim_size_to_factor``, else None
    (``optax._src.factorized._factored_dims``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Transform):
    """``optax.adafactor`` with its defaults: the factored second-moment
    estimate (decay ``1 - t ** -0.8``, in float32, factored past 128 rows
    and columns), the block-RMS clip at 1, the learning rate, the
    parameter's block RMS (at least 1e-3) and the descent sign."""

    def __init__(self, decay_rate: float = 0.8, min_dim: int = 128,
                 eps: float = 1e-30, clip: float = 1.0,
                 min_scale: float = 1e-3):
        self.decay_rate, self.min_dim, self.eps = decay_rate, min_dim, eps
        self.clip, self.min_scale = clip, min_scale

    def init(self, p):
        dims = factored_dims(p.shape, self.min_dim)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": p.new_zeros([s for i, s in enumerate(p.shape)
                                      if i != d0]),
                "v_col": p.new_zeros([s for i, s in enumerate(p.shape)
                                      if i != d1])}

    def update(self, us, ps, sts, ctx):
        f = np.float32
        decay = float(f(1) - f(ctx.count) ** f(-self.decay_rate))
        keep = float(f(1.0) - f(decay))
        out = []
        for u, p, s in zip(us, ps, sts):
            sq = u * u + self.eps
            dims = factored_dims(p.shape, self.min_dim)
            if dims is not None:
                d1, d0 = dims
                v_row = decay * s["v_row"] + keep * sq.mean(dim=d0)
                v_col = decay * s["v_col"] + keep * sq.mean(dim=d1)
                s["v_row"], s["v_col"] = v_row, v_col
                red = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(dim=red, keepdim=True)) ** -0.5
                u = u * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = decay * s["v"] + keep * sq
                s["v"] = v
                u = u * v ** -0.5
            u = u / torch.clamp_min(u.square().mean().sqrt() / self.clip,
                                    1.0)
            u = u * ctx.lr
            rms = p.square().mean().sqrt()
            u = u * torch.where(rms <= self.min_scale,
                                rms.new_tensor(self.min_scale), rms)
            out.append(-u)
        return out


class ScaleByRms(Transform):
    """``optax.scale_by_rms`` with ``eps`` in the square root:
    ``u / sqrt(nu + eps)``, ``nu`` starting at ``initial_scale``."""

    def __init__(self, decay: float, eps: float, initial_scale: float):
        self.decay, self.eps, self.initial = decay, eps, initial_scale

    def init(self, p):
        return {"square_avg": torch.full_like(p, self.initial)}

    def update(self, us, ps, sts, ctx):
        out = []
        for u, s in zip(us, sts):
            nu = (1 - self.decay) * (u * u) + self.decay * s["square_avg"]
            s["square_avg"] = nu
            out.append(torch.rsqrt(nu + self.eps) * u)
        return out


class LayerDecay(Transform):
    """``layer_decay_scale`` (``factory.py:45-74``): each update times its
    parameter's scale, ``layer_decay ** (num_layers + 1 - id)``, 1 where
    the parameter has no layer id."""

    def __init__(self, scales: List[Optional[float]]):
        self.scales = scales

    def update(self, us, ps, sts, ctx):
        return [u if s is None else u * s for u, s in zip(us, self.scales)]


_BLOCK = re.compile(r"blocks?_(\d+)|block_(\d+)")
_EMBEDDING = ("encoder/", "pos_embed", "reduce_dim", "cls_token", "cls_pos",
              "patch_embed")


def layer_id(name: str) -> Optional[int]:
    """The ViT layer id of a port parameter name, by ``geot_tpu``'s rule on
    its flax path (``factory.py:27-42``): block i gets i + 1; the
    embeddings (``encoder/``, ``pos_embed``, ``reduce_dim``, ``cls_token``,
    ``cls_pos``, ``patch_embed``) 0; anything else None. The port names a
    block ``blocks.<i>`` where flax names it ``block_<i>``
    (``engine/convert.py``'s map), and keeps flax's other names."""
    keys = name.split(".")
    flax = []
    for k in keys:
        if k.isdigit() and flax and flax[-1] in ("blocks", "block"):
            flax[-1] = f"block_{k}"
        else:
            flax.append(k)
    for k in flax:
        m = _BLOCK.fullmatch(k)
        if m:
            return int(m.group(1) or m.group(2)) + 1
    joined = "/".join(flax)
    if any(s in joined for s in _EMBEDDING):
        return 0
    return None


def layer_scales(names: Sequence[str],
                 layer_decay: float) -> List[Optional[float]]:
    """Each parameter's layer-decay scale: ``num_layers`` is the largest
    id among ``names``."""
    ids = [layer_id(n) for n in names]
    num_layers = max([i for i in ids if i is not None], default=0)
    return [None if i is None else layer_decay ** (num_layers + 1 - i)
            for i in ids]


class ChainOptimizer(torch.optim.Optimizer):
    """A chain of ``Transform`` s as a ``torch.optim.Optimizer``; see the
    module's docstring. ``step(hessian=...)`` takes AdaHessian's diagonal,
    one tensor per parameter in ``params()`` order; ``kernel_axes``, in
    that order too, permutes a parameter into ``geot_tpu``'s layout."""

    def __init__(self, groups: List[Dict[str, Any]], lr: float,
                 chain: List[Transform], every_k: int = 1,
                 needs_hessian: bool = False, name: str = "",
                 kernel_axes: Optional[List[Optional[Tuple[int, ...]]]]
                 = None):
        super().__init__(groups, {"lr": lr})
        self.chain = chain
        self.every_k = int(every_k)
        self.needs_hessian = needs_hessian
        self.name = name
        self.kernel_axes = kernel_axes or [None] * len(self.params())

    def params(self) -> Tensors:
        return [p for g in self.param_groups for p in g["params"]]

    def _init_state(self, ps: Tensors) -> None:
        for p in ps:
            st = self.state[p]
            st["step"] = torch.tensor(0.0)
            for tx in self.chain:
                st.update(tx.init(p))
            if self.every_k > 1:
                st["mini_step"] = 0
                st["acc"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, hessian: Optional[Sequence[torch.Tensor]] = None):
        ps = self.params()
        if not ps:
            return
        if self.needs_hessian and hessian is None:
            raise ValueError(f"optimizer {self.name!r} needs the Hessian "
                             f"diagonal: step(hessian=...)")
        if not self.state[ps[0]]:
            self._init_state(ps)
        sts = [self.state[p] for p in ps]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        if self.every_k > 1:
            # optax.MultiSteps: the running mean of the group's gradients
            n = sts[0]["mini_step"]
            gs = [s["acc"].add_((g - s["acc"]) / (n + 1))
                  for g, s in zip(gs, sts)]
            if n + 1 < self.every_k:
                for s in sts:
                    s["mini_step"] = n + 1
                return
        ctx = Ctx(count=int(sts[0]["step"]) + 1,
                  lr=float(np.float32(self.param_groups[0]["lr"])),
                  wd=[float(g.get("weight_decay", 0.0))
                      for g in self.param_groups for _ in g["params"]],
                  axes=self.kernel_axes, hessian=hessian)
        us = gs
        for tx in self.chain:
            us = tx.update(us, ps, sts, ctx)
        torch._foreach_add_(ps, us)
        for s in sts:
            s["step"].fill_(ctx.count)
            if self.every_k > 1:
                s["mini_step"] = 0
                s["acc"].zero_()


_OPTIMIZERS: Dict[str, Callable] = {}


def _register(*names):
    def deco(fn):
        for n in names:
            _OPTIMIZERS[n] = fn
        return fn
    return deco


def _ndim2(p: torch.Tensor) -> bool:
    """``geot_tpu``'s ``_decay_mask``: rank >= 2 tensors decay."""
    return p.dim() >= 2


def _all(p: torch.Tensor) -> bool:
    return True


# each factory returns (chain, weight decay, mask): the mask picks the
# parameters that the decay of the chain reaches
@_register("adamw")
def _adamw(weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8,
           filter_bias_and_bn=True, **kw):
    return ([ScaleByAdam(betas[0], betas[1], eps), AddDecayedWeights(),
             ScaleByLearningRate()], weight_decay,
            _ndim2 if filter_bias_and_bn else _all)


@_register("adam")
def _adam(betas=(0.9, 0.999), eps=1e-8, **kw):
    return [ScaleByAdam(betas[0], betas[1], eps), ScaleByLearningRate()], \
        0.0, None


@_register("sgd", "momentum")
def _sgd(momentum=0.9, weight_decay=0.0, nesterov=True,
         filter_bias_and_bn=True, **kw):
    # optax.sgd: no trace for momentum=None
    chain = ([Trace(momentum, nesterov)] if momentum is not None else []) \
        + [ScaleByLearningRate()]
    if weight_decay:
        chain.insert(0, AddDecayedWeights())
    return chain, weight_decay, _ndim2 if filter_bias_and_bn else _all


@_register("lamb")
def _lamb(weight_decay=0.0, **kw):
    # optax.lamb's eps 1e-6; the decay is masked when it is set
    return ([ScaleByAdam(0.9, 0.999, 1e-6), AddDecayedWeights(),
             ScaleByTrustRatio(), ScaleByLearningRate()], weight_decay,
            _ndim2)


@_register("lars")
def _lars(weight_decay=0.0, momentum=0.9, **kw):
    # the trust ratio and the decay reach every parameter
    return ([AddDecayedWeights(), ScaleByTrustRatio(0.001),
             ScaleByLearningRate(), Trace(momentum)], weight_decay, _all)


@_register("adabelief")
def _adabelief(betas=(0.9, 0.999), eps=1e-16, **kw):
    return ([ScaleByBelief(betas[0], betas[1], eps, 1e-16),
             ScaleByLearningRate()], 0.0, None)


@_register("radam")
def _radam(betas=(0.9, 0.999), **kw):
    return ([ScaleByRAdam(betas[0], betas[1], 1e-8),
             ScaleByLearningRate()], 0.0, None)


@_register("nadam")
def _nadam(betas=(0.9, 0.999), **kw):
    return ([ScaleByAdam(betas[0], betas[1], 1e-8, nesterov=True),
             ScaleByLearningRate()], 0.0, None)


@_register("novograd", "nvnovograd")
def _novograd(betas=(0.95, 0.98), weight_decay=0.0, **kw):
    return ([ScaleByNovograd(betas[0], betas[1], 1e-6,
                             weight_decay=weight_decay),
             ScaleByLearningRate()], 0.0, None)


@_register("adafactor")
def _adafactor(**kw):
    return [Adafactor()], 0.0, None


@_register("rmsprop", "rmsprop_tf", "rmsproptf")
def _rmsprop_tf(alpha=0.9, eps=1e-10, momentum=0.9, **kw):
    # tf/timm style: eps inside the square root, the accumulator at 1
    chain = [ScaleByRms(alpha, eps, 1.0), ScaleByLearningRate()]
    if momentum:
        chain.append(Trace(momentum))
    return chain, 0.0, None


@_register("adamp")
def _adamp(weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8, delta=0.1,
           wd_ratio=0.1, nesterov=False, filter_bias_and_bn=True, **kw):
    from .extra import AdamP
    return ([AdamP(betas[0], betas[1], eps, delta, wd_ratio, nesterov)],
            weight_decay, _ndim2 if filter_bias_and_bn else _all)


@_register("sgdp")
def _sgdp(momentum=0.9, weight_decay=1e-4, nesterov=True, delta=0.1,
          wd_ratio=0.1, filter_bias_and_bn=True, **kw):
    from .extra import SGDP
    return ([SGDP(momentum, nesterov, delta, wd_ratio)], weight_decay,
            _ndim2 if filter_bias_and_bn else _all)


@_register("adahessian")
def _adahessian(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                hessian_power=1.0, **kw):
    from .adahessian import AdaHessian
    return ([AdaHessian(betas[0], betas[1], eps, hessian_power)],
            weight_decay, _all)


@_register("madgrad")
def _madgrad(momentum=0.9, weight_decay=0.0, eps=1e-6, **kw):
    from .extra import Madgrad
    return [Madgrad(momentum, eps)], weight_decay, _all


def parse_name(name: str) -> Tuple[str, bool]:
    """(the optimizer's registered name, whether lookahead wraps it) of a
    ``NAME`` such as ``lookahead_sgd`` or ``lookaheadadamw``."""
    name = name.lower()
    for prefix in ("lookahead_", "lookahead"):
        if name.startswith(prefix) and name != "lookahead":
            return name[len(prefix):], True
    return name, False


def build_optimizer_from_cfg(module: torch.nn.Module, lr: float,
                             NAME: str = "adamw", every_k: int = 1,
                             layer_decay: float = 0.0,
                             lookahead_alpha: float = 0.5,
                             lookahead_k: int = 6,
                             **kwargs) -> ChainOptimizer:
    """``cfg.optimizer`` -> the ``ChainOptimizer`` of ``NAME`` over
    ``module``'s trainable parameters (``factory.py:185-225``): an unknown
    name raises ``ValueError``; ``every_k > 1`` accumulates that many
    gradients an update."""
    name, lookahead = parse_name(str(NAME))
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name}; known: "
                         f"{sorted(_OPTIMIZERS)}")
    chain, wd, mask = _OPTIMIZERS[name](**kwargs)
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    decayed = [(n, p) for n, p in named if wd and mask and mask(p)]
    kept = [(n, p) for n, p in named if not (wd and mask and mask(p))]
    groups = [{"params": [p for _, p in decayed],
               "names": [n for n, _ in decayed], "weight_decay": wd},
              {"params": [p for _, p in kept],
               "names": [n for n, _ in kept], "weight_decay": 0.0}]
    if lookahead:
        from .extra import Lookahead
        chain.append(Lookahead(lookahead_alpha, lookahead_k))
    layer_decay = float(layer_decay or 0)
    if 0.0 < layer_decay < 1.0:
        chain.append(LayerDecay(layer_scales(
            groups[0]["names"] + groups[1]["names"], layer_decay)))
    # the weights that are flax kernels in geot_tpu, and their layout there
    axes = {id(m.weight): m.flax_kernel_axes for m in module.modules()
            if getattr(m, "flax_kernel_axes", None)}
    return ChainOptimizer(groups, lr, chain, every_k=every_k,
                          needs_hessian=needs_hessian(NAME), name=str(NAME),
                          kernel_axes=[axes.get(id(p)) for g in groups
                                       for p in g["params"]])


def needs_hessian(NAME: str) -> bool:
    """True when the optimizer of ``NAME`` is AdaHessian (alone or under
    lookahead), whose step takes the Hessian diagonal
    (``geot_tpu/engine/steps.py:49-53``)."""
    return parse_name(str(NAME))[0] == "adahessian"


class PlateauSchedule:
    """ReduceLROnPlateau (``factory.py:228-298``): the lr drops by
    ``decay_rate`` (not below ``min_lr``) when the metric that the trainer
    feeds after each validation (``note_metric``) has not improved by the
    relative ``threshold`` for more than ``patience_t`` validations in a
    row, then waits ``cooldown_t`` validations; linear warmup first.
    ``schedule(epoch)`` returns the lr, as the other schedules do, and
    ``state_dict`` / ``load_state_dict`` carry what it has learned."""

    def __init__(self, lr: float, decay_rate: float = 0.1,
                 patience_t: int = 10, threshold: float = 1e-4,
                 cooldown_t: int = 0, warmup_epochs: int = 0,
                 warmup_lr: float = 1e-6, min_lr: float = 0.0,
                 mode: str = "max"):
        self.base_lr = float(lr)
        self.decay_rate = float(decay_rate)
        self.patience = int(patience_t)
        self.threshold = float(threshold)
        self.cooldown_t = int(cooldown_t)
        self.warmup_epochs = int(warmup_epochs)
        self.warmup_lr = float(warmup_lr)
        self.min_lr = float(min_lr)
        self.mode = mode
        self.cur = float(lr)
        self.best = None
        self.bad = 0
        self.cooldown = 0

    def _is_better(self, metric: float) -> bool:
        # torch ReduceLROnPlateau's relative threshold
        if self.mode == "max":
            return (metric > self.best * (1.0 + self.threshold)
                    if self.best > 0 else metric > self.best + self.threshold)
        return (metric < self.best * (1.0 - self.threshold)
                if self.best > 0 else metric < self.best - self.threshold)

    def note_metric(self, metric: float) -> None:
        metric = float(metric)
        if self.best is None or self._is_better(metric):
            self.best = metric
            self.bad = 0
            return
        if self.cooldown > 0:
            self.cooldown -= 1
            return
        self.bad += 1
        if self.bad > self.patience:
            self.cur = max(self.cur * self.decay_rate, self.min_lr)
            self.bad = 0
            self.cooldown = self.cooldown_t

    def __call__(self, epoch: int) -> float:
        t = max(int(epoch) - 1, 0)
        if self.warmup_epochs > 0 and t < self.warmup_epochs:
            return self.warmup_lr + (self.base_lr - self.warmup_lr) \
                * t / self.warmup_epochs
        return self.cur

    def state_dict(self) -> Dict[str, Any]:
        return {"cur": self.cur, "best": self.best, "bad": self.bad,
                "cooldown": self.cooldown}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.cur, self.best = sd["cur"], sd["best"]
        self.bad, self.cooldown = sd["bad"], sd["cooldown"]


def build_scheduler_from_cfg(cfg: Dict[str, Any]
                             ) -> "Callable[[int], float] | PlateauSchedule":
    """Epoch (1-based) -> lr (``factory.py:301-396``) for ``cfg["sched"]``
    in ``multistep``, ``step``, ``cosine``, ``tanh``, ``poly``,
    ``plateau`` (a ``PlateauSchedule``) and ``none``, with
    ``warmup_epochs`` / ``warmup_lr``. Unset ``min_lr`` is ``lr / 1000``,
    unset ``decay_rate`` ``0.01 ** (1 / epochs)`` (``step``), ``t_max``
    defaults to ``epochs``. The lr of epoch e is the timm schedule's at
    ``t = e - 1``: the reference steps its scheduler with the 0-based
    epoch after the previous one."""
    sched = cfg.get("sched", "multistep")
    lr = float(cfg.get("lr", 1e-3))
    epochs = int(cfg.get("epochs", 300))
    min_lr = float(cfg["min_lr"]) if cfg.get("min_lr") else lr / 1000.0
    default_rate = 0.01 ** (1.0 / max(epochs, 1))
    t_max = int(cfg.get("t_max") or epochs)
    warmup_epochs = int(cfg.get("warmup_epochs", 0) or 0)
    warmup_lr = cfg.get("warmup_lr", 1e-6)
    warmup_lr = 1e-6 if warmup_lr is None else float(warmup_lr)

    def with_warmup(base: Callable[[int], float]) -> Callable[[int], float]:
        def schedule(epoch: int) -> float:
            t = max(int(epoch) - 1, 0)
            if warmup_epochs > 0 and t < warmup_epochs:
                return warmup_lr + t * (lr - warmup_lr) / warmup_epochs
            return base(t)
        return schedule

    if sched == "multistep":
        decay_epochs = sorted(cfg.get("decay_epochs", [220]))
        rate = float(cfg.get("decay_rate") or 0.1)

        def base(t):
            # timm multistep_lr.py:46: bisect_right(decay_t, t + 1)
            return lr * rate ** bisect.bisect_right(decay_epochs, t + 1)
    elif sched == "step":
        every = cfg.get("decay_epochs", 30)
        every = int(every[0] if isinstance(every, (list, tuple)) else every)
        rate = float(cfg.get("decay_rate") or default_rate)

        def base(t):
            return lr * rate ** (t // max(every, 1))
    elif sched == "cosine":
        def base(t):
            if t >= t_max:                  # past the one cycle
                return min_lr
            return min_lr + 0.5 * (lr - min_lr) * (
                1 + math.cos(math.pi * t / t_max))
    elif sched == "tanh":
        lb, ub = -7.0, 3.0                  # timm tanh_lr.py:27-28

        def base(t):
            if t >= epochs:
                return min_lr
            tr = t / epochs
            return min_lr + 0.5 * (lr - min_lr) * (
                1 - math.tanh(lb * (1.0 - tr) + ub * tr))
    elif sched == "poly":
        power = float(cfg.get("decay_rate") or 0.9)

        def base(t):
            if t >= epochs:
                return min_lr
            return min_lr + (lr - min_lr) * (1 - t / epochs) ** power
    elif sched == "plateau":
        return PlateauSchedule(
            lr, decay_rate=float(cfg.get("decay_rate", 0.1)),
            patience_t=int(cfg.get("patience_epochs", 10)),
            threshold=float(cfg.get("plateau_threshold", 1e-4)),
            cooldown_t=int(cfg.get("cooldown_epochs", 0) or 0),
            warmup_epochs=warmup_epochs, warmup_lr=warmup_lr, min_lr=min_lr,
            mode=cfg.get("plateau_mode", "max"))
    elif sched in ("none", None):
        return lambda epoch: lr
    else:
        raise ValueError(f"unknown scheduler {sched}")
    return with_warmup(base)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the scheduled lr into every param group (``factory.py:398``)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
