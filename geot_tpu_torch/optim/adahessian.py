"""AdaHessian (``geot_tpu/optim/adahessian.py``): the Hutchinson estimate
of the Hessian's diagonal and the Adam-like update whose second moment is
that diagonal's square.

``geot_tpu`` takes ``H z`` as one ``jax.jvp`` through the gradient
function; here it is reverse over reverse, the reference's own double
backward: the first gradients with ``create_graph=True``, then the
gradient of ``sum(g * z)``, with no second forward.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .factory import Transform, f32_bias_correction


def rademacher(params: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> List[torch.Tensor]:
    """One ``z`` per parameter, entries -1 or 1 with equal odds, drawn
    from ``generator`` in parameter order."""
    return [torch.randint(0, 2, p.shape, generator=generator,
                          device=p.device).to(p.dtype) * 2 - 1
            for p in params]


def hutchinson_diag(grads: Sequence[Optional[torch.Tensor]],
                    params: Sequence[torch.Tensor],
                    zs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``z * (H z)`` per parameter (``adahessian.py:34-60`` with one
    sample): ``grads`` are the loss's gradients taken with
    ``create_graph=True`` (None where the loss does not reach a
    parameter), ``H z`` the gradient of ``sum(g * z)``. A parameter whose
    gradient does not depend on the parameters gets 0."""
    live = [i for i, g in enumerate(grads)
            if g is not None and g.requires_grad]
    hz = torch.autograd.grad([grads[i] for i in live], list(params),
                             grad_outputs=[zs[i] for i in live],
                             allow_unused=True) if live else \
        [None] * len(params)
    return [torch.zeros_like(p) if h is None else (z * h).detach()
            for p, z, h in zip(params, zs, hz)]


class AdaHessian(Transform):
    """The update (``adahessian.py:70-106``): first moment of the
    gradients, second moment of the squared diagonal, ``denom = (nu_hat)
    ** (k / 2) + eps``, decoupled decay on every parameter, times
    ``-lr``. The bias corrections are float32, as there. The learning rate
    and each parameter's decay are the chain's (``Ctx``) unless given
    here."""

    def __init__(self, b1: float, b2: float, eps: float,
                 hessian_power: float = 1.0,
                 learning_rate: Optional[float] = None,
                 weight_decay: Optional[float] = None):
        self.b1, self.b2, self.eps, self.k = b1, b2, eps, hessian_power
        self.lr, self.wd = learning_rate, weight_decay

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_hessian_diag_sq": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        b1, b2 = self.b1, self.b2
        bc1 = f32_bias_correction(b1, ctx.count)
        bc2 = f32_bias_correction(b2, ctx.count)
        lr = ctx.lr if self.lr is None else self.lr
        wds = ctx.wd if self.wd is None else [self.wd] * len(ps)
        out = []
        for u, p, s, h, wd in zip(us, ps, sts, ctx.hessian, wds):
            m = b1 * s["exp_avg"] + (1 - b1) * u
            v = b2 * s["exp_hessian_diag_sq"] + (1 - b2) * h * h
            s["exp_avg"], s["exp_hessian_diag_sq"] = m, v
            denom = (v / bc2).pow(self.k / 2.0) + self.eps
            out.append(-lr * (wd * p + m / (bc1 * denom)))
        return out


def adahessian(learning_rate: float = 0.1, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0,
               hessian_power: float = 1.0) -> AdaHessian:
    """The AdaHessian transform with its own learning rate and decay
    (``geot_tpu/optim/adahessian.py:65``): ``init(p)`` per parameter, and
    ``update(grads, params, states, Ctx(count=..., hessian=...))`` returns
    the updates."""
    return AdaHessian(b1, b2, eps, hessian_power,
                      learning_rate=learning_rate, weight_decay=weight_decay)
