"""The optimizers of ``geot_tpu/optim/extra.py`` that optax lacks, as
transforms of the port's chain (``optim.factory``): AdamP and SGDP with
their scale-invariant projection, MADGRAD, and Lookahead.

AdamP's and SGDP's channel view is the first axis of ``geot_tpu``'s
tensor: for a weight that is a flax kernel there (a ``Dense``'s, a
convolution's), the axis that the module's ``flax_kernel_axes`` puts
first (the input features of a ``Dense``, a convolution's kernel height).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .factory import Transform, f32_bias_correction


def _projection(p, g, perturb, delta: float, wd_ratio: float, eps: float,
                axes=None):
    """AdamP's projection (``extra.py:39-66``): where the gradient is
    nearly orthogonal to the weight in the channel view, or else in the
    layer view, the step loses its radial part and the decay is scaled by
    ``wd_ratio``; returns (step, decay ratio), decided on the device.
    ``axes`` permutes the tensors into ``geot_tpu``'s layout first."""
    if axes is not None:
        out, ratio = _projection(p.permute(axes), g.permute(axes),
                                 perturb.permute(axes), delta, wd_ratio, eps)
        return out.permute(tuple(np.argsort(axes))), ratio
    expand = (-1,) + (1,) * (p.dim() - 1)

    def view_try(rows: int):
        pv, gv = p.reshape(rows, -1), g.reshape(rows, -1)
        pn = torch.linalg.vector_norm(pv, dim=1)
        cos = (pv * gv).sum(dim=1).abs() / torch.clamp_min(
            pn * torch.linalg.vector_norm(gv, dim=1), eps)
        cond = cos.max() < delta / math.sqrt(pv.shape[1])
        p_n = p / (pn + eps).reshape(expand if rows > 1 else (1,) * p.dim())
        dot = (p_n * perturb).reshape(rows, -1).sum(dim=1)
        return cond, perturb - p_n * dot.reshape(
            expand if rows > 1 else (1,) * p.dim())

    cond_c, proj_c = view_try(p.shape[0])
    cond_l, proj_l = view_try(1)
    out = torch.where(cond_c, proj_c, torch.where(cond_l, proj_l, perturb))
    ratio = torch.where(cond_c | cond_l, p.new_tensor(wd_ratio),
                        p.new_tensor(1.0))
    return out, ratio


class AdamP(Transform):
    """AdamP (``extra.py:69-117``): Adam's step, projected for rank >= 2
    weights, plus the masked decay times the projection's ratio, times
    ``-lr``. The bias corrections are float32, as there."""

    def __init__(self, b1: float, b2: float, eps: float, delta: float,
                 wd_ratio: float, nesterov: bool):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov

    def init(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        b1, b2 = self.b1, self.b2
        bc1 = f32_bias_correction(b1, ctx.count)
        bc2 = f32_bias_correction(b2, ctx.count)
        out = []
        for u, p, s, wd, ax in zip(us, ps, sts, ctx.wd, ctx.axes):
            m = b1 * s["exp_avg"] + (1 - b1) * u
            v = b2 * s["exp_avg_sq"] + (1 - b2) * u * u
            s["exp_avg"], s["exp_avg_sq"] = m, v
            denom = (v / bc2).sqrt() + self.eps
            perturb = ((b1 * m + (1 - b1) * u) / bc1 / denom
                       if self.nesterov else (m / bc1) / denom)
            ratio = 1.0
            if p.dim() >= 2:
                perturb, ratio = _projection(p, u, perturb, self.delta,
                                             self.wd_ratio, self.eps, ax)
            out.append(-ctx.lr * (perturb + wd * ratio * p) if wd
                       else -ctx.lr * perturb)
        return out


class SGDP(Transform):
    """SGDP (``extra.py:120-172``): SGD with momentum and AdamP's
    projection; the decay is divided by ``1 - momentum``. Without
    Nesterov the stored momentum is the projected step, as in the
    reference's in-place code."""

    def __init__(self, momentum: float, nesterov: bool, delta: float,
                 wd_ratio: float, eps: float = 1e-8):
        self.momentum, self.nesterov = momentum, nesterov
        self.delta, self.wd_ratio, self.eps = delta, wd_ratio, eps

    def init(self, p):
        return {"momentum_buffer": torch.zeros_like(p)}

    def update(self, us, ps, sts, ctx):
        mom = self.momentum
        out = []
        for u, p, s, wd, ax in zip(us, ps, sts, ctx.wd, ctx.axes):
            buf = mom * s["momentum_buffer"] + u
            d_p = u + mom * buf if self.nesterov else buf
            ratio = 1.0
            if p.dim() >= 2:
                d_p, ratio = _projection(p, u, d_p, self.delta,
                                         self.wd_ratio, self.eps, ax)
            s["momentum_buffer"] = buf if self.nesterov else d_p
            out.append(-ctx.lr * (d_p + wd * ratio / (1.0 - mom) * p)
                       if wd else -ctx.lr * d_p)
        return out


class Madgrad(Transform):
    """MADGRAD (``extra.py:175-217``): momentumised dual averaging from the
    first weights ``x0``, with a cube-root denominator; the update moves
    ``p`` to ``(1 - momentum) * z + momentum * p``."""

    def __init__(self, momentum: float, eps: float):
        self.momentum, self.eps = momentum, eps

    def init(self, p):
        return {"grad_sum": torch.zeros_like(p),
                "grad_sum_sq": torch.zeros_like(p),
                "x0": p.detach().clone()}

    def update(self, us, ps, sts, ctx):
        lamb = ctx.lr * float(np.sqrt(np.float32(ctx.count)))
        mom = self.momentum
        out = []
        for u, p, s, wd in zip(us, ps, sts, ctx.wd):
            if wd:
                u = u + wd * p
            sg = s["grad_sum"] + lamb * u
            sq = s["grad_sum_sq"] + lamb * u * u
            s["grad_sum"], s["grad_sum_sq"] = sg, sq
            z = s["x0"] - sg / (sq.pow(1.0 / 3.0) + self.eps)
            out.append(((1 - mom) * z + mom * p) - p)
        return out


class Lookahead(Transform):
    """Lookahead (``extra.py:220-255``), chained after the optimizer: every
    ``k`` th update the weights land on the slow weights pulled ``alpha``
    of the way to the fast ones, which become the slow weights."""

    def __init__(self, alpha: float = 0.5, k: int = 6):
        self.alpha, self.k = float(alpha), int(k)

    def init(self, p):
        return {"slow": p.detach().clone()}

    def update(self, us, ps, sts, ctx):
        if ctx.count % self.k:
            return us
        out = []
        for u, p, s in zip(us, ps, sts):
            slow = s["slow"]
            slow = slow + self.alpha * ((p + u) - slow)
            s["slow"] = slow
            out.append(slow - p)
        return out
