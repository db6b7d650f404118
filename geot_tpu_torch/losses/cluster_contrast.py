"""Class-prototype cluster-contrast losses
(``geot_tpu/losses/cluster_contrast.py``, the fixed-shape form of the
reference's ``nativeContrastLoss_class`` / ``_subclass`` /
``_subclass_t``).

- ``ClassContrastState``: per-prototype EMA centres (P, D), ring-buffer
  queues (P, Q, D) and their pointers (P,).
- Sampling: per (cloud, class) exactly ``n_view`` slots from priority keys
  (a uniform draw plus 3 or 2 for the kind each half prefers: hard points,
  predicted c but labelled otherwise, then easy ones), or, with
  subclasses, up to ``n_view // K`` members in each of K confidence
  quantile bins; each slot carries a validity flag.
- The loss: InfoNCE of the sampled anchors against each other with the
  queues as extra negatives (ppc), plus ``pcc_weight`` times InfoNCE
  against the centres (pcc). The state update (centre EMA, mod-indexed
  enqueue) carries no gradient.

The top-k selections are stable descending sorts: equal keys come in index
order, as ``lax.top_k`` gives them (keys ``uniform + 2`` or ``+ 3`` in
float32 tie often at 16,000 points). The quantiles follow
``jnp.nanquantile``'s linear interpolation step by step. Draws come from a
``torch.Generator`` on the features' device, or are passed in as
``draws`` (a test seam: ``geot_tpu``'s own draws give ``geot_tpu``'s
results).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ClassContrastState(NamedTuple):
    centers: torch.Tensor     # (P, D) L2-normalised EMA prototypes
    queues: torch.Tensor      # (P, Q, D)
    ptrs: torch.Tensor        # (P,) int32

    @staticmethod
    def create(generator: torch.Generator, num_prototypes: int,
               dim: int = 64, queue_size: int = 150,
               dtype: torch.dtype = torch.float32) -> "ClassContrastState":
        """Normal centres and queue rows, L2-normalised, drawn from
        ``generator`` on its device; pointers 0 (``:32``)."""
        dev = generator.device
        c = torch.randn((num_prototypes, dim), generator=generator,
                        device=dev, dtype=dtype)
        c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
        q = torch.randn((num_prototypes, queue_size, dim),
                        generator=generator, device=dev, dtype=dtype)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return ClassContrastState(centers=c, queues=q, ptrs=torch.zeros(
            (num_prototypes,), dtype=torch.int32, device=dev))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _one_hot(y: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside [0, n) gives a zero row."""
    return (y[..., None] == torch.arange(n, device=y.device)).to(dtype)


def _top_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest keys along the last axis, largest
    first, equal keys in index order (``lax.top_k``'s order)."""
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def _uniform(shape, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=like.dtype)


def _sample_per_class(pred, label, num_classes: int, n_view: int,
                      g: torch.Tensor):
    """For each (cloud, class): n_view slots, hard points (pred == c,
    label != c) first in the first half, easy ones first in the second,
    each half filled by the other kind and then by the rest, in the order
    of the uniform draws ``g`` (B, N) (``:42``). Returns (idx (B, C,
    n_view), valid (B, C, n_view))."""
    half = n_view // 2
    classes = torch.arange(num_classes, device=pred.device)[:, None]
    is_pred = pred[:, None, :] == classes                   # (B, C, N)
    is_label = label[:, None, :] == classes
    hard, easy = is_pred & ~is_label, is_pred & is_label
    gb = g[:, None, :].expand(hard.shape)
    key_hard_half = torch.where(hard, gb + 3.0,
                                torch.where(easy, gb + 2.0, gb))
    key_easy_half = torch.where(easy, gb + 3.0,
                                torch.where(hard, gb + 2.0, gb))
    i1 = _top_k(key_hard_half, half)
    taken = torch.zeros(gb.shape, dtype=gb.dtype, device=gb.device).scatter(
        -1, i1, -10.0)
    i2 = _top_k(key_easy_half + taken, n_view - half)
    idx = torch.cat([i1, i2], dim=-1)
    return idx, (hard | easy).gather(-1, idx)


def _info_nce(anchors, contrast, pos_mask, contrast_valid=None,
              extra_neg=None, extra_neg_mask=None, temperature=0.1,
              base_temperature=1.0, drop_self=False, anchor_valid=None):
    """The InfoNCE core (``:74``): in-batch pairs of other (sub)classes
    are negatives, ``extra_neg`` rows (the queues) add more under their
    own row-max shift; padded slots (``contrast_valid`` off) stay out of
    the shift and the sums; the mean over anchors with a positive (and
    ``anchor_valid``)."""
    M = anchors.shape[0]
    logits = (anchors @ contrast.T) / temperature
    if contrast_valid is not None:
        logits = torch.where(contrast_valid[None, :], logits,
                             torch.full_like(logits, -1e9))
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    neg_mask = 1.0 - pos_mask
    if contrast_valid is not None:
        neg_mask = neg_mask * contrast_valid[None, :].to(neg_mask.dtype)
    if drop_self:
        eye = torch.eye(M, dtype=pos_mask.dtype, device=pos_mask.device)
        pos_mask = pos_mask * (1 - eye)
        neg_mask = neg_mask * (1 - eye)
    exp_logits = torch.exp(logits)
    neg_logits = (exp_logits * neg_mask).sum(1, keepdim=True)
    if extra_neg is not None:
        ln = (anchors @ extra_neg.T) / temperature
        ln = ln - ln.max(dim=1, keepdim=True).values.detach()
        neg_logits = neg_logits + (torch.exp(ln) * extra_neg_mask).sum(
            1, keepdim=True)
    log_prob = logits - torch.log(exp_logits + neg_logits)
    pos_count = pos_mask.sum(1)
    has_pos = pos_count > 0
    if anchor_valid is not None:
        has_pos = has_pos & anchor_valid
    mean_lp = (pos_mask * log_prob).sum(1) / pos_count.clamp_min(1.0)
    per = -(temperature / base_temperature) * mean_lp
    denom = has_pos.to(per.dtype).sum().clamp_min(1.0)
    return torch.where(has_pos, per, torch.zeros_like(per)).sum() / denom


# the confidence-quantile split boundaries of the K = 6 subclass variants
# (``:119``)
K_SPLIT = (0.95, 0.85, 0.75, 0.65, 0.55)


def _nanquantile(a: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(a, qs, axis=-1)`` (linear), step for step: sort
    (NaN last), positions ``q * (count - 1)``, the low and high values
    weighted ``1 - w`` and ``w`` (``low * (1 - w)``, then ``high * w``
    added in one rounding); an all-NaN row gives NaN. a (..., N), qs (Q,)
    -> (Q, ...)."""
    a = torch.sort(a, dim=-1).values
    counts = (~torch.isnan(a)).sum(-1).to(qs.dtype)
    q = qs.reshape((-1,) + (1,) * counts.dim()) * (counts - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low,
                                                             counts - 1))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high,
                                                               counts - 1))
    ae = a.expand((len(qs),) + a.shape)
    low_v = ae.gather(-1, low.long()[..., None])[..., 0]
    high_v = ae.gather(-1, high.long()[..., None])[..., 0]
    # XLA fuses the sum into an FMA of the high term: addcmul's
    return torch.addcmul(low_v.to(qs.dtype) * low_w, high_v.to(qs.dtype),
                         high_w).to(a.dtype)


def _sample_subclass_quantile(pred, conf, num_classes: int, K: int,
                              n_view_bin: int, g: torch.Tensor):
    """Per (cloud, class) the members' confidence quantiles at
    ``K_SPLIT[:K - 1]`` split K bins (0 the most confident; a point at a
    threshold goes to the lower bin; an empty class's thresholds are
    +inf), and up to ``n_view_bin`` members of each bin in the order of
    the draws ``g`` (B, N) (``:122``). Returns idx (B, C*K, n_view_bin),
    valid."""
    B, N = pred.shape
    member = pred[:, None, :] == torch.arange(
        num_classes, device=pred.device)[:, None]              # (B, C, N)
    confm = torch.where(member, conf[:, None, :],
                        torch.full_like(conf[:, None, :], float("nan")))
    qs = torch.tensor(K_SPLIT[:K - 1], dtype=conf.dtype, device=conf.device)
    ths = torch.nan_to_num(_nanquantile(confm, qs), nan=float("inf"))
    bins = (ths[:, :, :, None] >= conf[None, :, None, :]).sum(0)
    kk = torch.arange(K, device=pred.device)[:, None]
    m = member[:, :, None, :] & (bins[:, :, None, :] == kk)   # (B, C, K, N)
    gb = g[:, None, None, :].expand(m.shape)
    idx = _top_k(torch.where(m, gb + 2.0, gb), n_view_bin)
    valid = m.gather(-1, idx)
    return (idx.reshape(B, num_classes * K, n_view_bin),
            valid.reshape(B, num_classes * K, n_view_bin))


def class_contrast_loss(state: ClassContrastState, feats, pred, label,
                        conf: Optional[torch.Tensor] = None,
                        num_classes: int = 17, n_view: int = 100,
                        subclasses: int = 1, temperature: float = 0.1,
                        mu: float = 0.99, pixel_update: int = 30,
                        pcc_weight: float = 10.0,
                        teacher_feats: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """One step of the cluster-contrast family -> (loss, new_state)
    (``:163``).

    - ``subclasses=1``: ``nativeContrastLoss_class``.
    - ``subclasses=K>1`` with ``conf``: the confidence-quantile subclass
      variants, ``n_view // K`` slots a bin.
    - ``teacher_feats``: ``_subclass_t``; the anchors are the student's
      features, the contrast set and the state update the teacher's.

    feats / teacher_feats (B, N, D); pred / label (B, N) int; conf (B, N).
    ``draws = (g (B, N), g_queue (M,))``: the sampler's and the enqueue's
    uniforms, M = B * C * K * (n_view // K) (B * C * n_view with one
    class a prototype); drawn from ``generator`` without them, in the
    features' dtype."""
    B, N, D = feats.shape
    feats = _l2n(feats)
    if teacher_feats is not None:
        teacher_feats = _l2n(teacher_feats)
    if subclasses > 1 and conf is not None:
        n_view_bin = n_view // subclasses
        M = B * num_classes * subclasses * n_view_bin
    else:
        M = B * num_classes * n_view
    if draws is None:
        draws = (_uniform((B, N), feats, generator),
                 _uniform((M,), feats, generator))
    g, g_queue = draws

    if subclasses > 1 and conf is not None:
        idx, valid = _sample_subclass_quantile(pred, conf, num_classes,
                                               subclasses, n_view_bin, g)
    else:
        idx, valid = _sample_per_class(pred, label, num_classes, n_view, g)
    proto_ids = torch.arange(idx.shape[1], device=feats.device)[
        None, :, None].expand(idx.shape)

    flat = idx.reshape(B, -1)[..., None].expand(-1, -1, D)
    a = feats.gather(1, flat).reshape(M, D)
    c = (teacher_feats.gather(1, flat).reshape(M, D)
         if teacher_feats is not None else a)
    P = num_classes * subclasses
    y = proto_ids.reshape(M)
    v = valid.reshape(M)
    dt = feats.dtype

    same = (y[:, None] == y[None, :]).to(dt)
    vmask = v[:, None].to(dt) * v[None, :].to(dt)
    pos_mask = same * vmask
    Q = state.queues.shape[1]
    queue_flat = state.queues.reshape(-1, D).to(dt)
    q_ids = torch.arange(P, device=feats.device).repeat_interleave(Q)
    queue_neg_mask = (y[:, None] != q_ids[None, :]).to(dt)

    ppc = _info_nce(a, c, pos_mask, contrast_valid=v, extra_neg=queue_flat,
                    extra_neg_mask=queue_neg_mask, temperature=temperature,
                    drop_self=teacher_feats is None, anchor_valid=v)
    center_pos = _one_hot(y, P, dt) * v[:, None].to(dt)
    pcc = _info_nce(a, state.centers.to(dt), center_pos,
                    temperature=temperature, anchor_valid=v)
    loss = ppc + pcc_weight * pcc

    # --- the state update, no gradient ------------------------------------
    with torch.no_grad():
        a_sg = (c if teacher_feats is not None else a).detach()
        vf = v.to(dt)[:, None]
        sums = torch.zeros((P, D), dtype=dt, device=a.device).index_add_(
            0, y, a_sg * vf)
        counts = torch.zeros((P,), dtype=dt, device=a.device).index_add_(
            0, y, vf[:, 0])
        means = sums / counts[:, None].clamp_min(1.0)
        centers = state.centers.to(torch.promote_types(
            state.centers.dtype, dt))
        new_centers = torch.where(counts[:, None] > 0,
                                  mu * centers + (1 - mu) * means, centers)
        new_centers = _l2n(new_centers)

        # enqueue up to pixel_update random valid features a prototype
        gq = g_queue + v.to(g_queue.dtype)
        take = min(pixel_update, n_view)
        pids = torch.arange(P, device=a.device)[:, None]
        key = torch.where(y[None, :] == pids, gq[None, :],
                          torch.full_like(gq[None, :], -1.0))
        sel = _top_k(key, take)                               # (P, take)
        ok = v[sel]
        okl = ok.to(torch.int32)
        slots = (state.ptrs[:, None] + okl.cumsum(1, dtype=torch.int32)
                 - 1) % Q
        slots = torch.where(ok, slots, torch.full_like(slots, Q))
        queues = state.queues
        padded = torch.cat([queues, queues.new_zeros((P, 1, D))], dim=1)
        padded[pids.expand_as(slots), slots.long()] = a_sg[sel].to(
            queues.dtype)
        new_ptrs = (state.ptrs + okl.sum(1, dtype=torch.int32)) % Q
    return loss, ClassContrastState(centers=new_centers,
                                    queues=padded[:, :Q], ptrs=new_ptrs)


def pseudo_label_from_prototype(state: ClassContrastState, feats,
                                num_classes: int, subclasses: int = 1):
    """Prototype pseudo-labels (``:272``): the softmax of each point's
    similarity to the centres; its largest entry, and the argmax
    prototype folded back to its class. feats (B, N, D) ->
    (pseudo_label (B, N) int32, pseudo_logits (B, N))."""
    f = _l2n(feats)
    dist = torch.softmax(f @ state.centers.to(f.dtype).T, dim=-1)
    logits = dist.max(dim=-1).values
    label = torch.div(dist.argmax(dim=-1), subclasses, rounding_mode="floor")
    return label.to(torch.int32), logits


def pcc_top2_loss(state: ClassContrastState, feats, label1, label2,
                  valid_mask, cur, num_classes: int, subclasses: int = 6,
                  n_view: int = 100, temperature: float = 0.1,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[torch.Tensor] = None):
    """The ``_t`` variant's ambiguous-point prototype term (``:287``):
    points of ``valid_mask`` (B, N), binned by the quantiles of ``cur``
    (B, N) within their top-1 class ``label1``, anchor against the centres
    with both their top-1 and top-2 (``label2``) subclass prototypes as
    positives. ``draws``: the sampler's (B, N) uniforms (drawn from
    ``generator`` without them)."""
    K = subclasses
    n_view_bin = n_view // K
    B, N, D = feats.shape
    f = _l2n(feats)
    g = draws if draws is not None else _uniform((B, N), f, generator)
    pred_m = torch.where(valid_mask, label1,
                         torch.full_like(label1, num_classes))
    idx, valid = _sample_subclass_quantile(pred_m, cur, num_classes, K,
                                           n_view_bin, g)
    flat = idx.reshape(B, -1)
    bins = torch.arange(num_classes * K, device=f.device)[
        None, :, None].expand(idx.shape) % K
    y1 = label1.gather(1, flat).reshape(idx.shape) * K + bins
    y2 = label2.gather(1, flat).reshape(idx.shape) * K + bins
    a = f.gather(1, flat[..., None].expand(-1, -1, D)).reshape(-1, D)
    P = num_classes * K
    pos = torch.maximum(_one_hot(y1.reshape(-1), P, f.dtype),
                        _one_hot(y2.reshape(-1), P, f.dtype))
    v = valid.reshape(-1)
    pos = pos * v[:, None].to(f.dtype)
    return _info_nce(a, state.centers.to(f.dtype), pos,
                     temperature=temperature, anchor_valid=v)
