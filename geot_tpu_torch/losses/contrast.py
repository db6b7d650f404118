"""Student-vs-teacher point InfoNCE with a memory bank
(``geot_tpu/losses/contrast.py:26-107``, the fixed-shape form of the
reference's ``nativeContrastLoss_t``).

- Selection: each confident point (teacher confidence >= threshold) gets
  1 added to a uniform key, and the top S keys of a cloud are taken: S
  random confident points, or all of them and some unconfident ones,
  which a validity mask drops.
- Positive pairs are the same point in student and teacher feature
  space; the other selected points and the bank are negatives. The
  in-batch and bank logits get separate max shifts, bug-compatible with
  the reference.
- The bank (``ContrastState``: queue (Q, D) of L2-normalised teacher
  features, ``ptr``) takes a random subset of the valid targets by a
  mod-indexed scatter that drops invalid rows.

The uniform keys and the queue permutation come from a
``torch.Generator``; ``draws=(keys (B, N), perm (B*S,))`` feeds given ones
instead (a test seam: ``geot_tpu``'s own draws).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class ContrastState:
    queue: torch.Tensor    # (Q, D) L2-normalised teacher features
    ptr: torch.Tensor      # () int64, the next slot

    @classmethod
    def create(cls, generator: torch.Generator, queue_size: int = 4096,
               dim: int = 128) -> "ContrastState":
        """Normal rows, L2-normalised, drawn from ``generator`` on its
        device; ``ptr`` 0."""
        q = torch.randn((queue_size, dim), generator=generator,
                        device=generator.device)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return cls(queue=q, ptr=torch.zeros((), dtype=torch.int64,
                                            device=q.device))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def contrast_loss_t(state: ContrastState, feat_s: torch.Tensor,
                    score: torch.Tensor, feat_t: torch.Tensor,
                    threshold: float = 0.9, sample_nums: int = 1024,
                    temperature: float = 0.1, base_temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, ContrastState]:
    """``(loss, new_state)`` (``contrast.py:50``). feat_s / feat_t (B, N,
    D) student / teacher point features; score (B, N) the teacher's
    confidence. The loss is exactly 0, and the bank unchanged, when no
    point is confident."""
    B, N, D = feat_s.shape
    S = min(sample_nums, N)
    M = B * S
    feat_s, feat_t = _l2n(feat_s), _l2n(feat_t)
    if draws is None:
        keys = torch.rand((B, N), generator=generator,
                          device=feat_s.device)
        perm = torch.randperm(M, generator=generator, device=feat_s.device)
    else:
        keys, perm = draws
    mask = score >= threshold
    key = torch.where(mask, keys + 1.0, keys)
    # lax.top_k: descending, equal keys in index order
    idx = torch.sort(key, dim=1, descending=True, stable=True)[1][:, :S]
    valid = mask.gather(1, idx).reshape(M)
    gidx = idx[..., None].expand(-1, -1, D)
    anchors = feat_s.gather(1, gidx).reshape(M, D)
    targets = feat_t.gather(1, gidx).reshape(M, D)

    logits = (anchors @ targets.T) / temperature                   # (M, M)
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    bank = (anchors @ state.queue.T.to(anchors.dtype)) / temperature
    bank = bank - bank.max(dim=1, keepdim=True).values.detach()

    validf = valid.to(logits.dtype)
    eye = torch.eye(M, dtype=logits.dtype, device=logits.device)
    pos_mask = eye * validf[None, :]
    neg_mask = (1.0 - eye) * validf[None, :]
    exp_logits = torch.exp(logits)
    neg = (exp_logits * neg_mask).sum(1, keepdim=True) \
        + torch.exp(bank).sum(1, keepdim=True)
    log_prob = logits - torch.log(exp_logits + neg)
    per = -(temperature / base_temperature) * (pos_mask * log_prob).sum(1)
    n_valid = validf.sum()
    loss = (per * validf).sum() / n_valid.clamp_min(1.0)
    loss = torch.where(n_valid > 0, loss, torch.zeros_like(loss))

    take = perm[:S].long()
    feats_in = targets[take].detach().to(state.queue.dtype)
    ok = valid[take]
    Q = state.queue.shape[0]
    okl = ok.long()
    slots = (state.ptr + okl.cumsum(0) - 1) % Q
    slots = torch.where(ok, slots, Q)                   # row Q is dropped
    queue = torch.cat([state.queue, state.queue.new_zeros((1, D))])
    queue[slots] = feats_in
    new_ptr = (state.ptr + okl.sum()) % Q
    return loss, ContrastState(queue=queue[:Q], ptr=new_ptr)
