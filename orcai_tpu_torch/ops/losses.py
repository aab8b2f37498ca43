"""Masked multi-label loss and metrics on tensors.

Counterpart of orcai_tpu/ops/losses.py: positions where
y_true == MASK_VALUE ("presence not possible") are excluded from every
reduction. Fully shaped masked sums (no boolean indexing, so no sync with
the host); the BCE takes logits for numerical stability. Every function
returns a 0-d tensor on the inputs' device.
"""

from __future__ import annotations

import torch

from orcai_tpu_torch.utils.seeds import MASK_VALUE


def _mask(y_true: torch.Tensor) -> torch.Tensor:
    return y_true != MASK_VALUE


def _bce_elements(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # stable elementwise BCE: max(z, 0) - z*y + log(1 + exp(-|z|))
    return logits.clamp(min=0.0) - logits * y + torch.log1p(torch.exp(-logits.abs()))


def masked_bce_from_logits(logits: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy over unmasked positions, from logits."""
    total, count = weighted_masked_bce_sums(logits, y_true, None)
    return total / count.clamp(min=1)


def masked_bce_from_probs(probs: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Probability-space masked BCE with Keras' epsilon clipping (1e-7)."""
    eps = 1e-7
    p = probs.clamp(eps, 1.0 - eps)
    mask = _mask(y_true)
    y = torch.where(mask, y_true, 0.0)
    per_elem = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    total = torch.where(mask, per_elem, 0.0).sum()
    return total / mask.sum().clamp(min=1)


def masked_binary_accuracy_counts(
    probs: torch.Tensor, y_true: torch.Tensor, threshold: float = 0.5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) over unmasked positions, to be summed over batches."""
    mask = _mask(y_true)
    hit = (probs > threshold) == (y_true > 0.5)
    return (mask & hit).sum(), mask.sum()


def masked_binary_accuracy(
    probs: torch.Tensor, y_true: torch.Tensor, threshold: float = 0.5
) -> torch.Tensor:
    correct, total = masked_binary_accuracy_counts(probs, y_true, threshold)
    return correct / total.clamp(min=1)


def weighted_masked_bce_sums(
    logits: torch.Tensor, y_true: torch.Tensor, call_weights: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of weighted_masked_bce_from_logits, before the count is
    clamped and divides: data-parallel training adds the counts of every
    process first, since the mean of per-process means is not the mean."""
    mask = _mask(y_true)
    y = torch.where(mask, y_true, 0.0)
    if call_weights is None:
        return torch.where(mask, _bce_elements(logits, y), 0.0).sum(), mask.sum()
    w = torch.where(y > 0.5, call_weights.to(logits.dtype), 1.0)
    total = torch.where(mask, _bce_elements(logits, y) * w, 0.0).sum()
    return total, torch.where(mask, w, 0.0).sum()


def weighted_masked_bce_from_logits(
    logits: torch.Tensor, y_true: torch.Tensor, call_weights: torch.Tensor | None
) -> torch.Tensor:
    """Masked BCE with per-call weights applied to positive positions
    (Keras' class_weight for multi-label outputs): positions where a call
    is present are scaled by that call's weight, in the sum and the count."""
    total, count = weighted_masked_bce_sums(logits, y_true, call_weights)
    return total / count.clamp(min=1)


def masked_auc_roc(
    probs: torch.Tensor, y_true: torch.Tensor, num_thresholds: int = 200
) -> torch.Tensor:
    """Masked ROC-AUC by trapezoidal integration over threshold bins
    (Keras AUC with its default 200 thresholds). One broadcast compare of
    the flattened probabilities against all thresholds."""
    mask = _mask(y_true).reshape(-1)
    pos = mask & (y_true.reshape(-1) > 0.5)
    neg = mask & ~pos
    # Keras' grid: [-eps, 1/(n-1), ..., (n-2)/(n-1), 1+eps]; the epsilon
    # ends close the curve at (0,0)/(1,1) when probabilities saturate
    eps = 1e-7
    inner = torch.arange(1, num_thresholds - 1, device=probs.device) / (num_thresholds - 1)
    ends = torch.tensor([-eps, 1.0 + eps], device=probs.device)
    thresholds = torch.cat([ends[:1], inner, ends[1:]]).to(probs.dtype)
    pred = probs.reshape(1, -1) >= thresholds[:, None]
    tps = (pred & pos).sum(dim=1)
    fps = (pred & neg).sum(dim=1)
    n_pos = pos.sum().clamp(min=1)
    n_neg = (mask.sum() - n_pos).clamp(min=1)
    tpr = tps / n_pos
    fpr = fps / n_neg
    # thresholds ascending -> fpr descending; integrate |dx| * mean(y)
    return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()
