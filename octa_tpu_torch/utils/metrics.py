"""Evaluation metrics and ``MetricsManager``.

Counterpart of ``octa_tpu/utils/metrics.py``: the scores (:22-89), with AUC
by ranks (:67-86); ``_ListMetric`` (:93) with its per-channel loop;
``_is_zstack`` (:124); and ``MetricsManager`` (:135): DSC and IoU in
training, ClDice, AUC, ACC, Recall and Precision added otherwise, DSC the
comparison metric.

Scores take numpy arrays or tensors; confusion counts are reduced on the
input's device and read back as Python floats. ClDice thins on the
manager's ``device`` where one is given (the engine and ``validate`` give
the run's): the post-processed predictions reach the metrics as host
arrays, and thinning a [44, 1216, 1216] z-stack takes minutes on the host
and a fraction of a second on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from octa_tpu_torch.ops.skeleton import cl_dice
from octa_tpu_torch.utils.enums import Phase


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _counts(pred, label) -> tuple[float, float, float, float]:
    p = _tensor(pred).bool().ravel()
    y = _tensor(label).bool().ravel().to(p.device)
    c = torch.stack([(p & y).sum(), (~p & ~y).sum(), (p & ~y).sum(),
                     (~p & y).sum()]).tolist()
    return tuple(float(v) for v in c)


def dice_score(pred, label) -> float:
    """MacroDiceMetric semantics: nan when the ground truth is empty."""
    tp, tn, fp, fn = _counts(pred, label)
    if tp + fn == 0:
        return float("nan")
    return 2.0 * tp / (2 * tp + fp + fn)


def iou_score(pred, label) -> float:
    tp, tn, fp, fn = _counts(pred, label)
    union = tp + fp + fn
    if union == 0:
        return float("nan")
    return tp / union


def accuracy_score(pred, label) -> float:
    tp, tn, fp, fn = _counts(pred, label)
    return (tp + tn) / (tp + tn + fp + fn)


def recall_score(pred, label) -> float:
    tp, tn, fp, fn = _counts(pred, label)
    denom = tp + fn
    return tp / denom if denom else float("nan")


def precision_score(pred, label) -> float:
    tp, tn, fp, fn = _counts(pred, label)
    denom = tp + fp
    return tp / denom if denom else float("nan")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def roc_auc_score(pred, label) -> float:
    """ROC AUC by the Mann-Whitney rank statistic (ties averaged), as MONAI
    ``compute_roc_auc`` on flattened probabilities."""
    y = _host(label).ravel() > 0
    s = _host(pred).astype(np.float64).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    _, inv, cnt = np.unique(s[order], return_inverse=True, return_counts=True)
    cum = np.cumsum(cnt)
    ranks[order] = (cum - (cnt - 1) / 2.0)[inv]
    auc = (ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def cl_dice_score(pred, label, device=None) -> float:
    """clDice of a prediction and a label (images, or z-stacks scored as
    volumes), thinned on ``device`` (the prediction's where None)."""
    p = _tensor(pred)
    p = p if device is None else p.to(device)
    return float(cl_dice(p, _tensor(label).to(p.device)))


class _ListMetric:
    def __init__(self, fn, volumetric: bool = False):
        self.fn = fn
        self.volumetric = volumetric
        self.scores: list[float] = []

    def __call__(self, y_pred, y):
        for p, t in zip(y_pred, y):
            if self.volumetric and p.ndim == 3:
                self.scores.append(self.fn(p, t))
                continue
            # per channel, as the reference's per-layer loop
            for c in range(p.shape[0]) if p.ndim >= 3 else [None]:
                pc = p[c] if c is not None else p
                tc = t[c] if c is not None else t
                self.scores.append(self.fn(pc, tc))

    def aggregate(self) -> float:
        if not self.scores:
            return 0.0
        return float(np.nanmean(self.scores))

    def reset(self):
        self.scores = []


def _is_zstack(config: dict) -> bool:
    """True for the 3D-reconstruction family: a ves-seg model whose output
    channels are the z-slices of one volume."""
    g = config.get("General", {}) if isinstance(config, dict) else {}
    model = g.get("model", {}) or {}
    return (str(g.get("task", "")) == "ves-seg"
            and int(model.get("out_channels", 1) or 1) > 1)


class MetricsManager:
    """Train: DSC and IoU; Validation and Test add ClDice, AUC, ACC, Recall
    and Precision. The comparison metric is DSC. ``device``: where ClDice
    thins (each input's own device where None)."""

    def __init__(self, phase: Phase = Phase.TRAIN, volumetric: bool = False,
                 device=None):
        base = {"DSC": _ListMetric(dice_score), "IoU": _ListMetric(iou_score)}
        if phase != Phase.TRAIN:
            base.update({
                "ClDice": _ListMetric(
                    functools.partial(cl_dice_score, device=device),
                    volumetric=volumetric),
                "AUC": _ListMetric(roc_auc_score),
                "ACC": _ListMetric(accuracy_score),
                "Recall": _ListMetric(recall_score),
                "Precision": _ListMetric(precision_score),
            })
        self.metrics = base
        self.comp = "DSC"

    def __call__(self, y_pred, y):
        for v in self.metrics.values():
            v(y_pred=y_pred, y=y)

    def aggregate_and_reset(self, prefix: str = "") -> dict[str, float]:
        d = {}
        for k, v in self.metrics.items():
            d[f"{prefix}_{k}"] = v.aggregate()
            v.reset()
        return d

    def get_comp_metric(self, prefix: str) -> str:
        return f"{prefix}_{self.comp}"
