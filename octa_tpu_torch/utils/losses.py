"""Loss functions, and the loss registry.

Counterpart of ``octa_tpu/utils/losses.py``: ``dice_loss``,
``bce_with_logits``, ``bce`` and ``DiceBCELoss`` (:22-57); ``LSGANLoss``
(:60-69); ``L1Loss``,
``MSELoss``, ``CrossEntropyLoss``, ``PatchNCELoss``,
``LearnedPatchNCELoss``, ``WeightedCosineLoss``,
``WeightedMSELoss`` and ``QWKLoss`` (:72-178); ``ANTLoss`` (:181-272),
registered as ``AtLoss``; ``_cl_dice_combo_loss`` (:305); and
``get_loss_function_by_name`` (:275) with the same names.

Images are NCHW here where the JAX package has NHWC: the Dice sums run over
the spatial axes (2 and up) and the mean over batch and channel, as there.
Class scores stay on the last axis, as in the JAX package.

Every loss says whether it is a mean of per-sample terms
(``per_sample_mean``): then the mean of the losses of equal shards of a
batch is the loss of the whole batch. The others (the weighted losses,
``QWKLoss`` and ``ClDiceLoss``) are ratios of sums over the batch: they
take ``shard=`` (a :class:`octa_tpu_torch.parallel.mesh.Shard`), under
which they stack the sums they divide and take them over the global batch
in one all-reduce (:func:`octa_tpu_torch.parallel.mesh.global_sums`, whose
docstring gives the gradient rule). The trainers call the registry's
losses through :class:`TrainerLoss`, which hands them the step's shard.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from octa_tpu_torch.data import functional as tf
from octa_tpu_torch.models import noise_model as nm
from octa_tpu_torch.ops.skeleton import soft_cl_dice_loss
from octa_tpu_torch.parallel.mesh import global_sums

def dice_loss(y_pred, y, sigmoid=False, smooth_nr=1e-5, smooth_dr=1e-5):
    """MONAI DiceLoss (include_background, mean reduction) over NC[spatial]."""
    if sigmoid:
        y_pred = torch.sigmoid(y_pred)
    axes = tuple(range(2, y_pred.dim()))
    intersection = torch.sum(y_pred * y, dim=axes)
    denom = torch.sum(y_pred, dim=axes) + torch.sum(y, dim=axes)
    dice = (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return torch.mean(1.0 - dice)


def bce_with_logits(y_pred, y):
    return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y
                      + torch.log1p(torch.exp(-torch.abs(y_pred))))


def bce(y_pred, y, eps=1e-7):
    p = torch.clamp(y_pred, eps, 1 - eps)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


class DiceBCELoss:
    """(Dice + BCE) / 2 (reference ``losses.py:111-121``)."""

    per_sample_mean = True

    def __init__(self, sigmoid=False):
        self.sigmoid = sigmoid

    def __call__(self, y_pred, y):
        if self.sigmoid:
            return (dice_loss(y_pred, y, sigmoid=True)
                    + bce_with_logits(y_pred, y)) / 2
        return (dice_loss(y_pred, y) + bce(y_pred, y)) / 2


class LSGANLoss:
    """Least-squares GAN loss: the mean of ``(prediction - target)²`` over
    every element, the target 1 for real and 0 for fake (reference
    ``losses.py:183-202``)."""

    per_sample_mean = True

    def __init__(self, target_real_label=1.0, target_fake_label=0.0):
        self.real = target_real_label
        self.fake = target_fake_label

    def __call__(self, prediction, target_is_real: bool):
        target = self.real if target_is_real else self.fake
        return torch.mean((prediction - target) ** 2)


class PatchNCELoss:
    """Temperature-scaled InfoNCE over patch features (reference
    ``losses.py:204-265``, CUT; the JAX package's ``losses.py:96-130``).

    ``feat_q`` and ``feat_k`` are [B * P, dim], sample after sample; the key
    is detached. The positive is the row dot product; the negatives are the
    other patches of the same sample's keys (the diagonal set to -10), or
    ``neg_sample`` [B * N, dim] where given. The query is split into
    ``batch_size`` samples (1 with
    ``nce_includes_all_negatives_from_minibatch``). Returns the per-patch
    loss [B * P].

    ``shard`` (a :class:`octa_tpu_torch.parallel.mesh.Shard`) says that the
    features are this rank's rows of a global batch: the query splits into
    this rank's samples, and with all negatives from the minibatch the keys
    (and the given negatives, with their gradient) are gathered from every
    rank, so each row sees the global batch's negatives."""

    per_sample_mean = True

    def __init__(self, batch_size: int,
                 nce_includes_all_negatives_from_minibatch=False,
                 nce_T: float = 0.07):
        self.batch_size = batch_size
        self.all_neg = nce_includes_all_negatives_from_minibatch
        self.nce_T = nce_T

    def __call__(self, feat_q, feat_k, neg_sample=None, shard=None):
        num_patches, dim = feat_q.shape
        feat_k = feat_k.detach()
        l_pos = torch.sum(feat_q * feat_k, dim=-1, keepdim=True)
        gather = shard is not None and self.all_neg
        if self.all_neg:
            b = 1
        elif shard is None:
            b = self.batch_size
        else:
            b = self.batch_size * (shard.hi - shard.lo) // shard.n
        fq = feat_q.reshape(b, -1, dim)
        if neg_sample is not None:
            if gather:
                from torch.distributed.nn.functional import all_gather

                neg_sample = torch.cat(all_gather(neg_sample.contiguous(),
                                                  group=shard.mesh.group))
            ns = neg_sample.reshape(b, -1, dim)
            l_neg = torch.bmm(fq, ns.transpose(1, 2))
        else:
            keys = shard.gather(feat_k) if gather else feat_k
            fk = keys.reshape(b, -1, dim)
            npatches = fq.shape[1]
            l_neg = torch.bmm(fq, fk.transpose(1, 2))
            # a query's own key: at its row's offset in the global keys
            first = shard.mesh.rank * npatches if gather else 0
            diag = (torch.arange(fk.shape[1], device=feat_q.device)[None]
                    == torch.arange(npatches, device=feat_q.device)[:, None]
                    + first)[None]
            l_neg = l_neg.masked_fill(diag, -10.0)
        logits = torch.cat([l_pos, l_neg.reshape(num_patches, -1)],
                           dim=1) / self.nce_T
        return -torch.log_softmax(logits, dim=1)[:, 0]


class LearnedPatchNCELoss(PatchNCELoss):
    """NEGCUT's PatchNCE with learned negatives (reference ``losses.py:
    267-322``): the same loss, the negatives supplied."""


class L1Loss:
    per_sample_mean = True

    def __call__(self, y_pred, y):
        return torch.mean(torch.abs(y_pred - y))


class MSELoss:
    per_sample_mean = True

    def __call__(self, y_pred, y):
        return torch.mean((y_pred - y) ** 2)


def _weights(weights) -> torch.Tensor:
    """Class weights, kept in float64 and cast to the prediction's dtype
    where they are used (float32 values in a float32 step, as the JAX
    package's ``jnp.asarray`` gives; float64 with 64-bit types)."""
    return torch.as_tensor(weights, dtype=torch.float64)


def _one_hot(y: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a label outside 0..n-1 gives a row of zeros."""
    return (y[..., None] == torch.arange(n, device=y.device)).to(dtype)


def _ratio(num, den, shard):
    """``sum(num) / sum(den)`` over the global batch under ``shard``."""
    sums = global_sums(torch.stack([torch.sum(num), torch.sum(den)]), shard)
    return sums[0] / sums[1]


class CrossEntropyLoss:
    """Class scores on the last axis and integer labels of one dimension
    less (``jnp.take_along_axis``'s rule: other shapes raise ``ValueError``,
    as in the JAX package)."""

    class_last = True

    def __init__(self, weight=None):
        self.weight = None if weight is None else _weights(weight)
        self.per_sample_mean = weight is None

    def __call__(self, logits, labels, shard=None):
        if labels.dim() != logits.dim() - 1:
            raise ValueError(
                "CrossEntropyLoss: indices and arr must have the same number "
                f"of dimensions; {labels.dim() + 1} vs. {logits.dim()}")
        logp = torch.log_softmax(logits, dim=-1)
        labels = labels.long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        if self.weight is not None:
            w = self.weight.to(logp.device, logp.dtype)[labels]
            return _ratio(nll * w, w, shard)
        return torch.mean(nll)


class WeightedCosineLoss:
    """Class scores on the last axis; the one-hot labels broadcast against
    them or raise ``ValueError``, as in the JAX package."""

    per_sample_mean = False
    class_last = True

    def __init__(self, weights=(1, 1, 1)):
        self.weights = _weights(weights)

    def __call__(self, y_pred, y, shard=None):
        y = y.long()
        ypn = y_pred / (torch.linalg.norm(y_pred, dim=-1, keepdim=True) + 1e-12)
        onehot = _one_hot(y, y_pred.shape[-1], y_pred.dtype)
        try:
            torch.broadcast_shapes(ypn.shape, onehot.shape)
        except RuntimeError:
            raise ValueError(
                "WeightedCosineLoss: incompatible shapes for broadcasting: "
                f"{tuple(ypn.shape)} and {tuple(onehot.shape)}") from None
        cos = torch.sum(ypn * onehot, dim=-1)
        w = self.weights.to(y_pred.device, y_pred.dtype)[y]
        return 1 - _ratio(w * cos, w, shard)


class WeightedMSELoss:
    per_sample_mean = False

    def __init__(self, weights):
        self.weights = _weights(weights)

    def __call__(self, y_pred, y, shard=None):
        per = (y_pred - y) ** 2
        w = self.weights.to(y_pred.device, y_pred.dtype)[y.long()]
        return _ratio(per * w, w, shard)


class QWKLoss:
    """Quadratic-weighted-kappa loss (reference ``losses.py:136-170``) of
    [N, classes] scores and N labels; other shapes raise ``TypeError``, as
    the JAX package's matrix product does. Under ``shard`` the confusion
    matrix and the two histograms are summed over the global batch."""

    per_sample_mean = False
    class_last = True

    def __init__(self, scale=2.0, num_classes=3):
        self.scale = scale
        self.num_classes = num_classes

    def __call__(self, output, target, shard=None):
        n = self.num_classes
        target = _one_hot(target.reshape(-1).long(), n, output.dtype)
        if output.dim() != 2 or output.shape[0] != target.shape[0]:
            raise TypeError(
                f"QWKLoss: scores {tuple(output.shape)} for "
                f"{target.shape[0]} labels: takes [N, classes] scores and N "
                "labels")
        output = torch.softmax(output, dim=1)
        w = torch.arange(n, dtype=torch.float32, device=output.device) / (n - 1)
        w = (w - w[:, None]) ** 2
        conf = (output.T @ target).T
        hist_true = torch.sum(target, dim=0)
        hist_pred = torch.sum(output, dim=0)
        sums = global_sums(torch.cat([conf.reshape(-1), hist_true,
                                      hist_pred]), shard)
        conf = sums[:n * n].reshape(n, n)
        hist_true = sums[n * n:n * n + n, None]
        hist_pred = sums[n * n + n:, None]
        expected = (hist_true @ hist_pred.T) / torch.sum(conf)
        qwk = 1 - torch.sum(w * conf) / torch.sum(w * expected)
        return -torch.log(torch.sigmoid(self.scale * qwk))


class TrainerLoss:
    """A registry loss as a trainer's step calls it, on NCHW tensors:

    - a loss that takes class scores on the last axis (``class_last``:
      ``CrossEntropyLoss``, ``WeightedCosineLoss``, ``QWKLoss``) gets every
      tensor of three or more axes with axis 1 moved last, the NHWC layout
      in which the JAX package's trainers hand them over
      (``_batch_in``, ``octa_tpu/train/algorithms.py:110-112, 317-319``), so that it computes, or
      raises, as it does there;
    - a ratio of sums over the batch (``per_sample_mean`` False) gets
      ``shard=shard()``, the rows of the global batch that this rank steps
      on (None outside a step or on a mesh of one): the loss of the global
      batch, as XLA's SPMD step computes it.

    :meth:`wrap` returns any other loss unchanged."""

    def __init__(self, loss, shard: Callable):
        self.loss = loss
        self.shard = shard
        self.per_sample_mean = getattr(loss, "per_sample_mean", True)
        self.class_last = getattr(loss, "class_last", False)

    @classmethod
    def wrap(cls, loss, shard: Callable):
        if getattr(loss, "per_sample_mean", True) and \
                not getattr(loss, "class_last", False):
            return loss
        return cls(loss, shard)

    def __call__(self, *args):
        if self.class_last:
            args = tuple(a.movedim(1, -1) if torch.is_tensor(a) and a.dim() >= 3
                         else a for a in args)
        if self.per_sample_mean:
            return self.loss(*args)
        return self.loss(*args, shard=self.shard())


class ANTDecisions(NamedTuple):
    """The random geometry of one ANT call, one value per sample, on the
    device: rot90 counts and angles (degrees) for image and label,
    resolution factors for the image, crop offsets ([B, 2] row, column)."""
    rot_k: torch.Tensor
    angle: torch.Tensor
    factor: torch.Tensor
    crop_off: torch.Tensor


class ANTLoss:
    """Adversarial noise training (reference ``ANTLoss``,
    ``utils/losses.py:11-109``; JAX ``losses.py:181-272``): ``num_iters -
    1`` projected-gradient-ascent steps on the noise model's control points
    that raise the segmentation loss of the frozen segmentor, through noise
    model -> linear resize to the label's size -> rot90 -> rotation ->
    resolution decrease -> crop, the same geometry applied to the label
    (thresholded at ``label_threshold``). Returns the hardened sample,
    detached, and the label.

    ``__call__(seg_apply, x, background, y)``: ``seg_apply(img)`` maps an
    NCHW batch to NCHW logits; ``x`` and ``background`` are [B, h, w] of
    one size (the JAX function multiplies them; it fails where they
    differ), ``y`` is [B, H, W]. The decisions, the control points and the
    noise draws come from ``generator`` (on the device) in the JAX
    function's order: :meth:`decisions`, :meth:`noise_params`, then one saved
    state that every iteration's Gamma draw restores (:meth:`gamma_draw`,
    as JAX keeps one noise key over the loop). A test overrides those three
    methods to hand in the JAX package's draws. Only the control points take
    gradients (``torch.autograd.grad``): nothing lands in a parameter's
    ``.grad``. After a call, ``seg_losses`` holds the segmentation loss of
    each ascent step and ``param_grads`` its control-point gradients, on the
    device.

    ``shard`` (a :class:`octa_tpu_torch.parallel.mesh.Shard`) says that the
    batch is this rank's rows of a global batch: the decisions, control
    points and Gamma fields are drawn for the global batch and the rank
    keeps its rows, and the ascent takes the gradient of the loss scaled by
    B_local / B_global, the global batch mean's gradient for these
    samples' control points (the step ``p + alpha g`` depends on its
    scale). A trainer's inner loss that is a ratio of sums over the batch
    (a :class:`TrainerLoss`) takes the same shard from the trainer, and its
    gradient follows the rule of
    :func:`~octa_tpu_torch.parallel.mesh.global_sums`, so the same scale
    holds for it."""

    per_sample_mean = True

    def __init__(self, loss_fun: Callable, grid_size=(9, 9), lambda_delta=1.0,
                 lambda_speckle=0.7, lambda_gamma=0.3, max_decrease_res=0.25,
                 alpha=1e-3, crop=(1, 1), label_threshold=0.1, num_iters=3,
                 generator: torch.Generator | None = None):
        self.loss_fun = loss_fun
        self.grid_size = tuple(grid_size)
        self.lambda_delta = lambda_delta
        self.lambda_speckle = lambda_speckle
        self.lambda_gamma = lambda_gamma
        self.max_decrease_res = max_decrease_res
        self.alpha = alpha
        self.crop = tuple(crop)
        self.label_threshold = label_threshold
        self.num_iters = num_iters
        self.generator = generator
        self.seg_losses: list[torch.Tensor] = []
        self.param_grads: list[nm.NoiseParams] = []

    # -- the draws, in the JAX function's order ---------------------------
    def decisions(self, b: int, h: int, w: int, device) -> ANTDecisions:
        g = self.generator
        ch, cw = self.crop_size(h, w)
        rot_k = torch.randint(0, 4, (b,), generator=g, device=device)
        angle = torch.rand(b, generator=g, device=device) * 20.0 - 10.0
        factor = (torch.rand(b, generator=g, device=device)
                  * (1.0 - self.max_decrease_res) + self.max_decrease_res)
        oy = torch.randint(0, h - ch + 1, (b,), generator=g, device=device)
        ox = torch.randint(0, w - cw + 1, (b,), generator=g, device=device)
        return ANTDecisions(rot_k, angle, factor, torch.stack([oy, ox], -1))

    def noise_params(self, b: int, device) -> nm.NoiseParams:
        return nm.sample_noise_params(b, self.generator, self.grid_size,
                                      device=device)

    def gamma_draw(self):
        return nm.fixed_state_draw(self.generator)

    # ---------------------------------------------------------------------
    def crop_size(self, h: int, w: int) -> tuple[int, int]:
        return int(h * self.crop[0]), int(w * self.crop[1])

    def _geometry(self, img: torch.Tensor, d: ANTDecisions,
                  decrease: bool) -> torch.Tensor:
        """rot90, rotation, (resolution decrease,) crop of [B, H, W]."""
        h, w = img.shape[-2:]
        img = tf.rot90_traceable(img, d.rot_k)
        img = tf.rotate_bilinear(img, d.angle.to(img.dtype))
        if decrease:
            img = tf.decrease_resolution(img, d.factor.to(img.dtype),
                                         self.max_decrease_res)
        if self.crop != (1, 1):
            img = tf.crop_per_sample(img, d.crop_off, self.crop_size(h, w))
        return img

    def __call__(self, seg_apply: Callable, x: torch.Tensor,
                 background: torch.Tensor, y: torch.Tensor, shard=None):
        if x.shape != background.shape:
            raise ValueError(
                f"ANTLoss: image {tuple(x.shape)} and background "
                f"{tuple(background.shape)} differ in shape; the noise model "
                "multiplies them (the JAX ANTLoss fails there too). Keep the "
                "image at the background's size before the loss: the loss "
                "resizes its sample to the label's size itself")
        b, h, w = y.shape
        dev = y.device
        n = b if shard is None else shard.n
        take = (lambda t: t) if shard is None else shard.take
        d = ANTDecisions(*(take(t) for t in self.decisions(n, h, w, dev)))
        y_crop = (self._geometry(y, d, decrease=False)
                  >= self.label_threshold).to(y.dtype)
        params = self.noise_params(n, dev)
        params = nm.NoiseParams(*(take(p).to(x.dtype) for p in params))
        draw = self.gamma_draw()
        if shard is not None:
            draw = nm.sharded_draw(draw, shard)

        def make_sample(p):
            adv = nm.apply_noise_model(
                p, x, background, draw=draw, lambda_delta=self.lambda_delta,
                lambda_speckle=self.lambda_speckle,
                lambda_gamma=self.lambda_gamma)
            return self._geometry(nm.resize(adv, (h, w), "linear"), d,
                                  decrease=True)

        self.seg_losses, self.param_grads = [], []
        for _ in range(self.num_iters - 1):
            p = nm.NoiseParams(*(t.detach().requires_grad_(True)
                                 for t in params))
            loss = self.loss_fun(seg_apply(make_sample(p)[:, None]),
                                 y_crop[:, None])
            grads = nm.NoiseParams(*torch.autograd.grad(loss * (b / n),
                                                        tuple(p)))
            self.seg_losses.append(loss.detach())
            self.param_grads.append(grads)
            params = nm.pga_update(nm.NoiseParams(*(t.detach() for t in p)),
                                   grads, self.alpha, "PGA")
        with torch.no_grad():
            adv = make_sample(params)
        return adv, y_crop


def _cl_dice_combo_loss(y_pred, y, alpha=0.5, shard=None):
    """DiceBCE + soft-clDice combination on NCHW logits. Under ``shard``
    the soft clDice's sums run over the global batch; the DiceBCE half, a
    mean of per-sample terms, stays this rank's (the trainer's mean of the
    ranks' losses and gradients makes it the global batch's)."""
    base = DiceBCELoss(True)(y_pred, y)
    cl = soft_cl_dice_loss(torch.sigmoid(y_pred)[:, 0], y[:, 0], shard=shard)
    return (1 - alpha) * base + alpha * cl


_cl_dice_combo_loss.per_sample_mean = False  # soft clDice: batch-wide sums


def get_loss_function_by_name(name: str, config: dict, scaler=None, loss=None,
                              generator: torch.Generator | None = None):
    """Loss registry (reference ``losses.py:325-353``). ``AtLoss`` wraps
    ``loss`` and draws from ``generator`` (the port's addition: JAX passes
    a key to each call)."""
    weight = None
    if "Data" in config:
        weight = [1.0 / c for c in config["Data"]["class_balance"]]
    loss_map = {
        "AtLoss": lambda: ANTLoss(loss, generator=generator,
                                  **(config["Train"].get("AT") or {})),
        "DiceBCELoss": lambda: DiceBCELoss(True),
        "CrossEntropyLoss": lambda: CrossEntropyLoss(weight=weight),
        "CosineEmbeddingLoss": lambda: WeightedCosineLoss(weights=weight),
        "MSELoss": lambda: MSELoss(),
        "WeightedMSELoss": lambda: WeightedMSELoss(weights=weight),
        "QWKLoss": lambda: QWKLoss(),
        "LSGANLoss": lambda: LSGANLoss(),
        "L1Loss": lambda: L1Loss(),
        "PatchNCELoss": lambda: PatchNCELoss(
            batch_size=config["Train"]["batch_size"]),
        "LearnedPatchNCELoss": lambda: LearnedPatchNCELoss(
            batch_size=config["Train"]["batch_size"]),
        "ClDiceLoss": lambda: _cl_dice_combo_loss,
    }
    if name in loss_map:
        return loss_map[name]()
    print("Warning: No loss function defined. "
          "Ignore this message for parameterless models.")
    return lambda *args, **kwargs: None
