"""Port parity: the loss functions and the loss registry.

Each loss of ``octa_tpu.utils.losses`` and its port run on the same seeded
numpy inputs (the port's images are NCHW where JAX's are NHWC): values
within 1e-6 (relative for values above 1), and the gradient with respect to
the prediction against ``jax.grad`` within 1e-5 relative L2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.ops import skeleton as jsk
from octa_tpu.utils import losses as jl
from octa_tpu_torch.ops import skeleton as tsk
from octa_tpu_torch.utils import losses as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: where test processes share the
    cores (pytest-xdist), torch's parallel regions wait on threads that are
    not running, and the plain K1 splat of a fixture graph at 128² took 123
    s instead of 2.5 s on eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


def _nchw(x):
    return torch.from_numpy(np.array(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(jfn, tfn, pred, y, *, image=True):
    """Value and gradient of ``fn(pred, y)`` in both packages."""
    ref, gref = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(y)))(
        jnp.asarray(pred))
    tp = (_nchw(pred) if image else torch.from_numpy(np.array(pred))).requires_grad_(True)
    ty = _nchw(y) if image else torch.from_numpy(np.array(y))
    out = tfn(tp, ty)
    out.backward()
    g = _nhwc(tp.grad) if image else tp.grad.numpy()
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6, abs=1e-6)
    assert _rel_l2(g, np.asarray(gref)) <= 1e-5


@pytest.fixture
def seg(rng):
    logits = (rng.normal(size=(2, 24, 28, 1)) * 3).astype(np.float32)
    y = (rng.random((2, 24, 28, 1)) < 0.3).astype(np.float32)
    return logits, y


def test_dice_bce_logits(seg):
    _check(jl.DiceBCELoss(True), tl.DiceBCELoss(True), *seg)


def test_dice_bce_probabilities(seg):
    logits, y = seg
    prob = np.asarray(jax.nn.sigmoid(logits))
    _check(jl.DiceBCELoss(False), tl.DiceBCELoss(False), prob, y)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_dice_loss(seg, sigmoid):
    logits, y = seg
    x = logits if sigmoid else np.asarray(jax.nn.sigmoid(logits))
    _check(lambda p, t: jl.dice_loss(p, t, sigmoid=sigmoid),
           lambda p, t: tl.dice_loss(p, t, sigmoid=sigmoid), x, y)


def test_bce(seg):
    logits, y = seg
    prob = np.asarray(jax.nn.sigmoid(logits))
    _check(jl.bce, tl.bce, prob, y)
    _check(jl.bce_with_logits, tl.bce_with_logits, logits, y)


def test_soft_cl_dice_loss(rng):
    pred = rng.random((2, 32, 36)).astype(np.float32)
    y = (rng.random((2, 32, 36)) < 0.4).astype(np.float32)
    _check(lambda p, t: jsk.soft_cl_dice_loss(p, t, iters=5),
           lambda p, t: tsk.soft_cl_dice_loss(p, t, iters=5), pred, y,
           image=False)


def test_cl_dice_combo_loss(seg):
    _check(jl._cl_dice_combo_loss, tl._cl_dice_combo_loss, *seg)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss"])
def test_regression_losses(rng, name):
    p = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    y = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    _check(getattr(jl, name)(), getattr(tl, name)(), p, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_class_losses(rng, weighted):
    logits = rng.normal(size=(10, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 10).astype(np.float32)
    w = [0.2, 0.5, 0.3] if weighted else None
    _check(jl.CrossEntropyLoss(w), tl.CrossEntropyLoss(w), logits, labels,
           image=False)
    _check(jl.WeightedCosineLoss(w or (1, 1, 1)),
           tl.WeightedCosineLoss(w or (1, 1, 1)), logits, labels, image=False)
    _check(jl.QWKLoss(), tl.QWKLoss(), logits, labels.astype(np.int32),
           image=False)
    reg = rng.normal(size=10).astype(np.float32)
    _check(jl.WeightedMSELoss([0.2, 0.5, 0.3]), tl.WeightedMSELoss([0.2, 0.5, 0.3]),
           reg, labels, image=False)


def test_registry_names(capsys):
    cfg = {"Train": {"batch_size": 2}}
    for name in ("DiceBCELoss", "CrossEntropyLoss", "MSELoss", "QWKLoss",
                 "L1Loss", "ClDiceLoss", "LSGANLoss", "AtLoss"):
        ours = tl.get_loss_function_by_name(name, cfg)
        ref = jl.get_loss_function_by_name(name, cfg)
        assert type(ours).__name__ == type(ref).__name__, name
    cfg_w = {"Data": {"class_balance": [0.5, 0.25, 0.25]}, "Train": {}}
    for name in ("CosineEmbeddingLoss", "WeightedMSELoss"):
        ours = tl.get_loss_function_by_name(name, cfg_w)
        np.testing.assert_allclose(ours.weights.numpy(), [2.0, 4.0, 4.0])
    assert tl.get_loss_function_by_name("none", cfg)(1, 2) is None
    assert "No loss function defined" in capsys.readouterr().out


@pytest.mark.parametrize("name,slice_", [("PatchNCELoss", "GAN"),
                                         ("LearnedPatchNCELoss", "GAN")])
def test_unported_losses_raise(name, slice_):
    """The contrastive GAN losses, once unported, now build with the
    batch size of ``Train.batch_size`` in both packages."""
    from octa_tpu.utils import losses as jl

    ours = tl.get_loss_function_by_name(name, {"Train": {"batch_size": 3}})
    ref = jl.get_loss_function_by_name(name, {"Train": {"batch_size": 3}})
    assert type(ours).__name__ == type(ref).__name__ == name
    assert ours.batch_size == ref.batch_size == 3
    assert ours.nce_T == ref.nce_T and ours.all_neg is ref.all_neg is False
    del slice_  # part of the case's id only
