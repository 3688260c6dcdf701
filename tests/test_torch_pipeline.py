"""Port parity: the whole adapt-and-segment slice against the JAX path.

Two fixture graphs go through ``octa_tpu_torch.pipeline.AdaptSegment`` on
the CPU and through the JAX path of ``bench.py`` ``adapted_pass``
(:419-433) at a small size (input 64², label 256², batch 2, shipped weights,
float32), with the same noise parameters and the same Gamma draws injected
into both. Tolerances: splat atol 1e-4 (as ``tests/test_pallas_splat.py``),
logits atol 1e-3 (float32 convolutions summed in another order, through two
networks), masks equal on at least 99.9 % of pixels.

Run as a script, ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_pipeline.py`` prints the JAX
adapted-path Dice on the four fixture graphs at full size (304² -> 1216²,
bf16 networks, ``bench.py``'s noise keys 7 and 8), the JAX side of the Dice
comparison with the port's number from ``chip_smoke.py``. It runs one image
at a time through the networks to keep host memory small (the networks act
on each image alone, so this equals the batched pass).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from octa_tpu.io.checkpoints import load_checkpoint as jax_load_checkpoint
from octa_tpu.models import noise_model as jnm
from octa_tpu.models.dynunet import DynUNet as JDynUNet
from octa_tpu.models.resnet_gan import resnetGenerator9 as j_gen9
from octa_tpu.ops import raster as jr
from octa_tpu_torch import pipeline as tp
from octa_tpu_torch.models import noise_model as tnm
from octa_tpu_torch.ops import raster as tr


def _jax_nets(dtype=jnp.float32):
    gen = j_gen9(dtype=dtype)
    seg = JDynUNet(spatial_dims=2, in_channels=1, out_channels=1,
                   kernel_size=[3] * 5, strides=[1, 2, 2, 2, 1],
                   upsample_kernel_size=[1, 2, 2, 2, 1], dtype=dtype)
    gp = jax_load_checkpoint(tp.G_CKPT)["model"]
    sp = jax_load_checkpoint(tp.S_CKPT)["model"]
    return gen, seg, gp, sp


def _jax_splat(a, b, w, v, res, k):
    return np.stack([np.asarray(jr.splat_lines_2d(
        jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(w[i]),
        jnp.asarray(v[i]), height=res, width=res, k_max=k))
        for i in range(a.shape[0])])


def _dice(pred, lab):
    inter = (pred & lab).sum((1, 2))
    return 2 * inter / np.maximum(pred.sum((1, 2)) + lab.sum((1, 2)), 1)


def test_slice_matches_jax(rng, monkeypatch):
    res_in, res_lab, bsz = 64, 256, 2
    samples = [tr.parse_graph_csv(p) for p in tr.fixture_graph_paths()[:bsz]]
    prep = tr.pad_batch_edges(samples, res_in, res_lab)
    params = [(10.0 ** (rng.random((bsz, 9, 9)) * 2 - 1)).astype(np.float32)
              for _ in range(4)] + [rng.random((bsz, 9, 9)).astype(np.float32)]
    gammas = [rng.gamma(1.5, size=(bsz, res_in, res_in)).astype(np.float32)
              for _ in range(4)]
    bg = tp.background(bsz, res_in)

    # --- JAX path (bench.py adapted_pass, float32, injected draws) ----------
    img_j = _jax_splat(*prep["in"], res_in, tp.K_IN)
    lab_j = _jax_splat(*prep["lab"], res_lab, tp.K_LAB) > tp.LABEL_THRESHOLD
    queue = list(gammas)
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a: jnp.asarray(queue.pop(0)))
    noised_j = jnm.apply_noise_model(
        jnm.NoiseParams(*map(jnp.asarray, params)), jax.random.PRNGKey(8),
        jnp.asarray(img_j), jnp.asarray(bg))
    gen, seg, gp, sp = _jax_nets()
    fake_j = gen.apply({"params": gp}, noised_j[..., None])
    up = jax.image.resize(fake_j, (bsz, res_lab, res_lab, 1), "linear")
    logits_j = np.asarray(seg.apply({"params": sp}, up))[..., 0]
    pred_j = 1 / (1 + np.exp(-logits_j)) > 0.5

    # --- the port on the CPU -------------------------------------------------
    edges = tp.edges_to_device(samples, "cpu", res_in, res_lab)
    pipe = tp.AdaptSegment("cpu", torch.float32, res_in=res_in,
                           res_lab=res_lab, max_batch=bsz)
    out = pipe.stages(edges["in"], edges["lab"],
                      tnm.NoiseParams(*map(torch.from_numpy, params)),
                      gammas=[torch.from_numpy(g) for g in gammas])
    pred, lab, dice = pipe(edges["in"], edges["lab"],
                           tnm.NoiseParams(*map(torch.from_numpy, params)),
                           gammas=[torch.from_numpy(g) for g in gammas])

    np.testing.assert_allclose(out["img"].numpy(), img_j, atol=1e-4)
    assert img_j.max() > 0.9 and lab_j.mean() > 0.05  # real vessel content
    assert (out["lab"].numpy() == lab_j).mean() >= 0.999
    np.testing.assert_allclose(out["noised"].numpy(), np.asarray(noised_j),
                               atol=1e-4)
    np.testing.assert_allclose(out["fake"][:, 0].numpy(),
                               np.asarray(fake_j)[..., 0], atol=1e-4)
    np.testing.assert_allclose(out["logits"][:, 0].numpy(), logits_j, atol=1e-3)
    assert (out["pred"].numpy() == pred_j).mean() >= 0.999
    assert torch.equal(pred, out["pred"]) and torch.equal(lab, out["lab"])
    np.testing.assert_allclose(dice.numpy(), _dice(pred_j, lab_j), atol=2e-3)


def test_noise_from_generator_is_seeded():
    """With a seeded generator the port's adapted path is deterministic."""
    samples = [tr.parse_graph_csv(tr.fixture_graph_paths()[0])]
    edges = tp.edges_to_device(samples, "cpu", 32, 64)
    nets = (torch.nn.Identity(), lambda x: torch.logit(x.clamp(1e-4, 1 - 1e-4)))
    pipe = tp.AdaptSegment("cpu", torch.float32, nets=nets, res_in=32,
                           res_lab=64, max_batch=1)
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        prm = tnm.sample_noise_params(1, g, device="cpu")
        runs.append(pipe.stages(edges["in"], edges["lab"], prm, g)["noised"])
    assert torch.equal(runs[0], runs[1])


def jax_adapted_dice_full_size():
    """JAX adapted-path Dice on the fixture graphs, as ``bench.py``'s rider
    computes it (bf16 networks, noise keys 7 and 8, one batch of four)."""
    samples = [tr.parse_graph_csv(p) for p in tr.fixture_graph_paths()]
    prep = tr.pad_batch_edges(samples, tp.RES_IN, tp.RES_LAB)
    n = len(samples)
    img = _jax_splat(*prep["in"], tp.RES_IN, tp.K_IN)
    lab = _jax_splat(*prep["lab"], tp.RES_LAB, tp.K_LAB) > tp.LABEL_THRESHOLD
    bg = tp.background(n)
    nprm = jnm.sample_noise_params(jax.random.PRNGKey(7), n)
    noised = jnm.apply_noise_model(nprm, jax.random.PRNGKey(8),
                                   jnp.asarray(img), jnp.asarray(bg))
    gen, seg, gp, sp = _jax_nets(jnp.bfloat16)

    @jax.jit
    def one(x):
        fake = gen.apply({"params": gp}, x[None, ..., None].astype(jnp.bfloat16))
        up = jax.image.resize(fake, (1, tp.RES_LAB, tp.RES_LAB, 1), "linear")
        return jax.nn.sigmoid(seg.apply({"params": sp}, up))[0, ..., 0] > 0.5

    pred = np.stack([np.asarray(one(noised[i])) for i in range(n)])
    return _dice(pred, lab)


if __name__ == "__main__":
    d = jax_adapted_dice_full_size()
    print("jax adapted-path dice per image:", d.tolist())
    print("jax adapted-path dice mean:", float(d.mean()))
