"""Port parity: the noise model.

The resize and the composition are compared with ``octa_tpu`` on the same
numpy inputs; the random draws are injected into both (JAX's
``jax.random.gamma`` is monkeypatched to hand out the same numpy Gammas, in
the order the JAX function draws them). Sampling is checked against
analytic means, since torch and JAX draw different streams.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.models import noise_model as jnm
from octa_tpu_torch.models import noise_model as tnm


@pytest.mark.parametrize("src,dst,method", [
    ((9, 9), (304, 304), "cubic"),
    ((9, 7), (64, 40), "cubic"),
    ((64, 64), (40, 40), "linear"),
    ((40, 40), (64, 64), "linear"),
])
def test_resize_matches_jax(rng, src, dst, method):
    x = rng.random((2, *src)).astype(np.float32) * 10
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst), method))
    out = tnm.resize(torch.from_numpy(x), dst, method).numpy()
    # float32 weights built in another order: a few ulp of values ~10
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_torch_bicubic_is_not_jax_cubic(rng):
    """Why the resize is hand-written: torch's bicubic differs visibly."""
    x = rng.random((1, 9, 9)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 304, 304), "cubic"))
    tb = torch.nn.functional.interpolate(
        torch.from_numpy(x)[None], size=(304, 304), mode="bicubic",
        align_corners=False)[0].numpy()
    assert np.abs(tb - ref).max() > 1e-2


def _params(rng, b):
    cp = lambda: (10.0 ** (rng.random((b, 9, 9)) * 2 - 1)).astype(np.float32)
    return [cp(), cp(), cp(), cp(), rng.random((b, 9, 9)).astype(np.float32)]


@pytest.mark.parametrize("downsample_factor", [1.0, 2.0])
def test_apply_noise_model_injected_draws(rng, monkeypatch, downsample_factor):
    b, h, w = 2, 64, 48
    p = _params(rng, b)
    img = rng.random((b, h, w)).astype(np.float32)
    bg = rng.random((b, h, w)).astype(np.float32)
    hw = (int(h / downsample_factor), int(w / downsample_factor))
    draws = [rng.gamma(2.0, size=(b, *hw)).astype(np.float32) for _ in range(4)]
    queue = list(draws)
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a: jnp.asarray(queue.pop(0)))
    ref = np.asarray(jnm.apply_noise_model(
        jnm.NoiseParams(*map(jnp.asarray, p)), jax.random.PRNGKey(0),
        jnp.asarray(img), jnp.asarray(bg), downsample_factor=downsample_factor))
    assert not queue  # JAX consumed exactly the four injected draws
    out = tnm.apply_noise_model(
        tnm.NoiseParams(*map(torch.from_numpy, p)), torch.from_numpy(img),
        torch.from_numpy(bg), gammas=[torch.from_numpy(d) for d in draws],
        downsample_factor=downsample_factor)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_concentrations_match_jax_gamma_arguments(rng, monkeypatch):
    """The port draws its Gammas at the concentrations JAX draws at."""
    b, h, w = 2, 40, 40
    p = _params(rng, b)
    seen = []

    def fake_gamma(key, a):
        seen.append(np.asarray(a))
        return jnp.ones_like(a)

    monkeypatch.setattr(jax.random, "gamma", fake_gamma)
    jnm.apply_noise_model(jnm.NoiseParams(*map(jnp.asarray, p)),
                          jax.random.PRNGKey(0), jnp.zeros((b, h, w)),
                          jnp.zeros((b, h, w)))
    conc = tnm.beta_concentrations(tnm.NoiseParams(*map(torch.from_numpy, p)),
                                   (h, w))
    assert len(seen) == 4
    for s, c in zip(seen, conc):
        np.testing.assert_allclose(c.numpy(), s, rtol=1e-5, atol=1e-5)


def test_sample_noise_params_statistics():
    g = torch.Generator().manual_seed(0)
    p = tnm.sample_noise_params(400, g, device="cpu")
    # X ~ Beta(2,2) (pdf 6x(1-x)); E[10**(2X-1)] by quadrature
    x = np.linspace(0, 1, 200001)
    mean_cp = np.trapezoid(6 * x * (1 - x) * 10 ** (2 * x - 1), x)
    for cp in p[:4]:
        a = cp.numpy()
        assert a.shape == (400, 9, 9)
        assert a.min() >= 0.1 - 1e-5 and a.max() <= 10.0 + 1e-4
        assert abs(a.mean() - mean_cp) < 0.02 * mean_cp
    gm = p.gamma_cp.numpy()
    assert gm.min() >= 0.0 and gm.max() <= 1.0 and abs(gm.mean() - 0.5) < 0.01
    # same generator seed, same draws
    q = tnm.sample_noise_params(400, torch.Generator().manual_seed(0),
                                device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(p, q))


def test_beta_fields_statistics():
    """Beta(a, b) from two generator-driven Gammas has mean a / (a + b)."""
    g = torch.Generator().manual_seed(1)
    b, h, w = 4, 128, 128
    ones = torch.ones(b, 9, 9)
    p = tnm.NoiseParams(2 * ones, 3 * ones, 0.5 * ones, 0.5 * ones, ones)
    conc = tnm.beta_concentrations(p, (h, w))
    gx_d, gy_d, gx_s, gy_s = tnm.draw_gammas(conc, g)
    delta = tnm._beta_field(gx_d, gy_d)
    speckle = tnm._beta_field(gx_s, gy_s)
    assert abs(float(delta.mean()) - 0.4) < 0.005
    assert abs(float(speckle.mean()) - 0.5) < 0.005
    # Beta(2,3) variance ab / ((a+b)^2 (a+b+1)) = 0.04
    assert abs(float(delta.var()) - 0.04) < 0.002


def test_apply_noise_model_with_generator_range():
    g = torch.Generator().manual_seed(2)
    p = tnm.sample_noise_params(2, g, device="cpu")
    img, bg = torch.rand(2, 32, 32, generator=g), torch.rand(2, 32, 32, generator=g)
    out = tnm.apply_noise_model(p, img, bg, g)
    assert out.shape == (2, 32, 32) and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0 + 1e-5
    with pytest.raises(ValueError):
        tnm.apply_noise_model(p, img, bg)


@pytest.mark.parametrize("mode", ["PGA", "FGSM", "GS"])
def test_pga_update_matches(rng, mode):
    p = [rng.random((2, 9, 9)).astype(np.float32) for _ in range(5)]
    gr = [rng.normal(size=(2, 9, 9)).astype(np.float32) for _ in range(5)]
    ref = jnm.pga_update(jnm.NoiseParams(*map(jnp.asarray, p)),
                         jnm.NoiseParams(*map(jnp.asarray, gr)), 0.3, mode)
    out = tnm.pga_update(tnm.NoiseParams(*map(torch.from_numpy, p)),
                         tnm.NoiseParams(*map(torch.from_numpy, gr)), 0.3, mode)
    for x, y in zip(out, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
