"""Port parity: shared layers, resnetGenerator9 and DynUNet.

The flax modules of ``octa_tpu.models`` and their ports run on the same
numpy inputs; the networks carry the weights shipped in
``docker/trained_models`` (flax checkpoints read by the port's own reader and
mapped by ``flax_to_state_dict``). float32 on the CPU; tolerances cover
float32 convolutions summed in another order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.io.checkpoints import load_checkpoint as jax_load_checkpoint
from octa_tpu.models import layers as jl
from octa_tpu.models.dynunet import DynUNet as JDynUNet
from octa_tpu.models.resnet_gan import resnetGenerator9 as j_gen9
from octa_tpu_torch.io.checkpoints import (
    flax_to_state_dict,
    load_checkpoint,
    load_flax_params,
)
from octa_tpu_torch.models import layers as tl
from octa_tpu_torch.models.dynunet import DynUNet
from octa_tpu_torch.models.resnet_gan import resnetGenerator9
from octa_tpu_torch.pipeline import G_CKPT, S_CKPT, build_segmentor


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches(rng, affine):
    x = (rng.normal(size=(2, 12, 10, 6)) * 3 + 5).astype(np.float32)
    mod = jl.InstanceNorm(affine=affine)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = tl.InstanceNorm(6, affine=affine)
    if affine:
        p = {"scale": rng.normal(size=6).astype(np.float32),
             "bias": rng.normal(size=6).astype(np.float32)}
        variables = {"params": jax.tree.map(jnp.asarray, p)}
        load_flax_params(ours, p)
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(ours(_nchw(x))), ref, atol=1e-5)
    # bf16 in, statistics in float32, bf16 out
    ref16 = np.asarray(mod.apply(variables, jnp.asarray(x, jnp.bfloat16))
                       .astype(jnp.float32))
    out16 = ours(_nchw(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(out16), ref16, atol=2e-2)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 11, 7, 2)])
def test_blur_layers_match(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    down = np.asarray(jl.BlurDownsample().apply({}, jnp.asarray(x)))
    up = np.asarray(jl.BlurUpsample().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tl.BlurDownsample()(_nchw(x))), down,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(tl.BlurUpsample()(_nchw(x))), up,
                               atol=1e-5)


@pytest.mark.parametrize("path", [G_CKPT, S_CKPT])
def test_state_dict_covers_checkpoint(path):
    params = load_checkpoint(path)["model"]
    net = resnetGenerator9() if path == G_CKPT else build_segmentor()
    sd = flax_to_state_dict(params, net)
    assert len(sd) == len(net.state_dict()) == (48 if path == G_CKPT else 60)


def test_resnet_generator9_shipped_weights(rng):
    params = jax_load_checkpoint(G_CKPT)["model"]
    x = rng.random((2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(j_gen9().apply({"params": params}, jnp.asarray(x)))
    net = load_flax_params(resnetGenerator9(), load_checkpoint(G_CKPT)["model"])
    with torch.no_grad():
        out = net(_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, 1, 64, 64)
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4)


def test_dynunet_shipped_weights(rng):
    params = jax_load_checkpoint(S_CKPT)["model"]
    x = rng.random((1, 128, 128, 1)).astype(np.float32)
    jnet = JDynUNet(spatial_dims=2, in_channels=1, out_channels=1,
                    kernel_size=[3] * 5, strides=[1, 2, 2, 2, 1],
                    upsample_kernel_size=[1, 2, 2, 2, 1])
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = load_flax_params(build_segmentor(), load_checkpoint(S_CKPT)["model"])
    with torch.no_grad():
        out = net(_nchw(x))
    assert out.shape == (1, 1, 128, 128)
    assert np.abs(ref).max() > 1.0  # non-trivial logits
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4)


def test_dynunet_random_weights_small(rng):
    """Another topology (3 levels, stride-2 up k=2, custom filters) with
    random flax weights: the mapping is not tied to the shipped shapes."""
    jnet = JDynUNet(spatial_dims=2, in_channels=2, out_channels=3,
                    kernel_size=[3, 3, 3], strides=[1, 2, 1],
                    upsample_kernel_size=[1, 2, 1], filters=[8, 16, 24])
    x = rng.random((1, 32, 32, 2)).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.3).astype(np.float32),
        shapes["params"])
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = load_flax_params(
        DynUNet(2, 2, 3, [3, 3, 3], [1, 2, 1], [1, 2, 1], filters=[8, 16, 24]),
        params)
    with torch.no_grad():
        out = net(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4)


def test_flax_to_state_dict_rejects_mismatch():
    params = load_checkpoint(S_CKPT)["model"]
    small = DynUNet(2, 1, 1, [3, 3, 3], [1, 2, 1], [1, 2, 1])
    with pytest.raises((KeyError, ValueError)):
        flax_to_state_dict(params, small)
