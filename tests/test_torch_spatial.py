"""Height-sharded DynUNet inference in the port
(``octa_tpu_torch.parallel.spatial``) over several CPU processes (gloo):
the halo exchange against a zero pad (the counterpart of
``tests/test_spatial_sharding.py:27-40``), bit for bit; the sharded
forward against the JAX package's ``dynunet_spatial_infer`` on conftest's
virtual 8-device mesh, with the JAX parameters carried by the flax -> torch
converter, at 64², in float32 within 1e-5 of the output's largest
magnitude (at 128², largest 5.6, the port's sharded forward read 1.5e-5
from JAX's, and JAX's own sharded forward 1.4e-5 from its whole one: the
float32 rounding of another summation order); JAX's precondition errors. Every rank
runs one torch thread, every collective fails after 60 s and every launch
after its join timeout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.models.dynunet import DynUNet as JDynUNet
from octa_tpu.parallel.spatial import dynunet_spatial_infer, spatial_mesh
from octa_tpu_torch.models.dynunet import DynUNet
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.parallel import spatial
from tests import torch_mesh_workers as W

NET = dict(spatial_dims=2, in_channels=1, out_channels=1,
           kernel_size=[3] * 5, strides=[1, 2, 2, 2, 1],
           upsample_kernel_size=[1, 2, 2, 2, 1], filters=[8, 16, 32, 64, 64])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_halo_exchange_matches_zero_pad(tmp_path):
    x = np.random.default_rng(0).random((2, 3, 32, 8), np.float32)
    outs = mesh_lib.launch(W.halo, 4, torch.from_numpy(x), 1, 1,
                           tmp_dir=str(tmp_path))
    # each 8-row shard becomes 10 rows: [prev row | shard | next row]
    ref = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)))
    for s, out in enumerate(outs):
        np.testing.assert_array_equal(out.numpy(), ref[:, :, s * 8:s * 8 + 10])


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's ``dynunet_spatial_infer`` on a (1, 4) mesh: the parameters and
    input it took, and its output (NCHW)."""
    model = JDynUNet(**NET)
    # flax's init jitted: op by op it compiles a small program an operation
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 1)))
    x = np.random.default_rng(1).random((2, 64, 64, 1), np.float32)
    out = np.asarray(dynunet_spatial_infer(
        model, variables, jnp.asarray(x), spatial_mesh(n_data=1, n_space=4)))
    return (jax.tree.map(np.asarray, variables["params"]),
            x.transpose(0, 3, 1, 2).copy(), out.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("n_data,n_space", [(1, 4), (2, 2)])
def test_sharded_dynunet_matches_jax(jax_ref, tmp_path, n_data, n_space):
    """The port on a (1, 4) and a (2, 2) grid against JAX's (1, 4) sharded
    forward of the same batch of two."""
    state, x, ref = jax_ref
    outs = mesh_lib.launch(W.spatial_infer, n_data * n_space, state,
                           dict(NET), x, n_data, n_space,
                           tmp_dir=str(tmp_path))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


class _Grid:
    """A (data, space) grid with no process group: the preconditions are
    checked before anything is exchanged."""

    def __init__(self, n_data, n_space):
        dev = torch.device("cpu")
        self.data = mesh_lib.Mesh(None, 0, n_data, dev, ())
        self.space = mesh_lib.Mesh(None, 0, n_space, dev, ())
        self.device = dev


def test_spatial_infer_rejects_what_jax_rejects():
    net = DynUNet(filters=[4, 8, 8, 16, 16])
    # H=104, n_space=4 -> shard 26 -> 13 after one stride-2: invalid
    with pytest.raises(ValueError, match="odd at stride-2"):
        spatial.dynunet_spatial_infer(net, torch.zeros(2, 1, 104, 64),
                                      _Grid(2, 4))
    with pytest.raises(ValueError, match="not divisible by n_space"):
        spatial.dynunet_spatial_infer(net, torch.zeros(2, 1, 66, 64),
                                      _Grid(1, 4))
    with pytest.raises(ValueError, match="does not divide"):
        spatial.dynunet_spatial_infer(net, torch.zeros(3, 1, 64, 64),
                                      _Grid(2, 2))
    with pytest.raises(RuntimeError, match="no process group"):
        spatial.spatial_mesh(1, 1, device="cpu")
