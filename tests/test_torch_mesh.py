"""The port's mesh (``octa_tpu_torch.parallel.mesh``) over several CPU
processes (gloo, spawned by ``parallel.mesh.launch`` with a ``file://``
rendezvous under the test's directory): JAX's divisor rule and the rows
each rank keeps (``shard_of``) against ``octa_tpu.parallel.mesh.get_mesh``
and ``batch_sharding`` on conftest's eight virtual devices, exactly; the data-
parallel trainer's replication of a batch that does not divide the mesh
(``BaseAlgorithm.shard_array``); the collectives a step uses; PatchNCE with
the negatives of the whole minibatch, its rows split over two ranks,
against the loss of the whole batch in one process (1e-12 in float64).
Every rank runs one torch thread, every collective fails after 60 s and
every launch after its join timeout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.parallel import mesh as jmesh
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.utils.losses import PatchNCELoss
from tests import torch_mesh_workers as W

BATCHES = (6, 4, 3, 1, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_alone_there_is_no_mesh(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.get_mesh(batch_size=4, device="cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh_lib.get_mesh(device="cpu") is None
    assert mesh_lib.shard_of(None, 4) is None
    assert mesh_lib.read_on_first(None, lambda: 7) == 7
    assert mesh_lib.broadcast_object(5) == 5


def test_divisor_rule_and_rows_match_jax(tmp_path):
    outs = mesh_lib.launch(W.mesh_rules, 4, BATCHES, tmp_dir=str(tmp_path))
    for i, bs in enumerate(BATCHES):
        jm = jmesh.get_mesh(n_devices=4, batch_size=bs)
        x = jax.device_put(jnp.arange(bs), jmesh.batch_sharding(jm))
        rows = {d: sorted(np.asarray(s.data).tolist())
                for s in x.addressable_shards for d in [s.device]}
        for rank, out in enumerate(outs):
            grank, mrank, size, got = out[i]
            assert grank == rank and size == jm.size, (bs, out[i])
            if rank < jm.size:
                assert mrank == rank
                assert got == rows[jm.devices[rank]], (bs, rank)
            else:  # outside JAX's mesh: no rows, no steps
                assert mrank == -1 and got is None


class _Mesh(mesh_lib.Mesh):
    """A mesh with no process group behind it: enough for row arithmetic."""

    def __init__(self, rank, size):
        super().__init__(None, rank, size, torch.device("cpu"),
                         tuple(range(size)))


@pytest.mark.parametrize("n", [4, 3, 6])
def test_a_batch_that_does_not_divide_the_mesh_runs_whole(n):
    """JAX's ``shard_array`` replicates a batch whose rows do not divide
    the mesh (``octa_tpu/train/algorithms.py:102-109``); the port's trainer
    then steps on the whole batch on every rank."""
    m = _Mesh(1, 2)
    s = mesh_lib.shard_of(m, n)
    if n % 2:
        assert s is None
    else:
        assert (s.lo, s.hi) == (n // 2, n)
        assert s.take(torch.arange(n)).tolist() == list(range(n // 2, n))
    assert mesh_lib.shard_of(_Mesh(-1, 2), 4) is None  # outside the mesh


def test_patch_nce_with_all_negatives_over_two_ranks(tmp_path):
    rng = np.random.default_rng(3)
    batch, patches, dim = 4, 8, 16
    fq = rng.normal(size=(batch * patches, dim))
    fk = rng.normal(size=(batch * patches, dim))
    fq /= np.linalg.norm(fq, axis=1, keepdims=True)
    fk /= np.linalg.norm(fk, axis=1, keepdims=True)
    outs = mesh_lib.launch(W.nce_all_negatives, 2, fq, fk, batch,
                           tmp_dir=str(tmp_path))
    q = torch.from_numpy(fq).requires_grad_()
    loss = PatchNCELoss(batch, True)(q, torch.from_numpy(fk))
    loss.mean().backward()
    np.testing.assert_allclose(np.concatenate([o[0] for o in outs]),
                               loss.detach().numpy(), rtol=1e-12)
    # the gradient of the global mean: each rank's rows of the whole one
    np.testing.assert_allclose(np.concatenate([o[1] for o in outs]),
                               q.grad.numpy(), rtol=1e-12, atol=1e-15)
    # without all negatives the query splits into the rank's samples
    sh = mesh_lib.Shard(_Mesh(1, 2), batch)
    half = slice(sh.lo * patches, sh.hi * patches)
    part = PatchNCELoss(batch)(torch.from_numpy(fq[half]),
                               torch.from_numpy(fk[half]), shard=sh)
    whole = PatchNCELoss(batch)(torch.from_numpy(fq), torch.from_numpy(fk))
    np.testing.assert_allclose(part.numpy(), whole[half].numpy(), rtol=1e-12)
