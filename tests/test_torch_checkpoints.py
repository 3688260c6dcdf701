"""Port parity: the stdlib msgpack checkpoint reader.

``octa_tpu_torch.io.checkpoints.load_checkpoint`` must return what the JAX
package's flax-based ``load_checkpoint`` returns, tensor for tensor
(exactly: same bytes, same dtype), on both shipped checkpoints and on a
checkpoint written by ``save_checkpoint`` with the value kinds flax encodes.
"""
import numpy as np
import jax
import pytest
from flax import serialization

from octa_tpu.io import checkpoints as jck
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.pipeline import G_CKPT, S_CKPT


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same(out, ref):
    lo, lr = _leaves(out), _leaves(ref)
    assert [k for k, _ in lo] == [k for k, _ in lr]
    for (k, x), (_, y) in zip(lo, lr):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("path,n", [(G_CKPT, 48), (S_CKPT, 60)])
def test_shipped_checkpoints_match(path, n):
    ref, out = jck.load_checkpoint(path), tck.load_checkpoint(path)
    assert set(out) == set(ref)
    assert out["epoch"] == ref["epoch"] and out["config"] == ref["config"]
    assert len(_leaves(out["model"])) == n
    _assert_same(out["model"], ref["model"])


def test_save_checkpoint_roundtrip(tmp_path, rng):
    payload = {
        "epoch": 3,
        "model": {"a": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
                  "i": np.arange(300, dtype=np.int64) - 150,
                  "b": np.array([True, False]),
                  "h": rng.normal(size=(5,)).astype(np.float16)},
        "optimizer": {"count": np.int32(7), "lr": 0.5},
        "config": {"k": [1, 2]},
    }
    path = jck.save_checkpoint(str(tmp_path / "c" / "t.ckpt"), payload)
    ref, out = jck.load_checkpoint(path), tck.load_checkpoint(path)
    assert out["config"] == ref["config"] == {"k": [1, 2]}
    _assert_same(out["model"], ref["model"])
    _assert_same(out["optimizer"], ref["optimizer"])


def test_msgpack_value_kinds():
    tree = {"neg": -3, "neg8": -100, "neg64": -2 ** 40, "u8": 200,
            "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 40, "f": 0.25,
            "t": True, "f0": False, "none": None, "s": "x" * 40,
            "long": "y" * 300, "list": [1, 2.5, "z"], "c": 1 + 2j,
            "np": np.float32(1.5), "e": {}}
    blob = serialization.msgpack_serialize(tree)
    assert tck.msgpack_restore(blob) == serialization.msgpack_restore(blob)


def test_bfloat16_and_truncation(rng):
    import jax.numpy as jnp

    x = jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)
    blob = serialization.msgpack_serialize({"x": np.asarray(x)})
    out = tck.msgpack_restore(blob)["x"]
    np.testing.assert_array_equal(out, np.asarray(x.astype(jnp.float32)))
    with pytest.raises(ValueError):
        tck.msgpack_restore(blob[:-3])


def test_layout_helpers_invert_jax(rng):
    w = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tck.conv_hwio_to_oihw(jck._conv_oihw_to_hwio(w)), w)
    np.testing.assert_array_equal(
        tck.convT_hwio_to_iohw(jck._convT_iohw_to_hwio(w)), w)


def _reference_generator_state_dict(rng, ngf: int, n_blocks: int) -> dict:
    """A state dict in the reference ``ResnetGenerator``'s layout
    (``networks.py:350-443``: one ``Sequential``, affine-free instance
    norms, blur filters as constants), random weights."""
    import torch

    def conv(key, c_out, c_in, k):
        return {f"{key}.weight": torch.from_numpy(
                    rng.normal(0, 0.1, (c_out, c_in, k, k)).astype(np.float32)),
                f"{key}.bias": torch.from_numpy(
                    rng.normal(0, 0.1, (c_out,)).astype(np.float32))}

    sd = {**conv("model.1", ngf, 1, 7), **conv("model.4", 2 * ngf, ngf, 3),
          **conv("model.8", 4 * ngf, 2 * ngf, 3)}
    for i in range(n_blocks):
        sd.update(conv(f"model.{12 + i}.conv_block.1", 4 * ngf, 4 * ngf, 3))
        sd.update(conv(f"model.{12 + i}.conv_block.5", 4 * ngf, 4 * ngf, 3))
    sd.update(conv(f"model.{12 + n_blocks + 1}", 2 * ngf, 4 * ngf, 3))
    sd.update(conv(f"model.{12 + n_blocks + 5}", ngf, 2 * ngf, 3))
    sd.update(conv(f"model.{12 + n_blocks + 9}", 1, ngf, 7))
    # the antialiasing filters the reference registers as buffers
    sd[f"model.{12 + n_blocks}.filt"] = torch.ones(4 * ngf, 1, 4, 4)
    return sd


@pytest.mark.parametrize("wrapped", [False, True])
def test_resnet_generator_pth_imports_as_in_jax(tmp_path, rng, wrapped):
    """A reference-layout generator ``.pth`` (plain, or as ``{"model":
    sd}``) loads in both packages to the same outputs (1e-5), and the port
    holds the file's tensors as they are."""
    import jax.numpy as jnp
    import torch

    sd = _reference_generator_state_dict(rng, ngf=8, n_blocks=2)
    path = str(tmp_path / "g.pth")
    torch.save({"model": sd} if wrapped else sd, path)
    cfg = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 2}
    ours = tck.load_network_for_inference(path, cfg, device="cpu")
    ref = jck.load_network_for_inference(path, cfg)
    x = rng.random((2, 1, 32, 32)).astype(np.float32)
    got = ours(torch.from_numpy(x)).numpy()
    want = np.asarray(ref(jnp.asarray(x).transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)
    from octa_tpu_torch.models.registry import build_network

    net = tck.import_resnet_generator_pth(path, build_network(cfg))
    assert torch.equal(net.resblock_1.conv2.weight,
                       sd["model.13.conv_block.5.weight"])
    assert torch.equal(net.up_conv_1.bias, sd["model.19.bias"])
    assert torch.equal(net.conv_out.weight, sd["model.23.weight"])
