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
