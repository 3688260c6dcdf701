"""Reader for the JAX package's flax-msgpack checkpoints, and weight mapping.

Counterpart of ``octa_tpu/io/checkpoints.py`` ``load_checkpoint`` (:45-52)
and of its layout helpers ``_conv_oihw_to_hwio`` / ``_convT_iohw_to_hwio``
(:78-86), run in reverse.

The card's host has neither flax nor msgpack, so :func:`msgpack_restore` is
a small stdlib (``struct``) decoder for the subset that flax's
``msgpack_serialize`` writes: maps, arrays, strings, binaries, ints, floats,
booleans, nil, and the ext types flax defines (1: ndarray as a packed
``(shape, dtype-name, bytes)``; 2: complex; 3: numpy scalar), plus flax's
chunked form of oversized arrays.
"""
from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np
import torch
from torch import nn

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Sequential big-endian msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in scalars:
            return self.unpack(scalars[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen to float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(blob: bytes) -> Any:
    """Decode bytes written by flax ``serialization.msgpack_serialize``."""
    r = _Reader(blob)
    out = r.read()
    if r.pos != len(blob):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return _unchunk(out)


def load_checkpoint(path: str) -> dict[str, Any]:
    """``{"epoch", "model", "optimizer", "config"}`` as the JAX package's
    ``load_checkpoint`` returns it, with numpy arrays as leaves."""
    with open(path, "rb") as f:
        obj = msgpack_restore(f.read())
    out = dict(obj["state"])
    out["config"] = json.loads(obj.get("config_json", "{}"))
    return out


def _flatten(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), np.asarray(v)))
    return out


def conv_hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax ``nn.Conv`` kernel [kh, kw, in, out] -> torch [out, in, kh, kw]."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def convT_hwio_to_iohw(w: np.ndarray) -> np.ndarray:
    """Inverse of ``_convT_iohw_to_hwio``: flax ``nn.ConvTranspose`` kernel
    [kh, kw, in, out] -> torch ``ConvTranspose2d`` [in, out, kh, kw]. flax
    places ``x[i]*K[a]`` at output ``s*i + (k-1-a)`` where torch places
    ``x[i]*W[a]`` at ``s*i + a``, so the kernel is also flipped spatially."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def flax_to_state_dict(params: dict, module: nn.Module) -> dict[str, torch.Tensor]:
    """Map a JAX param tree (nested dicts of numpy arrays) onto ``module``.

    The port names its submodules as the flax modules are named, so the path
    ``resblock_0/conv1/kernel`` becomes ``resblock_0.conv1.weight``. Conv
    kernels go HWIO -> OIHW, transposed-conv kernels through
    :func:`convT_hwio_to_iohw`, and InstanceNorm ``scale`` becomes
    ``weight``. Raises if a tensor finds no home or a shape disagrees.
    """
    own = module.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mod_path, leaf = path
        sub = module.get_submodule(".".join(mod_path))
        if leaf == "kernel":
            if isinstance(sub, nn.ConvTranspose2d):
                arr = convT_hwio_to_iohw(arr)
            elif isinstance(sub, nn.Conv2d):
                arr = conv_hwio_to_oihw(arr)
            else:
                raise KeyError(f"{'/'.join(path)}: not a conv in the port")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"{'/'.join(path)}: unknown parameter kind")
        key = ".".join([*mod_path, name])
        if key not in own:
            raise KeyError(f"{'/'.join(path)} -> {key}: no such tensor")
        t = torch.from_numpy(np.array(arr, np.float32))
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(t.shape)} vs module "
                f"{tuple(own[key].shape)}")
        out[key] = t
    missing = set(own) - set(out)
    if missing:
        raise KeyError(f"tensors missing from the checkpoint: {sorted(missing)}")
    return out


def load_flax_params(module: nn.Module, params: dict) -> nn.Module:
    """Copy a JAX param tree into ``module`` (in place) and return it."""
    module.load_state_dict(flax_to_state_dict(params, module))
    return module
