"""Read the shipped flax-msgpack checkpoints into plain tensors.

A small stdlib decoder for the subset of msgpack that flax's
``msgpack_serialize`` writes (maps, arrays, strings, binaries, numbers,
nil, booleans; ext type 1 ndarray and 3 numpy scalar; flax's chunked
arrays), and the mapping of a flax parameter tree onto the names the
reference networks use (``a/b/kernel`` -> ``a.b.weight``).
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
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

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if code in (1, 3):
            shape, dtype_name, buffer = _Reader(data).read()
            if isinstance(dtype_name, bytes):
                dtype_name = dtype_name.decode()
            if dtype_name == "bfloat16":
                bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
                arr = bits.view(np.float32).reshape(shape)
            else:
                arr = np.frombuffer(buffer, np.dtype(dtype_name)).reshape(shape)
            return arr if code == 1 else arr[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_params(path: str) -> dict:
    """The flax parameter tree of a checkpoint file (numpy leaves)."""
    with open(path, "rb") as f:
        blob = f.read()
    r = _Reader(blob)
    obj = _unchunk(r.read())
    state = obj["state"]
    json.loads(obj.get("config_json", "{}"))  # the file must be whole
    return state["model"]


def to_named(tree: dict, transposed=("transp_conv",)) -> dict[str, torch.Tensor]:
    """flax tree -> ``{dotted name: float32 tensor}`` in torch layouts: a
    conv kernel HWIO -> OIHW; a transposed conv's (a module named in
    ``transposed``) HWIO -> IOHW flipped in space, since flax places
    ``x[i] K[a]`` at ``s i + (k - 1 - a)``; ``scale`` -> ``weight``."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
                continue
            arr = np.asarray(v, np.float32)
            name = {"kernel": "weight", "scale": "weight"}.get(k, k)
            if k == "kernel":
                if prefix and prefix[-1] in transposed:
                    arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
                else:
                    arr = np.transpose(arr, (3, 2, 0, 1))
            out[".".join(prefix + [name])] = torch.from_numpy(
                np.array(arr, np.float32, order="C", copy=True))

    walk(tree, [])
    return out
