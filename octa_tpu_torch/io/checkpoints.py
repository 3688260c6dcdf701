"""The JAX package's flax-msgpack checkpoints: reader, writer, weight mapping.

Counterpart of ``octa_tpu/io/checkpoints.py``: ``save_checkpoint`` (:27),
``load_checkpoint`` (:45-52), ``restore_like`` (:55), the ``.pth`` imports of
a DynUNet (:89) and of a ``ResnetGenerator`` (:121) and
``load_network_for_inference`` (:149); and of its layout
helpers ``_conv_oihw_to_hwio`` / ``_convT_iohw_to_hwio`` (:78-86), both
ways. A checkpoint the port writes is the file the JAX package writes for
the same values: the network's parameters under the flax names and layouts
(:func:`state_dict_to_flax`), and an optimizer checkpoint holding Adam's
step, moments and learning rate where optax's ``inject_hyperparams(chain(
add_decayed_weights, adam))`` state keeps them (:func:`adam_state_to_flax`).
:func:`load_adam_state` reads such a checkpoint of either package back
into a torch optimizer.

The card's host has neither flax nor msgpack, so :func:`msgpack_restore` is
a small stdlib (``struct``) decoder for the subset that flax's
``msgpack_serialize`` writes: maps, arrays, strings, binaries, ints, floats,
booleans, nil, and the ext types flax defines (1: ndarray as a packed
``(shape, dtype-name, bytes)``; 2: complex; 3: numpy scalar), plus flax's
chunked form of oversized arrays. :func:`msgpack_serialize` writes the same
subset as flax does (smallest encodings, arrays as ext type 1), so that
flax's ``msgpack_restore`` reads it.
"""
from __future__ import annotations

import json
import os
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


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_len(out: list, n: int, small: tuple, codes: tuple) -> None:
    """Header of a str/bin/array/map/ext of length ``n``: the fix form
    ``small = (limit, base)`` when it fits, else the 8/16/32-bit form."""
    limit, base = small
    if n <= limit and base is not None:
        out.append(struct.pack(">B", base | n))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: list, n: int) -> None:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: integer {n} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: integer {n} too small")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(struct.pack(">B", fixed[len(data)]))
    else:
        _pack_len(out, len(data), (-1, None), (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code) + data)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured arrays are not written")
    return msgpack_serialize([list(arr.shape), arr.dtype.name,
                              np.ascontiguousarray(arr).tobytes()])


def _pack(out: list, obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (31, 0xA0), (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), (-1, None), (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (15, 0x80), (None, 0xDE, 0xDF))
        for k, v in sorted(obj.items()):  # flax writes its keys sorted
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (15, 0x90), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts, lists, numpy arrays and scalars as flax's
    ``msgpack_serialize`` does (arrays above 1 GiB, which flax chunks, are
    refused)."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


def save_checkpoint(path: str, payload: dict[str, Any]) -> str:
    """Save ``{"epoch", "model": flax tree, "optimizer": flax tree,
    "config"}`` as the JAX package's ``save_checkpoint`` does."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v for k, v in payload.items() if k != "config"}
    for k in ("model", "optimizer"):
        if state.get(k) is not None:
            state[k] = _numpy_tree(state[k])
            if any(x.nbytes > 2 ** 30 for _, x in _flatten(state[k])):
                raise ValueError(f"{path}: an array above 1 GiB is not written")
    blob = msgpack_serialize(
        {"state": state,
         "config_json": json.dumps(payload.get("config", {}), default=str)})
    with open(path, "wb") as f:
        f.write(blob)
    return path


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _nest(flat: dict[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = arr
    return out


def state_dict_to_flax(module: nn.Module,
                       tensors: dict[str, torch.Tensor] | None = None) -> dict:
    """Inverse of :func:`flax_to_state_dict`: ``module``'s parameters (or
    ``tensors``, a mapping from its parameter names to tensors of their
    shapes, such as gradients or Adam's moments) as a flax param tree of
    float32 numpy arrays in flax layouts."""
    if tensors is None:
        tensors = dict(module.named_parameters())
    flat = {}
    for key, t in tensors.items():
        *mod_path, name = key.split(".")
        sub = module.get_submodule(".".join(mod_path))
        arr = t.detach().float().cpu().numpy()
        if name == "weight" and isinstance(sub, nn.ConvTranspose2d):
            leaf, arr = "kernel", np.ascontiguousarray(
                np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1)))
        elif name == "weight" and isinstance(sub, nn.Conv2d):
            leaf, arr = "kernel", np.ascontiguousarray(
                np.transpose(arr, (2, 3, 1, 0)))
        elif name == "weight":
            leaf = "scale"
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"{key}: unknown parameter kind")
        flat[(*mod_path, leaf)] = arr
    return _nest(flat)


def restore_like(module: nn.Module, loaded: dict) -> nn.Module:
    """Load a flax param tree into ``module``, each tensor in the dtype of
    the parameter it replaces (the JAX ``restore_like`` of a network)."""
    own = module.state_dict()
    sd = {k: v.to(own[k].dtype) for k, v in flax_to_state_dict(loaded, module).items()}
    module.load_state_dict(sd)
    return module


def adam_state_to_flax(optimizer: torch.optim.Adam,
                       modules: dict[str, nn.Module]) -> dict:
    """A one-group ``torch.optim.Adam`` over the parameters of ``modules``
    (network name -> network) as the state dict of optax's
    ``inject_hyperparams(chain(add_decayed_weights, adam))`` over the JAX
    package's ``{name: params}``: the step in ``count``, the learning rate in
    ``hyperparams/learning_rate`` and the moments under each network's flax
    names in ``inner_state/1/0/{mu,nu}/<name>``."""
    group = optimizer.param_groups[0]
    step = 0
    mu, nu = {}, {}
    for name, module in modules.items():
        m, v = {}, {}
        for pname, p in module.named_parameters():
            st = optimizer.state.get(p, {})
            m[pname] = st.get("exp_avg", torch.zeros_like(p))
            v[pname] = st.get("exp_avg_sq", torch.zeros_like(p))
            step = int(st["step"]) if "step" in st else step
        mu[name] = state_dict_to_flax(module, m)
        nu[name] = state_dict_to_flax(module, v)
    count = np.asarray(step, np.int32)
    return {
        "count": count,
        "hyperparams": {"learning_rate": np.asarray(group["lr"], np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {}, "1": {
            "0": {"count": count, "mu": mu, "nu": nu},
            "1": {}}},
    }


def load_adam_state(optimizer: torch.optim.Adam,
                    modules: dict[str, nn.Module], tree: dict) -> None:
    """Inverse of :func:`adam_state_to_flax`."""
    adam = tree["inner_state"]["1"]["0"]
    step = int(np.asarray(adam["count"]))
    optimizer.param_groups[0]["lr"] = float(
        np.asarray(tree["hyperparams"]["learning_rate"]))
    for name, module in modules.items():
        mu = flax_to_state_dict(adam["mu"][name], module)
        nu = flax_to_state_dict(adam["nu"][name], module)
        for pname, p in module.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": mu[pname].to(p.device, p.dtype),
                "exp_avg_sq": nu[pname].to(p.device, p.dtype)}


# ---------------------------------------------------------------------------
# torch .pth import and inference
# ---------------------------------------------------------------------------

def _torch_load(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` state dict, unwrapped from ``{"model": sd}`` where it is
    so wrapped (the JAX package's ``_torch_load``, :70-75)."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    return ck["model"] if isinstance(ck, dict) and "model" in ck else ck


def import_dynunet_pth(path: str, module: nn.Module) -> nn.Module:
    """Load a MONAI DynUNet ``state_dict`` (``.pth``) into the port's
    DynUNet: the same torch layouts under MONAI's names."""
    sd = _torch_load(path)
    out = {}
    for key in module.state_dict():
        src = key
        for ours, monai in (("downsample_", "downsamples."),
                            ("upsample_", "upsamples.")):
            if src.startswith(ours):
                src = monai + src[len(ours):]
        parts = src.split(".")
        if parts[-2].startswith("conv") and parts[-2] != "conv_block":
            parts.insert(-1, "conv")  # MONAI wraps each conv: convN.conv.weight
        elif parts[-2] == "transp_conv":
            parts.insert(-1, "conv")
        elif parts[0] == "output_block":
            parts = ["output_block", "conv", "conv", parts[-1]]
        out[key] = sd[".".join(parts)]
    module.load_state_dict(out)
    return module


def import_resnet_generator_pth(path: str, module: nn.Module) -> nn.Module:
    """Load the reference's ``ResnetGenerator`` ``state_dict`` (``.pth``;
    ``networks.py:350-443``, the antialiased generator as one
    ``Sequential``) into the port's ``ResnetGenerator`` with ``n`` blocks:
    ``model.1`` is ``conv_in``, ``model.4`` and ``model.8`` the two
    down-convolutions, ``model.{12+i}.conv_block.{1,5}`` the two
    convolutions of block ``i``, ``model.{12+n+1}`` and ``model.{12+n+5}``
    the two up-convolutions and ``model.{12+n+9}`` ``conv_out``, all in
    torch's layouts. The reference's instance norms are affine-free and its
    blur filters constants, so nothing else is loaded; a bias the file
    lacks keeps the module's value (the JAX package keeps its own)."""
    sd = _torch_load(path)
    n = module.n_blocks
    names = {"conv_in": "model.1", "down_conv_0": "model.4",
             "down_conv_1": "model.8", "up_conv_0": f"model.{12 + n + 1}",
             "up_conv_1": f"model.{12 + n + 5}", "conv_out": f"model.{12 + n + 9}"}
    for i in range(n):
        names[f"resblock_{i}.conv1"] = f"model.{12 + i}.conv_block.1"
        names[f"resblock_{i}.conv2"] = f"model.{12 + i}.conv_block.5"
    out = module.state_dict()
    for ours, ref in names.items():
        out[f"{ours}.weight"] = sd[f"{ref}.weight"]
        if f"{ref}.bias" in sd:
            out[f"{ours}.bias"] = sd[f"{ref}.bias"]
    module.load_state_dict(out)
    return module


def load_network_for_inference(model_path, model_config: dict | None,
                               device="cuda"):
    """A frozen ``apply(nchw_batch) -> nchw_batch`` from a checkpoint
    (``.ckpt`` of either package, or a MONAI DynUNet or reference
    ``ResnetGenerator`` ``.pth``), on ``device``."""
    from octa_tpu_torch.device import resolve_device
    from octa_tpu_torch.models.dynunet import DynUNet
    from octa_tpu_torch.models.registry import build_network
    from octa_tpu_torch.models.resnet_gan import ResnetGenerator

    dev = resolve_device(device)
    net = build_network(dict(model_config or {"name": "resnetGenerator9"}))
    if isinstance(model_path, dict):  # {"generator": path, ...}: the first
        model_path = next(iter(model_path.values()))
    if str(model_path).endswith(".pth"):
        if isinstance(net, DynUNet):
            import_dynunet_pth(str(model_path), net)
        elif isinstance(net, ResnetGenerator):
            import_resnet_generator_pth(str(model_path), net)
        else:
            raise NotImplementedError(
                f".pth import for {type(net).__name__} not yet supported")
    else:
        ck = load_checkpoint(str(model_path))
        restore_like(net, ck["model"])
        print(f"Loaded network weights from epoch {ck.get('epoch')}.")
    net = net.to(dev).eval()

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(x.to(dev))

    return apply_fn
