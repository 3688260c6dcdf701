"""The networks of both configurations as plain functions over named
float32 tensors: DynUNet (MONAI's topology as the configs set it),
``resnetGenerator9`` and the 70x70 ``NLayerDiscriminator`` (both
antialiased, as the reference repository's ``networks.py``).

Parameter names follow the flax module names of the checkpoints
(``input_block.conv1.weight``, ``resblock_3.conv2.bias``, ...), conv weights
are OIHW and transposed-conv weights IOHW, as in torch. Every function takes
a :class:`Prec`: ``fp32`` computes in float32 with TF32 off; ``fp8`` rounds
the input and the weight of every learned convolution to float8 e4m3 (a
scale per tensor) and accumulates in float32, the precision one step below
the configurations' bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


class Prec:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the convolutions see it; the gradient passes straight
        through the rounding."""
        if self.name == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (r - x).detach()


FP32 = Prec("fp32")


def no_tf32():
    """Float32 matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def conv(p, name, x, prec, stride=1, padding=0):
    w = p[name + ".weight"]
    b = p.get(name + ".bias")
    return F.conv2d(prec.q(x), prec.q(w), b, stride=stride, padding=padding)


def conv_t(p, name, x, prec, stride):
    return F.conv_transpose2d(prec.q(x), prec.q(p[name + ".weight"]),
                              p.get(name + ".bias"), stride=stride)


def inorm(x, weight=None, bias=None, eps=1e-5):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight[:, None, None] + bias[:, None, None]
    return y


# --------------------------------------------------------------------------
# DynUNet
# --------------------------------------------------------------------------

def dynunet_layout(m: dict):
    """``(blocks, ups, out)`` of a DynUNet model config: basic blocks as
    ``(name, cin, cout, k, stride)``, up blocks as ``(name, cin, cout, k,
    up_stride)`` and the output conv as ``(cin, cout)``."""
    ks, st = list(m["kernel_size"]), list(m["strides"])
    n = len(st)
    f = list(m.get("filters") or [min(2 ** (5 + i), 320) for i in range(n)])
    blocks = [("input_block", m["in_channels"], f[0], ks[0], st[0])]
    blocks += [(f"downsample_{i - 1}", f[i - 1], f[i], ks[i], st[i])
               for i in range(1, n - 1)]
    blocks.append(("bottleneck", f[-2], f[-1], ks[-1], st[-1]))
    up_strides = st[1:][::-1]
    upk = list(m["upsample_kernel_size"])[::-1]
    ups = []
    for j, i in enumerate(range(n - 1, 0, -1)):
        if max(upk[j], up_strides[j]) != up_strides[j]:
            raise ValueError("only up kernel == up stride")
        ups.append((f"upsample_{j}", f[i], f[i - 1], ks[i - 1], up_strides[j]))
    return blocks, ups, (f[0], m["out_channels"])


def dynunet_shapes(m: dict) -> dict[str, tuple]:
    blocks, ups, (c0, cout) = dynunet_layout(m)
    out = {}

    def basic(name, cin, c, k):
        out[f"{name}.conv1.weight"] = (c, cin, k, k)
        out[f"{name}.norm1.weight"] = (c,)
        out[f"{name}.norm1.bias"] = (c,)
        out[f"{name}.conv2.weight"] = (c, c, k, k)
        out[f"{name}.norm2.weight"] = (c,)
        out[f"{name}.norm2.bias"] = (c,)

    for name, cin, c, k, _ in blocks:
        basic(name, cin, c, k)
    for name, cin, c, k, s in ups:
        out[f"{name}.transp_conv.weight"] = (cin, c, s, s)
        basic(f"{name}.conv_block", 2 * c, c, k)
    out["output_block.weight"] = (cout, c0, 1, 1)
    out["output_block.bias"] = (cout,)
    return out


def _basic(p, name, x, stride, k, prec):
    x = conv(p, f"{name}.conv1", x, prec, stride, k // 2)
    x = F.leaky_relu(inorm(x, p[f"{name}.norm1.weight"],
                           p[f"{name}.norm1.bias"]), 0.01)
    x = conv(p, f"{name}.conv2", x, prec, 1, k // 2)
    return F.leaky_relu(inorm(x, p[f"{name}.norm2.weight"],
                              p[f"{name}.norm2.bias"]), 0.01)


def dynunet(p: dict, m: dict, x: torch.Tensor, prec: Prec = FP32,
            recompute: bool = False):
    """[B, in, H, W] -> logits [B, out, H, W]. ``recompute`` keeps only each
    block's input for the backward pass (the same values, less memory)."""
    blocks, ups, _ = dynunet_layout(m)

    def basic(*args):
        if recompute and torch.is_grad_enabled():
            return checkpoint(_basic, p, *args, use_reentrant=False)
        return _basic(p, *args)

    skips = []
    h = x
    for name, _, _, k, s in blocks:
        h = basic(name, h, s, k, prec)
        skips.append(h)
    skips.pop()  # the bottleneck feeds the first up block, not a skip
    for j, (name, _, _, k, s) in enumerate(ups):
        h = conv_t(p, f"{name}.transp_conv", h, prec, s)
        h = basic(f"{name}.conv_block", torch.cat([h, skips[-1 - j]], 1), 1,
                  k, prec)
    return conv(p, "output_block", h, prec)


# --------------------------------------------------------------------------
# antialiased resnet generator and PatchGAN
# --------------------------------------------------------------------------

def _binomial(size: int) -> np.ndarray:
    row = np.asarray({3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0]}[size])
    f = row[:, None] * row[None, :]
    return (f / f.sum()).astype(np.float32)


def blur_down(x):
    c = x.shape[1]
    w = torch.from_numpy(_binomial(3)).to(x)[None, None].expand(c, 1, 3, 3)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, stride=2,
                    groups=c)


def blur_up(x):
    c = x.shape[1]
    w = torch.from_numpy(_binomial(4) * 4.0).to(x)[None, None].expand(
        c, 1, 4, 4)
    y = F.conv_transpose2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), w,
                           stride=2, padding=2, groups=c)
    return y[:, :, 1:-1, 1:-1]


def generator_shapes(g: dict) -> dict[str, tuple]:
    ngf, cin, cout = g["ngf"], g["input_nc"], g["output_nc"]
    out = {"conv_in.weight": (ngf, cin, 7, 7), "conv_in.bias": (ngf,)}
    for i in range(2):
        c = ngf * 2 ** i
        out[f"down_conv_{i}.weight"] = (2 * c, c, 3, 3)
        out[f"down_conv_{i}.bias"] = (2 * c,)
    for i in range(g["n_blocks"]):
        for j in (1, 2):
            out[f"resblock_{i}.conv{j}.weight"] = (4 * ngf, 4 * ngf, 3, 3)
            out[f"resblock_{i}.conv{j}.bias"] = (4 * ngf,)
    for i in range(2):
        c = ngf * 2 ** (2 - i)
        out[f"up_conv_{i}.weight"] = (c // 2, c, 3, 3)
        out[f"up_conv_{i}.bias"] = (c // 2,)
    out["conv_out.weight"] = (cout, ngf, 7, 7)
    out["conv_out.bias"] = (cout,)
    return out


def generator(p: dict, g: dict, x: torch.Tensor, prec: Prec = FP32):
    """[B, 1, H, W] -> [B, 1, H, W] in (0, 1)."""
    h = F.pad(x, (3, 3, 3, 3), mode="reflect")
    h = torch.relu(inorm(conv(p, "conv_in", h, prec)))
    for i in range(2):
        h = blur_down(torch.relu(inorm(conv(p, f"down_conv_{i}", h, prec,
                                            padding=1))))
    for i in range(g["n_blocks"]):
        r = F.pad(h, (1, 1, 1, 1), mode="reflect")
        r = torch.relu(inorm(conv(p, f"resblock_{i}.conv1", r, prec)))
        r = F.pad(r, (1, 1, 1, 1), mode="reflect")
        h = h + inorm(conv(p, f"resblock_{i}.conv2", r, prec))
    for i in range(2):
        h = torch.relu(inorm(conv(p, f"up_conv_{i}", blur_up(h), prec,
                                  padding=1)))
    h = conv(p, "conv_out", F.pad(h, (3, 3, 3, 3), mode="reflect"), prec)
    return torch.sigmoid(h)


def discriminator_shapes(d: dict) -> dict[str, tuple]:
    ndf, n = d["ndf"], d["n_layers"]
    out = {"conv0.weight": (ndf, d["input_nc"], 4, 4), "conv0.bias": (ndf,)}
    nf = ndf
    for i in range(1, n + 1):
        nxt = ndf * min(2 ** i, 8)
        out[f"conv{i}.weight"] = (nxt, nf, 4, 4)
        out[f"conv{i}.bias"] = (nxt,)
        nf = nxt
    out["conv_out.weight"] = (1, nf, 4, 4)
    out["conv_out.bias"] = (1,)
    return out


def discriminator(p: dict, d: dict, x: torch.Tensor, prec: Prec = FP32):
    """[B, 1, H, W] -> patch scores [B, 1, H', W']."""
    pad = lambda t: F.pad(t, (1, 1, 1, 1))  # noqa: E731
    h = blur_down(F.leaky_relu(conv(p, "conv0", pad(x), prec), 0.2))
    for i in range(1, d["n_layers"] + 1):
        h = F.leaky_relu(inorm(conv(p, f"conv{i}", pad(h), prec)), 0.2)
        if i < d["n_layers"]:
            h = blur_down(h)
    return conv(p, "conv_out", pad(h), prec)


SHAPES = {"DynUNet": dynunet_shapes, "resnetGenerator9": generator_shapes,
          "patchGAN70x70": discriminator_shapes}


def seeded_weights(shapes: dict[str, tuple], generator: torch.Generator,
                   dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Weights from ``generator`` in one draw: every conv weight normal with
    variance 2 / fan-in (fan-in ``in * kh * kw``; a transposed conv's ``in``
    is its first axis), biases 0, norm scales 1 and shifts 0."""
    conv = {k: s for k, s in shapes.items() if len(s) == 4}
    total = sum(int(np.prod(s)) for s in conv.values())
    flat = torch.randn(total, generator=generator, device=generator.device,
                       dtype=dtype)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 4:
            n = int(np.prod(s))
            fan_in = (s[0] if "transp_conv" in k else s[1]) * s[2] * s[3]
            out[k] = (flat[at:at + n] * (2.0 / fan_in) ** 0.5).view(s)
            at += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(s, device=generator.device, dtype=dtype)
        else:
            out[k] = torch.zeros(s, device=generator.device, dtype=dtype)
    return out
