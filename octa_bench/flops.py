"""Work counted from the configurations and from the calls' inputs, never
from the code that runs, and the H100's peaks.

A network's operations are 2 x the multiply-adds of every convolution and
transposed convolution (the antialiasing blurs are depthwise convolutions
and count too), from the layer shapes in the configuration's file; norms
and activations do not count, nor does what remat recomputes. A trained
pass counts 3 forwards, a pass without gradients 1.
"""
from __future__ import annotations

from octa_bench.reference.nets import dynunet_layout

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: bf16 tensor cores
PEAK_BF16_FLOPS = 989e12
# the same sheet (and chip_smoke.py's PEAK_FP32_FLOPS): float32 outside the
# tensor cores, and the HBM3 rate (PEAK_HBM_BYTES)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# chip_smoke.py: K1 per (pixel, edge) pair inside the edge's dilated bbox
# (projection, clamp, sqrt, coverage, product); K2 per admitted (query,
# point) pair (three differences, three products, two sums)
K1_FLOPS_PER_PAIR = 20
K2_FLOPS_PER_PAIR = 8


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv_macs(hw, cin, cout, k, s=1, p=0):
    """``(macs, out_hw)`` of a k x k convolution."""
    h, w = _out(hw[0], k, s, p), _out(hw[1], k, s, p)
    return h * w * cin * cout * k * k, (h, w)


def dynunet_macs(m: dict, hw) -> int:
    blocks, ups, (c0, cout) = dynunet_layout(m)
    total = 0
    for _, cin, c, k, s in blocks:
        a, hw = conv_macs(hw, cin, c, k, s, k // 2)
        b, hw = conv_macs(hw, c, c, k, 1, k // 2)
        total += a + b
    for _, cin, c, k, s in ups:
        total += hw[0] * hw[1] * cin * c * s * s
        hw = (hw[0] * s, hw[1] * s)
        a, hw = conv_macs(hw, 2 * c, c, k, 1, k // 2)
        b, hw = conv_macs(hw, c, c, k, 1, k // 2)
        total += a + b
    return total + hw[0] * hw[1] * c0 * cout


def generator_macs(g: dict, hw) -> int:
    ngf = g["ngf"]
    total, hw = conv_macs((hw[0] + 6, hw[1] + 6), g["input_nc"], ngf, 7)
    for i in range(2):
        c = ngf * 2 ** i
        a, hw = conv_macs(hw, c, 2 * c, 3, 1, 1)
        b, hw = conv_macs((hw[0] + 2, hw[1] + 2), 1, 1, 3, 2)  # blur
        total += a + b * 2 * c
    for _ in range(g["n_blocks"]):
        a, _ = conv_macs((hw[0] + 2, hw[1] + 2), 4 * ngf, 4 * ngf, 3)
        total += 2 * a
    for i in range(2):
        c = ngf * 2 ** (2 - i)
        total += (hw[0] + 2) * (hw[1] + 2) * c * 16      # blur up
        hw = (2 * hw[0], 2 * hw[1])
        a, hw = conv_macs(hw, c, c // 2, 3, 1, 1)
        total += a
    a, _ = conv_macs((hw[0] + 6, hw[1] + 6), ngf, g["output_nc"], 7)
    return total + a


def discriminator_macs(d: dict, hw) -> int:
    ndf, n = d["ndf"], d["n_layers"]
    total, hw = conv_macs(hw, d["input_nc"], ndf, 4, 1, 1)
    b, hw = conv_macs((hw[0] + 2, hw[1] + 2), 1, 1, 3, 2)
    total += b * ndf
    nf = ndf
    for i in range(1, n + 1):
        nxt = ndf * min(2 ** i, 8)
        a, hw = conv_macs(hw, nf, nxt, 4, 1, 1)
        total += a
        if i < n:
            b, hw = conv_macs((hw[0] + 2, hw[1] + 2), 1, 1, 3, 2)
            total += b * nxt
        nf = nxt
    a, _ = conv_macs(hw, nf, 1, 4, 1, 1)
    return total + a


def network_flops(net: dict, hw) -> int:
    """Forward operations of one image through a network of the config's
    ``networks`` section."""
    kind = net["name"]
    if kind == "DynUNet":
        return 2 * dynunet_macs(net, hw)
    if kind == "resnetGenerator9":
        return 2 * generator_macs(net, hw)
    if kind == "patchGAN70x70":
        return 2 * discriminator_macs(net, hw)
    raise ValueError(f"no count for network {kind!r}")


def passes_flops(config: dict, passes: str) -> int:
    """Operations of one unit (a step, a request, an image) from the
    config's list ``passes[<name>]``: each entry a network, its input size,
    the images and whether it is trained (3 forwards) or not (1)."""
    nets = config["networks"]
    total = 0
    for p in config["passes"][passes]:
        factor = 3 if p["trained"] else 1
        total += factor * p["images"] * network_flops(nets[p["net"]],
                                                      tuple(p["hw"]))
    return total


def k1_work(torch, a, b, width, valid, height: int, wid: int):
    """``(operations, bytes)`` of one K1 call, as device tensors: pixels
    inside each valid edge's bbox dilated by ``w/2 + 1``, and each input
    read and the float32 image written once."""
    reach = width.float() * 0.5 + 1.0
    lo = torch.minimum(a, b).float() - reach[..., None]
    hi = torch.maximum(a, b).float() + reach[..., None]
    first = torch.ceil(lo - 0.5).clamp(min=0)
    last = torch.floor(hi - 0.5)
    rows = last[..., 0].clamp(max=height - 1) - first[..., 0] + 1
    cols = last[..., 1].clamp(max=wid - 1) - first[..., 1] + 1
    n = rows.clamp(min=0) * cols.clamp(min=0)
    pairs = (n * valid).sum(dtype=torch.float64)
    nbytes = ((a.numel() + b.numel() + width.numel()) * 4 + valid.numel()
              + valid.shape[0] * height * wid * 4)
    return K1_FLOPS_PER_PAIR * pairs, nbytes


def k2_work(torch, query, points, masks, want_idx: bool):
    """``(operations, bytes)`` of one K2 call: the (query, point) pairs its
    masks admit, and each input read and each output written once."""
    r, qn = query.shape[:2]
    m = masks.shape[1]
    admitted = masks.sum(dtype=torch.float64) * qn
    out = r * m * qn * 4
    nbytes = ((query.numel() + points.numel()) * 4 + masks.numel()
              + out * (2 if want_idx else 1))
    return K2_FLOPS_PER_PAIR * admitted, nbytes

