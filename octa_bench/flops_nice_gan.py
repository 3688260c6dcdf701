"""NICE-GAN's operations, counted from the configuration as
``octa_bench/flops.py`` counts the other networks': 2 x the multiply-adds
of every convolution (the spectral-norm convs, ``conv1x1`` and the
generator's), dense layer (the generator's head) and of the CAM logit's
product; the norms, activations, pixel shuffles and the spectral norms'
power iterations (three matrix-vector products of each weight a call) do
not count. A trained pass counts 3 forwards, a pass without gradients 1.
"""
from __future__ import annotations

from octa_bench.flops import conv_macs
from octa_bench.reference import nice_gan


def discriminator_macs(d: dict, hw) -> int:
    """Multiply-adds of one image of ``hw`` through a ``NiceDiscriminator``:
    every conv pads by 1 (4x4 kernels)."""
    convs = nice_gan._sn_convs(d)
    total, sizes = 0, {}

    def sn(name, at):
        nonlocal total
        cin, cout, stride, _ = convs[name]
        macs, out = conv_macs(at, cin, cout, 4, stride, 1)
        total += macs
        sizes[name] = out
        return out

    x0 = sn("enc1", sn("enc0", hw))
    ndf = d["ndf"]
    total += 4 * ndf                                     # the CAM logit
    total += conv_macs(x0, 4 * ndf, 2 * ndf, 1)[0]       # conv1x1
    h0 = sn("dis0_0", x0)
    sn("conv0", sn("dis0_1", h0))
    h1 = h0
    for name in ("dis1_0a", "dis1_0b", "dis1_1"):
        h1 = sn(name, h1)
    sn("conv1", h1)
    return total


def generator_macs(g: dict, z_ch: int, hw) -> int:
    """Multiply-adds of one image of ``hw`` (the output's size; the
    encoding is ``hw // 4``) through a ``NiceResnetGenerator``."""
    width = 4 * g["ngf"]
    s = (hw[0] // 4, hw[1] // 4)
    total = conv_macs(s, z_ch, width, 3, 1, 1)[0]
    fc_in = width if g["light"] else s[0] * s[1] * width
    total += fc_in * width + 3 * width * width           # the dense head
    total += 2 * g["n_blocks"] * conv_macs(s, width, width, 3, 1, 1)[0]
    for i in range(2):
        cin = g["ngf"] * 2 ** (2 - i)
        c = cin // 2
        total += conv_macs(s, cin, c, 3, 1, 1)[0]
        total += conv_macs(s, c, 4 * c, 1)[0]
        s = (2 * s[0], 2 * s[1])
    return total + conv_macs(s, g["ngf"], g["output_nc"], 7, 1, 3)[0]


def network_flops(networks: dict, name: str, hw) -> int:
    """Forward operations of one image through network ``name`` of the
    configuration's ``networks``."""
    spec = networks[name]
    if spec["name"] == "NiceDiscriminator":
        return 2 * discriminator_macs(spec, hw)
    if spec["name"] == "NiceResnetGenerator":
        z_ch = nice_gan.z_channels(networks[nice_gan.ENCODER[name]])
        return 2 * generator_macs(spec, z_ch, hw)
    raise ValueError(f"no count for network {spec['name']!r}")


def passes_flops(config: dict, passes: str) -> int:
    """Operations of one step from the configuration's list
    ``passes[<name>]``: each entry a network, the image size, the images and
    whether it is trained (3 forwards) or not (1)."""
    nets = config["networks"]
    return sum((3 if p["trained"] else 1) * p["images"]
               * network_flops(nets, p["net"], tuple(p["hw"]))
               for p in config["passes"][passes])
