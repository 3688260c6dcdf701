"""The operation counts come from the configuration's shapes: they equal a
hand count, and a count of the multiply-adds of the port's own modules as
they run."""
import json

import pytest
import torch

from octa_bench import flops, harness

CFG = json.loads((harness.BENCH_DIR / "configs" / "gan_ves_seg.json")
                 .read_text())
NETS = CFG["networks"]


def test_dynunet_hand_count_small():
    m = dict(NETS["segmentor"], filters=[2, 4, 4, 4, 4])
    # 8x8 input, strides 1,2,2,2,1, kernel 3: blocks at 8, 4, 2, 1, 1
    hand = (1 * 2 * 9 * 64 + 2 * 2 * 9 * 64          # input block at 8x8
            + 2 * 4 * 9 * 16 + 4 * 4 * 9 * 16        # down 0 -> 4x4
            + 4 * 4 * 9 * 4 + 4 * 4 * 9 * 4          # down 1 -> 2x2
            + 4 * 4 * 9 * 1 + 4 * 4 * 9 * 1          # down 2 -> 1x1
            + 4 * 4 * 9 * 1 + 4 * 4 * 9 * 1          # bottleneck 1x1
            + 4 * 4 * 1 * 1 + 8 * 4 * 9 + 4 * 4 * 9  # up 0: k1 transp at 1x1
            + 4 * 4 * 4 * 1 + 8 * 4 * 9 * 4 + 4 * 4 * 9 * 4    # up 1 -> 2x2
            + 4 * 4 * 4 * 4 + 8 * 4 * 9 * 16 + 4 * 4 * 9 * 16  # up 2 -> 4x4
            + 4 * 2 * 4 * 16 + 4 * 2 * 9 * 64 + 2 * 2 * 9 * 64  # up 3 -> 8x8
            + 2 * 1 * 64)                               # output 1x1 conv
    assert flops.network_flops(m, (8, 8)) == 2 * hand


def test_published_counts():
    assert flops.network_flops(NETS["segmentor"], (1216, 1216)) \
        == 576_510_230_528
    assert flops.network_flops(NETS["generator"], (304, 304)) \
        == 178_540_912_640
    assert flops.passes_flops(CFG, "segment_image") == \
        576_510_230_528 + 178_540_912_640


def _macs_of_modules(module, x):
    """Multiply-adds of every conv the module runs, read from the shapes it
    runs them at (forward hooks on torch's conv modules)."""
    total = [0]

    def hook(m, inp, out):
        w = m.weight
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += inp[0][0, 0].numel() * inp[0].shape[0] * w.numel()
        else:
            total[0] += out[0, 0].numel() * out.shape[0] * w[0].numel() \
                * w.shape[0]

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        module(x)
    for h in hs:
        h.remove()
    return total[0]


@pytest.mark.parametrize("net,hw", [("segmentor", (64, 64)),
                                    ("discriminator", (64, 64)),
                                    ("generator", (32, 32))])
def test_count_unchanged_when_built_another_way(net, hw):
    """The port's modules, run, make the same count (their blurs are
    torch.nn.functional calls, not modules: added by hand)."""
    from octa_tpu_torch.models.dynunet import DynUNet
    from octa_tpu_torch.models.resnet_gan import patchGAN70x70, resnetGenerator9

    build = {"segmentor": lambda: DynUNet(**{k: v for k, v in NETS[net].items()
                                             if k not in ("name", "filters")}),
             "discriminator": patchGAN70x70,
             "generator": resnetGenerator9}[net]
    macs = _macs_of_modules(build().eval(), torch.rand(1, 1, *hw))
    blur = {"segmentor": 0,
            # conv0 -> 63 -> blur 32, conv1 -> 31 -> blur 16, conv2 -> 15 -> 8
            "discriminator": 9 * (32 * 32 * 64 + 16 * 16 * 128 + 8 * 8 * 256),
            # down blurs to 16 and 8; up blurs from (8+2)^2 and (16+2)^2
            "generator": 9 * (16 * 16 * 128 + 8 * 8 * 256)
            + 16 * (10 * 10 * 256 + 18 * 18 * 128)}[net]
    assert 2 * (macs + blur) == flops.network_flops(NETS[net], hw)


def test_kernel_work_from_inputs():
    a = torch.tensor([[[1.5, 1.5], [0.0, 0.0]]])
    b = torch.tensor([[[1.5, 3.5], [0.0, 0.0]]])
    w = torch.tensor([[0.0, 0.0]])
    v = torch.tensor([[True, False]])
    ops, nbytes = flops.k1_work(torch, a, b, w, v, 8, 8)
    # bbox [0.5, 2.5] x [0.5, 4.5]: pixel centres 0.5..2.5 and 0.5..4.5
    assert float(ops) == flops.K1_FLOPS_PER_PAIR * 3 * 5
    assert nbytes == (4 + 4 + 2) * 4 + 2 + 8 * 8 * 4
    q = torch.zeros(2, 3, 3)
    p = torch.zeros(2, 5, 3)
    masks = torch.zeros(2, 1, 5, dtype=torch.bool)
    masks[0, 0, :2] = True
    masks[1, 0, 4] = True
    ops, nbytes = flops.k2_work(torch, q, p, masks, True)
    assert float(ops) == flops.K2_FLOPS_PER_PAIR * 3 * 3
    assert nbytes == (18 + 30) * 4 + 10 + 2 * 6 * 4
