"""NICE-GAN (Chen et al., "Reusing Discriminators for Encoding: Towards
Unsupervised Image-to-Image Translation", CVPR 2020) as shipped in
``configs/config_nice_gan.yml``: its two networks and its training step as
plain functions over named float32 tensors, with TF32 off
(:func:`nets.no_tf32`).

Discriminator (the other domain's encoder): two spectral-norm stride-2
convs (LeakyReLU 0.2) give the encoding's trunk ``x0``; class-activation
attention takes the logit ``[gap(x0), gmp(x0)] . k / |k|`` (``k`` the
bias-free ``cam_fc_kernel``), reweights ``[x0, x0]`` channel by channel by
``k`` and fuses it back, ``z = lrelu(lamda * conv1x1([x0, x0] k) + x0)``;
from ``z`` a local head (two spectral-norm convs, then the 1-channel
``conv0``) and a global head (three, then ``conv1``). Every conv pads by
reflection. Generator (decoder): ``z`` through a conv and an ILN at ``4
ngf``; ``gamma`` and ``beta`` per sample from a dense head over the
global average (``light``) or the whole map flattened channels-last;
``n_blocks`` residual blocks ``x + adaILN(conv(relu(adaILN(conv(x)))))``;
two upsamplings (conv, ILN, a 1x1 conv to ``4 c`` and a pixel shuffle,
ILN); a 7x7 conv and a sigmoid. A norm is ``gamma * (rho IN(x) + (1 - rho)
LN(x)) + beta`` over (H, W) and over (C, H, W), eps 1e-5, biased
variances.

The step is the JAX package's (``octa_tpu/train/gan_algorithms.py::
NiceGANAlgorithm``, its ``step`` at :1037): the discriminators' update
(each on its real images and on the other direction's translation of its
detached encoding, detached), then the generators' through the
discriminators at their new parameters, which take no gradient; the
multi-scale LSGAN losses (local, global and CAM logits), the L1 cycle and
reconstruction losses with weights ``adv``, ``cycle`` and ``recon``; Adam
(0.5, 0.999), eps 1e-8, one for each half.

Departures from the paper, all the JAX package's (and the port's):

- ``rho`` is a per-channel softmax of two logits ``[C, 2]``, not a learned
  scalar clipped to [0, 1]; adaILN's initial logits are (3.2, 1.0), the
  other norms' (1.0, 3.2);
- a spectral norm takes one power iteration at every call, training or
  not, from the ``u`` the previous call left, and divides the weight by
  ``sigma`` without a gradient through ``sigma``; its norms, and the CAM
  kernel's, add 1e-12;
- the G step's encodings of A images see ``max(x, background * u)``, the
  background composite (``background`` and the uniform ``u`` are the
  step's inputs);
- ``u`` is not checkpointed: this function is handed it, as it is handed
  the weights (it does not recompute the JAX package's initial draw).

``prec`` is :class:`nets.Prec`: ``fp8`` (``low``) rounds the input and
weight of every conv to float8 e4m3, the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from octa_bench.reference import nets
from octa_bench.reference.train import Adam

#: the spectral-norm convs of a discriminator, in the order of its call
SN_LAYERS = ("enc0", "enc1", "dis0_0", "dis0_1", "conv0", "dis1_0a",
             "dis1_0b", "dis1_1", "conv1")
#: the discriminator whose trunk encodes each generator's input
ENCODER = {"gen2B": "disA", "gen2A": "disB"}
#: the losses of a step, as the program names them
LOSSES = ("G", "G_A", "G_B", "cycle_A", "cycle_B", "idt_A", "idt_B", "D_A",
          "D_B")


def _sn_convs(d: dict) -> dict[str, tuple]:
    """``name: (cin, cout, stride, bias)`` of the spectral-norm convs."""
    n = d["ndf"]
    return {"enc0": (d["input_nc"], n, 2, True), "enc1": (n, 2 * n, 2, True),
            "dis0_0": (2 * n, 4 * n, 2, True),
            "dis0_1": (4 * n, 8 * n, 1, True), "conv0": (8 * n, 1, 1, False),
            "dis1_0a": (4 * n, 8 * n, 2, True),
            "dis1_0b": (8 * n, 16 * n, 2, True),
            "dis1_1": (16 * n, 32 * n, 1, True),
            "conv1": (32 * n, 1, 1, False)}


def discriminator_shapes(d: dict) -> dict[str, tuple]:
    n = d["ndf"]
    out = {"cam_fc_kernel": (4 * n, 1), "lamda": (1,)}
    for name, (cin, cout, _, bias) in _sn_convs(d).items():
        out[f"{name}.weight"] = (cout, cin, 4, 4)
        if bias:
            out[f"{name}.bias"] = (cout,)
    out["conv1x1.weight"] = (2 * n, 4 * n, 1, 1)
    out["conv1x1.bias"] = (2 * n,)
    return out


def u_shapes(d: dict) -> dict[str, int]:
    """The length of each spectral-norm conv's ``u``: its output channels."""
    return {name: c[1] for name, c in _sn_convs(d).items()}


def z_channels(d: dict) -> int:
    return 2 * d["ndf"]


def generator_shapes(g: dict, z_ch: int) -> dict[str, tuple]:
    width = 4 * g["ngf"]
    out = {"up0_conv.weight": (width, z_ch, 3, 3), "up0_conv.bias": (width,),
           "up0_iln.rho": (width, 2), "up0_iln.gamma": (width,),
           "up0_iln.beta": (width,)}
    fc_in = width if g["light"] else (g["img_size"] // 4) ** 2 * width
    out["fc0.weight"] = (width, fc_in)
    for k in ("fc1", "gamma", "beta"):
        out[f"{k}.weight"] = (width, width)
    for i in range(g["n_blocks"]):
        for j in (1, 2):
            out[f"upblock1_{i}.conv{j}.weight"] = (width, width, 3, 3)
            out[f"upblock1_{i}.norm{j}.rho"] = (width, 2)
    for i in range(2):
        cin = g["ngf"] * 2 ** (2 - i)
        c = cin // 2
        out[f"up2_conv_{i}.weight"] = (c, cin, 3, 3)
        for s in ("a", "b"):
            out[f"up2_iln_{i}{s}.rho"] = (c, 2)
            out[f"up2_iln_{i}{s}.gamma"] = (c,)
            out[f"up2_iln_{i}{s}.beta"] = (c,)
        out[f"up2_sub_{i}.weight"] = (4 * c, c, 1, 1)
        out[f"up2_sub_{i}.bias"] = (4 * c,)
    out["conv_out.weight"] = (g["output_nc"], g["ngf"], 7, 7)
    return out


def shapes(networks: dict) -> dict[str, dict[str, tuple]]:
    """The parameter shapes of every network of the configuration's
    ``networks`` (keys ``gen2A``, ``gen2B``, ``disA``, ``disB``)."""
    out = {}
    for name, spec in networks.items():
        if name in ENCODER:
            out[name] = generator_shapes(
                spec, z_channels(networks[ENCODER[name]]))
        else:
            out[name] = discriminator_shapes(spec)
    return out


def seeded_weights(shapes: dict[str, tuple], generator: torch.Generator,
                   dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Weights from ``generator`` in one draw: every conv and dense weight,
    and ``cam_fc_kernel``, normal with variance 2 / fan-in (the JAX
    package's initialisation); biases 0. The leaves the JAX package starts
    at constants are drawn off them, so that every path of the block
    computes something: ``rho`` its initial logits plus N(0, 0.5²) (the
    adaILN blocks' (3.2, 1.0), the others' (1.0, 3.2)), the norms'
    ``gamma`` 1 + N(0, 0.1²) and ``beta`` N(0, 0.1²), ``lamda`` N(0,
    0.5²)."""
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=generator,
                       device=generator.device, dtype=dtype)
    out, at = {}, 0
    for k, s in shapes.items():
        x = flat[at:at + sizes[k]].view(s)
        at += sizes[k]
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight" or k == "cam_fc_kernel":
            fan_in = s[0] if k == "cam_fc_kernel" else math.prod(s[1:])
            out[k] = x * (2.0 / fan_in) ** 0.5
        elif leaf == "bias":
            out[k] = torch.zeros_like(x)
        elif leaf == "rho":
            init = (3.2, 1.0) if k.startswith("upblock1_") else (1.0, 3.2)
            out[k] = torch.tensor(init, dtype=dtype,
                                  device=x.device).expand(s) + 0.5 * x
        elif leaf == "gamma":
            out[k] = 1.0 + 0.1 * x
        elif leaf == "beta":
            out[k] = 0.1 * x
        elif leaf == "lamda":
            out[k] = 0.5 * x
        else:
            raise KeyError(f"no initialisation for {k}")
    return out


def seeded_u(d: dict, generator: torch.Generator,
             dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A discriminator's initial ``u``, standard normal, one draw."""
    lens = u_shapes(d)
    flat = torch.randn(sum(lens.values()), generator=generator,
                       device=generator.device, dtype=dtype)
    out, at = {}, 0
    for k, n in lens.items():
        out[k] = flat[at:at + n].clone()
        at += n
    return out


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _pad(x, p: int):
    return F.pad(x, (p, p, p, p), mode="reflect")


def iln(x, rho, gamma=None, beta=None, eps=1e-5):
    """``gamma * (rho IN(x) + (1 - rho) LN(x)) + beta``, ``rho`` the first
    softmax weight of the logits ``[C, 2]``; ``gamma`` and ``beta`` [C]
    (the norm's own) or [B, C] (adaILN's, per sample)."""
    iv, im = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    lv, lm = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    r = torch.softmax(rho, dim=-1)[None, :, :, None, None]
    y = (r[:, :, 0] * (x - im) * torch.rsqrt(iv + eps)
         + r[:, :, 1] * (x - lm) * torch.rsqrt(lv + eps))
    if gamma is None:
        return y
    if gamma.dim() == 1:
        return y * gamma[:, None, None] + beta[:, None, None]
    return y * gamma[:, :, None, None] + beta[:, :, None, None]


def power_iteration(w: torch.Tensor, u: torch.Tensor):
    """One power iteration on ``w`` [out, ...] from ``u`` [out]: ``(sigma,
    u')``, neither with a gradient; ``v = W^T u / (|W^T u| + 1e-12)``,
    ``u' = W v / (|W v| + 1e-12)``, ``sigma = u'^T W v``."""
    with torch.no_grad():
        m = w.reshape(w.shape[0], -1)
        v = m.T @ u
        v = v / (v.norm() + 1e-12)
        wv = m @ v
        u_new = wv / (wv.norm() + 1e-12)
        return u_new @ wv, u_new


class SpectralState:
    """The ``u`` of one discriminator, threaded through its calls, with the
    count of power iterations taken. ``skip``, where given, is ``(call,
    layer)``: the iteration of that layer at that call (counted from 0
    within each step) is left out (the weight divided by ``|W^T u|``, ``u``
    kept): a fault the comparison has to catch."""

    def __init__(self, u: dict, skip=None):
        self.u = {k: v.detach().clone() for k, v in u.items()}
        self.skip = skip
        self.call = 0
        self.iterations = 0

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        if self.skip == (self.call, name):
            with torch.no_grad():
                sigma = (w.reshape(w.shape[0], -1).T @ self.u[name]).norm()
            return w / sigma
        sigma, self.u[name] = power_iteration(w, self.u[name])
        self.iterations += 1
        return w / sigma


def discriminator(p: dict, sn: SpectralState, d: dict, x: torch.Tensor,
                  prec: nets.Prec = nets.FP32):
    """[B, 1, H, W] -> ``(out0, out1, cam_logit, z)``; the call's power
    iterations update ``sn``."""
    convs = _sn_convs(d)

    def snconv(name, h):
        w = sn.weight(name, p[f"{name}.weight"])
        return F.conv2d(prec.q(_pad(h, 1)), prec.q(w), p.get(f"{name}.bias"),
                        stride=convs[name][2])

    def block(name, h):
        return F.leaky_relu(snconv(name, h), 0.2)

    x0 = block("enc1", block("enc0", x))
    k = p["cam_fc_kernel"]
    cam_in = torch.cat([x0.mean(dim=(2, 3)), x0.amax(dim=(2, 3))], dim=1)
    cam_logit = cam_in @ (k / (k.norm() + 1e-12))
    h = torch.cat([x0, x0], dim=1) * k[:, 0][None, :, None, None]
    h = nets.conv(p, "conv1x1", h, prec)
    z = F.leaky_relu(p["lamda"] * h + x0, 0.2)
    h0 = block("dis0_0", z)
    h1 = h0
    out0 = snconv("conv0", block("dis0_1", h0))
    for name in ("dis1_0a", "dis1_0b", "dis1_1"):
        h1 = block(name, h1)
    out1 = snconv("conv1", h1)
    sn.call += 1
    return out0, out1, cam_logit, z


def pixel_shuffle(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """[B, C f², H, W] -> [B, C, H f, W f]: input channel ``(i f + j) C +
    c`` to channel ``c`` at row phase ``i``, column phase ``j``."""
    b, c, h, w = x.shape
    x = x.reshape(b, f, f, c // (f * f), h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c // (f * f), h * f, w * f)


def generator(p: dict, g: dict, z: torch.Tensor,
              prec: nets.Prec = nets.FP32) -> torch.Tensor:
    """The encoding ``z`` [B, 2 ndf, S, S] -> an image [B, 1, 4 S, 4 S] in
    (0, 1)."""
    h = nets.conv(p, "up0_conv", _pad(z, 1), prec)
    h = torch.relu(iln(h, p["up0_iln.rho"], p["up0_iln.gamma"],
                       p["up0_iln.beta"]))
    pooled = (h.mean(dim=(2, 3)) if g["light"]
              else h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
    fc = torch.relu(pooled @ p["fc0.weight"].T)
    fc = torch.relu(fc @ p["fc1.weight"].T)
    gamma, beta = fc @ p["gamma.weight"].T, fc @ p["beta.weight"].T
    for i in range(g["n_blocks"]):
        b = f"upblock1_{i}"
        r = nets.conv(p, f"{b}.conv1", _pad(h, 1), prec)
        r = torch.relu(iln(r, p[f"{b}.norm1.rho"], gamma, beta))
        r = nets.conv(p, f"{b}.conv2", _pad(r, 1), prec)
        h = h + iln(r, p[f"{b}.norm2.rho"], gamma, beta)
    for i in range(2):
        h = nets.conv(p, f"up2_conv_{i}", _pad(h, 1), prec)
        a = f"up2_iln_{i}a"
        h = torch.relu(iln(h, p[f"{a}.rho"], p[f"{a}.gamma"], p[f"{a}.beta"]))
        h = pixel_shuffle(nets.conv(p, f"up2_sub_{i}", h, prec))
        b = f"up2_iln_{i}b"
        h = torch.relu(iln(h, p[f"{b}.rho"], p[f"{b}.gamma"], p[f"{b}.beta"]))
    return torch.sigmoid(nets.conv(p, "conv_out", _pad(h, 3), prec))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _mse(x, target: float):
    return torch.mean((x - target) ** 2)


def _l1(x, y):
    return torch.mean((x - y).abs())


def steps(config: dict, weights: dict, u: dict, batches: list, prec="fp32",
          half=False, skip=None) -> dict:
    """NICE-GAN's steps on ``batches`` (``(real_A, real_B, background,
    u_draw)``, NCHW) from ``weights`` (per network) and the discriminators'
    initial ``u`` (``{"disA": {layer: u}, "disB": ...}``), in the weights'
    dtype (float32 on the card; float64 in the tests). Returns the
    losses a step (:data:`LOSSES`), the first step's gradients, the
    parameters and each ``u`` after the last step, and the power
    iterations of each step. ``half`` leaves out the second half of every
    batch; ``skip`` is :class:`SpectralState`'s, in both
    discriminators."""
    run, nw = config["run"], config["networks"]
    mp = run["General"]["model"]
    aw, cw, rw = (float(mp.get(k, d)) for k, d in
                  (("adv_weight", 1.0), ("cycle_weight", 10.0),
                   ("recon_weight", 1.0)))
    p = nets.Prec("fp8" if prec == "low" else "fp32")
    lr = run["Train"]["lr"]
    dtype = weights["disA"]["lamda"].dtype
    par = {k: {n: v.detach().clone().to(dtype).requires_grad_(True)
               for n, v in weights[k].items()}
           for k in ("gen2A", "gen2B", "disA", "disB")}
    sn = {k: SpectralState({n: v.to(dtype) for n, v in u[k].items()}, skip)
          for k in ("disA", "disB")}
    gens, diss = ("gen2A", "gen2B"), ("disA", "disB")
    opt_d = Adam({f"{n}/{k}": v for n in diss for k, v in par[n].items()},
                 lr, (0.5, 0.999))
    opt_g = Adam({f"{n}/{k}": v for n in gens for k, v in par[n].items()},
                 lr, (0.5, 0.999))

    def D(name, x):
        return discriminator(par[name], sn[name], nw[name], x, p)

    def G(name, z):
        return generator(par[name], nw[name], z, p)

    def grads(loss, names):
        keys = [(n, k) for n in names for k in par[n]]
        g = torch.autograd.grad(loss, [par[n][k] for n, k in keys])
        out = {n: {} for n in names}
        for (n, k), v in zip(keys, g):
            out[n][k] = v
        return out

    out = {"losses": [], "grads": None, "power_iterations": []}
    for batch in batches:
        real_A, real_B, background, u_draw = (t.to(dtype) for t in batch)
        if half:
            n = len(real_A) // 2
            real_A, real_B = real_A[:n], real_B[:n]
            background, u_draw = background[:n], u_draw[:n]
        for s in sn.values():
            s.call = 0
        first = sum(s.iterations for s in sn.values())
        # the discriminators' half
        rLA, rGA, rcamA, real_A_z = D("disA", real_A)
        rLB, rGB, rcamB, real_B_z = D("disB", real_B)
        with torch.no_grad():
            fake_A2B = G("gen2B", real_A_z)
            fake_B2A = G("gen2A", real_B_z)
        fLA, fGA, fcamA, _ = D("disA", fake_B2A)
        fLB, fGB, fcamB, _ = D("disB", fake_A2B)

        def pair(real, fake):
            return _mse(real, 1.0) + _mse(fake, 0.0)

        d_A = aw * (pair(rGA, fGA) + pair(rcamA, fcamA) + pair(rLA, fLA))
        d_B = aw * (pair(rGB, fGB) + pair(rcamB, fcamB) + pair(rLB, fLB))
        gd = grads(d_A + d_B, diss)
        opt_d.step({f"{n}/{k}": v for n in diss for k, v in gd[n].items()})
        # the generators' half, through the updated discriminators
        bg = background * u_draw
        real_A_z = D("disA", torch.maximum(real_A, bg))[3]
        real_B_z = D("disB", real_B)[3]
        fake_A2B = G("gen2B", real_A_z)
        fake_B2A = G("gen2A", real_B_z)
        fLA, fGA, fcamA, fake_A_z = D("disA", torch.maximum(fake_B2A, bg))
        fLB, fGB, fcamB, fake_B_z = D("disB", fake_A2B)
        fake_B2A2B = G("gen2B", fake_A_z)
        fake_A2B2A = G("gen2A", fake_B_z)
        ad_A = _mse(fGA, 1.0) + _mse(fcamA, 1.0) + _mse(fLA, 1.0)
        ad_B = _mse(fGB, 1.0) + _mse(fcamB, 1.0) + _mse(fLB, 1.0)
        cycle_A, cycle_B = _l1(fake_A2B2A, real_A), _l1(fake_B2A2B, real_B)
        recon_A = _l1(G("gen2A", real_A_z), real_A)
        recon_B = _l1(G("gen2B", real_B_z), real_B)
        g_A = aw * ad_A + cw * cycle_A + rw * recon_A
        g_B = aw * ad_B + cw * cycle_B + rw * recon_B
        gg = grads(g_A + g_B, gens)
        opt_g.step({f"{n}/{k}": v for n in gens for k, v in gg[n].items()})
        if out["grads"] is None:
            out["grads"] = {**gg, **gd}
        vals = (g_A + g_B, g_A, g_B, cycle_A, cycle_B, recon_A, recon_B, d_A,
                d_B)
        out["losses"].append({k: float(v.detach())
                              for k, v in zip(LOSSES, vals)})
        out["power_iterations"].append(
            sum(s.iterations for s in sn.values()) - first)
    out["params"] = {k: {n: v.detach() for n, v in d.items()}
                     for k, d in par.items()}
    out["u"] = {k: dict(s.u) for k, s in sn.items()}
    return out
