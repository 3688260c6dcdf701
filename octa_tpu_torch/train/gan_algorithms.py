"""Unpaired image-translation algorithms: CycleGAN, the first of the GAN zoo.

Counterpart of ``octa_tpu/train/gan_algorithms.py``: ``register`` and
``build`` (:36-50), ``ImagePool`` (:52-76), ``_UnpairedBase`` (:79-166) and
``CycleGANAlgorithm`` (:169-331). CUT, NEGCUT, DCLGAN and NICE-GAN are not
registered yet: :func:`build` raises ``NotImplementedError`` for them.

A CycleGAN step is the JAX package's two jitted steps in eager PyTorch: the
G step (GAN, cycle and identity losses of both generators, with the
background composite ``max(real_A, background * u)``) through the
discriminators, which take no gradient from it, then the D step on the
fakes replayed by the ``ImagePool``\\ s, detached. Two Adam optimizers,
betas (0.5, 0.999); bf16 autocast under ``General.amp``. The losses of a
step come back to the host in one read.
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import Any

import torch

from octa_tpu_torch.io import checkpoints as ck
from octa_tpu_torch.models.layers import kaiming_normal_
from octa_tpu_torch.models.registry import build_network
from octa_tpu_torch.train.algorithms import BaseAlgorithm, _host, _post_first
from octa_tpu_torch.utils import losses as losses_lib
from octa_tpu_torch.utils.enums import Phase

_BUILDERS: dict[str, type] = {}


def register(name):
    def deco(cls):
        _BUILDERS[name] = cls
        return cls

    return deco


def build(name: str, config: dict, phase: Phase, device="cuda",
          **model_params):
    if name not in _BUILDERS:
        raise NotImplementedError(
            f"Algorithm {name} is not ported to octa_tpu_torch yet: it comes "
            f"with a later step of the GAN zoo's slice. Ported: "
            f"{sorted(_BUILDERS)}")
    return _BUILDERS[name](config=config, phase=phase, device=device,
                           **model_params)


class ImagePool:
    """The discriminator's replay buffer (reference ``cycle_gan.py:
    287-336``): until it holds ``pool_size`` images each image is kept and
    returned; after that, with chance one half, an image takes the place of
    a random pooled one, which is returned instead. The choices come from
    ``random.Random(seed)`` in the JAX package's order of calls, so both
    packages make the same choices; the images stay on their device. The
    pool keeps the tensors it is given, so they must not be written to
    later (the CycleGAN step hands it detached fakes)."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.images: list[torch.Tensor] = []
        self.rng = pyrandom.Random(seed)

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """The mixed batch for a batch ``images`` [B, ...]."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            image = image[None]
            if len(self.images) < self.pool_size:
                self.images.append(image)
                out.append(image)
            elif self.rng.uniform(0, 1) > 0.5:
                rid = self.rng.randint(0, self.pool_size - 1)
                out.append(self.images[rid])
                self.images[rid] = image
            else:
                out.append(image)
        return torch.cat(out, 0)


class _UnpairedBase(BaseAlgorithm):
    """What the unpaired algorithms share: initial weights, the inference
    checkpoint of the network ``General.inference`` names, a generator's
    inference and the sample plot."""

    def _init_weights(self):
        """Network i of ``self.networks`` draws from ``seed + i`` (the JAX
        package's ``_init_networks``, :82-88, keys ``seed + i``)."""
        for i, net in enumerate(self.networks.values()):
            kaiming_normal_(net, torch.Generator().manual_seed(self.seed + i))
            net.to(self.device)

    def _load_inference_checkpoint(self, config, args):
        net_name = self.inference_mode
        model_path = (config.get(Phase.TEST, {}) or {}).get("model_path")
        if not model_path:
            ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
            tag = getattr(args, "epoch", "latest") or "latest"
            model_path = os.path.join(ckdir, f"{tag}_{net_name}_model.ckpt")
        net_ck = ck.load_checkpoint(str(model_path))
        self.load_network_state(net_name, {"params": net_ck["model"]})
        print(f"Loaded network weights {net_name} from epoch "
              f"{net_ck.get('epoch')}.")

    def _gen_inference(self, net_name, mini_batch, post_transformations,
                       phase, cycle_loss=None, cycle_loss_name="L1_cycle"):
        x = self._batch_in(mini_batch["image"])
        net = self.networks[net_name]
        net.eval()
        with torch.no_grad(), self.autocast():
            pred = net(x)
        outputs = {"prediction": _post_first(
            post_transformations.get("prediction"), pred)}
        losses: dict[str, Any] = {}
        if phase == Phase.VALIDATION and "label" in mini_batch \
                and cycle_loss is not None:
            y = self._batch_in(mini_batch["label"])
            outputs["label"] = _post_first(post_transformations.get("label"),
                                           mini_batch["label"])
            losses[cycle_loss_name] = cycle_loss(pred, y)
        return outputs, losses

    def plot_sample(self, visualizer, mini_batch, outputs, *, suffix=""):
        if "fake_B" not in outputs:
            return super().plot_sample(visualizer, mini_batch, outputs,
                                       suffix=suffix)
        return visualizer.plot_gan_seg_sample(
            _host(mini_batch["real_A"][0]), _host(outputs["fake_B"][0]),
            _host(outputs["prediction"][0]), _host(mini_batch["real_B"][0]),
            _host(outputs.get("idt_A", outputs.get("idt_B"))[0]),
            _host(outputs["real_B_seg"][0]),
            path_a=mini_batch.get("real_A_path", [""])[0],
            path_b=mini_batch.get("real_B_path", [""])[0], suffix=suffix)


@register("CycleGAN")
class CycleGANAlgorithm(_UnpairedBase):
    """Two generators and two discriminators with cycle consistency
    (reference ``cycle_gan.py:146-248``): ``netG_A`` translates A (the
    synthetic images) to B (the real ones), ``netG_B`` back; ``netD_A``
    judges B, ``netD_B`` judges A."""

    optimizer_mapping = {"optimizer_G": ["netG_A", "netG_B"],
                         "optimizer_D": ["netD_A", "netD_B"]}

    def __init__(self, config, phase, netG_A_config, netG_B_config,
                 netD_A_config=None, netD_B_config=None, lambda_A=10.0,
                 lambda_B=10.0, lambda_idt=0.5, pool_size=50,
                 inference=None, device="cuda", **kw):
        super().__init__(config, phase, device)
        self.inference_mode = inference or config["General"].get("inference")
        self.lambda_A, self.lambda_B = lambda_A, lambda_B
        self.lambda_idt = lambda_idt
        if phase == Phase.TRAIN or self.inference_mode == "netG_A":
            self.networks["netG_A"] = build_network(dict(netG_A_config))
        if phase == Phase.TRAIN or self.inference_mode == "netG_B":
            self.networks["netG_B"] = build_network(dict(netG_B_config))
        if phase == Phase.TRAIN:
            self.networks["netD_A"] = build_network(dict(netD_A_config))
            self.networks["netD_B"] = build_network(dict(netD_B_config))
            self.fake_A_pool = ImagePool(pool_size, self.seed)
            self.fake_B_pool = ImagePool(pool_size, self.seed + 1)
            # the background and u draws the JAX package takes from its keys
            self.generator = torch.Generator(self.device).manual_seed(
                self.seed)
        self._init_weights()

    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase=Phase.TRAIN):
        if phase != Phase.TEST:
            tr = config[Phase.TRAIN]
            self.criterionGAN = losses_lib.get_loss_function_by_name(
                tr["loss_criterionGAN"], config)
            self.criterionCycle = losses_lib.get_loss_function_by_name(
                tr["loss_criterionCycle"], config)
            self.criterionIdt = losses_lib.get_loss_function_by_name(
                tr["loss_criterionIdt"], config)
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

    # ------------------------------------------------------------------
    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with self.autocast():
            return self.networks[name](x)

    def g_step(self, real_A, real_B, background, u):
        """The generators' update (``g_step``, :239-276): returns the
        detached ``fake_B``, ``fake_A``, ``rec_A`` and ``idt_A`` and the
        seven losses as 0-d tensors, in the JAX step's order."""
        gan, cyc, idt = self.criterionGAN, self.criterionCycle, self.criterionIdt
        lA, lB, lidt = self.lambda_A, self.lambda_B, self.lambda_idt
        for net in self.networks.values():
            net.train()
        opt = self.opt["optimizer_G"]
        opt.zero_grad(set_to_none=True)
        discs = [self.networks[n] for n in self.optimizer_mapping["optimizer_D"]]
        for d in discs:  # the G step's gradient reaches no discriminator
            d.requires_grad_(False)
        try:
            bg = background * u
            fake_B = self._net("netG_A", torch.maximum(real_A, bg))
            rec_A = self._net("netG_B", fake_B)
            fake_A = self._net("netG_B", real_B)
            rec_B = self._net("netG_A", torch.maximum(fake_A, bg))
            if lidt > 0:
                idt_A = self._net("netG_A", real_B)
                loss_idt_A = idt(idt_A, real_B) * lB * lidt
                idt_B = self._net("netG_B", real_A)
                loss_idt_B = idt(idt_B, real_A) * lA * lidt
            else:
                idt_A = fake_B
                loss_idt_A = loss_idt_B = torch.zeros(
                    (), device=real_A.device, dtype=fake_B.dtype)
            loss_G_A = gan(self._net("netD_A", fake_B), True)
            loss_G_B = gan(self._net("netD_B", fake_A), True)
            loss_cycle_A = cyc(rec_A, real_A) * lA
            loss_cycle_B = cyc(rec_B, real_B) * lB
            loss_G = (loss_G_A + loss_G_B + loss_cycle_A + loss_cycle_B
                      + loss_idt_A + loss_idt_B)
            loss_G.backward()
        finally:
            for d in discs:
                d.requires_grad_(True)
        opt.step()
        losses = dict(G=loss_G, G_A=loss_G_A, G_B=loss_G_B,
                      cycle_A=loss_cycle_A, cycle_B=loss_cycle_B,
                      idt_A=loss_idt_A, idt_B=loss_idt_B)
        images = (fake_B, fake_A, rec_A, idt_A)
        return ([x.detach() for x in images],
                {k: v.detach() for k, v in losses.items()})

    def d_step(self, real_A, real_B, pooled_fake_A, pooled_fake_B):
        """The discriminators' update (``d_step``, :280-301) on the replayed
        fakes; returns ``loss_D_A`` and ``loss_D_B``, detached."""
        gan = self.criterionGAN
        opt = self.opt["optimizer_D"]
        opt.zero_grad(set_to_none=True)

        def d_basic(name, real, fake):
            loss_real = gan(self._net(name, real), True)
            loss_fake = gan(self._net(name, fake.detach()), False)
            return (loss_real + loss_fake) * 0.5

        loss_D_A = d_basic("netD_A", real_B, pooled_fake_B)
        loss_D_B = d_basic("netD_B", real_A, pooled_fake_A)
        (loss_D_A + loss_D_B).backward()
        opt.step()
        return loss_D_A.detach(), loss_D_B.detach()

    def train_step(self, real_A, real_B, background, u):
        """The G step, the pools, the D step. Returns ``(images, losses)``:
        the detached ``fake_B``, ``fake_A``, ``rec_A`` and ``idt_A``, and the
        nine losses as 0-d tensors on the device."""
        images, losses = self.g_step(real_A, real_B, background, u)
        fake_B, fake_A = images[0], images[1]
        pooled_B = self.fake_B_pool.query(fake_B)
        pooled_A = self.fake_A_pool.query(fake_A)
        losses["D_A"], losses["D_B"] = self.d_step(real_A, real_B, pooled_A,
                                                   pooled_B)
        return images, losses

    def perform_training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        if "background" in mini_batch:
            background = self._batch_in(mini_batch["background"])
        else:
            background = torch.rand(real_A.shape, generator=self.generator,
                                    device=self.device)
        u = torch.rand(real_A.shape, generator=self.generator,
                       device=self.device)
        (fake_B, fake_A, rec_A, idt_A), losses = self.train_step(
            real_A, real_B, background, u)
        values = torch.stack(list(losses.values())).tolist()  # one sync
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      rec_A),
            "label": _post_first(post_transformations.get("label"), real_A),
            # on the device until a sample is plotted
            "fake_B": fake_B[0:1, 0:1],
            "idt_A": idt_A[0:1, 0:1],
            "real_B_seg": fake_A[0:1, 0:1],
        }
        return outputs, dict(zip(losses, values))

    def inference(self, mini_batch, post_transformations, phase=Phase.TEST):
        net = "netG_A" if "netG_A" in self.networks else "netG_B"
        return self._gen_inference(
            net, mini_batch, post_transformations, phase,
            getattr(self, "criterionCycle", None), "loss_criterionCycle")
