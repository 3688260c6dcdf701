"""Unpaired image-translation algorithms, the GAN zoo: CycleGAN, the
contrastive family (CUT, NEGCUT, DCLGAN) and NICE-GAN.

Counterpart of ``octa_tpu/train/gan_algorithms.py``: ``register`` and
``build`` (:36-50), ``ImagePool`` (:52-76), ``_UnpairedBase`` (:79-166),
``CycleGANAlgorithm`` (:169-331), ``_sample_patch_ids`` (:334-337),
``CUTAlgorithm`` (:340-515), ``NEGCUTAlgorithm`` (:518-719),
``DCLGANAlgorithm`` (:722-944) and ``NiceGANAlgorithm`` (:947-1177).

A step is the JAX package's jitted steps in eager PyTorch, with the same
losses, the same order of updates and the same gradient flow; Adam with
betas (0.5, 0.999); bf16 autocast under ``General.amp``. A CycleGAN step is
the G step (GAN, cycle and identity losses of both generators, with the
background composite ``max(real_A, background * u)``) through the
discriminators, which take no gradient from it, then the D step on the
fakes replayed by the ``ImagePool``\\ s, detached. A CUT step is the D
step on the detached fake, then one G+F step through the discriminator at
its new parameters: GAN plus the multilayer PatchNCE of the generator's
feature taps (query: the generator's encoding of its output; key: of its
input; the same patch ids for both). NEGCUT adds an N step between them,
which maximises the PatchNCE against ``netN``'s negatives over ``netN``
alone, and the EMA mirror ``netF_``. DCLGAN takes the D step first on the
pooled fakes, then the G+F step with the NCE in both directions. A
NICE-GAN step is the D step (each discriminator on its real and on the
other direction's detached translation of the real encoding), then the G
step through the discriminators at their new parameters; while a profiler
session records, the two are the spans ``octa.train.D`` and
``octa.train.G`` (each with its Adam step), noted with the
``power_iterations`` of the spectral norms inside them. On one CUDA
card its sixteen network passes replay CUDA graphs, two launches each
(``train/graphed.py``), after the discriminators' power iterations. A
generator pass that the JAX package takes twice at the same parameters is
taken once here (same value); a pass whose gradient the JAX step stops is
taken without a graph. The projection heads, the L2 norms and the NCE
logits run in float32 outside autocast (the JAX package's ``Dense`` heads
carry no ``dtype``). Patch ids and NEGCUT's noise come from the
algorithm's ``torch.Generator``; the step functions take them as
arguments, as the JAX package's jitted steps do. The losses of a step come
back to the host in one read.

On a data-parallel mesh (``BaseAlgorithm._setup_mesh``) each rank steps on
its rows of the global batch: the backgrounds, ``u`` and NEGCUT's noise are
drawn for the global batch on every rank (the generators are seeded alike)
and each rank keeps its rows; patch ids, one draw for every sample, are the
same on every rank; an ``ImagePool`` replays the global batch of fakes
(gathered from every rank) on every rank with the same choices, and each
rank keeps its rows of what it returns.
"""
from __future__ import annotations

import contextlib
import copy
import os
import random as pyrandom
from typing import Any

import torch

from octa_tpu_torch.io import checkpoints as ck
from octa_tpu_torch.models.layers import SpectralNormConv, kaiming_normal_
from octa_tpu_torch.models.registry import build_network
from octa_tpu_torch.train.algorithms import BaseAlgorithm, _host, _post_first
from octa_tpu_torch.train.graphed import GraphedPasses
from octa_tpu_torch.utils import trace
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
            f"Algorithm {name} is not implemented. Available: "
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

    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with self.autocast():
            return self.networks[name](x)

    @contextlib.contextmanager
    def _frozen(self, names):
        """The networks ``names`` take no gradient inside the block (a
        gradient still flows through them)."""
        nets = [self.networks[n] for n in names]
        for n in nets:
            n.requires_grad_(False)
        try:
            yield
        finally:
            for n in nets:
                n.requires_grad_(True)

    # -- the contrastive family's shared parts (CUT, NEGCUT, DCLGAN) -------
    def _dry_taps(self, init_mini_batch, net_name: str) -> list:
        """The feature taps of ``net_name`` on a zero image of one sample
        of the batch's shape (the JAX package's dry encode, :389-398)."""
        key = "real_A" if "real_A" in init_mini_batch else "image"
        shape = tuple(init_mini_batch[key].shape[1:])
        net = self.networks[net_name]
        w = next(net.parameters())
        with torch.no_grad():
            return net(torch.zeros((1, *shape), device=w.device,
                                   dtype=w.dtype),
                       layers=self.nce_layers, encode_only=True)

    def _add_head(self, name: str, cfg: dict, in_channels: list, seed: int,
                  like: str):
        """Build the projection head ``name`` for levels of
        ``in_channels`` channels, its weights drawn from ``seed`` (the JAX
        package's key for it), in the dtype of the network ``like``."""
        net = build_network(cfg, in_channels=in_channels)
        kaiming_normal_(net, torch.Generator().manual_seed(seed))
        dtype = next(self.networks[like].parameters()).dtype
        self.networks[name] = net.to(self.device, dtype)

    def _patch_ids(self) -> list:
        """One draw of patch ids, a tensor a tap, from the algorithm's
        generator."""
        return _sample_patch_ids(self.generator, self.feat_sizes,
                                 self.num_patches)

    def _pool(self, pool: ImagePool, fakes: torch.Tensor) -> torch.Tensor:
        """``pool.query`` of the step's global batch of ``fakes``: on a mesh
        every rank replays the gathered batch and keeps its rows."""
        if self._shard is None:
            return pool.query(fakes)
        return self._shard.take(pool.query(self._shard.gather(fakes)))

    def _global_rand(self, mini_batch) -> torch.Tensor:
        """One uniform draw of the shape of the global batch's ``real_A``
        from the algorithm's generator: this rank's rows of it."""
        shape = tuple(mini_batch["real_A"].shape)
        return self._local(torch.rand(shape, generator=self.generator,
                                      device=self.device))

    def _encode(self, name: str, x: torch.Tensor) -> list:
        """The taps ``nce_layers`` of the generator ``name`` on ``x``."""
        with self.autocast():
            return self.networks[name](x, layers=self.nce_layers,
                                       encode_only=True)

    def _patch_nce(self, feat_q, feat_k, ids, head_q: str, head_k: str,
                   negs=None, weight: float = 1.0):
        """The multilayer PatchNCE: each level's mean loss times ``weight``,
        summed and divided by the number of levels. The key is detached in
        the loss, so its projection is taken without a graph."""
        fq, _ = self.networks[head_q](feat_q, ids, self.num_patches)
        with torch.no_grad():
            fk, _ = self.networks[head_k](feat_k, ids, self.num_patches)
        total = 0.0
        for level, (f_q, f_k) in enumerate(zip(fq, fk)):
            n_k = None if negs is None else negs[level]
            total = total + self.criterionNCE(
                f_q, f_k, n_k, shard=self._shard).mean() * weight
        return total / len(self.nce_layers)

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
        if "fake_B" not in outputs and "idt_B" in outputs:  # CUT, NEGCUT
            return visualizer.plot_cut_sample(
                _host(mini_batch["real_A"][0]),
                _host(outputs["prediction"][0]),
                _host(mini_batch["real_B"][0]), _host(outputs["idt_B"][0]),
                suffix=suffix)
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
            self.criterionGAN = self.registry_loss(
                tr["loss_criterionGAN"], config)
            self.criterionCycle = self.registry_loss(
                tr["loss_criterionCycle"], config)
            self.criterionIdt = self.registry_loss(
                tr["loss_criterionIdt"], config)
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

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
        # the G step's gradient reaches no discriminator
        with self._frozen(self.optimizer_mapping["optimizer_D"]):
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
        pooled_B = self._pool(self.fake_B_pool, fake_B)
        pooled_A = self._pool(self.fake_A_pool, fake_A)
        losses["D_A"], losses["D_B"] = self.d_step(real_A, real_B, pooled_A,
                                                   pooled_B)
        return images, losses

    def _training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        if "background" in mini_batch:
            background = self._batch_in(mini_batch["background"])
        else:
            background = self._global_rand(mini_batch)
        u = self._global_rand(mini_batch)
        (fake_B, fake_A, rec_A, idt_A), losses = self.train_step(
            real_A, real_B, background, u)
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      rec_A),
            "label": _post_first(post_transformations.get("label"), real_A),
            # on the device until a sample is plotted
            "fake_B": fake_B[0:1, 0:1],
            "idt_A": idt_A[0:1, 0:1],
            "real_B_seg": fake_A[0:1, 0:1],
        }
        return outputs, losses

    def inference(self, mini_batch, post_transformations, phase=Phase.TEST):
        net = "netG_A" if "netG_A" in self.networks else "netG_B"
        return self._gen_inference(
            net, mini_batch, post_transformations, phase,
            getattr(self, "criterionCycle", None), "loss_criterionCycle")


def _sample_patch_ids(generator: torch.Generator, sizes, num_patches: int):
    """For each level of ``sizes`` positions, the first ``min(num_patches,
    size)`` of a random permutation drawn from ``generator``, on its
    device."""
    return [torch.randperm(s, generator=generator,
                           device=generator.device)[:min(num_patches, s)]
            for s in sizes]


def _nce_layers(spec) -> list[int]:
    return [int(i) for i in str(spec).split(",")]


@register("CUTModel")
class CUTAlgorithm(_UnpairedBase):
    """Contrastive unpaired translation (reference ``cut.py:120-242``): one
    generator ``netG``, a PatchGAN ``netD`` and the patch projector
    ``netF``."""

    optimizer_mapping = {"optimizer_G": ["netG"], "optimizer_D": ["netD"],
                         "optimizer_F": ["netF"]}

    def __init__(self, config, phase, netG_config, netD_config=None,
                 netF_config=None, nce_layers="0,4,8,12,16", nce_idt=True,
                 lambda_NCE=1.0, lambda_GAN=1.0, flip_equivariance=False,
                 num_patches=256, inference=None, device="cuda", **kw):
        super().__init__(config, phase, device)
        self.inference_mode = inference or config["General"].get("inference")
        self.nce_layers = _nce_layers(nce_layers)
        self.nce_idt = nce_idt
        self.lambda_NCE = lambda_NCE
        self.lambda_GAN = lambda_GAN
        self.flip_equivariance = flip_equivariance  # stored, as in JAX
        self.num_patches = num_patches
        self.netF_config = dict(netF_config or {"name": "PatchSamplerF"})
        self.netF_config.setdefault("use_mlp", True)
        self.networks["netG"] = build_network(dict(netG_config))
        if phase == Phase.TRAIN:
            self.networks["netD"] = build_network(dict(netD_config))
            # the patch ids (and NEGCUT's noise) the JAX package draws
            self.generator = torch.Generator(self.device).manual_seed(
                self.seed)
        self._init_weights()

    def _init_heads(self, init_mini_batch):
        """``netF`` from the channel counts of a dry encode, and the
        positions of each tap for the patch ids."""
        feats = self._dry_taps(init_mini_batch, "netG")
        self.feat_sizes = [f.shape[2] * f.shape[3] for f in feats]
        self._add_head("netF", self.netF_config, [f.shape[1] for f in feats],
                       self.seed + 17, "netG")

    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase=Phase.TRAIN):
        if phase != Phase.TRAIN:
            self.inference_mode = "netG"
            self._load_inference_checkpoint(config, args)
            return
        tr = config[Phase.TRAIN]
        self.criterionGAN = self.registry_loss(
            tr["loss_criterionGAN"], config)
        self.criterionNCE = self.registry_loss(
            tr["loss_criterionNCE"], config)
        self._init_heads(init_mini_batch)
        self._init_optimizers(config)
        if getattr(args, "start_epoch", 0) > 0:
            self._load_resume_checkpoints(config, args)

    # ------------------------------------------------------------------
    def translate(self, real_A, real_B):
        """``fake_B`` and ``idt_B`` (None without ``nce_idt``) from the
        current generator, with their graphs: the D step takes them
        detached, the G+F step through its own gradient."""
        for net in self.networks.values():
            net.train()
        fake_B = self._net("netG", real_A)
        idt_B = self._net("netG", real_B) if self.nce_idt else None
        return fake_B, idt_B

    def d_step(self, fake_B, real_B):
        """The discriminator's update on the detached ``fake_B`` and
        ``real_B``; returns ``D_fake`` and ``D_real``, detached."""
        gan = self.criterionGAN
        opt = self.opt["optimizer_D"]
        opt.zero_grad(set_to_none=True)
        loss_fake = gan(self._net("netD", fake_B.detach()), False)
        loss_real = gan(self._net("netD", real_B), True)
        ((loss_fake + loss_real) * 0.5).backward()
        opt.step()
        return loss_fake.detach(), loss_real.detach()

    def _nce_loss(self, src, tgt, ids):
        """CUT's ``_nce_loss`` (:412-423): the query is the encoding of
        ``tgt``, the key of ``src``."""
        feat_q = self._encode("netG", tgt)
        with torch.no_grad():
            feat_k = self._encode("netG", src)
        return self._patch_nce(feat_q, feat_k, ids, "netF", "netF",
                               weight=self.lambda_NCE)

    def g_step(self, real_A, real_B, fake_B, idt_B, ids_a, ids_b) -> dict:
        """The generator's and the projector's update (:449-480) through
        the discriminator at its new parameters, which takes no gradient;
        returns ``G``, ``loss_NCE`` and ``loss_NCE_Y``, detached."""
        gan = self.criterionGAN
        for name in ("optimizer_G", "optimizer_F"):
            self.opt[name].zero_grad(set_to_none=True)
        zero = fake_B.new_zeros(())
        with self._frozen(["netD"]):
            loss_G_GAN = (gan(self._net("netD", fake_B), True)
                          * self.lambda_GAN if self.lambda_GAN > 0 else zero)
            loss_NCE = (self._nce_loss(real_A, fake_B, ids_a)
                        if self.lambda_NCE > 0 else zero)
            if self.nce_idt and self.lambda_NCE > 0:
                loss_NCE_Y = self._nce_loss(real_B, idt_B, ids_b)
                loss_NCE_both = (loss_NCE + loss_NCE_Y) * 0.5
            else:
                loss_NCE_Y = zero
                loss_NCE_both = loss_NCE
            loss_G = loss_G_GAN + loss_NCE_both
            loss_G.backward()
        self.opt["optimizer_G"].step()
        self.opt["optimizer_F"].step()
        return {"G": loss_G.detach(), "loss_NCE": loss_NCE.detach(),
                "loss_NCE_Y": loss_NCE_Y.detach()}

    def train_step(self, real_A, real_B, ids_a, ids_b):
        """The D step, then the G+F step (the JAX package's jitted ``step``,
        :428-496, with the patch ids given). Returns ``((fake_B, idt_B),
        losses)``: the images detached, the losses ``G``, ``loss_NCE``,
        ``loss_NCE_Y``, ``D_fake``, ``D_real`` as 0-d tensors."""
        fake_B, idt_B = self.translate(real_A, real_B)
        d_fake, d_real = self.d_step(fake_B, real_B)
        losses = self.g_step(real_A, real_B, fake_B, idt_B, ids_a, ids_b)
        losses.update(D_fake=d_fake, D_real=d_real)
        return _detached(fake_B, idt_B), losses

    def _outputs(self, post_transformations, fake_B, real_B, idt_B) -> dict:
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      fake_B),
            # the JAX package post-processes the label as a prediction
            "label": _post_first(post_transformations.get("prediction"),
                                 real_B),
        }
        if idt_B is not None:  # on the device until a sample is plotted
            outputs["idt_B"] = idt_B[0:1, 0:1]
        return outputs

    def _training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        ids_a, ids_b = self._patch_ids(), self._patch_ids()
        (fake_B, idt_B), losses = self.train_step(real_A, real_B, ids_a,
                                                  ids_b)
        return (self._outputs(post_transformations, fake_B, real_B, idt_B),
                losses)

    def inference(self, mini_batch, post_transformations, phase=Phase.TEST):
        return self._gen_inference("netG", mini_batch, post_transformations,
                                   phase)


@register("NEGCUTModel")
class NEGCUTAlgorithm(CUTAlgorithm):
    """NEGCUT (reference ``negcut.py:129-279``): CUT with an adversarial
    negative generator ``netN``, which maximises the PatchNCE loss, and
    ``netF_``, an EMA mirror of ``netF`` (decay 0.9) through which the
    negatives' pools are projected.

    As in the JAX package, ``netF_`` is neither checkpointed nor restored:
    it starts as a copy of the initial ``netF``, made before a resume loads
    the checkpoints (:547), and a resumed run's mirror starts there
    again."""

    optimizer_mapping = {"optimizer_G": ["netG"], "optimizer_D": ["netD"],
                         "optimizer_F": ["netF"], "optimizer_N": ["netN"]}

    def __init__(self, config, phase, netG_config, netD_config=None,
                 netF_config=None, netN_config=None,
                 nce_layers="0,4,8,12,16", nce_idt=True, lambda_NCE=1.0,
                 lambda_GAN=1.0, lambda_MS_neg=1.0, flip_equivariance=False,
                 num_patches=256, inference=None, device="cuda", **kw):
        super().__init__(config, phase, netG_config, netD_config, netF_config,
                         nce_layers, nce_idt, lambda_NCE, lambda_GAN,
                         flip_equivariance, num_patches, inference, device)
        self.lambda_MS_neg = lambda_MS_neg
        self.netN_config = dict(netN_config or {"name": "Negative_Generator"})

    def _init_heads(self, init_mini_batch):
        super()._init_heads(init_mini_batch)
        self.networks["netF_"] = copy.deepcopy(self.networks["netF"])
        self._add_head("netN", self.netN_config,
                       self.networks["netF"].out_channels, self.seed + 23,
                       "netG")

    def _nce_loss_neg(self, src, tgt, ids, noise, detach_qk=False):
        """NEGCUT's ``_nce_loss_neg`` (:574-589): the PatchNCE of ``tgt``'s
        encoding against ``src``'s with ``netN``'s negatives, made from
        ``src``'s encoding projected at every position by ``netF_``.
        Returns ``(loss, negatives)``. With ``detach_qk`` (the N step) the
        query and the key carry no gradient and the pools none either (the
        N step differentiates ``netN`` alone); otherwise the gradient
        reaches ``netG`` through the negatives too."""
        with torch.set_grad_enabled(not detach_qk):
            feat_q = self._encode("netG", tgt)
            feat_k = self._encode("netG", src)
            pools, _ = self.networks["netF_"](feat_k, None, 0)
        if noise is None:
            noise = self._global_noise(pools)
        negs = self.networks["netN"](pools, self.num_patches, noise=noise)
        loss = self._patch_nce(feat_q, feat_k, ids, "netF", "netF", negs,
                               weight=self.lambda_NCE)
        return loss, negs

    def _global_noise(self, pools) -> list:
        """``netN``'s noise of one call, level after level as ``netN`` draws
        it, from the algorithm's generator for the step's global batch:
        this rank's rows."""
        net = self.networks["netN"]
        n = pools[0].shape[0] if self._shard is None else self._shard.n
        return [self._local(torch.randn(
            (n, self.num_patches, net.z_dim), generator=self.generator,
            device=self.device, dtype=getattr(net, f"mlp_{lv}_0").weight.dtype))
            for lv in range(len(pools))]

    def n_step(self, real_A, real_B, fake_B, idt_B, ids_a, ids_b,
               noise=(None, None)):
        """``netN``'s update (:612-640): it minimises ``-NCE + MS``, the MS
        diversity term over the negatives of the last NCE call (the identity
        call with ``nce_idt``). Returns the loss ``N``, detached."""
        opt = self.opt["optimizer_N"]
        opt.zero_grad(set_to_none=True)
        with self._frozen(["netF"]):
            l1, negs = self._nce_loss_neg(real_A, fake_B.detach(), ids_a,
                                          noise[0], detach_qk=True)
            if self.nce_idt:
                l2, negs = self._nce_loss_neg(real_B, idt_B.detach(), ids_b,
                                              noise[1], detach_qk=True)
                l_both = (l1 + l2) * 0.5
            else:
                l_both = l1
        ms = 0.0
        if self.lambda_MS_neg > 0:
            half = self.num_patches // 2
            for n_k in negs:
                nk = n_k.reshape(-1, self.num_patches, n_k.shape[-1])
                ms = ms + (-torch.mean(torch.abs(nk[:, :half] - nk[:, half:]))
                           * self.lambda_MS_neg)
            ms = ms / len(self.nce_layers)
        loss_N = -l_both + ms
        loss_N.backward()
        opt.step()
        return loss_N.detach()

    def g_step(self, real_A, real_B, fake_B, idt_B, ids_a, ids_b,
               noise=(None, None)) -> dict:
        """The generator's and the projector's update (:643-683) through
        ``netD``, ``netF_`` and ``netN`` at their new parameters, which take
        no gradient; then the EMA ``netF_ = 0.9 netF_ + 0.1 netF``.
        Returns ``G``, ``loss_NCE`` and ``loss_NCE_Y``, detached."""
        gan = self.criterionGAN
        for name in ("optimizer_G", "optimizer_F"):
            self.opt[name].zero_grad(set_to_none=True)
        with self._frozen(["netD", "netF_", "netN"]):
            loss_G_GAN = (gan(self._net("netD", fake_B), True) * self.lambda_GAN
                          if self.lambda_GAN > 0 else fake_B.new_zeros(()))
            loss_NCE, _ = self._nce_loss_neg(real_A, fake_B, ids_a, noise[0])
            if self.nce_idt:
                loss_NCE_Y, _ = self._nce_loss_neg(real_B, idt_B, ids_b,
                                                   noise[1])
                loss_NCE_both = (loss_NCE + loss_NCE_Y) * 0.5
            else:
                loss_NCE_Y = torch.zeros_like(loss_NCE)
                loss_NCE_both = loss_NCE
            loss_G = loss_G_GAN + loss_NCE_both
            loss_G.backward()
        self.opt["optimizer_G"].step()
        self.opt["optimizer_F"].step()
        with torch.no_grad():
            for ema, new in zip(self.networks["netF_"].parameters(),
                                self.networks["netF"].parameters()):
                ema.copy_(ema * 0.9 + new * 0.1)
        return {"G": loss_G.detach(), "loss_NCE": loss_NCE.detach(),
                "loss_NCE_Y": loss_NCE_Y.detach()}

    def train_step(self, real_A, real_B, ids_a, ids_b, noise=None):
        """The D step, the N step, then the G+F step (the JAX package's
        jitted ``step``, :594-702, with the patch ids given). ``noise``, where
        given, is the four draws of the step's ``netN`` calls (JAX's ``r1``
        to ``r4``), each a list of one [B, num_patches, z_dim] tensor a
        level; else they come from the algorithm's generator. Returns
        ``((fake_B, idt_B), losses)`` with the losses ``G``, ``loss_NCE``,
        ``loss_NCE_Y``, ``D_fake``, ``D_real`` and ``N``."""
        noise = noise or (None,) * 4
        fake_B, idt_B = self.translate(real_A, real_B)
        d_fake, d_real = self.d_step(fake_B, real_B)
        loss_N = self.n_step(real_A, real_B, fake_B, idt_B, ids_a, ids_b,
                             noise[:2])
        losses = self.g_step(real_A, real_B, fake_B, idt_B, ids_a, ids_b,
                             noise[2:])
        losses.update(D_fake=d_fake, D_real=d_real, N=loss_N)
        return _detached(fake_B, idt_B), losses


@register("DCLGAN")
class DCLGANAlgorithm(_UnpairedBase):
    """Dual contrastive learning (reference ``dclgan.py:183-293``): two
    generators, two discriminators fed by ``ImagePool``\\ s, and two patch
    projectors, the PatchNCE in both directions plus the identity losses.
    The D step comes first, on the pooled fakes of the current generators;
    then the G+F step through the discriminators at their new
    parameters."""

    optimizer_mapping = {"optimizer_G": ["netG_A", "netG_B"],
                         "optimizer_D": ["netD_A", "netD_B"],
                         "optimizer_F": ["netF1", "netF2"]}

    def __init__(self, config, phase, netG_A_config, netG_B_config,
                 netD_A_config=None, netD_B_config=None, netF1_config=None,
                 netF2_config=None, nce_layers="0,4,8,12,16",
                 lambda_A=10.0, lambda_B=10.0, lambda_idt=0.5,
                 lambda_NCE=2.0, lambda_GAN=1.0, num_patches=256,
                 pool_size=50, inference=None, device="cuda", **kw):
        super().__init__(config, phase, device)
        self.inference_mode = inference or config["General"].get("inference")
        self.nce_layers = _nce_layers(nce_layers)
        self.lambda_A, self.lambda_B = lambda_A, lambda_B
        self.lambda_idt, self.lambda_NCE = lambda_idt, lambda_NCE
        self.lambda_GAN = lambda_GAN  # stored, as in JAX
        self.num_patches = num_patches
        self.head_configs = {}
        for name, cfg in (("netF1", netF1_config), ("netF2", netF2_config)):
            c = dict(cfg or {"name": "PatchSamplerF"})
            c.setdefault("use_mlp", True)
            self.head_configs[name] = c
        if phase == Phase.TRAIN or self.inference_mode == "netG_A":
            self.networks["netG_A"] = build_network(dict(netG_A_config))
        if phase == Phase.TRAIN or self.inference_mode == "netG_B":
            self.networks["netG_B"] = build_network(dict(netG_B_config))
        if phase == Phase.TRAIN:
            self.networks["netD_A"] = build_network(dict(netD_A_config))
            self.networks["netD_B"] = build_network(dict(netD_B_config))
            self.fake_A_pool = ImagePool(pool_size, self.seed)
            self.fake_B_pool = ImagePool(pool_size, self.seed + 1)
            # the background, u and patch-id draws
            self.generator = torch.Generator(self.device).manual_seed(
                self.seed)
        self._init_weights()

    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase=Phase.TRAIN):
        tr = config.get(Phase.TRAIN, {})
        if phase != Phase.TEST:
            self.criterionGAN = self.registry_loss(
                tr["loss_criterionGAN"], config)
            self.criterionCycle = self.registry_loss(
                tr.get("loss_criterionCycle", "L1Loss"), config)
            self.criterionIdt = self.registry_loss(
                tr.get("loss_criterionIdt", "L1Loss"), config)
        if phase != Phase.TRAIN:
            self._load_inference_checkpoint(config, args)
            return
        self.criterionNCE = self.registry_loss(
            tr["loss_criterionNCE"], config)
        feats = self._dry_taps(init_mini_batch, "netG_A")
        self.feat_sizes = [f.shape[2] * f.shape[3] for f in feats]
        for j, name in enumerate(("netF1", "netF2")):
            self._add_head(name, self.head_configs[name],
                           [f.shape[1] for f in feats], self.seed + 31 + j,
                           "netG_A")
        self._init_optimizers(config)
        if getattr(args, "start_epoch", 0) > 0:
            self._load_resume_checkpoints(config, args)

    # ------------------------------------------------------------------
    def translate(self, real_A, real_B, background, u):
        """``fake_B`` (from the background composite) and ``fake_A`` of the
        current generators, with their graphs."""
        for net in self.networks.values():
            net.train()
        fake_B = self._net("netG_A", torch.maximum(real_A, background * u))
        fake_A = self._net("netG_B", real_B)
        return fake_B, fake_A

    def d_step(self, real_A, real_B, pooled_fake_A, pooled_fake_B):
        """The discriminators' update on the pooled fakes, detached
        (``d_step``, :833-850); returns ``D_A`` and ``D_B``, detached."""
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

    def _nce(self, enc_q, enc_k, head_q, head_k, src, tgt, ids):
        """DCLGAN's ``_nce`` (:817-829): the query is ``enc_q``'s encoding
        of ``tgt`` through ``head_q``, the key ``enc_k``'s of ``src``
        through ``head_k``."""
        feat_q = self._encode(enc_q, tgt)
        with torch.no_grad():
            feat_k = self._encode(enc_k, src)
        return self._patch_nce(feat_q, feat_k, ids, head_q, head_k)

    def g_step(self, real_A, real_B, fake_B, fake_A, ids1, ids2):
        """The generators' and the projectors' update (``g_step``,
        :853-901) through the discriminators at their new parameters,
        which take no gradient. Returns ``(rec_A, idt_A)`` detached and the
        losses ``G``, ``G_A``, ``G_B``, ``NCE1``, ``NCE2``, ``idt_A``,
        ``idt_B``, detached."""
        gan, idt = self.criterionGAN, self.criterionIdt
        for name in ("optimizer_G", "optimizer_F"):
            self.opt[name].zero_grad(set_to_none=True)
        with torch.no_grad():
            rec_A = self._net("netG_B", fake_B)
        with self._frozen(self.optimizer_mapping["optimizer_D"]):
            if self.lambda_idt > 0:
                idt_A = self._net("netG_A", real_B)
                l_idt_A = idt(idt_A, real_B) * self.lambda_B * self.lambda_idt
                idt_B = self._net("netG_B", real_A)
                l_idt_B = idt(idt_B, real_A) * self.lambda_A * self.lambda_idt
            else:
                idt_A = fake_B
                l_idt_A = l_idt_B = fake_B.new_zeros(())
            l_G_A = gan(self._net("netD_A", fake_B), True)
            l_G_B = gan(self._net("netD_B", fake_A), True)
            if self.lambda_NCE > 0:
                nce1 = self._nce("netG_B", "netG_A", "netF2", "netF1", real_A,
                                 fake_B, ids1) * self.lambda_NCE
                nce2 = self._nce("netG_A", "netG_B", "netF1", "netF2", real_B,
                                 fake_A, ids2) * self.lambda_NCE
            else:
                nce1 = nce2 = fake_B.new_zeros(())
            loss_G = ((l_G_A + l_G_B) * 0.5 + (nce1 + nce2) * 0.5
                      + (l_idt_A + l_idt_B) * 0.5)
            loss_G.backward()
        self.opt["optimizer_G"].step()
        self.opt["optimizer_F"].step()
        losses = dict(G=loss_G, G_A=l_G_A, G_B=l_G_B, NCE1=nce1, NCE2=nce2,
                      idt_A=l_idt_A, idt_B=l_idt_B)
        return (_detached(rec_A, idt_A),
                {k: v.detach() for k, v in losses.items()})

    def train_step(self, real_A, real_B, background, u, ids1, ids2):
        """The fakes, the pools, the D step, then the G+F step (the JAX
        package's ``perform_training_step``, :903-925, with the draws
        given). Returns ``((fake_B, fake_A, rec_A, idt_A), losses)``: the
        images detached, the nine losses as 0-d tensors."""
        fake_B, fake_A = self.translate(real_A, real_B, background, u)
        pooled_B = self._pool(self.fake_B_pool, fake_B.detach())
        pooled_A = self._pool(self.fake_A_pool, fake_A.detach())
        d_A, d_B = self.d_step(real_A, real_B, pooled_A, pooled_B)
        (rec_A, idt_A), losses = self.g_step(real_A, real_B, fake_B, fake_A,
                                             ids1, ids2)
        losses.update(D_A=d_A, D_B=d_B)
        return (fake_B.detach(), fake_A.detach(), rec_A, idt_A), losses

    def _training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        if "background" in mini_batch:
            background = self._batch_in(mini_batch["background"])
        else:
            background = self._global_rand(mini_batch)
        u = self._global_rand(mini_batch)
        ids1, ids2 = self._patch_ids(), self._patch_ids()
        (fake_B, fake_A, rec_A, idt_A), losses = self.train_step(
            real_A, real_B, background, u, ids1, ids2)
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      rec_A),
            "label": _post_first(post_transformations.get("label"), real_A),
            # on the device until a sample is plotted
            "fake_B": fake_B[0:1, 0:1],
            "idt_A": idt_A[0:1, 0:1],
            "real_B_seg": fake_A[0:1, 0:1],
        }
        return outputs, losses

    def inference(self, mini_batch, post_transformations, phase=Phase.TEST):
        net = "netG_A" if "netG_A" in self.networks else "netG_B"
        return self._gen_inference(
            net, mini_batch, post_transformations, phase,
            getattr(self, "criterionCycle", None), "L1_cycle")


@register("NiceGAN")
class NiceGANAlgorithm(_UnpairedBase):
    """NICE-GAN (reference ``nice_gan.py:119-240``): each discriminator's
    trunk encodes its domain for the generator into the other one;
    multi-scale adversarial losses (local, global and CAM heads), cycle and
    reconstruction losses. ``gen2B`` decodes ``disA``'s encoding of an A
    image into B, ``gen2A`` ``disB``'s of a B image into A.

    The spectral norms' ``u`` lives in the discriminators' buffers: each
    discriminator call of a training step takes one power iteration and
    keeps its ``u``, in the JAX step's order (D step: ``disA(real_A)``,
    ``disB(real_B)``, ``disA(fake_B2A)``, ``disB(fake_A2B)``; G step at the
    new parameters: ``disA(max(real_A, bg))``, ``disB(real_B)``,
    ``disA(max(fake_B2A, bg))``, ``disB(fake_A2B)``), so no pass is
    recomputed. As in the JAX package, ``u`` is not checkpointed: a resumed
    run and ``test`` start it again from its initial value, and inference
    takes one iteration from the stored ``u`` and keeps none."""

    optimizer_mapping = {"G_optim": ["gen2A", "gen2B"],
                         "D_optim": ["disA", "disB"]}

    def __init__(self, config, phase, gen2B_config=None, gen2A_config=None,
                 disA_config=None, disB_config=None, adv_weight=1.0,
                 cycle_weight=10.0, recon_weight=1.0, inference=None,
                 device="cuda", **kw):
        super().__init__(config, phase, device)
        self.inference_mode = inference or config["General"].get("inference")
        self.adv_weight = adv_weight
        self.cycle_weight = cycle_weight
        self.recon_weight = recon_weight
        # the JAX package's network order (:963-973); the generators are
        # built once a dry pass of a discriminator gives z's channels
        built = []
        if phase == Phase.TRAIN or self.inference_mode == "gen2A":
            built += [("gen2A", gen2A_config), ("disB", disB_config)]
        if phase == Phase.TRAIN or self.inference_mode == "gen2B":
            built += [("gen2B", gen2B_config), ("disA", disA_config)]
        self._order = [n for n, _ in built]
        self._gen_configs = {n: dict(c) for n, c in built
                             if n.startswith("gen")}
        # discriminator i of the network order draws from seed + i
        for i, (name, cfg) in enumerate(
                (n, c) for n, c in built if n.startswith("dis")):
            net = build_network(dict(cfg))
            kaiming_normal_(net, torch.Generator().manual_seed(self.seed + i))
            self.networks[name] = net.to(self.device)
        if phase == Phase.TRAIN:
            # the background and u draws the JAX package takes from its keys
            self.generator = torch.Generator(self.device).manual_seed(
                self.seed)
        #: the networks' passes of a training step, by call site, as CUDA
        #: graphs (eager off CUDA; None: eager everywhere); ``_calls``
        #: counts a step's calls of each network
        self.passes = GraphedPasses(self.autocast)
        self._calls: dict[str, int] | None = None

    def _init_generators(self, init_mini_batch):
        """The generators, sized by ``z`` of a dry pass of a discriminator
        on a zero sample of the batch's shape (which keeps no ``u``),
        generator i drawing from ``seed + 7 + i`` (the JAX package's
        :988-1006), in the discriminators' dtype."""
        key = "real_A" if "real_A" in init_mini_batch else "image"
        shape = tuple(init_mini_batch[key].shape[1:])
        dis = next(n for n in self._order if n.startswith("dis"))
        w = next(self.networks[dis].parameters())
        with torch.no_grad():
            z = self.networks[dis](torch.zeros((1, *shape), device=w.device,
                                               dtype=w.dtype),
                                   update_stats=False)[4]
        for i, name in enumerate(self._gen_configs):
            net = build_network(self._gen_configs[name],
                                in_channels=z.shape[1])
            kaiming_normal_(net, torch.Generator().manual_seed(
                self.seed + 7 + i))
            self.networks[name] = net.to(self.device, w.dtype)
        self.networks = {n: self.networks[n] for n in self._order}

    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase=Phase.TRAIN):
        tr = config.get(Phase.TRAIN, {})
        if phase != Phase.TEST:
            self.ad_loss = self.registry_loss(
                tr["loss_ad"], config)
            self.cycle_loss = self.registry_loss(
                tr["loss_cycle"], config)
        self._init_generators(init_mini_batch)
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

    def _load_inference_checkpoint(self, config, args):
        """The inference generator, then its paired discriminator, whose
        trunk is its encoder, from ``{tag}_{dis}_model.ckpt`` of the run
        directory where that exists (the JAX package's :1011-1024)."""
        super()._load_inference_checkpoint(config, args)
        dis = "disA" if self.inference_mode == "gen2B" else "disB"
        ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
        tag = getattr(args, "epoch", "latest") or "latest"
        path = os.path.join(ckdir, f"{tag}_{dis}_model.ckpt")
        if os.path.exists(path):
            self.load_network_state(dis, {"params": ck.load_checkpoint(path)[
                "model"]})
            print(f"Loaded network weights {dis} from {path}.")

    # ------------------------------------------------------------------
    def _site(self, name: str):
        """The call site of network ``name`` in the training step under
        way: the step's how-manieth call of ``name``; None outside a step
        and on a mesh of several ranks."""
        if self._calls is None or self.passes is None or self._spread():
            return None
        k = self._calls[name] = self._calls.get(name, -1) + 1
        return name, k

    def _dis(self, name: str, x: torch.Tensor):
        """``(out0, out1, cam_logit, z)`` of discriminator ``name``, which
        keeps this call's ``u``; in a training step, its power iterations,
        then its body from its call site's CUDA graphs
        (:mod:`octa_tpu_torch.train.graphed`)."""
        net = self.networks[name]
        key = self._site(name)
        if key is None:
            with self.autocast():
                out0, out1, cam, _, z = net(x)
        else:
            out0, out1, cam, _, z = self.passes(key, net, net.body, x,
                                                *net.iterate())
        return out0, out1, cam, z

    def _net(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Generator ``name``'s pass; in a training step, from its call
        site's CUDA graphs."""
        key = self._site(name)
        if key is None:
            return super()._net(name, x)
        net = self.networks[name]
        return self.passes(key, net, net, x)

    def d_step(self, real_A, real_B):
        """The discriminators' update (:1040-1072) on the real images and
        on the translations of their detached encodings, detached; returns
        ``D_A`` and ``D_B``, detached."""
        ad, aw = self.ad_loss, self.adv_weight
        for net in self.networks.values():
            net.train()
        opt = self.opt["D_optim"]
        opt.zero_grad(set_to_none=True)
        rLA, rGA, rcamA, real_A_z = self._dis("disA", real_A)
        rLB, rGB, rcamB, real_B_z = self._dis("disB", real_B)
        with torch.no_grad():
            fake_A2B = self._net("gen2B", real_A_z)
            fake_B2A = self._net("gen2A", real_B_z)
        fLA, fGA, fcamA, _ = self._dis("disA", fake_B2A)
        fLB, fGB, fcamB, _ = self._dis("disB", fake_A2B)

        def pair(real, fake):
            return (ad(real, torch.ones_like(real))
                    + ad(fake, torch.zeros_like(fake)))

        loss_A = aw * (pair(rGA, fGA) + pair(rcamA, fcamA) + pair(rLA, fLA))
        loss_B = aw * (pair(rGB, fGB) + pair(rcamB, fcamB) + pair(rLB, fLB))
        (loss_A + loss_B).backward()
        opt.step()
        return loss_A.detach(), loss_B.detach()

    def g_step(self, real_A, real_B, bg):
        """The generators' update (:1074-1118) through the discriminators
        at their new parameters, which take no gradient; ``bg`` is the
        background composite's ``background * u``. Returns the detached
        ``fake_A2B``, ``fake_B2A``, ``fake_A2B2A`` and ``fake_B2B`` and the
        losses ``G``, ``G_A``, ``G_B``, ``cycle_A``, ``cycle_B``, ``idt_A``,
        ``idt_B``, detached."""
        ad, cyc = self.ad_loss, self.cycle_loss
        aw, cw, rw = self.adv_weight, self.cycle_weight, self.recon_weight
        opt = self.opt["G_optim"]
        opt.zero_grad(set_to_none=True)
        ones = lambda t: ad(t, torch.ones_like(t))
        with self._frozen(self.optimizer_mapping["D_optim"]):
            real_A_z = self._dis("disA", torch.maximum(real_A, bg))[3]
            real_B_z = self._dis("disB", real_B)[3]
            fake_A2B = self._net("gen2B", real_A_z)
            fake_B2A = self._net("gen2A", real_B_z)
            fLA, fGA, fcamA, fake_A_z = self._dis(
                "disA", torch.maximum(fake_B2A, bg))
            fLB, fGB, fcamB, fake_B_z = self._dis("disB", fake_A2B)
            fake_B2A2B = self._net("gen2B", fake_A_z)
            fake_A2B2A = self._net("gen2A", fake_B_z)
            ad_A = ones(fGA) + ones(fcamA) + ones(fLA)
            ad_B = ones(fGB) + ones(fcamB) + ones(fLB)
            cycle_A = cyc(fake_A2B2A, real_A)
            cycle_B = cyc(fake_B2A2B, real_B)
            fake_A2A = self._net("gen2A", real_A_z)
            fake_B2B = self._net("gen2B", real_B_z)
            recon_A = cyc(fake_A2A, real_A)
            recon_B = cyc(fake_B2B, real_B)
            loss_A = aw * ad_A + cw * cycle_A + rw * recon_A
            loss_B = aw * ad_B + cw * cycle_B + rw * recon_B
            loss = loss_A + loss_B
            loss.backward()
        opt.step()
        losses = dict(G=loss, G_A=loss_A, G_B=loss_B, cycle_A=cycle_A,
                      cycle_B=cycle_B, idt_A=recon_A, idt_B=recon_B)
        return (_detached(fake_A2B, fake_B2A, fake_A2B2A, fake_B2B),
                {k: v.detach() for k, v in losses.items()})

    def train_step(self, real_A, real_B, background, u):
        """The D step, then the G step (the JAX package's jitted ``step``,
        :1036-1137, with the background and ``u`` given). Returns
        ``((fake_A2B, fake_B2A, fake_A2B2A, fake_B2B), losses)``: the images
        detached, the nine losses as 0-d tensors. Each half is a span noted
        with its spectral norms' power iterations (eight discriminator calls
        a step, each one iteration a spectral-norm layer). On a CUDA device
        the sixteen network passes replay their call sites' CUDA graphs
        (:meth:`_net`, :meth:`_dis`; the power iterations stay eager); the
        images are then the sites' buffers, which the next step
        overwrites."""
        self._calls = {}
        try:
            with _iterations_noted("octa.train.D"):
                d_A, d_B = self.d_step(real_A, real_B)
            with _iterations_noted("octa.train.G"):
                images, losses = self.g_step(real_A, real_B, background * u)
        finally:
            self._calls = None
        losses.update(D_A=d_A, D_B=d_B)
        return images, losses

    def _training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        if "background" in mini_batch:
            background = self._batch_in(mini_batch["background"])
        else:
            background = self._global_rand(mini_batch)
        u = self._global_rand(mini_batch)
        (fake_A2B, fake_B2A, fake_A2B2A, fake_B2B), losses = self.train_step(
            real_A, real_B, background, u)
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      fake_A2B2A),
            "label": _post_first(post_transformations.get("label"), real_A),
            # on the device until a sample is plotted
            "fake_B": fake_A2B[0:1, 0:1],
            "idt_B": fake_B2B[0:1, 0:1],
            "real_B_seg": fake_B2A[0:1, 0:1],
        }
        return outputs, losses

    def inference(self, mini_batch, post_transformations, phase=Phase.TEST):
        """``gen2B`` on ``disA``'s encoding of the image where ``gen2B`` is
        built, else ``gen2A`` on ``disB``'s; the encoder's power iterations
        keep no ``u``. In validation, the cycle loss against the label as
        ``loss_cycle``."""
        x = self._batch_in(mini_batch["image"])
        gen, dis = (("gen2B", "disA") if "gen2B" in self.networks
                    else ("gen2A", "disB"))
        self.eval()
        with torch.no_grad(), self.autocast():
            z = self.networks[dis](x, update_stats=False)[4]
            pred = self.networks[gen](z)
        outputs = {"prediction": _post_first(
            post_transformations.get("prediction"), pred)}
        losses: dict[str, Any] = {}
        if phase == Phase.VALIDATION and "label" in mini_batch:
            y = self._batch_in(mini_batch["label"])
            outputs["label"] = _post_first(post_transformations.get("label"),
                                           mini_batch["label"])
            losses["loss_cycle"] = self.cycle_loss(pred, y)
        return outputs, losses


@contextlib.contextmanager
def _iterations_noted(name: str):
    """The span ``name``, noted with the power iterations of the spectral
    norms inside it."""
    with trace.span(name) as span:
        first = SpectralNormConv.power_iterations
        yield
        span.note(power_iterations=SpectralNormConv.power_iterations - first)


def _detached(*xs):
    return tuple(None if x is None else x.detach() for x in xs)
