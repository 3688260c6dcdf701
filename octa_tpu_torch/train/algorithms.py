"""Training algorithms: the segmentation and GAN-seg trainers.

Counterpart of ``octa_tpu/train/algorithms.py``: ``BaseAlgorithm``
(:45-170) with its mesh (:87-113), ``_post_first`` (:172),
``SegAlgorithm`` (:179-368), ``GanSegAlgorithm`` (:371-651) and
``define_model`` (:654-665), which hands the other GAN algorithms of
``ALGORITHM_NAMES`` to :mod:`octa_tpu_torch.train.gan_algorithms`
(CycleGAN, CUT, NEGCUT, DCLGAN and NICE-GAN).

A step is the JAX package's jitted ``train_step`` in eager PyTorch: forward,
loss, backward and one Adam update of float32 parameters. With
``General.amp`` the forward runs under ``torch.autocast(..., bfloat16)``,
the counterpart of the bf16 compute of the JAX package's ``CanonConv``
(``octa_tpu/models/dynunet.py:122-170``): convolutions in bfloat16,
instance-norm statistics and the loss in float32. A fresh DynUNet draws
its weights from ``General.seed`` on the CPU with the JAX package's
initialisation (the GAN-seg networks from ``seed + i`` in their build
order), so that the card and the CPU start from the same weights.
DynUNet is trained with ``remat`` on unless the model config says
``remat: false`` (``algorithms.py:196-201``).

Per step a trainer reads its losses back in one (the segmentation trainer
its one loss) and moves the first sample's post-processed prediction and
label to the host (``_post_first``), the JAX package's semantics.

While a profiler session records, a step is the span ``octa.train.step``
(:mod:`octa_tpu_torch.utils.trace`), with ``octa.train.read_losses`` around
the losses' read-back; the segmentation trainer's update holds
``octa.train.forward`` (forward and loss), ``octa.train.backward`` and
``octa.train.optimizer``, GAN-seg's ``octa.train.D``, ``octa.train.adam_D``,
``octa.train.GS``, ``octa.train.adam_G`` and ``octa.train.adam_S``.

Data parallelism (``_setup_mesh``, the JAX package's :87-113): on a mesh
of more than one rank (``define_model(mesh=)``, which the engine resolves
under ``python -m torch.distributed.run``), the optimizers' networks are
broadcast from the first rank, every rank loads
the same global batch and steps on its rows (``_batch_in``; a batch that
does not divide the mesh runs whole on every rank), every optimizer takes
the mean of its gradients over the mesh before its step
(``parallel.mesh.mean_gradients``), and the losses read back are their mean
over the mesh: the global batch's, which XLA's SPMD step computes. A loss
that is a ratio of sums over the whole batch (soft clDice, the weighted
losses, QWK) takes those sums over the global batch in one all-reduce a
call (``utils.losses.TrainerLoss`` hands it the step's rows). Draws
made for the batch (backgrounds, ``u``, noise, ANT's geometry and control
points) come from generators seeded alike on every rank, drawn for the
global batch, and each rank keeps its rows.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io import checkpoints as ck
from octa_tpu_torch.models.layers import at_least_float32, kaiming_normal_
from octa_tpu_torch.models.registry import (
    ALGORITHM_NAMES,
    build_network,
    network_constructor,
)
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.train.state import (
    linear_decay_factor,
    make_optimizer,
    set_learning_rate,
)
from octa_tpu_torch.utils import losses as losses_lib
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.enums import Phase


class BaseAlgorithm:
    """A training procedure over named networks and optimizers."""

    #: {optimizer_name: [net_names]}, as the reference's optimizer_mapping
    optimizer_mapping: dict[str, list[str]] = {}
    optimizer_configs: dict[str, dict] = {}

    def __init__(self, config: dict, phase: Phase, device="cuda"):
        self.config = config
        self.phase = phase
        self.device = resolve_device(device)
        self.networks: dict[str, torch.nn.Module] = {}
        self.opt: dict[str, torch.optim.Adam] = {}
        self.base_lr: dict[str, float] = {}
        self.seed = config["General"].get("seed", 42)
        self.amp = bool(config["General"].get("amp"))
        #: the data-parallel mesh (None alone; ``define_model(mesh=)``); a
        #: rank outside it takes no steps
        self.mesh: mesh_lib.Mesh | None = None
        #: this rank's rows of the batch of the step under way (None: all)
        self._shard: mesh_lib.Shard | None = None

    def autocast(self, **kw):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.amp, **kw)

    def _init_optimizers(self, config):
        train_cfg = config[Phase.TRAIN]
        for opt_name, net_names in self.optimizer_mapping.items():
            cfg = dict(lr=train_cfg["lr"], betas=(0.5, 0.999),
                       weight_decay=train_cfg.get("weight_decay", 0) or 0)
            cfg.update(self.optimizer_configs.get(opt_name, {}))
            params = [p for n in net_names
                      for p in self.networks[n].parameters()]
            self.opt[opt_name] = make_optimizer(
                params, cfg["lr"], cfg["betas"], cfg["weight_decay"])
            self.base_lr[opt_name] = cfg["lr"]
        self._setup_mesh()

    # -- data parallelism over several cards --------------------------------
    def _spread(self) -> bool:
        """Whether this rank shares its steps with others."""
        return self.mesh is not None and self.mesh.member and self.mesh.size > 1

    def _setup_mesh(self):
        """On a mesh of more than one rank: the networks and optimizer
        states broadcast from the first rank, and every optimizer step
        preceded by the mean of its gradients over the mesh."""
        if not self._spread():
            return
        mesh = self.mesh
        mesh_lib.replicated(mesh, self.networks.values(), self.opt.values())
        for opt in self.opt.values():
            mesh_lib.mean_gradients(opt, mesh)

    def registry_loss(self, name: str, config: dict, *args, **kwargs):
        """The registry's loss ``name``
        (:func:`~octa_tpu_torch.utils.losses.get_loss_function_by_name`) as
        this trainer's steps call it: on NCHW tensors and, where it is a
        ratio of sums over the batch, over the step's global batch
        (:class:`~octa_tpu_torch.utils.losses.TrainerLoss`)."""
        return losses_lib.TrainerLoss.wrap(
            losses_lib.get_loss_function_by_name(name, config, *args,
                                                 **kwargs),
            lambda: self._shard)

    def _local(self, x):
        """This rank's rows of a global tensor of the step under way."""
        return x if self._shard is None else self._shard.take(x)

    def _batch_in(self, x) -> torch.Tensor:
        """A collated NCHW batch as float32 on the device: during a training
        step on a mesh, this rank's rows of it."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return self._local(x).to(self.device, torch.float32)

    def perform_training_step(self, mini_batch, post_transformations):
        """One training step on the collated global batch: on a mesh, on
        this rank's rows of it. Returns the step's outputs and its losses as
        floats, read back in one (on a mesh, their mean over it)."""
        with trace.span("octa.train.step"):
            key = "real_A" if "real_A" in mini_batch else "image"
            self._shard = mesh_lib.shard_of(self.mesh, len(mini_batch[key]))
            try:
                outputs, losses = self._training_step(mini_batch,
                                                      post_transformations)
            finally:
                self._shard = None
            values = torch.stack([v.detach() for v in losses.values()])
            if self._spread():
                mesh_lib.mean_([values], self.mesh, "losses")
            with trace.span("octa.train.read_losses"):
                read = values.tolist()  # one sync
            return outputs, dict(zip(losses, read))

    def _training_step(self, mini_batch, post_transformations):
        """The algorithm's step: ``(outputs, {name: 0-d loss tensor})``."""
        raise NotImplementedError

    def scheduler_step(self, epoch: int):
        """Linear decay over the last ``epochs_decay`` epochs (per epoch)."""
        train_cfg = self.config[Phase.TRAIN]
        factor = linear_decay_factor(
            epoch + 1, train_cfg["epochs"], train_cfg.get("epochs_decay", 0))
        for opt_name, opt in self.opt.items():
            set_learning_rate(opt, self.base_lr[opt_name] * factor)

    # -- checkpoints ------------------------------------------------------
    def _load_resume_checkpoints(self, config, args):
        """Each network's ``{tag}_{net}_model.ckpt`` and each optimizer's
        ``{tag}_{opt}.ckpt`` from the run directory, as the engine writes
        them (``--start_epoch``, ``--epoch``)."""
        ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
        tag = getattr(args, "epoch", "latest")
        epoch = None

        def read(path):
            # on a mesh, the first rank reads and every member gets it
            return mesh_lib.read_on_first(
                self.mesh, lambda: ck.load_checkpoint(path)
                if os.path.exists(path) else None)

        for opt_name, net_names in self.optimizer_mapping.items():
            for net_name in net_names:
                path = os.path.join(ckdir, f"{tag}_{net_name}_model.ckpt")
                net_ck = read(path)
                if net_ck is None:
                    raise FileNotFoundError(path)
                self.load_network_state(net_name, {"params": net_ck["model"]})
                epoch = net_ck.get("epoch")
            opt_ck = read(os.path.join(ckdir, f"{tag}_{opt_name}.ckpt"))
            if opt_ck is not None:
                self.load_optimizer_state(opt_name, opt_ck["optimizer"])
        print(f"Loaded all network weights from epoch {epoch}.")

    def network_state(self, name: str) -> dict:
        return {"params": ck.state_dict_to_flax(self.networks[name])}

    def load_network_state(self, name: str, state: dict):
        ck.restore_like(self.networks[name], state["params"])

    def _optimized(self, opt_name: str) -> dict[str, torch.nn.Module]:
        return {n: self.networks[n] for n in self.optimizer_mapping[opt_name]}

    def optimizer_state(self, opt_name: str) -> dict:
        return ck.adam_state_to_flax(self.opt[opt_name],
                                     self._optimized(opt_name))

    def load_optimizer_state(self, opt_name: str, state: dict):
        ck.load_adam_state(self.opt[opt_name], self._optimized(opt_name), state)

    # -- reference interface ----------------------------------------------
    def train(self):
        for net in self.networks.values():
            net.train()

    def eval(self):
        for net in self.networks.values():
            net.eval()

    def compute_metric(self, outputs, metrics) -> None:
        metrics(outputs["prediction"], outputs["label"])

    def plot_sample(self, visualizer, mini_batch, outputs, *, suffix=""):
        key = "image" if "image" in mini_batch else "real_A"
        return visualizer.plot_sample(
            _host(mini_batch[key][0]),
            _host(outputs["prediction"][0]),
            _host(outputs["label"][0]) if "label" in outputs else None,
            suffix=suffix,
        )

    def num_parameters(self) -> dict[str, int]:
        return {n: sum(p.numel() for p in net.parameters())
                for n, net in self.networks.items()}


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)


def _post_first(post, arr_nchw) -> list:
    """A post-processing Compose applied to the first batch element
    (reference ``decollate_batch(pred[0:1])``)."""
    first = arr_nchw[0].detach()
    return [post(first)] if post is not None else [_host(first)]


class SegAlgorithm(BaseAlgorithm):
    """Single-network segmentation training: the reference's
    ``LambdaModel`` (``models/lambda_model.py``), with adversarial noise
    training where ``Train.AT`` is set (``ANTLoss`` hardens each batch
    against the network at its current weights before the step). The
    classical baselines (``frangi``, ``oof``, ``skrgan``) are parameterless
    models: no optimizer, no checkpoint, ``inference`` runs them on the
    batch."""

    optimizer_mapping = {"optimizer": ["model"]}

    def __init__(self, model_name: str, config: dict, phase: Phase,
                 device="cuda", **net_kwargs):
        super().__init__(config, phase, device)
        self.model_name = model_name
        for k in ("phase", "MODEL_DICT", "inference"):
            net_kwargs.pop(k, None)
        ctor = network_constructor(model_name)
        if phase == Phase.TRAIN and model_name == "DynUNet":
            net_kwargs.setdefault("remat", True)
        self.net = ctor(**net_kwargs)
        self.parameterless = not isinstance(self.net, torch.nn.Module)
        if self.parameterless:
            return
        if model_name == "DynUNet":
            kaiming_normal_(self.net, torch.Generator().manual_seed(self.seed))
        self.net.to(self.device)
        self.networks["model"] = self.net

    # ------------------------------------------------------------------
    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase: Phase = Phase.TRAIN):
        self.loss_name = config.get(Phase.TRAIN, {}).get("loss", "")
        self.loss_function = self.registry_loss(self.loss_name, config)
        self.at = None
        if phase == Phase.TRAIN and config[Phase.TRAIN].get("AT", False):
            self.at = self.registry_loss(
                "AtLoss", config, None, self.loss_function,
                generator=torch.Generator(self.device).manual_seed(self.seed))
        if self.parameterless:
            print(f"Skipping initialization for {self.model_name}")
            return
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

    def _load_inference_checkpoint(self, config, args):
        model_path = config.get(Phase.TEST, {}).get("model_path")
        if not model_path:
            ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
            tag = getattr(args, "epoch", "latest") or "latest"
            model_path = os.path.join(ckdir, f"{tag}_model_model.ckpt")
        if str(model_path).endswith(".pth"):
            ck.import_dynunet_pth(str(model_path), self.net)
        else:
            model_ck = ck.load_checkpoint(str(model_path))
            self.load_network_state("model", {"params": model_ck["model"]})
            print(f"Loaded network weights from epoch {model_ck.get('epoch')}.")

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """float32 NCHW logits of the network for an NCHW batch (float64
        for a network cast to float64)."""
        with self.autocast():
            return at_least_float32(self.net(x))

    def train_step(self, x: torch.Tensor, y: torch.Tensor):
        """One Adam update on the batch; returns (prediction, loss) of the
        parameters before the update, on the device."""
        self.net.train()
        opt = self.opt["optimizer"]
        opt.zero_grad(set_to_none=True)
        with trace.span("octa.train.forward"):
            pred = self.forward(x)
            loss = self.loss_function(pred, y)
        with trace.span("octa.train.backward"):
            loss.backward()
        with trace.span("octa.train.optimizer"):
            opt.step()
        return pred.detach(), loss.detach()

    def adversarial_batch(self, x: torch.Tensor, background: torch.Tensor,
                          y: torch.Tensor):
        """``ANTLoss`` on channel 0 of the NCHW batch against the network at
        its current weights (under the step's autocast and remat); returns
        the hardened sample and its label as NCHW batches. On a mesh the
        batch is this rank's rows of the step's global batch, and ANT draws
        for the global batch."""
        self.net.train()
        adv, y_crop = self.at(self.forward, x[:, 0], background[:, 0], y[:, 0],
                              shard=self._shard)
        return adv[:, None], y_crop[:, None]

    def _training_step(self, mini_batch, post_transformations):
        x = self._batch_in(mini_batch["image"])
        y = self._batch_in(mini_batch["label"])
        if self.at is not None:
            x, y = self.adversarial_batch(
                x, self._batch_in(mini_batch["background"]), y)
            mini_batch["image"] = x
        pred, loss = self.train_step(x, y)
        outputs = {
            "prediction": _post_first(
                post_transformations.get("prediction"), pred),
            "label": _post_first(post_transformations.get("label"), y),
        }
        return outputs, {self.loss_name: loss}

    def inference(self, mini_batch, post_transformations,
                  phase: Phase = Phase.TEST):
        x = self._batch_in(mini_batch["image"])
        with torch.no_grad():
            if self.parameterless:
                # the baseline on the batch, a zero loss in validation (the
                # JAX package's ``inference``, :338-345)
                pred = self.net(x)
                losses: Any = ({} if phase == Phase.TEST
                               else {self.loss_name or "loss": 0.0})
            else:
                self.net.eval()
                pred = self.forward(x)
                if phase != Phase.TEST:
                    y = self._batch_in(mini_batch["label"])
                    losses = {self.loss_name: self.loss_function(pred, y)}
                else:
                    losses = None
        outputs = {"prediction": _post_first(
            post_transformations.get("prediction"), pred)}
        if phase != Phase.TEST:
            outputs["label"] = _post_first(
                post_transformations.get("label"), mini_batch["label"])
        return outputs, losses


class GanSegAlgorithm(BaseAlgorithm):
    """Joint GAN and segmentation training, the paper's S-GAN (reference
    ``models/gan_seg_model.py``): a generator translates the 304² synthetic
    image into a realistic one, a 70x70 PatchGAN judges it, and a DynUNet
    segments its bilinear upsampling to ``upshape``.

    A step is the JAX package's jitted ``train_step`` (:477-590) in eager
    PyTorch: the discriminator's update on the detached ``fake_B`` first,
    then one backward pass of ``loss_G + loss_G_idt + 0.5 (loss_S +
    loss_S_idt)`` into the generator and the segmentor, through the
    discriminator at its updated parameters, which take no gradient from
    it. The generator's forward pass is taken once for both halves: the
    JAX step takes it again in the joint half at the same parameters,
    which gives the same value.
    """

    optimizer_mapping = {
        "optimizer_G": ["generator"],
        "optimizer_D": ["discriminator"],
        "optimizer_S": ["segmentor"],
    }
    optimizer_configs = {"optimizer_S": {"betas": (0.9, 0.999)}}

    def __init__(self, config: dict, phase: Phase, model_g: dict,
                 model_d: dict, model_s: dict, compute_identity=True,
                 compute_identity_seg=True, inference=None,
                 upshape=(1216, 1216), device="cuda", **kwargs):
        super().__init__(config, phase, device)
        self.inference_mode = inference or config["General"].get("inference")
        self.compute_identity = compute_identity
        self.compute_identity_seg = compute_identity_seg
        self.upshape = tuple(upshape)
        if phase == Phase.VALIDATION and self.inference_mode != "S":
            raise ValueError(
                f"a GanSegModel with General.inference "
                f"{self.inference_mode!r} builds no segmentor and cannot be "
                "validated: the Validation metrics compare segmentations with "
                "labels (set General.inference: S to validate its segmentor)")
        # built where the phase and the inference mode need them, in the
        # JAX package's order (:398-411); network i draws from seed + i
        if phase == Phase.TRAIN or self.inference_mode == "S":
            s_cfg = dict(model_s)
            if phase == Phase.TRAIN and s_cfg.get("name") == "DynUNet":
                s_cfg.setdefault("remat", True)
            self.networks["segmentor"] = build_network(s_cfg)
        if phase == Phase.TRAIN or self.inference_mode == "G":
            self.networks["generator"] = build_network(dict(model_g))
        if phase == Phase.TRAIN:
            self.networks["discriminator"] = build_network(dict(model_d))
        for i, net in enumerate(self.networks.values()):
            kaiming_normal_(net, torch.Generator().manual_seed(self.seed + i))
            net.to(self.device)
        self.l1 = losses_lib.L1Loss()

    # ------------------------------------------------------------------
    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase: Phase = Phase.TRAIN):
        if phase != Phase.TEST:
            self.loss_name_dg = config[Phase.TRAIN]["loss_dg"]
            self.loss_name_s = config[Phase.TRAIN]["loss_s"]
            self.dg_loss = self.registry_loss(self.loss_name_dg, config)
            self.s_loss = self.registry_loss(self.loss_name_s, config)
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

    def _load_inference_checkpoint(self, config, args):
        mode = self.inference_mode
        net_name = {"S": "segmentor", "G": "generator"}.get(mode, mode)
        model_path = (config.get(Phase.TEST, {}) or {}).get("model_path")
        if not model_path:
            ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
            tag = getattr(args, "epoch", "latest") or "latest"
            model_path = os.path.join(ckdir, f"{tag}_{net_name}_model.ckpt")
        net_ck = ck.load_checkpoint(str(model_path))
        self.load_network_state(net_name, {"params": net_ck["model"]})
        print(f"Loaded network weights {net_name} from epoch "
              f"{net_ck.get('epoch')}.")

    # ------------------------------------------------------------------
    def generate(self, x: torch.Tensor) -> torch.Tensor:
        """The generator's translation of an NCHW batch (float32)."""
        with self.autocast():
            return self.networks["generator"](x)

    def discriminate(self, x: torch.Tensor) -> torch.Tensor:
        with self.autocast():
            return self.networks["discriminator"](x)

    def segment(self, img: torch.Tensor) -> torch.Tensor:
        """Bilinear upsampling to ``upshape`` (``jax.image.resize(...,
        "linear")``, :489-492), then the segmentor's logits (float32)."""
        if tuple(img.shape[-2:]) != self.upshape:
            img = F.interpolate(img, size=self.upshape, mode="bilinear",
                                align_corners=False)
        with self.autocast():
            return at_least_float32(self.networks["segmentor"](img))

    def train_step(self, real_A, real_B, real_A_seg, on_stage=None):
        """One D update and one joint G+S update on the batch. Returns
        ``(outs, losses)``: the detached ``fake_B``, ``idt_B``,
        ``fake_B_seg`` and ``real_B_seg``, and the six losses as 0-d
        tensors on the device. ``on_stage(name)``, where given, is called
        after each of the five stages ("D", "adam_D", "GS", "adam_G",
        "adam_S"), for a caller that times them."""
        mark = on_stage or (lambda name: None)
        gen, disc = self.networks["generator"], self.networks["discriminator"]
        for net in self.networks.values():
            net.train()
        need_idt = self.compute_identity or self.compute_identity_seg
        opt_d = self.opt["optimizer_D"]
        with trace.span("octa.train.D"):
            fake_B = self.generate(real_A)
            idt_B = self.generate(real_B) if need_idt else None

            # the discriminator's update, on the detached translation
            opt_d.zero_grad(set_to_none=True)
            loss_D_fake = self.dg_loss(self.discriminate(fake_B.detach()),
                                       False)
            loss_D_real = self.dg_loss(self.discriminate(real_B), True)
            (0.5 * (loss_D_fake + loss_D_real)).backward()
        mark("D")
        with trace.span("octa.train.adam_D"):
            opt_d.step()
        mark("adam_D")

        # the joint update of generator and segmentor, through the
        # discriminator at its new parameters, which take no gradient
        with trace.span("octa.train.GS"):
            self.opt["optimizer_G"].zero_grad(set_to_none=True)
            self.opt["optimizer_S"].zero_grad(set_to_none=True)
            disc.requires_grad_(False)
            try:
                with torch.no_grad():
                    real_B_seg = (self.segment(real_B) > 0.5).to(real_B.dtype)
                fake_B_seg = self.segment(fake_B)
                loss_G = self.dg_loss(self.discriminate(fake_B), True)
                zero = torch.zeros((), device=loss_G.device,
                                   dtype=loss_G.dtype)
                loss_G_idt = (self.l1(idt_B, real_B) if self.compute_identity
                              else zero)
                loss_G = loss_G + loss_G_idt
                loss_S = self.s_loss(fake_B_seg, real_A_seg)
                if self.compute_identity_seg:
                    loss_S_idt = self.s_loss(self.segment(idt_B), real_B_seg)
                    loss_SS = 0.5 * (loss_S + loss_S_idt)
                else:
                    loss_S_idt, loss_SS = zero, loss_S
                (loss_G + loss_SS).backward()
            finally:
                disc.requires_grad_(True)
        mark("GS")
        with trace.span("octa.train.adam_G"):
            self.opt["optimizer_G"].step()
        mark("adam_G")
        with trace.span("octa.train.adam_S"):
            self.opt["optimizer_S"].step()
        mark("adam_S")
        outs = {"fake_B": fake_B.detach(),
                "idt_B": (idt_B if need_idt else fake_B).detach(),
                "fake_B_seg": fake_B_seg.detach(), "real_B_seg": real_B_seg}
        # in the JAX step's order (its jitted dict comes back key-sorted)
        losses = {"D_fake": loss_D_fake, "D_real": loss_D_real, "G": loss_G,
                  "G_idt": loss_G_idt, "S": loss_S, "S_idt": loss_S_idt}
        return outs, {k: v.detach() for k, v in losses.items()}

    def _training_step(self, mini_batch, post_transformations):
        real_A = self._batch_in(mini_batch["real_A"])
        real_B = self._batch_in(mini_batch["real_B"])
        real_A_seg = self._batch_in(mini_batch["real_A_seg"])
        outs, losses = self.train_step(real_A, real_B, real_A_seg)
        outputs = {
            "prediction": _post_first(post_transformations.get("prediction"),
                                      outs["fake_B_seg"]),
            "label": _post_first(post_transformations.get("label"),
                                 real_A_seg),
            # on the device until a sample is plotted
            "fake_B": outs["fake_B"][0:1, 0:1],
            "idt_B": outs["idt_B"][0:1, 0:1],
            "real_B_seg": outs["real_B_seg"],
        }
        return outputs, losses

    def inference(self, mini_batch, post_transformations,
                  phase: Phase = Phase.TEST):
        """The segmentor's logits where it is built (training, or
        ``General.inference: S``), else the generator's translation."""
        has_seg = "segmentor" in self.networks
        x = self._batch_in(mini_batch["image"])
        self.eval()
        losses: dict[str, Any] = {}
        with torch.no_grad():
            if has_seg:
                pred = self.segment(x)
                if phase == Phase.VALIDATION and "label" in mini_batch:
                    y = self._batch_in(mini_batch["label"])
                    losses[self.loss_name_s] = self.s_loss(pred, y)
            else:
                pred = self.generate(x)
        outputs = {"prediction": _post_first(
            post_transformations.get("prediction"), pred)}
        if has_seg and phase == Phase.VALIDATION and "label" in mini_batch:
            outputs["label"] = _post_first(post_transformations.get("label"),
                                           mini_batch["label"])
        return outputs, losses

    def plot_sample(self, visualizer, mini_batch, outputs, *, suffix=""):
        if "fake_B" not in outputs:
            return super().plot_sample(visualizer, mini_batch, outputs,
                                       suffix=suffix)
        return visualizer.plot_gan_seg_sample(
            _host(mini_batch["real_A"][0]), _host(outputs["fake_B"][0]),
            _host(outputs["prediction"][0]), _host(mini_batch["real_B"][0]),
            _host(outputs["idt_B"][0]), _host(outputs["real_B_seg"][0]),
            path_a=mini_batch.get("real_A_path", [""])[0],
            path_b=mini_batch.get("real_B_path", [""])[0], suffix=suffix)


def define_model(config: dict, phase: Phase, device="cuda", mesh=None):
    """Dispatch ``General.model.name`` (reference ``models/model.py:7-18``).
    ``mesh`` (:func:`octa_tpu_torch.parallel.mesh.get_mesh`) makes the
    algorithm train data-parallel over it."""
    model_params = dict(config["General"]["model"])
    name = model_params.pop("name")
    if name == "GanSegModel":
        model = GanSegAlgorithm(config=config, phase=phase, device=device,
                                **model_params)
    elif name in ALGORITHM_NAMES:
        from octa_tpu_torch.train import gan_algorithms

        model = gan_algorithms.build(name, config, phase, device=device,
                                     **model_params)
    else:
        model = SegAlgorithm(model_name=name, config=config, phase=phase,
                             device=device, **model_params)
    model.mesh = mesh
    return model
