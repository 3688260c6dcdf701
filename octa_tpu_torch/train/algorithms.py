"""Training algorithms: the segmentation trainer on one card.

Counterpart of ``octa_tpu/train/algorithms.py``: ``BaseAlgorithm``
(:45-170) without the mesh (:87-113), ``_post_first`` (:172),
``SegAlgorithm`` (:179-368) and ``define_model`` (:654) for ``ves-seg``.
The GAN algorithms (``gan-ves-seg`` and the ``ALGORITHM_NAMES``) raise
``NotImplementedError`` until the GAN slice.

A step is the JAX package's jitted ``train_step`` in eager PyTorch: forward,
loss, backward and one Adam update of float32 parameters. With
``General.amp`` the forward runs under ``torch.autocast(..., bfloat16)``,
the counterpart of the bf16 compute of the JAX package's ``CanonConv``
(``octa_tpu/models/dynunet.py:122-170``): convolutions in bfloat16,
instance-norm statistics and the loss in float32. A fresh network draws
DynUNet draws its weights from ``General.seed`` on the CPU with the JAX
package's initialisation, so that the card and the CPU start from the same
weights (the generator keeps PyTorch's default initialisation here).
DynUNet is trained with ``remat`` on unless the model config says
``remat: false`` (``algorithms.py:196-201``).

Per step the trainer reads the loss back (``float(loss)``) and moves the
first sample's post-processed prediction and label to the host
(``_post_first``): three host syncs, the JAX package's semantics.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io import checkpoints as ck
from octa_tpu_torch.models.layers import at_least_float32, kaiming_normal_
from octa_tpu_torch.models.registry import ALGORITHM_NAMES, network_constructor
from octa_tpu_torch.train.state import (
    linear_decay_factor,
    make_optimizer,
    set_learning_rate,
)
from octa_tpu_torch.utils import losses as losses_lib
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

    def autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.amp)

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

    def _batch_in(self, x) -> torch.Tensor:
        """A collated NCHW batch as float32 on the device."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(self.device, torch.float32)

    def scheduler_step(self, epoch: int):
        """Linear decay over the last ``epochs_decay`` epochs (per epoch)."""
        train_cfg = self.config[Phase.TRAIN]
        factor = linear_decay_factor(
            epoch + 1, train_cfg["epochs"], train_cfg.get("epochs_decay", 0))
        for opt_name, opt in self.opt.items():
            set_learning_rate(opt, self.base_lr[opt_name] * factor)

    # -- checkpoints ------------------------------------------------------
    def network_state(self, name: str) -> dict:
        return {"params": ck.state_dict_to_flax(self.networks[name])}

    def load_network_state(self, name: str, state: dict):
        ck.restore_like(self.networks[name], state["params"])

    def optimizer_state(self, opt_name: str) -> dict:
        (net_name,) = self.optimizer_mapping[opt_name]
        return ck.adam_state_to_flax(self.opt[opt_name],
                                     self.networks[net_name], net_name)

    def load_optimizer_state(self, opt_name: str, state: dict):
        (net_name,) = self.optimizer_mapping[opt_name]
        ck.load_adam_state(self.opt[opt_name], self.networks[net_name], state,
                           net_name)

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
    ``LambdaModel`` (``models/lambda_model.py``), without adversarial noise
    training (``AT``), which comes with its own slice."""

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
        if model_name == "DynUNet":
            kaiming_normal_(self.net, torch.Generator().manual_seed(self.seed))
        self.net.to(self.device)
        self.networks["model"] = self.net

    # ------------------------------------------------------------------
    def initialize_model_and_optimizer(self, init_mini_batch, config, args,
                                       phase: Phase = Phase.TRAIN):
        self.loss_name = config.get(Phase.TRAIN, {}).get("loss", "")
        self.loss_function = losses_lib.get_loss_function_by_name(
            self.loss_name, config)
        if phase == Phase.TRAIN and config[Phase.TRAIN].get("AT", False):
            losses_lib.get_loss_function_by_name("AtLoss", config)  # raises
        if phase == Phase.TRAIN:
            self._init_optimizers(config)
            if getattr(args, "start_epoch", 0) > 0:
                self._load_resume_checkpoints(config, args)
        else:
            self._load_inference_checkpoint(config, args)

    def _load_resume_checkpoints(self, config, args):
        ckdir = os.path.join(config["Output"]["save_dir"], "checkpoints")
        tag = getattr(args, "epoch", "latest")
        model_ck = ck.load_checkpoint(
            os.path.join(ckdir, f"{tag}_model_model.ckpt"))
        self.load_network_state("model", {"params": model_ck["model"]})
        opt_path = os.path.join(ckdir, f"{tag}_optimizer.ckpt")
        if os.path.exists(opt_path):
            self.load_optimizer_state(
                "optimizer", ck.load_checkpoint(opt_path)["optimizer"])
        print(f"Loaded all network weights from epoch {model_ck.get('epoch')}.")

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
        pred = self.forward(x)
        loss = self.loss_function(pred, y)
        loss.backward()
        opt.step()
        return pred.detach(), loss.detach()

    def perform_training_step(self, mini_batch, post_transformations):
        x = self._batch_in(mini_batch["image"])
        y = self._batch_in(mini_batch["label"])
        pred, loss = self.train_step(x, y)
        outputs = {
            "prediction": _post_first(
                post_transformations.get("prediction"), pred),
            "label": _post_first(post_transformations.get("label"), y),
        }
        return outputs, {self.loss_name: float(loss)}

    def inference(self, mini_batch, post_transformations,
                  phase: Phase = Phase.TEST):
        x = self._batch_in(mini_batch["image"])
        self.net.eval()
        with torch.no_grad():
            pred = self.forward(x)
            if phase != Phase.TEST:
                y = self._batch_in(mini_batch["label"])
                losses: Any = {self.loss_name: self.loss_function(pred, y)}
            else:
                losses = None
        outputs = {"prediction": _post_first(
            post_transformations.get("prediction"), pred)}
        if phase != Phase.TEST:
            outputs["label"] = _post_first(
                post_transformations.get("label"), mini_batch["label"])
        return outputs, losses


def define_model(config: dict, phase: Phase, device="cuda"):
    """Dispatch ``General.model.name`` (reference ``models/model.py:7-18``)."""
    model_params = dict(config["General"]["model"])
    name = model_params.pop("name")
    if name in ALGORITHM_NAMES or config["General"].get("task") == "gan-ves-seg":
        raise NotImplementedError(
            f"model '{name}' ({config['General'].get('task')}) is a GAN "
            "algorithm: it comes with the GAN slice of octa_tpu_torch")
    return SegAlgorithm(model_name=name, config=config, phase=phase,
                        device=device, **model_params)
