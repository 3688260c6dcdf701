"""Training engine: the epoch loop of the reference's ``train.py``.

Counterpart of ``octa_tpu/train/engine.py:21-237``: ``apply_split_suffix``,
``_LiveProgress`` (with ``rich`` optional) and :func:`train`, with
validation every ``val_interval``, best / latest / every ``save_interval``
epochs checkpoints, ``epochs_per_run`` and the resume fork of the run
directory.

:func:`train` takes the device to train on (the card unless the caller
asks for ``"cpu"``) and an optional ``on_step(epoch, step, losses,
wait_s, step_s)`` called after every training step with the seconds spent
waiting for the batch and in the step (the step ends with the loss read
back, so the card has finished it). While a profiler session records,
the loop's wait for each batch is the span ``octa.train.wait`` and its
metrics on the step's outputs ``octa.train.metrics``
(:mod:`octa_tpu_torch.utils.trace`).

Where the process is one rank of several (``python -m
torch.distributed.run --nproc_per_node N -m octa_tpu_torch.train``), every
rank of the mesh loads the same batches and steps on its rows
(``algorithms.BaseAlgorithm._setup_mesh``); only the first rank writes the
run directory (config, checkpoints, plots, metrics), prints, and runs the
validation on whole batches while the others wait at the epoch's barrier.
A rank outside the mesh (JAX's divisor rule) takes no steps.
"""
from __future__ import annotations

import datetime
import importlib
import os
import sys
import time
from shutil import copyfile

from octa_tpu_torch.data.dataset import get_dataset, get_post_transformation
from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io.visualizer import Visualizer
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.train.algorithms import define_model
from octa_tpu_torch.utils.enums import Phase
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.metrics import MetricsManager, _is_zstack


def apply_split_suffix(config: dict, split: str):
    """Append the split id to split-file stems (reference ``train.py:31-37``)."""
    for phase in Phase:
        if phase not in config:
            continue
        for k in config[phase].get("data", {}):
            entry = config[phase]["data"][k]
            if not entry.get("split", ".txt").endswith(".txt"):
                assert split, "You have to specify a split!"
                entry["split"] = entry["split"] + split + ".txt"


class _LiveProgress:
    """Epoch and batch progress bars with the running loss (``rich``), on a
    TTY or with OCTA_TPU_RICH=1 and where ``rich`` is installed;
    OCTA_TPU_RICH=0 turns it off."""

    def __init__(self, n_epochs: int, start_epoch: int, show: bool = True):
        flag = os.environ.get("OCTA_TPU_RICH")
        self.on = show and (flag != "0") and (flag == "1"
                                              or sys.stdout.isatty())
        if self.on:
            try:
                live = importlib.import_module("rich.live")
                progress = importlib.import_module("rich.progress")
            except ImportError:
                self.on = False
        if not self.on:
            return
        self.progress = progress.Progress(
            *progress.Progress.get_default_columns(),
            progress.TimeElapsedColumn(), speed_estimate_period=300)
        self.live = live.Live(self.progress, refresh_per_second=4)
        self.live.start()
        self.epoch_task = self.progress.add_task(
            "Epochs", total=n_epochs - start_epoch)
        self.batch_task = None

    def epoch_start(self, n_batches):
        if not self.on:
            return
        if self.batch_task is not None:
            self.progress.remove_task(self.batch_task)
        self.batch_task = self.progress.add_task("Train Batch", total=n_batches)

    def batch(self, loss_name, value):
        if self.on and self.batch_task is not None:
            self.progress.update(self.batch_task, advance=1,
                                 description=f"train {loss_name}: {value:.4f}")

    def epoch_end(self):
        if self.on:
            self.progress.advance(self.epoch_task)

    def close(self):
        if self.on:
            self.live.stop()


def save_latest_checkpoints(visualizer, model, epoch: int,
                            config: dict) -> list[str]:
    """Write every optimizer's and every network's ``latest_`` checkpoint of
    ``model`` into the run directory; returns their paths."""
    paths = [visualizer.save_model(None, model.optimizer_state(opt_name),
                                   epoch, config, f"latest_{opt_name}")
             for opt_name in model.optimizer_mapping]
    return paths + [visualizer.save_model(model.network_state(net_name), None,
                                          epoch, config, f"latest_{net_name}")
                    for net_names in model.optimizer_mapping.values()
                    for net_name in net_names]


def _not_saving(config: dict) -> dict:
    """``config`` with nothing written to disk (the other ranks of a
    mesh)."""
    out = dict(config)
    out["Output"] = dict(config.get("Output", {}), save_to_disk=False,
                         save_to_tensorboard=False)
    return out


def train(args, config: dict, device="cuda", on_step=None) -> str | None:
    """Train as ``config`` says; returns the run directory.

    ``on_step``, where given, is called after each training step with
    ``(epoch, step, losses, wait_s, step_s)``: the step's losses, the
    seconds the loop waited for the batch and the seconds the step took.
    The JAX engine has no such hook; it is here so that a caller can see
    every step's loss and time without reading the run directory
    (``chip_smoke.py``'s training phase and the engine's test read it).

    Under ``torch.distributed.run`` the process joins the process group
    and trains on the data-parallel mesh of the batch size
    (``parallel.mesh.get_mesh``): the device is the rank's card, the seed
    the first rank's, and a rank outside the mesh returns None at once."""
    device = resolve_device(device)
    mesh = mesh_lib.get_mesh(
        batch_size=config[Phase.TRAIN].get("batch_size") or 1, device=device)
    if mesh is not None:
        device = mesh.device
        config["General"]["seed"] = mesh_lib.broadcast_object(
            config["General"].get("seed", 42))
        if not mesh.member:
            print(f"rank outside the data-parallel mesh of {mesh.size}: "
                  "no steps to take", flush=True)
            return None
    lead = mesh is None or mesh.rank == 0
    apply_split_suffix(config, getattr(args, "split", ""))
    start_epoch = getattr(args, "start_epoch", 0)
    save_latest = getattr(args, "save_latest", True)

    max_epochs = config[Phase.TRAIN]["epochs"]
    val_interval = config[Phase.TRAIN].get("val_interval") or 1
    save_interval = config[Phase.TRAIN].get("save_interval") or 100
    visualizer = Visualizer(config if lead else _not_saving(config),
                            start_epoch > 0,
                            epoch=getattr(args, "epoch", "latest"))

    train_loader = get_dataset(config, Phase.TRAIN, device=device)
    post_train = get_post_transformation(config, Phase.TRAIN, device)
    val_loader = None
    if Phase.VALIDATION in config and lead:
        val_loader = get_dataset(config, Phase.VALIDATION, device=device)
        post_val = get_post_transformation(config, Phase.VALIDATION, device)
    elif lead:
        print("No validation config. Skipping validation steps.")

    init_mini_batch = next(iter(train_loader))
    input_key = [k for k in init_mini_batch if not k.endswith("_path")][0]
    init_mini_batch.setdefault("image", init_mini_batch[input_key])

    model = define_model(config, Phase.TRAIN, device, mesh=mesh)
    model.initialize_model_and_optimizer(init_mini_batch, config, args,
                                         phase=Phase.TRAIN)
    visualizer.save_model_architecture(model)

    metrics = MetricsManager(phase=Phase.TRAIN)
    if start_epoch > 0:
        best_metric, best_metric_epoch = visualizer.get_max_of_metric(
            "metric", metrics.get_comp_metric(Phase.VALIDATION))
    else:
        best_metric, best_metric_epoch = -1, -1

    total_start = time.time()
    train_sample_path = val_sample_path = None
    live = _LiveProgress(max_epochs, start_epoch, show=lead)
    for epoch in range(start_epoch, max_epochs):
        epoch_metrics: dict[str, dict[str, float]] = {"loss": {}}
        model.train()
        epoch_loss, step, save_best = 0.0, 0, False
        t_ep = time.time()
        live.epoch_start(len(train_loader))
        t_wait = time.perf_counter()
        for mini_batch in trace.iterate("octa.train.wait", train_loader):
            t_start = time.perf_counter()
            step += 1
            outputs, losses = model.perform_training_step(mini_batch, post_train)
            t_end = time.perf_counter()
            if on_step is not None:
                on_step(epoch, step, losses, t_start - t_wait, t_end - t_start)
            with trace.span("octa.train.metrics"):
                model.compute_metric(outputs, metrics)
            for loss_name, loss in losses.items():
                key = f"train_{loss_name}"
                epoch_metrics["loss"][key] = (
                    epoch_metrics["loss"].get(key, 0.0) + loss)
            main_loss = list(losses)[0]
            epoch_loss += losses[main_loss]
            live.batch(main_loss, float(losses[main_loss]))
            t_wait = time.perf_counter()
        model.scheduler_step(epoch)
        epoch_metrics["loss"] = {
            k: v / step for k, v in epoch_metrics["loss"].items()}
        epoch_metrics["metric"] = metrics.aggregate_and_reset(
            prefix=str(Phase.TRAIN))
        epoch_loss /= step

        if save_latest or (epoch + 1) % save_interval == 0:
            train_sample_path = model.plot_sample(
                visualizer, mini_batch, outputs, suffix="train_latest")

        # VALIDATION
        if val_loader is not None and (epoch + 1) % val_interval == 0:
            model.eval()
            val_metrics = MetricsManager(phase=Phase.VALIDATION,
                                         volumetric=_is_zstack(config),
                                         device=device)
            vstep = 0
            for val_mini_batch in val_loader:
                vstep += 1
                outputs, losses = model.inference(
                    val_mini_batch, post_val, phase=Phase.VALIDATION)
                model.compute_metric(outputs, val_metrics)
                for loss_name, loss in losses.items():
                    key = f"val_{loss_name}"
                    epoch_metrics["loss"][key] = (
                        epoch_metrics["loss"].get(key, 0.0) + float(loss))
            epoch_metrics["loss"] = {
                k: (v / vstep if k.startswith("val_") else v)
                for k, v in epoch_metrics["loss"].items()}
            epoch_metrics["metric"].update(
                val_metrics.aggregate_and_reset(prefix=str(Phase.VALIDATION)))
            metric_comp = epoch_metrics["metric"][
                val_metrics.get_comp_metric(Phase.VALIDATION)]
            if metric_comp > best_metric:
                best_metric, best_metric_epoch = metric_comp, epoch
                save_best = True
            if save_latest or save_best or (epoch + 1) % save_interval == 0:
                val_sample_path = model.plot_sample(
                    visualizer, val_mini_batch, outputs, suffix="val_latest")

        if visualizer.save_to_disk:
            if (epoch + 1) % save_interval == 0 and train_sample_path:
                copyfile(train_sample_path,
                         train_sample_path.replace("latest", str(epoch + 1)))
            if save_best and train_sample_path and val_sample_path:
                copyfile(train_sample_path,
                         train_sample_path.replace("latest", "best"))
                copyfile(val_sample_path,
                         val_sample_path.replace("latest", "best"))

        # checkpoints, with the reference's tag scheme
        if visualizer.save_to_disk and (
                save_latest or save_best or (epoch + 1) % save_interval == 0):
            for p in save_latest_checkpoints(visualizer, model, epoch + 1,
                                             config):
                if (epoch + 1) % save_interval == 0:
                    copyfile(p, p.replace("latest", str(epoch + 1)))
                if save_best:
                    copyfile(p, p.replace("latest", "best"))

        visualizer.plot_losses_and_metrics(epoch_metrics, epoch)
        live.epoch_end()
        if mesh is not None:  # the first rank has validated and saved
            mesh.barrier()
        msg = ", ".join(f"{k}={v:.4f}" for k, v in
                        list(epoch_metrics["loss"].items())[:4])
        if lead:
            print(f"[epoch {epoch + 1}/{max_epochs}] {msg} "
                  f"({time.time() - t_ep:.1f}s)", flush=True)

        # bounded-lifetime training: exit at an epoch boundary after N
        # epochs, so that a launcher can restart the process and resume
        per_run = int(getattr(args, "epochs_per_run", 0) or 0)
        if per_run and (epoch + 1 - start_epoch) >= per_run \
                and (epoch + 1) < max_epochs:
            if lead:
                print(f"epochs_per_run={per_run} reached at epoch "
                      f"{epoch + 1}; exiting for clean resume.", flush=True)
            break

    live.close()
    total = time.time() - total_start
    if lead:
        print(f"Finished training after "
              f"{datetime.timedelta(seconds=total)}.")
        if best_metric_epoch > -1:
            print(f"Best metric: {best_metric} at epoch: "
                  f"{best_metric_epoch}.")
    return visualizer.save_dir
