"""Run artifacts: run directory, metrics log, checkpoints, sample plots.

Counterpart of ``octa_tpu/io/visualizer.py:20-334``: the timestamped run
directory with its config snapshot, the append-only ``metrics.csv``
(truncated to the resume epoch in a forked run, :80-103), ``loss.png``,
``save_model`` with the ``{latest|best|<epoch>}_{name}`` tag scheme,
``get_max_of_metric``, ``architecture.txt``, ``plot_sample``,
``plot_gan_seg_sample`` (:263), ``plot_cut_sample`` (:271), and the
test-time writers ``plot_single_image`` (:282) and ``plot_comparison``
(:296).

PyYAML, matplotlib, TensorBoard and PIL are optional, each imported where
it is used: without PyYAML the config snapshot ``config.yml`` is written as
JSON (``utils.config.dump_config``, which YAML readers read too); without matplotlib the sample grid is
an 8-bit grayscale PNG written by ``octa_tpu_torch.io.images`` and no
``loss.png`` is drawn; ``plot_single_image`` writes its PNG with that
writer always. Two runs started in the same second get distinct
directories (``<stamp>_1``, ...).
"""
from __future__ import annotations

import csv
import datetime
import importlib
import os
import shutil
from typing import Any

import numpy as np

from octa_tpu_torch.utils.config import dump_config


def _optional(name: str):
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def _fresh_dir(parent: str) -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path, n = os.path.join(parent, stamp), 0
    while os.path.exists(path):
        n += 1
        path = os.path.join(parent, f"{stamp}_{n}")
    return path


class Visualizer:
    def __init__(self, config: dict, continue_train: bool = False,
                 epoch: str = "latest"):
        self.config = config
        self.save_to_disk = bool(config.get("Output", {}).get("save_to_disk"))
        base = config.get("Output", {}).get("save_dir", "./results")
        if continue_train:
            # fork a new sibling run dir, carry the checkpoints over and
            # truncate the metrics log to the resume epoch
            self.save_dir = _fresh_dir(os.path.dirname(base.rstrip("/")) or ".")
            if self.save_to_disk:
                os.makedirs(os.path.join(self.save_dir, "checkpoints"))
                old_ck = os.path.join(base, "checkpoints")
                if os.path.isdir(old_ck):
                    for fn in os.listdir(old_ck):
                        shutil.copyfile(os.path.join(old_ck, fn),
                                        os.path.join(self.save_dir,
                                                     "checkpoints", fn))
        else:
            self.save_dir = _fresh_dir(base)
        if self.save_to_disk:
            os.makedirs(os.path.join(self.save_dir, "checkpoints"), exist_ok=True)
            snapshot = dict(config)
            snapshot["Output"] = dict(snapshot.get("Output", {}))
            snapshot["Output"]["save_dir"] = self.save_dir
            dump_config(_plain(snapshot),
                        os.path.join(self.save_dir, "config.yml"),
                        sort_keys=False)
        self.metrics_path = os.path.join(self.save_dir, "metrics.csv")
        self._metric_history: dict[str, list[float]] = {}
        if continue_train and self.save_to_disk:
            old_metrics = os.path.join(base, "metrics.csv")
            if os.path.exists(old_metrics):
                self._copy_truncated_metrics(old_metrics, epoch)
        self.save_to_tensorboard = bool(
            config.get("Output", {}).get("save_to_tensorboard"))
        self._tb = None

    def _tb_writer(self):
        """Lazy TensorBoard writer, where ``Output.save_to_tensorboard``."""
        if not (self.save_to_tensorboard and self.save_to_disk):
            return None
        if self._tb is None:
            tb = _optional("torch.utils.tensorboard")
            if tb is None:
                self.save_to_tensorboard = False
                return None
            self._tb = tb.SummaryWriter(
                log_dir=os.path.join(self.save_dir, "tensorboard"))
        return self._tb

    def _copy_truncated_metrics(self, old_metrics: str, epoch):
        """Carry the rows before the resume epoch into the forked run (all
        rows for 'latest' or 'best')."""
        with open(old_metrics) as f:
            rows = list(csv.DictReader(f))
        try:
            limit = int(epoch)
        except (TypeError, ValueError):
            limit = None
        kept = [r for r in rows
                if limit is None or float(r.get("epoch", -1)) < limit]
        if not kept:
            return
        with open(self.metrics_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(kept[0].keys()))
            w.writeheader()
            w.writerows(kept)
        for r in kept:
            for k, v in r.items():
                try:
                    self._metric_history.setdefault(k, []).append(float(v))
                except (TypeError, ValueError):
                    pass

    # -- metrics ----------------------------------------------------------
    def plot_losses_and_metrics(self, epoch_metrics: dict[str, dict], epoch: int):
        row: dict[str, Any] = {"epoch": epoch}
        for group in epoch_metrics.values():
            row.update(group)
        for k, v in row.items():
            self._metric_history.setdefault(k, []).append(v)
        if not self.save_to_disk:
            return
        exists = os.path.exists(self.metrics_path)
        fieldnames = list(row.keys())
        if exists:
            with open(self.metrics_path) as f:
                old = list(csv.reader(f))
            if old and old[0] != fieldnames:
                fieldnames = old[0]
        with open(self.metrics_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            if not exists:
                w.writeheader()
            w.writerow(row)
        self._plot_loss_png()
        tb = self._tb_writer()
        if tb is not None:
            for k, v in row.items():
                if k != "epoch":
                    tb.add_scalar(k, float(v), epoch)
            tb.flush()

    def _plot_loss_png(self):
        plt = _pyplot()
        keys = [k for k in self._metric_history if k != "epoch"]
        if plt is None or not keys:
            return
        ncols = min(3, len(keys))
        nrows = -(-len(keys) // ncols)
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(4 * ncols, 3 * nrows), squeeze=False)
        for i, k in enumerate(keys):
            ax = axes[i // ncols][i % ncols]
            ax.plot(self._metric_history[k])
            ax.set_title(k, fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(self.save_dir, "loss.png"))
        plt.close(fig)

    def get_max_of_metric(self, group: str, metric_name: str):
        """Best value and its epoch in metrics.csv (the resume path)."""
        if not os.path.exists(self.metrics_path):
            return -1, -1
        with open(self.metrics_path) as f:
            rows = list(csv.DictReader(f))
        vals = [(float(r[metric_name]), int(float(r["epoch"])))
                for r in rows if r.get(metric_name) not in (None, "", "nan")]
        if not vals:
            return -1, -1
        return max(vals)

    # -- checkpoints --------------------------------------------------------
    def save_model(self, network_state, optimizer_state, epoch: int,
                   config: dict, name: str) -> str:
        """Save ``{tag}_{netname}_model.ckpt`` or ``{tag}_{optname}.ckpt``."""
        from octa_tpu_torch.io.checkpoints import save_checkpoint

        ckdir = os.path.join(self.save_dir, "checkpoints")
        if network_state is not None:
            path = os.path.join(ckdir, f"{name}_model.ckpt")
            save_checkpoint(path, {"epoch": epoch,
                                   "model": network_state["params"],
                                   "config": _plain(config)})
        else:
            path = os.path.join(ckdir, f"{name}.ckpt")
            save_checkpoint(path, {"epoch": epoch,
                                   "optimizer": optimizer_state,
                                   "config": _plain(config)})
        return path

    def save_model_architecture(self, model):
        if not self.save_to_disk:
            return
        lines = [f"{type(model).__name__}"]
        for name, n in model.num_parameters().items():
            lines.append(f"  {name}: {n:,} parameters")
        with open(os.path.join(self.save_dir, "architecture.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # -- sample plots ---------------------------------------------------------
    def _save_grid(self, images: list[np.ndarray], titles: list[str],
                   filename: str) -> str:
        path = os.path.join(self.save_dir, filename)
        if not self.save_to_disk:
            return path
        arrays = [np.asarray(img, np.float32).squeeze() for img in images]
        # a z-stack (3D reconstruction: the planes as channels) as its
        # maximum over the planes; the JAX package's grid raises on one
        arrays = [a.max(axis=0) if a.ndim == 3 else a for a in arrays]
        plt = _pyplot()
        if plt is None:
            _save_png_row(path, arrays)
            return path
        n = len(arrays)
        ncols = min(3, n)
        nrows = -(-n // ncols)
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(4 * ncols, 4 * nrows), squeeze=False)
        for i, (arr, t) in enumerate(zip(arrays, titles)):
            ax = axes[i // ncols][i % ncols]
            ax.imshow(arr, cmap="gray")
            ax.set_title(t, fontsize=8)
            ax.axis("off")
        for j in range(n, nrows * ncols):
            axes[j // ncols][j % ncols].axis("off")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path

    def plot_sample(self, image, prediction, label=None, *, path="",
                    suffix="") -> str:
        imgs = [image, prediction] + ([label] if label is not None else [])
        titles = ["image", "prediction"] + (["label"] if label is not None else [])
        return self._save_grid(imgs, titles, f"sample_{suffix}.png")

    def plot_gan_seg_sample(self, real_a, fake_b, pred, real_b, idt_b,
                            real_b_seg, *, path_a="", path_b="",
                            suffix="") -> str:
        return self._save_grid(
            [real_a, fake_b, pred, real_b, idt_b, real_b_seg],
            ["real_A", "fake_B", "fake_B_seg", "real_B", "idt_B", "real_B_seg"],
            f"sample_{suffix}.png")

    def plot_cut_sample(self, real_a, fake_b, real_b, idt_b, *,
                        suffix="") -> str:
        return self._save_grid(
            [real_a, fake_b, real_b, idt_b],
            ["real_A", "fake_B", "real_B", "idt_B"],
            f"sample_{suffix}.png")


def _png_name(name: str) -> str:
    return name if name.endswith(".png") else name + ".png"


def plot_single_image(save_dir: str, image: np.ndarray, name: str) -> str:
    """Write one prediction as an 8-bit grayscale PNG: values in [0, 1] as
    they are, larger ones divided by 255, clipped and truncated to 8 bits; a
    3D volume also as ``.npy``, and its maximum along the last axis as the
    PNG."""
    from octa_tpu_torch.io.images import save_png_gray8

    os.makedirs(save_dir, exist_ok=True)
    arr = np.asarray(image, np.float32).squeeze()
    if arr.ndim == 3:
        np.save(os.path.join(save_dir, name + ".npy"), arr)
        arr = arr.max(axis=-1)
    arr = np.clip(arr, 0, 1) if arr.max() <= 1.0 else np.clip(arr / 255.0, 0, 1)
    path = os.path.join(save_dir, _png_name(name))
    save_png_gray8(path, (arr * 255).astype(np.uint8))
    return path


def plot_comparison(save_dir: str, image: np.ndarray, prediction: np.ndarray,
                    name: str, path: str = "") -> str:
    """Input and prediction side by side (reference ``test.py:88-89`` with
    ``save_comparisons``): a matplotlib figure titled with ``path``'s name
    where matplotlib is installed, else the two as one grayscale PNG."""
    os.makedirs(save_dir, exist_ok=True)
    arrays = []
    for arr in (image, prediction):
        a = np.asarray(arr, np.float32).squeeze()
        arrays.append(a.max(axis=-1) if a.ndim == 3 else a)
    out = os.path.join(save_dir, _png_name(name))
    plt = _pyplot()
    if plt is None:
        _save_png_row(out, arrays)
        return out
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, title, a in zip(axes, ("image", "prediction"), arrays):
        ax.imshow(a, cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    if path:
        fig.suptitle(os.path.basename(str(path)))
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None."""
    mpl = _optional("matplotlib")
    if mpl is None:
        return None
    mpl.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def _save_png_row(path: str, arrays: list[np.ndarray]) -> None:
    """The images side by side, each min-max scaled to 8 bits, as one
    grayscale PNG."""
    from octa_tpu_torch.io.images import save_png_gray8

    h = max(a.shape[0] for a in arrays)
    tiles = []
    for a in arrays:
        a = a.astype(np.float32)
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
        tile = np.zeros((h, a.shape[1]), np.uint8)
        tile[:a.shape[0]] = np.round(a * 255).astype(np.uint8)
        tiles.append(tile)
    save_png_gray8(path, np.concatenate(tiles, axis=1))


def _plain(obj):
    """YAML-safe plain structure."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
