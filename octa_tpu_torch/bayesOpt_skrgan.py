"""SkrGAN sketch-filter search: the port's ``bayesOpt_skrgan.py``.

Counterpart of the root ``bayesOpt_skrgan.py`` (reference
``utils/bayesOpt_skrgan.py``): search the sketch's ``sigma``, its two area
thresholds and the binarization threshold of ``ops/filters.py::
skrgan_sketch`` against Validation DSC with the HPO harness
(``utils/hpo.py::tune``)::

    python -m octa_tpu_torch.bayesOpt_skrgan --config_file <config> \\
        [--num_samples 50] [--device cuda|cpu] [--Section.key value ...]

The validation loader runs once (on the card unless ``--device cpu`` is
given) and its images are kept on the host, where the sketch runs (scipy).
The seed is 4958 unless the config sets one, the batch size 1.
"""
from __future__ import annotations

import argparse

import numpy as np

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def search_space() -> dict:
    """The root script's space."""
    from octa_tpu_torch.utils.hpo import Uniform, UniformInt

    return {"area_threshold_open": UniformInt(1, 96),
            "area_threshold_close": UniformInt(1, 96),
            "sigma": UniformInt(0, 5),
            "threshold": Uniform(0.5, 0.9)}


def load_samples(config: dict, device) -> list[tuple]:
    """The Validation split as (image [C, H, W], label [C, H, W]) float32
    numpy pairs."""
    from octa_tpu_torch.data.dataset import get_dataset
    from octa_tpu_torch.utils.enums import Phase

    def host(x):
        return x.detach().float().cpu().numpy()

    config[Phase.VALIDATION]["batch_size"] = 1
    loader = get_dataset(config, Phase.VALIDATION, device=device)
    return [(host(b["image"])[0], host(b["label"])[0]) for b in loader]


def make_eval_fn(samples: list[tuple]):
    """A trial: ``params`` -> the Validation DSC and IoU of the thresholded
    sketches."""
    from octa_tpu_torch.ops.filters import skrgan_sketch
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    def eval_fn(params):
        metrics = MetricsManager(Phase.TRAIN)
        for img, label in samples:
            sketch = skrgan_sketch(
                img, sigma=params["sigma"],
                area_threshold_open=params["area_threshold_open"],
                area_threshold_close=params["area_threshold_close"])
            pred = (sketch > params["threshold"]).astype(np.float32)
            metrics([pred[None]], [(label > 0.5).astype(np.uint8)])
        return metrics.aggregate_and_reset(str(Phase.VALIDATION))

    return eval_fn


def main(argv=None):
    """Search as the arguments say; returns ``(best_params, best_result,
    history)``."""
    from octa_tpu_torch.utils.hpo import tune

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=50)
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_file)
    apply_cli_overrides(config, unknown)
    config.setdefault("General", {}).setdefault("seed", 4958)
    samples = load_samples(config, device)
    best_params, best_result, history = tune(
        search_space(), make_eval_fn(samples), metric="Validation_DSC",
        mode="max", num_samples=args.num_samples)
    print("Best trial:", best_params, best_result)
    return best_params, best_result, history


if __name__ == "__main__":
    main()
