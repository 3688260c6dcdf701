"""Post-processing search: the port's ``bayesOpt.py``.

Counterpart of the root ``bayesOpt.py`` (reference ``utils/bayesOpt.py``):
search the prediction threshold and ``RemoveSmallObjects``' ``min_size``
against Validation DSC with the HPO harness (``utils/hpo.py::tune``)::

    python -m octa_tpu_torch.bayesOpt --config_file <config> \\
        [--num_samples 100] [--epoch best] [--device cuda|cpu] \\
        [--Section.key value ...]

The validation loader, the model (``define_model``, its weights from
``Test.model_path`` or ``<Output.save_dir>/checkpoints/<epoch>_...``) and
its inference run once, at the config's full width, and each raw prediction
stays where it was made (on the card unless ``--device cpu`` is given).
Each trial then runs only ``Activations`` -> ``AsDiscrete`` on that device
and ``RemoveSmallObjects`` and the metrics on the host, over every cached
image; its cost is the number of images times one post-processing pass.
The seed is 4958 unless the config sets one, the batch size 1.
"""
from __future__ import annotations

import argparse

import numpy as np

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def search_space() -> dict:
    """The root script's space: ``min_size`` in 0..64, the threshold one of
    0.01, 0.02, ..., 0.89."""
    from octa_tpu_torch.utils.hpo import Choice, UniformInt

    return {"min_size": UniformInt(0, 64),
            "threshold": Choice(list(np.arange(0.01, 0.9, 0.01)))}


def cache_predictions(config: dict, args, device) -> list[tuple]:
    """Run the Validation split through the model once: a list of (raw
    prediction [C, H, W] on ``device``, its label cast to uint8 on the
    host), one pair an image."""
    from octa_tpu_torch.data.dataset import get_dataset
    from octa_tpu_torch.data.transforms import CastToType
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    config[Phase.VALIDATION]["batch_size"] = 1
    loader = get_dataset(config, Phase.VALIDATION, device=device)
    model = define_model(config, Phase.VALIDATION, device)
    model.initialize_model_and_optimizer(next(iter(loader)), config, args,
                                         phase=Phase.VALIDATION)
    keep = {"prediction": lambda x: x, "label": lambda x: x}
    post_label = CastToType(dtype="uint8")
    raw = []
    for mini_batch in loader:
        outputs, _ = model.inference(mini_batch, keep, phase=Phase.VALIDATION)
        raw.append((outputs["prediction"][0], post_label(outputs["label"][0])))
    return raw


def make_eval_fn(raw: list[tuple]):
    """A trial over the cached predictions: ``params`` (``threshold``,
    ``min_size``) -> the Validation DSC and IoU."""
    from octa_tpu_torch.data.transforms import (
        Activations,
        AsDiscrete,
        Compose,
        RemoveSmallObjects,
    )
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    def eval_fn(params):
        post = Compose([
            Activations(sigmoid=True),
            AsDiscrete(threshold=params["threshold"]),
            RemoveSmallObjects(min_size=params["min_size"]),
        ])
        metrics = MetricsManager(Phase.TRAIN)  # DSC + IoU is enough
        for pred, label in raw:
            metrics([np.asarray(post(pred))], [label])
        return metrics.aggregate_and_reset(str(Phase.VALIDATION))

    return eval_fn


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=100)
    parser.add_argument("--epoch", type=str, default="best")
    parser.add_argument("--debug_mode", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Search as the arguments say; returns ``(best_params, best_result,
    history)`` as :func:`octa_tpu_torch.utils.hpo.tune` does."""
    from octa_tpu_torch.utils.hpo import tune

    args, unknown = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_file)
    apply_cli_overrides(config, unknown)
    config.setdefault("General", {}).setdefault("seed", 4958)
    raw = cache_predictions(config, args, device)
    best_params, best_result, history = tune(
        search_space(), make_eval_fn(raw), metric="Validation_DSC",
        mode="max", num_samples=args.num_samples)
    print("Best trial:", best_params, best_result)
    return best_params, best_result, history


if __name__ == "__main__":
    main()
