"""Noise-model search: the port's ``bayesOpt_noise.py``.

Counterpart of the root ``bayesOpt_noise.py`` (reference
``utils/bayesOpt_noise.py``): search ``NoiseModeld``'s ``lambda_speckle``
and ``lambda_delta`` and ``RandomDecreaseResolutiond``'s ``max_factor``
(``max_decrease_res``) by short trainings scored by Validation DSC, with
successive halving (``utils/hpo.py::tune_sha``): every trial trains
``epochs_per_trial`` epochs, the best third goes on to three times the
budget, resuming its run directory, up to ``--max_budget``::

    python -m octa_tpu_torch.bayesOpt_noise --config_file <config> \\
        [--num_samples 32] [--epochs_per_trial 2] [--max_budget 9] \\
        [--sampler tpe|random] [--device cuda|cpu] [--Section.key value ...]

The config's Train chain must hold a ``NoiseModeld`` and a
``RandomDecreaseResolutiond`` entry (``config_ves_seg-S_RA.yml`` does); the
trials' runs go under ``Output.save_dir/trial_<n>``. Training runs on the
card unless ``--device cpu`` is given (``octa_tpu_torch.train.engine.
train``). The seed is 4958 unless the config sets one.
"""
from __future__ import annotations

import argparse
import copy

import numpy as np

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def _inject(config: dict, params: dict) -> None:
    """Write a trial's values into the config's Train chain."""
    from octa_tpu_torch.utils.enums import Phase

    for aug in config[Phase.TRAIN]["data_augmentation"]:
        if aug["name"] == "NoiseModeld":
            aug["lambda_speckle"] = params["lambda_speckle"]
            aug["lambda_delta"] = params["lambda_delta"]
        if aug["name"] == "RandomDecreaseResolutiond":
            aug["max_factor"] = params["max_decrease_res"]


def search_space() -> dict:
    """The root script's space: three choices on 0.1 grids."""
    from octa_tpu_torch.utils.hpo import Choice

    def grid(lo, hi):
        return Choice([round(float(x), 2) for x in np.arange(lo, hi, 0.1)])

    return {"lambda_speckle": grid(0.3, 0.71), "lambda_delta": grid(0.5, 1.1),
            "max_decrease_res": grid(0.3, 1.1)}


def make_eval_fn(base: dict, epochs_per_trial: int, device="cuda"):
    """The successive-halving rung evaluator: train a trial to ``budget *
    epochs_per_trial`` epochs, from scratch on its first rung and, when
    promoted, resuming the run directory its last rung returned (the
    engine reads ``<save_dir>/checkpoints/latest_*`` from it and forks a
    fresh sibling run directory that carries them and the metrics log).
    Returns ``{"Validation_DSC", "trial_dir", "epochs_done"}``."""
    import csv
    import os

    from octa_tpu_torch.train.engine import train
    from octa_tpu_torch.utils.enums import Phase

    trial_counter = [0]

    def eval_fn(params, budget, state):
        config = copy.deepcopy(base)
        _inject(config, params)
        epochs = budget * epochs_per_trial
        config[Phase.TRAIN]["epochs"] = epochs
        config["Output"]["save_to_disk"] = True
        if state is None:
            trial_counter[0] += 1
            config["Output"]["save_dir"] = os.path.join(
                base["Output"]["save_dir"], f"trial_{trial_counter[0]}")
        else:
            config["Output"]["save_dir"] = state["trial_dir"]

        class A:
            start_epoch = 0 if state is None else state["epochs_done"]
            epoch = "latest"
            split = ""
            save_latest = True
            num_workers = 0

        out_dir = train(A(), config, device=device)
        with open(os.path.join(out_dir, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        return {"Validation_DSC": float(rows[-1].get("Validation_DSC", 0)),
                "trial_dir": out_dir, "epochs_done": epochs}

    return eval_fn


def main(argv=None):
    """Search as the arguments say; returns ``(best_params, best_result,
    history)`` as :func:`octa_tpu_torch.utils.hpo.tune_sha` does."""
    from octa_tpu_torch.utils.hpo import tune_sha

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=32)
    parser.add_argument("--epochs_per_trial", type=int, default=2)
    parser.add_argument("--max_budget", type=int, default=9,
                        help="successive-halving max budget multiplier "
                             "(epochs = budget * epochs_per_trial)")
    parser.add_argument("--sampler", type=str, default="tpe",
                        choices=["tpe", "random"],
                        help="tpe = surrogate-model sampling (BOHB-style), "
                             "random = quasi-random")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    device = resolve_device(args.device)
    base = load_config(args.config_file)
    apply_cli_overrides(base, unknown)
    base.setdefault("General", {}).setdefault("seed", 4958)
    best_params, best_result, history = tune_sha(
        search_space(), make_eval_fn(base, args.epochs_per_trial, device),
        metric="Validation_DSC", mode="max", num_samples=args.num_samples,
        min_budget=1, max_budget=args.max_budget, reduction_factor=3,
        sampler=args.sampler)
    print("Best trial:", best_params, best_result)
    return best_params, best_result, history


if __name__ == "__main__":
    main()
