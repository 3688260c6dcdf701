"""Run the Validation split through a trained model and print the metric
dict: the port's ``validate.py``.

Counterpart of the root ``validate.py:1-40``, with the port's ``--device``:

    python -m octa_tpu_torch.validate --config_file <config> \\
        [--epoch best] [--split 0] [--device cuda|cpu] [--Section.key value ...]

The batch size is 1 and the seed 4958 unless the config sets one. The model
is read from ``Test.model_path`` where the config gives one, else from
``<Output.save_dir>/checkpoints/<epoch>_...``. It runs on the card unless
``--device cpu`` is given, and raises when a card is asked for and none is
present. A GAN-seg model whose ``General.inference`` is ``G`` predicts
images, not segmentations, and is refused with a ``ValueError``.
"""
from __future__ import annotations

import argparse

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--epoch", type=str, default="best")
    parser.add_argument("--split", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_known_args(argv)


def main(argv=None) -> dict[str, float]:
    """Validate as the config says; returns the metric dict, rounded to 4
    digits as it is printed."""
    args, unknown = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_file)
    apply_cli_overrides(config, unknown)
    config.setdefault("General", {}).setdefault("seed", 4958)

    from octa_tpu_torch.data.dataset import get_dataset, get_post_transformation
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.train.engine import apply_split_suffix
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager, _is_zstack

    apply_split_suffix(config, args.split)
    config[Phase.VALIDATION]["batch_size"] = 1
    model = define_model(config, Phase.VALIDATION, device)
    loader = get_dataset(config, Phase.VALIDATION, device=device)
    post = get_post_transformation(config, Phase.VALIDATION, device)
    model.initialize_model_and_optimizer(next(iter(loader)), config, args,
                                         phase=Phase.VALIDATION)
    metrics = MetricsManager(Phase.VALIDATION, volumetric=_is_zstack(config),
                             device=device)
    for mini_batch in loader:
        outputs, _ = model.inference(mini_batch, post, phase=Phase.VALIDATION)
        model.compute_metric(outputs, metrics)
    result = metrics.aggregate_and_reset(str(Phase.VALIDATION))
    rounded = {k: round(v, 4) for k, v in result.items()}
    print(rounded)
    return rounded


if __name__ == "__main__":
    main()
