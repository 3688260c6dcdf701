"""Inference only: write one prediction image per test sample: the port's
``test.py``.

Counterpart of the root ``test.py:1-63``, with the port's ``--device``:

    python -m octa_tpu_torch.test --config_file <config> [--epoch best] \\
        [--num_samples N] [--device cuda|cpu] [--Section.key value ...]

Each prediction is an 8-bit PNG named ``{General.inference}_{input}.png``
(``model_{input}.png`` where the config names no inference mode) in
``Test.save_dir``, or ``<Output.save_dir>/test``; with ``Test.
save_comparisons`` the input and the prediction side by side as
``comparison_...``. ``--num_samples`` stops after that many samples and
shuts the loader's thread down before returning. It runs on the card
unless ``--device cpu`` is given, and raises when a card is asked for and
none is present. Its last line gives the rate over all samples, the
first sample's seconds (the loader's start, the first calls) and the rate
over the others.
"""
from __future__ import annotations

import argparse
import os
import time

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--epoch", type=str, default="best")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_known_args(argv)


def main(argv=None) -> list[str]:
    """Predict as the config says; returns the paths of the predictions."""
    args, unknown = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_file)
    apply_cli_overrides(config, unknown)
    config.setdefault("General", {}).setdefault("seed", 4958)

    import numpy as np
    import torch

    from octa_tpu_torch.data.dataset import get_dataset, get_post_transformation
    from octa_tpu_torch.io.visualizer import plot_comparison, plot_single_image
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    def host(x) -> np.ndarray:
        return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    save_dir = (config[Phase.TEST].get("save_dir")
                or os.path.join(config["Output"]["save_dir"], "test"))
    os.makedirs(save_dir, exist_ok=True)
    loader = get_dataset(config, Phase.TEST, device=device)
    post = get_post_transformation(config, Phase.TEST, device)
    model = define_model(config, Phase.TEST, device)
    init_batch = next(iter(loader))
    input_key = [k for k in init_batch if not k.endswith("_path")][0]
    init_batch.setdefault("image", init_batch[input_key])
    model.initialize_model_and_optimizer(init_batch, config, args,
                                         phase=Phase.TEST)
    inference_mode = config["General"].get("inference") or "model"

    written, done = [], []
    t0 = time.perf_counter()
    batches = iter(loader)
    try:
        for mini_batch in batches:
            input_key = [k for k in mini_batch if not k.endswith("_path")][0]
            mini_batch["image"] = mini_batch[input_key]
            outputs, _ = model.inference(mini_batch, post, phase=Phase.TEST)
            img_name = os.path.basename(
                str(mini_batch.get(input_key + "_path", ["pred"])[0]))
            img_name = os.path.splitext(img_name)[0] + ".png"
            prediction = host(outputs["prediction"][0])
            written.append(plot_single_image(
                save_dir, prediction, f"{inference_mode}_{img_name}"))
            done.append(time.perf_counter())
            if config[Phase.TEST].get("save_comparisons"):
                plot_comparison(
                    save_dir, host(mini_batch[input_key][0]), prediction,
                    f"comparison_{inference_mode}_{img_name}",
                    path=mini_batch.get(input_key + "_path", [""])[0])
            if args.num_samples is not None and len(written) >= args.num_samples:
                break
    finally:
        batches.close()  # stops and joins the loader's thread
    dt = time.perf_counter() - t0
    msg = (f"Wrote {len(written)} predictions to {save_dir} in {dt:.2f} s "
           f"({len(written) / dt:.2f} img/s)")
    if len(done) > 1:
        msg += (f"; the first in {done[0] - t0:.3f} s, the other "
                f"{len(done) - 1} at {(len(done) - 1) / (done[-1] - done[0]):.2f} "
                f"img/s")
    print(msg)
    return written


if __name__ == "__main__":
    main()
