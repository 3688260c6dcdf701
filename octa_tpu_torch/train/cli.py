"""Train a model from a YAML or JSON config: the port's ``train.py``.

Counterpart of the root ``train.py:15-35``, with the port's ``--device``;
``python -m octa_tpu_torch.train`` runs it (``train/__main__.py``):

    python -m octa_tpu_torch.train --config_file configs/config_ves_seg-S.yml \\
        [--device cuda|cpu] [--start_epoch N] [--epoch latest] [--split 0] \\
        [--num_workers N] [--epochs_per_run N] [--profile] [--debug] \\
        [--Section.key value ...]

It trains on the card unless ``--device cpu`` is given, and raises when a
card is asked for and none is present. ``--profile`` writes a
``torch.profiler`` trace of the run into ``<Output.save_dir>/profile_trace``
(``trace_rank<r>.json`` on a mesh), and beside it ``spans.json``
(``spans_rank<r>.json``): the program's ``octa.*`` spans summed by name
(:func:`octa_tpu_torch.utils.trace.totals`), the loader thread's
``octa.data.batch`` among them, which the trace does not hold. ``--debug``
turns on autograd's anomaly detection and makes warnings errors.

Over several cards of one host, data-parallel (one process a card, NCCL):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m octa_tpu_torch.train --config_file configs/config_ves_seg-S.yml

Every rank loads the same global batch and steps on its rows; a seed drawn
for a config without one is the first rank's.
"""
from __future__ import annotations

import argparse
import json
import os
from random import randint

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.utils.config import apply_cli_overrides, load_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--epoch", type=str, default="latest")
    parser.add_argument("--split", type=str, default="")
    parser.add_argument("--save_latest", type=bool, default=True)
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument(
        "--epochs_per_run", type=int, default=0,
        help="exit cleanly after this many epochs (0 = unlimited) so that a "
             "launcher can restart the process and resume")
    parser.add_argument(
        "--profile", action="store_true",
        help="write a torch.profiler trace of the run, and the program's "
             "spans summed by name, into the run's save_dir/profile_trace")
    parser.add_argument(
        "--debug", action="store_true",
        help="autograd anomaly detection, and warnings raised as errors")
    return parser.parse_known_args(argv)


def main(argv=None) -> str:
    args, unknown = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config_file)
    apply_cli_overrides(config, unknown)
    if "seed" not in config["General"]:
        config["General"]["seed"] = randint(0, int(1e6))
    try:
        return _run(args, config, device)
    finally:
        mesh_lib.shutdown()  # the process group that train joined


def _run(args, config, device) -> str:
    import torch
    import torch.distributed as dist

    from octa_tpu_torch.train.engine import train
    from octa_tpu_torch.utils import trace

    if args.debug:
        import warnings

        warnings.filterwarnings("error")
        torch.autograd.set_detect_anomaly(True)
    if not args.profile:
        return train(args, config, device)
    trace_dir = os.path.join(
        config.get("Output", {}).get("save_dir", "./results"), "profile_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace.clear()
    with torch.profiler.profile(activities=activities) as prof:
        run_dir = train(args, config, device)
    os.makedirs(trace_dir, exist_ok=True)
    rank = f"_rank{dist.get_rank()}" if dist.is_initialized() else ""
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace{rank}.json"))
    with open(os.path.join(trace_dir, f"spans{rank}.json"), "w") as f:
        json.dump({"dropped": trace.dropped(), "spans": trace.totals()}, f,
                  indent=1)
    print(f"Profiler trace written to {trace_dir}")
    return run_dir


if __name__ == "__main__":
    main()
