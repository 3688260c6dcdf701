"""Generate synthetic vessel graphs, 3D volumes and 2D images.

Counterpart of the JAX package's ``generate_vessel_graph.py`` (the
reference-compatible dataset generator): grow ``--num_samples`` simulations
batched on the device, and per sample write into a new directory under the
config's ``output.directory``:

- ``config.yml``            the configuration used, as the JAX package's CLI
                            writes it (``yaml.safe_dump``, keys sorted);
                            JSON where PyYAML is missing,
- ``<name>.csv``            the arterial and venous trees (``save_trees``),
- ``art_ven_img_gray.npy``  the uint8 volume, the maximum of the arterial and
                            the venous voxelization (``save_3D_volumes: npy``;
                            ``art_ven_img_gray.nii.npy`` for ``nifti``, as the
                            JAX package's CLI writes it without nibabel, and
                            as ``LoadImaged`` reads a ``.nii`` path),
- ``art_ven_img_gray.png``  the uint8 image, the maximum of the two 2D
                            rasterizations (``save_2D_image``),
- ``stats/stats.yml``       the growth statistics (``save_stats``), and
                            ``stats/stats.png`` where matplotlib imports.

Run it as ``python3 -m octa_tpu_torch.generate_vessel_graph --config_file
builtin --num_samples 8 --output.image_scale_factor 1216
--output.save_3D_volumes npy``. ``--config_file`` takes a ``.json`` file, a
``.yml`` file where PyYAML is installed, or ``builtin`` for
``configs/vessel_graph_gen.yml`` as :mod:`octa_tpu_torch.sim.configs` holds
it; dotted arguments override config keys. It runs on the card unless
``--device cpu`` is given; ``--banded`` grows with the banded nearest scans.

Over several cards of one host (one process a card, NCCL):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m octa_tpu_torch.generate_vessel_graph --config_file builtin ...

shards each batch of growth over the cards (``develop_forest(mesh=)``, the
batch padded to a multiple of them with extra seeds); each rank voxelizes,
rasterizes and writes its own samples, which are those of a single process
grown from the same seed.

The volume and the image stay on the device until the one copy to the host
that writes each file. While a profiler session records, the stages are the
spans ``octa.generate.grow``, ``octa.generate.voxelize``,
``octa.generate.rasterize`` and ``octa.generate.write``
(:mod:`octa_tpu_torch.utils.trace`), with no synchronization of their own.
"""
from __future__ import annotations

import argparse
import datetime
import os
import uuid

import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io import images
from octa_tpu_torch.ops import raster
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.sim import greenhouse as gh
from octa_tpu_torch.sim.configs import vessel_graph_gen
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.config import (apply_cli_overrides, dump_config,
                                         load_config)


def prepare_output_dir(out_cfg: dict) -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out = os.path.join(out_cfg["directory"], f"{stamp}_{uuid.uuid4().hex[:8]}")
    os.makedirs(out, exist_ok=True)
    return out


def check_output_config(out_cfg: dict) -> None:
    """Raise on a volume format the generator does not write."""
    vol = out_cfg.get("save_3D_volumes")
    if vol not in (None, "npy", "nifti"):
        raise ValueError(f"Invalid save_3D_volumes option {vol}")


def generate(config: dict, num_samples: int = 1, *, seed: int = 0,
             batch_size: int | None = None, banded: bool = False,
             device="cuda", log=print,
             mesh: mesh_lib.Mesh | None = None) -> list[str]:
    """Grow ``num_samples`` simulations in batches and write each sample's
    files; returns the sample directories. With ``mesh`` each batch's
    growth is sharded over its ranks, and this process writes (and returns)
    its rank's samples."""
    dev = resolve_device(device) if mesh is None else mesh.device
    out_cfg = config["output"]
    check_output_config(out_cfg)
    g = gh.Greenhouse(config["Greenhouse"], seed=seed, device=dev,
                      banded=banded)
    batch = batch_size or min(num_samples, 64)
    scale = out_cfg["image_scale_factor"]
    volume_dimension = [int(d * scale) for d in g.sizes]
    axis = out_cfg["proj_axis"]
    collect_stats = bool(out_cfg.get("save_stats"))
    out_dirs: list[str] = []
    done = 0
    while done < num_samples:
        b = min(batch, num_samples - done)
        g.seed = seed + done
        with trace.span("octa.generate.grow"):
            state = g.develop_forest(config["Forest"], batch=b,
                                     collect_stats=collect_stats, mesh=mesh)
        state, stats = state if collect_stats else (state, None)
        # this process's samples of the batch (a padding seed is not one)
        for i, row in enumerate(g.rows):
            if row >= b:
                break
            with trace.span("octa.generate.write"):
                out_dir = prepare_output_dir(out_cfg)
                dump_config(config, os.path.join(out_dir, "config.yml"))
                art = gh.forest_to_edges(state.art, i)
                ven = gh.forest_to_edges(state.ven, i)
                name = os.path.basename(out_dir)
                if out_cfg.get("save_trees"):
                    gh.save_edges_csv([art, ven],
                                      os.path.join(out_dir, name + ".csv"))
                if collect_stats:
                    g.save_stats(state, stats, os.path.join(out_dir, "stats"),
                                 sim_index=i)

            if out_cfg.get("save_3D_volumes"):
                with trace.span("octa.generate.voxelize"):
                    art_vol, _ = raster.voxelize_forest_device(
                        art, volume_dimension, device=dev)
                    ven_vol, _ = raster.voxelize_forest_device(
                        ven, volume_dimension, device=dev)
                    vol = torch.maximum(art_vol, ven_vol)
                suffix = ".npy" if out_cfg["save_3D_volumes"] == "npy" \
                    else ".nii.npy"
                with trace.span("octa.generate.write"):
                    images.save_npy(
                        os.path.join(out_dir, "art_ven_img_gray" + suffix),
                        vol.cpu().numpy())

            if out_cfg.get("save_2D_image"):
                image_res = [*volume_dimension]
                del image_res[axis]
                with trace.span("octa.generate.rasterize"):
                    art_img, _ = raster.rasterize_forest_device(
                        art, image_res, MIP_axis=axis, device=dev)
                    ven_img, _ = raster.rasterize_forest_device(
                        ven, image_res, MIP_axis=axis, device=dev)
                    img = torch.maximum(art_img, ven_img).to(torch.uint8)
                with trace.span("octa.generate.write"):
                    images.save_png_gray8(
                        os.path.join(out_dir, "art_ven_img_gray.png"),
                        img.cpu().numpy())
            out_dirs.append(out_dir)
            log(f"[{done + row + 1}/{num_samples}] {out_dir}")
        done += b
    return out_dirs


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_file", type=str, required=True,
                        help="a .json config, a .yml one where PyYAML is "
                        "installed, or 'builtin'")
    parser.add_argument("--num_samples", type=int, default=1)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--threads", type=int, default=-1,
                        help="kept for CLI parity; batching replaces it")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="simulations grown per device batch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--banded", action="store_true",
                        help="grow with the banded nearest scans (K5)")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)

    if args.debug:
        import warnings

        warnings.filterwarnings("error")

    config = (vessel_graph_gen() if args.config_file == "builtin"
              else load_config(args.config_file))
    apply_cli_overrides(config, unknown)
    device = resolve_device(args.device)
    # under torch.distributed.run: shard growth over every rank
    mesh = mesh_lib.get_mesh(device=device)
    try:
        if mesh is not None and mesh.rank == 0:
            print(f"growth sharded over {mesh.size} processes", flush=True)
        return generate(config, args.num_samples, seed=args.seed,
                        batch_size=args.batch_size, banded=args.banded,
                        device=device, mesh=mesh)
    finally:
        mesh_lib.shutdown()


if __name__ == "__main__":
    main()
