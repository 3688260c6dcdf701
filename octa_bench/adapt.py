"""What the adapt-and-segment cells share: the pool of vessel graphs as K1
inputs, the per-request draws, and the comparison of what the program's
``AdaptSegment`` produced with the plain reference.

The pool is the four frozen fixture graphs under ``octa_bench/data``, each
in its eight dihedral poses (x and y swapped and mirrored in the unit
square), so 32 distinct graphs; their edges are padded to one length and
kept on the device at both resolutions.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from octa_bench.reference import ckpt, nets, noise, splat

DATA = Path(__file__).resolve().parent / "data"
CHECKS = ("k1_in_max_abs", "label_mismatch", "noised_p99", "fake_rel",
          "logits_rel", "mask_mismatch", "dice_gap")


def read_graph(path) -> np.ndarray:
    """A vessel-graph CSV (``node1,node2,radius``; nodes as ``[x y z]``) ->
    float64 [E, 7]."""
    with open(path) as f:
        body = f.read().split("\n", 1)[1]
    vals = np.array(body.replace("[", " ").replace("]", " ")
                    .replace(",", " ").split(), dtype=np.float64)
    return vals.reshape(-1, 7)


def fixture_graphs() -> list[np.ndarray]:
    return [read_graph(p) for p in sorted(DATA.glob("graph_seed*.csv"))]


def dihedral(g: np.ndarray, k: int) -> np.ndarray:
    """Pose ``k`` (0-7) of a graph in the unit square: x, y swapped for
    ``k & 4``, x mirrored for ``k & 1``, y for ``k & 2``."""
    g = g.copy()
    for off in (0, 3):
        x, y = g[:, off].copy(), g[:, off + 1].copy()
        if k & 4:
            x, y = y, x
        g[:, off] = 1 - x if k & 1 else x
        g[:, off + 1] = 1 - y if k & 2 else y
    return g


class Pool:
    """The 32 graphs' edges on ``device`` at ``res`` for each resolution:
    ``a, b`` [32, E, 2], ``w, v`` [32, E]; ``take(idx)`` a batch."""

    def __init__(self, device, resolutions, multiple: int = 2048):
        graphs = [dihedral(g, k) for g in fixture_graphs() for k in range(8)]
        e = max(len(g) for g in graphs)
        e = -(-e // multiple) * multiple
        arr = np.zeros((len(graphs), e, 7), np.float64)
        valid = np.zeros((len(graphs), e), bool)
        for i, g in enumerate(graphs):
            arr[i, :len(g)] = g
            valid[i, :len(g)] = True
        t = torch.from_numpy(arr).to(device, torch.float32)
        v = torch.from_numpy(valid).to(device)
        self.size = len(graphs)
        self.edges = {res: splat.graph_edges(t[..., 0:3], t[..., 3:6],
                                             t[..., 6], res, v)
                      for res in resolutions}

    def take(self, res, idx):
        return tuple(x.index_select(0, idx) for x in self.edges[res])


def load_path(run, torch):
    """The program's ``AdaptSegment`` with the shipped weights, as the
    configuration's ``pipeline`` section sets it."""
    from octa_tpu_torch import pipeline

    from octa_bench.harness import ROOT

    pl = run.config["pipeline"]
    dev = torch.device(run.device)
    dtype = getattr(torch, pl["dtype"])
    g_ckpt, s_ckpt = (str(ROOT / run.config["weights"][k])
                      for k in ("generator", "segmentor"))
    nets_ = pipeline.load_networks(dev, dtype, g_ckpt=g_ckpt, s_ckpt=s_ckpt)
    return pipeline.AdaptSegment(dev, dtype, nets=nets_, res_in=pl["res_in"],
                                 res_lab=pl["res_lab"], k_in=pl["k_in"],
                                 k_lab=pl["k_lab"], max_batch=pl["batch"])


def adapt_batch(path, e_in, e_lab, gen, grid, keep: bool):
    """One batch through the program's path with fresh noise parameters
    drawn from ``gen``: returns the host's masks and Dice, and what the
    comparison needs when ``keep``."""
    from octa_tpu_torch import pipeline
    from octa_tpu_torch.models.noise_model import NoiseParams

    gen_state = gen.get_state() if keep else None
    params = noise.draw_params(e_in[0].shape[0], gen, tuple(grid))
    out = path.stages(e_in, e_lab, NoiseParams(*params), generator=gen)
    dice = pipeline.dice(out["pred"], out["lab"])
    masks, dice_host = out["pred"].cpu(), dice.cpu()
    kept = None
    if keep:
        kept = {"in": e_in, "lab": e_lab, "gen_state": gen_state,
                "out": {**out, "dice": dice_host}}
    return masks, dice_host, kept


def load_reference_nets(config: dict, root: Path, device) -> dict:
    """The shipped generator's and segmentor's weights, read from the raw
    checkpoint files, float32 on ``device``."""
    out = {}
    for net, rel in config["weights"].items():
        named = ckpt.to_named(ckpt.read_params(str(root / rel)))
        out[net] = {k: v.to(device) for k, v in named.items()}
    return out


def reference_outputs(sample: dict, config: dict, weights: dict,
                      prec: str = "fp32") -> dict:
    """The reference's every stage for one sampled request: ``sample``
    holds its edges at both resolutions, its noise parameters and the
    generator state before the program drew them. ``prec`` ``fp32``, or
    ``low``: K1 and the noise model in bfloat16, the networks in fp8."""
    pl = config["pipeline"]
    low = prec == "low"
    dt = torch.bfloat16 if low else torch.float32
    p = nets.Prec("fp8" if low else "fp32")
    a, b, w, v = sample["in"]
    img = splat.splat(a, b, w, v, pl["res_in"], pl["res_in"], pl["k_in"],
                      dtype=dt)
    a, b, w, v = sample["lab"]
    lab = splat.splat(a, b, w, v, pl["res_lab"], pl["res_lab"], pl["k_lab"],
                      dtype=dt) > pl["label_threshold"]
    gen = torch.Generator(img.device)
    gen.set_state(sample["gen_state"])
    nz = pl["noise"]
    params = noise.draw_params(img.shape[0], gen, tuple(nz["grid"]))
    bg = torch.from_numpy(noise.background(img.shape[0], pl["res_in"])).to(
        img.device)
    noised = noise.apply(params, img, bg, gen, nz["lambda_delta"],
                         nz["lambda_speckle"], nz["lambda_gamma"], dtype=dt)
    g_cfg = config["networks"]["generator"]
    s_cfg = config["networks"]["segmentor"]
    with torch.no_grad():
        fake = nets.generator(weights["generator"], g_cfg, noised[:, None], p)
        up = F.interpolate(fake, size=(pl["res_lab"], pl["res_lab"]),
                           mode="bilinear", align_corners=False)
        logits = nets.dynunet(weights["segmentor"], s_cfg, up, p)
    pred = logits[:, 0] > 0
    inter = (pred & lab).sum((1, 2)).float()
    dice = 2 * inter / (pred.sum((1, 2)) + lab.sum((1, 2))).clamp(min=1)
    return {"img": img, "lab": lab, "noised": noised, "fake": fake.float(),
            "logits": logits.float(), "pred": pred, "dice": dice}


def _rel(x, ref) -> float:
    """The largest relative L2 gap over the batch's images."""
    x, ref = x.flatten(1).double(), ref.flatten(1).double()
    return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
                  ).max())


def _p99(x, ref) -> float:
    """The 99th percentile of the pixels' gaps, image by image, the largest:
    a Gamma draw replayed from concentrations a last bit apart can land
    elsewhere at a pixel or two (a rejection sampler's accept flips)."""
    gap = (x.float() - ref.float()).abs().flatten(1)
    return float(torch.quantile(gap, 0.99, dim=1).max())


def compare(got: dict, ref: dict) -> dict[str, float]:
    """The numbers that decide ``correct`` for one request."""
    return {
        "k1_in_max_abs": float((got["img"] - ref["img"]).abs().max()),
        "label_mismatch": float((got["lab"] != ref["lab"]).flatten(1)
                                .float().mean(1).max()),
        "noised_p99": _p99(got["noised"], ref["noised"]),
        "fake_rel": _rel(got["fake"], ref["fake"]),
        "logits_rel": _rel(got["logits"], ref["logits"]),
        "mask_mismatch": float((got["pred"] != ref["pred"]).flatten(1)
                               .float().mean(1).max()),
        "dice_gap": float((got["dice"].float().cpu()
                           - ref["dice"].float().cpu()).abs().max()),
    }


def worst(readings: list[dict]) -> list[tuple[str, float]]:
    """Each number's worst reading over the requests compared (NaN, if
    any, is kept, and fails)."""
    out = []
    for k in CHECKS:
        vals = [r[k] for r in readings]
        bad = [x for x in vals if not math.isfinite(x)]
        out.append((k, bad[0] if bad else max(vals)))
    return out
