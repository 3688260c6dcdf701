"""Functions that the multi-process port tests run in each rank
(``octa_tpu_torch.parallel.mesh.launch`` spawns them by name), and the
small configurations they share with the tests. No JAX here: a spawned
rank imports this module, and the JAX package's imports would cost every
rank seconds.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.parallel import spatial
from octa_tpu_torch.sim import greenhouse as gh
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.utils.enums import Phase

# ---------------------------------------------------------------------------
# small configurations
# ---------------------------------------------------------------------------

# the tiny growth schedule of ``__graft_entry__.py:181-200``
GROW_CFG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025, "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05, "FAZ_center": [0.5, 0.5], "param_scale": 3,
    "modes": [{"name": "SVC", "I": 8, "N": 300, "eps_n": 0.18,
               "eps_s": 0.135, "eps_k": 0.135, "delta_art": 0.2925,
               "delta_ven": 0.2925, "gamma_art": 50, "gamma_ven": 50,
               "phi": 15, "omega": 0.3, "kappa": 2.55, "delta_sigma": 0.02}]}
GROW_FOREST = {"type": "stumps", "N_trees": 4,
               "source_walls": {"x0": True, "x1": True, "y0": True,
                                "y1": True, "z0": False, "z1": False}}

RES, BATCH = 32, 2
SMALL_G = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 2}
SMALL_G5 = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 5}
SMALL_D = {"name": "NLayerDiscriminator", "ndf": 8}
SMALL_F = {"name": "PatchSamplerF", "use_mlp": True, "nc": 16}
SMALL_N = {"name": "Negative_Generator", "nc": 16, "z_dim": 8}
SEG_NET = {"name": "DynUNet", "spatial_dims": 2, "in_channels": 1,
           "out_channels": 1, "kernel_size": [3, 3, 3, 3],
           "strides": [1, 2, 2, 1], "upsample_kernel_size": [1, 2, 2, 1],
           "filters": [8, 16, 16, 16], "remat": False}
NICE_RES = 128
NICE_GEN = {"name": "NiceResnetGenerator", "input_nc": 1, "output_nc": 1,
            "ngf": 8, "n_blocks": 2, "img_size": NICE_RES, "light": True}
NICE_DIS = {"name": "NiceDiscriminator", "input_nc": 1, "ndf": 8,
            "n_layers": 7}


def _train(lr=2e-4, **kw):
    return {"lr": lr, "weight_decay": 1e-3, "epochs": 3, "epochs_decay": 1,
            "batch_size": BATCH, **kw}


def _general(model, inference=None, task="gan-ves-seg"):
    g = {"task": task, "seed": 3, "amp": False, "model": model}
    if inference:
        g["inference"] = inference
    return g


def seg_config(at=None):
    cfg = {"General": _general(dict(SEG_NET), task="ves-seg"),
           "Train": _train(1e-3, loss="DiceBCELoss"),
           "Output": {"save_dir": "unused"}}
    if at is not None:
        cfg["Train"]["AT"] = at
    return cfg


def _contrastive(name, **model):
    m = {"name": name, "nce_layers": "0,4,8,12,16", "num_patches": 64,
         **model}
    return {"General": _general(m, "netG"),
            "Train": _train(loss_criterionGAN="LSGANLoss",
                            loss_criterionNCE=("LearnedPatchNCELoss"
                                               if name == "NEGCUTModel"
                                               else "PatchNCELoss"),
                            loss_criterionCycle="L1Loss",
                            loss_criterionIdt="L1Loss"),
            "Output": {"save_dir": "unused"}}


def trainer_config(name: str) -> dict:
    """A small configuration of each trainer that the data-parallel tests
    step (the pools of one image, so that one step of a batch of two
    replays one). ``s-wmse``, ``s-aa-cldice`` and ``gan-seg-cldice`` train
    with a loss that is a ratio of sums over the batch."""
    if name in ("gan-seg", "gan-seg-cldice"):
        s = dict(SEG_NET)
        loss_s = "ClDiceLoss" if name == "gan-seg-cldice" else "DiceBCELoss"
        return {"General": _general(
                    {"name": "GanSegModel", "model_g": dict(SMALL_G),
                     "model_d": dict(SMALL_D), "model_s": s,
                     "compute_identity": True, "compute_identity_seg": True,
                     "upshape": [2 * RES, 2 * RES]}, "G"),
                "Train": _train(loss_dg="LSGANLoss", loss_s=loss_s),
                "Output": {"save_dir": "unused"}}
    if name in ("s-aa", "s-aa-cldice"):
        cfg = seg_config({"grid_size": [9, 9], "alpha": 0.001,
                          "crop": [1, 1], "label_threshold": 0.1})
        if name == "s-aa-cldice":
            cfg["Train"]["loss"] = "ClDiceLoss"
        return cfg
    if name == "s-wmse":
        cfg = seg_config()
        cfg["Train"]["loss"] = "WeightedMSELoss"
        cfg["Data"] = {"class_balance": [0.25, 0.75]}
        return cfg
    if name == "cycle-gan":
        m = {"name": "CycleGAN", "netG_A_config": dict(SMALL_G),
             "netG_B_config": dict(SMALL_G), "netD_A_config": dict(SMALL_D),
             "netD_B_config": dict(SMALL_D), "lambda_A": 10, "lambda_B": 10,
             "lambda_idt": 0.5, "pool_size": 1}
        return {"General": _general(m, "netG_A"),
                "Train": _train(loss_criterionGAN="LSGANLoss",
                                loss_criterionCycle="L1Loss",
                                loss_criterionIdt="L1Loss"),
                "Output": {"save_dir": "unused"}}
    if name == "cut":
        return _contrastive("CUTModel", netG_config=dict(SMALL_G5),
                            netD_config=dict(SMALL_D),
                            netF_config=dict(SMALL_F))
    if name == "negcut":
        return _contrastive("NEGCUTModel", netG_config=dict(SMALL_G5),
                            netD_config=dict(SMALL_D),
                            netF_config=dict(SMALL_F),
                            netN_config=dict(SMALL_N), lambda_MS_neg=1.0)
    if name == "dclgan":
        cfg = _contrastive("DCLGAN", netG_A_config=dict(SMALL_G5),
                           netG_B_config=dict(SMALL_G5),
                           netD_A_config=dict(SMALL_D),
                           netD_B_config=dict(SMALL_D),
                           netF1_config=dict(SMALL_F),
                           netF2_config=dict(SMALL_F), pool_size=1)
        cfg["General"]["inference"] = "netG_A"
        return cfg
    if name == "nice-gan":
        m = {"name": "NiceGAN", "gen2A_config": dict(NICE_GEN),
             "gen2B_config": dict(NICE_GEN), "disA_config": dict(NICE_DIS),
             "disB_config": dict(NICE_DIS), "adv_weight": 1,
             "cycle_weight": 10, "recon_weight": 1}
        return {"General": _general(m, "gen2B"),
                "Train": _train(loss_ad="MSELoss", loss_cycle="L1Loss"),
                "Output": {"save_dir": "unused"}}
    raise KeyError(name)


TRAINERS = ("gan-seg", "s-aa", "cycle-gan", "cut", "negcut", "dclgan",
            "nice-gan", "s-wmse", "s-aa-cldice", "gan-seg-cldice")


def trainer_batch(name: str) -> dict:
    """The global batch of one step (numpy, NCHW float32, seeded)."""
    rng = np.random.default_rng(11)
    r = NICE_RES if name == "nice-gan" else RES
    img = lambda s=r: rng.random((BATCH, 1, s, s)).astype(np.float32)
    if name.startswith("s-aa"):
        return {"image": img(16), "background": img(16),
                "label": (rng.random((BATCH, 1, 32, 32)) < 0.3)
                .astype(np.float32)}
    if name == "s-wmse":
        return {"image": img(), "label": (rng.random((BATCH, 1, r, r)) < 0.3)
                .astype(np.float32)}
    batch = {"real_A": img(), "real_B": img()}
    if name.startswith("gan-seg"):
        batch["real_A_seg"] = (rng.random((BATCH, 1, 2 * r, 2 * r)) < 0.3) \
            .astype(np.float32)
    return batch


class Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def build_trainer(cfg: dict, batch: dict, dtype=torch.float64):
    """The port's trainer of ``cfg`` on the CPU, its networks in ``dtype``
    and its batches too (a spectral-norm layer computes in its input's
    dtype), initialised (on the mesh where the process group has one)."""
    mesh = mesh_lib.get_mesh(batch_size=cfg["Train"]["batch_size"],
                             device="cpu")
    t = talg.define_model(cfg, Phase.TRAIN, "cpu", mesh=mesh)
    for net in t.networks.values():
        net.to(dtype)
    t.initialize_model_and_optimizer(
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, Args())
    batch_in = t._batch_in
    t._batch_in = lambda x: batch_in(x).to(dtype)
    return t


def trainer_state(t, losses: dict) -> dict:
    """What a step left: losses, every network's parameters and buffers,
    and the gradients the optimizers stepped with (numpy)."""
    n = lambda x: x.detach().cpu().numpy().copy()
    out = {"losses": dict(losses), "params": {}, "buffers": {}, "grads": {}}
    for name, net in t.networks.items():
        for k, p in net.named_parameters():
            out["params"][f"{name}.{k}"] = n(p)
            if p.grad is not None:
                out["grads"][f"{name}.{k}"] = n(p.grad)
        for k, b in net.named_buffers():
            out["buffers"][f"{name}.{k}"] = n(b)
    return out


def trainer_step(name: str) -> dict:
    """One float64 step of trainer ``name`` on its global batch."""
    cfg, batch = trainer_config(name), trainer_batch(name)
    t = build_trainer(cfg, batch)
    _, losses = t.perform_training_step(
        {k: torch.from_numpy(v) for k, v in batch.items()}, {})
    return trainer_state(t, losses)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def mesh_rules(batch_sizes):
    """For each batch size: this rank's place in the mesh and its rows."""
    out = []
    for bs in batch_sizes:
        m = mesh_lib.get_mesh(batch_size=bs, device="cpu")
        rows = None
        if m.member:
            s = mesh_lib.shard_of(m, bs)  # None: all of them
            rows = (torch.arange(bs) if s is None
                    else s.take(torch.arange(bs))).tolist()
        out.append((dist.get_rank(), m.rank, m.size, rows))
    return out


def halo(x, up, down):
    """This rank's block of ``x`` [B, C, H, W] after a halo exchange."""
    sm = spatial.spatial_mesh(1, dist.get_world_size(), device="cpu")
    rows = mesh_lib.Shard(sm.space, x.shape[2])
    return spatial.halo_exchange(x[:, :, rows.lo:rows.hi].contiguous(), up,
                                 down, sm.space)


def spatial_infer(state, kwargs, x, n_data, n_space):
    """A DynUNet of ``kwargs`` with the flax parameters ``state`` on the
    global batch ``x``, sharded over an (n_data, n_space) grid."""
    from octa_tpu_torch.io import checkpoints as tck
    from octa_tpu_torch.models.dynunet import DynUNet

    net = DynUNet(**kwargs)
    tck.restore_like(net, state)
    sm = spatial.spatial_mesh(n_data, n_space, device="cpu")
    return spatial.dynunet_spatial_infer(net, torch.from_numpy(x), sm)


def nce_all_negatives(fq, fk, batch_size):
    """``PatchNCELoss`` with all negatives of the minibatch on this rank's
    rows of the features; returns the loss rows and the query's gradient
    of the global mean."""
    from octa_tpu_torch.utils.losses import PatchNCELoss

    m = mesh_lib.get_mesh(device="cpu")
    shard = mesh_lib.Shard(m, batch_size)
    per = fq.shape[0] // batch_size
    q = torch.from_numpy(fq[shard.lo * per:shard.hi * per]).requires_grad_()
    k = torch.from_numpy(fk[shard.lo * per:shard.hi * per])
    loss = PatchNCELoss(batch_size, True)(q, k, shard=shard)
    (loss.sum() / fq.shape[0]).backward()
    return loss.detach().numpy(), q.grad.numpy()


def dp_seg_steps(cfg, start, batches):
    """The port's segmentation trainer in float64 from the flax parameters
    ``start``, stepped on ``batches`` (global, numpy) over the mesh;
    returns its parameters (flax names) and the losses."""
    from octa_tpu_torch.io import checkpoints as tck

    mesh = mesh_lib.get_mesh(batch_size=cfg["Train"]["batch_size"],
                             device="cpu")
    t = talg.define_model(cfg, Phase.TRAIN, "cpu", mesh=mesh)
    tck.restore_like(t.net, start)
    t.net.double()
    t.initialize_model_and_optimizer(
        {k: torch.from_numpy(v) for k, v in batches[0].items()}, cfg, Args())
    assert t.mesh is not None and t.mesh.size == dist.get_world_size()
    losses = []
    for b in batches:
        _, lt = t.perform_training_step(
            {k: torch.from_numpy(v) for k, v in b.items()}, {})
        losses.append(lt[t.loss_name])
    params = {n: p.detach().numpy().copy()
              for n, p in t.net.named_parameters()}
    return params, losses


def dp_trainer_steps(names):
    """One float64 step of each trainer of ``names`` over the mesh."""
    return {name: trainer_step(name) for name in names}


def grow(batch: int, sharded: bool):
    """The tiny schedule grown at ``batch`` (over the mesh where
    ``sharded``): this process's rows, their state (numpy) and the
    capacities staged."""
    g = gh.Greenhouse(GROW_CFG, node_capacity=2048, sink_capacity=1024,
                      seed=3, device="cpu")
    mesh = mesh_lib.get_mesh(device="cpu") if sharded else None
    state = g.develop_forest(GROW_FOREST, batch=batch, mesh=mesh,
                             final_murray_sweeps=16)
    log = [(e["cap"], e["scap"], e["ecap"], e["accepted"])
           for e in g.stage_log]
    return list(g.rows), gh.state_to_numpy(state), log


def generate_cli(argv, cwd):
    """``python -m octa_tpu_torch.generate_vessel_graph`` in ``cwd``."""
    from octa_tpu_torch import generate_vessel_graph as gen

    os.chdir(cwd)
    return gen.main(argv)


def train_cli(argv):
    """``python -m octa_tpu_torch.train`` with ``argv``."""
    from octa_tpu_torch.train import cli

    return cli.main(argv)


#: the batch-wide class losses at the loss level: (registry name,
#: Data.class_balance); seeded [N, C] float64 scores and N labels, as
#: ``tests/test_torch_losses.py::test_class_losses`` shapes them
CLASS_LOSSES = (("CrossEntropyLoss", (0.2, 0.5, 0.3)),
                ("CosineEmbeddingLoss", (0.2, 0.5, 0.3)),
                ("QWKLoss", None))


def class_loss_inputs():
    rng = np.random.default_rng(7)
    return rng.normal(size=(10, 3)), rng.integers(0, 3, 10).astype(np.float64)


def class_loss(name: str, balance, shard=None, rows=slice(None)):
    """The registry's ``name`` on ``rows`` of :func:`class_loss_inputs`:
    its value and the gradient of the scores of those rows."""
    from octa_tpu_torch.utils import losses as tl

    cfg = {"Train": {}}
    if balance is not None:
        cfg["Data"] = {"class_balance": list(balance)}
    fn = tl.get_loss_function_by_name(name, cfg)
    scores, labels = class_loss_inputs()
    x = torch.from_numpy(scores[rows]).requires_grad_(True)
    y = torch.from_numpy(labels[rows])
    loss = fn(x, y) if shard is None else fn(x, y, shard=shard)
    loss.backward()
    return float(loss.detach()), x.grad.numpy().copy()


def _counting_collectives():
    """Record the ``what`` of every ``parallel.mesh.all_reduce_`` from now
    on in this process; returns the list."""
    seen = []
    reduce_ = mesh_lib.all_reduce_

    def counted(tensors, mesh, op=dist.ReduceOp.SUM, what="all_reduce"):
        seen.append(what)
        return reduce_(tensors, mesh, op, what)

    mesh_lib.all_reduce_ = counted
    return seen


def _cldice_step(cfg, batch, seen):
    """One float64 S step with ``ClDiceLoss`` on ``batch``: the loss and
    the loss collectives (``loss_sums``) it ran."""
    cfg["Train"]["loss"] = "ClDiceLoss"
    t = build_trainer(cfg, batch)
    del seen[:]
    _, losses = t.perform_training_step(
        {k: torch.from_numpy(v) for k, v in batch.items()}, {})
    return losses["ClDiceLoss"], seen.count("loss_sums")


#: :func:`loss_agreement`'s ``ClDiceLoss`` steps: rows of the batch
CLDICE_ROWS = {"sharded": 2, "undivided": 3, "mesh-1": 1}


def cldice_step_alone(case: str) -> float:
    """The loss of :func:`loss_agreement`'s step ``case`` in one
    process."""
    return _cldice_step(seg_config(), _rows_batch(CLDICE_ROWS[case]), [])[0]


def _rows_batch(rows: int) -> dict:
    rng = np.random.default_rng(13)
    return {"image": rng.random((rows, 1, RES, RES)).astype(np.float32),
            "label": (rng.random((rows, 1, RES, RES)) < 0.3)
            .astype(np.float32)}


def loss_agreement(per_sample):
    """On the mesh of every rank:

    - ``class``: each loss of :data:`CLASS_LOSSES` on this rank's rows of
      the scores, under its shard: value and this rank's gradient rows;
    - ``per_sample``: the S trainer built on the mesh with each ``(loss,
      class_balance)`` of ``per_sample``: None, or the error it raised;
    - ``collectives``: the loss collectives and the loss of one float64 S
      step with ``ClDiceLoss`` where the batch divides the mesh
      (``sharded``: 2 rows), where it does not (``undivided``: 3 rows on
      the mesh of 2), and on a mesh of one (``mesh-1``: batch size 1,
      which the divisor rule gives one rank)."""
    m = mesh_lib.get_mesh(device="cpu")
    out = {"class": {}, "per_sample": {}, "collectives": {}}
    n = len(class_loss_inputs()[1])
    shard = mesh_lib.Shard(m, n)
    for name, balance in CLASS_LOSSES:
        out["class"][name] = class_loss(name, balance, shard,
                                        slice(shard.lo, shard.hi))
    for loss, balance in per_sample:
        cfg = seg_config()
        cfg["Train"]["loss"] = loss
        if balance is not None:
            cfg["Data"] = {"class_balance": balance}
        try:
            build_trainer(cfg, trainer_batch("s-wmse"), torch.float32)
            out["per_sample"][loss, balance is not None] = None
        except Exception as exc:  # noqa: BLE001 - reported to the test
            out["per_sample"][loss, balance is not None] = repr(exc)
    seen = _counting_collectives()
    for case, rows in CLDICE_ROWS.items():
        cfg = seg_config()
        if case == "mesh-1":
            cfg["Train"]["batch_size"] = 1
        out["collectives"][case] = _cldice_step(cfg, _rows_batch(rows), seen)
    return out
