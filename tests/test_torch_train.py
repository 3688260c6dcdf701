"""Port parity: the optimizer, the segmentation trainer, checkpoints across
the two packages, the training engine and its CLI.

A narrow DynUNet (filters 8-32) at 64², batch 2, float32 on the CPU, with
the JAX package's initial parameters carried into the port: one training
step gives the same loss (1e-5 relative) and gradients (1e-4 relative L2
per tensor), and three steps the same parameters (1e-5 absolute). The
engine runs two epochs on data made on the spot (fixture graphs cut to
their first edges, noise backgrounds, validation pairs rendered from the
graphs).
"""
import csv
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.train import algorithms as jalg
from octa_tpu.train import state as jstate
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import cli
from octa_tpu_torch.train import state as tstate
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                      "config_ves_seg-S.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: where test processes share the
    cores (pytest-xdist), torch's parallel regions wait on threads that are
    not running, and the plain K1 splat of a fixture graph at 128² took 123
    s instead of 2.5 s on eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_matches_optax(rng, wd):
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jstate.make_optimizer(1e-2, (0.5, 0.999), wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = tstate.make_optimizer(list(tp.values()), 1e-2, (0.5, 0.999), wd)
    for step in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        if step == 1:  # a schedule change between steps
            js = jstate.set_learning_rate(js, 5e-3)
            tstate.set_learning_rate(opt, 5e-3)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert opt.param_groups[0]["lr"] == 5e-3


def test_linear_decay_factor():
    for e in range(12):
        assert tstate.linear_decay_factor(e, 10, 3) == \
            jstate.linear_decay_factor(e, 10, 3)


# ---------------------------------------------------------------------------
# the segmentation trainer against the JAX package's
# ---------------------------------------------------------------------------

def _seg_config(lr=1e-4, wd=1e-3, remat=None):
    model = {"name": "DynUNet", "spatial_dims": 2, "in_channels": 1,
             "out_channels": 1, "kernel_size": [3, 3, 3, 3],
             "strides": [1, 2, 2, 1], "upsample_kernel_size": [1, 2, 2, 1],
             "filters": [8, 16, 32, 32]}
    if remat is not None:
        model["remat"] = remat
    return {"General": {"task": "ves-seg", "seed": 3, "amp": False,
                        "model": model},
            "Train": {"lr": lr, "weight_decay": wd, "loss": "DiceBCELoss",
                      "epochs": 4, "epochs_decay": 2, "batch_size": 2},
            "Output": {"save_dir": "unused"}}


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def _batch(rng, n=2, res=64):
    img = rng.random((n, 1, res, res)).astype(np.float32)
    lab = (rng.random((n, 1, res, res)) < 0.3).astype(np.float32)
    return {"image": img, "label": lab}


@pytest.fixture
def pair(rng):
    """The JAX trainer and the port's, from the same parameters."""
    cfg = _seg_config(remat=False)  # remat: test_remat_gives_the_same_step
    batch = _batch(rng)
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batch, cfg, _Args(), phase=JPhase.TRAIN)
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(batch, cfg, _Args(), phase=Phase.TRAIN)
    tck.restore_like(t.net, jax.tree.map(np.asarray, j.params["model"]))
    return j, t, batch


def test_training_step_matches_jax(pair, rng):
    j, t, batch = pair
    x = jnp.asarray(batch["image"]).transpose(0, 2, 3, 1)
    y = jnp.asarray(batch["label"]).transpose(0, 2, 3, 1)

    def loss_of(p):
        return j.loss_function(j.net.apply({"params": p}, x), y)

    ref, gref = jax.jit(jax.value_and_grad(loss_of))(j.params["model"])
    pred, loss = t.train_step(torch.from_numpy(batch["image"]),
                              torch.from_numpy(batch["label"]))
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    grads = tck.state_dict_to_flax(
        t.net, {n: p.grad for n, p in t.net.named_parameters()})
    g_ours, g_ref = _flat(grads), _flat(gref)
    assert g_ours.keys() == g_ref.keys()
    for k in g_ref:
        assert _rel_l2(g_ours[k], g_ref[k]) <= 1e-4, k


def test_three_steps_match_jax(pair, rng):
    j, t, batch = pair
    losses = []
    for _ in range(3):
        b = _batch(rng)
        _, lj = j.perform_training_step(dict(b), {})
        out, lt = t.perform_training_step(
            {k: torch.from_numpy(v) for k, v in b.items()}, {})
        losses.append((lt["DiceBCELoss"], lj["DiceBCELoss"]))
        assert isinstance(out["prediction"][0], np.ndarray)
    for ours, ref in losses:
        assert ours == pytest.approx(ref, rel=1e-5)
    p_ours = _flat(tck.state_dict_to_flax(t.net))
    p_ref = _flat(j.params["model"])
    for k in p_ref:
        np.testing.assert_allclose(p_ours[k], p_ref[k], atol=1e-5, err_msg=str(k))
    # the optimizer checkpoint restores into the JAX package's optax state
    state = tck.adam_state_to_flax(t.opt["optimizer"], {"model": t.net})
    restored = jck.restore_like(j.opt_state["optimizer"], state)
    assert int(restored.count) == 3
    for name in ("mu", "nu"):
        ours = _flat(getattr(restored.inner_state[1][0], name)["model"])
        ref = _flat(getattr(j.opt_state["optimizer"].inner_state[1][0],
                            name)["model"])
        for k in ref:
            assert _rel_l2(ours[k], ref[k]) <= 1e-4, (name, k)


def test_remat_gives_the_same_step(rng):
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
    out = []
    for remat in (True, False):
        t = talg.define_model(_seg_config(remat=remat), Phase.TRAIN, "cpu")
        t.initialize_model_and_optimizer(batch, _seg_config(), _Args())
        assert t.net.remat is remat
        _, loss = t.train_step(batch["image"], batch["label"])
        out.append((float(loss), [p.grad.clone() for p in t.net.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_checkpoints_cross_packages(pair, rng, tmp_path):
    j, t, batch = pair
    t.train_step(torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"]))
    x = _batch(rng)["image"]
    ours = t.forward(torch.from_numpy(x)).detach().numpy()
    # the port's checkpoint, read by the JAX package
    path = tck.save_checkpoint(str(tmp_path / "ck" / "t.ckpt"),
                               {"epoch": 1, **{"model": t.network_state("model")["params"]},
                                "config": {"a": 1}})
    loaded = jck.load_checkpoint(path)
    assert loaded["epoch"] == 1 and loaded["config"] == {"a": 1}
    params = jck.restore_like(j.params["model"], loaded["model"])
    ref = j.net.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-5)
    # the JAX package's checkpoint, read by the port
    jpath = jck.save_checkpoint(str(tmp_path / "ck" / "j.ckpt"),
                                {"epoch": 2, "model": j.params["model"]})
    t2 = talg.define_model(_seg_config(), Phase.TRAIN, "cpu")
    t2.load_network_state("model", {"params": tck.load_checkpoint(jpath)["model"]})
    ref = j.net.apply({"params": j.params["model"]},
                      jnp.asarray(x).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(t2.forward(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5)


def _monai_name(key):
    """The MONAI DynUNet state-dict name of a port parameter."""
    for ours, monai in (("downsample_", "downsamples."), ("upsample_", "upsamples.")):
        if key.startswith(ours):
            key = monai + key[len(ours):]
    if key.startswith("output_block."):
        return "output_block.conv.conv." + key.split(".")[-1]
    head, leaf = key.rsplit(".", 1)
    if head.rsplit(".", 1)[-1].startswith(("conv1", "conv2", "transp_conv")):
        return f"{head}.conv.{leaf}"
    return key


def test_inference_loading_ckpt_and_pth(pair, rng, tmp_path):
    j, t, _ = pair
    x = _batch(rng)["image"]
    ref = np.asarray(j.net.apply({"params": j.params["model"]},
                                 jnp.asarray(x).transpose(0, 2, 3, 1)))
    ref = ref.transpose(0, 3, 1, 2)
    model_cfg = dict(_seg_config()["General"]["model"])
    ck = tck.save_checkpoint(str(tmp_path / "m.ckpt"),
                             {"epoch": 1, "model": t.network_state("model")["params"]})
    pth = tmp_path / "monai.pth"
    torch.save({"model": {_monai_name(k): v for k, v in t.net.state_dict().items()}},
               pth)
    for path in (ck, str(pth)):
        apply = tck.load_network_for_inference(path, model_cfg, device="cpu")
        np.testing.assert_allclose(apply(torch.from_numpy(x)).numpy(), ref,
                                   atol=1e-5)
    # the JAX package reads the same .pth into the same network
    params = jck.import_dynunet_pth(str(pth), j.params["model"])
    out = j.net.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(np.asarray(out).transpose(0, 3, 1, 2), ref,
                               atol=1e-5)


def test_optimizer_checkpoint_resumes_in_the_port(rng, tmp_path):
    batches = [{k: torch.from_numpy(v) for k, v in _batch(rng).items()}
               for _ in range(3)]
    a = talg.define_model(_seg_config(), Phase.TRAIN, "cpu")
    a.initialize_model_and_optimizer(batches[0], _seg_config(), _Args())
    for b in batches[:2]:
        a.train_step(b["image"], b["label"])
    a.scheduler_step(2)  # epoch 3 of 4 with 2 decay epochs: lr halves
    path = tck.save_checkpoint(str(tmp_path / "o.ckpt"),
                               {"epoch": 2, "optimizer": a.optimizer_state("optimizer")})
    b_alg = talg.define_model(_seg_config(), Phase.TRAIN, "cpu")
    b_alg.initialize_model_and_optimizer(batches[0], _seg_config(), _Args())
    b_alg.load_network_state("model", a.network_state("model"))
    b_alg.load_optimizer_state("optimizer", tck.load_checkpoint(path)["optimizer"])
    assert b_alg.opt["optimizer"].param_groups[0]["lr"] == pytest.approx(5e-5)
    for alg in (a, b_alg):
        alg.train_step(batches[2]["image"], batches[2]["label"])
    for p, q in zip(a.net.parameters(), b_alg.net.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_fresh_dynunet_init_statistics():
    t = talg.define_model(load_config(CONFIG), Phase.TRAIN, "cpu")
    assert t.net.remat  # the JAX package's default for DynUNet training
    w = t.net.input_block.conv2.weight.detach()  # 32 -> 32, 3x3
    assert float(w.std()) == pytest.approx((2 / 288) ** 0.5, rel=0.05)
    assert float(t.net.output_block.bias.detach().abs().sum()) == 0.0
    up = t.net.upsample_1.transp_conv.weight.detach()  # [in 256, out 128, 2, 2]
    assert tuple(up.shape) == (256, 128, 2, 2)
    assert float(up.std()) == pytest.approx((2 / (256 * 4)) ** 0.5, rel=0.05)
    again = talg.define_model(load_config(CONFIG), Phase.TRAIN, "cpu")
    assert torch.equal(again.net.input_block.conv1.weight,
                       t.net.input_block.conv1.weight)
    cfg = load_config(CONFIG)
    cfg["General"]["model"]["name"] = "frangi"
    frangi = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert frangi.parameterless and not frangi.networks
    cfg["General"]["model"]["name"] = "CUTModel"
    with pytest.raises(NotImplementedError, match="GAN"):
        talg.define_model(cfg, Phase.TRAIN, "cpu")
    cfg = load_config(CONFIG)
    cfg["Train"]["AT"] = {"alpha": 1e-3}
    at = talg.define_model(cfg, Phase.TRAIN, "cpu")
    at.initialize_model_and_optimizer(None, cfg, _Args())
    assert at.at.alpha == 1e-3 and at.at.loss_fun is at.loss_function


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------

def _small_config(root):
    globs = make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                             n_val=2, background_res=40, val_res=64,
                             device="cpu", max_edges=120)
    cfg = point_config_at(load_config(CONFIG), globs, str(root / "runs"))
    aug = cfg["Train"]["data_augmentation"]
    aug[1]["image_resolutions"] = [[32, 32], [64, 64]]
    aug[4]["spatial_size"] = [32, 32]
    aug[6]["spatial_size"] = [64, 64]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [64, 64]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    tr = cfg["Train"]
    tr.update(epochs=2, epochs_decay=1, batch_size=2, save_interval=2, lr=1e-3)
    return cfg


def test_engine_trains_saves_and_resumes(tmp_path):
    cfg = _small_config(tmp_path)
    steps = []
    run = train(_Args(), json.loads(json.dumps(cfg)), device="cpu",
                on_step=lambda *a: steps.append(a))
    assert [s[:2] for s in steps] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert all(np.isfinite(s[2]["DiceBCELoss"]) and s[3] >= 0 for s in steps)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert {"train_DiceBCELoss", "val_DiceBCELoss", "Train_DSC", "Train_IoU",
            "Validation_DSC", "Validation_ClDice", "Validation_AUC"} <= set(rows[0])
    assert float(rows[1]["train_DiceBCELoss"]) < float(rows[0]["train_DiceBCELoss"])
    cks = set(os.listdir(os.path.join(run, "checkpoints")))
    assert {"latest_model_model.ckpt", "latest_optimizer.ckpt",
            "2_model_model.ckpt", "2_optimizer.ckpt",
            "best_model_model.ckpt", "best_optimizer.ckpt"} <= cks
    assert jck.load_checkpoint(os.path.join(run, "checkpoints",
                                            "latest_model_model.ckpt"))["epoch"] == 2
    for name in ("config.yml", "architecture.txt", "sample_train_latest.png",
                 "sample_val_latest.png"):
        assert os.path.exists(os.path.join(run, name)), name
    # resume: a new sibling run dir with the checkpoints and the metrics
    snap = load_config(os.path.join(run, "config.yml"))
    assert snap["Output"]["save_dir"] == run
    snap["Train"]["epochs"] = 3

    class Resume(_Args):
        start_epoch = 2

    run2 = train(Resume(), snap, device="cpu")
    assert run2 != run and os.path.dirname(run2) == os.path.dirname(run)
    with open(os.path.join(run2, "metrics.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
    assert os.path.exists(os.path.join(run2, "checkpoints", "2_model_model.ckpt"))


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    cfg = _small_config(tmp_path)
    cfg["Train"]["epochs"] = 1
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config_file", str(path)])
    assert not (tmp_path / "runs").exists()
    run = cli.main(["--config_file", str(path), "--device", "cpu", "--profile",
                    "--Train.batch_size", "4"])
    assert os.path.exists(os.path.join(run, "metrics.csv"))
    assert os.path.exists(tmp_path / "runs" / "profile_trace" / "trace.json")
