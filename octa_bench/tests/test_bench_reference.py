"""The plain reference against the port at a tiny size on the CPU, float32
on both sides. The reference imports nothing of the port; the test does."""
import json
import random

import numpy as np
import pytest
import torch

from octa_bench import adapt, harness
from octa_bench.reference import ckpt, nets, noise, splat
from octa_bench.reference import train as ref_train

CFG = json.loads((harness.BENCH_DIR / "configs" / "gan_ves_seg.json")
                 .read_text())
S_CFG = json.loads((harness.BENCH_DIR / "configs" / "ves_seg_S.json")
                   .read_text())


@pytest.fixture(autouse=True)
def _float32():
    torch.manual_seed(0)
    torch.set_num_threads(1)
    nets.no_tf32()


def _port_nets(dtype=torch.float32):
    from octa_tpu_torch import pipeline

    return pipeline.load_networks(
        "cpu", dtype, g_ckpt=str(harness.ROOT / CFG["weights"]["generator"]),
        s_ckpt=str(harness.ROOT / CFG["weights"]["segmentor"]))


def test_shipped_networks_agree():
    g, s = _port_nets()
    w = adapt.load_reference_nets(CFG, harness.ROOT, "cpu")
    x = torch.rand(2, 1, 32, 32)
    y = torch.rand(2, 1, 64, 64)
    with torch.no_grad():
        assert torch.allclose(g(x), nets.generator(w["generator"],
                                                   CFG["networks"]["generator"],
                                                   x), atol=1e-5)
        assert torch.allclose(s(y), nets.dynunet(w["segmentor"],
                                                 CFG["networks"]["segmentor"],
                                                 y), atol=1e-4, rtol=1e-5)


def test_seeded_weights_load_into_the_port():
    from octa_tpu_torch.models.resnet_gan import patchGAN70x70

    d = patchGAN70x70()
    spec = CFG["networks"]["discriminator"]
    w = nets.seeded_weights(nets.discriminator_shapes(spec),
                            torch.Generator().manual_seed(3))
    d.load_state_dict(w, strict=True)
    x = torch.rand(2, 1, 64, 64)
    with torch.no_grad():
        assert torch.allclose(d(x), nets.discriminator(w, spec, x), atol=1e-5)


def test_splat_agrees_with_k1():
    from octa_tpu_torch.ops.splat import splat_lines_2d

    g = adapt.fixture_graphs()[1]
    t = torch.from_numpy(g).float()[None]
    for res, k in ((48, 4096), (96, 64)):
        a, b, w, v = splat.graph_edges(t[..., 0:3], t[..., 3:6], t[..., 6], res)
        ref = splat.splat(a, b, w, v, res, res, k)
        got = splat_lines_2d(a, b, w, v, height=res, width=res, k_max=k)
        assert (ref - got).abs().max() < 1e-5


def test_noise_replays_the_draws():
    from octa_tpu_torch.models import noise_model as nm

    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    p = noise.draw_params(2, gen)
    img, bg = torch.rand(2, 40, 40), torch.rand(2, 40, 40)
    got = nm.apply_noise_model(nm.NoiseParams(*p), img, bg, gen)
    gen.set_state(state)
    ref = noise.apply(noise.draw_params(2, gen), img, bg, gen)
    assert (got - ref).abs().max() < 1e-5
    assert np.array_equal(noise.background(2, 8),
                          np.random.default_rng(0).random((2, 8, 8),
                                                          np.float32))


def test_dropout_replay_matches_the_renderer():
    from octa_tpu_torch.ops.raster import edge_dropout

    engine_train = harness.load_module(
        harness.BENCH_DIR / "drivers" / "engine_train.py", "engine_train")
    g = adapt.fixture_graphs()[0]
    for seed in (1, 2, 3):
        r1, r2 = random.Random(seed), random.Random(seed)
        rkeep = (g[:, 6] >= 0) & (g[:, 6] <= 1)
        want, bd = edge_dropout(g[:, 0:3], g[:, 3:6], rkeep, 0.5, None, r1)
        got, bd2 = engine_train._kept_edges(g, 0, 0.5, None, r2)
        assert np.array_equal(want, got) and bd == bd2
        want2, _ = edge_dropout(g[:, 0:3], g[:, 3:6], rkeep, 0.5, bd, r1)
        got2, _ = engine_train._kept_edges(g, 0, 0.5, bd2, r2)
        assert np.array_equal(want2, got2)


def test_segmentation_step_agrees_with_the_trainer():
    """Three of S's steps in float32: the port's SegAlgorithm step against
    the reference's, from the same weights on the same batches."""
    from octa_tpu_torch.train.algorithms import SegAlgorithm
    from octa_tpu_torch.utils.enums import Phase

    run = json.loads(json.dumps(S_CFG["run"]))
    run["General"]["amp"] = False
    model_cfg = {k: v for k, v in run["General"]["model"].items()
                 if k != "name"}
    algo = SegAlgorithm("DynUNet", run, Phase.TRAIN, device="cpu",
                        **model_cfg)
    spec = S_CFG["networks"]["segmentor"]
    w = nets.seeded_weights(nets.dynunet_shapes(spec),
                            torch.Generator().manual_seed(5))
    algo.net.load_state_dict(w, strict=True)
    algo.initialize_model_and_optimizer(None, run, None)
    batches = [(torch.rand(2, 1, 32, 32), (torch.rand(2, 1, 32, 32) > 0.7)
                .float()) for _ in range(3)]
    losses = [float(algo.train_step(x, y)[1]) for x, y in batches]
    config = dict(S_CFG, run=run)
    ref = ref_train.seg_steps(config, {"segmentor": w}, batches)
    for got, want in zip(losses, ref["losses"]):
        assert got == pytest.approx(want["DiceBCELoss"], rel=1e-5)
    for k, p in algo.net.named_parameters():
        assert torch.allclose(p, ref["params"]["segmentor"][k], atol=2e-6), k


def test_checkpoint_reader_matches_the_port():
    from octa_tpu_torch.io.checkpoints import load_checkpoint

    path = str(harness.ROOT / CFG["weights"]["segmentor"])
    mine = ckpt.read_params(path)
    port = load_checkpoint(path)["model"]
    assert np.array_equal(mine["input_block"]["conv1"]["kernel"],
                          port["input_block"]["conv1"]["kernel"])


def test_growth_references_agree_with_k2_k3_and_murray():
    """The plain nearest scan, segment sum and Murray relaxation of
    ``reference/growth.py`` against the port's plain versions of K2, K3 and
    its sweep, on a small grown forest."""
    from octa_tpu_torch.ops.nearest import masked_nearest_plain
    from octa_tpu_torch.ops.segsum import segment_sum_plain
    from octa_tpu_torch.sim import greenhouse as gh

    from octa_bench.reference import growth

    g = torch.Generator().manual_seed(4)
    q, p = torch.rand(3, 50, 3, generator=g), torch.rand(3, 70, 3, generator=g)
    m = torch.rand(3, 2, 70, generator=g) > 0.6
    m[1, 1] = False                          # a mask that admits nothing
    d, i = masked_nearest_plain(q, p, m)
    q_idx = torch.arange(0, 50, 3)
    d_ref, i_ref = growth.nearest(q, p, m, q_idx)
    assert torch.allclose(d[:, :, q_idx].double(), d_ref, rtol=1e-6)
    assert growth.nearest_gap((q, p, m, d, i), q_idx) < 1e-6
    assert growth.nearest_gap((q, p, m, d, i + 1), q_idx) > 1e-3
    seg = torch.randint(0, 11, (2, 40), generator=g)
    feats = torch.randn(2, 40, 18, generator=g)
    out = segment_sum_plain(seg, feats, 10)
    assert growth.segsum_gap((seg, feats, 10, out)) < 1e-6
    assert growth.segsum_gap((seg, feats, 10, out * 1.01)) > 1e-3
    cfg = json.loads(json.dumps(CFG["growth"]))
    for mode in cfg["Greenhouse"]["modes"]:
        mode["I"], mode["N"] = 4, 100
    house = gh.Greenhouse(cfg["Greenhouse"], node_capacity=2048,
                          sink_capacity=4096, device="cpu")
    house.seed = 3
    state = house.develop_forest(cfg["Forest"], batch=2, murray_sweeps=4,
                                 final_murray_sweeps=64)
    forests = (state.art, state.ven)
    r0 = house.r
    for f in forests:
        assert growth.faults(f, {4.0, float(np.float32(2.55)),
                                 float(np.float32(2.9))}) == 0
        assert growth.murray_gap(f, r0) < 1e-5
        relaxed = growth.murray_radii(f, 64, torch.float32)
        assert torch.allclose(relaxed, gh.murray_sweep(f, 64, exact=True)
                              .radius, rtol=1e-5)
    assert 0 < growth.stump_share(forests, 8) < 1
