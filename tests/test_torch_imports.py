"""The port stands alone at run time, and its entry points never fall back
to the CPU.

``octa_tpu_torch`` and ``chip_smoke.py`` run on a host with PyTorch, numpy
and the CUDA toolkit only: an AST scan shows that none of their modules
imports JAX, flax, the JAX package, yaml, PIL, matplotlib, nibabel,
msgpack or one of the repo's root scripts. Entry points
default to ``device="cuda"`` and raise, rather than run on the CPU, when no
card is present.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from octa_tpu_torch import pipeline as tp
from octa_tpu_torch.models import noise_model as tnm
from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.sim import configs as tcfg
from octa_tpu_torch.sim import greenhouse as tgh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "octa_tpu", "yaml", "PIL",
             "msgpack", "matplotlib", "nibabel"}
# the repo's root scripts, which import the JAX package
ROOT_SCRIPTS = {"bayesOpt", "bayesOpt_noise", "bayesOpt_skrgan",
                "ROI_cropping", "train", "validate", "test", "bench",
                "generate_vessel_graph", "visualize_vessel_graphs",
                "__graft_entry__"}


# the segmentation-training slice
TRAINING = ("octa_tpu_torch/utils/enums.py", "octa_tpu_torch/utils/metrics.py",
            "octa_tpu_torch/utils/losses.py", "octa_tpu_torch/ops/morphology.py",
            "octa_tpu_torch/ops/skeleton.py", "octa_tpu_torch/data/functional.py",
            "octa_tpu_torch/data/transforms.py", "octa_tpu_torch/data/dataset.py",
            "octa_tpu_torch/train/state.py", "octa_tpu_torch/train/algorithms.py",
            "octa_tpu_torch/train/engine.py", "octa_tpu_torch/train/cli.py",
            "octa_tpu_torch/train/__main__.py", "octa_tpu_torch/models/registry.py",
            "octa_tpu_torch/io/visualizer.py", "octa_tpu_torch/tools/seg_data.py")
# the GAN-seg slice and the evaluation CLIs
GAN_SEG = ("octa_tpu_torch/models/resnet_gan.py", "octa_tpu_torch/validate.py",
           "octa_tpu_torch/test.py", "octa_tpu_torch/io/checkpoints.py")
# adversarial noise training, the Menten chain and the classical baselines
RECIPES = ("octa_tpu_torch/ops/filters.py", "octa_tpu_torch/models/noise_model.py",
           "octa_tpu_torch/utils/losses.py", "octa_tpu_torch/data/transforms.py",
           "octa_tpu_torch/models/registry.py", "octa_tpu_torch/train/algorithms.py")
# the 3D reconstruction (volumetric skeleton, RemoveOuterNoise, z-stack data)
# and CycleGAN
RECON_CYCLE = ("octa_tpu_torch/ops/skeleton.py", "octa_tpu_torch/tools/seg_data.py",
               "octa_tpu_torch/data/transforms.py",
               "octa_tpu_torch/train/gan_algorithms.py",
               "octa_tpu_torch/generate_vessel_graph.py",
               "octa_tpu_torch/visualize_vessel_graphs.py")
# the tuning and data tooling: the HPO harness and the three searches, the
# native readers, ROI cropping
TOOLING = ("octa_tpu_torch/utils/hpo.py", "octa_tpu_torch/bayesOpt.py",
           "octa_tpu_torch/bayesOpt_noise.py", "octa_tpu_torch/bayesOpt_skrgan.py",
           "octa_tpu_torch/native/__init__.py", "octa_tpu_torch/ROI_cropping.py")
# the mesh: data parallelism and height-sharded inference over several cards
MESH = ("octa_tpu_torch/parallel/__init__.py", "octa_tpu_torch/parallel/mesh.py",
        "octa_tpu_torch/parallel/spatial.py")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "octa_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_stack():
    files = _port_files()
    assert len(files) >= 10
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"octa_tpu_torch/sim/greenhouse.py", "octa_tpu_torch/sim/configs.py",
            "octa_tpu_torch/ops/nearest.py", "octa_tpu_torch/ops/segsum.py",
            "octa_tpu_torch/ops/splat3d.py", "octa_tpu_torch/ops/raster.py",
            "octa_tpu_torch/utils/config.py", "octa_tpu_torch/io/images.py",
            "octa_tpu_torch/generate_vessel_graph.py",
            "octa_tpu_torch/visualize_vessel_graphs.py"} | set(TRAINING) \
        | set(GAN_SEG) | set(RECIPES) | set(RECON_CYCLE) | set(TOOLING) \
        | set(MESH) <= names
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN | ROOT_SCRIPTS}
    assert not bad, f"forbidden imports: {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import octa_tpu_torch.pipeline, chip_smoke; "
            "import octa_tpu_torch.sim.greenhouse, octa_tpu_torch.sim.configs; "
            "import octa_tpu_torch.ops.nearest, octa_tpu_torch.ops.segsum; "
            "import octa_tpu_torch.ops.splat3d, octa_tpu_torch.ops.raster; "
            "import octa_tpu_torch.utils.config, octa_tpu_torch.io.images; "
            "import octa_tpu_torch.generate_vessel_graph; "
            "import octa_tpu_torch.visualize_vessel_graphs; "
            "import octa_tpu_torch.train.cli, octa_tpu_torch.train.engine; "
            "import octa_tpu_torch.data.transforms, octa_tpu_torch.data.dataset; "
            "import octa_tpu_torch.utils.metrics, octa_tpu_torch.utils.losses; "
            "import octa_tpu_torch.io.visualizer, octa_tpu_torch.tools.seg_data; "
            "import octa_tpu_torch.models.registry, octa_tpu_torch.ops.morphology; "
            "import octa_tpu_torch.validate, octa_tpu_torch.test; "
            "import octa_tpu_torch.models.resnet_gan; "
            "import octa_tpu_torch.ops.filters; "
            "import octa_tpu_torch.train.gan_algorithms; "
            "import octa_tpu_torch.native, octa_tpu_torch.utils.hpo; "
            "import octa_tpu_torch.bayesOpt, octa_tpu_torch.bayesOpt_noise; "
            "import octa_tpu_torch.bayesOpt_skrgan, octa_tpu_torch.ROI_cropping; "
            "import octa_tpu_torch.parallel.mesh, octa_tpu_torch.parallel.spatial; "
            "bad = [m for m in ('jax', 'flax', 'octa_tpu', 'yaml', 'msgpack', "
            "'PIL', 'matplotlib', 'nibabel', 'scipy', 'rich', "
            "'tensorboard', 'bayesOpt', 'bayesOpt_noise', 'bayesOpt_skrgan', "
            "'ROI_cropping') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tp.load_networks()
    with pytest.raises(RuntimeError):
        tp.AdaptSegment()
    with pytest.raises(RuntimeError):
        tp.edges_to_device([{"node1": [[0, 0, 0]], "node2": [[1, 1, 1]],
                             "radius": [0.01]}])
    with pytest.raises(RuntimeError):
        tnm.sample_noise_params(1, torch.Generator())
    cfg = tcfg.vessel_graph_gen()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgh.Greenhouse(cfg["Greenhouse"])
    with pytest.raises(RuntimeError):
        tgh.state_from_numpy(None)
    assert resolve_device("cpu") == torch.device("cpu")
    g = tgh.Greenhouse(cfg["Greenhouse"], device="cpu")
    assert g.device == torch.device("cpu") and g.generator.device == g.device
    assert g.init_state(cfg["Forest"], 0, 64, 32).art.pos.device == g.device


def test_generation_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from octa_tpu_torch import generate_vessel_graph as gen
    from octa_tpu_torch import visualize_vessel_graphs as viz
    from octa_tpu_torch.ops import raster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = raster.parse_graph_csv(raster.fixture_graph_paths()[0])
    for render in (raster.voxelize_forest, raster.voxelize_forest_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            render(graph, [76, 76, 1])
    for render in (raster.rasterize_forest, raster.rasterize_forest_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            render(graph, [76, 76])
    cfg = tcfg.vessel_graph_gen()
    cfg["output"]["directory"] = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen.generate(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen.main(["--config_file", "builtin", "--output.directory",
                  str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        viz.main(["--source_dir", raster.FIXTURE_DIR, "--out_dir",
                  str(tmp_path / "viz")])
    assert not (tmp_path / "out").exists() and not (tmp_path / "viz").exists()


def test_kernel_wrappers_never_fall_back_on_a_cuda_tensor():
    """Each wrapper takes its plain version for CPU tensors only: for any
    other device it goes to the kernel or raises, with no ``try`` around it."""
    import inspect

    from octa_tpu_torch.ops import nearest, segsum, splat, splat3d

    for mod, name in ((nearest, "masked_nearest"), (segsum, "segment_sum"),
                      (splat, "splat_lines_2d"),
                      (nearest, "masked_nearest_banded"),
                      (splat3d, "splat_capsules_3d")):
        src = inspect.getsource(getattr(mod, name))
        assert 'device.type == "cpu"' in src and "try:" not in src
        assert "try:" not in inspect.getsource(mod)
    meta = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nearest.masked_nearest(meta, meta, torch.ones(1, 1, 4, dtype=torch.bool,
                                                      device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        segsum.segment_sum(torch.zeros(1, 4, dtype=torch.int32, device="meta"),
                           torch.zeros(1, 4, 2, device="meta"), 3)


def test_noise_draws_stay_on_the_generator_device(monkeypatch):
    """A CPU generator cannot feed draws asked for on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator on cpu"):
        tnm.sample_noise_params(1, torch.Generator())


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not reachable")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_launch_guard_only_for_another_card(monkeypatch):
    """Every wrapper launches under ``ops._cuda.on_device``: no guard for a
    tensor on the current card, ``torch.cuda.device`` for one on another."""
    import contextlib
    import inspect

    from octa_tpu_torch.ops import _cuda, nearest, segsum, splat, splat3d

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert isinstance(_cuda.on_device(torch.device("cuda", 0)),
                      contextlib.nullcontext)
    guard = _cuda.on_device(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
    for fn in (nearest._nearest_cuda, nearest._banded_cuda,
               segsum._segsum_cuda, splat._splat_cuda, splat3d._splat3d_cuda):
        src = inspect.getsource(fn)
        assert "with on_device(dev):" in src and "stream_handle(dev)" in src
        assert "torch.cuda.device(" not in src


def test_scratch_and_counters_are_cached_per_stream():
    """Scratch is kept per (device, stream) and grown on demand; counters are
    zero when made; dropping a stream's scratch forgets both."""
    from octa_tpu_torch.ops import _cuda

    dev = torch.device("cpu")
    a, b = _cuda.scratch(dev, 7, a=(10, torch.float32), b=(4, torch.int32))
    assert a.numel() == 10 and b.dtype == torch.int32
    assert _cuda.scratch(dev, 7, a=(5, torch.float32))[0] is a
    assert _cuda.scratch(dev, 7, a=(20, torch.float32))[0].numel() == 20
    assert _cuda.scratch(dev, 8, a=(5, torch.float32))[0] is not a
    c = _cuda.counters(dev, 7, 6)
    assert c.dtype == torch.int32 and not bool(c.any())
    c[0] = 1  # a kernel would leave it zero; the cache keeps what it gets
    assert _cuda.counters(dev, 7, 3) is c
    _cuda.drop_scratch(dev, 7)
    _cuda.drop_scratch(dev, 8)
    assert not bool(_cuda.counters(dev, 7, 3).any())
    _cuda.drop_scratch(dev, 7)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from octa_tpu_torch.data import dataset as tds
    from octa_tpu_torch.data import transforms as ttr
    from octa_tpu_torch.tools import seg_data
    from octa_tpu_torch.train import algorithms, cli, engine
    from octa_tpu_torch.utils.config import load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(ROOT, "configs", "config_ves_seg-S.yml"))
    gan = load_config(os.path.join(ROOT, "configs", "config_gan_ves_seg.yml"))
    for call in (lambda: ttr.RngPool(0),
                 lambda: algorithms.define_model(gan, "Train"),
                 lambda: tds.get_dataset(gan, "Train"),
                 lambda: tds.get_dataset(cfg, "Train"),
                 lambda: tds.DataLoader([], device="cuda"),
                 lambda: algorithms.define_model(cfg, "Train"),
                 lambda: engine.train(None, cfg),
                 lambda: seg_data.make_seg_dataset(str(tmp_path / "d")),
                 lambda: cli.main(["--config_file", os.path.join(
                     ROOT, "configs", "config_ves_seg-S.yml")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "d").exists()


def test_profiler_windows_with_dropped_events(monkeypatch):
    """``time_kernels._launches`` takes a window again when the profiler
    dropped some of its events and reads each kernel from a window that held
    whole calls of it; with none, a kernel launched once a call is read from
    the launches the fullest window held (counted as partial), and one
    launched several times a call raises."""
    import types

    from torch.autograd import DeviceType

    from octa_tpu_torch.tools import time_kernels as tk

    windows = []

    class FakeProfile:
        def __init__(self, activities):
            self.held = windows.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [types.SimpleNamespace(device_type=DeviceType.CUDA, name=n,
                                          self_device_time_total=1000.0 * t)
                    for n, ts in self.held.items() for t in ts]

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    whole = {"bin": [1.0] * 4, "splat": [2.0] * 4}
    short = {"bin": [1.0] * 3, "splat": [2.0] * 4}
    windows[:] = [short, whole]
    retaken, partial = tk.WINDOWS["retaken"], tk.WINDOWS["partial"]
    assert tk._launches(lambda: None, reps=4, tries=3) == {
        "bin": (1.0, 1), "splat": (2.0, 1)}
    assert (tk.WINDOWS["retaken"], tk.WINDOWS["partial"]) == (retaken + 1,
                                                             partial)
    # each kernel from the window that held it whole
    windows[:] = [short, {"bin": [1.0] * 4, "splat": [2.0] * 3}]
    assert tk._launches(lambda: None, reps=4, tries=3) == {
        "bin": (1.0, 1), "splat": (2.0, 1)}
    assert tk.WINDOWS["partial"] == partial
    # once a call and never whole: the fullest window's launches
    windows[:] = [short, {}, {"bin": [1.0] * 2, "splat": [2.0] * 3}]
    assert tk._launches(lambda: None, reps=4, tries=3) == {
        "bin": (1.0, 1), "splat": (2.0, 1)}
    assert tk.WINDOWS["partial"] == partial + 1
    # several launches a call at two shapes: whole calls give their mean ...
    twice = {"scan": [1.0, 3.0] * 4}
    windows[:] = [twice]
    assert tk._launches(lambda: None, reps=4, tries=3) == {"scan": (2.0, 2)}
    # ... and a dropped launch leaves no call's mean
    windows[:] = [{"scan": [1.0, 3.0] * 3 + [1.0]}] * 3
    with pytest.raises(RuntimeError, match="several times a call"):
        tk._launches(lambda: None, reps=4, tries=3)
    windows[:] = [{}, {}, {}]
    with pytest.raises(RuntimeError, match="no kernel"):
        tk._launches(lambda: None, reps=4, tries=3)
