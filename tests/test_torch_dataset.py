"""Port parity: path resolution, the dataset, collation and the prefetching
loader of ``octa_tpu_torch.data.dataset`` against ``octa_tpu.data.dataset``.
"""
import threading

import numpy as np
import pytest
import torch

from octa_tpu.data import dataset as jd
from octa_tpu_torch.data import dataset as td
from octa_tpu_torch.data.transforms import Compose
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase


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


def test_natsorted():
    names = ["img10.png", "img2.png", "a1b20", "a1b3", "img1.png", "b"]
    assert td.natsorted(names) == jd.natsorted(names)
    assert td.natsorted(names)[:2] == ["a1b3", "a1b20"]


def test_resolve_paths_with_split(tmp_path):
    for i in range(12):
        (tmp_path / f"f{i}.csv").write_text("x")
    split = tmp_path / "split.txt"
    split.write_text("3\n0\n11\n\n")
    cfg = {"image": {"files": str(tmp_path / "*.csv"), "split": str(split)},
           "label": {"files": str(tmp_path / "f1*.csv")}}
    out = td._resolve_data_paths(cfg)
    assert out == jd._resolve_data_paths(cfg)
    assert [p.rsplit("/", 1)[1] for p in out["image"]] == ["f3.csv", "f0.csv",
                                                           "f11.csv"]
    with pytest.raises(AssertionError, match="does not match any files"):
        td._resolve_data_paths({"x": {"files": str(tmp_path / "*.png")}})
    split.write_text("12\n")
    with pytest.raises(AssertionError, match="requests index 12"):
        td._resolve_data_paths(cfg)


class _Index:
    """A dataset whose samples name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "t": torch.tensor([i]), "path": f"p{i}"}


@pytest.mark.parametrize("batch,drop", [(4, False), (3, True)])
def test_loader_order_matches_jax(batch, drop):
    ours = td.DataLoader(_Index(10), batch, seed=7, drop_last=drop,
                         device="cpu")
    ref = jd.DataLoader(_Index(10), batch, seed=7, drop_last=drop)
    assert len(ours) == len(ref)
    for _ in range(3):  # a new shuffle every epoch, from the same stream
        got = [b["i"].tolist() for b in ours]
        assert got == [b["i"].tolist() for b in ref]
    b = next(iter(td.DataLoader(_Index(5), 2, shuffle=False, device="cpu")))
    assert torch.equal(b["t"], torch.tensor([[0], [1]])) and b["path"] == ["p0", "p1"]


def test_collate():
    s = [{"x": torch.ones(2, 3) * i, "n": np.ones(2) * i, "p": str(i)}
         for i in range(3)]
    out = td.collate(s)
    assert out["x"].shape == (3, 2, 3) and torch.is_tensor(out["x"])
    assert isinstance(out["n"], np.ndarray) and out["n"].shape == (3, 2)
    assert out["p"] == ["0", "1", "2"]


def test_loader_stops_its_thread():
    loader = td.DataLoader(_Index(40), 2, prefetch=2, device="cpu")
    it = iter(loader)
    next(it)
    assert loader._worker in threading.enumerate()
    it.close()  # leaving early joins the prefetch thread
    assert not loader._worker.is_alive()
    assert loader._worker not in threading.enumerate()

    class Boom(_Index):
        def __getitem__(self, i):
            raise ValueError("bad sample")

    with pytest.raises(ValueError, match="bad sample"):
        list(td.DataLoader(Boom(4), 2, device="cpu"))
    td._shutdown_loader_threads()
    assert not td._LOADER_THREADS


def test_get_dataset_on_self_made_data(tmp_path):
    globs = make_seg_dataset(str(tmp_path), n_graphs=3, n_backgrounds=2,
                             n_val=1, background_res=40, val_res=48,
                             device="cpu", max_edges=120)
    cfg = point_config_at(load_config("configs/config_ves_seg-S.yml"), globs,
                          str(tmp_path / "runs"))
    aug = cfg["Train"]["data_augmentation"]
    aug[1]["image_resolutions"] = [[32, 32], [48, 48]]
    aug[4]["spatial_size"] = [32, 32]
    aug[6]["spatial_size"] = [48, 48]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [48, 48]
    train = td.get_dataset(cfg, Phase.TRAIN, device="cpu")
    assert len(train) == 1 and train.batch_size == 4
    batch = next(iter(train))
    assert batch["image"].shape == (3, 1, 48, 48)
    assert batch["image"].dtype == torch.bfloat16  # amp: "dtype" is bf16
    assert len(batch["background_path"]) == 3
    val = next(iter(td.get_dataset(cfg, Phase.VALIDATION, device="cpu")))
    assert val["image"].dtype == torch.float32 and val["label"].shape == (1, 1, 48, 48)
    post = td.get_post_transformation(cfg, Phase.VALIDATION, device="cpu")
    assert set(post) == {"prediction", "label"}
    cfg["General"]["task"] = "gan-ves-seg"
    with pytest.raises(NotImplementedError, match="GAN"):
        td.get_dataset(cfg, Phase.TRAIN, device="cpu")
