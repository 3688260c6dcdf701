"""Dataset construction and the batched, thread-prefetched loader.

Counterpart of ``octa_tpu/data/dataset.py``: ``natsorted`` (:30),
``_resolve_data_paths`` (:38) with split files, ``VesSegDataset`` (:60),
the GAN pairing ``UnalignedZipDataset`` (:83-117), ``collate`` (:120),
``DataLoader`` (:131) with its prefetch thread, its per-epoch shuffle from
``default_rng(seed)`` and its shutdown at exit (:200-216),
``get_post_transformation`` (:219) and ``get_dataset`` (:230-252).

The transforms run in the prefetch thread and launch on the card (K1 and
the noise model). On a CUDA device the loader gives that thread a stream of
its own, so that loading overlaps the training step: the thread records an
event after each batch, and the consumer makes its stream wait on the event
and marks the batch's tensors as used on its stream (``record_stream``)
before it reads them. The kernels' scratch is kept per stream
(``ops/_cuda.py``), so the two threads never share one. Only one prefetch
thread of a loader runs at a time: leaving an iteration early waits for the
thread to finish its batch.
While a profiler session records, each batch's load, render and noise is
the span ``octa.data.batch`` on the loader's thread
(:mod:`octa_tpu_torch.utils.trace`).
"""
from __future__ import annotations

import atexit
import os
import re
import threading
from glob import glob
from queue import Full, Queue
from typing import Any

import numpy as np
import torch

from octa_tpu_torch.data.transforms import (
    Compose,
    RngPool,
    get_data_augmentations,
)
from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.enums import Phase, Task


def natsorted(paths):
    def key(s):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(s))]

    return sorted(paths, key=key)


def _resolve_data_paths(data_settings: dict) -> dict[str, list[str]]:
    data = {}
    for key, val in data_settings.items():
        paths = natsorted(glob(val["files"], recursive=True))
        assert len(paths) > 0, (
            f"Error: Your provided file path {val['files']} for {key} does "
            "not match any files!")
        if "split" in val and val["split"]:
            assert os.path.isfile(val["split"]), (
                f"Error: Your provided split file path {val['split']} for "
                f"{key} does not exist.")
            with open(val["split"]) as f:
                indices = [int(line.rstrip()) for line in f if line.strip()]
            assert max(indices) < len(paths), (
                f"Error: split file for {key} requests index {max(indices)} "
                f"but the dataset only contains {len(paths)} files.")
            paths = np.array(paths)[indices].tolist()
            assert len(paths) > 0
        data[key] = paths
    return data


class VesSegDataset:
    """Paired dataset: every key cycled to the longest list's length."""

    def __init__(self, data: dict[str, list[str]], transform: Compose):
        max_len = max(len(v) for v in data.values())
        self.data = {
            k: np.resize(np.array(v), max_len).tolist() for k, v in data.items()
        }
        self.keys = list(data.keys())
        self.transform = transform
        self.length = max_len

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        item = {}
        for k in self.keys:
            item[k] = self.data[k][i]
            item[k + "_path"] = self.data[k][i]
        return self.transform(item)


class UnalignedZipDataset:
    """GAN pairing (reference ``unalignedZipDataset.py:38-59``): ``real_A``
    and ``real_A_seg`` in order, ``real_B`` and ``background`` drawn per item
    from ``rng`` (the transforms' numpy stream), ``real_B`` first."""

    def __init__(self, data: dict[str, list[str]], transform: Compose,
                 phase, rng: np.random.Generator):
        self.a = data.get("real_A")
        self.a_seg = data.get("real_A_seg")
        self.b = data.get("real_B")
        self.bg = data.get("background")
        self.transform = transform
        self.phase = phase
        self.rng = rng
        self.a_size = len(self.a) if self.a else 0
        self.b_size = len(self.b) if self.b else 0

    def __len__(self):
        return max(self.a_size, self.b_size)

    def __getitem__(self, i):
        item: dict[str, Any] = {}
        if self.a is not None:
            p = self.a[i % self.a_size]
            item["real_A"] = p
            item["real_A_path"] = p
        if self.b is not None:
            ib = int(self.rng.integers(0, self.b_size)) if "real_A" in item else i
            item["real_B"] = self.b[ib]
            item["real_B_path"] = self.b[ib]
        if self.a_seg is not None:
            p = self.a_seg[i % self.a_size]
            item["real_A_seg"] = p
            item["real_A_seg_path"] = p
        if self.bg is not None:
            item["background"] = self.bg[int(self.rng.integers(0, len(self.bg)))]
        return self.transform(item)


def collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack a list of samples: tensors on their device, numpy arrays on the
    host, strings into lists."""
    out: dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        elif torch.is_tensor(vals[0]):
            out[k] = torch.stack(vals)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


def _tensors(batch: dict):
    return [v for v in batch.values() if torch.is_tensor(v)]


class DataLoader:
    """Thread-prefetched batch iterator, shuffled per epoch; on a CUDA
    ``device`` the thread launches on a stream of its own."""

    def __init__(self, dataset, batch_size=1, shuffle=True, seed=0,
                 prefetch=2, drop_last=False, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self._stream = None
        self._worker: threading.Thread | None = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            with trace.span("octa.data.batch"):
                batch = collate([self.dataset[int(i)] for i in sel])
            yield batch

    def _loader_stream(self):
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def __iter__(self):
        if self._worker is not None:
            self._worker.join()
        q: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        stream = self._loader_stream()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def worker():
            try:
                if stream is None:
                    for batch in self._batches():
                        if stop.is_set() or not put((batch, None)):
                            return
                    return
                with torch.cuda.stream(stream):
                    for batch in self._batches():
                        done = torch.cuda.Event()
                        done.record(stream)
                        if stop.is_set() or not put((batch, done)):
                            return
            except BaseException as e:  # surfaced in the consumer
                put((e, None))
            finally:
                put((sentinel, None))

        t = threading.Thread(target=worker, daemon=True)
        self._worker = t
        _LOADER_THREADS.append((stop, t))
        t.start()
        try:
            while True:
                item, done = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for x in _tensors(item):
                        x.record_stream(consumer)
                yield item
        finally:
            stop.set()
            t.join()


_LOADER_THREADS: list = []


def _shutdown_loader_threads():
    """Stop the prefetch threads before the interpreter tears down: a daemon
    thread that dies inside a CUDA call can abort the process at exit."""
    for stop, _ in _LOADER_THREADS:
        stop.set()
    for _, t in _LOADER_THREADS:
        if t.is_alive():
            t.join(timeout=2.0)
    _LOADER_THREADS.clear()


atexit.register(_shutdown_loader_threads)


def get_post_transformation(config: dict, phase, device="cuda"
                            ) -> dict[str, Compose]:
    """Post-processing Composes for prediction and label."""
    aug_config: dict = config[phase]["post_processing"]
    out = {}
    for k, v in (aug_config or {}).items():
        out[k] = Compose(get_data_augmentations(
            v, seed=config["General"].get("seed", 42), device=device))
    return out


def get_dataset(config: dict, phase, batch_size=None, num_workers=None,
                device="cuda") -> DataLoader:
    """The loader of a phase (reference ``image_dataset.py:41-81``); the
    samples are made on ``device``. Train casts ``"dtype"`` to bfloat16 when
    ``General.amp`` is set."""
    task = config["General"]["task"]
    seed = config["General"].get("seed", 42)
    amp = bool(config["General"].get("amp"))
    dtype = torch.bfloat16 if (phase == Phase.TRAIN and amp) else torch.float32
    rng = RngPool(seed, device)
    transform = Compose(get_data_augmentations(
        config[phase]["data_augmentation"], seed, dtype, rng=rng))
    data = _resolve_data_paths(config[phase]["data"])
    if task == Task.GAN_VESSEL_SEGMENTATION and phase != Phase.VALIDATION:
        ds = UnalignedZipDataset(data, transform, phase, rng.np)
    else:
        ds = VesSegDataset(data, transform)
    return DataLoader(
        ds,
        batch_size=batch_size or config[phase].get("batch_size") or 1,
        shuffle=phase != Phase.TEST,
        seed=seed,
        device=device,
    )
