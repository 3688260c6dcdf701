"""The port stands alone at run time, and its entry points never fall back
to the CPU.

``octa_tpu_torch`` and ``chip_smoke.py`` run on a host with PyTorch, numpy
and the CUDA toolkit only: an AST scan shows that none of their modules
imports JAX, flax, the JAX package, yaml, PIL or msgpack. Entry points
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "octa_tpu", "yaml", "PIL",
             "msgpack"}


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
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, f"forbidden imports: {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import octa_tpu_torch.pipeline, chip_smoke; "
            "bad = [m for m in ('jax', 'flax', 'octa_tpu', 'yaml', 'msgpack') "
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
    assert resolve_device("cpu") == torch.device("cpu")


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
