"""Test settings of the benchmark's own tests (``python -m pytest
octa_bench``): the ``card`` marker for tests that need an NVIDIA card,
which decide inside the test whether one is present."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test where "
        "none is present (run them on the card: python -m pytest octa_bench "
        "-m card)")
