"""The benchmark of ``octa_tpu_torch``: one command runs one cell once
(``octa_bench/run.py``; see ``README.md``)."""
