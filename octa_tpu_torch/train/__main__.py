"""``python -m octa_tpu_torch.train``: the training CLI (``train/cli.py``)."""
from octa_tpu_torch.train.cli import main

main()
