"""Several cards, one process each: data parallelism (:mod:`.mesh`) and
height-sharded inference (:mod:`.spatial`), over ``torch.distributed``."""
