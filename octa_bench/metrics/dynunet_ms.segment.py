"""Device milliseconds of the upsample and DynUNet stage
(``AdaptSegment.segment``) a request, between CUDA events, mean over the
traced run's requests."""


def read(rec):
    ms = rec.get("dynunet_ms") or []
    return sum(ms) / len(ms) if ms else None
