"""forward_host_ms.serve: in the sampler's traced steps, the host's
milliseconds inside a ``dd.model.forward`` span, over the forwards."""
from benchmark.yardstick.spans import sampler_spans


def read(run: dict):
    forwards, us = sampler_spans(run, "dd.model.forward")
    return us / forwards / 1e3 if forwards else None
