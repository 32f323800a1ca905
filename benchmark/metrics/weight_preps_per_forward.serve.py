"""weight_preps_per_forward.serve: in the sampler's traced steps, the
``dd.model.weight_prep`` spans (an MP weight re-scaled outside training, or
K1's weights prepared anew) over the ``dd.model.forward`` spans."""
from benchmark.yardstick.spans import sampler_spans


def read(run: dict):
    preps, _ = sampler_spans(run, "dd.model.weight_prep")
    forwards, _ = sampler_spans(run, "dd.model.forward")
    return preps / forwards if forwards else None
