"""latent_sampler_s: seconds per clip of the latent sampler stage
(``Pipeline.generate``'s own "sampler" timing), median over the traced
run's window."""
from benchmark.yardstick.readers import per_clip_stage


def read(run: dict):
    return per_clip_stage(run, ["sampler"])
