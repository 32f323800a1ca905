"""audio_decode_s: seconds per clip of the stages after the latent sampler
(the DAE decode, then Griffin-Lim, or the DDEC and the inverse MDCT), from
``Pipeline.generate``'s own timings, median over the traced run's window."""
from benchmark.yardstick.readers import per_clip_stage


def read(run: dict):
    stages = (["dae_decode", "fgla"] if run["traffic"]["decode_mode"] == "fgla"
              else ["dae_decode", "ddec", "mdct_to_raw"])
    return per_clip_stage(run, stages)
