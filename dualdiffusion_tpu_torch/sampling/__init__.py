from .sampler import LOOP_PAD, SampleParams, edm_sample, seamless_loop_crossfade
