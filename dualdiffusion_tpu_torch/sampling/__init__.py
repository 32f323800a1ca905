from .sampler import SampleParams, edm_sample
