"""dualdiffusion_tpu_torch: the PyTorch + CUDA port of dualdiffusion_tpu.

Three slices run end to end: serving (EDM sampling over the MP-UNet, DAE
decode to a mel spectrogram, mel unscale + Griffin-Lim to audio), UNet
training on pre-encoded latents, and DAE training on audio. Their hot
kernels (the grouped 3x3 conv and its backward, the Griffin-Lim iteration,
the fused 2-D multi-scale spectral loss and its gradient) are hand-written
CUDA C++ under ``csrc/``, built at first use. The package imports torch,
numpy, scipy and safetensors only.
"""
