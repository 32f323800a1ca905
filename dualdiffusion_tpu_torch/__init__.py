"""dualdiffusion_tpu_torch: the PyTorch + CUDA port of dualdiffusion_tpu.

The serving slice runs end to end: EDM sampling over the MP-UNet, DAE
decode to a mel spectrogram, and mel unscale + Griffin-Lim to audio. Its
two hot kernel families (the grouped 3x3 conv and the Griffin-Lim
iteration) are hand-written CUDA C++ under ``csrc/``, built at first use.
The package imports torch, numpy and safetensors only.
"""
