"""dualdiffusion_tpu_torch: the PyTorch + CUDA port of dualdiffusion_tpu.

The slices that run end to end: serving (EDM sampling over the MP-UNet,
DAE decode to a mel spectrogram, mel unscale + Griffin-Lim or the DDEC
decoder to audio) with its generation options (img2img, inpainting, seamless
loops, post-hoc EMAs, prompt embeddings; ``python -m
dualdiffusion_tpu_torch.sample``), the dataset factory that encodes audio
into latents (``python -m dualdiffusion_tpu_torch.dataset_process``), UNet
training on those latents, and DAE and DDEC training on audio. Their hot
kernels (the grouped 3x3 conv and its backward, the Griffin-Lim iteration,
the fused 2-D multi-scale spectral loss and its gradient) are hand-written
CUDA C++ under ``csrc/``, built at first use. The package imports torch,
numpy, scipy and safetensors (and ``transformers`` only to load CLAP
weights, when they are present).
"""
