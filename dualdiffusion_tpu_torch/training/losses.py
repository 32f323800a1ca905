# Windows and frequency weights copied from dualdiffusion_tpu/training/losses.py; losses on torch.
"""The DAE trainer's losses (JAX: dualdiffusion_tpu/training/losses.py:96-208,
385-406; reference: src/training/loss/multiscale_spectral.py:121-297,
dae_p1_trainer.py:330-371).

* ``MSSLoss2D``: the unfold + rfft2 multi-scale 2-D spectral loss, the DAE
  trainer's default recon loss. It holds the fully unfolded block tensor
  (B, C, nH, nW, bw, bw); ``ops/kernels/mss2d.py`` is the memory-lean fused
  route.
* ``phase_invariance_loss`` and ``latents_dispersion_loss``, the latent
  regularizers.

Layouts: the 2-D losses take (B, C, H, W); latents are (B, H, W, C).
The 1-D, randomized-prime, spectral-regularization, wavelet, DoG and
equivariance losses are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.windows import get_window


def _flat_top(x: np.ndarray) -> np.ndarray:
    return (0.21557895 - 0.41663158 * np.cos(x) + 0.277263158 * np.cos(2 * x)
            - 0.083578947 * np.cos(3 * x) + 0.006947368 * np.cos(4 * x))


def _window_2d(name: str, bw: int) -> np.ndarray:
    if name == "flat_top":
        wx = np.arange(bw) / bw * 2 * np.pi
        w = _flat_top(wx)[:, None] * _flat_top(wx)[None, :]
    elif name == "hann":
        wx = np.arange(bw) / bw * np.pi
        w = (np.sin(wx) ** 2)[:, None] * (np.sin(wx) ** 2)[None, :]
    elif name == "kaiser":
        k = get_window("kaiser", bw, beta=12.0)
        w = k[:, None] * k[None, :]
    elif name == "flat_top_circular":
        c = (np.arange(bw) + 0.5) - bw / 2
        dist = np.sqrt(c[:, None] ** 2 + c[None, :] ** 2) / (bw // 2)
        w = _flat_top(dist * np.pi + np.pi) * (dist <= 1)
    elif name == "none":
        w = np.ones((bw, bw))
    else:
        raise ValueError(f"invalid block window: {name}")
    return (w / np.sqrt((w ** 2).mean())).astype(np.float32)


def product_weights(bw: int) -> np.ndarray:
    """The "product" frequency weighting: (|f_h| + 1)(|f_w| + 1), (bw, bw/2+1)."""
    fh = np.fft.fftfreq(bw, d=1.0 / bw)
    fw = np.fft.rfftfreq(bw, d=1.0 / bw)
    return ((np.abs(fh)[:, None] + 1) * (np.abs(fw)[None, :] + 1)).astype(np.float32)


def unfold_2d(x: torch.Tensor, block: int, step: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, nH, nW, block, block), reflect-padded by block//2."""
    pad = block // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return x.unfold(2, block, step).unfold(3, block, step)


@dataclass
class MSSLoss2DConfig:
    """Field names and defaults of the JAX MSSLoss2DConfig."""
    block_widths: Tuple[int, ...] = (8, 16, 32, 64)
    block_overlap: int = 8
    block_width_weight_exponent: float = 0.0
    block_window_fn: str = "flat_top"
    frequency_weighting: Literal["product", "f^2", "dynamic"] = "product"
    frequency_weight_exponent: float = 1.0
    use_midside_transform: Literal["stack", "cat", "none"] = "stack"
    use_mse_loss: bool = False
    phase_loss_scale: float = 0.0
    abs_loss_scale: float = 1.0


class MSSLoss2D:
    def __init__(self, config: MSSLoss2DConfig) -> None:
        self.config = config
        self.windows = {bw: _window_2d(config.block_window_fn, bw) for bw in config.block_widths}
        self.loss_weights = {}
        for bw in config.block_widths:
            fh = np.fft.fftfreq(bw, d=1.0 / bw)
            fw = np.fft.rfftfreq(bw, d=1.0 / bw)
            if config.frequency_weighting == "product":
                self.loss_weights[bw] = product_weights(bw)
            elif config.frequency_weighting == "f^2":
                self.loss_weights[bw] = (fh[:, None] ** 2 + fw[None, :] ** 2 + 1).astype(np.float32)

    def _stft2d(self, x: torch.Tensor, bw: int, step: int) -> torch.Tensor:
        win = torch.as_tensor(self.windows[bw], device=x.device)
        fft = torch.fft.rfft2(unfold_2d(x, bw, step) * win, norm="ortho")
        ms = self.config.use_midside_transform
        if ms == "stack":
            fft = torch.stack([fft[:, 0] + fft[:, 1], fft[:, 0] - fft[:, 1]], dim=1)
        elif ms == "cat":
            fft = torch.cat([fft, (fft[:, 0:1] + fft[:, 1:2]) * 0.5 ** 0.5,
                             (fft[:, 0:1] - fft[:, 1:2]) * 0.5 ** 0.5], dim=1)
        return fft

    def __call__(self, sample: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) x2 -> per-sample loss (B,)."""
        cfg = self.config
        loss = torch.zeros((target.shape[0],), device=target.device)

        def err(a, b):
            return (a - b) ** 2 if cfg.use_mse_loss else (a - b).abs()

        for bw in cfg.block_widths:
            if bw > target.shape[-1]:
                continue
            step = max(bw // cfg.block_overlap, 1)
            t_fft = self._stft2d(target, bw, step).detach()
            s_fft = self._stft2d(sample, bw, step)
            t_abs = t_fft.abs()
            if cfg.frequency_weighting == "dynamic":
                lw = 1.0 / t_abs.mean(dim=(0, 2, 3), keepdim=True).clamp_min(1e-2)
            else:
                lw = torch.as_tensor(self.loss_weights[bw], device=target.device)
            if cfg.frequency_weight_exponent != 1:
                lw = lw ** cfg.frequency_weight_exponent
            if cfg.block_width_weight_exponent != 0:
                lw = lw * bw ** cfg.block_width_weight_exponent
            block_loss = torch.zeros_like(t_abs)
            if cfg.abs_loss_scale > 0:
                block_loss = err(s_fft.abs(), t_abs) * cfg.abs_loss_scale
            if cfg.phase_loss_scale > 0:
                block_loss = block_loss + (err(s_fft.real, t_fft.real)
                                           + err(s_fft.imag, t_fft.imag)) * cfg.phase_loss_scale
            loss = loss + (block_loss * lw).mean(dim=(1, 2, 3, 4, 5))
        return loss


def latents_dispersion_loss(latents: torch.Tensor, shifts: Sequence[int] = (1,)) -> torch.Tensor:
    """Squared cosine similarity between batch-rolled latents, (B,)."""
    flat = latents.reshape(latents.shape[0], -1)
    flat = flat / (flat.norm(dim=-1, keepdim=True) + 1e-8)
    loss = torch.zeros((latents.shape[0],), device=latents.device)
    for s in shifts:
        loss = loss + (flat * torch.roll(flat, s, dims=0)).sum(dim=-1) ** 2
    return loss / len(shifts)


def phase_invariance_loss(latents_a: torch.Tensor, latents_b: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity of two encodes of the same audio, (B,)."""
    a = latents_a.reshape(latents_a.shape[0], -1)
    b = latents_b.reshape(latents_b.shape[0], -1)
    a = a / (a.norm(dim=-1, keepdim=True) + 1e-8)
    b = b / (b.norm(dim=-1, keepdim=True) + 1e-8)
    return 1.0 - (a * b).sum(dim=-1)
