# Windows, weights and prime tables copied from dualdiffusion_tpu/training/losses.py.
"""The training loss library (JAX: dualdiffusion_tpu/training/losses.py;
reference: src/training/loss/, dae_p1_trainer.py, dae_trainer_m1.py).

* ``MSSLoss1D``: multi-window STFT magnitude L1 and a magnitude- and
  mel-weighted, wrap-aware phase loss on audio (B, C, T).
* ``MSSLoss2D``: the unfold + rfft2 multi-scale 2-D spectral loss, the DAE
  trainer's default recon loss. It holds the fully unfolded block tensor
  (B, C, nH, nW, bw, bw); ``ops/kernels/mss2d.py`` is the memory-lean fused
  route.
* ``random_prime_mss_2d``: the p1 trainer's randomized-prime-block 2-D MSS.
  Its block-size sets are drawn on the host from ``seed`` (numpy, so both
  packages hold the same sets); which set, the offsets and the mid/side
  flags are draws the caller passes in (``draw_random_prime_mss``).
* ``prime_mss_1d``: the m1 trainer's prime-width 1-D MSS.
* ``spec_reg_loss``, ``wavelet_loss``, ``dog_loss_2d``, ``kl_to_unit_loss``,
  ``vicreg_regularization``, ``phase_invariance_loss``,
  ``latents_dispersion_loss`` and ``equivariance_loss`` (the latent
  shift-equivariance penalty, its crop offsets passed in).

None of these reaches a TPU kernel in the JAX package; they run on
``torch.fft`` and ``ops/stft.py``. Layouts: audio losses take (B, C, T); the
2-D spectral losses (B, C, H, W); latents, wavelet and DoG losses are
channel-last (B, H, W, C).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Literal, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import mp
from ..models.layers import _sep_conv_axis, filtered_downsample_2d, filtered_upsample_2d
from ..ops.mel import mel_density
from ..ops.stft import frame_signal, stft
from ..ops.windows import get_window


def _same(t: torch.Tensor) -> torch.Tensor:
    """A batch statistic as it is: the global batch is this one."""
    return t


# ---------------------------------------------------------------------------
# 1-D multi-scale spectral loss
# ---------------------------------------------------------------------------

@dataclass
class MSSLoss1DConfig:
    """Field names and defaults of the JAX MSSLoss1DConfig."""
    block_widths: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096,
                                     8192, 16384, 32768)
    block_overlap: int = 2
    sample_rate: float = 32000
    loss_scale: float = 1.0


class MSSLoss1D:
    """STFT magnitude L1 at every block width up to the signal's length, and a
    wrap-aware phase error weighted by the target's magnitude above its
    per-frame minimum and the mel density of each bin."""

    def __init__(self, config: MSSLoss1DConfig) -> None:
        self.config = config
        self.windows = {}
        self.loss_weights = {}
        for bw in config.block_widths:
            self.windows[bw] = get_window("hann", bw, periodic=True)
            freqs = np.fft.rfftfreq(bw) * config.sample_rate
            w = np.asarray(mel_density(freqs), np.float64)
            self.loss_weights[bw] = (w / w.max() / np.pi).astype(np.float32)

    def __call__(self, sample: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, T) -> (abs_loss (B,), phase_loss (B,))."""
        cfg = self.config
        loss = torch.zeros((target.shape[0],), device=target.device)
        phase_loss = torch.zeros_like(loss)
        for bw in cfg.block_widths:
            if bw > target.shape[-1]:
                continue
            hop = max(bw // cfg.block_overlap, 1)
            win = self.windows[bw] / np.sqrt((self.windows[bw] ** 2).sum())
            t_fft = stft(target.detach(), win, bw, hop)
            s_fft = stft(sample, win, bw, hop)
            t_abs = t_fft.abs()
            lw = torch.as_tensor(self.loss_weights[bw], device=target.device)
            loss = loss + (s_fft.abs() - t_abs).abs().mean(dim=(1, 2, 3))
            perr = (torch.angle(s_fft) - torch.angle(t_fft)).abs()
            perr = torch.where(perr > np.pi, 2 * np.pi - perr, perr)
            plw = (t_abs - t_abs.amin(dim=-1, keepdim=True)) * lw
            phase_loss = phase_loss + (perr * plw.detach()).mean(dim=(1, 2, 3))
        return loss * cfg.loss_scale, phase_loss * cfg.loss_scale


# ---------------------------------------------------------------------------
# 2-D multi-scale spectral loss
# ---------------------------------------------------------------------------

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

    def __call__(self, sample: torch.Tensor, target: torch.Tensor,
                 batch_mean: Callable = _same) -> torch.Tensor:
        """(B, C, H, W) x2 -> per-sample loss (B,). ``batch_mean`` takes a
        statistic over this batch to one over the global batch (the data
        axis's ``mean_of``), for the "dynamic" frequency weights."""
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
                lw = 1.0 / batch_mean(t_abs.mean(dim=(0, 2, 3), keepdim=True)).clamp_min(1e-2)
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


def latents_dispersion_loss(latents: torch.Tensor, shifts: Sequence[int] = (1,),
                            axis=None) -> torch.Tensor:
    """Squared cosine similarity between batch-rolled latents, (B,). With
    ``axis`` (the data axis) the roll runs over the global batch, gathered
    with its gradient, and this rank's rows are returned."""
    if axis is not None:
        return axis.share(latents_dispersion_loss(axis.gather(latents), shifts))
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


# ---------------------------------------------------------------------------
# randomized-prime 2-D MSS (the p1 trainer's recon loss)
# ---------------------------------------------------------------------------

PRIME_BLOCKS = (9, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
                67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127,
                131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191,
                193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251)


def _flat_top_window_rect(bh: int, bw: int) -> np.ndarray:
    xh = np.arange(bh) / bh * 2 * np.pi
    xw = np.arange(bw) / bw * 2 * np.pi
    w = _flat_top(xh)[:, None] * _flat_top(xw)[None, :]
    return (w / np.sqrt((w ** 2).mean())).astype(np.float32)


def _draw_prime_sizes(rng: np.random.Generator, n: int, max_h: int, max_w: int) -> list:
    """n rectangular (bh, bw) prime block sizes, ln-linear weighted, capped at
    the image (reference: dae_p1_trainer.py:179-194)."""
    blocks = np.asarray(PRIME_BLOCKS)
    ln_w = 1.0 / np.log(blocks)
    p = ln_w / ln_w.sum()
    bh = np.minimum(rng.choice(blocks, size=n, p=p), max_h)
    bw = np.minimum(rng.choice(blocks, size=n, p=p), max_w)
    return [(int(h), int(w)) for h, w in zip(bh, bw)]


@functools.lru_cache(maxsize=16)
def prime_size_sets(h: int, w: int, num_iterations: int = 16, seed: int = 0,
                    num_size_sets: int = 4) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The block-size sets of an (h, w) image, drawn on the host from
    ``seed`` as the JAX package draws them, so both packages hold the same."""
    rng = np.random.default_rng(seed)
    return tuple(tuple(_draw_prime_sizes(rng, num_iterations, h, w))
                 for _ in range(max(num_size_sets, 1)))


@dataclass
class PrimeMSSDraws:
    """One call's draws: which size set, each iteration's block offset
    (oh, ow) and mid/side flag."""
    set_index: int
    offsets: List[Tuple[int, int]]
    midside: List[bool]


def draw_random_prime_mss(generator: torch.Generator, h: int, w: int,
                          num_iterations: int = 16, seed: int = 0,
                          num_size_sets: int = 4) -> PrimeMSSDraws:
    """The draws of one ``random_prime_mss_2d`` call, from ``generator``
    (read back to the host at once: the offsets slice the images)."""
    sets = prime_size_sets(h, w, num_iterations, seed, num_size_sets)
    u = torch.rand((1 + 3 * num_iterations,), generator=generator,
                   device=generator.device).tolist()
    idx = min(int(u[0] * len(sets)), len(sets) - 1)
    offsets, flags = [], []
    for i, (bh, bw) in enumerate(sets[idx]):
        uh, uw, um = u[1 + 3 * i: 4 + 3 * i]
        offsets.append((min(int(uh * (max(h - bh, 0) + 1)), max(h - bh, 0)),
                        min(int(uw * (max(w - bw, 0) + 1)), max(w - bw, 0))))
        flags.append(um < 0.5)
    return PrimeMSSDraws(idx, offsets, flags)


def random_prime_mss_2d(sample: torch.Tensor, target: torch.Tensor, draws: PrimeMSSDraws,
                        num_iterations: int = 16, use_midside: bool = True,
                        seed: int = 0, num_size_sets: int = 4) -> torch.Tensor:
    """Randomized-prime-block 2-D MSS (reference: dae_p1_trainer.py:85-213):
    for each block size of the drawn set, the flat-top-windowed ortho
    ``rfft2`` of ONE block at the drawn offset (mid/side where drawn), and
    the target-energy-normalized squared error. (B, C, H, W) x2 -> (B,)."""
    h, w = target.shape[-2], target.shape[-1]
    sizes = prime_size_sets(h, w, num_iterations, seed, num_size_sets)[draws.set_index]
    loss = torch.zeros((target.shape[0],), device=target.device)
    for (bh, bw), (oh, ow), ms in zip(sizes, draws.offsets, draws.midside):
        win = torch.as_tensor(_flat_top_window_rect(bh, bw), device=target.device)

        def spec(x):
            xs = x[:, :, oh:oh + bh, ow:ow + bw]
            if use_midside and ms:
                xs = mp.midside_transform(xs, channel_dim=1)
            return torch.fft.rfft2(xs * win, norm="ortho")

        t_fft = spec(target).detach()
        d = spec(sample) - t_fft
        t_energy = (t_fft.real.square() + t_fft.imag.square()).mean(dim=(1, 2, 3)) + 1e-8
        err = (d.real.square() + d.imag.square()).mean(dim=(1, 2, 3))
        loss = loss + err / t_energy
    return loss / num_iterations


# ---------------------------------------------------------------------------
# spectral regularization, wavelet, DoG
# ---------------------------------------------------------------------------

def spec_reg_loss(latents: torch.Tensor, target_profile: torch.Tensor,
                  kind: Literal["l1", "mse", "kl"] = "l1") -> torch.Tensor:
    """The latents' normalized ``rfft2`` magnitude against a target spectral
    profile (reference: spectral_regularization.py:41-103). latents
    (B, C, H, W); ``target_profile`` broadcastable to the magnitude."""
    mag = torch.fft.rfft2(latents.float(), norm="ortho").abs()
    mag = mag / (mag.mean(dim=(-2, -1), keepdim=True) + 1e-8)
    tp = target_profile / (target_profile.mean(dim=(-2, -1), keepdim=True) + 1e-8)
    if kind == "l1":
        return (mag - tp).abs().mean(dim=(1, 2, 3))
    if kind == "mse":
        return (mag - tp).square().mean(dim=(1, 2, 3))
    if kind == "kl":
        p = mag / (mag.sum(dim=(-2, -1), keepdim=True) + 1e-12)
        q = tp / (tp.sum(dim=(-2, -1), keepdim=True) + 1e-12)
        return (p * (torch.log(p + 1e-12) - torch.log(q + 1e-12))).sum(dim=(1, 2, 3))
    raise ValueError(kind)


def wavelet_loss(sample: torch.Tensor, target: torch.Tensor, num_levels: int = 4,
                 level_exponent: float = 1.0, use_midside: bool = False) -> torch.Tensor:
    """Per-level L1 of Laplacian pyramids weighted 4^(-i e) (reference:
    wavelet.py:39-84). Channel-last (B, H, W, C) -> (B,)."""
    if use_midside:
        sample = mp.midside_transform(sample, channel_dim=-1)
        target = mp.midside_transform(target, channel_dim=-1)
    sw = mp.wavelet_decompose_2d(sample, num_levels)
    tw = mp.wavelet_decompose_2d(target.detach(), num_levels)
    loss = torch.zeros((target.shape[0],), device=target.device)
    for i, (s, t) in enumerate(zip(sw, tw)):
        loss = loss + 4.0 ** (-i * level_exponent) * (s - t).abs().mean(
            dim=tuple(range(1, s.dim())))
    return loss


def _gaussian_kernel_1d(size: int, sigma: Optional[float] = None) -> np.ndarray:
    sigma = sigma or (size / 6.0)
    x = np.arange(size) - (size - 1) / 2
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _blur_2d(x: torch.Tensor, size: int) -> torch.Tensor:
    k = _gaussian_kernel_1d(size)
    return _sep_conv_axis(_sep_conv_axis(x, k, -2, 1), k, -3, 1)


def dog_loss_2d(sample: torch.Tensor, target: torch.Tensor, logvars: torch.Tensor,
                kernel_sizes: Sequence[int] = (3, 7, 11, 15, 19, 23, 27)) -> torch.Tensor:
    """Difference-of-gaussians pyramid NLL with a learned logvar per scale
    (reference: difference_of_gaussians.py:31-90). Channel-last (B, H, W, C);
    ``logvars`` (len(kernel_sizes) + 1,). Returns (B,)."""
    losses = []
    s_prev, t_prev = sample, target.detach()
    for size in kernel_sizes:
        s_blur, t_blur = _blur_2d(s_prev, size), _blur_2d(t_prev, size)
        losses.append(((s_prev - s_blur) - (t_prev - t_blur)).square().mean(dim=(1, 2, 3)))
        s_prev, t_prev = s_blur, t_blur
    losses.append((s_prev - t_prev).square().mean(dim=(1, 2, 3)))
    total = torch.zeros_like(losses[0])
    for i, l in enumerate(losses):
        total = total + l / torch.exp(logvars[i]) + logvars[i]
    return total


# ---------------------------------------------------------------------------
# latent regularizers
# ---------------------------------------------------------------------------

def kl_to_unit_loss(latents: torch.Tensor, mean_penalty: float = 1.0) -> torch.Tensor:
    """KL(N(mu, var) || N(0, 1)) per sample over (H, W), with an extra mean
    penalty (reference: dae_p1_trainer.py:373-383). (B, H, W, C) -> (B,)."""
    mu = latents.mean(dim=(1, 2))
    var = latents.var(dim=(1, 2), correction=0) + 1e-8
    return (0.5 * (mu.square() * mean_penalty + var - torch.log(var) - 1.0)).mean(dim=-1)


def vicreg_regularization(latents: torch.Tensor, variance_weight: float = 1.0,
                          covariance_weight: float = 1.0, gamma: float = 1.0) -> torch.Tensor:
    """VICReg-style hinge variance plus off-diagonal covariance over the
    first 512 latent dims (reference: dae_p1_trainer.py:35-69). Scalar."""
    b = latents.shape[0]
    z = latents.reshape(b, -1).float()
    z = z - z.mean(dim=0, keepdim=True)
    std = torch.sqrt(z.var(dim=0, correction=0) + 1e-4)
    var_loss = torch.clamp(gamma - std, min=0.0).mean()
    d = min(z.shape[1], 512)
    zc = z[:, :d]
    cov = (zc.t() @ zc) / max(b - 1, 1)
    off = cov - torch.diag(torch.diag(cov))
    return var_loss * variance_weight + off.square().sum() / d * covariance_weight


# ---------------------------------------------------------------------------
# latent shift-equivariance
# ---------------------------------------------------------------------------

@dataclass
class EquivarianceLossConfig:
    """Field names and defaults of the JAX EquivarianceLossConfig."""
    levels: int = 4            # latent upsample factor = 2**(levels-1)
    filter_beta: float = 1.5
    filter_k_size: int = 7
    crop_range: int = 8


def _crop_per_sample(t: torch.Tensor, yo: Sequence[int], xo: Sequence[int],
                     crop: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H-crop, W-crop, C) at each sample's (yo, xo)."""
    h, w = t.shape[1] - crop, t.shape[2] - crop
    return torch.stack([t[i, y:y + h, x:x + w] for i, (y, x) in enumerate(zip(yo, xo))])


def draw_equivariance_offsets(generator: torch.Generator, b: int, crop_range: int = 8
                              ) -> Tuple[List[int], List[int]]:
    """Each sample's crop offsets (yo, xo) in [1, crop_range], on the host."""
    yx = torch.randint(1, crop_range + 1, (2, b), generator=generator,
                       device=generator.device).tolist()
    return yx[0], yx[1]


def equivariance_loss(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                      mel_spec: torch.Tensor, latents: torch.Tensor,
                      offsets: Tuple[Sequence[int], Sequence[int]],
                      config: EquivarianceLossConfig = EquivarianceLossConfig()
                      ) -> torch.Tensor:
    """Latent shift-equivariance (reference: loss/equivariance.py:63-101):
    the mel cropped at each sample's ``offsets`` (yo, xo) and re-encoded,
    against the original latents filter-upsampled, cropped at the same
    offsets and filter-downsampled back (the sub-latent-pixel shifted
    latents, without gradient). The re-encoded latents are re-standardized
    to the target's mean and std with their own statistics detached, as the
    reference does. mel_spec (B, F, T, C); latents (B, F/2**(levels-1),
    T/2**(levels-1), C'). Returns (B,)."""
    cfg = config
    yo, xo = offsets
    cr = cfg.crop_range
    mel_c = _crop_per_sample(mel_spec, yo, xo, cr)
    up = latents
    for _ in range(cfg.levels - 1):
        up = filtered_upsample_2d(up, cfg.filter_k_size * 2 + cfg.filter_k_size % 2,
                                  cfg.filter_beta)
    down = _crop_per_sample(up, yo, xo, cr)
    for _ in range(cfg.levels - 1):
        down = filtered_downsample_2d(down, cfg.filter_k_size, cfg.filter_beta)
    down = down.detach()
    lat2 = encode_fn(mel_c).float()
    ax = (1, 2, 3)
    s2 = lat2.std(dim=ax, keepdim=True, correction=0).detach()
    m2 = lat2.mean(dim=ax, keepdim=True).detach()
    lat2 = (lat2 / s2 * down.std(dim=ax, keepdim=True, correction=0)
            - m2 + down.mean(dim=ax, keepdim=True))
    return (lat2 - down).abs().mean(dim=ax)


# ---------------------------------------------------------------------------
# prime-width 1-D MSS (the m1 trainer's MDCT-domain term)
# ---------------------------------------------------------------------------

PRIME_BLOCK_WIDTHS_1D = (31, 53, 83, 137, 223, 359, 577, 937, 1511, 2447,
                         3967, 6397)
PRIME_BLOCK_STEPS_1D = (7, 11, 17, 29, 47, 79, 127, 211, 337, 547, 887, 1433)


@functools.lru_cache(maxsize=32)
def _flat_top_window_1d(n: int) -> np.ndarray:
    """Periodic flat-top window on (k+0.5)/n, RMS-normalized
    (reference: dae_trainer_m1.py:159-167)."""
    x = (np.arange(n) + 0.5) / n * 2.0 * np.pi
    w = (0.21557895 - 0.41663158 * np.cos(x) + 0.277263158 * np.cos(2 * x)
         - 0.083578947 * np.cos(3 * x) + 0.006947368 * np.cos(4 * x))
    return (w / np.sqrt(np.mean(w ** 2))).astype(np.float32)


def prime_mss_1d(sample: torch.Tensor, target: torch.Tensor,
                 block_widths: Tuple[int, ...] = PRIME_BLOCK_WIDTHS_1D,
                 block_steps: Tuple[int, ...] = PRIME_BLOCK_STEPS_1D,
                 batch_mean: Callable = _same) -> torch.Tensor:
    """Prime-width 1-D multi-scale spectral loss (reference:
    dae_trainer_m1.py:136-208): reflect-pad by the widest block's half, then
    for each (width, step) the flat-top-windowed frames' ortho ``rfft2`` over
    (frame, within-frame) and the squared magnitude error, each bin weighted
    by width / rms(target), the rms over the global batch through
    ``batch_mean`` (as in ``MSSLoss2D``). (B, C, T) x2 -> (B,)."""
    from ..ops.stft import reflect_pad
    pad = block_widths[-1] // 2
    s = reflect_pad(sample.float(), pad)
    t = reflect_pad(target.float(), pad).detach()
    loss = torch.zeros((target.shape[0],), device=target.device)
    for bw, step in zip(block_widths, block_steps):
        win = torch.as_tensor(_flat_top_window_1d(bw), device=target.device)

        def fft2_abs(x):
            return torch.fft.rfft2(frame_signal(x, bw, step) * win, norm="ortho").abs()

        t_abs = fft2_abs(t).detach()
        w = bw / torch.sqrt(batch_mean(t_abs.square().mean(dim=(0, 1, 2), keepdim=True)
                                       ).clamp_min(1e-5))
        loss = loss + ((fft2_abs(s) - t_abs).square() * w).mean(dim=(1, 2, 3))
    return loss
