# Audio, loudness, safetensors io, tensor_to_img and the numeric helpers copied from
# dualdiffusion_tpu/utils/utils.py:39-330; the PNG encoder is the port's own.
"""Audio io (WAV through scipy; FLAC through a ``flac`` or ``ffmpeg`` binary
on PATH, when there is one), ITU-R BS.1770-4 integrated loudness and its
normalization in numpy, safetensors io (numpy-backed, atomic writes),
previews (``tensor_to_img``, an 8-bit RGB PNG encoder on ``zlib`` (no PIL)
and ``save_img``) and numeric helpers (quantization, mu-law, slerp, fractal
noise).
Reference semantics: src/utils/dual_diffusion_utils.py:236-496.
"""

from __future__ import annotations

import logging
import os
import struct
import shutil
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)


def load_audio(path: Union[str, Path], start: int = 0, count: int = -1,
               return_sample_rate: bool = False):
    """Load ``count`` samples (all with -1) from ``start`` of a WAV or FLAC
    file as a float32 (channels, samples) array; with
    ``return_sample_rate``, (array, sample rate)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        from scipy.io import wavfile
        sr, data = wavfile.read(str(path))
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 1:
            data = data[:, None]
        data = data.T
    elif suffix == ".flac":
        data, sr = _load_flac(path)
    else:
        raise ValueError(f"unsupported audio format: {suffix}")
    if start > 0 or count >= 0:
        end = start + count if count >= 0 else data.shape[-1]
        data = data[:, start:end]
    if return_sample_rate:
        return data, sr
    return data


def _flac_binary() -> Optional[str]:
    for name in ("flac", "ffmpeg"):
        b = shutil.which(name)
        if b:
            return b
    return None


def _load_flac(path: Path) -> Tuple[np.ndarray, int]:
    binary = _flac_binary()
    if binary is None:
        raise RuntimeError("FLAC decoding requires the 'flac' or 'ffmpeg' binary on PATH")
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "out.wav"
        if binary.endswith("ffmpeg"):
            cmd = [binary, "-y", "-i", str(path), str(wav)]
        else:
            cmd = [binary, "-d", "-f", "-o", str(wav), str(path)]
        subprocess.run(cmd, check=True, capture_output=True)
        return load_audio(wav, return_sample_rate=True)


def save_audio(audio: np.ndarray, sample_rate: int, path: Union[str, Path],
               target_lufs: Optional[float] = None) -> None:
    """Save (channels, samples) float audio as 16-bit PCM, gained to
    ``target_lufs`` integrated loudness when given. WAV through scipy; FLAC
    through a ``flac``/``ffmpeg`` binary, or, without one, a WAV beside the
    path asked for (with a warning)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if target_lufs is not None:
        audio = normalize_lufs(audio, sample_rate, target_lufs)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from scipy.io import wavfile
    pcm16 = (np.clip(audio.T, -1.0, 1.0) * 32767.0).astype(np.int16)
    if path.suffix.lower() == ".wav":
        wavfile.write(str(path), sample_rate, pcm16)
        return
    if path.suffix.lower() == ".flac":
        binary = _flac_binary()
        if binary is None:
            wav_path = path.with_suffix(".wav")
            logger.warning("no flac encoder available; wrote %s instead", wav_path)
            wavfile.write(str(wav_path), sample_rate, pcm16)
            return
        with tempfile.TemporaryDirectory() as tmp:
            wav = Path(tmp) / "in.wav"
            wavfile.write(str(wav), sample_rate, pcm16)
            if binary.endswith("ffmpeg"):
                cmd = [binary, "-y", "-i", str(wav), str(path)]
            else:
                cmd = [binary, "-f", "-o", str(path), str(wav)]
            subprocess.run(cmd, check=True, capture_output=True)
        return
    raise ValueError(f"unsupported audio format: {path.suffix}")


def _k_weighting_coeffs(sr: float):
    """Pre-filter (shelving) + RLB high-pass biquads per BS.1770-4 annex 1."""
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array([(Vh + Vb * K / Q + K * K) / a0,
                        2.0 * (K * K - Vh) / a0,
                        (Vh - Vb * K / Q + K * K) / a0])
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
                     (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)])
    b_hp = np.array([1.0, -2.0, 1.0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def get_audio_loudness(audio: np.ndarray, sample_rate: int) -> float:
    """Integrated loudness (LUFS) of (channels, samples) audio, BS.1770-4:
    K-weighting, 400 ms blocks at 75 % overlap, the -70 LUFS absolute gate
    and the -10 LU relative gate."""
    from scipy.signal import lfilter
    audio = np.atleast_2d(np.asarray(audio, dtype=np.float64))
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sample_rate)
    y = lfilter(b2, a2, lfilter(b1, a1, audio, axis=-1), axis=-1)
    block = int(round(0.4 * sample_rate))
    step = max(1, int(round(0.1 * sample_rate)))
    n = y.shape[-1]
    if n < block:
        z = np.mean(y ** 2, axis=-1).sum()
        return float(-0.691 + 10.0 * np.log10(max(z, 1e-12)))
    starts = np.arange(0, n - block + 1, step)
    csum = np.concatenate([np.zeros((y.shape[0], 1)), np.cumsum(y ** 2, axis=-1)], axis=-1)
    zblk = (csum[:, starts + block] - csum[:, starts]) / block  # (C, blocks)
    zsum = zblk.sum(axis=0)  # channel weights 1.0 for L/R
    lblk = -0.691 + 10.0 * np.log10(np.maximum(zsum, 1e-12))
    mask = lblk > -70.0
    if not mask.any():
        return -70.0
    rel_thresh = -0.691 + 10.0 * np.log10(np.maximum(zsum[mask].mean(), 1e-12)) - 10.0
    mask &= lblk > rel_thresh
    if not mask.any():
        return -70.0
    return float(-0.691 + 10.0 * np.log10(np.maximum(zsum[mask].mean(), 1e-12)))


def normalize_lufs(audio: np.ndarray, sample_rate: int,
                   target_lufs: float = -20.0, max_clip: float = 0.15) -> np.ndarray:
    """Gain audio to ``target_lufs`` integrated loudness, then scale down so
    that no peak exceeds 1 + ``max_clip``."""
    loudness = get_audio_loudness(audio, sample_rate)
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    out = np.asarray(audio, dtype=np.float32) * gain
    peak = np.abs(out).max() if out.size else 0.0
    limit = 1.0 + max_clip
    if peak > limit:
        out = out * (limit / peak)
    return out


def load_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    from safetensors.numpy import load_file
    return load_file(str(path))


def load_safetensors_metadata(path: Union[str, Path]) -> Dict[str, str]:
    from safetensors import safe_open
    with safe_open(str(path), framework="numpy") as f:
        return dict(f.metadata() or {})


def save_safetensors(tensors: Dict[str, np.ndarray], path: Union[str, Path],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Atomic safetensors write (copy-on-write temp + rename)."""
    from safetensors.numpy import save_file
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    try:
        save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()},
                  tmp, metadata=metadata)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# visualisation
# ---------------------------------------------------------------------------

def tensor_to_img(x, flip_y: bool = True, colormap: bool = True) -> np.ndarray:
    """Map a 2D/3D tensor to a uint8 image (H, W, 3) for previews.

    Multi-channel inputs are tiled vertically. Reference semantics:
    src/utils/dual_diffusion_utils.py (tensor_to_img).
    """
    x = np.asarray(x, dtype=np.float32)
    while x.ndim > 3:
        x = x.reshape((-1,) + x.shape[-2:]) if x.shape[0] != 1 else x[0]
    if x.ndim == 3:
        x = np.concatenate(list(x), axis=0)
    lo, hi = np.nanmin(x), np.nanmax(x)
    x = (x - lo) / (hi - lo + 1e-8)
    if flip_y:
        x = x[::-1]
    if colormap:
        from .roseus import ROSEUS_LUT
        idx = np.clip((x * 255.0).astype(np.int32), 0, 255)
        return (ROSEUS_LUT[idx] * 255.0).astype(np.uint8)
    g = (x * 255.0).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """A uint8 (H, W, 3) image as PNG file bytes: 8-bit RGB, no interlace,
    one IDAT chunk of zlib-deflated rows, each behind filter byte 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_img(img: np.ndarray, path: Union[str, Path]) -> None:
    """Write a uint8 (H, W, 3) image, or a (H, W) gray one, as a PNG file."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png_bytes(img))


# ---------------------------------------------------------------------------
# misc numeric helpers
# ---------------------------------------------------------------------------

def quantize_tensor(x: np.ndarray, num_levels: int = 256):
    """Uniform per-tensor quantization -> (uint8/uint16 codes, scale, offset)
    (reference: src/utils/dual_diffusion_utils.py:553-570)."""
    lo, hi = float(np.min(x)), float(np.max(x))
    scale = (hi - lo) / max(num_levels - 1, 1) or 1.0
    codes = np.round((x - lo) / scale).astype(np.uint8 if num_levels <= 256 else np.uint16)
    return codes, np.float32(scale), np.float32(lo)


def dequantize_tensor(codes: np.ndarray, scale, offset) -> np.ndarray:
    return codes.astype(np.float32) * np.float32(scale) + np.float32(offset)


def mu_law_encode(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def mu_law_decode(y: np.ndarray, mu: float = 255.0) -> np.ndarray:
    return np.sign(y) * (np.expm1(np.abs(y) * np.log1p(mu))) / mu


def cos_angle(a: np.ndarray, b: np.ndarray) -> float:
    na = np.linalg.norm(a.ravel()) + 1e-12
    nb = np.linalg.norm(b.ravel()) + 1e-12
    return float(np.dot(a.ravel(), b.ravel()) / (na * nb))


def slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation between flattened tensors."""
    omega = np.arccos(np.clip(cos_angle(a, b), -1.0, 1.0))
    so = np.sin(omega)
    if so < 1e-6:
        return a * (1.0 - t) + b * t
    return (np.sin((1.0 - t) * omega) / so) * a + (np.sin(t * omega) / so) * b


def fractal_noise_2d(shape: Tuple[int, int], octaves: int = 6, persistence: float = 0.5,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """1/f-style fractal noise: bilinearly upsampled gaussian octaves, summed
    with weights ``persistence`` ** octave."""
    rng = rng or np.random.default_rng()
    h, w = shape
    out = np.zeros(shape, dtype=np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        up = (g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx) + g[np.ix_(y0, x1)] * (1 - fy) * fx
              + g[np.ix_(y1, x0)] * fy * (1 - fx) + g[np.ix_(y1, x1)] * fy * fx)
        out += amp * up
        total += amp
        amp *= persistence
    return out / total
