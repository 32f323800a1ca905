# Audio and safetensors io copied from dualdiffusion_tpu/utils/utils.py: WAV only, no loudness normalization.
"""WAV audio io through scipy, and safetensors io (numpy-backed, atomic
writes). Reference semantics: src/utils/dual_diffusion_utils.py:236-496.
FLAC and loudness normalization are not ported.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np


def load_audio(path: Union[str, Path], start: int = 0, count: int = -1) -> np.ndarray:
    """Load ``count`` samples (all with -1) from ``start`` of a WAV file as a
    float32 (channels, samples) array."""
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise NotImplementedError(f"audio format {path.suffix!r} is not ported (WAV only)")
    from scipy.io import wavfile
    _, data = wavfile.read(str(path))
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
    if start > 0 or count >= 0:
        end = start + count if count >= 0 else data.shape[-1]
        data = data[:, start:end]
    return data


def save_audio(audio: np.ndarray, sample_rate: int, path: Union[str, Path]) -> None:
    """Save (channels, samples) float audio as 16-bit PCM WAV."""
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise NotImplementedError(f"audio format {path.suffix!r} is not ported (WAV only)")
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    path.parent.mkdir(parents=True, exist_ok=True)
    from scipy.io import wavfile
    pcm16 = (np.clip(audio.T, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(str(path), sample_rate, pcm16)


def load_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    from safetensors.numpy import load_file
    return load_file(str(path))


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
