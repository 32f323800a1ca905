# Safetensors io copied from dualdiffusion_tpu/utils/utils.py (numpy-backed, atomic writes).
"""Safetensors io (numpy-backed, atomic writes).

Reference semantics: src/utils/dual_diffusion_utils.py:444-496.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np


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
