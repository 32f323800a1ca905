# Copied from dualdiffusion_tpu/sampling/schedule.py (pure numpy).
"""Named sigma schedules for the EDM sampler.

Capability parity with the reference's SamplingSchedule
(reference: src/sampling/schedule.py:30-79): edm2 (Karras rho), ln_linear,
linear, cos, scale_invariant — plus parameter discovery for UIs. Schedules
are computed host-side in float64 (static trace-time constants).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List

import numpy as np


class SamplingSchedule:

    @staticmethod
    def get_schedule(name: str, steps: int, t_start: float = 1.0, **kwargs) -> np.ndarray:
        fn = getattr(SamplingSchedule, f"schedule_{name}", None)
        if fn is None:
            raise ValueError(f"unknown schedule '{name}'; known: "
                             f"{SamplingSchedule.get_schedules_list()}")
        t = np.linspace(t_start, 0.0, int(steps) + 1)
        return fn(t, **kwargs)

    @staticmethod
    def get_schedule_params(name: str) -> Dict[str, Any]:
        fn = getattr(SamplingSchedule, f"schedule_{name}")
        params = {n: p.annotation for n, p in inspect.signature(fn).parameters.items()}
        for drop in ("t", "_", "sigma_max", "sigma_min"):
            params.pop(drop, None)
        return params

    @classmethod
    def get_schedules_list(cls) -> List[str]:
        return sorted(a.removeprefix("schedule_") for a in dir(cls)
                      if a.startswith("schedule_"))

    @staticmethod
    def schedule_edm2(t, sigma_max: float, sigma_min: float, rho: float = 7.0, **_):
        return (sigma_max ** (1 / rho)
                + (1 - t) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho

    @staticmethod
    def schedule_ln_linear(t, sigma_max: float, sigma_min: float, **_):
        return np.exp(np.log(sigma_min) + (np.log(sigma_max) - np.log(sigma_min)) * t)

    @staticmethod
    def schedule_linear(t, sigma_max: float, sigma_min: float, rho: float = 1.0, **_):
        t = (sigma_max ** (1 / rho) - sigma_min ** (1 / rho)) * t + sigma_min ** (1 / rho)
        return t ** rho

    @staticmethod
    def schedule_cos(t, sigma_max: float, sigma_min: float, rho: float = 1.0, **_):
        theta_max = np.pi / 2 - np.arctan(sigma_max / rho)
        theta_min = np.pi / 2 - np.arctan(sigma_min / rho)
        theta = (1 - t) * (theta_min - theta_max) + theta_max
        return np.cos(theta) / np.sin(theta) * rho

    @staticmethod
    def schedule_scale_invariant(t, sigma_max: float, sigma_min: float, rho: float = 1.0, **_):
        return sigma_min / ((1 - t) ** rho + sigma_min / sigma_max)


def get_schedule(name: str, steps: int, **kwargs) -> np.ndarray:
    return SamplingSchedule.get_schedule(name, steps, **kwargs)
