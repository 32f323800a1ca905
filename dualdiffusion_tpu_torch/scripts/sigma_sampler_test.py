"""Sigma-distribution histogram harness (JAX: scripts/sigma_sampler_test.py;
reference: src/tests/sigma_sampler.py:100): text histograms of ln sigma for
each of the six distributions, 20,000 draws each.

Usage: python -m dualdiffusion_tpu_torch.scripts.sigma_sampler_test [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..training.sigma_sampler import SigmaSampler, SigmaSamplerConfig
from . import print_launches, resolve_device

DISTRIBUTIONS = ("ln_normal", "ln_sech", "ln_sech^2", "ln_linear", "linear", "scale_invariant")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Returns the sigmas drawn, by distribution."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {}
    for dist in DISTRIBUTIONS:
        s = SigmaSampler(SigmaSamplerConfig(distribution=dist))
        gen = torch.Generator(device=device).manual_seed(0)
        sig = s.sample(s.draw_quantiles(gen, 20000)).cpu().numpy()
        out[dist] = sig
        hist, edges = np.histogram(np.log(sig), bins=24)
        peak = hist.max()
        print(f"\n{dist}:  sigma in [{sig.min():.4g}, {sig.max():.4g}]  "
              f"median {np.median(sig):.4g}")
        for h, e0, e1 in zip(hist, edges[:-1], edges[1:]):
            print(f"  ln sigma [{e0:+6.2f},{e1:+6.2f}) {'#' * int(40 * h / peak)}")
    print_launches()
    return out


if __name__ == "__main__":
    main()
