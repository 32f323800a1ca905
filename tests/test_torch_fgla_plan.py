"""K2's pass schedule (``fgla_plan``) and a float64 numpy model of the Hopper
kernel (csrc/fgla_frame_hopper.cu) that follows its index mapping: the
16-byte staging of a frame, each pass's loads, twiddle exponents and
write-back into the padded shared buffer, the real-FFT split, the spectral
step, the merge and the inverse passes. The model is held against
``numpy.fft`` and against ``fgla_frame_plain`` in float64 to 1e-9, and its
shared-memory addresses are counted for bank conflicts. CPU only.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch.ops.kernels import fgla_frame_plain, fgla_plan
from dualdiffusion_tpu_torch.ops.kernels.fgla_frame import SMEM_PAD_EVERY

HOPPER_N = (6400, 4096)


def slot(e):
    return e + e // SMEM_PAD_EVERY


def buffer_slots(m):
    """Complex slots of one frame's buffer (rounded up to 16 bytes)."""
    return (m + m // SMEM_PAD_EVERY + 1) & ~1


def table(n):
    """The wrapper's twiddle table: exp(-2 pi i t / n), t < n."""
    return np.exp(-2j * np.pi * np.arange(n) / n)


def passes(plan, m):
    """(R, PP, table stride) of each pass: PP is the product of the radices
    before it; its twiddles are table(2m)[stride * j * k]."""
    out, pp = [], 1
    for r in plan.radices:
        out.append((r, pp, 2 * m // (pp * r)))
        pp *= r
    return out


def pass_indices(plan, m, r, pp):
    """Per (thread t, butterfly u): butterfly i, k = i mod PP, the source
    points (i + j m/R) and destinations ((i - k) R + k + q PP)."""
    t = np.arange(plan.threads)[:, None]
    u = np.arange(plan.points // r)[None, :]
    i = t + plan.threads * u
    k = i % pp
    j = np.arange(r)
    src = i[..., None] + j * (m // r)
    dst = ((i - k) * r + k)[..., None] + j * pp
    return i, k, src, dst


def fft_model(buf, plan, m, inverse):
    """The kernel's three passes on one frame's padded buffer (in place)."""
    tw = table(2 * m)
    sign = 1.0 if inverse else -1.0
    for r, pp, stride in passes(plan, m):
        _, k, src, dst = pass_indices(plan, m, r, pp)
        v = buf[slot(src)]
        j = np.arange(r)
        w = tw[stride * j * k[..., None]]
        v = v * (np.conj(w) if inverse else w)
        dft = np.exp(sign * 2j * np.pi * np.outer(j, j) / r)
        buf[slot(dst)] = v @ dft.T
    return buf


def split_bin(za, zb, w):
    s = za.real + zb.real + 1j * (za.imag - zb.imag)
    wd = w * ((za.real - zb.real) + 1j * (za.imag + zb.imag))
    return 0.5 * (s.real + wd.imag) + 0.5j * (s.imag - wd.real)


def merge_bin(xa, xb, wc):
    s = xa.real + xb.real + 1j * (xa.imag - xb.imag)
    v = wc * ((xa.real - xb.real) + 1j * (xa.imag + xb.imag))
    return 0.5 * (s.real - v.imag) + 0.5j * (s.imag + v.real)


def forward_model(frame, plan):
    """rfft of one real frame as the kernel computes it: stage the (even,
    odd) sample pairs, three passes, then split bins k and m - k."""
    n = frame.shape[-1]
    m = n // 2
    buf = np.zeros(buffer_slots(m), complex)
    buf[slot(np.arange(m))] = frame[0::2] + 1j * frame[1::2]
    z = fft_model(buf, plan, m, inverse=False)[slot(np.arange(m))]
    tw = table(n)
    k = np.arange(m + 1)
    return split_bin(z[k % m], z[(m - k) % m], tw[k])


def inverse_model(x, plan):
    """irfft (bins m + 1 -> n samples) as the kernel computes it: merge
    bins k and m - k into the buffer, three inverse passes, scale 1/m."""
    m = x.shape[-1] - 1
    tw = table(2 * m)
    buf = np.zeros(buffer_slots(m), complex)
    k = np.arange(m)
    buf[slot(k)] = merge_bin(x[k], x[m - k], np.conj(tw[k]))
    z = fft_model(buf, plan, m, inverse=True)[slot(k)] / m
    out = np.empty(2 * m)
    out[0::2], out[1::2] = z.real, z.imag
    return out


def frame_step_model(frame, r_prev, spec, merged, t, mom, plan):
    """The kernel's whole frame step in float64."""
    r = forward_model(frame, plan)
    n = r - mom * r_prev
    interp = merged + (spec - merged) * max(t, 0.0)
    x = n / (np.abs(n) + 1e-12) * interp
    x[0], x[-1] = x[0].real, x[-1].real
    return r, inverse_model(x, plan)


@pytest.mark.parametrize("n", HOPPER_N)
def test_hopper_plan_covers_the_frame(n):
    plan = fgla_plan(n)
    m = n // 2
    assert plan.route == "hopper"
    assert np.prod(plan.radices) == m
    assert len(plan.radices) in (2, 3)
    assert all(plan.points % r == 0 for r in plan.radices)
    assert plan.points * plan.threads == m
    assert plan.frames * plan.threads >= 256


@pytest.mark.parametrize("n,route", [(6400, "hopper"), (4096, "hopper"), (1280, "stockham"),
                                     (384, "stockham"), (6402, "stockham")])
def test_route_by_size(n, route):
    plan = fgla_plan(n)
    assert plan.route == route
    assert np.prod(plan.radices) == n // 2


@pytest.mark.parametrize("n", HOPPER_N)
def test_pass_indices_are_permutations(n):
    """Every pass reads each point once and writes each point once."""
    plan, m = fgla_plan(n), n // 2
    for r, pp, stride in passes(plan, m):
        i, k, src, dst = pass_indices(plan, m, r, pp)
        assert sorted(src.ravel()) == list(range(m))
        assert sorted(dst.ravel()) == list(range(m))
        assert stride * (r - 1) * (pp - 1) < 2 * m  # twiddles inside the table, no wrap


@pytest.mark.parametrize("n", HOPPER_N)
@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_model_matches_numpy_fft(n, seed):
    rng = np.random.default_rng(seed)
    plan = fgla_plan(n)
    frame = rng.standard_normal(n)
    want = np.fft.rfft(frame)
    got = forward_model(frame, plan)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    x = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(n // 2 + 1)
    x[0], x[-1] = x[0].real, x[-1].real
    want = np.fft.irfft(x, n=n)
    got = inverse_model(x, plan)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n", HOPPER_N)
def test_numpy_model_matches_plain_frame_step(n):
    """The model's whole frame step against fgla_frame_plain in float64."""
    rng = np.random.default_rng(3)
    plan, bins = fgla_plan(n), n // 2 + 1
    frame = 0.05 * rng.standard_normal(n)
    r_prev = rng.standard_normal(bins) + 1j * rng.standard_normal(bins)
    spec = rng.random(bins)
    merged = rng.random(bins)
    r, y = frame_step_model(frame, r_prev, spec, merged, 0.3, 0.4975, plan)
    tt = torch.from_numpy
    r_p, y_p = fgla_frame_plain(tt(frame)[None], tt(np.stack([r_prev.real, r_prev.imag], -1))[None],
                                tt(spec)[None], tt(merged)[None], 0.3, 0.4975,
                                compute=torch.float64)
    r_p = r_p[0, :, 0].numpy() + 1j * r_p[0, :, 1].numpy()
    assert np.abs(r - r_p).max() <= 1e-9 * np.abs(r_p).max()
    assert np.abs(y - y_p[0].numpy()).max() <= 1e-9 * np.abs(y_p.numpy()).max()


def ways(addresses):
    """Shared-memory wavefronts per wavefront needed, for 8-byte accesses
    (16 lanes, 128 bytes, per wavefront): the most lanes of a half warp that
    hit one bank pair at different addresses."""
    worst = 1
    for h in range(0, len(addresses), 16):
        banks = Counter(a % 16 for a in set(addresses[h:h + 16]))
        worst = max(worst, max(banks.values()))
    return worst


@pytest.mark.parametrize("n", HOPPER_N)
def test_pass_exchanges_at_most_two_way_conflicted(n):
    """Each load and store instruction of every pass, over every warp of a
    block (frames' buffers side by side, a warp may span two frames)."""
    plan, m = fgla_plan(n), n // 2
    threads = plan.threads * plan.frames
    tid = np.arange(threads)
    frame, t = tid // plan.threads, tid % plan.threads
    base = frame * buffer_slots(m)
    for r, pp, _ in passes(plan, m):
        _, _, src, dst = pass_indices(plan, m, r, pp)
        for idx in (src, dst):
            for u in range(idx.shape[1]):
                for j in range(r):
                    addr = base + slot(idx[t, u, j])
                    for w in range(0, threads, 32):
                        assert ways(list(addr[w:w + 32])) <= 2, (r, u, j, w)
