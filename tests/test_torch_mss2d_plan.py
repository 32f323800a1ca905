"""K5/K6's plan (``MSS2D_PLANS``) and a float64 numpy model of the kernels
of csrc/mss2d.cu that follows their index maps: each bw-point FFT spread
over ``threads`` threads of 8 points (radix 8, the twiddles W^(t k1), the
exchange through the FFT's shared slice, radix ``threads``), the stage-1
ring of complex row spectra and its Hermitian split, stage 2 per bin
column, K6's inverse FFTs into the gradient ring, the W adjoint of a
finished row and K6b's sum over column blocks. The model is held against
``numpy.fft`` and against ``mss2d_block_loss_plain`` /
``mss2d_block_loss_grad_plain`` in float64 to 1e-9, and its shared-memory
addresses are counted for bank conflicts. Beside it, a float64 model of
the direct-DFT route (csrc/mss2d_dft.cu) with its twiddle index maps, its
gradient scratch walked in chunks of position rows and its gather, for the
shapes the FFT kernels do not take. CPU only.
"""

import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch.ops.kernels import (MSS2D_PLANS, mss2d_block_loss_grad_plain,
                                                 mss2d_block_loss_plain, mss2d_route)
from dualdiffusion_tpu_torch.training.losses import _window_2d, product_weights

WIDTHS = (32, 64)
SOURCE = Path(__file__).resolve().parents[1] / "dualdiffusion_tpu_torch" / "csrc" / "mss2d.cu"
DFT_SOURCE = SOURCE.with_name("mss2d_dft.cu")


class Shape:
    """The kernel's Shape<BW>: thread roles and counts of one thread block."""

    def __init__(self, bw):
        p = self.plan = MSS2D_PLANS[bw]
        self.bw, self.n2, self.jb = bw, p.threads, p.cols
        self.bins = bw // 2 + 1
        self.own = 8 // self.n2
        self.prod = self.jb * (bw // 8) * self.n2
        self.cons = self.jb * self.bins * self.n2
        self.threads = self.prod + self.cons
        self.groups = self.threads // self.n2

    def smem_bytes(self, stride, n_grad):
        ring = self.bw + stride
        p = self.plan
        return 8 * (self.jb * ring * p.z_stride + self.groups * p.x_slots
                    + n_grad * self.jb * ring * p.q_stride)

    def bins_of(self, t):
        """Lane::bin: the bin of a[e] after the forward FFT, (len(t), 8)."""
        e = np.arange(8)
        return t[:, None] + self.n2 * (e // self.n2) + 8 * (e % self.n2)

    def exch_a(self, t):
        """The exchange entries thread t (holding n2 = t) writes / reads: (len(t), 8) over k1."""
        return np.arange(8)[None, :] * (self.n2 + 1) + t[:, None]

    def exch_b(self, t):
        """The entries thread t (owning k1 = t + N2 m) reads / writes: (len(t), own, N2)."""
        k1 = t[:, None] + self.n2 * np.arange(self.own)[None, :]
        return k1[..., None] * (self.n2 + 1) + np.arange(self.n2)

    def twiddles(self, t, inverse=False):
        tw = np.exp(-2j * np.pi * np.outer(t, np.arange(8)) / self.bw)
        return np.conj(tw) if inverse else tw


def dft_matrix(n, inverse=False):
    sign = 1.0 if inverse else -1.0
    return np.exp(sign * 2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)


def fft_fwd(a, sh):
    """fft_fwd on G FFTs at once: a[g, t, n1] = x_g[N2 n1 + t] ->
    out[g, t, e] = X_g[bins_of(t)[e]], through each FFT's exchange slice."""
    t = np.arange(sh.n2)
    y = (a @ dft_matrix(8).T) * sh.twiddles(t)
    xb = np.zeros((a.shape[0], sh.plan.x_slots), complex)
    xb[:, sh.exch_a(t)] = y
    b = xb[:, sh.exch_b(t)] @ dft_matrix(sh.n2).T
    return b.reshape(a.shape[0], sh.n2, 8)


def fft_inv(a, sh):
    """fft_inv: a[g, t, e] = X_g[bins_of(t)[e]] -> out[g, t, n1] =
    sum_k X_g[k] e^{+2 pi i k r / bw} at r = N2 n1 + t."""
    t = np.arange(sh.n2)
    b = a.reshape(a.shape[0], sh.n2, sh.own, sh.n2) @ dft_matrix(sh.n2, True).T
    xb = np.zeros((a.shape[0], sh.plan.x_slots), complex)
    xb[:, sh.exch_b(t)] = b
    y = xb[:, sh.exch_a(t)] * sh.twiddles(t, inverse=True)
    return y @ dft_matrix(8, True).T


def grid(shape, bw, stride):
    bc, h, w = shape
    return (h - bw) // stride + 1, (w - bw) // stride + 1


def kernel_model(s, t, bw, stride, w1, weight, g=None, n_grad=1):
    """K5 (g None: per-image sums) or K6a + K6b (the gradients of
    (loss * g).sum(), n_grad of them) as the kernels compute them."""
    sh = Shape(bw)
    n2, jb, bins = sh.n2, sh.jb, sh.bins
    p = sh.plan
    bc, h, w = s.shape
    n_rows, n_cols = grid(s.shape, bw, stride)
    ring = bw + stride
    tt = np.arange(n2)
    r = n2 * np.arange(8)[None, :] + tt[:, None]          # (N2, 8): point n1 of thread t
    kb = sh.bins_of(tt)                                    # (N2, 8): bin of a[e]
    w1r = w1[r]
    ls = np.arange(bins)
    lm = (bw - ls) % bw
    loss = np.zeros(bc)
    d = np.zeros((n_grad, bc, h, w))
    D = np.zeros((n_grad, bc, h, n_cols, bw))
    for b in range(bc):
        for bx in range(-(-n_cols // jb)):
            cols = [jj for jj in range(jb) if bx * jb + jj < n_cols]
            z = np.zeros((jb, ring, p.z_stride), complex)
            q = np.zeros((n_grad, jb, ring, p.q_stride), complex)

            def stage1(jj, ys):
                x0 = (bx * jb + jj) * stride
                a = w1r * (s[b][ys[:, None, None], x0 + r] + 1j * t[b][ys[:, None, None], x0 + r])
                z[jj, (ys % ring)[:, None, None], kb] = fft_fwd(a, sh)

            def finalize(jj, ys):                            # one inverse FFT per tensor
                sl = (ys % ring)[:, None, None]
                src = np.where(kb <= bw // 2, kb, bw - kb)
                end = (kb == 0) | (kb == bw // 2)
                for tens in range(n_grad):
                    v = q[tens, jj, sl, src]
                    v = np.where(end, v.real, np.where(kb < bw // 2, 0.5 * v, 0.5 * np.conj(v)))
                    D[tens, b, ys[:, None, None], bx * jb + jj, r] = \
                        (fft_inv(v, sh) * w1r).real                  # c = N2 n1 + t
                q[:, jj, ys % ring, :bins] = 0

            for jj in cols:
                stage1(jj, np.arange(bw))
            for i in range(n_rows):
                base = (i * stride) % ring
                sl = (base + r) % ring                       # (N2, 8)
                for jj in cols:                              # consumers, one FFT per column l
                    z1 = z[jj, sl[None], ls[:, None, None]]
                    z2 = z[jj, sl[None], lm[:, None, None]]
                    S = fft_fwd(0.5 * w1r * (z1 + np.conj(z2)), sh)
                    T = fft_fwd(0.5 * w1r * (z1 - np.conj(z2)) / 1j, sh)
                    wgt = weight[kb[None], ls[:, None, None]]
                    ms, mt = np.abs(S), np.abs(T)
                    if g is None:
                        loss[b] += (wgt * np.abs(ms - mt)).sum()
                        continue
                    c = g[b] * wgt * np.sign(ms - mt)
                    grads = (np.where(ms > 0, c * S / np.where(ms > 0, ms, 1), 0),
                             np.where(mt > 0, -c * T / np.where(mt > 0, mt, 1), 0))
                    for tens in range(n_grad):
                        q[tens, jj, sl[None], ls[:, None, None]] += w1r * fft_inv(grads[tens], sh)
                for jj in cols:                              # producers, a step ahead / behind
                    if i + 1 < n_rows:
                        stage1(jj, i * stride + bw + np.arange(stride))
                    if g is not None and i > 0:
                        finalize(jj, (i - 1) * stride + np.arange(stride))
            if g is not None:
                for jj in cols:
                    finalize(jj, (n_rows - 1) * stride + np.arange(bw))
    if g is None:
        return loss
    covered = (n_rows - 1) * stride + bw
    for x in range(w):                                       # K6b
        for j in range(max(0, -(-(x - bw + 1) // stride)), min(n_cols - 1, x // stride) + 1):
            d[:, :, :covered, x] += D[:, :, :covered, j, x - j * stride]
    return d


def dyadic_window(bw):
    """The flat-top factor rounded to 1/64ths, so outer(w1, w1) is exact in
    fp32 and the plain version's fp32 window is the model's."""
    win = _window_2d("flat_top", bw)
    w1 = np.sqrt(np.clip(np.diag(win), 0, None)) * np.sign(win[bw // 2])
    w1 = np.round(w1 * 64) / 64
    return w1, np.outer(w1, w1)


def inputs(bw, stride, seed):
    rng = np.random.default_rng(seed)
    h = bw + 2 * stride + 3
    w = bw + 9 * stride + 5
    s = rng.standard_normal((2, h, w))
    t = rng.standard_normal((2, h, w))
    weight = (product_weights(bw) / bw).astype(np.float32).astype(np.float64)
    w1, win = dyadic_window(bw)
    return s, t, w1, win, weight


def rfft2_loss(s, t, bw, stride, win, weight):
    """The loss by numpy.fft.rfft2 of every windowed block."""
    n_rows, n_cols = grid(s.shape, bw, stride)
    out = np.zeros(s.shape[0])
    for i in range(n_rows):
        for j in range(n_cols):
            blk = np.s_[:, i * stride:i * stride + bw, j * stride:j * stride + bw]
            d = np.abs(np.fft.rfft2(s[blk] * win)) - np.abs(np.fft.rfft2(t[blk] * win))
            out += (np.abs(d) * weight).sum(axis=(1, 2))
    return out


@pytest.mark.parametrize("bw", WIDTHS)
def test_plan_is_the_compiled_plan(bw):
    """MSS2D_PLANS against the Plan<BW> the kernel source compiles."""
    src = SOURCE.read_text()
    m = re.search(r"struct Plan<%d> \{\s*static constexpr int N2 = (\d+), JB = (\d+), "
                  r"ZS = (\d+), QS = (\d+), XS = (\d+);" % bw, src)
    assert m, "Plan<%d> not found in %s" % (bw, SOURCE.name)
    p = MSS2D_PLANS[bw]
    assert [int(v) for v in m.groups()] == [p.threads, p.cols, p.z_stride, p.q_stride, p.x_slots]
    assert 8 * p.threads == bw


@pytest.mark.parametrize("bw,stride,window,route", [
    (32, 4, "flat_top", "fft"), (64, 8, "flat_top", "fft"), (32, 1, "flat_top", "fft"),
    (64, 64, "flat_top", "fft"), (16, 2, "flat_top", "dft"), (128, 16, "flat_top", "dft"),
    (32, 4, "flat_top_circular", "dft"), (32, 33, "flat_top", "dft"),
    (64, 100, "flat_top", "dft")])
def test_route_by_shape(bw, stride, window, route):
    """The FFT kernels take bw 32 and 64, strides 1 to bw and separable
    windows; every other shape takes the direct-DFT kernels, chosen before
    any launch."""
    assert mss2d_route(bw, stride, _window_2d(window, bw)) == route


@pytest.mark.parametrize("bw", WIDTHS)
def test_plan_fits_the_card(bw):
    """An FFT's threads share a warp, producers fill whole warps, and at the
    default stride two blocks fit an SM (228 KB) for K5 and for K6 without
    dTarget; any stride up to bw fits one block (227 KB)."""
    sh = Shape(bw)
    p = sh.plan
    assert 32 % sh.n2 == 0 and sh.prod % 32 == 0
    assert p.x_slots >= 8 * (sh.n2 + 1) - 1 and p.z_stride >= bw and p.q_stride >= sh.bins
    for n_grad in (0, 1):
        assert 2 * (sh.smem_bytes(bw // 8, n_grad) + 1024) <= 228 * 1024
    assert sh.smem_bytes(bw, 2) <= 227 * 1024


@pytest.mark.parametrize("bw", WIDTHS)
def test_index_maps_are_permutations(bw):
    """The exchange writes and reads one set of distinct slots; the threads'
    bins cover 0..bw-1 once."""
    sh = Shape(bw)
    t = np.arange(sh.n2)
    a, b = sh.exch_a(t).ravel(), sh.exch_b(t).ravel()
    assert len(set(a)) == bw and set(a) == set(b) and max(a) < sh.plan.x_slots
    assert sorted(sh.bins_of(t).ravel()) == list(range(bw))


@pytest.mark.parametrize("bw", WIDTHS)
def test_fft_model_matches_numpy_fft(bw):
    sh = Shape(bw)
    rng = np.random.default_rng(bw)
    x = rng.standard_normal((5, bw)) + 1j * rng.standard_normal((5, bw))
    t = np.arange(sh.n2)
    r = sh.n2 * np.arange(8)[None, :] + t[:, None]
    kb = sh.bins_of(t)
    got = fft_fwd(x[:, r], sh)
    want = np.fft.fft(x)[:, kb]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    got = fft_inv(x[:, kb], sh)
    want = bw * np.fft.ifft(x)[:, r]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("bw,stride", [(32, 4), (64, 8), (32, 3), (64, 5)])
def test_k5_model_matches_rfft2_and_plain(bw, stride):
    s, t, w1, win, weight = inputs(bw, stride, 0)
    got = kernel_model(s, t, bw, stride, w1, weight)
    assert np.abs(got - rfft2_loss(s, t, bw, stride, win, weight)).max() <= 1e-9 * np.abs(got).max()
    plain = mss2d_block_loss_plain(torch.from_numpy(s), torch.from_numpy(t), bw, stride, win,
                                   weight).numpy()
    assert np.abs(got - plain).max() <= 1e-9 * np.abs(plain).max()


@pytest.mark.parametrize("bw,stride", [(32, 4), (64, 8), (32, 3), (64, 5)])
@pytest.mark.parametrize("n_grad", [1, 2])
def test_k6_model_matches_plain_grad(bw, stride, n_grad):
    """Both gradients (K6 with dTarget) or d_sample alone, with an
    independent target: in float64 no bin's |S| - |T| is near enough 0 to
    flip its sign."""
    s, t, w1, win, weight = inputs(bw, stride, 1)
    g = np.array([0.7, -1.3])
    got = kernel_model(s, t, bw, stride, w1, weight, g=g, n_grad=n_grad)
    want = mss2d_block_loss_grad_plain(torch.from_numpy(s), torch.from_numpy(t),
                                       torch.from_numpy(g), bw, stride, win, weight,
                                       need_target=n_grad > 1)
    for tens in range(n_grad):
        ref = want[tens].numpy()
        assert np.abs(got[tens] - ref).max() <= 1e-9 * np.abs(ref).max()


def ways(addresses):
    """Shared-memory wavefronts per wavefront needed, for 8-byte accesses
    (16 lanes, 128 bytes, per wavefront): the most lanes of a half warp that
    hit one bank pair at different addresses (None: the lane does not access)."""
    worst = 1
    for hw in range(0, len(addresses), 16):
        live = {a for a in addresses[hw:hw + 16] if a is not None}
        if live:
            worst = max(worst, max(Counter(a % 16 for a in live).values()))
    return worst


def worst_ways(addr, active):
    """addr: (instructions, threads) complex-slot addresses of one block."""
    worst = 1
    for row, act in zip(addr, active):
        for w in range(0, len(row), 32):
            worst = max(worst, ways([int(a) if on else None
                                     for a, on in zip(row[w:w + 32], act[w:w + 32])]))
    return worst


@pytest.mark.parametrize("bw", WIDTHS)
def test_shared_accesses_at_most_two_way_conflicted(bw):
    """Each load and store instruction of both kernels, over every warp of a
    block at the default stride: the exchanges of every FFT, stage 2's reads
    of the ring (columns l and bw - l, at every ring offset), stage 1's
    writes into it, K6's adds into the gradient ring and the finished rows'
    reads and clears."""
    sh = Shape(bw)
    p = sh.plan
    stride = bw // 8
    ring = bw + stride
    tid = np.arange(sh.threads)
    t, group = tid % sh.n2, tid // sh.n2
    xb = group * p.x_slots
    everyone = np.ones(sh.threads, bool)
    checks = {}
    # the exchanges (fft_fwd's write, then reads; fft_inv the same slots reversed)
    a, b = sh.exch_a(t), sh.exch_b(t).reshape(sh.threads, -1)
    checks["exchange A"] = ((xb[:, None] + a).T, [everyone] * 8)
    checks["exchange B"] = ((xb[:, None] + b).T, [everyone] * 8)
    # consumers
    cons = tid >= sh.prod
    cidx = np.where(cons, tid - sh.prod, 0)
    cjj, l = cidx // (sh.bins * sh.n2), (cidx // sh.n2) % sh.bins
    lm = (bw - l) % bw
    zr, qr = [], []
    for base in range(ring):
        for n1 in range(8):
            sl = (base + sh.n2 * n1 + t) % ring
            for col in (l, lm):
                zr.append((cjj * ring + sl) * p.z_stride + col)
            qr.append((cjj * ring + sl) * p.q_stride + l)
    checks["stage-2 ring reads"] = (np.array(zr), [cons] * len(zr))
    checks["gradient ring adds"] = (np.array(qr), [cons] * len(qr))
    # producers: a row each, at every step (rows y of column block jj)
    prod = tid < sh.prod
    job = np.where(prod, group, 0)
    jj, q = job // stride, job % stride
    kb = sh.bins_of(t)
    src = np.where(kb <= bw // 2, kb, bw - kb)
    zw, qf, qz = [], [], []
    for i in range(ring):
        sl = (i * stride + bw + q) % ring
        for e in range(8):
            zw.append((jj * ring + sl) * p.z_stride + kb[:, e])
            qf.append((jj * ring + sl) * p.q_stride + src[:, e])
            qz.append(((jj * ring + sl) * p.q_stride + kb[:, e], prod & (kb[:, e] <= bw // 2)))
    checks["stage-1 ring writes"] = (np.array(zw), [prod] * len(zw))
    checks["finished-row reads"] = (np.array(qf), [prod] * len(qf))
    checks["finished-row clears"] = (np.array([a for a, _ in qz]), [m for _, m in qz])
    # the prologue: every thread takes a row
    pj = group
    pjj, py = pj // bw, pj % bw
    pw = [(pjj * ring + py) * p.z_stride + kb[:, e] for e in range(8)]
    checks["prologue ring writes"] = (np.array(pw), [pjj < sh.jb] * 8)
    found = {name: worst_ways(addr, act) for name, (addr, act) in checks.items()}
    assert all(v <= 2 for v in found.values()), found


def dft_model(s, t, bw, stride, win, weight, g=None, n_grad=1, chunk=1):
    """csrc/mss2d_dft.cu in float64: per position, the row DFT and the
    column DFT with E[m] = e^{-2 pi i m / bw} indexed by running sums mod
    bw, then K5's weighted sum (partials per position, then per image) or
    K6's G, its adjoint transforms into the scratch rows of one chunk and
    the gather of each pixel's covering positions, chunk after chunk."""
    n_rows, n_cols = grid(s.shape, bw, stride)
    bins = bw // 2 + 1
    e = np.exp(-2j * np.pi * np.arange(bw) / bw)
    fc = e[np.outer(np.arange(bins), np.arange(bw)) % bw]    # fc[v, c] = E[v c mod bw]
    fr = e[np.outer(np.arange(bw), np.arange(bw)) % bw]      # fr[u, r] = E[u r mod bw]

    def spectra(x, i, j):       # (BC, bw, bins): X[u, v] = sum_r fr[u, r] Z[r, v]
        blk = x[:, i * stride:i * stride + bw, j * stride:j * stride + bw] * win
        return fr @ blk @ fc.T

    if g is None:
        partial = np.zeros((s.shape[0], n_rows * n_cols))
        for i in range(n_rows):
            for j in range(n_cols):
                d = np.abs(np.abs(spectra(s, i, j)) - np.abs(spectra(t, i, j)))
                partial[:, i * n_cols + j] = (weight * d).sum(axis=(1, 2))
        return partial.sum(axis=1)
    d = np.zeros((n_grad,) + s.shape)
    writes = np.zeros(s.shape[1:], int)
    for i0 in range(0, n_rows, chunk):
        i1 = min(n_rows, i0 + chunk)
        p = np.zeros((n_grad, s.shape[0], chunk, n_cols, bw, bw))
        for i in range(i0, i1):
            for j in range(n_cols):
                a, b = spectra(s, i, j), spectra(t, i, j)
                ms, mt = np.abs(a), np.abs(b)
                c = g[:, None, None] * weight * np.sign(ms - mt)
                gs = np.where(ms > 0, a * c / np.where(ms > 0, ms, 1), 0)
                gt = np.where(mt > 0, -b * c / np.where(mt > 0, mt, 1), 0)
                for tens, gg in enumerate((gs, gt)[:n_grad]):
                    z = fr.conj().T @ gg                      # Z[r, v] = sum_u G[u, v] conj E[u r]
                    p[tens, :, i - i0, j] = win * (z @ fc.conj()).real
        y0, y1 = i0 * stride, min(s.shape[1], (i1 - 1) * stride + bw)
        y, x = np.arange(y0, y1)[:, None], np.arange(s.shape[2])[None, :]
        ia = np.maximum(i0, np.where(y >= bw, (y - bw + stride) // stride, 0))
        ib = np.minimum(i1 - 1, y // stride)
        ja = np.where(x >= bw, (x - bw + stride) // stride, 0)
        jb = np.minimum(n_cols - 1, x // stride)
        for i in range(i0, i1):           # the gather's terms, position by position
            for j in range(n_cols):
                take = (ia <= i) & (i <= ib) & (ja <= j) & (j <= jb)
                yy, xx = np.nonzero(take)
                d[:, :, y0 + yy, xx] += p[:, :, i - i0, j, y0 + yy - i * stride, xx - j * stride]
                np.add.at(writes, (y0 + yy, xx), 1)
    covered = np.zeros(s.shape[1:], int)
    for i in range(n_rows):
        for j in range(n_cols):
            covered[i * stride:i * stride + bw, j * stride:j * stride + bw] += 1
    assert np.array_equal(writes, covered)   # each (position, pixel) pair gathered once
    return d


def dft_inputs(bw, stride, window, seed):
    rng = np.random.default_rng(seed)
    h, w = bw + 2 * stride + 3, bw + 4 * stride + 5
    s, t = rng.standard_normal((2, 2, h, w))
    win = _window_2d(window, bw).astype(np.float64)
    weight = (product_weights(bw) / bw).astype(np.float32).astype(np.float64)
    return s, t, win, weight


DFT_SHAPES = [(16, 2, "flat_top"), (32, 4, "flat_top_circular"), (32, 33, "flat_top"),
              (7, 3, "hann"), (128, 16, "flat_top")]


@pytest.mark.parametrize("bw,stride,window", DFT_SHAPES)
def test_dft_k5_model_matches_plain(bw, stride, window):
    """The direct-DFT route's loss against the plain version in float64, at
    a width the FFT kernels do not take, a window that is not separable, a
    stride above bw, an odd width and the widest block."""
    s, t, win, weight = dft_inputs(bw, stride, window, 2)
    got = dft_model(s, t, bw, stride, win, weight)
    plain = mss2d_block_loss_plain(torch.from_numpy(s), torch.from_numpy(t), bw, stride, win,
                                   weight).numpy()
    assert np.abs(got - plain).max() <= 1e-9 * np.abs(plain).max()


@pytest.mark.parametrize("bw,stride,window", DFT_SHAPES[:4])
@pytest.mark.parametrize("n_grad,chunk", [(1, 1), (2, 2), (2, 100)])
def test_dft_k6_model_matches_plain_grad(bw, stride, window, n_grad, chunk):
    """The direct-DFT route's gradients against the plain version's
    autograd in float64, with the scratch walked one, two or all position
    rows at a time."""
    s, t, win, weight = dft_inputs(bw, stride, window, 3)
    g = np.array([0.7, -1.3])
    got = dft_model(s, t, bw, stride, win, weight, g=g, n_grad=n_grad, chunk=chunk)
    want = mss2d_block_loss_grad_plain(torch.from_numpy(s), torch.from_numpy(t),
                                       torch.from_numpy(g), bw, stride, win, weight,
                                       need_target=n_grad > 1)
    for tens in range(n_grad):
        ref = want[tens].numpy()
        assert np.abs(got[tens] - ref).max() <= 1e-9 * np.abs(ref).max()


def test_dft_kernel_fits_the_card():
    """The widest block's three spectra and twiddles (the kernel's
    smem_bytes) fit one block's dynamic shared memory (227 KB) beside K5's
    eight warp sums, and the source states the widths it takes."""
    src = DFT_SOURCE.read_text()
    assert re.search(r"constexpr int kMaxBw = 128;", src)
    bw = 128
    assert (bw + 3 * bw * (bw // 2 + 1)) * 8 + 8 * 4 <= 227 * 1024
