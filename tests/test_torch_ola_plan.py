"""K3's route by shape (``ola_plan``) and a float64 numpy model of the Hopper
kernel (csrc/ola_reframe_hopper.cu) that follows its index maps: the main
warps, one per interior hop chunk (the R input chunks that feed a signal
chunk, the R output chunks that read it), and the edge blocks, one a row
(the signal chunks the reflections read, in their shared-memory slots, and
each output sample of the edge chunks through the reflect index map). The
model is held against ``ola_reframe_plain`` in float64 and JAX
``ola_reframe_jnp`` in fp32; it counts every output sample's writes and
every input sample's reads. CPU only.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.ops.fgla_fast import ola_reframe_jnp
from dualdiffusion_tpu_torch.ops.kernels import ola_plan, ola_reframe, ola_reframe_plain
from dualdiffusion_tpu_torch.ops.kernels.ola_reframe import (HOPPER_HOP, HOPPER_WARPS,
                                                             chunk_counts)

SOURCE = (Path(__file__).resolve().parents[1] / "dualdiffusion_tpu_torch" / "csrc"
          / "ola_reframe_hopper.cu")
#: (n_fft, hop, frames): the serving sizes at F 60 and 200, the smallest F at
#: which the two reflect zones nearly meet (14 at 6400, 10 at 4096), odd and
#: even chunk counts, and a hop other than the kernel's
SIZES = [(6400, 256, 60), (6400, 256, 14), (4096, 256, 40), (4096, 256, 10), (1280, 256, 4),
         (384, 128, 3), (6400, 256, 200)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def model(y, win, inv_env, n, hop, warps=HOPPER_WARPS):
    """The kernel on rows y (rows, F, n): edge blocks first, then main warps.
    Returns (out, writes per output sample, reads per input sample)."""
    rows, frames, _ = y.shape
    r, e, es = chunk_counts(n, hop)
    half, core, total = n // 2, (frames - 1) * hop, frames - 1 + r
    ni = total - 2 * e
    out = np.full(y.shape, np.nan, y.dtype)
    writes = np.zeros(y.shape, np.int64)
    reads = np.zeros(y.shape, np.int64)

    def taps(k):
        return range(max(0, k - frames + 1), min(r - 1, k) + 1)

    def signal_chunk(b, k):
        acc = np.zeros(hop, y.dtype)
        for j in taps(k):
            cols = slice(j * hop, (j + 1) * hop)
            acc += win[cols] * y[b, k - j, cols]
            reads[b, k - j, cols] += 1
        return acc * inv_env[k * hop:(k + 1) * hop]

    s = np.arange(hop)
    for b in range(rows):                       # edge blocks
        lo0, lo1 = r // 2, r
        hi0, hi1 = max(frames - 2, lo1 + 1), frames - 1 + (half - 1) // hop
        n_lo = lo1 - lo0 + 1
        n_sig = n_lo + max(0, hi1 - hi0 + 1)
        assert n_sig <= 2 * es                  # the shared memory the launch gives
        sig = np.full(2 * es * hop, np.nan, y.dtype)
        for c in range(n_sig):
            sig[c * hop:(c + 1) * hop] = signal_chunk(b, lo0 + c if c < n_lo else hi0 + c - n_lo)
        for i in range(2 * e):
            k = i if i < e else total - 2 * e + i
            jc = k * hop + s - half
            jc = np.where(jc < 0, -jc, np.where(jc >= core, 2 * (core - 1) - jc, jc))
            src = jc + half
            c = src // hop
            slot = np.where(c <= lo1, c - lo0, n_lo + c - hi0)
            assert ((slot >= 0) & (slot < n_sig)).all()
            v = sig[slot * hop + src % hop]
            for j in taps(k):
                out[b, k - j, j * hop + s] = win[j * hop + s] * v
                writes[b, k - j, j * hop + s] += 1
    for g in range(-(-rows * ni // warps) * warps):     # main blocks' warps
        if g >= rows * ni:
            continue
        b, k = g // ni, e + g % ni
        assert half <= k * hop and (k + 1) * hop <= half + core     # an interior chunk
        sig = signal_chunk(b, k)
        for j in taps(k):
            cols = slice(j * hop, (j + 1) * hop)
            out[b, k - j, cols] = win[cols] * sig
            writes[b, k - j, cols] += 1
    return out, writes, reads


def inputs(n, hop, frames, rows=2, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((rows, frames, n)).astype(dtype)
    win = (rng.random(n) + 0.1).astype(dtype)
    inv_env = (rng.random((frames - 1) * hop + n) + 0.5).astype(dtype)
    return y, win, inv_env


def test_ola_plan_routes_by_shape():
    """Hop 256 with n_fft a multiple of 256 takes the Hopper kernel (the
    serving paths' 6400 and 4096 among them, and frames too long for the
    gather kernel's shared memory); other shapes the gather kernel."""
    for n in (6400, 4096, 1280, 256, 256 * 240):
        plan = ola_plan(n, 256)
        assert plan.route == "hopper"
        assert (plan.chunks, plan.edge_chunks, plan.edge_signal_chunks) == chunk_counts(n, 256)
    assert ola_plan(6400, 256).interior_chunks(5504) == 5502
    assert ola_plan(4096, 256).interior_chunks(5504) == 5503
    for n, hop in ((384, 128), (1000, 250), (6400, 320), (6500, 256)):
        plan = ola_plan(n, hop)
        assert plan.route == "gather" and plan.frames_per_block >= 1


@pytest.mark.parametrize("n,hop,frames", SIZES)
def test_model_matches_plain_in_float64(n, hop, frames):
    """Main warps and edge blocks together give the plain version's output
    in float64 (1e-12 of max): each output sample written exactly once, no
    input sample read more than twice, and only the samples that feed the
    signal the centre crop keeps read at all."""
    y, win, inv_env = inputs(n, hop, frames)
    got, writes, reads = model(y, win, inv_env, n, hop)
    want = ola_reframe_plain(torch.from_numpy(y), torch.from_numpy(win),
                             torch.from_numpy(inv_env), hop, compute=torch.float64).numpy()
    assert (writes == 1).all()
    assert reads.max() <= 2
    # input chunk (u, j) feeds signal chunk u + j; the crop keeps [n/2, L - n/2)
    k = np.arange(frames)[:, None] + np.arange(n // hop)[None, :]
    kept = ((k + 1) * hop > n // 2) & (k * hop < (frames - 1) * hop + n // 2)
    chunk_reads = reads.reshape(-1, frames, n // hop, hop)
    assert (chunk_reads[:, kept] >= 1).all() and (chunk_reads[:, ~kept] == 0).all()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_model_matches_jax_in_fp32():
    """The model in fp32 against JAX ``ola_reframe_jnp`` on the polyphase
    grid (natural frames read as (n/128, 128) rows, hop 2 rows) at n_fft
    6400 and F 14, the smallest serving-size row: 1e-5 of max."""
    n, hop, frames = 6400, 256, 14
    y, win, inv_env = inputs(n, hop, frames, seed=3, dtype=np.float32)
    got, _, _ = model(y, win, inv_env, n, hop)
    want = ola_reframe_jnp(jnp.asarray(y.reshape(2, frames, n // 128, 128)),
                           jnp.asarray(win.reshape(-1, 128)),
                           jnp.asarray(inv_env.reshape(-1, 128)), hop // 128)
    want = np.asarray(want).reshape(y.shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_chunk_counts_match_the_source():
    """The hop, warps a block and the chunk counts the kernel states for the
    serving shapes (its static_asserts) are ``ola_plan``'s."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kHop = (\d+);", src).group(1)) == HOPPER_HOP
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) == HOPPER_WARPS
    edges = re.findall(r"static_assert\(edge_chunks\((\d+)\) == (\d+) && "
                       r"edge_signal_chunks\((\d+)\) == (\d+)", src)
    interiors = re.findall(r"static_assert\(interior_chunks\((\d+), (\d+)\) == (\d+)", src)
    assert {int(r) for r, *_ in edges} == {25, 16} and len(interiors) == 2
    for r, e, r2, es in edges:
        plan = ola_plan(int(r) * HOPPER_HOP, HOPPER_HOP)
        assert r == r2 and (plan.chunks, plan.edge_chunks, plan.edge_signal_chunks) == \
            (int(r), int(e), int(es))
    for r, frames, ni in interiors:
        assert ola_plan(int(r) * HOPPER_HOP, HOPPER_HOP).interior_chunks(int(frames)) == int(ni)


def test_wrapper_on_cpu_takes_the_plain_version():
    """CPU tensors run the plain version (fp32 and bf16 in, same dtype out)
    and count no launch on either route."""
    y, win, inv_env = inputs(1280, 256, 6, dtype=np.float32)
    before = ola_reframe.launches, dict(ola_reframe.routes)
    for dtype in (torch.float32, torch.bfloat16):
        ty = torch.from_numpy(y).to(dtype)
        got = ola_reframe(ty, torch.from_numpy(win), torch.from_numpy(inv_env), 256)
        assert got.dtype == dtype
        assert torch.equal(got, ola_reframe_plain(ty, torch.from_numpy(win),
                                                  torch.from_numpy(inv_env), 256))
    assert (ola_reframe.launches, ola_reframe.routes) == before
