"""The port's kernels' plain versions against the JAX package on the CPU
(tests/test_torch_cuda.py holds the kernels against these on a GPU).

K1 grouped_conv3x3 <-> dualdiffusion_tpu/ops/pallas/grouped_conv.py
K2 fgla_frame + K3 ola_reframe <-> ops/fgla.py's loop body, ops/fgla_fast.py
ola_reframe_jnp and the fused Pallas iteration (interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.ops import get_window
from dualdiffusion_tpu.ops.fgla_fast import griffinlim_fast, ola_reframe_jnp
from dualdiffusion_tpu.ops.pallas.grouped_conv import (_lax_reference,
                                                       grouped_conv2d_3x3_pre,
                                                       prepare_kernel_weights)
from dualdiffusion_tpu.ops.stft import istft_pair, stft, stft_pair
from dualdiffusion_tpu_torch.ops import griffinlim
from dualdiffusion_tpu_torch.ops.kernels import (dft_twiddles, fgla_frame, grouped_conv3x3,
                                                 ola_reframe, prepare_weights)
from dualdiffusion_tpu_torch.ops.stft import envelope, pad_center


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(2, 4, 20, 2, 8, 16), (1, 3, 9, 4, 4, 2)])
def test_grouped_conv_plain_matches_lax_reference(b, h, w, groups, cig, cog):
    """fp32: the plain version equals lax.conv_general_dilated with
    feature_group_count up to float rounding (1e-5 relative)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, groups * cig)).astype(np.float32)
    wgt = rng.standard_normal((groups * cog, cig, 3, 3)).astype(np.float32)
    want = _lax_reference(jnp.asarray(x), jnp.asarray(wgt), groups)
    got = grouped_conv3x3(torch.from_numpy(x), prepare_weights(torch.from_numpy(wgt), groups,
                                                               torch.float32), groups)
    assert _rel_err(got.numpy(), want) < 1e-5


def test_grouped_conv_plain_matches_pallas_kernel():
    """bf16: the plain version against the Pallas kernel (interpret mode)
    on the same pre-arranged weights. Both accumulate in fp32 and round
    once to bf16, so they differ by at most one bf16 ulp (2**-7 of max)."""
    rng = np.random.default_rng(1)
    groups, cig, cog = 2, 16, 8
    x = rng.standard_normal((2, 4, 12, groups * cig)).astype(np.float32)
    wgt = (rng.standard_normal((groups * cog, cig, 3, 3)) / np.sqrt(9 * cig)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = grouped_conv2d_3x3_pre(jx, prepare_kernel_weights(jnp.asarray(wgt), groups,
                                                             jnp.bfloat16), groups)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = grouped_conv3x3(tx, prepare_weights(torch.from_numpy(wgt), groups), groups)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= 2 ** -7


# ---------------------------------------------------------------------------
# K3 and K2
# ---------------------------------------------------------------------------

def test_ola_reframe_plain_matches_jnp():
    """Natural-layout frames are the polyphase grid read row-major, so the
    plain version equals ola_reframe_jnp on (n1, 128) rows (fp32, 1e-5)."""
    rng = np.random.default_rng(2)
    f, n1, hop_rows = 12, 10, 2
    n, hop = n1 * 128, hop_rows * 128
    y = rng.standard_normal((1, 2, f, n)).astype(np.float32)
    win = (rng.random(n) + 0.1).astype(np.float32)
    inv_env = (rng.random((f - 1) * hop + n) + 0.5).astype(np.float32)
    want = ola_reframe_jnp(jnp.asarray(y.reshape(1, 2, f, n1, 128)),
                           jnp.asarray(win.reshape(n1, 128)),
                           jnp.asarray(inv_env.reshape(-1, 128)), hop_rows)
    got = ola_reframe(torch.from_numpy(y), torch.from_numpy(win), torch.from_numpy(inv_env),
                      hop)
    assert _rel_err(got.numpy(), np.asarray(want).reshape(1, 2, f, n)) < 1e-5


def test_frame_step_matches_jax_loop_body():
    """K3 then K2 (plain versions) == one body of JAX ops/fgla.py's loop:
    r = stft(istft(ang * interp)), ang' = normalize(r - mom * prev), and
    K2's inverse output is istft's frames of ang' * interp' (fp32, 1e-4:
    two 1280-point transforms in another order)."""
    rng = np.random.default_rng(3)
    n_fft, hop, f = 1280, 256, 9
    bins = n_fft // 2 + 1
    win_np = get_window("hann_power", n_fft, exponent=8.0)
    spec = rng.random((1, 2, f, bins)).astype(np.float32)
    merged = np.broadcast_to(spec.mean(1, keepdims=True), spec.shape).copy()
    phi = rng.uniform(-np.pi, np.pi, spec.shape).astype(np.float32)
    prev = rng.standard_normal(spec.shape + (2,)).astype(np.float32)
    mom, t0, t1 = 0.4975, 0.2, 0.3

    # JAX: x = ang*interp(t0) -> istft -> stft -> momentum -> normalize
    interp0 = merged + (spec - merged) * t0
    inverse = istft_pair(jnp.asarray(np.cos(phi) * interp0), jnp.asarray(np.sin(phi) * interp0),
                         win_np, n_fft, hop)
    rr, ri = stft_pair(inverse, win_np, n_fft, hop)
    nr, ni = rr - mom * prev[..., 0], ri - mom * prev[..., 1]
    mag = jnp.sqrt(nr * nr + ni * ni) + 1e-12
    interp1 = merged + (spec - merged) * t1
    x1 = (np.asarray(nr) + 1j * np.asarray(ni)) / np.asarray(mag) * interp1
    want_y1 = np.fft.irfft(x1, n=n_fft).astype(np.float32)

    tt = torch.from_numpy
    ang0 = tt(np.stack([np.cos(phi), np.sin(phi)], -1))
    win = tt(pad_center(win_np, n_fft).astype(np.float32))
    inv_env = tt((1.0 / envelope(win_np, n_fft, hop, f)).astype(np.float32))
    tw = dft_twiddles(n_fft, "cpu")
    _, y0 = fgla_frame(ang0, None, tt(spec), tt(merged), t0, mom, tw, spectral_in=True)
    r1, y1 = fgla_frame(ola_reframe(y0, win, inv_env, hop), tt(prev), tt(spec), tt(merged),
                        t1, mom, tw)
    assert _rel_err(r1[..., 0].numpy(), rr) < 1e-4
    assert _rel_err(r1[..., 1].numpy(), ri) < 1e-4
    assert _rel_err(y1.numpy(), want_y1) < 1e-4


def test_griffinlim_one_iteration_matches_fused_pallas_iteration():
    """One Griffin-Lim iteration through K3 + K2 (plain versions) against
    griffinlim_fast(fuse_iteration=True), the one-kernel TPU iteration run in
    interpret mode, on a geometry fgla_iter supports (F = 40). The fused
    kernel works on the digit grid with matmul DFTs, so they agree to float
    rounding of two different DFT factorizations (1e-3 of max)."""
    n_fft, hop, frames = 1280, 256, 41
    win = get_window("hann_power", n_fft, exponent=8.0)
    t = np.arange((frames - 1) * hop) / 32000
    sig = np.stack([np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 991 * t),
                    np.sin(2 * np.pi * 440 * t) * 0.8]).astype(np.float32)[None]
    mag = np.asarray(jnp.abs(stft(jnp.asarray(sig), win, n_fft, hop, backend="fft")))[:, :, :40]
    want = griffinlim_fast(jnp.asarray(mag), win, n_fft, hop, n_iter=1, momentum=0.99,
                           work_dtype="float32", fuse_iteration=True, phase_init="spsi")
    got = griffinlim(torch.from_numpy(mag), win, n_fft, hop, n_iter=1, momentum=0.99,
                     work_dtype="float32", phase_init="spsi")
    assert _rel_err(got.numpy(), want) < 1e-3
