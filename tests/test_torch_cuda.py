"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the suite.)
"""

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch.ops.kernels import (GroupedConv3x3Fn, dft_twiddles, dgrad_weights,
                                                 fgla_frame, fgla_frame_plain, fgla_plan,
                                                 flash_attention, flash_attention_plain,
                                                 gather_everywhere, grouped_conv3x3,
                                                 grouped_conv3x3_plain, grouped_conv3x3_wgrad,
                                                 grouped_conv3x3_wgrad_plain, hopper_takes,
                                                 mss2d_block_loss,
                                                 mss2d_block_loss_grad,
                                                 mss2d_block_loss_grad_plain,
                                                 mss2d_block_loss_plain, mss2d_loss_fused,
                                                 ola_plan, ola_reframe, ola_reframe_plain,
                                                 prepare_weights, stockham_everywhere)
from dualdiffusion_tpu_torch.training.losses import _window_2d, product_weights


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(1, 3, 5, 2, 8, 8), (2, 4, 86, 8, 288, 256),
                                                  (2, 2, 43, 8, 320, 320),
                                                  (2, 4, 70, 4, 12, 20)])   # the WMMA kernel
def test_grouped_conv_kernel_matches_plain(cuda, b, h, w, groups, cig, cog):
    """bf16 out: one rounding of an fp32 sum taken in another order."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, h, w, groups * cig), generator=g, device=cuda).bfloat16()
    wt = prepare_weights(torch.randn((groups * cog, cig, 3, 3), generator=g, device=cuda)
                         / (9 * cig) ** 0.5, groups)
    before = grouped_conv3x3.launches
    got = grouped_conv3x3(x, wt, groups)
    torch.cuda.synchronize()
    assert grouped_conv3x3.launches == before + 1
    assert _rel_err(got.float().cpu(), grouped_conv3x3_plain(x, wt, groups).float().cpu()) \
        <= 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(1, 3, 5, 2, 8, 8), (2, 4, 70, 4, 12, 20),
                                                  (8, 32, 688, 8, 32, 64), (8, 2, 43, 8, 320, 320),
                                                  (2, 3, 9, 1, 40, 72)])
def test_wgrad_kernel_matches_plain(cuda, b, h, w, groups, cig, cog):
    """K4: bf16 out, one rounding of an fp32 sum taken in another order (2**-7
    of max); its split sum runs in a fixed order, so two calls agree bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, h, w, groups * cig), generator=g, device=cuda).bfloat16()
    gy = torch.randn((b, h, w, groups * cog), generator=g, device=cuda).bfloat16()
    before = grouped_conv3x3_wgrad.launches
    got = grouped_conv3x3_wgrad(x, gy, groups)
    again = grouped_conv3x3_wgrad(x, gy, groups)
    torch.cuda.synchronize()
    assert grouped_conv3x3_wgrad.launches == before + 2
    assert got.shape == (groups, 9 * cig, cog) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert _rel_err(got.float().cpu(),
                    grouped_conv3x3_wgrad_plain(x, gy, groups).float().cpu()) <= 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(8, 32, 688, 8, 64, 32), (8, 16, 344, 8, 128, 64),
                                                  (8, 8, 172, 8, 192, 96), (8, 4, 86, 8, 288, 256),
                                                  (8, 2, 43, 8, 320, 160)])
def test_grouped_conv_kernels_at_each_level(cuda, b, h, w, groups, cig, cog):
    """One main-path shape per level of the reference UNet at the training
    batch: K1 forward, dgrad (K1 on dgrad_weights) and K4 on the Hopper
    kernels, each against its plain version to one bf16 ulp of max (2**-7);
    K4 twice, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((b, h, w, groups * cig), generator=g, device=cuda).bfloat16()
    wt = prepare_weights(torch.randn((groups * cog, cig, 3, 3), generator=g, device=cuda)
                         / (9 * cig) ** 0.5, groups)
    gy = torch.randn((b, h, w, groups * cog), generator=g, device=cuda).bfloat16()
    wd = dgrad_weights(wt)
    assert hopper_takes(cig, cog, x.data_ptr(), wt.data_ptr(), gy.data_ptr())
    assert hopper_takes(cog, cig, gy.data_ptr(), wd.data_ptr(), x.data_ptr())
    for got, want in ((grouped_conv3x3(x, wt, groups), grouped_conv3x3_plain(x, wt, groups)),
                      (grouped_conv3x3(gy, wd, groups), grouped_conv3x3_plain(gy, wd, groups))):
        torch.cuda.synchronize()
        assert _rel_err(got.float().cpu(), want.float().cpu()) <= 2 ** -7
    dw = grouped_conv3x3_wgrad(x, gy, groups)
    again = grouped_conv3x3_wgrad(x, gy, groups)
    torch.cuda.synchronize()
    assert torch.equal(dw, again)
    assert _rel_err(dw.float().cpu(),
                    grouped_conv3x3_wgrad_plain(x, gy, groups).float().cpu()) <= 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(2, 4, 70, 4, 16, 8), (2, 32, 688, 8, 32, 64),
                                                  (2, 2, 43, 8, 320, 320)])
def test_grouped_conv_fn_matches_plain(cuda, b, h, w, groups, cig, cog):
    """GroupedConv3x3Fn on the card (K1 forward, K1 on dgrad_weights, K4)
    against the same Function on CPU copies (the plain versions): forward
    and input gradient to one bf16 ulp of max (2**-7); the fp32 weight
    gradient, which passes through prepare_weights' bf16 cast, to 2**-7."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((b, h, w, groups * cig), generator=g, device=cuda).bfloat16()
    wgt = torch.randn((groups * cog, cig, 3, 3), generator=g, device=cuda) / (9 * cig) ** 0.5
    r = torch.randn((b, h, w, groups * cog), generator=g, device=cuda)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        tx = x.detach().to(dev).requires_grad_()
        tw = wgt.detach().to(dev).requires_grad_()
        out = GroupedConv3x3Fn.apply(tx, prepare_weights(tw, groups), groups)
        (out.float() * r.to(dev)).sum().backward()
        res[dev.type] = [t.detach().float().cpu() for t in (out, tx.grad, tw.grad)]
    for got, want in zip(res["cuda"], res["cpu"]):
        assert _rel_err(got, want) <= 2 ** -7
    wd = dgrad_weights(prepare_weights(wgt, groups))
    assert wd.shape == (groups, 9 * cog, cig)


def _k3_routes(n, hop):
    """(route, context in which K3 takes it): the route ``ola_plan`` chooses
    and, where that is the Hopper kernel, the gather kernel forced."""
    import contextlib
    routes = [(ola_plan(n, hop).route, contextlib.nullcontext())]
    if routes[0][0] == "hopper":
        routes.append(("gather", gather_everywhere()))
    return routes


def _check_k3(y, win, inv_env, hop, tol):
    """K3 on every route against the plain version (``tol`` of max); each
    call counted once, on its route. Returns the chosen route's frames."""
    out = None
    for route, ctx in _k3_routes(y.shape[-1], hop):
        before = ola_reframe.routes[route]
        with ctx:
            got = ola_reframe(y, win, inv_env, hop)
        torch.cuda.synchronize()
        assert ola_reframe.routes[route] == before + 1
        assert _rel_err(got.float().cpu(),
                        ola_reframe_plain(y, win, inv_env, hop).float().cpu()) <= tol, route
        out = got if out is None else out
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop,dtype,route", [
    (1280, 256, torch.float32, "stockham"), (384, 128, torch.float32, "stockham"),
    (1280, 256, torch.bfloat16, "stockham"),
    (6400, 256, torch.bfloat16, "hopper"), (6400, 256, torch.float32, "hopper"),
    (4096, 256, torch.bfloat16, "hopper"), (4096, 256, torch.float32, "hopper"),
    (6400, 256, torch.bfloat16, "stockham"), (6400, 256, torch.float32, "stockham")])
def test_fgla_kernels_match_plain(cuda, n, hop, dtype, route):
    """Both K2 routes against fgla_frame_plain in float64, at three seeds.
    The spectrum r: 1e-5 of max (fp32: transforms' rounding in another
    order), 2**-6 (bf16: one rounding of the stored result). Frames y in
    fp32: relative L2 <= 1e-5 and a max error within twice the plain fp32
    version's own against float64 plus 1e-6 of max (an fp32 transform's
    rounding varies with the inputs, so a fixed bound on the max error
    passed or failed with the draw); in bf16 2**-6 of max. K3 alongside,
    on each of its routes (the Hopper kernel where ``ola_plan`` takes it,
    and the gather kernel), to 1e-5 of max in fp32 and 2**-6 in bf16."""
    import contextlib
    f, bins = 40, n // 2 + 1
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    forced = route == "stockham" and fgla_plan(n).route != "stockham"
    for seed in range(3):
        g = torch.Generator(device=cuda).manual_seed(seed)
        y = torch.randn((1, 2, f, n), generator=g, device=cuda).to(dtype)
        win = torch.rand(n, generator=g, device=cuda) + 0.1
        inv_env = torch.rand((f - 1) * hop + n, generator=g, device=cuda) + 0.5
        frames = _check_k3(y, win, inv_env, hop, tol)
        spec = torch.rand((1, 2, f, bins), generator=g, device=cuda).to(dtype)
        merged = spec.float().mean(1, keepdim=True).expand_as(spec).to(dtype).contiguous()
        prev = torch.randn((1, 2, f, bins, 2), generator=g, device=cuda).to(dtype)
        tw = dft_twiddles(n, cuda)
        before = fgla_frame.launches
        with stockham_everywhere() if forced else contextlib.nullcontext():
            assert fgla_plan(n, stockham_everywhere.active).route == route
            r, y2 = fgla_frame(frames, prev, spec, merged, 0.3, 0.4975, tw)
        torch.cuda.synchronize()
        assert fgla_frame.launches == before + 1
        r_64, y_64 = fgla_frame_plain(frames, prev, spec, merged, 0.3, 0.4975,
                                      compute=torch.float64)
        assert _rel_err(r.float().cpu(), r_64.float().cpu()) <= tol
        y2, y_64 = y2.double(), y_64.double()
        scale = y_64.abs().max().item()
        err = (y2 - y_64).abs().max().item()
        if dtype == torch.float32:
            _, y_32 = fgla_frame_plain(frames, prev, spec, merged, 0.3, 0.4975)
            plain_err = (y_32.double() - y_64).abs().max().item()
            assert ((y2 - y_64).norm() / y_64.norm()).item() <= 1e-5
            assert err <= 2 * plain_err + 1e-6 * scale, (err, plain_err, scale)
        else:
            assert err <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(6400, 14), (4096, 10), (6400, 60), (4096, 40), (1280, 4),
                                 (1280, 5), (6400, 5504), (384, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ola_reframe_routes_match_plain(cuda, n, f, dtype):
    """K3 on both routes against the plain version at hop 256 (hop 128 at
    n_fft 384: the gather kernel only), at the smallest F whose reflect
    zones nearly meet (14 at 6400, 10 at 4096), at the serving F and in
    between: 1e-5 of max in fp32 (sums in another order), 2**-6 in bf16 (one
    rounding of the stored result)."""
    hop = 128 if n == 384 else 256
    g = torch.Generator(device=cuda).manual_seed(11)
    y = torch.randn((2, f, n), generator=g, device=cuda).to(dtype)
    win = torch.rand(n, generator=g, device=cuda) + 0.1
    inv_env = torch.rand((f - 1) * hop + n, generator=g, device=cuda) + 0.5
    _check_k3(y, win, inv_env, hop, 1e-5 if dtype == torch.float32 else 2 ** -6)


@pytest.mark.cuda
def test_ola_reframe_hopper_route(cuda):
    """The kernel's compiled chunk counts are ``ola_plan``'s; a frame, window
    or envelope whose data pointer is not 16-byte aligned raises on the
    Hopper route."""
    import ctypes
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    for n, f in ((6400, 5504), (4096, 5504), (6400, 14), (1280, 4)):
        plan = ola_plan(n, 256)
        got = (ctypes.c_int * 6)()
        assert library().lib.dd_ola_reframe_hopper_plan(n, f, got) == 1
        assert list(got) == [plan.chunks, plan.edge_chunks, plan.edge_signal_chunks,
                             plan.interior_chunks(f), 256, 8]
    assert library().lib.dd_ola_reframe_hopper_plan(1000, 10, (ctypes.c_int * 6)()) == 0
    n, f = 1280, 6
    y = torch.randn((2, f, n), device=cuda)
    win = torch.rand(n, device=cuda) + 0.1
    inv_env = torch.rand((f - 1) * 256 + n, device=cuda) + 0.5

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view_as(t).copy_(t)
    for args in ((shifted(y), win, inv_env), (y, shifted(win), inv_env),
                 (y, win, shifted(inv_env))):
        with pytest.raises(ValueError, match="16-byte"):
            ola_reframe(*args, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6400, 4096])
def test_fgla_hopper_route(cuda, n):
    """The kernel's compiled plan is fgla_plan's; the seed call (spectrum in)
    and a call without the inverse match the plain version; a frame whose
    data pointer is not 16-byte aligned raises."""
    import ctypes
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    plan = fgla_plan(n)
    got = (ctypes.c_int * 6)()
    assert library().lib.dd_fgla_frame_hopper_plan(n, got) == 1
    assert list(got) == [plan.points, plan.threads, plan.frames, *plan.radices]
    g = torch.Generator(device=cuda).manual_seed(4)
    f, bins = 7, n // 2 + 1   # a ragged last block
    spec = torch.rand((1, 2, f, bins), generator=g, device=cuda)
    merged = spec.mean(1, keepdim=True).expand_as(spec).contiguous()
    ang = torch.randn((1, 2, f, bins, 2), generator=g, device=cuda)
    tw = dft_twiddles(n, cuda)
    _, y = fgla_frame(ang, None, spec, merged, 0.1, 0.4975, tw, spectral_in=True)
    _, y_64 = fgla_frame_plain(ang, None, spec, merged, 0.1, 0.4975, spectral_in=True,
                               compute=torch.float64)
    assert _rel_err(y.cpu(), y_64.float().cpu()) <= 1e-5
    frames = torch.randn((1, 2, f, n), generator=g, device=cuda)
    r, none = fgla_frame(frames, None, spec, merged, 0.1, 0.4975, tw, inverse=False)
    r_64, _ = fgla_frame_plain(frames, None, spec, merged, 0.1, 0.4975, compute=torch.float64)
    assert none is None and _rel_err(r.cpu(), r_64.float().cpu()) <= 1e-5
    shifted = torch.empty(frames.numel() + 1, device=cuda)[1:].view_as(frames)
    with pytest.raises(ValueError, match="16-byte"):
        fgla_frame(shifted, None, spec, merged, 0.1, 0.4975, tw)


@pytest.mark.cuda
@pytest.mark.parametrize("bw,stride,bc,h,w", [(32, 4, 2, 32 + 21, 32 + 13),
                                              (64, 8, 2, 64 + 19, 64 + 9),
                                              (32, 4, 16, 256 + 32, 680 + 32),
                                              (64, 8, 16, 256 + 64, 680 + 64),
                                              (32, 4, 1, 32 + 21, 32 + 13),     # bc 1
                                              (64, 8, 1, 64 + 19, 64 + 9),
                                              (32, 4, 2, 32 + 3, 32 + 2),       # one position
                                              (64, 8, 2, 64 + 5, 64 + 3),
                                              (32, 4, 2, 32 + 9, 32 + 21),      # 6 column blocks
                                              (32, 3, 2, 32 + 21, 32 + 23)])    # another stride
def test_mss2d_kernels_match_plain(cuda, bw, stride, bc, h, w):
    """K5 per-image sums to 1e-4 relative (fp32 sums in another order;
    measured 4e-7). K6 to 1e-4 of max with target = sample / 2, where
    |S| - |T| = |S| / 2 exactly in both versions; with an independent target
    some bins have |S| ~ |T| and the sign of their difference flips between
    two fp32 evaluations, so there the gradients agree to 1e-3 relative L2
    (measured 1.6e-4 at the chip path's shapes). Two K6 calls agree bit for
    bit; the small shapes leave ragged edges: rows and columns no block
    covers, fewer positions than a ring step, and at bw 32 a thread block
    (4 column blocks) whose last column blocks lie past the image."""
    g = torch.Generator(device=cuda).manual_seed(3)
    s = torch.randn((bc, h, w), generator=g, device=cuda)
    gg = torch.randn((bc,), generator=g, device=cuda)
    win, wgt = _window_2d("flat_top", bw), product_weights(bw) / bw
    t = torch.randn((bc, h, w), generator=g, device=cuda)
    before = mss2d_block_loss.launches, mss2d_block_loss_grad.launches
    got = mss2d_block_loss(s, t, bw, stride, win, wgt)
    torch.cuda.synchronize()
    want = mss2d_block_loss_plain(s, t, bw, stride, win, wgt)
    assert ((got - want).abs() <= 1e-4 * want.abs()).all()
    ds, dt = mss2d_block_loss_grad(s, t, gg, bw, stride, win, wgt)
    again, _ = mss2d_block_loss_grad(s, t, gg, bw, stride, win, wgt)
    torch.cuda.synchronize()
    assert torch.equal(ds, again)
    for a, b in zip((ds, dt), mss2d_block_loss_grad_plain(s, t, gg, bw, stride, win, wgt)):
        assert ((a - b).norm() / b.norm()).item() <= 1e-3
    half = 0.5 * s
    ds, dt = mss2d_block_loss_grad(s, half, gg, bw, stride, win, wgt)
    for a, b in zip((ds, dt), mss2d_block_loss_grad_plain(s, half, gg, bw, stride, win, wgt)):
        assert _rel_err(a.cpu(), b.cpu()) <= 1e-4
    only_s, none = mss2d_block_loss_grad(s, half, gg, bw, stride, win, wgt, need_target=False)
    assert none is None and torch.equal(only_s, ds)
    assert (mss2d_block_loss.launches, mss2d_block_loss_grad.launches) == \
        (before[0] + 1, before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("bw,stride,window", [(16, 2, "flat_top"),
                                              (32, 4, "flat_top_circular"),
                                              (32, 33, "flat_top"), (128, 16, "flat_top")])
def test_mss2d_takes_every_shape_on_the_card(cuda, bw, stride, window):
    """Block widths other than 32 and 64, windows that are not separable,
    strides above the block width and the widest block (all of which the
    JAX op takes) run on the card through the direct-DFT kernels, routed by
    shape and counted on the "dft" route: the loss, its gradient and the
    autograd Function against the plain version on CPU copies, 1e-4
    relative (fp32 sums in another order); two gradient calls bit-equal."""
    from dualdiffusion_tpu_torch.ops.kernels import Mss2dBlockLossFn
    g = torch.Generator(device=cuda).manual_seed(12)
    s = torch.randn((2, 40 + bw, 37 + bw), generator=g, device=cuda)
    t = torch.randn((2, 40 + bw, 37 + bw), generator=g, device=cuda)
    gg = torch.randn((2,), generator=g, device=cuda)
    win, wgt = _window_2d(window, bw), product_weights(bw) / bw
    launches = mss2d_block_loss.launches, mss2d_block_loss_grad.launches
    dft = mss2d_block_loss.routes["dft"], mss2d_block_loss_grad.routes["dft"]
    x = s.clone().requires_grad_()
    loss = Mss2dBlockLossFn.apply(x, t, bw, stride, win, wgt)
    (loss * gg).sum().backward()
    got = (mss2d_block_loss(s, t, bw, stride, win, wgt),
           *mss2d_block_loss_grad(s, t, gg, bw, stride, win, wgt), loss, x.grad)
    torch.cuda.synchronize()
    assert torch.equal(got[1], x.grad)
    cpu = [v.cpu() for v in (s, t, gg)]
    xc = cpu[0].clone().requires_grad_()
    loss_c = Mss2dBlockLossFn.apply(xc, cpu[1], bw, stride, win, wgt)
    (loss_c * cpu[2]).sum().backward()
    want = (mss2d_block_loss_plain(*cpu[:2], bw, stride, win, wgt),
            *mss2d_block_loss_grad_plain(*cpu, bw, stride, win, wgt), loss_c, xc.grad)
    for a, b in zip(got, want):
        assert _rel_err(a.detach().cpu(), b.detach()) <= 1e-4
    assert (mss2d_block_loss.launches, mss2d_block_loss_grad.launches) == \
        (launches[0] + 2, launches[1] + 2)
    assert (mss2d_block_loss.routes["dft"], mss2d_block_loss_grad.routes["dft"]) == \
        (dft[0] + 2, dft[1] + 2)


@pytest.mark.cuda
def test_mss2d_compiled_plans(cuda):
    """The kernel's compiled plans are MSS2D_PLANS (the CPU model's)."""
    import ctypes
    from dualdiffusion_tpu_torch.ops.kernels import MSS2D_PLANS
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    for bw, p in MSS2D_PLANS.items():
        got = (ctypes.c_int * 5)()
        assert library().lib.dd_mss2d_plan(bw, got) == 1
        assert list(got) == [p.threads, p.cols, p.z_stride, p.q_stride, p.x_slots]
    assert library().lib.dd_mss2d_plan(16, (ctypes.c_int * 5)()) == 0


@pytest.mark.cuda
def test_mss2d_fused_loss_on_card_matches_cpu(cuda):
    """The multi-scale loss with the "stack" mid/side (widths 8/16 unfold,
    32/64 through K5/K6) on the card against the CPU's plain versions:
    per-sample losses to 1e-4 relative, the sample's gradient to 1e-4 of max
    (target = sample / 2, see test_mss2d_kernels_match_plain)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    s = torch.randn((2, 2, 80, 100), generator=g, device=cuda)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x = s.detach().to(dev).requires_grad_()
        loss = mss2d_loss_fused(x, 0.5 * s.to(dev), use_midside=True)
        (loss * torch.tensor([1.0, 2.0], device=dev)).sum().backward()
        out[dev.type] = (loss.detach().cpu(), x.grad.cpu())
    assert ((out["cuda"][0] - out["cpu"][0]).abs() <= 1e-4 * out["cpu"][0].abs()).all()
    assert _rel_err(out["cuda"][1], out["cpu"][1]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bw", [32, 64])
def test_mss2d_on_mdct_images_matches_plain(cuda, bw):
    """K5/K6 on what the m1 DAE step feeds them: (B, 2, 256, W) MDCT images
    of seeded stereo audio (signed, unlike a mel), rotated per sample, cut
    as the trainer cuts them, mid/side stacked and reflect-padded by bw/2 at
    stride bw/8. Per-image losses to 1e-4 relative; the gradient to 1e-4 of
    max with target = sample / 2 and to 1e-3 relative L2 against the
    reconstruction (see test_mss2d_kernels_match_plain)."""
    import torch.nn.functional as F
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.models.mp import midside_transform
    fmt = MSMDCTDualFormat(MSMDCTDualFormatConfig())
    g = torch.Generator(device=cuda).manual_seed(21)
    t = torch.arange(48000, device=cuda) / 32000
    audio = (0.3 * torch.sin(2 * np.pi * 440 * t) * torch.ones((2, 2, 1), device=cuda)
             + 0.05 * torch.randn((2, 2, 48000), generator=g, device=cuda))
    theta = torch.rand((2,), generator=g, device=cuda) * 2 * np.pi
    with torch.no_grad():
        x = fmt.raw_to_mdct(audio, theta)[:, :, 4:-4]
        x = x[:, :, : x.shape[2] // 8 * 8].permute(0, 3, 1, 2)
    assert x.shape[:3] == (2, 2, 256)
    recon = x + 0.1 * torch.randn(x.shape, generator=g, device=cuda)
    stride, pad = bw // 8, bw // 2
    s, tt = (F.pad((midside_transform(v, 1) * np.sqrt(2.0)).reshape(-1, 1, *x.shape[2:]),
                   (pad,) * 4, mode="reflect")[:, 0] for v in (recon, x))
    gg = torch.rand((s.shape[0],), generator=g, device=cuda) + 0.5
    win, wgt = _window_2d("flat_top", bw), product_weights(bw) / bw
    before = mss2d_block_loss.routes["fft"], mss2d_block_loss_grad.routes["fft"]
    got = mss2d_block_loss(s, tt, bw, stride, win, wgt)
    want = mss2d_block_loss_plain(s, tt, bw, stride, win, wgt)
    assert ((got - want).abs() <= 1e-4 * want.abs()).all()
    for a, b in zip(mss2d_block_loss_grad(s, 0.5 * s, gg, bw, stride, win, wgt),
                    mss2d_block_loss_grad_plain(s, 0.5 * s, gg, bw, stride, win, wgt)):
        assert _rel_err(a.cpu(), b.cpu()) <= 1e-4
    a = mss2d_block_loss_grad(s, tt, gg, bw, stride, win, wgt, need_target=False)[0]
    b = mss2d_block_loss_grad_plain(s, tt, gg, bw, stride, win, wgt, need_target=False)[0]
    assert ((a - b).norm() / b.norm()).item() <= 1e-3
    assert (mss2d_block_loss.routes["fft"], mss2d_block_loss_grad.routes["fft"]) == \
        (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("l,h,d,window,causal", [
    (300, 3, 64, None, False),   # dense, ragged last tile
    (256, 3, 64, None, True),    # causal
    (1000, 3, 32, 100, False),   # banded: tiles skipped on both sides
    (517, 3, 128, None, False),  # D = 128, ragged
    (130, 3, 64, 40, True),      # banded + causal
    (77, 3, 32, 0, False),       # one key per row
    (2100, 3, 64, None, False),  # past FLASH_MIN_SEQ
    (700, 4, 8, None, False),    # head widths zero-padded in the loads: 8 -> 32
    (700, 12, 24, 90, False),    # 24 -> 32, banded
    (600, 4, 96, None, True),    # 96 -> 128, causal
    (700, 12, 192, None, False),  # 192 -> 256
    (5504, 8, 64, None, False),  # the full-attention model's level 1
    (300, 2, 257, None, False),  # wider than 256: the D-chunked kernel (257 -> 264 copies)
    (260, 2, 320, 64, False),    # 320, banded
    (200, 2, 512, None, True),   # 512, causal
])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
def test_flash_attention_kernel_matches_plain(cuda, l, h, d, window, causal, dtype, tol):
    """K7 against the fp32 plain version. bf16: P is rounded to bf16 for the
    P V products (as the JAX einsum route rounds its probabilities) and o is
    stored in bf16, so 2e-2 of max |o|; fp32 (fp32 FMA): summation order,
    2e-5. Inputs are the UNet's transposed (B, L, H, D) views; the output
    keeps q's strides where D is a multiple of 8."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, l, h, d), generator=g, device=cuda).to(dtype).transpose(1, 2)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert d % 8 or got.stride() == q.stride()      # else a view of a padded output
    want = flash_attention_plain(q, k, v, window=window, causal=causal)
    assert _rel_err(got.float().cpu(), want.float().cpu()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
def test_flash_attention_takes_any_batch_times_heads(cuda, dtype, tol):
    """B * H = 70,000 blocks' rows (above the 65,535 of a grid's y and z):
    the grid folds B * H into x, so every (b, h) is computed."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((2, 35000, 16, 8), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v)
    assert _rel_err(got.float().cpu(), want.float().cpu()) <= tol


@pytest.mark.cuda
def test_flash_attention_takes_any_layout(cuda):
    """Strided views the kernel reads in place (16-byte aligned rows and
    start) and views it copies first (a 2-byte offset) give the output of
    contiguous inputs, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(6)
    base = torch.randn((1, 2, 200, 72), generator=g, device=cuda).bfloat16()
    for q in (base[..., 8:], base[..., 1:65]):
        want = flash_attention(q.contiguous(), q.contiguous(), q.contiguous())
        got = flash_attention(q, q, q)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_pads_unaligned_head_widths(cuda):
    """D 20 in bf16 (40-byte rows: no TMA view) runs on zero-padded copies:
    a strided view with a 2-byte offset gives the output of its contiguous
    copy bit for bit, and both agree with the plain version (2e-2 of max)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randn((2, 300, 3, 24), generator=g, device=cuda).bfloat16().transpose(1, 2)
    q = base[..., 1:21]
    got = flash_attention(q, q, q)
    want = flash_attention(q.contiguous(), q.contiguous(), q.contiguous())
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, want)
    assert _rel_err(got.float().cpu(), flash_attention_plain(q, q, q).float().cpu()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.2, 0.0, 0.05])
def test_flash_attention_takes_any_scale(cuda, scale):
    """The bf16 kernel applies the scale inside its exponent, which needs a
    scale >= 0: the wrapper moves a negative one onto q, and 0 gives the
    mean of the visible values. Against the plain version, 2e-2 of max."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((2, 3, 300, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    got = flash_attention(q, k, v, scale=scale, window=50)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, scale=scale, window=50)
    assert _rel_err(got.float().cpu(), want.float().cpu()) <= 2e-2


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.randn((1, 4, 8, 16), device=cuda)            # fp32: K1 takes bf16 only
    wt = prepare_weights(torch.randn((16, 8, 3, 3), device=cuda), 2)
    with pytest.raises(TypeError):
        grouped_conv3x3(x, wt, 2)
    with pytest.raises(ValueError):
        grouped_conv3x3(x.bfloat16(), wt.cpu(), 2)          # mixed devices
    s = torch.randn((2, 40, 40), device=cuda)
    with pytest.raises(TypeError):                           # fp32 only
        mss2d_block_loss(s.double(), s.double(), 32, 4, _window_2d("flat_top", 32),
                         product_weights(32))
    with pytest.raises(ValueError):                          # mixed devices
        mss2d_block_loss(s, s.cpu(), 32, 4, _window_2d("flat_top", 32), product_weights(32))
    a = torch.randn((1, 2, 64, 64), device=cuda).half()      # bf16 and fp32 only
    with pytest.raises(TypeError):
        flash_attention(a, a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("phase_init,tol", [("spsi", 1e-3), ("flat", 1e-2)])
def test_griffinlim_kernel_loop_matches_plain_loop(cuda, phase_init, tol):
    """fp32 state: the K3 + K2 loop and the plain stft/istft loop run the
    same iteration on different FFTs; after 3 iterations they agree to 1e-3
    of max from SPSI phases, and to 1e-2 from flat phases, whose
    near-cancelling bins take their phase from rounding noise (measured
    1.2e-3)."""
    import math

    from dualdiffusion_tpu_torch.ops import get_window, griffinlim, griffinlim_reference, stft
    n_fft, hop, frames = 1280, 256, 41
    win = get_window("hann_power", n_fft, exponent=8.0)
    t = torch.arange((frames - 1) * hop, device=cuda, dtype=torch.float64) / 32000
    sig = sum(0.2 * torch.sin(2 * math.pi * f * t) for f in (220.0, 473.0, 881.0)).float()
    mag = stft(torch.stack([sig, 0.8 * sig])[None], win, n_fft, hop).abs()
    kw = dict(n_iter=3, work_dtype="float32", phase_init=phase_init)
    got = griffinlim(mag, win, n_fft, hop, **kw)
    want = griffinlim_reference(mag, win, n_fft, hop, **kw)
    assert _rel_err(got.cpu(), want.cpu()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("cig,cog", [(32, 64), (64, 32)])
def test_grouped_conv_kernel_at_the_seamless_width(cuda, cig, cog):
    """The seamless loop pads the 688 latent columns of a 45 s clip by 32 on
    each side: K1 at level 0 of the reference UNet at W 752, batch 2 (CFG),
    both MLP convs, against the plain version to one bf16 ulp of max."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 32, 752, 8 * cig), generator=g, device=cuda).bfloat16()
    wt = prepare_weights(torch.randn((8 * cog, cig, 3, 3), generator=g, device=cuda)
                         / (9 * cig) ** 0.5, 8)
    assert hopper_takes(cig, cog, x.data_ptr(), wt.data_ptr())
    before = grouped_conv3x3.launches
    got = grouped_conv3x3(x, wt, 8)
    torch.cuda.synchronize()
    assert grouped_conv3x3.launches == before + 1
    assert _rel_err(got.float().cpu(), grouped_conv3x3_plain(x, wt, 8).float().cpu()) <= 2 ** -7


@pytest.mark.cuda
def test_inpainting_unet_forward_on_the_card_matches_cpu(cuda):
    """A UNet with the inpainting reference and mask channels (4 + 4 + 1
    inputs, grouped MLP convs on K1) fed a reference and a half mask, on the
    card against the CPU: bf16 trunks that round at different places, 5e-2
    of max."""
    import copy
    from dualdiffusion_tpu_torch.models import UNet, UNetConfig

    g = torch.Generator().manual_seed(13)
    cfg = UNetConfig(in_channels=9, out_channels=4, model_channels=32, channel_mult=(1, 2),
                     num_layers_per_block=1, channels_per_head=32, mlp_multiplier=2,
                     mlp_groups=2)
    unet = UNet(cfg).init_weights(g).eval()
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    x = torch.randn((2, 8, 32, 4), generator=g)
    mask = torch.zeros((2, 8, 32, 1))
    mask[:, :, :16] = 1.0
    ref = torch.cat([torch.randn((2, 8, 32, 4), generator=g) * (1 - mask), mask], dim=-1)
    sigma = torch.tensor([3.0, 0.5])
    before = grouped_conv3x3.launches
    with torch.no_grad():
        want = unet(x, sigma, None, ref)
        got = copy.deepcopy(unet).to(cuda)(x.to(cuda), sigma.to(cuda), None, ref.to(cuda))
    torch.cuda.synchronize()
    assert grouped_conv3x3.launches > before
    assert torch.isfinite(got).all()
    assert _rel_err(got.float().cpu(), want) < 5e-2


@pytest.mark.cuda
def test_tiny_pipeline_generates_through_the_kernels(cuda):
    """A tiny model (grouped MLP convs) generates finite audio on the card
    and every kernel is launched on the way."""
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams

    g = torch.Generator(device=cuda).manual_seed(0)
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=63 * 256)
    pipe = Pipeline({
        "unet": ModuleHandle("unet", "unet", ucfg, UNet(ucfg, device=cuda).init_weights(g)),
        "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg, device=cuda).init_weights(g)),
        "format": ModuleHandle("format", "format:spectrogram", fcfg, SpectrogramFormat(fcfg))})
    before = launch_counts()
    prompt = torch.randn((1, 1024), generator=g, device=cuda)
    raw = pipe.generate(SampleParams(steps=2, num_fgla_iters=3), prompt_embedding=prompt)["raw"]
    after = launch_counts()
    assert raw.shape == (1, 2, 63 * 256) and torch.isfinite(raw).all()
    assert all(after[k] > before[k] for k in ("grouped_conv3x3", "fgla_frame", "ola_reframe")), \
        (before, after)


@pytest.mark.cuda
def test_model_server_serves_on_the_card(cuda, tmp_path):
    """``launch(device="cuda")``: a spawned model server loads a tiny model
    (made by the port, grouped MLP convs) onto the card, lists ``cuda:0``
    and answers one 2-step request with finite numpy output."""
    import time
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.serving import launch

    g = torch.Generator().manual_seed(0)
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=16, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=63 * 256)
    Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, UNet(ucfg).init_weights(g)),
              "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg).init_weights(g)),
              "format": ModuleHandle("format", "format:spectrogram", fcfg,
                                     SpectrogramFormat(fcfg))}).save_pretrained(tmp_path / "m")

    def wait(state, timeout=300):
        t0 = time.time()
        while state.get("cmd") is not None:
            assert time.time() - t0 < timeout, state.get("cmd")
            time.sleep(0.05)
        assert state.get("error") is None, state.get("error")

    proc, state = launch(str(tmp_path / "m"), device="cuda")
    try:
        wait(state)
        state["cmd"] = "get_available_devices"
        wait(state)
        assert "cuda:0" in state["available_devices"]
        state["sample_params"] = {"steps": 2, "num_fgla_iters": 3, "seed": 5}
        state["cmd"] = "generate"
        wait(state)
        out = state["generate_output"]
        assert isinstance(out["raw"], np.ndarray) and out["raw"].shape == (1, 2, 63 * 256)
        assert np.isfinite(out["raw"]).all() and np.isfinite(out["latents"]).all()
        assert out["seed"] == 5
    finally:
        state["cmd"] = "shutdown"
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()


@pytest.mark.cuda
def test_tiny_ddec_generate_on_the_card_matches_cpu(cuda):
    """``generate(decode_mode="auto")`` on a tiny model with a "ddec" module
    (the MS-MDCT dual format of tests/test_torch_ms_mdct_generate.py): the
    card (K1 in the latent UNet, cuDNN in the DDEC) against the CPU, same
    weights and noise. Both run bf16 trunks that round at different places:
    latents and mel to 5e-2 of max, the audio to 0.1 relative L2."""
    import copy
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (MSMDCTDualFormat,
                                                        MSMDCTDualFormatConfig)
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams

    g = torch.Generator().manual_seed(0)
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    ddcfg = UNetConfig(in_channels=2, out_channels=2, in_num_freqs=32, in_psd_freqs=128,
                       sigma_max=20.0, sigma_min=3e-5, model_channels=16, channel_mult=(1, 2),
                       num_layers_per_block=1, mlp_multiplier=2, add_constant_channel=True)
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    modules = {"unet": UNet(ucfg).init_weights(g), "dae": DAE(dcfg).init_weights(g),
               "ddec": UNet(ddcfg).init_weights(g)}
    with torch.no_grad():
        modules["unet"].core.out_gain.fill_(1.0)
        modules["ddec"].core.out_gain.fill_(1.0)
    cfgs = {"unet": ucfg, "dae": dcfg, "ddec": ddcfg}
    params = SampleParams(steps=2)
    noise = {"init_noise": torch.randn((1, 8, 16, 8), generator=g),
             "ddec_init_noise": torch.randn((1, 32, 64, 2), generator=g)}
    noise["step_noise"] = [torch.randn((1, 8, 16, 8), generator=g) for _ in range(2)]
    noise["ddec_step_noise"] = [torch.randn((1, 32, 64, 2), generator=g) for _ in range(2)]
    prompt = torch.randn((1, 1024), generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = Pipeline({n: ModuleHandle(n, n, cfgs[n], copy.deepcopy(m).to(dev))
                         for n, m in modules.items()})
        pipe.modules["format"] = ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                              MSMDCTDualFormat(fcfg))
        before = launch_counts()
        out = pipe.generate(params, prompt_embedding=prompt.to(dev),
                            **{k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
                               for k, v in noise.items()})
        after = launch_counts()
        outs[str(dev)] = {k: v.float().cpu() for k, v in out.items()}
    assert after["grouped_conv3x3"] > before["grouped_conv3x3"]
    assert all(after[k] == before[k] for k in ("fgla_frame", "ola_reframe", "flash_attention"))
    got, want = outs["cuda"], outs["cpu"]
    assert got["raw"].shape == (1, 2, 63 * 32) and torch.isfinite(got["raw"]).all()
    assert _rel_err(got["latents"], want["latents"]) < 5e-2
    assert _rel_err(got["sample"], want["sample"]) < 5e-2
    assert ((got["raw"] - want["raw"]).norm() / want["raw"].norm()).item() < 0.1


@pytest.mark.cuda
def test_training_forward_raises_without_its_kernel(cuda, monkeypatch):
    """No fallback: when the kernel library cannot be had, a training-mode
    grouped conv on a CUDA tensor raises instead of going to cuDNN."""
    import dualdiffusion_tpu_torch.ops.kernels.grouped_conv as gc
    from dualdiffusion_tpu_torch.models.layers import MPConv

    def no_library():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(gc, "library", no_library)
    conv = MPConv(16, 16, (3, 3), groups=2, device=cuda)
    conv.init_weights(torch.Generator(device=cuda).manual_seed(0))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        conv(torch.randn((1, 2, 8, 16), device=cuda).bfloat16(), training=True)


def _tiny_encode_model(path, device):
    """A tiny ms_mdct_dual + DAE model directory (bf16 DAE, ratio 4)."""
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
                     in_num_freqs=32)
    dae = DAE(dcfg, device=device).init_weights(torch.Generator(device=device).manual_seed(3))
    Pipeline({"dae": ModuleHandle("dae", "dae", dcfg, dae),
              "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg))}).save_pretrained(path)
    return dae


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.cuda
def test_tiled_encode_on_the_card_matches_cpu(cuda, tmp_path):
    """DAE ``tiled_encode`` of a (2, 32, 1024, 2) mel in six chunks, the
    tiny bf16 DAE on the card against the same weights on the CPU: bf16
    rounds each of ~10 layers to 2**-9 in another summation order, so 3e-2
    relative L2; no kernel of the port launches (dense convs on cuDNN)."""
    from dualdiffusion_tpu_torch.models import tiled_encode
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    dae = _tiny_encode_model(tmp_path, cuda)
    cpu_dae = _tiny_encode_model(tmp_path / "cpu", "cpu")
    cpu_dae.load_state_dict({k: v.cpu() for k, v in dae.state_dict().items()})
    x = torch.randn((2, 32, 1024, 2), generator=torch.Generator().manual_seed(4))
    before = launch_counts()
    got = tiled_encode(dae, x.to(cuda), None, 256, 32)
    torch.cuda.synchronize()
    assert launch_counts() == before
    want = tiled_encode(cpu_dae, x, None, 256, 32)
    assert got.shape == (2, 8, 256, 8) and torch.isfinite(got).all()
    assert _rel_l2(got.cpu(), want) < 3e-2


@pytest.mark.cuda
def test_encode_stage_on_the_card_matches_cpu(cuda, tmp_path):
    """The encode stage in-process on the card and on the CPU, one stereo
    song, 8 variations: float16 latents agree to the bf16 bound above
    (3e-2 relative L2); the card's worker reports its peak memory."""
    from dualdiffusion_tpu_torch.dataset import processes as P
    from dualdiffusion_tpu_torch.dataset.processor import DatasetProcessorConfig
    _tiny_encode_model(tmp_path, "cpu")
    t = np.arange(16000) / 32000
    audio = np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.2 * np.sin(2 * np.pi * 660 * t)])
    item = {"path": str(tmp_path / "a.wav"), "audio": audio.astype(np.float32),
            "sample_rate": 32000}
    out = {}
    for device in ("cuda", "cpu"):
        stage = P.EncodeStage(P.EncodeConfig(model_path=str(tmp_path), device=device,
                                             max_chunk=256, overlap=32,
                                             encode_embeddings=False))
        stage.start_process(DatasetProcessorConfig(dataset_path=str(tmp_path)), 0)
        out[device] = stage.process(dict(item))["tensors"]["latents"]
        stage.finish_process()
    assert out["cuda"].dtype == np.float16 and out["cuda"].shape == (8, 8, 8, 123)
    assert np.isfinite(out["cuda"]).all()
    assert _rel_l2(out["cuda"], out["cpu"]) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,groups", [((2, 3, 3), 1), ((1, 3, 3), 8), ((3, 3, 3), 2),
                                           ((2, 1, 1), 1)])
def test_mpconv_rank3_reflect_on_the_card_matches_cpu(cuda, kernel, groups):
    """A rank-3 MPConv with W reflect padding on (B, Z, H, W, C) input, on
    cuDNN in fp32 (TF32 off) against the CPU: float rounding, 1e-5 of max;
    K1 never takes the 5-D tensor."""
    from dualdiffusion_tpu_torch.models.layers import MPConv
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.ops.kernels.common import no_tf32
    cpu = MPConv(64, 64, kernel, groups=groups, w_pad_mode="reflect", use_bias=True)
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = MPConv(64, 64, kernel, groups=groups, w_pad_mode="reflect", use_bias=True,
                  device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 2, 8, 37, 64), generator=torch.Generator().manual_seed(1))
    before = launch_counts()
    with torch.no_grad(), no_tf32():
        got = card(x.to(cuda))
        torch.cuda.synchronize()
    assert launch_counts() == before
    assert _rel_err(got.cpu(), cpu(x).detach()) <= 1e-5


@pytest.mark.cuda
def test_tiny_unet_3d_on_the_card_matches_cpu(cuda):
    """The tiny d1 UNet (stereo-folded, reflect padding, "full" attention,
    ln-freq channel) forward on the card against the CPU, bf16 trunks:
    the network branch to 3e-2 of its max, as the JAX comparison; no K1."""
    from dualdiffusion_tpu_torch.models import UNet, UNetConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    cfg = UNetConfig(in_channels=4, out_channels=4, in_channels_emb=16, model_channels=16,
                     channel_mult=(1, 2), channels_per_head=16, num_layers_per_block=1,
                     attn_levels=(1,), attn_axis="full", mlp_multiplier=2, mlp_groups=2,
                     double_midblock=True, midblock_attn=True, use_3d=True, io_kernel_z=2,
                     conv_w_pad="reflect", io_bias=False, always_skip=True,
                     add_constant_channel=True, add_ln_freqs_channel=True)
    cpu = UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.core.out_gain.fill_(1.0)
    card = UNet(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 2, 16, 24, 4), generator=g)
    sigma = torch.tensor([3.0, 0.5])
    emb_in = torch.randn((2, 16), generator=g)
    before = launch_counts()
    with torch.no_grad():
        got = card(x.to(cuda), sigma.to(cuda),
                   card.get_embeddings(emb_in.to(cuda), torch.ones(2, device=cuda))).cpu()
        want = cpu(x, sigma, cpu.get_embeddings(emb_in, torch.ones(2)))
    assert launch_counts()["grouped_conv3x3"] == before["grouped_conv3x3"]
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1, 1)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel_err(got - c_skip * x, want - c_skip * x) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["raw", "mdct", "mdct_psd", "ms_mdct_dual_v1"])
def test_new_format_round_trip_on_the_card_matches_cpu(cuda, name):
    """Each new format's forward and inverse (the MDCT pair where its
    sample is a mel) on 1 s of stereo noise and tones, fp32 on the card
    against the CPU: relative L2 1e-5 (cuFFT and cuBLAS against the CPU's
    FFT and products)."""
    from dualdiffusion_tpu_torch.models.formats import get_format_class
    cls, cfg_cls = get_format_class(name)
    fmt = cls(cfg_cls())
    fwd, inv = ((fmt.raw_to_mdct, fmt.mdct_to_raw) if hasattr(fmt, "mdct_to_raw")
                else (fmt.raw_to_sample, fmt.sample_to_raw))
    t = np.arange(32000) / 32000
    x = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 1760 * t)])[None] * 0.2
    x = torch.from_numpy((x + 0.02 * np.random.default_rng(0).standard_normal(x.shape))
                         .astype(np.float32))
    with torch.no_grad():
        want = fwd(x)
        got = fwd(x.to(cuda))
        back_want, back_got = inv(want), inv(got)
    assert _rel_l2(got.cpu(), want) <= 1e-5
    assert _rel_l2(back_got.cpu(), back_want) <= 1e-5
    assert torch.isfinite(back_got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cig,cog", [(8, 32, 688, 64, 32), (8, 16, 344, 128, 64),
                                           (8, 8, 172, 192, 96), (8, 4, 86, 288, 256),
                                           (8, 2, 43, 320, 160)])
def test_grouped_conv_kernels_at_the_tensor_parallel_shard(cuda, b, h, w, cig, cog):
    """The reference UNet's MLP convs on one rank of a 2-wide model axis: 4
    of the 8 groups, half the input and output channels. K1 forward, dgrad
    and K4 against their plain versions to one bf16 ulp of max (2**-7)."""
    groups = 4
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((b, h, w, groups * cig), generator=g, device=cuda).bfloat16()
    wt = prepare_weights(torch.randn((groups * cog, cig, 3, 3), generator=g, device=cuda)
                         / (9 * cig) ** 0.5, groups)
    gy = torch.randn((b, h, w, groups * cog), generator=g, device=cuda).bfloat16()
    wd = dgrad_weights(wt)
    for got, want in ((grouped_conv3x3(x, wt, groups), grouped_conv3x3_plain(x, wt, groups)),
                      (grouped_conv3x3(gy, wd, groups), grouped_conv3x3_plain(gy, wd, groups)),
                      (grouped_conv3x3_wgrad(x, gy, groups),
                       grouped_conv3x3_wgrad_plain(x, gy, groups))):
        torch.cuda.synchronize()
        assert _rel_err(got.float().cpu(), want.float().cpu()) <= 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("fsdp", [False, True])
def test_world_one_nccl_step_matches_the_unwrapped_step(cuda, fsdp):
    """A process group of one over NCCL: the data-parallel (or FSDP) UNet
    step of a tiny grouped UNet, K1 and K4 launched, against the same step
    without a group on a copy of the model, with the same draws: loss, grad
    norm and parameters equal to 1e-6 (the same kernels on the same inputs;
    FSDP over one rank leaves the weights whole, as JAX's sharding over one
    device does)."""
    import copy

    from dualdiffusion_tpu_torch.models import UNet, UNetConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.parallel import (MeshConfig, ParallelState, make_mesh,
                                                  maybe_initialize_distributed, shutdown)
    from dualdiffusion_tpu_torch.training import (SigmaSampler, UNetTrainConfig,
                                                  build_optimizer, init_train_state,
                                                  make_unet_train_step)
    from dualdiffusion_tpu_torch.training.train_state import draw_unet_step
    ucfg = UNetConfig(in_channels=4, out_channels=4, in_channels_emb=64, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    gen = torch.Generator().manual_seed(3)
    unet = UNet(ucfg).init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    tc = UNetTrainConfig(grad_accum_steps=2)
    n, shape = 8, (8, 16, 64, 4)
    batch = {"samples": torch.randn(shape, generator=gen).to(cuda),
             "embeddings": torch.randn((n, 64), generator=gen).to(cuda)}
    draws = draw_unet_step(gen, SigmaSampler(tc.sigma), tc, n, (n // 2,) + shape[1:], True,
                           0).to(cuda)
    assert maybe_initialize_distributed(device="cuda", always=True)
    try:
        out = {}
        for wrapped in (False, True):
            model = copy.deepcopy(unet).to(cuda)
            parallel = None
            if wrapped:
                parallel = ParallelState(make_mesh(MeshConfig()), fsdp=fsdp)
                parallel.prepare(model)
            opt = build_optimizer("adamw", model.parameters(), 1e-3)
            opt.axis = parallel.data if parallel else None
            step = make_unet_train_step(opt, None, tc, n,
                                        data=parallel.data if parallel else None)
            state = init_train_state(model, opt, None, tc.sigma, torch.Generator(device=cuda))
            before = launch_counts()
            logs = step(state, batch, draws)
            after = launch_counts()
            assert all(after[k] > before[k] for k in ("grouped_conv3x3", "grouped_conv3x3_wgrad"))
            out[wrapped] = (float(logs["loss"]), float(logs["grad_norm"]),
                            {k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    finally:
        shutdown()
    (l0, g0, p0), (l1, g1, p1) = out[False], out[True]
    assert abs(l1 - l0) <= 1e-6 * abs(l0) and abs(g1 - g0) <= 1e-6 * abs(g0)
    for k, v in p0.items():
        torch.testing.assert_close(p1[k], v, rtol=0, atol=1e-6, msg=k)


@pytest.mark.cuda
def test_pipeline_to_runs_the_dae_on_the_cpu(cuda):
    """``Pipeline.to(device_map={"dae": "cpu"})``: the UNet samples on the
    card (K1), the DAE decodes on the CPU, Griffin-Lim runs on the card
    (K2, K3) and the audio is finite, of the format's shape."""
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams

    g = torch.Generator().manual_seed(0)
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=63 * 256)
    pipe = Pipeline({
        "unet": ModuleHandle("unet", "unet", ucfg, UNet(ucfg).init_weights(g)),
        "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg).init_weights(g)),
        "format": ModuleHandle("format", "format:spectrogram", fcfg, SpectrogramFormat(fcfg))})
    pipe.to("cuda", device_map={"dae": "cpu"})
    assert next(pipe.modules["dae"].module.parameters()).device.type == "cpu"
    before = launch_counts()
    prompt = torch.randn((1, 1024), generator=g).to(cuda)
    raw = pipe.generate(SampleParams(steps=2, num_fgla_iters=3), prompt_embedding=prompt)["raw"]
    after = launch_counts()
    assert raw.is_cuda and raw.shape == (1, 2, 63 * 256) and torch.isfinite(raw).all()
    assert all(after[k] > before[k] for k in ("grouped_conv3x3", "fgla_frame", "ola_reframe"))


def _placement_pipeline(seed: int = 0):
    """A tiny DDEC pipeline on the CPU: the ms_mdct_dual format (64 frames),
    an fp32 supersampled DAE (4 latent channels), a grouped UNet on
    its (16, 32, 4) latents and the DDEC, every output gain 1."""
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (MSMDCTDualFormat,
                                                        MSMDCTDualFormatConfig)
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    g = torch.Generator().manual_seed(seed)
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    dcfg = DAEConfig(model_channels=8, channel_mult_enc=(1,), channel_mult_dec=(1, 2),
                     num_enc_layers_per_block=2, num_dec_layers_per_block=1, latent_channels=4,
                     supersampled=True, compute_dtype="float32")
    ucfg = UNetConfig(in_channels=4, out_channels=4, in_channels_emb=16, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    ddcfg = UNetConfig(in_channels=2, out_channels=2, in_channels_emb=0, in_num_freqs=32,
                       in_psd_freqs=128, sigma_max=20.0, sigma_min=3e-5, model_channels=16,
                       channel_mult=(1, 2), num_layers_per_block=1, mlp_multiplier=2,
                       logvar_channels=32, double_midblock=True, add_constant_channel=True)
    unet, ddec = UNet(ucfg).init_weights(g), UNet(ddcfg).init_weights(g)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
        ddec.core.out_gain.fill_(1.0)
    return Pipeline({
        "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg, MSMDCTDualFormat(fcfg)),
        "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg).init_weights(g)),
        "unet": ModuleHandle("unet", "unet", ucfg, unet),
        "ddec": ModuleHandle("ddec", "ddec", ddcfg, ddec)})


def check_placements(device: torch.device) -> None:
    """``generate`` with ``decode_mode="ddec"`` after ``Pipeline.to(device,
    device_map=...)`` against the pipeline all on ``device``: the DDEC on
    the CPU, and img2img from audio (strength 0.5) with the DAE on the CPU.
    Each stage runs on its module's device; the noise comes from the
    generator on the UNet's device in every run. The DDEC on the CPU: the
    latents of the run all on ``device`` to 1e-6 relative L2 (the same
    stage), the audio to 0.1 (the DDEC's bf16 trunk rounds apart on the
    CPU and the card). The DAE on the CPU: its fp32 encode and decode
    against ``device``'s (TF32 convs on a card), the latents to 1e-2 and
    the audio to 0.1."""
    import dataclasses

    from dualdiffusion_tpu_torch.sampling import SampleParams
    pipe = _placement_pipeline()
    g = torch.Generator().manual_seed(1)
    prompt = torch.randn((1, 16), generator=g).to(device)
    audio = torch.randn((2, 63 * 32), generator=g) * 0.1
    params = SampleParams(steps=2, seed=5)

    def run(device_map, **kw):
        pipe.to(device, device_map=device_map)
        for name, dev in (device_map or {}).items():
            assert next(pipe.modules[name].module.parameters()).device.type == dev
        p = dataclasses.replace(params, img2img_strength=0.5) if kw else params
        out = pipe.generate(p, prompt_embedding=prompt, decode_mode="ddec", **kw)
        assert out["raw"].device.type == device.type and out["raw"].shape == (1, 2, 63 * 32)
        assert torch.isfinite(out["raw"]).all()
        return {k: out[k].float().cpu() for k in ("latents", "raw")}

    for device_map, kw, lat_tol in (({"ddec": "cpu"}, {}, 1e-6),
                                    ({"dae": "cpu"}, {"input_audio": audio}, 1e-2)):
        want, got = run(None, **kw), run(device_map, **kw)
        assert _rel_l2(got["latents"], want["latents"]) <= lat_tol, device_map
        assert _rel_l2(got["raw"], want["raw"]) <= 0.1, device_map


@pytest.mark.cuda
def test_pipeline_to_moves_each_stage_to_its_module(cuda):
    """The UNet on the card, the DDEC or the DAE on the CPU
    (``check_placements``)."""
    check_placements(cuda)
