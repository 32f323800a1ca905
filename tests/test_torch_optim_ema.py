"""Muon / NorMuon and the host-memory EMA profiles of the port against the
JAX package on the CPU.

* Two updates of Muon and NorMuon (with AdamW for the rest) on a small
  UNet's parameters and seeded gradients, routed by the JAX path with the
  default pattern and with one that needs the "params/" prefix; the
  optimizer's state through ``state_dict`` / ``load_state_dict``.
* ``EMABank.host_init`` / ``host_update`` against JAX's, and
  ``AsyncHostEMA`` against JAX's: the same profiles after a run of updates,
  applied in submission order, a worker's error raised again, the
  ``cpu_offload`` refusals.

<-> dualdiffusion_tpu/training/optim.py:146-266, dualdiffusion_tpu/training/
ema.py:89-137, 214-240, 273-416.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten, _unflatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.training import ema as tema
from dualdiffusion_tpu_torch.training.optim import (_newton_schulz5, build_optimizer,
                                                    jax_param_paths)
from dualdiffusion_tpu_torch.weights import flax_key, load_flat, state_to_flat, to_flat
from test_torch_training import UNET_KW, X_SHAPE


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _unet_flat():
    """The small UNet's parameters, shaped by JAX (traced, not compiled) and
    drawn with numpy."""
    unet = JaxUNet(JaxUNetConfig(**UNET_KW))
    shapes = jax.eval_shape(lambda k: unet.init(k, jnp.zeros((1,) + X_SHAPE[1:]), jnp.ones((1,)),
                                                jnp.zeros((1, 8)), method=JaxUNet.init_all),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return _flatten(jax.tree_util.tree_map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32), shapes))


def test_newton_schulz_matches_jax():
    """NS5 on a wide and a tall matrix, fp32: 1e-5 relative."""
    rng = np.random.default_rng(1)
    for shape in ((16, 72), (72, 16)):
        g = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(joptim._newton_schulz5(jnp.asarray(g)))
        got = _newton_schulz5(torch.from_numpy(g)).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("name,patterns", [("muon", ("*w_mp*",)), ("normuon", ("*w_mp*",)),
                                           ("muon", ("params/core/dec_*",))])
def test_muon_updates_match_jax(name, patterns):
    """Two updates (the momentum and NorMuon's second moment carry over) at
    an lr schedule, behind the dynamic clip: every parameter to 1e-5 of the
    step it took, plus two fp32 spacings of its value (each package rounds
    its own sum; AdamW's leaves too: the gradients are drawn away from zero,
    where its first update would flip). The second pattern matches
    only with the "params/" prefix of the JAX path, and its 1-D leaves
    still go to AdamW. A state_dict round trip gives the same third step."""
    flat = _unet_flat()
    model = UNet(UNetConfig(**UNET_KW))
    load_flat(model, flat)
    lr = joptim.lr_schedule("constant", 1e-2, warmup_steps=3)
    jopt = joptim.build_optimizer(name, lr, muon_patterns=patterns)
    jparams = _unflatten(flat)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    opt = build_optimizer(name, jax_param_paths(model), lr, muon_patterns=patterns)
    routed = {flax_key(k, False) for k, p in model.named_parameters()
              if any(p is q for q in opt.muon.params)}
    assert routed and all(k.endswith("w_mp") for k in routed)
    if patterns != ("*w_mp*",):
        assert all(k.startswith("params/core/dec_") for k in routed)
    params = dict(model.named_parameters())
    keys = {flax_key(k, p.dim() == 0): k for k, p in params.items()}
    rng = np.random.default_rng(2)
    for step in range(2):
        grads = {k: (rng.choice([-1, 1], v.shape) * rng.uniform(0.5, 1.5, v.shape) * 0.1
                     ).astype(np.float32) for k, v in flat.items()}
        upd, jstate = jupdate(_unflatten(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for fk, tk in keys.items():
            params[tk].grad = torch.from_numpy(grads[fk]).reshape(params[tk].shape)
        opt.step(step)
    want = _flatten(jparams)
    got = to_flat(model)
    for k in want:
        moved = np.abs(want[k] - flat[k]).max()
        bound = 1e-5 * moved + 2 * np.spacing(np.abs(want[k]))
        assert moved > 0 and np.all(np.abs(got[k] - want[k]) <= bound), k

    clone = UNet(UNetConfig(**UNET_KW))
    clone.load_state_dict(model.state_dict())
    opt2 = build_optimizer(name, jax_param_paths(clone), lr, muon_patterns=patterns)
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))     # as a checkpoint file holds it
    for m, o in ((model, opt), (clone, opt2)):
        for p in m.parameters():
            p.grad = torch.full_like(p, 0.05)
        o.step(2)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), clone.parameters()))


def test_muon_needs_paths_and_unknown_optimizers_raise_as_in_jax():
    p = torch.nn.Parameter(torch.zeros(3, 3))
    with pytest.raises(ValueError):
        build_optimizer("muon", [p])
    for make in (lambda: joptim.build_optimizer("lion"), lambda: build_optimizer("lion", [p])):
        with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
            make()


# ---------------------------------------------------------------------------
# host-memory EMA profiles
# ---------------------------------------------------------------------------

CONFIGS = [dict(name="std0.1", std=0.1, cpu_offload=True),
           dict(name="beta", beta=0.9, num_warmup_steps=3, cpu_offload=True),
           dict(name="device", std=0.1)]


def _weights(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"params/a/w": rng.standard_normal((4, 3)).astype(np.float32),
             "params/b#0d": rng.standard_normal((1,)).astype(np.float32)} for _ in range(n)]


def _as_state(flat):
    return {"a.w": torch.from_numpy(flat["params/a/w"]),
            "b": torch.from_numpy(flat["params/b#0d"])[0]}


def test_host_ema_matches_jax():
    """host_init from the first weights, then four host_updates at the
    counters JAX's trainer passes (before each step): 1e-6 relative; the
    device-only profile is not a host one in either package."""
    ws = _weights(5)
    jbank = jema.EMABank([jema.EMAConfig(**c) for c in CONFIGS])
    tbank = tema.EMABank([tema.EMAConfig(**c) for c in CONFIGS])
    assert tbank.offloaded == jbank.offloaded == ["std0.1", "beta"]
    jh = jbank.host_init(_unflatten(ws[0]))
    th = tbank.host_init(_as_state(ws[0]))
    for i, w in enumerate(ws[1:]):
        jh = jbank.host_update(jh, _unflatten(w), i * 8, 8, i)
        tbank.host_update(th, _as_state(w), i * 8, 8, i)
    for name in tbank.offloaded:
        want, got = _flatten(jh[name]), state_to_flat(th[name])
        for k in want:
            assert np.allclose(got[k], want[k], rtol=1e-6, atol=1e-7), (name, k)
    assert set(tbank.init(torch.nn.Linear(2, 2))) == {"device"}


def test_async_host_ema_matches_jax_and_keeps_order():
    """Eight updates submitted back to back (the depth-1 queue makes the
    caller wait for the worker): the profiles equal JAX AsyncHostEMA's and a
    sequential host_update of the same weights, so no update was lost,
    repeated or reordered; read after sync()."""
    ws = _weights(9, seed=4)
    jbank = jema.EMABank([jema.EMAConfig(**c) for c in CONFIGS])
    tbank = tema.EMABank([tema.EMAConfig(**c) for c in CONFIGS])
    jworker, tworker = jema.AsyncHostEMA(jbank, 8), tema.AsyncHostEMA(tbank, 8)
    jworker.seed(_unflatten(ws[0]))
    tworker.restore(tbank.host_init(_as_state(ws[0])))
    seq = tbank.host_init(_as_state(ws[0]))
    for i, w in enumerate(ws[1:]):
        jworker.update(_unflatten(w), jnp.int32((i + 1) * 8), jnp.int32(i + 1))
        tworker.update(_as_state(w), (i + 1) * 8, i + 1)
        tbank.host_update(seq, _as_state(w), i * 8, 8, i)
    jworker.sync()
    tworker.sync()
    for name in tbank.offloaded:
        want = _flatten(jworker.profiles[name])
        got, ref = state_to_flat(tworker.profiles[name]), state_to_flat(seq[name])
        for k in want:
            assert np.allclose(got[k], want[k], rtol=1e-6, atol=1e-7), (name, k)
            assert np.array_equal(got[k], ref[k]), (name, k)
    tworker.close()
    jworker.close()


def test_async_host_ema_raises_the_workers_error(monkeypatch):
    """A failure on the worker thread comes back on the next update() or
    sync(), once; unseeded, the first update seeds the profiles."""
    bank = tema.EMABank([tema.EMAConfig(**CONFIGS[0])])
    worker = tema.AsyncHostEMA(bank, 8)
    ws = _weights(3, seed=5)
    worker.update(_as_state(ws[0]), 8, 1)
    worker.sync()
    assert torch.equal(worker.profiles["std0.1"]["a.w"], _as_state(ws[0])["a.w"])

    def boom(*args, **kwargs):
        raise RuntimeError("lerp failed")
    monkeypatch.setattr(bank, "host_update", boom)
    worker.update(_as_state(ws[1]), 16, 2)
    with pytest.raises(RuntimeError, match="lerp failed"):
        worker.sync()
    worker.sync()       # raised once
    worker.update(_as_state(ws[2]), 24, 3)
    worker._queue.join()        # the worker has failed on it
    with pytest.raises(RuntimeError, match="lerp failed"):
        worker.update(_as_state(ws[2]), 24, 3)
    worker.close()


@pytest.mark.parametrize("extra", [dict(feedback_beta=0.5), dict(num_switch_ema_epochs=2),
                                   dict(use_float64=True)])
def test_cpu_offload_refusals_match_jax(extra):
    kw = dict(name="e", std=0.1, cpu_offload=True, **extra)
    with pytest.raises(ValueError) as want:
        jema.EMAConfig(**kw)
    with pytest.raises(ValueError) as got:
        tema.EMAConfig(**kw)
    assert str(got.value) == str(want.value)
