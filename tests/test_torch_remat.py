"""UNet block rematerialization (``UNetConfig.remat_blocks``) in the port:
the rematerialized UNet against the JAX package's, against the port's
plain UNet (2-D, the stereo-folded 3-D UNet with dropout, a DDEC), the
bytes a training forward keeps, inference untouched, FSDP and tensor
parallelism on two gloo ranks, and the training entry point.

<-> dualdiffusion_tpu/models/unet.py (``nn.remat`` of UNetBlock,
unet.py:442-445) and tests/test_models.py test_remat_blocks_same_loss_and_grads.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dualdiffusion_tpu_torch.models.unet as port_unet_module
import torch_parallel_ranks as ranks
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.models.unet import UNetBlock
from dualdiffusion_tpu_torch.training import SigmaSampler, SigmaSamplerConfig, UNetTrainConfig
from dualdiffusion_tpu_torch.training.train_state import draw_unet_step
from dualdiffusion_tpu_torch.weights import flax_key, load_flat, to_flat
from test_torch_ddec import DDEC_KW
from test_torch_ddec_training import EMB_DIM, RAW_LEN, write_ddec_model
from test_torch_train_step import SIGMA_KW, TRAIN_KW
from test_torch_training import UNET_KW, X_SHAPE, set_trunk_dtype
from test_torch_unet_3d import D1_KW
from test_torch_unet_3d import X_SHAPE as X3_SHAPE

#: tests/test_models.py test_remat_blocks_same_loss_and_grads's UNet
JAX_REMAT_KW = dict(in_channels=4, out_channels=4, in_channels_emb=0, model_channels=8,
                    channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=8,
                    logvar_channels=16, mlp_groups=2, mlp_multiplier=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _seeded(cfg: UNetConfig, seed: int = 0) -> UNet:
    """A UNet of ``cfg`` from ``seed``, every scalar gain in [0.5, 1.5] so each
    branch carries signal (a zero ``out_gain`` would mute the trunk)."""
    model = UNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 0 and "gain" in name:
                p.fill_(float(rng.uniform(0.5, 1.5)))
    return model


def _remat_twin(model: UNet) -> UNet:
    """``model``'s weights in a UNet with ``remat_blocks`` (the same state
    dict keys)."""
    twin = UNet(dataclasses.replace(model.cfg, remat_blocks=True))
    twin.load_state_dict(model.state_dict())
    return twin


class _CountedCheckpoint:
    """``torch.utils.checkpoint.checkpoint`` as ``models/unet.py`` calls it,
    counting its calls and keeping the tensors each call holds for its
    recompute (the block's inputs)."""

    def __init__(self):
        self.calls, self.held = 0, []

    def __call__(self, fn, *args, **kwargs):
        self.calls += 1
        self.held += [a for a in args if torch.is_tensor(a)]
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)


@pytest.fixture
def counted(monkeypatch):
    c = _CountedCheckpoint()
    monkeypatch.setattr(port_unet_module, "checkpoint", c)
    return c


def _n_blocks(model: UNet) -> int:
    return sum(isinstance(m, UNetBlock) for m in model.modules())


# ---------------------------------------------------------------------------
# against the JAX package's rematerialized UNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_levels", [(), (1,)])
def test_remat_unet_loss_and_grads_match_jax_remat(attn_levels, monkeypatch):
    """JAX's UNet and the port's, both with ``remat_blocks``, from the same
    weights (JAX's init, every scalar gain and the logvar head given values)
    in fp32 trunks: the loss of a training forward that reaches every head
    to 1e-5 relative and each parameter's gradient to 1e-4 of its own max,
    the bounds of test_torch_train_kernels.py's plain UNet parity test."""
    set_trunk_dtype(monkeypatch, "float32")
    kw = dict(JAX_REMAT_KW, attn_levels=attn_levels, remat_blocks=True)
    junet = JaxUNet(JaxUNetConfig(**kw))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    sigma = np.array([0.4, 3.0], np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    jvars = jax.jit(lambda k: junet.init(k, jnp.asarray(x), jnp.asarray(sigma), None,
                                         method=JaxUNet.init_all))(jax.random.PRNGKey(0))

    def fix(path, leaf):
        name = getattr(path[-1], "key", "")
        if leaf.ndim == 0 and "gain" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        if name == "w_raw":
            return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf
    jvars = jax.tree_util.tree_map_with_path(fix, jvars)

    def jloss(v):
        d = junet.apply(v, jnp.asarray(x), jnp.asarray(sigma), None, training=True)
        lv = junet.apply(v, jnp.asarray(sigma), method=JaxUNet.get_sigma_loss_logvar)
        return (d * r).mean() + lv.mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jvars)
    model = UNet(UNetConfig(**kw))
    load_flat(model, _flatten(jvars))
    d = model(torch.from_numpy(x), torch.from_numpy(sigma), None, training=True)
    loss = (d * torch.from_numpy(r)).mean() + model.get_sigma_loss_logvar(
        torch.from_numpy(sigma)).mean()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = _flatten(want_grads)
    for k, p in model.named_parameters():
        w = np.asarray(want[flax_key(k, p.dim() == 0)])
        assert _rel_err(p.grad.reshape(p.shape or (1,)).numpy(), w) < 1e-4, k


# ---------------------------------------------------------------------------
# against the port's plain UNet
# ---------------------------------------------------------------------------

def _case(kind: str):
    """(config, inputs of a training forward) of a 2-D UNet with attention
    and dropout, the stereo-folded 3-D UNet at dropout 0.1, or a DDEC (the
    PSD fold: ``x_ref`` is the (B, 128, W, C) linear PSD)."""
    rng = np.random.default_rng(7)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if kind == "2d":
        cfg, shape, emb = UNetConfig(**UNET_KW, dropout=0.1), X_SHAPE, 8
    elif kind == "3d":
        cfg, shape, emb = UNetConfig(**D1_KW, dropout=0.1), X3_SHAPE, 16
    else:
        cfg, shape, emb = UNetConfig(**DDEC_KW), (2, 32, 16, 2), 0
    b = shape[0]
    inputs = {"x": randn(*shape), "sigma": torch.linspace(0.3, 4.0, b),
              "emb_in": randn(b, emb) if emb else None,
              "mask": (torch.arange(b) % 2 == 0).float(),
              "x_ref": randn(b, 128, 16, 2).abs() if kind == "ddec" else None,
              "r": randn(*shape)}
    return cfg, inputs


def _train_forward(model: UNet, inputs, seed: int = 11):
    """One training forward and backward with the dropout masks drawn from
    a generator seeded by ``seed``: (loss, gradients, the generator's
    state afterwards)."""
    gen = torch.Generator().manual_seed(seed)
    emb = (model.get_embeddings(inputs["emb_in"], inputs["mask"])
           if inputs["emb_in"] is not None else None)
    d = model(inputs["x"], inputs["sigma"], emb, inputs["x_ref"], training=True,
              dropout_generator=gen)
    loss = (d * inputs["r"]).mean() + model.get_sigma_loss_logvar(inputs["sigma"]).mean()
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("kind", ["2d", "3d", "ddec"])
def test_remat_matches_plain_bit_for_bit(kind, counted):
    """A rematerialized training forward and backward against the plain one
    of the same weights, in the bf16 trunk the port ships: the same loss and
    every gradient equal (the same arithmetic, at one thread), and the
    dropout generator left in the same state, so the recompute drew the
    masks its forward drew and the next draws do not move. Every UNetBlock
    ran under ``checkpoint``, each once."""
    cfg, inputs = _case(kind)
    plain = _seeded(cfg)
    remat = _remat_twin(plain)
    want_loss, want, want_state = _train_forward(plain, inputs)
    assert counted.calls == 0
    loss, got, state = _train_forward(remat, inputs)
    assert counted.calls == _n_blocks(remat) > 0
    assert torch.equal(loss, want_loss)
    assert sorted(got) == sorted(want) and len(want) > 20
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(state, want_state)
    if cfg.dropout > 0:     # the masks were drawn: the generator moved
        assert not torch.equal(state, torch.Generator().manual_seed(11).get_state())


def test_remat_without_the_generator_copy_would_draw_other_masks(monkeypatch):
    """The trap the generator copy avoids: ``checkpoint`` restores torch's
    default generators for the recompute, not one passed in, so a recompute
    from the trainer's generator itself draws the next masks and every
    gradient moves (this test holds the trap open, so the one above means
    something)."""
    cfg, inputs = _case("2d")
    plain = _seeded(cfg)
    want_loss, want, _ = _train_forward(plain, inputs)

    def naive(block, x, emb, generator):
        return torch.utils.checkpoint.checkpoint(block, x, emb, True, generator,
                                                 use_reentrant=False)
    monkeypatch.setattr(port_unet_module, "remat_block", naive)
    loss, got, _ = _train_forward(_remat_twin(plain), inputs)
    assert torch.equal(loss, want_loss)
    assert not all(torch.equal(got[k], want[k]) for k in want)


def _storage_bytes(tensors, skip=frozenset()) -> int:
    """Bytes of the distinct storages under ``tensors``, those in ``skip``
    (parameters) left out."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        if s.data_ptr() not in skip:
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def test_remat_keeps_at_most_a_fifth_of_the_plain_forward_bytes(counted):
    """Bytes a training forward keeps for its backward (the tensors packed
    under ``saved_tensors_hooks`` plus the block inputs each ``checkpoint``
    holds, distinct storages, parameters not counted), at 2 layers a block,
    three levels and attention at the lowest: with remat at most 20 % of the
    plain forward's (the reference-scale structure keeps 7-9 %)."""
    cfg = UNetConfig(**dict(UNET_KW, channel_mult=(1, 2, 3), num_layers_per_block=2,
                            attn_levels=(2,)))
    plain = _seeded(cfg)
    x = torch.randn((2, 16, 32, 4), generator=torch.Generator().manual_seed(1))
    sigma = torch.tensor([0.5, 2.0])
    emb = plain.get_embeddings(torch.randn((2, 8)), torch.ones(2))

    def kept(model):
        saved = []
        params = {p.untyped_storage().data_ptr() for p in model.parameters()}
        counted.held = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            model(x, sigma, emb.detach(), training=True)
        return _storage_bytes(saved + counted.held, params)

    plain_bytes = kept(plain)
    remat_bytes = kept(_remat_twin(plain))
    assert remat_bytes <= 0.2 * plain_bytes, (remat_bytes, plain_bytes)


def test_inference_with_remat_is_untouched(counted):
    """With ``training=False``, or under ``no_grad``, a UNet with
    ``remat_blocks`` calls no ``checkpoint`` and its output is bit-equal to
    the same UNet's without it."""
    cfg, inputs = _case("2d")
    plain = _seeded(dataclasses.replace(cfg, dropout=0.0))
    remat = _remat_twin(plain)
    emb = plain.get_embeddings(inputs["emb_in"], inputs["mask"])
    args = (inputs["x"], inputs["sigma"], emb)
    assert torch.equal(remat(*args), plain(*args))
    with torch.no_grad():
        assert torch.equal(remat(*args, training=True), plain(*args, training=True))
        assert torch.equal(remat.core.run_ops(inputs["x"].bfloat16(), emb.bfloat16(), [],
                                              training=True)[0],
                           plain.core.run_ops(inputs["x"].bfloat16(), emb.bfloat16(), [],
                                              training=True)[0])
    assert counted.calls == 0


# ---------------------------------------------------------------------------
# FSDP and tensor parallelism on two gloo ranks
# ---------------------------------------------------------------------------

STEPS, N = 2, 4         # 2 steps of a global batch of 4: 2 rows a rank, no accumulation
LR = 1e-3


@pytest.fixture(scope="module")
def parallel_runs(tmp_path_factory):
    """The UNet's steps under FSDP and tensor parallelism on two ranks, with
    and without ``remat_blocks``, and the plain UNet's on one process, from
    the same weights, batches and draws, in fp32 trunks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_unet_module, "ACT_DTYPE", torch.float32)
        tmp = tmp_path_factory.mktemp("remat_parallel")
        train_kw = dict(TRAIN_KW, grad_accum_steps=1)
        tc = UNetTrainConfig(sigma=SigmaSamplerConfig(**SIGMA_KW), **train_kw)
        rng = np.random.default_rng(10)
        gen = torch.Generator().manual_seed(4)
        batches, draws = [], []
        for _ in range(STEPS):
            batches.append({"samples": torch.from_numpy(
                rng.standard_normal((N,) + X_SHAPE[1:]).astype(np.float32) * 1.5),
                "embeddings": torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))})
            draws.append(draw_unet_step(gen, SigmaSampler(tc.sigma), tc, N,
                                        (N,) + X_SHAPE[1:], True, 32))
        inp = {"state": _seeded(UNetConfig(**UNET_KW)).state_dict(), "train_kw": train_kw,
               "unet_kw": UNET_KW, "sigma_kw": SIGMA_KW, "lr": LR, "n": N,
               "batches": batches, "draws": draws}
        torch.save(inp, tmp / "remat_inputs.pt")
        ranks.spawn(ranks.remat_steps, 2, tmp)
        model, _, _, step, state = ranks.unet_step_setup(inp)
        logs = [step(state, b, d) for b, d in zip(batches, draws)]
        yield {"model": model, "logs": logs,
               **{(m, r): torch.load(tmp / f"remat_{m}_{r}.pt", weights_only=False)
                  for m in ("fsdp", "tp") for r in (False, True)}}


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_remat_under_fsdp_and_tp_matches_one_plain_process(parallel_runs, mode):
    """Two rematerialized steps on two ranks: bit for bit the same losses,
    grad norms and parameters as the same layout's plain steps (the
    recomputes, collectives included, repeat the forward exactly on both
    ranks), and against the plain UNet on one process the loss and grad norm
    to 1e-5 relative, the parameters to 1e-5 absolute under FSDP and to
    lr/20 under tensor parallelism (its column-parallel layers sum a
    near-zero gradient in another order, and AdamW's first update of such
    an element moves by up to lr whatever the gradient's size; the plain
    tensor-parallel step is off by the same amount). Under FSDP the steps
    save no whole weight for their backward, and each sharded weight is
    gathered at least once and at most twice a step (the forward and the
    recompute; a layer checkpoint nested in the block's would add a third);
    tensor parallelism gathers no weight."""
    res, plain = parallel_runs[(mode, True)], parallel_runs[(mode, False)]
    assert res["logs"] == plain["logs"] and res["gathers"] == plain["gathers"]
    for k, v in plain["params"].items():
        assert np.array_equal(res["params"][k], v), k
    for got, want in zip(res["logs"], parallel_runs["logs"]):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    want_p = to_flat(parallel_runs["model"])
    assert sorted(res["params"]) == sorted(want_p)
    tol = 1e-5 if mode == "fsdp" else LR / 20
    for k, v in want_p.items():
        assert np.abs(res["params"][k] - v).max() <= tol, k
    assert res["n_sharded"] > 40
    for per_weight in res["gathers"]:
        if mode == "fsdp":
            assert len(per_weight) == res["n_sharded"]
            assert 1 <= min(per_weight) and max(per_weight) <= 2
        else:
            assert max(per_weight) == 0
    if mode == "fsdp":
        assert res["saved_whole"] == 0


# ---------------------------------------------------------------------------
# the training entry point, with the option in the model's config
# ---------------------------------------------------------------------------

def _write_unet_model(path):
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    cfg = UNetConfig(**UNET_KW, dropout=0.1)
    Pipeline({"unet": ModuleHandle("unet", "unet", cfg, _seeded(cfg))}).save_pretrained(path)


def _set_remat(module_dir):
    """Turn the option on as a user does: in the module's config file."""
    for f in module_dir.glob("*.json"):
        raw = json.loads(f.read_text())
        if "remat_blocks" in raw:
            raw["remat_blocks"] = True
            f.write_text(json.dumps(raw))
            return
    raise AssertionError(f"no UNet config in {module_dir}")


@pytest.mark.parametrize("module", ["unet", "ddec"])
def test_train_entry_with_remat_matches_plain_and_resumes(module, tmp_path, counted):
    """``dualdiffusion_tpu_torch.train`` on the CPU, the UNet trainer (dropout
    0.1) and the DDEC trainer, with ``"remat_blocks": true`` in the model's
    config: 2 steps whose losses equal those of the same model without it
    (every block through ``checkpoint``), then ``--resume`` to step 3; the
    checkpoint's weights load into the UNet without the option (the keys do
    not change)."""
    from dualdiffusion_tpu_torch import train
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset, write_latent_dataset
    from dualdiffusion_tpu_torch.utils import load_safetensors

    data = tmp_path / "d"
    if module == "unet":
        _write_unet_model(tmp_path / "plain")
        write_latent_dataset(data, 8, (4, 8, 16), 8, seed=1)
        extra = {"dataloader": {"latents_crop_width": 16}}
    else:
        write_ddec_model(tmp_path / "plain")
        write_audio_dataset(data, 8, 2, RAW_LEN + 500, seed=1, emb_dim=EMB_DIM)
        extra = {"module_trainer": "ddec",
                 "dataloader": {"load_datatypes": ["audio", "audio_embeddings"],
                                "raw_crop_width": RAW_LEN}}
    shutil.copytree(tmp_path / "plain", tmp_path / "remat")
    _set_remat(tmp_path / "remat" / module)
    (tmp_path / "tc.json").write_text(json.dumps({
        "module_name": module, "device_batch_size": 2, "gradient_accumulation_steps": 2,
        "lr_schedule": {"lr_warmup_steps": 0}, "emas": {"std0.05": {"std": 0.05}}, **extra}))

    def run(model, *more):
        return train.main(["--device", "cpu", "--model_path", str(tmp_path / model),
                           "--train_config_path", str(tmp_path / "tc.json"),
                           "--dataset_path", str(data), *more])

    want = [h["loss"] for h in run("plain", "--max_steps", "2").history]
    assert counted.calls == 0
    trainer = run("remat", "--max_steps", "2")
    assert trainer.state.module.cfg.remat_blocks
    blocks = _n_blocks(trainer.state.module)
    assert counted.calls == 2 * 2 * blocks      # 2 steps x 2 microbatches
    assert [h["loss"] for h in trainer.history] == want and np.all(np.isfinite(want))
    resumed = run("remat", "--resume", "--max_steps", "3")
    assert resumed.state.global_step == 3 and np.isfinite(resumed.history[-1]["loss"])
    ckpt = tmp_path / "remat" / f"{module}_checkpoint-3" / module
    assert json.loads((ckpt / f"{module}.json").read_text())["remat_blocks"] is True
    plain = UNet(dataclasses.replace(trainer.state.module.cfg, remat_blocks=False))
    load_flat(plain, load_safetensors(ckpt / f"{module}.safetensors"))
    assert to_flat(plain).keys() == to_flat(resumed.state.module).keys()
