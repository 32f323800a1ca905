"""The port's multi-device execution on the CPU: the mesh layout and the
sharding rule against the JAX package's, then the tiny grouped UNet's train
step on two gloo ranks (spawned once for the module) under data
parallelism, FSDP and tensor parallelism, each fed its share of the global
batch and JAX's draws of the global microbatches, against JAX's step on the
8-device mesh (``shard_batch``) and the port's own step on one process, all
in fp32 trunks; the FSDP checkpoint reloaded on one process; and the EDM
sampler with tensor-parallel weights against the replicated one.

<-> dualdiffusion_tpu/parallel/{mesh,distributed}.py and
tests/test_parallel.py (test_tensor_parallel_state_sharding,
test_tensor_parallel_sampler_matches_replicated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from dualdiffusion_tpu.parallel import MeshConfig as JaxMeshConfig
from dualdiffusion_tpu.parallel import make_mesh as jax_make_mesh
from dualdiffusion_tpu.parallel import param_sharding_rule as jax_sharding_rule
from dualdiffusion_tpu.parallel import replicate_state as jax_replicate_state
from dualdiffusion_tpu.parallel import shard_batch as jax_shard_batch
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import UNetTrainConfig as JaxUNetTrainConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu.training.train_state import make_unet_train_step as jax_make_step
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.parallel import (MeshConfig, is_main_process, mesh_layout,
                                              maybe_initialize_distributed, process_count)
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.training import Trainer, TrainerConfig
from dualdiffusion_tpu_torch.weights import flax_key, state_to_flat, to_flat
from test_torch_sample_cli import _model_dir
from test_torch_train_step import SIGMA_KW, TRAIN_KW, _jax_draws
from test_torch_training import UNET_KW, X_SHAPE, _jax_unet_vars, _port_unet, set_trunk_dtype

LR = 1e-3
N = 8                       # the global batch: 2 ranks x 2 rows x accumulation 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the mesh and the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_axis,slices", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (1, 4)])
def test_mesh_layout_matches_jax(model_axis, slices):
    """The (data, model) array of ranks against JAX's device ids on the
    8-device CPU mesh (one process: JAX's DCN fallback orders by process)."""
    cfg = dict(model_axis=model_axis, num_dcn_slices=slices)
    jmesh = jax_make_mesh(JaxMeshConfig(**cfg))
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh_layout(MeshConfig(**cfg), 8), want)
    assert tuple(jmesh.axis_names) == MeshConfig().axis_names


@pytest.mark.parametrize("cfg", [dict(model_axis=3), dict(data_axis=2, model_axis=2),
                                 dict(num_dcn_slices=3), dict(model_axis=2, num_dcn_slices=3)])
def test_mesh_errors_match_jax(cfg):
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(JaxMeshConfig(**cfg))
    with pytest.raises(ValueError) as terr:
        mesh_layout(MeshConfig(**cfg), 8)
    assert str(terr.value) == str(jerr.value)


def test_mesh_layout_groups_ranks_by_node():
    """With DCN slices, the data axis's outer blocks are the ranks of one
    node each, as JAX orders devices by process index."""
    layout = mesh_layout(MeshConfig(model_axis=2, num_dcn_slices=2), 8,
                         node_of=[1, 1, 0, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(layout, [[2, 3], [6, 7], [0, 1], [4, 5]])


def test_one_process_starts_no_group(monkeypatch):
    """As JAX's: one process (by argument or environment) starts nothing;
    several without a coordinator raise; the gates read one process."""
    for var in ("DD_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("DD_NUM_PROCESSES", "1")
    assert maybe_initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="no coordinator"):
        maybe_initialize_distributed(num_processes=2, device="cpu")
    assert process_count() == 1 and is_main_process()


# ---------------------------------------------------------------------------
# the UNet step on two ranks
# ---------------------------------------------------------------------------

def _jax_steps(jvars, junet, batches, jtc, mesh_state):
    """Two JAX steps on the 8-device mesh; returns (state, logs, draws)."""
    jopt = joptim.build_optimizer("adamw", LR)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])

    def unet_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, training=True, x_perturbed=x_perturbed)

    def get_emb(p, e, m):
        return junet.apply(p, e, m, method=JaxUNet.get_embeddings)

    def get_logvar(p, s):
        return junet.apply(p, s, method=JaxUNet.get_sigma_loss_logvar)

    jstep = jax.jit(jax_make_step(unet_apply, get_emb, get_logvar, jopt, jbank, jtc, N))
    mesh = jax_make_mesh()
    jstate = jax_replicate_state(mesh, jax_init_train_state(jvars, jopt, jbank, jtc.sigma,
                                                            jax.random.PRNGKey(3)))
    sampler = JaxSigmaSampler(jtc.sigma)
    logs, draws = [], []
    for batch in batches:
        _, d = _jax_draws(jstate.rng, sampler, jtc, N, (N // 2,) + X_SHAPE[1:], (N // 2, 32))
        draws.append(d)
        with mesh:
            jstate, jl = jstep(jstate, jax_shard_batch(mesh, {k: jnp.asarray(v)
                                                              for k, v in batch.items()}))
        logs.append(jl)
    return jstate, logs, draws


def _one_process_steps(inp, batches, draws, optimizer="adamw"):
    """The port's two steps on one process: the model, state and logs."""
    model, _, _, step, state = ranks.unet_step_setup(inp, optimizer=optimizer)
    logs = [step(state, {k: torch.from_numpy(v) for k, v in b.items()}, d)
            for b, d in zip(batches, draws)]
    return model, state, logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's two steps on the 8-device mesh, the port's on one process, and
    the port's on two ranks (data parallel, FSDP, tensor parallel) plus the
    tensor-parallel sampler, all fed the same batches and draws."""
    with pytest.MonkeyPatch.context() as mp:
        set_trunk_dtype(mp, "float32")
        tmp = tmp_path_factory.mktemp("parallel_unet")
        junet, jvars = _jax_unet_vars()
        rng = np.random.default_rng(10)
        batches = [{"samples": rng.standard_normal((N,) + X_SHAPE[1:]).astype(np.float32) * 1.5,
                    "embeddings": rng.standard_normal((N, 8)).astype(np.float32)}
                   for _ in range(2)]
        jtc = JaxUNetTrainConfig(sigma=JaxSigmaConfig(**SIGMA_KW), **TRAIN_KW)
        jstate, jlogs, draws = _jax_steps(jvars, junet, batches, jtc, None)
        start = _port_unet(jvars).state_dict()
        inp = {"state": start, "unet_kw": UNET_KW, "train_kw": TRAIN_KW,
               "sigma_kw": SIGMA_KW, "lr": LR, "n": N, "draws": draws,
               "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]}
        model, state, logs = _one_process_steps(inp, batches, draws)
        muon = _one_process_steps(inp, batches, draws, "muon")

        Pipeline({"unet": ModuleHandle("unet", "unet", UNetConfig(**UNET_KW),
                                       _port_unet(jvars))}).save_pretrained(tmp / "fsdp_model")
        torch.save(inp, tmp / "unet_inputs.pt")
        dshape = (1, 16, 32, 4)
        torch.save({"state": start, "unet_kw": UNET_KW, "shape": dshape},
                   tmp / "denoise_inputs.pt")
        model_dir, _ = _model_dir(tmp)
        ranks.spawn(ranks.unet_steps, 2, tmp)
        ranks.spawn(ranks.tp_denoise, 2, tmp)
        replicated = {"latents": ranks.sample_latents(_port_unet(jvars), dshape),
                      "generate": ranks.generate_clip(Pipeline.from_pretrained(model_dir,
                                                                               device="cpu"))}
        yield dict(tmp=tmp, jvars=jvars, jstate=jstate, jlogs=jlogs, model=model, state=state,
                   logs=logs, replicated=replicated, muon=muon,
                   **{m: torch.load(tmp / f"unet_{m}.pt", weights_only=False)
                      for m in ("dp", "fsdp", "tp", "fsdp_muon", "tp_muon")})


def _global_order(sample_losses, ranks_=2, accum=2):
    """Rank-ordered rows (rank, microbatch, row) in the global batch's order."""
    b = sample_losses.shape[0] // (ranks_ * accum)
    return sample_losses.reshape(ranks_, accum, b).transpose(0, 1).reshape(-1)


def _assert_matches_one_process(res, runs, what):
    """Loss and grad norm to 1e-5 relative, bucket counts and sample losses,
    sigma pdf, parameters and EMA to 1e-5 absolute (fp32 trunks; only the
    order of the gradient sums differs)."""
    one_model, one_state, one_logs = (runs["muon"] if what.endswith("muon") else
                                      (runs["model"], runs["state"], runs["logs"]))
    for got, want in zip(res["logs"], one_logs):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - float(want[k])) <= 1e-5 * abs(float(want[k])), (what, k)
        assert torch.equal(got["bucket_counts"], want["bucket_counts"]), what
        order = _global_order(got["sample_losses"], 1 if what.startswith("tp") else 2)
        torch.testing.assert_close(order, want["sample_losses"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(res["sigma_pdf"], one_state.sigma_pdf, rtol=1e-5, atol=1e-7)
    want_p = to_flat(one_model)
    want_e = state_to_flat(one_state.ema_state["std0.05"])
    assert sorted(res["params"]) == sorted(want_p)
    for k in want_p:
        for got, want in ((res["params"][k], want_p[k]), (res["ema"][k], want_e[k])):
            assert np.abs(got - want).max() <= 1e-5, (what, k, np.abs(got - want).max())


def test_data_parallel_unet_step_matches_jax_mesh_and_one_process(runs):
    """Two ranks, each with half of each microbatch: against JAX's step on
    the 8-device mesh as test_torch_train_step holds the one-process step
    (loss and grad norm to 1e-5 relative, params and EMA to lr/20: AdamW's
    first updates are about +-lr per element), and against the port's step
    on one process to 1e-5."""
    res, jstate = runs["dp"], runs["jstate"]
    assert res["sharded"] == []
    for got, want in zip(res["logs"], runs["jlogs"]):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - float(want[k])) <= 1e-5 * abs(float(want[k])), k
        np.testing.assert_array_equal(got["bucket_counts"].numpy(),
                                      np.asarray(want["bucket_counts"]))
    want_p, want_e = _flatten(jstate.params), _flatten(jstate.ema_state["std0.05"])
    start = _flatten(runs["jvars"])
    moved = 0.0
    for k in want_p:
        for got, want in ((res["params"][k], want_p[k]), (res["ema"][k], want_e[k])):
            assert np.abs(got - np.asarray(want)).max() <= LR / 20, k
        moved = max(moved, float(np.abs(np.asarray(want_p[k]) - start[k]).max()))
    assert moved > 6 * LR       # the comparison is not trivially met
    _assert_matches_one_process(res, runs, "dp")


def test_fsdp_unet_step_matches_one_process_and_its_checkpoint_reloads(runs):
    """FSDP on two ranks: every MPConv weight whose dim 0 divides by 2 is
    sharded (weights, moments, EMA), the step saves no whole weight for its
    backward (each is gathered again there; the data-parallel step saves
    them), and it matches one process to 1e-5. Its checkpoint holds whole
    tensors: a trainer on one process resumes from it with the weights, EMA,
    AdamW moments, counters and generator of the one-process run, and a
    single-device pipeline loads it."""
    res = runs["fsdp"]
    model = UNet(UNetConfig(**UNET_KW))
    want_sharded = sorted(k for k, v in model.state_dict().items()
                          if k.endswith(".w_mp") and v.shape[0] % 2 == 0)
    assert res["sharded"] == want_sharded and len(want_sharded) > 40
    assert res["saved_whole"] == 0 and runs["dp"]["saved_whole"] > 40
    _assert_matches_one_process(res, runs, "fsdp")

    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSamplerConfig,
                                                  build_optimizer, init_train_state)
    st1 = runs["state"]
    m = _port_unet(runs["jvars"])
    opt = build_optimizer("adamw", m.parameters(), LR)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    st = init_train_state(m, opt, bank, SigmaSamplerConfig(**SIGMA_KW), torch.Generator())
    trainer = Trainer(TrainerConfig(model_path=str(runs["tmp"] / "fsdp_model"),
                                    module_name="unet"), lambda *a: {}, st, [], ema_bank=bank)
    assert trainer.load_checkpoint()
    assert st.global_step == 2 and st.total_samples_processed == 2 * N
    for k, v in to_flat(runs["model"]).items():
        np.testing.assert_allclose(to_flat(m)[k], v, rtol=0, atol=1e-5, err_msg=k)
    for k, v in state_to_flat(st1.ema_state["std0.05"]).items():
        np.testing.assert_allclose(state_to_flat(st.ema_state["std0.05"])[k], v, rtol=0,
                                   atol=1e-5, err_msg=k)
    want_m = [s["exp_avg"] for s in st1.optimizer.adamw.state.values()]
    got_m = [st.optimizer.adamw.state[p]["exp_avg"] for p in st.optimizer.adamw.param_groups[0]
             ["params"]]
    for g, w in zip(got_m, want_m):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(st.sigma_pdf, st1.sigma_pdf, rtol=1e-5, atol=1e-7)
    assert torch.equal(st.generator.get_state(), st1.generator.get_state())

    pipe = Pipeline.from_pretrained(runs["tmp"] / "fsdp_model", device="cpu",
                                    load_checkpoints=True)
    for k, v in to_flat(pipe.modules["unet"].module).items():
        np.testing.assert_allclose(v, to_flat(runs["model"])[k], rtol=0, atol=1e-5, err_msg=k)


def test_tensor_parallel_unet_step_matches_data_parallel(runs):
    """Tensor parallelism on a 1 x 2 mesh (every MPConv column-parallel
    where its rows and groups divide by 2) against one data-parallel
    process, to 1e-5 (JAX's test_tensor_parallel_state_sharding holds 5e-2
    on the loss alone)."""
    res = runs["tp"]
    model = UNet(UNetConfig(**UNET_KW))
    mp_convs = {n + ".w_mp": m for n, m in model.named_modules() if hasattr(m, "weight_name")}
    want = sorted(k for k, m in mp_convs.items()
                  if m.out_channels % 2 == 0 and (m.groups == 1 or m.groups % 2 == 0))
    assert res["sharded"] == want
    _assert_matches_one_process(res, runs, "tp")


@pytest.mark.parametrize("mode", ["fsdp_muon", "tp_muon"])
def test_muon_on_row_shards_matches_one_process(runs, mode):
    """Muon (every ``w_mp`` weight) under FSDP and tensor parallelism:
    each row-sharded weight gathered whole for Newton-Schulz, then cut,
    against Muon on one process, to 1e-5."""
    assert runs[mode]["sharded"]
    _assert_matches_one_process(runs[mode], runs, mode)


def test_sharding_rule_matches_jax_on_every_leaf(runs):
    """``param_sharding_rule`` on every leaf of the tiny UNet against JAX's
    on a 4 x 2 mesh: dim 0 over "model" exactly where JAX shards it."""
    jmesh = jax_make_mesh(JaxMeshConfig(model_axis=2))
    rule = runs["tp"]["rule"]
    flat = _flatten(runs["jvars"])
    model = UNet(UNetConfig(**UNET_KW))
    assert any(v == "Shard" for v in rule.values())
    for k, v in model.state_dict().items():
        leaf = jnp.asarray(flat[flax_key(k, v.dim() == 0)])
        spec = tuple(jax_sharding_rule(jmesh, leaf).spec)
        assert (rule[k] == "Shard") == (spec[:1] == ("model",)), k


def test_tensor_parallel_denoise_matches_replicated(runs):
    """The EDM sampler (8 Heun steps, CFG) with the UNet's weights sharded
    over two ranks against the replicated run: the counterpart of JAX's
    test_tensor_parallel_sampler_matches_replicated, in fp32 trunks."""
    got = torch.load(runs["tmp"] / "denoise_tp.pt")["latents"]
    want = runs["replicated"]["latents"]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_pipeline_generates_the_replicated_clip(runs):
    """``Pipeline.shard(2)`` (the UNet and the DAE column-parallel) and
    ``generate`` with a prompt, the DAE decode and Griffin-Lim: the
    latents, mel and audio of the replicated pipeline, in fp32 trunks."""
    got = torch.load(runs["tmp"] / "denoise_tp.pt")["generate"]
    for k, want in runs["replicated"]["generate"].items():
        torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-5, msg=k)
