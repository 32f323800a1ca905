"""The port's GPipe pipeline parallelism on the CPU against the JAX
package's: ``pipeline_apply`` of four ``UNetBlock`` stages over four gloo
ranks against JAX's on a 4-device mesh; ``pipelined_denoise`` of a 3-level
UNet with attention over 4 stages, and of an uneven 3-stage plan with a
double midblock, against JAX's and against the port's sequential forward;
``build_stage_plan`` against JAX's plan, down to the reference-scale
schedule; ``UNetCore.run_ops`` split at every op boundary against the
forward. The ranks are spawned once for the module, each keeping only its
own stage's modules.

The UNets are compared in fp32 trunks (``set_trunk_dtype``'s swap, here
also in JAX's ``unet_pipeline``, whose payload takes the trunk's dtype the
same way), where the two packages differ by fp32 rounding alone; in the
shipped bf16 trunk the pipeline is held to the port's own sequential trunk
bit for bit.

<-> dualdiffusion_tpu/parallel/{pipeline,unet_pipeline}.py and
tests/test_parallel.py (test_gpipe_pipeline_matches_sequential,
test_unet_pipeline_real_model_matches_sequential,
test_unet_pipeline_wpack_double_midblock).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dualdiffusion_tpu.models.unet as jax_unet_module
import dualdiffusion_tpu.parallel.unet_pipeline as jax_unet_pipeline
import dualdiffusion_tpu_torch.models.unet as port_unet_module
import torch_parallel_ranks as ranks
from dualdiffusion_tpu.models.unet import UNetBlock as JaxUNetBlock
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.models.unet import UNetCore as JaxUNetCore
from dualdiffusion_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models.unet import UNetBlock, UNetConfig, UNetCore
from dualdiffusion_tpu_torch.parallel import (Axis, build_stage_plan, keep_stage, pipeline_apply,
                                              unet_pipeline_apply)
from dualdiffusion_tpu_torch.weights import flat_to_state, load_flat
from test_torch_training import _JnpTrunkF32

WORLD = 4
BLOCK_KW = dict(in_channels=8, out_channels=8, model_channels=8, channel_mult=(1,),
                num_layers_per_block=1, channels_per_head=8, logvar_channels=16)
REAL_KW = dict(in_channels=4, out_channels=4, in_channels_emb=32, model_channels=16,
               channel_mult=(1, 2, 3), num_layers_per_block=1, attn_levels=(2,),
               attn_axis="freq", channels_per_head=16, logvar_channels=32)
# JAX's test also W-packs this model; the port leaves W-packing out (the same math)
UNEVEN_KW = dict(in_channels=2, out_channels=2, model_channels=8, channel_mult=(1, 2, 3, 4),
                 num_layers_per_block=1, double_midblock=True, channels_per_head=8,
                 logvar_channels=16)
REF_KW = dict(in_channels=4, out_channels=4, in_channels_emb=1024, model_channels=256,
              channel_mult=(1, 2, 3, 4, 5), channel_mult_noise=1, channel_mult_emb=3,
              channels_per_head=64, num_layers_per_block=2, attn_levels=(3, 4),
              attn_axis="freq", mlp_multiplier=2, mlp_groups=8, logvar_channels=128)
#: name: (config, input shape, stages, microbatches)
CASES = {"real": (REAL_KW, (8, 16, 32, 4), 4, 4), "uneven": (UNEVEN_KW, (8, 32, 64, 2), 3, 2)}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _seeded_vars(module, rng, *args):
    """The module's variables with seeded values instead of its init's
    (whose compile costs ~10 s a UNet here): N(0, 1) weights, each scalar
    gain in [0.5, 1.5] (at init they are zero, which mutes the trunk)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5) if a.ndim == 0 else
                              rng.standard_normal(a.shape), a.dtype), shapes)


def _jax_unet(kw, shape, seed=0):
    """JAX ``_unet_pp_setup``'s model and inputs, with ``_seeded_vars``."""
    core = JaxUNetCore(JaxUNetConfig(**kw))
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, shape, jnp.float32)
    sigma = jnp.exp(jax.random.normal(jax.random.fold_in(key, 1), (shape[0],)) + 1.0)
    emb = jax.random.normal(jax.random.fold_in(key, 2), (shape[0], core._cemb()), jnp.float32)
    return core, _seeded_vars(core, np.random.default_rng(seed), x, sigma, emb), x, sigma, emb


def _port_core(kw, v) -> UNetCore:
    core = UNetCore(UNetConfig(**kw))
    load_flat(core, _flatten(v))
    return core.eval()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("pipeline")
    key = jax.random.PRNGKey(0)
    # (a) UNetBlock stages, as JAX test_gpipe_pipeline_matches_sequential
    block = JaxUNetBlock(JaxUNetConfig(**BLOCK_KW), 8, 8, 0)
    bx = jax.random.normal(key, (16, 8, 16, 8))
    rng = np.random.default_rng(1)
    params = [_seeded_vars(block, rng, bx[:2], None) for _ in range(WORLD)]
    stacked = jax.tree_util.tree_map(lambda *ps: jnp.stack(ps), *params)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
    jblock = jax_pipeline_apply(lambda p, xx: block.apply(p, xx, None), stacked, bx, mesh,
                                axis="model", num_microbatches=8)
    like = UNetBlock(UNetConfig(**BLOCK_KW), 8, 8, 0).state_dict()
    inp = {"block": {"cfg": BLOCK_KW, "channels": (8, 8, 0), "x": _t(bx), "m": 8,
                     "states": [flat_to_state(like, _flatten(p)) for p in params]},
           "unets": []}
    want = {"block": np.asarray(jblock)}
    # (b), (c) pipelined_denoise in fp32 trunks on both sides
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unet_module, "jnp", _JnpTrunkF32("jnp"))
        mp.setattr(jax_unet_pipeline, "jnp", _JnpTrunkF32("jnp"))
        for name, (kw, shape, k, m) in CASES.items():
            core, v, x, sigma, emb = _jax_unet(kw, shape)
            kmesh = Mesh(np.array(jax.devices()[:k]).reshape(1, k), ("data", "model"))
            want[name] = np.asarray(jax.jit(lambda v_, x_, s_, e_: jax_unet_pipeline.
                                            pipelined_denoise(core, v_, x_, s_, e_, kmesh,
                                                              num_microbatches=m))(
                v, x, sigma, emb))
            want[name + "_vars"] = v
            inp["unets"].append({"name": name, "cfg": kw, "stages": k, "m": m,
                                 "mb_shape": (shape[0] // m,) + shape[1:],
                                 "state": _port_core(kw, v).state_dict(), "x": _t(x),
                                 "sigma": _t(sigma), "emb": _t(emb)})
    torch.save(inp, tmp / "pipeline_inputs.pt")
    ranks.spawn(ranks.pipeline_runs, WORLD, tmp)
    return inp, want, torch.load(tmp / "pipeline_out.pt", weights_only=False)


def _case(inp, name):
    return next(c for c in inp["unets"] if c["name"] == name)


# ---------------------------------------------------------------------------
# (a) pipeline_apply
# ---------------------------------------------------------------------------

def test_pipeline_apply_matches_jax_gpipe(runs):
    """Four UNetBlock stages over four gloo ranks, 8 microbatches, against
    JAX's ``pipeline_apply`` on a 4-device mesh and against the blocks
    applied in turn (JAX's own tolerance: fp32 rounding through four
    blocks)."""
    inp, want, got = runs
    np.testing.assert_allclose(got["block"].numpy(), want["block"], rtol=2e-4, atol=2e-4)
    blk = inp["block"]
    seq = blk["x"]
    for state in blk["states"]:
        b = UNetBlock(UNetConfig(**blk["cfg"]), *blk["channels"])
        b.load_state_dict(state)
        with torch.no_grad():
            seq = b(seq, None)
    np.testing.assert_allclose(got["block"].numpy(), seq.numpy(), rtol=2e-4, atol=2e-4)


def test_pipeline_apply_on_one_rank_is_the_stage():
    """Over one rank the pipeline is the stage applied per microbatch."""
    x = torch.randn(6, 3, 4)
    got = pipeline_apply(lambda s, t: t * s + 1.0, 2.0, x, Axis(), num_microbatches=3)
    assert torch.equal(got, x * 2.0 + 1.0)


def test_pipeline_apply_refuses_what_it_cannot_stream():
    x = torch.randn(6, 3)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda s, t: t, None, x, Axis(), num_microbatches=4)
    with pytest.raises(ValueError, match="must keep both"):
        pipeline_apply(lambda s, t: t[:, :2], None, x, Axis(), num_microbatches=2)
    with pytest.raises(ValueError, match="must keep both"):
        pipeline_apply(lambda s, t: t.double(), None, x, Axis(), num_microbatches=2)


# ---------------------------------------------------------------------------
# (b), (c) pipelined_denoise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_denoise_matches_jax(runs, name):
    """(b) 3 levels, attention at level 2, skips across the cuts, 4 stages,
    4 microbatches; (c) 4 levels, a double midblock, an uneven cut into 3
    stages, 2 microbatches: the port on its gloo ranks against JAX's
    ``pipelined_denoise`` on a mesh of as many devices, fp32 trunks."""
    _, want, got = runs
    np.testing.assert_allclose(got[(name, "torch.float32")].numpy(), want[name], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_denoise_matches_the_sequential_forward(runs, name, monkeypatch):
    """The same pipelines against the port's own sequential forward of the
    whole batch in an fp32 trunk."""
    inp, _, got = runs
    case = _case(inp, name)
    monkeypatch.setattr(port_unet_module, "ACT_DTYPE", torch.float32)
    core = UNetCore(UNetConfig(**case["cfg"]))
    core.load_state_dict(case["state"])
    with torch.no_grad():
        want = core(case["x"], case["sigma"], case["emb"])
    np.testing.assert_allclose(got[(name, "torch.float32")].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_denoise_is_the_microbatched_trunk_in_bf16(runs, name):
    """In the shipped bf16 trunk the payload is bf16 already: the pipelined
    denoise equals ``precondition``, the trunk run microbatch by microbatch
    and the combine, bit for bit."""
    inp, _, got = runs
    case = _case(inp, name)
    core = UNetCore(UNetConfig(**case["cfg"]))
    core.load_state_dict(case["state"])
    m = case["m"]
    with torch.no_grad():
        x, emb, c_skip, c_out = core.precondition(case["x"], case["sigma"], case["emb"])
        y = torch.cat([core.run_ops(xx, ee, [])[0] for xx, ee in zip(x.chunk(m), emb.chunk(m))])
        want = c_skip * case["x"] + c_out * y.float()
    assert torch.equal(got[(name, "torch.bfloat16")], want)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_stage(runs, name):
    """After ``keep_stage`` a rank's parameters, but for the replicated
    noise embedding, are its stage's in the plan: the op modules of its
    range and ``out_gain``."""
    inp, _, got = runs
    case = _case(inp, name)
    plan = build_stage_plan(UNetConfig(**case["cfg"]), case["mb_shape"], case["stages"])
    held = [c[name] for c in got["param_counts"][:case["stages"]]]
    assert held == plan.stage_param_sizes
    whole = sum(p.numel() for n, p in UNetCore(UNetConfig(**case["cfg"]), device="meta")
                .named_parameters() if not n.startswith("emb_noise."))
    assert sum(held) == whole + case["stages"] - 1      # out_gain on every stage


def test_unet_pipeline_apply_refuses_a_core_without_its_stage(runs):
    inp, _, _ = runs
    case = _case(inp, "real")
    cfg = UNetConfig(**case["cfg"])
    plan = build_stage_plan(cfg, (8,) + case["mb_shape"][1:], 2)
    core = keep_stage(UNetCore(cfg), plan, 1)
    x = torch.zeros((8,) + case["mb_shape"][1:], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lacks its stage's modules"):
        unet_pipeline_apply(core, x, torch.zeros(8, 48), Axis(), 1)
    with pytest.raises(ValueError, match="a plan of 2 stages on an axis of 1"):
        unet_pipeline_apply(core, x, torch.zeros(8, 48), Axis(), 1, plan=plan)


# ---------------------------------------------------------------------------
# (d) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,k", [("real", 2), ("real", 4), ("uneven", 3), ("uneven", 8)])
def test_stage_plan_matches_jax(runs, name, k):
    """Boundaries, boundary states, payload length and every stage's
    parameter count against JAX ``build_stage_plan`` on the test's weights."""
    inp, want, _ = runs
    case = _case(inp, name)
    core = JaxUNetCore(JaxUNetConfig(**case["cfg"]))
    mb = case["mb_shape"]
    jplan = jax_unet_pipeline.build_stage_plan(core, want[name + "_vars"],
                                               jnp.zeros(mb, jnp.bfloat16),
                                               jnp.zeros((mb[0], core._cemb()), jnp.bfloat16), k)
    plan = build_stage_plan(UNetConfig(**case["cfg"]), mb, k)
    assert plan.boundaries == jplan.boundaries
    assert plan.payload_len == jplan.payload_len
    assert plan.stage_param_sizes == jplan.stage_param_sizes and plan.n_stages == k
    assert plan.boundary_specs == [(tuple(x.shape), [tuple(s.shape) for s in sk])
                                   for x, sk in jplan.boundary_specs]


@pytest.fixture(scope="module")
def ref_scale_jax():
    """JAX's boundary states and op costs of the reference-scale UNet for a
    45 s latent at microbatch 1, on abstract variables."""
    core = JaxUNetCore(JaxUNetConfig(**REF_KW))
    shape = (1, 32, 688, 4)
    v = jax.eval_shape(lambda k: core.init(k, jnp.zeros(shape), jnp.ones((1,)),
                                           jnp.zeros((1, core._cemb()))), jax.random.PRNGKey(0))
    specs = jax_unet_pipeline._boundary_state_specs(
        core, v, jnp.zeros(shape, jnp.bfloat16), jnp.zeros((1, core._cemb()), jnp.bfloat16))
    return core, v, specs, jax_unet_pipeline._op_costs(core, specs)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_reference_scale_plan_matches_jax(ref_scale_jax, k):
    """The 356M reference-scale schedule (36 ops) at K 2, 4 and 8: JAX's
    ``_balance`` of its ``_op_costs``, its payload length and its stages'
    parameters from ``jax.eval_shape`` of the init."""
    core, v, specs, costs = ref_scale_jax
    plan = build_stage_plan(UNetConfig(**REF_KW), (1, 32, 688, 4), k)
    bounds = jax_unet_pipeline._balance(costs, k)
    ops, _ = core._build_schedule()
    sizes = [sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jax_unet_pipeline._stage_param_subset(v["params"], [ops[i][0] for i in range(lo, hi)])))
        for lo, hi in zip(bounds, bounds[1:])]
    assert plan.boundaries == bounds
    assert plan.payload_len == max(sum(jax_unet_pipeline._payload_sizes(specs[b]))
                                   for b in bounds)
    assert plan.stage_param_sizes == sizes
    assert plan.boundary_specs == [(tuple(x.shape), [tuple(s.shape) for s in sk])
                                   for x, sk in specs]


def test_stage_plan_refuses_shapes_the_unet_cannot_take():
    cfg = UNetConfig(**REAL_KW)
    with pytest.raises(ValueError, match="must be divisible by 4"):
        build_stage_plan(cfg, (2, 16, 30, 4), 2)
    with pytest.raises(ValueError, match="the input conv takes 4"):
        build_stage_plan(cfg, (2, 16, 32, 5), 2)
    with pytest.raises(ValueError, match="17 stages for a schedule of 16 ops"):
        build_stage_plan(cfg, (2, 16, 32, 4), 17)


# ---------------------------------------------------------------------------
# (f) run_ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trunk", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_run_ops_split_at_every_boundary_is_the_forward(runs, name, trunk, monkeypatch):
    """``run_ops`` one op at a time, the state handed on at every boundary,
    then the combine: the forward bit for bit."""
    inp, _, _ = runs
    case = _case(inp, name)
    monkeypatch.setattr(port_unet_module, "ACT_DTYPE", trunk)
    core = UNetCore(UNetConfig(**case["cfg"]))
    core.load_state_dict(case["state"])
    with torch.no_grad():
        want = core(case["x"], case["sigma"], case["emb"])
        x, emb, c_skip, c_out = core.precondition(case["x"], case["sigma"], case["emb"])
        skips = []
        for b in range(len(core.schedule)):
            x, skips = core.run_ops(x, emb, skips, b, b + 1)
        assert skips == []
        got = c_skip * case["x"] + c_out * x.float()
    assert torch.equal(got, want)
