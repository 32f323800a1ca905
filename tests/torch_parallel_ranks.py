"""Rank functions of the port's multi-process CPU tests (imported by the
spawned ranks, so it imports no JAX).

``spawn(fn, world, tmp)`` starts ``world`` gloo ranks that rendezvous
through a file in ``tmp``, one thread each; each runs ``fn(rank, world, tmp)``
and the test module reads back what rank 0 saved. A rank that raises, or a
run past its timeout, fails the test.
"""

import collections
import time
import uuid
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import dualdiffusion_tpu_torch.models.layers as port_layers_module
import dualdiffusion_tpu_torch.models.unet as port_unet_module
from dualdiffusion_tpu_torch.models import DAE, DAEConfig, MPConv, UNet, UNetConfig
from dualdiffusion_tpu_torch.models.unet import UNetBlock, UNetCore
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.parallel import (Axis, MeshConfig, ParallelState, build_stage_plan,
                                              gather_w, gathered, keep_stage, make_mesh,
                                              maybe_initialize_distributed,
                                              param_sharding_rule, pipeline_apply,
                                              pipelined_denoise, shard_batch, shard_of,
                                              shard_train_state, shard_w, sharded_tiled_decode,
                                              sharded_tiled_encode, shutdown, whole)
from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, save_module
from dualdiffusion_tpu_torch.sampling import SampleParams, edm_sample
from dualdiffusion_tpu_torch.training import (DAETrainConfig, EMABank, EMAConfig,
                                              SigmaSamplerConfig, Trainer, TrainerConfig,
                                              UNetTrainConfig, build_optimizer,
                                              init_train_state, make_dae_train_step,
                                              make_unet_train_step)
from dualdiffusion_tpu_torch.training.ema import trained_tensors
from dualdiffusion_tpu_torch.training.losses import MSSLoss2DConfig
from dualdiffusion_tpu_torch.training.optim import jax_param_paths
from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat


def spawn(fn, world: int, tmp, timeout: float = 240.0) -> None:
    rendezvous = f"file://{Path(tmp) / f'rdzv_{uuid.uuid4().hex}'}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp), rendezvous), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _entry(rank: int, fn, world: int, tmp: str, rendezvous: str) -> None:
    torch.set_num_threads(1)
    maybe_initialize_distributed(rendezvous, world, rank, device="cpu")
    try:
        fn(rank, world, Path(tmp))
    finally:
        shutdown()


def _load(path: Path):
    return torch.load(path, weights_only=False)


def unet_step_setup(inp, parallel=None, optimizer: str = "adamw"):
    """The tiny UNet of ``inp`` in an fp32 trunk, made whole on every rank and
    sharded by ``parallel``, its optimizer ("adamw", or "muon" over the
    ``w_mp`` weights), EMA bank, step and state."""
    port_unet_module.ACT_DTYPE = torch.float32
    model = UNet(UNetConfig(**inp["unet_kw"]))
    model.load_state_dict(inp["state"])
    if parallel is not None:
        parallel.prepare(model)
    opt = build_optimizer(optimizer, jax_param_paths(model), inp["lr"])
    data = parallel.data if parallel is not None else None
    opt.axis = data
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tc = UNetTrainConfig(sigma=SigmaSamplerConfig(**inp["sigma_kw"]), **inp["train_kw"])
    step = make_unet_train_step(opt, bank, tc, inp["n"], data=data)
    state = init_train_state(model, opt, bank, tc.sigma, torch.Generator())
    return model, bank, tc, step, state


def unet_steps(rank: int, world: int, tmp: Path) -> None:
    """The same two UNet steps under data parallelism (2 x 1 mesh), FSDP
    (2 x 1, weights sharded over "data") and tensor parallelism (1 x 2),
    with AdamW, and under FSDP and tensor parallelism with Muon; each rank
    fed its share of the global batches and the global draws; rank 0 saves
    the whole parameters, EMA and logs. The FSDP run also writes a trainer
    checkpoint; the tensor-parallel one also records the sharding rule on
    every leaf."""
    inp = _load(tmp / "unet_inputs.pt")
    for mode in ("dp", "fsdp", "tp", "fsdp_muon", "tp_muon"):
        mesh = make_mesh(MeshConfig(model_axis=2 if mode.startswith("tp") else 1))
        parallel = ParallelState(mesh, fsdp=mode.startswith("fsdp"))
        if mode == "tp":
            rule = {k: type(param_sharding_rule(mesh, v, "model")).__name__
                    for k, v in UNet(UNetConfig(**inp["unet_kw"])).state_dict().items()}
        model, bank, tc, step, state = unet_step_setup(
            inp, parallel, "muon" if mode.endswith("muon") else "adamw")
        logs, saved = [], []
        own = {p.data_ptr() for p in model.parameters()}

        def keep(t):        # the shapes of what the step saves for its backward, but params
            if t.data_ptr() not in own:
                saved.append(tuple(t.shape))
            return t

        for batch, draws in zip(inp["batches"], inp["draws"]):
            local = shard_batch(mesh, batch, tc.grad_accum_steps)
            with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
                out = step(state, local, draws)
            logs.append({"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
                         "bucket_counts": out["bucket_counts"].clone(),
                         "sample_losses": parallel.data.gather(out["sample_losses"])})
        sharded = sorted(k for k, v in trained_tensors(model).items()
                         if getattr(v, "dd_shard", None) is not None)
        # the whole weights FSDP shards: the step must save none of them
        whole_shapes = {tuple(v.shape) for k, v in UNet(UNetConfig(**inp["unet_kw"]))
                        .state_dict().items() if k.endswith(".w_mp") and v.shape[0] % 2 == 0}
        if mode == "dp":
            # a model axis of one rank leaves every weight whole
            shard_train_state(mesh, model, "model")
            assert not any(hasattr(v, "dd_shard") for v in model.parameters())
        ema = state_to_flat(whole(state.ema_state["std0.05"], trained_tensors(model)))
        with gathered(model):
            params = to_flat(model)
        if mode == "fsdp":
            cfg = TrainerConfig(model_path=str(tmp / "fsdp_model"), module_name="unet")
            kw = inp["unet_kw"]

            def export(ckpt, module, global_step=0):
                save_module(ckpt, "unet", "unet", UNetConfig(**kw), module, global_step)
            Trainer(cfg, step, state, [], ema_bank=bank, export_module_fn=export,
                    parallel=parallel).save_checkpoint()
        if rank == 0:
            res = {"logs": logs, "params": params, "ema": ema, "sharded": sharded,
                   "sigma_pdf": state.sigma_pdf.clone(),
                   "saved_whole": sum(shape in whole_shapes for shape in saved)}
            if mode == "tp":
                res["rule"] = rule
            torch.save(res, tmp / f"unet_{mode}.pt")


def remat_steps(rank: int, world: int, tmp: Path) -> None:
    """The UNet steps of ``inp`` under FSDP (2 x 1) and tensor parallelism
    (1 x 2), each with and without ``remat_blocks``, each rank fed its share
    of the global batches and the global draws. Rank 0 saves the whole
    parameters and the logs, how many whole weights the steps saved for
    their backward, and, per step, how often each sharded weight was
    gathered whole."""
    inp = _load(tmp / "remat_inputs.pt")
    gathers = collections.Counter()
    gather_rows = port_layers_module.gather_rows

    def counted(w, axis, scale):
        gathers[w.data_ptr()] += 1
        return gather_rows(w, axis, scale)
    port_layers_module.gather_rows = counted
    whole_shapes = {tuple(v.shape) for k, v in UNet(UNetConfig(**inp["unet_kw"]))
                    .state_dict().items() if k.endswith(".w_mp") and v.shape[0] % 2 == 0}
    for mode in ("fsdp", "tp"):
        for remat in (False, True):
            mesh = make_mesh(MeshConfig(model_axis=2 if mode == "tp" else 1))
            parallel = ParallelState(mesh, fsdp=mode == "fsdp")
            model, _, tc, step, state = unet_step_setup(
                dict(inp, unet_kw=dict(inp["unet_kw"], remat_blocks=remat)), parallel)
            own = {p.data_ptr() for p in model.parameters()}
            logs, saved, per_step = [], [], []

            def keep(t):
                if t.data_ptr() not in own:
                    saved.append(tuple(t.shape))
                return t

            for batch, draws in zip(inp["batches"], inp["draws"]):
                gathers.clear()
                with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
                    out = step(state, shard_batch(mesh, batch, tc.grad_accum_steps), draws)
                per_step.append(dict(gathers))
                logs.append({"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])})
            sharded = {p.data_ptr() for p in model.parameters()
                       if getattr(p, "dd_shard", None) is not None}
            with gathered(model):
                params = to_flat(model)
            if rank == 0:
                torch.save({"logs": logs, "params": params, "n_sharded": len(sharded),
                            "gathers": [sorted(c.get(p, 0) for p in sharded) for c in per_step],
                            "saved_whole": sum(shape in whole_shapes for shape in saved)},
                           tmp / f"remat_{mode}_{remat}.pt")


def tp_denoise(rank: int, world: int, tmp: Path) -> None:
    """The EDM sampler with CFG on the tiny UNet, its weights sharded over a
    2-wide model axis, then ``generate`` on the pipeline of ``tmp/model``
    after ``Pipeline.shard(2)``; rank 0 saves the latents and the clip."""
    inp = _load(tmp / "denoise_inputs.pt")
    port_unet_module.ACT_DTYPE = torch.float32
    model = UNet(UNetConfig(**inp["unet_kw"]))
    model.load_state_dict(inp["state"])
    shard_train_state(make_mesh(MeshConfig(data_axis=1, model_axis=2)), model)
    out = {"latents": sample_latents(model, inp["shape"]),
           "generate": generate_clip(Pipeline.from_pretrained(tmp / "model", device="cpu")
                                     .shard(2))}
    if rank == 0:
        torch.save(out, tmp / "denoise_tp.pt")


@torch.no_grad()
def generate_clip(pipe):
    """2 steps with a prompt and CFG, the DAE decode and 2 FGLA iterations."""
    params = SampleParams(steps=2, num_fgla_iters=2, seed=3)
    out = pipe.generate(params, torch.Generator().manual_seed(3),
                        prompt_embedding=pipe.get_prompt_embedding({"label_a": 1.0}))
    return {k: out[k] for k in ("latents", "sample", "raw")}


@torch.no_grad()
def sample_latents(model, shape):
    """8 Heun steps with CFG 1.5 from seed 7 (the JAX
    test_tensor_parallel_sampler_matches_replicated's)."""
    emb_c = model.get_embeddings(torch.ones((1, model.cfg.in_channels_emb)), torch.ones((1,)))
    emb2 = torch.cat([emb_c, emb_c * 0], dim=0)
    return edm_sample(lambda x, sigma: model(x, sigma, emb2), shape,
                      SampleParams(steps=8, cfg_scale=1.5, use_heun=True), 80.0, 0.03, 1.0,
                      generator=torch.Generator().manual_seed(7), use_cfg=True)


def dae_setup(inp, data=None):
    """The tiny DAE of ``inp`` and its optimizer, EMA bank, step and state."""
    model = DAE(DAEConfig(**inp["dae_kw"]))
    model.load_state_dict(inp["state"])
    opt = build_optimizer("adamw", model.parameters(), inp["lr"])
    opt.axis = data
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    cfg = DAETrainConfig(mss2d=MSSLoss2DConfig(**inp["mss_kw"]), **inp["train_kw"])
    step = make_dae_train_step(MSMDCTDualFormat(MSMDCTDualFormatConfig(**inp["fmt_kw"])),
                               opt, bank, cfg, inp["n"], data)
    state = init_train_state(model, opt, bank, SigmaSamplerConfig(), torch.Generator())
    return model, step, state


def dae_steps(rank: int, world: int, tmp: Path) -> None:
    """Two DAE steps under data parallelism, each rank fed its share of the
    global audio and the global draws; rank 0 saves params, EMA and logs."""
    inp = _load(tmp / "dae_inputs.pt")
    mesh = make_mesh(MeshConfig())
    parallel = ParallelState(mesh)
    model, step, state = dae_setup(inp, parallel.data)
    parallel.prepare(model)
    logs = []
    for audio, draws in zip(inp["audio"], inp["draws"]):
        local = shard_batch(mesh, {"audio": audio}, inp["train_kw"]["grad_accum_steps"])
        out = step(state, local, draws)
        logs.append({k: float(v) for k, v in out.items() if v.dim() == 0}
                    | {"sample_losses": parallel.data.gather(out["sample_losses"])})
    if rank == 0:
        torch.save({"logs": logs, "params": to_flat(model),
                    "ema": state_to_flat(state.ema_state["std0.05"])}, tmp / "dae_dp.pt")


def _axes(rank: int, world: int, sizes=()):
    """{n: this rank's Axis over ranks [0, n)} for n = world (the mesh's
    model axis) and each of ``sizes`` (a group of its own; None where this
    rank is outside it)."""
    axes = {world: Axis.of(make_mesh(MeshConfig(model_axis=world)), "model")}
    for n in sizes:
        group = dist.new_group(list(range(n)))      # a collective: every rank calls it
        axes[n] = Axis(group, rank, n) if rank < n else None
    return axes


def pipeline_runs(rank: int, world: int, tmp: Path) -> None:
    """Four ranks: the UNetBlock stages through ``pipeline_apply`` (rank r
    holds block r); ``pipelined_denoise`` of each UNet of ``tmp/
    pipeline_inputs.pt`` on its ranks, in fp32 and bf16 trunks, each rank
    keeping only its stage; rank 0 saves the outputs and every rank's
    parameter counts."""
    inp = _load(tmp / "pipeline_inputs.pt")
    axes = _axes(rank, world, sorted({c["stages"] for c in inp["unets"]} - {world}))
    blk = inp["block"]
    block = UNetBlock(UNetConfig(**blk["cfg"]), *blk["channels"])
    block.load_state_dict(blk["states"][rank])
    res = {"block": pipeline_apply(lambda b, x: b(x, None), block, blk["x"], axes[world],
                                   blk["m"])}
    counts = {}
    for case in inp["unets"]:
        axis = axes[case["stages"]]
        if axis is None:
            continue
        cfg = UNetConfig(**case["cfg"])
        for dtype in (torch.float32, torch.bfloat16):
            port_unet_module.ACT_DTYPE = dtype
            core = UNetCore(cfg)
            core.load_state_dict(case["state"])
            plan = build_stage_plan(cfg, case["mb_shape"], axis.size)
            keep_stage(core, plan, axis.rank)
            out = pipelined_denoise(core, case["x"], case["sigma"], case["emb"], axis, case["m"],
                                    plan=plan)
            res[(case["name"], str(dtype))] = out
            counts[case["name"]] = sum(p.numel() for n, p in core.named_parameters()
                                       if not n.startswith("emb_noise."))
    port_unet_module.ACT_DTYPE = torch.bfloat16
    everyone = [None] * world
    dist.all_gather_object(everyone, counts)
    if rank == 0:
        res["param_counts"] = everyone
        torch.save(res, tmp / "pipeline_out.pt")


def sharded_dae_runs(rank: int, world: int, tmp: Path) -> None:
    """The DAE of ``tmp/dae_inputs.pt`` encoding and decoding the W shards of
    its mel and latents over 4 ranks and over ranks [0, 2); rank 0 saves
    the gathered latents and decoded mel of each. Over ranks [0, 2) also at
    halo 0, beside each rank's encode and decode of its shard alone."""
    inp = _load(tmp / "dae_inputs.pt")
    dae = DAE(DAEConfig(**inp["dae_kw"]))
    dae.load_state_dict(inp["state"])
    dae.eval()
    ds = dae.downsample_ratio
    res = {}
    for n, axis in _axes(rank, world, inp["sizes"]).items():
        if axis is None:
            continue
        with torch.no_grad():
            lat = sharded_tiled_encode(dae.encode, shard_w(inp["x"], axis), axis, inp["halo"], ds)
            dec = sharded_tiled_decode(dae.decode, shard_w(inp["latents"], axis), axis,
                                       inp["halo_latent"], ds)
        res[n] = {"encode": gather_w(lat, axis), "decode": gather_w(dec, axis)}
        if n == 2:
            x, latents = shard_w(inp["x"], axis), shard_w(inp["latents"], axis)
            with torch.no_grad():
                zero = {"encode": sharded_tiled_encode(dae.encode, x, axis, 0, ds),
                        "decode": sharded_tiled_decode(dae.decode, latents, axis, 0, ds),
                        "encode_alone": dae.encode(x), "decode_alone": dae.decode(latents)}
            res["zero_halo"] = {k: gather_w(v, axis) for k, v in zero.items()}
    if rank == 0:
        torch.save(res, tmp / "dae_out.pt")


def mpconv_gain_runs(rank: int, world: int, tmp: Path) -> None:
    """Each MPConv of ``tmp/gain_inputs.pt`` with its per-sample gain, in
    training, tensor-parallel (a 1 x 2 mesh) and under FSDP (2 x 1), every
    rank fed the same input and output gradient; rank 0 saves each output
    and the gradients of the input and of the gain."""
    inp = _load(tmp / "gain_inputs.pt")
    res = {}
    for mode in ("tp", "fsdp"):
        mesh = make_mesh(MeshConfig(model_axis=2 if mode == "tp" else 1))
        for i, case in enumerate(inp["cases"]):
            conv = MPConv(**case["kw"])
            conv.load_state_dict(case["state"])
            ParallelState(mesh, fsdp=mode == "fsdp").prepare(conv)
            if shard_of(conv.weight) is None:
                raise AssertionError(f"case {i} was not sharded under {mode}")
            x = case["x"].clone().requires_grad_()
            g = case["gain"].clone().requires_grad_()
            out = conv(x, gain=g, training=True)
            (out * case["probe"]).sum().backward()
            res[(mode, i)] = {"out": out.detach(), "x": x.grad, "gain": g.grad}
    if rank == 0:
        torch.save(res, tmp / "gain_out.pt")
