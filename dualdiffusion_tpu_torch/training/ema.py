"""Multi-profile EMA bank with power-function profiles, feedback and switch
EMA, host-memory profiles, bf16 archive snapshots and post-hoc
reconstruction from them (JAX: dualdiffusion_tpu/training/ema.py; reference:
src/training/ema.py).

A profile is a dict name -> tensor beside the model's parameters and
persistent buffers (the DAE's latent stats: the JAX bank averages every
variable collection it is given, "stats" with "params"), updated in place
after each optimizer step (``torch._foreach`` lerp in the
accumulation dtype, stored in the profile's dtype). A ``cpu_offload``
profile lives in host memory as fp32 CPU tensors (``EMABank.host_init`` /
``host_update``), driven by ``AsyncHostEMA``: each step's weights go to the
host as one packed fp32 buffer, copied without blocking into pinned memory,
and a worker thread lerps them once the copy's CUDA event has completed.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..weights import flax_key

Profile = Dict[str, torch.Tensor]


# NVIDIA EDM2 power-function EMA math (Karras et al., arXiv:2312.02696,
# Algorithms 2/3 and eqs. 121-151, as in NVlabs/edm2 training/phema.py).

def exp_to_std(exp) -> np.ndarray:
    exp = np.asarray(exp, np.float64)
    return np.sqrt((exp + 1) / (exp + 2) ** 2 / (exp + 3))


def std_to_exp(std) -> np.ndarray:
    """Relative std -> power-function exponent (eq. 126 / alg. 2)."""
    std = np.asarray(std, np.float64)
    tmp = std.flatten() ** -2
    exp = [np.roots([1, 7, 16 - t, 12 - t]).real.max() for t in tmp]
    return np.float64(exp).reshape(std.shape)


def power_function_beta(std: float, t_next: float, t_delta: float) -> float:
    """Per-step beta tracking a power-function profile (eq. 127)."""
    exp = float(std_to_exp(np.array(std)))
    return (1.0 - t_delta / t_next) ** (exp + 1.0)


def power_function_correlation(a_ofs, a_std, b_ofs, b_std) -> np.ndarray:
    a_exp = std_to_exp(a_std)
    b_exp = std_to_exp(b_std)
    t_ratio = a_ofs / b_ofs
    t_exp = np.where(a_ofs < b_ofs, b_exp, -a_exp)
    t_max = np.maximum(a_ofs, b_ofs)
    num = (a_exp + 1) * (b_exp + 1) * t_ratio ** t_exp
    den = (a_exp + b_exp + 1) * t_max
    return num / den


def solve_posthoc_coefficients(in_ofs, in_std, out_ofs, out_std) -> np.ndarray:
    """Least-squares mixing coefficients (alg. 3), normalized to sum to 1."""
    in_ofs, in_std = np.broadcast_arrays(in_ofs, in_std)
    out_ofs, out_std = np.broadcast_arrays(out_ofs, out_std)
    rv = lambda x: np.asarray(x, np.float64).reshape(-1, 1)  # noqa: E731
    cv = lambda x: np.asarray(x, np.float64).reshape(1, -1)  # noqa: E731
    a = power_function_correlation(rv(in_ofs), rv(in_std), cv(in_ofs), cv(in_std))
    b = power_function_correlation(rv(in_ofs), rv(in_std), cv(out_ofs), cv(out_std))
    x = np.linalg.solve(a, b)
    return x / np.sum(x, axis=0)


def reconstruct_phema(out_std: float, phema_path) -> Dict[str, np.ndarray]:
    """Post-hoc EMA (JAX ema.py:432-459; reference: ema.py:147-191): the
    least-squares combination, at the archives' latest sample count, of the
    bf16 snapshots in ``phema_path`` (as ``save_ema_archive`` of either
    package writes them), accumulated in float64. Returns the archives' flat
    dict in fp32, under their keys: the port writes 0-d leaves as (1,) under
    a ``#0d`` key, the JAX package as (1,) under the bare key."""
    from safetensors import safe_open
    emas = []
    for f in sorted(Path(phema_path).iterdir()):
        if not f.name.lower().endswith(".safetensors"):
            continue
        with safe_open(str(f), framework="pt") as h:
            meta = h.metadata() or {}
        emas.append({"path": f, "std": float(meta["std"]),
                     "n_processed": int(meta["total_samples_processed"])})
    if not emas:
        raise FileNotFoundError(f"no ema archives in {phema_path}")
    emas.sort(key=lambda e: (e["n_processed"], e["std"]))
    out_n = max(e["n_processed"] for e in emas)
    coefs = solve_posthoc_coefficients(
        np.array([e["n_processed"] for e in emas]), np.array([e["std"] for e in emas]),
        np.array([out_n]), np.array([out_std]))
    state: Optional[Dict[str, torch.Tensor]] = None
    for i, e in enumerate(emas):
        with safe_open(str(e["path"]), framework="pt") as h:
            sd = {k: h.get_tensor(k) for k in h.keys()}
        if state is None:
            state = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in sd.items()}
        for k in state:
            state[k] += sd[k].double() * float(coefs[i, 0])
    return {k: v.float().numpy() for k, v in state.items()}


@dataclass
class EMAConfig:
    """One EMA profile; field names and defaults of the JAX EMAConfig."""
    name: str
    beta: Optional[float] = None            # classic EMA
    std: Optional[float] = None             # power-function EMA
    num_warmup_steps: Optional[int] = None
    num_archive_steps: Optional[int] = None
    feedback_beta: Optional[float] = None   # lerp EMA back into train weights
    num_switch_ema_epochs: Optional[int] = None
    use_float64: bool = False
    store_dtype: str = "float32"            # float32 | bfloat16
    cpu_offload: bool = False
    include_in_validation: bool = True

    def __post_init__(self):
        if (self.beta is None) == (self.std is None):
            raise ValueError(f"ema '{self.name}': specify exactly one of beta/std")
        if self.beta is not None and not (0 <= self.beta < 1):
            raise ValueError(f"ema '{self.name}': invalid beta {self.beta}")
        if self.std is not None and self.std < 0:
            raise ValueError(f"ema '{self.name}': invalid std {self.std}")
        if self.feedback_beta is not None and not (0 <= self.feedback_beta < 1):
            raise ValueError(f"ema '{self.name}': invalid feedback_beta")
        if self.std is not None and (self.num_warmup_steps or 0) > 0:
            raise ValueError(f"ema '{self.name}': power-function ema cannot warm up")
        if self.store_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"ema '{self.name}': store_dtype must be "
                             f"float32|bfloat16, got {self.store_dtype}")
        if self.cpu_offload and (self.feedback_beta is not None
                                 or self.num_switch_ema_epochs):
            raise ValueError(f"ema '{self.name}': cpu_offload is incompatible "
                             f"with feedback/switch EMA (host profile cannot "
                             f"write back into the jitted step)")
        if self.cpu_offload and self.use_float64:
            raise ValueError(f"ema '{self.name}': host profiles are fp32")


def trained_tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters and persistent buffers of a trained module: what an EMA
    profile tracks and a checkpoint restores."""
    return module.state_dict(keep_vars=True)


class EMABank:
    """Named EMA profiles of one module's parameters: the device profiles in
    the train state, updated by ``update``; the ``cpu_offload`` ones
    (``offloaded``) by ``host_update``."""

    def __init__(self, configs: List[EMAConfig]) -> None:
        names = [c.name for c in configs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate ema names")
        self.configs: Dict[str, EMAConfig] = {c.name: c for c in configs}
        switch = [c.name for c in configs if c.num_switch_ema_epochs]
        if len(switch) > 1:
            raise ValueError("only one EMA can be the switch EMA")
        self.switch_ema_name = switch[0] if switch else None
        self.offloaded = [c.name for c in configs if c.cpu_offload]

    @staticmethod
    def storage_dtype(cfg: EMAConfig) -> torch.dtype:
        if cfg.use_float64:
            return torch.float64
        return torch.bfloat16 if cfg.store_dtype == "bfloat16" else torch.float32

    def beta(self, cfg: EMAConfig, total_samples_processed: int, batch_size: int,
             global_step: int) -> float:
        if cfg.beta is not None:
            beta = float(np.float32(cfg.beta))
        else:
            beta = power_function_beta(cfg.std, total_samples_processed + batch_size, batch_size)
        if cfg.num_warmup_steps:
            beta = beta * min(global_step / cfg.num_warmup_steps, 1.0)
        return beta

    def init(self, module: nn.Module) -> Dict[str, Profile]:
        """Every device profile starts as a copy of the module's tracked
        tensors; the host profiles live apart (``host_init``)."""
        return {name: {k: p.detach().to(self.storage_dtype(cfg), copy=True)
                       for k, p in trained_tensors(module).items()}
                for name, cfg in self.configs.items() if not cfg.cpu_offload}

    @torch.no_grad()
    def update(self, ema_state: Dict[str, Profile], module: nn.Module,
               total_samples_processed: int, batch_size: int, global_step: int) -> None:
        """One EMA step of every profile, in place, with the counters from
        before the step; a feedback profile then lerps the parameters toward
        itself."""
        params = trained_tensors(module)
        for name, cfg in self.configs.items():
            if cfg.cpu_offload:
                continue
            b = self.beta(cfg, total_samples_processed, batch_size, global_step)
            store = self.storage_dtype(cfg)
            keys = list(ema_state[name])
            ema = [ema_state[name][k] for k in keys]
            ps = [params[k].detach() for k in keys]
            if store == torch.bfloat16:
                new = [e.float() * b + p.float() * (1.0 - b) for e, p in zip(ema, ps)]
                torch._foreach_copy_(ema, new)
            else:
                ps = [p.to(store) for p in ps]
                torch._foreach_mul_(ema, b)
                torch._foreach_add_(ema, ps, alpha=1.0 - b)
            if cfg.feedback_beta is not None:
                fb = cfg.feedback_beta
                tgt = [params[k] for k in keys]
                torch._foreach_mul_(tgt, fb)
                torch._foreach_add_(tgt, [e.to(t.dtype) for e, t in zip(ema, tgt)],
                                    alpha=1.0 - fb)

    def host_init(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, Profile]:
        """The host profiles, each an fp32 CPU copy of ``tensors``."""
        return {name: {k: v.detach().to("cpu", torch.float32, copy=True)
                       for k, v in tensors.items()} for name in self.offloaded}

    @torch.no_grad()
    def host_update(self, host_state: Dict[str, Profile], tensors: Dict[str, torch.Tensor],
                    total_samples_processed: int, batch_size: int, global_step: int) -> None:
        """One EMA step of every host profile toward ``tensors`` (fp32 CPU),
        in place, with the counters from before the step."""
        for name in self.offloaded:
            b = self.beta(self.configs[name], total_samples_processed, batch_size, global_step)
            keys = list(host_state[name])
            ema = [host_state[name][k] for k in keys]
            torch._foreach_mul_(ema, b)
            torch._foreach_add_(ema, [tensors[k] for k in keys], alpha=1.0 - b)

    def get_betas(self, total_samples_processed: int, batch_size: int) -> Dict[str, float]:
        return {name: cfg.beta if cfg.beta is not None else
                power_function_beta(cfg.std, total_samples_processed + batch_size, batch_size)
                for name, cfg in self.configs.items()}

    @torch.no_grad()
    def maybe_switch(self, ema_state: Dict[str, Profile], module: nn.Module, epoch: int,
                     global_step: int,
                     normalize_fn: Optional[Callable[[nn.Module], None]] = None
                     ) -> Optional[str]:
        """SwitchEMA: every N epochs load the switch profile into the train
        weights (in place). Returns the profile's name if it switched."""
        name = self.switch_ema_name
        if name is None:
            return None
        cfg = self.configs[name]
        if cfg.num_warmup_steps and global_step < cfg.num_warmup_steps:
            return None
        if epoch % cfg.num_switch_ema_epochs != 0:
            return None
        for k, p in trained_tensors(module).items():
            p.copy_(ema_state[name][k])
        if normalize_fn is not None:
            normalize_fn(module)
        return name

    def validation_emas(self) -> List[str]:
        return [n for n, c in self.configs.items() if c.include_in_validation]


class AsyncHostEMA:
    """Drives the bank's ``cpu_offload`` profiles off the training thread.

    ``update`` packs the module's tensors into one fp32 device buffer, starts
    its copy into pinned host memory without blocking, records a CUDA event
    after it, and queues the lerp for a single worker thread, which waits on
    the event before it reads. A depth-1 queue bounds the staleness to one
    step, and updates apply in submission order. Three pinned buffers take
    turns: while one is filled, the queue holds at most one and the worker
    reads at most one. On CPU tensors the copy is a plain one.

    Read ``profiles`` only after ``sync()``. A worker's exception is raised
    again by the next ``update`` or ``sync``.
    """

    RING = 3

    def __init__(self, bank: EMABank, batch_size: int):
        self.bank = bank
        self.batch_size = batch_size
        self.profiles: Optional[Dict[str, Profile]] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._layout = None        # (keys, shapes, sizes) of the packed buffer
        self._packed = None        # the device buffer the step's tensors are packed into
        self._host: List[torch.Tensor] = []
        self._turn = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="async-host-ema")
        self._thread.start()

    def restore(self, profiles: Optional[Dict[str, Profile]]) -> None:
        """Install profiles (seeded by ``EMABank.host_init`` from the weights
        before the first step, or restored from a checkpoint); a missing one
        is seeded from the weights of the next update."""
        self.sync()
        self.profiles = profiles or None

    def update(self, tensors: Dict[str, torch.Tensor], total_samples_processed: int,
               global_step: int) -> None:
        """Submit one EMA step toward ``tensors``, the module's tensors after
        the step just taken; the counters are the state's after it."""
        self._raise_pending()
        host, event = self._stage(tensors)
        self._queue.put((host, event, self._layout, total_samples_processed, global_step))

    def _stage(self, tensors: Dict[str, torch.Tensor]):
        keys = list(tensors)
        layout = (keys, [tuple(tensors[k].shape) for k in keys],
                  [tensors[k].numel() for k in keys])
        if self._layout != layout:
            self.sync()
            self._layout = layout
            first = tensors[keys[0]]
            self._packed = torch.empty((sum(layout[2]),), dtype=torch.float32,
                                       device=first.device)
            self._host = [torch.empty((sum(layout[2]),), dtype=torch.float32,
                                      pin_memory=first.is_cuda) for _ in range(self.RING)]
        with torch.no_grad():
            torch.cat([tensors[k].detach().reshape(-1).float() for k in keys], out=self._packed)
        host = self._host[self._turn]
        self._turn = (self._turn + 1) % self.RING
        event = None
        if self._packed.is_cuda:
            host.copy_(self._packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host.copy_(self._packed)
        return host, event

    def sync(self) -> None:
        """Block until every submitted update has been applied."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                host, event, (keys, shapes, sizes), tsp, step = item
                if event is not None:
                    event.synchronize()     # the copy has landed in ``host``
                views, ofs = {}, 0
                for k, shape, n in zip(keys, shapes, sizes):
                    views[k] = host[ofs:ofs + n].view(shape)
                    ofs += n
                if self.profiles is None:
                    # driven without a seed: the first weights seed, one lerp late
                    self.profiles = self.bank.host_init(views)
                    continue
                for name in self.bank.offloaded:
                    if name not in self.profiles:     # a partial restore
                        self.profiles[name] = {k: v.clone() for k, v in views.items()}
                self.bank.host_update(self.profiles, views, int(tsp) - self.batch_size,
                                      self.batch_size, int(step) - 1)
            except BaseException as e:      # raised again by the next update() or sync()
                self._error = e
            finally:
                self._queue.task_done()


def save_ema_archive(profile: Profile, path, global_step: int,
                     total_samples_processed: int, std: float) -> None:
    """bf16 archive snapshot of a profile, under the JAX package's flat keys,
    for post-hoc reconstruction."""
    from safetensors.torch import save_file
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {flax_key(k, v.dim() == 0): v.detach().reshape(v.shape or (1,)).to(torch.bfloat16)
            .cpu().contiguous() for k, v in profile.items()}
    save_file(flat, str(path), metadata={"std": str(std), "global_step": str(global_step),
                                         "total_samples_processed": str(total_samples_processed)})
