"""The import check: nothing that ``benchmark/run.py`` or the plain
reference loads is JAX or the JAX package, compared by whole top-level
names (``dualdiffusion_tpu_torch`` begins with ``dualdiffusion_tpu`` and is
not it), and the reference loads nothing of the port."""

import json
import subprocess
import sys

from benchmark.common import ROOT
from benchmark.run import FORBIDDEN, forbidden_modules

RUN_EVERY_CELL = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
from benchmark import common
from benchmark.run import measure
from benchmark.tests.tiny import tiny_root
root = tiny_root(tempfile.mkdtemp())
spec = common.benchmark_spec(root)
for w in spec["workloads"]:
    for trace in (0, 1):
        measure(spec, w["name"], 2 ** 31 + 5, 0.0, trace, "cpu", root=root)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.common import make_weights
from benchmark.reference import model, serve
from benchmark.reference.precision import CONTROL
from benchmark.tests.tiny import TINY_TRAFFIC, tiny_config
for name, traffic in (("ref_scale", dict(decode_mode="fgla", batch=2)),
                      ("edm2_default", dict(decode_mode="auto", batch=1))):
    cfg = tiny_config(name)
    made = {{m: make_weights(model.parameter_shapes(
        (model.DAE if m == "dae" else model.UNet)(cfg[m])), 9, "cpu")
        for m in ("unet", "dae", "ddec") if m in cfg}}
    tr = dict(TINY_TRAFFIC, cfg_scale=1.5, **traffic)
    ref = serve.ServeReference(cfg, made, "cpu")
    ctl = serve.ServeReference(cfg, made, "cpu", CONTROL)
    b = tr["batch"]
    # 64 / 128 mel frames of 256 bins, the tiny DAE halving both
    lat_shape = (b, 128, 32 if name == "ref_scale" else 64, cfg["dae"]["latent_channels"])
    request = dict(seed=3, emb=torch.randn(b, cfg["unet"]["in_channels_emb"]),
                   lat_shape=lat_shape, rows=slice(0, b))
    gaps = serve.compare(ref, tr, request, ctl)
    assert all(v > 0 for v in gaps.values()), gaps
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_cell_loads_no_jax():
    names = loaded(RUN_EVERY_CELL)
    assert "dualdiffusion_tpu_torch" in names and "torch" in names
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


def test_reference_loads_neither_jax_nor_the_port():
    names = loaded(RUN_REFERENCE)
    assert "torch" in names
    assert not names & (set(FORBIDDEN) | {"dualdiffusion_tpu_torch"})


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dualdiffusion_tpu_torch_like", sys)
    assert forbidden_modules() == [] or "dualdiffusion_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in forbidden_modules()
