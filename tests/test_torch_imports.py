"""``repro_torch`` and every one of its modules import with ``jax`` and the
reference package ``repro`` blocked, as does ``chip_smoke.py``: the port
keeps its own copies of what it needs from the reference.  Among them the
serving plan, the examples, the analytic cost model, the MLA, MoE and
int8-cache model code, the tensor-parallel layout (the sharding rules,
the vocab-parallel embedding and cross-entropy and the mesh), the
encoder-decoder and VLM prefix through the config, registry, data, model,
facade, tracer and launcher, and the recurrent blocks with their WKV-6
scan op."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
for name in ("repro_torch.serving.plan", "repro_torch.examples.quickstart",
             "repro_torch.examples.serve_with_plan",
             "repro_torch.core.analytic", "repro_torch.models.layers",
             "repro_torch.models.stacked", "repro_torch.serving.engine",
             "repro_torch.distributed.sharding",
             "repro_torch.distributed.tensor_parallel",
             "repro_torch.models.vocab_parallel", "repro_torch.launch.mesh",
             "repro_torch.models.model", "repro_torch.models.config",
             "repro_torch.configs", "repro_torch.data.pipeline",
             "repro_torch.plan.facade", "repro_torch.core.trace",
             "repro_torch.launch.train", "repro_torch.models.recurrent"):
    assert name in names, name
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 15   # every module was imported


_LIGHT = r"""
import sys
import repro_torch.distributed.train_step, repro_torch.models.stacked
import repro_torch.serving.engine
print(sorted(m for m in sys.modules if m.split(".")[:2] in (
    ["repro_torch", "core"], ["repro_torch", "plan"],
    ["repro_torch", "cluster"])))
"""


def test_model_step_and_engine_load_no_search():
    """The model marks its scans through ``models/regions.py``: importing
    the model, the train step or the serving engine loads nothing of the
    tracer, the search or the cluster model."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _LIGHT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split("\n")[-2] == "[]", proc.stdout
