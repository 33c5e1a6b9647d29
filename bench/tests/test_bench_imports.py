"""Nothing the harness runs imports ``jax``, ``jaxlib``, ``flax`` or the
reference package ``repro`` (compared by whole top-level name: the port's
``repro_torch`` passes): a small run of each configuration on the CPU in
a fresh process, with those imports blocked, and the harness's own check
of ``sys.modules`` after it."""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

PROBE = r"""
import importlib.abc, sys, time, tempfile, pathlib
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1] + "/../../src", sys.argv[1] + "/..", sys.argv[1]]
import torch
import bench_tiny
from perfkit import harness
harness.CACHE = pathlib.Path(tempfile.mkdtemp())
for name in bench_tiny.CONFIGS:
    harness.run(bench_tiny.cell(name, limits={}), 5, 0.1, True, rank=0,
                world=1, device=torch.device("cpu"), t_start=time.time(),
                check_registry=False)
assert harness.forbidden_modules() == [], harness.forbidden_modules()
assert "repro_torch" in sys.modules
print("clean")
"""


def test_no_jax_or_reference_package():
    env = dict(os.environ)
    for var in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK"):
        env.pop(var, None)
    out = subprocess.run([sys.executable, "-c", PROBE, HERE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


def test_forbidden_names_compared_whole():
    sys.path.insert(0, os.path.join(HERE, ".."))
    from perfkit import harness

    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_lookalike"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.models"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
