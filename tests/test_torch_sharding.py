"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), exactly: every leaf's
spec of every architecture at full size, on ``("data", "model")`` meshes
with model dims of 1, 2 and 16 and on the ``("pod", "data", "model")``
production mesh, with fsdp on and off; the head alignment, the batch spec
and the ZeRO-1 rule.  The reference's shapes come from ``jax.eval_shape``
and its specs from its own ``param_shardings`` on an ``AbstractMesh``; the
port's shapes come from its meta-tensor tree, where the port has the
architecture (the VLM prefix and the encoder-decoder, ROADMAP A6, are
taken at the reference's shapes)."""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

ALL_ARCHS = JC.ARCHS + JC.EXTRA_ARCHS   # with transformer-paper: 11
MESHES = {"model1": {"data": 16, "model": 1},
          "model2": {"data": 16, "model": 2},
          "model16": {"data": 16, "model": 16},
          "pod": {"pod": 2, "data": 16, "model": 16}}


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference config, reference ShapeDtypeStruct tree, the port's
    config and tree: meta tensors where the port has the architecture,
    else the reference's shapes)."""
    jcfg = JC.get_config(arch)
    jtree = jax.eval_shape(lambda: JST.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    if arch not in ARCHS:
        return jcfg, jtree, jcfg, jtree
    cfg = get_config(arch)
    with torch.device("meta"):
        own = ST.init_params(cfg, device="meta")
    return jcfg, jtree, cfg, own


def _ref_specs(tree, shardings) -> list:
    return [tuple(s.spec) for s in jax.tree.leaves(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))]


@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_reference(arch, mesh, fsdp):
    jcfg, jtree, cfg, own = _trees(arch)
    shape = MESHES[mesh]
    assert [(p, tuple(l.shape)) for p, l in T.leaves_with_paths(own)] == \
        [(jax.tree_util.keystr(p), tuple(l.shape))
         for p, l in jax.tree_util.tree_leaves_with_path(jtree)]
    want = _ref_specs(jtree, JSH.param_shardings(jtree, _abstract(shape),
                                                 fsdp=fsdp, cfg=jcfg))
    got = SH.param_specs(own, shape, fsdp=fsdp, cfg=cfg)
    assert got == want
    # one leaf at a time, as a caller without a tree asks
    kw = dict(model_size=shape["model"], dp_axes=SH.dp_axes_of(shape),
              fsdp=fsdp, dp_size=SH.dp_size_of(shape),
              **SH.head_alignment(cfg, shape))
    assert [SH.param_spec(p, l.shape, **kw)
            for p, l in T.leaves_with_paths(own)] == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_zero1_specs_equal_reference(arch, mesh):
    """ZeRO-1: each moment's spec is its parameter's with the largest free
    dim that the data dims divide sharded over them."""
    jcfg, jtree, cfg, own = _trees(arch)
    shape = MESHES[mesh]
    am = _abstract(shape)
    pshard = JSH.param_shardings(jtree, am, cfg=jcfg)
    want = _ref_specs(jtree, JSH.zero1_shardings(jtree, am, pshard))
    specs = SH.param_specs(own, shape, cfg=cfg)
    got = [SH.zero1_spec(l.shape, s, shape)
           for l, s in zip(T.leaves(own), specs)]
    assert got == want


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_head_alignment_equals_reference(arch):
    jcfg, _, cfg, _ = _trees(arch)
    for m in (1, 2, 3, 4, 8, 16):
        shape = {"data": 2, "model": m}
        assert SH.head_alignment(cfg, shape) == \
            JSH.head_alignment(jcfg, _abstract(shape))
    assert SH.head_alignment(None, {"model": 16}) == \
        {"q_aligned": True, "kv_aligned": True}


def test_batch_pspec_equals_reference():
    for shape in MESHES.values():
        for b in (1, 8, 16, 32, 256, 100):
            for ndim in (1, 2, 3):
                assert SH.batch_pspec(b, shape, ndim) == tuple(
                    JSH.batch_pspec(b, _abstract(shape), ndim))
    assert SH.batch_pspec(8, {"model": 4}, 2) == (None, None)


def test_path_names_read_keypaths_as_the_reference():
    params = {"groups": [{"attn": {"wq": np.zeros((2, 4, 4))}}],
              "embed": np.zeros((8, 4))}
    for (path, _), (jpath, _) in zip(
            T.leaves_with_paths(params),
            jax.tree_util.tree_leaves_with_path(params)):
        assert SH.path_names(path) == JSH._path_names(jpath)
    assert SH.path_names(".mu['groups'][0]['ln1']['scale']") == \
        ["groups", "0", "ln1", "scale"]
