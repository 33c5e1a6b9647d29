"""The port's copy of the analytic FLOP / HBM-byte / ICI-byte model
(``repro_torch.core.analytic``) against the reference's
(``repro.core.analytic``), for every architecture in the port's registry:
the per-token forward FLOPs, and the train, prefill and decode costs of
every assigned shape on a single device, a data-parallel mesh and a
data x model mesh, with and without ZeRO-3.  The copy is numpy only, so
the numbers are equal, not close."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import analytic as RA  # noqa: E402
from repro.launch.shapes import SHAPES as REF_SHAPES  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import analytic as PA  # noqa: E402

MESHES = [{"data": 1}, {"data": 8}, {"data": 16, "model": 8}]


def test_shapes_are_the_reference_shapes():
    assert PA.SHAPES == REF_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for S in (64, 4096):
            for decode in (False, True):
                assert PA._per_token_forward_flops(c, S, decode) == \
                    RA._per_token_forward_flops(jc, S, decode)
        for shape in PA.SHAPES:
            for mesh in MESHES:
                for fsdp in (False, True):
                    got = PA.shape_cost(c, shape, mesh, fsdp=fsdp)
                    want = RA.shape_cost(jc, shape, mesh, fsdp=fsdp)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (arch, shape, mesh, fsdp)
        for remat in (False, True):
            assert dataclasses.asdict(PA.train_cost(c, 8, 512, MESHES[2],
                                                    remat=remat)) == \
                dataclasses.asdict(RA.train_cost(jc, 8, 512, MESHES[2],
                                                 remat=remat))
