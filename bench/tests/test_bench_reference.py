"""The plain reference against the port's own step, on small copies of
both configurations on the CPU: in f32 the two agree to rounding, on one
rank and on two gloo ranks (each routing its own rows); the control (the
reference at float8 matmuls) and each fault planted in the program come
out not correct."""
import multiprocessing as mp
import os
import socket
import time

import pytest
import torch

import bench_tiny
from perfkit import compare, harness

CPU = torch.device("cpu")
# a small cell's own limits, set as a real cell's are: above the bf16
# program's readings on these sizes, below the control's
TINY_LIMITS = {"loss_gap": 5e-4, "grad_gap": 2e-2, "change_gap": 1.5e-2,
               "rank_spread": 0.0}


@pytest.fixture(autouse=True)
def _plans(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE", tmp_path)
    for var in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)


def _run(w, seed=7, faults=()):
    return harness.run(w, seed, 0.2, False, rank=0, world=1, device=CPU,
                       t_start=time.time(), faults=faults,
                       check_registry=False)


@pytest.mark.parametrize("name", bench_tiny.CONFIGS)
def test_f32_program_equals_reference(name):
    out = _run(bench_tiny.cell(name, limits={"loss_gap": 1e-6,
                                             "grad_gap": 1e-5,
                                             "change_gap": 1e-4}))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", bench_tiny.CONFIGS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "loss_altered"])
def test_planted_fault_is_not_correct(name, fault):
    w = bench_tiny.cell(name, "bfloat16", limits=TINY_LIMITS)
    assert _run(w)["correct"]
    assert not _run(w, faults=(fault,))["correct"]


@pytest.mark.parametrize("name", bench_tiny.CONFIGS)
def test_control_is_not_correct(name):
    w = bench_tiny.cell(name, "bfloat16")
    cell = harness.Cell(w, rank=0, world=1, device=CPU,
                        check_registry=False)
    try:
        for seed in (1, 2, 3):
            ref = cell.reference(seed)
            ok, _ = compare.judge(compare.numbers(cell.reference(seed, "fp8"),
                                                  ref), TINY_LIMITS)
            assert not ok
    finally:
        cell.close()


def _rank(rank, world, port, name, faults, cache, q):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    harness.CACHE = cache
    w = bench_tiny.cell(name, chips=world, limits={
        "loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-4,
        "rank_spread": 0.0})
    out = harness.run(w, 11, 0.2, False, rank=rank, world=world, device=CPU,
                      t_start=time.time(), faults=faults,
                      check_registry=False)
    if rank == 0:
        q.put((out["correct"], out["checks"]))


def _two_ranks(name, faults, cache):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, name, faults,
                                             cache, q)) for r in range(2)]
    for p in procs:
        p.start()
    got = q.get(timeout=300)
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    return got


@pytest.mark.parametrize("name", bench_tiny.CONFIGS)
def test_two_gloo_ranks_equal_reference(name, tmp_path):
    ok, checks = _two_ranks(name, (), tmp_path)
    assert ok, checks
    assert checks["rank_spread"]["value"] == 0.0


def test_exchange_left_out_is_not_correct(tmp_path):
    ok, checks = _two_ranks("deepseek-v2-lite-16b.l4", ("no_exchange",),
                            tmp_path)
    assert not ok
    assert checks["rank_spread"]["value"] > 0
