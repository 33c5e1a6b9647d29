"""Cost substrate: per-op and fused-op execution-time oracles (port of
``repro/core/costs.py``).

Two roles (paper Sec. 4.2):

* **Profiler** — standalone time of every original op: an analytic
  roofline of the :class:`~repro_torch.core.hw.Hardware` it is given, by
  default the H100 (``H100_SXM``) the port runs on.
* **Fused-op ground truth** — the detailed oracle used as the simulator's
  default estimator.  It includes the non-linear "hardware texture" the
  paper argues makes fused op time hard to predict analytically from *op
  lists alone*: tile-alignment padding, on-chip working-set spill,
  overhead amortisation, and a saturation term for deep elementwise chains.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

from ..cluster import ClusterSpec, comm_time
from .graph import DOT, EW, FusionGraph, LAYOUT, OPAQUE, PrimOp, REDUCE
from .hw import H100_SXM, Hardware


# --------------------------------------------------------------------- prims
def prim_time(p: PrimOp, hw: Hardware = H100_SXM) -> float:
    """Standalone execution time of one primitive (the Profiler's output)."""
    bytes_total = p.in_bytes + p.out_bytes
    flops_t = p.flops / (hw.peak_flops * hw.efficiency)
    mem_t = bytes_total / hw.hbm_bw
    if p.category == OPAQUE:
        # opaque ops (scan/sort/custom) run at a discount to peak
        flops_t *= 2.0
    return max(flops_t, mem_t) + hw.launch_overhead


def profile_graph(g: FusionGraph, hw: Hardware = H100_SXM) -> FusionGraph:
    """Fill in ``time`` for every prim (returns a new graph sharing edges)."""
    prims = [
        PrimOp(
            pid=p.pid,
            op_type=p.op_type,
            category=p.category,
            flops=p.flops,
            in_bytes=p.in_bytes,
            out_bytes=p.out_bytes,
            time=prim_time(p, hw),
            grad_param=p.grad_param,
            grad_bytes=p.grad_bytes,
            grad_sig=p.grad_sig,
        )
        for p in g.prims
    ]
    return FusionGraph._from_parts(
        prims, g.psuccs, g.ppreds, g.groups, g.provider, g._next_gid,
        g.grad_prim, g.buckets, bucket_algos=g.bucket_algos,
        bucket_comm=g.bucket_comm, bucket_chunks=g.bucket_chunks,
    )


# ----------------------------------------------------------------- fused ops
def _align_penalty(p: PrimOp, hw: Hardware) -> float:
    """Deterministic MXU-padding texture: dots whose FLOP volume is not a
    multiple of a full MXU tile pass waste cycles on padding."""
    if p.category != DOT or p.flops <= 0:
        return 1.0
    tile_flops = 2.0 * hw.mxu_dim**3
    waste = (-p.flops) % tile_flops
    return 1.0 + 0.35 * (waste / tile_flops) * min(1.0, tile_flops / max(p.flops, 1.0) * 8)


def fused_time_oracle(
    members: Sequence[PrimOp],
    external_in_bytes: float,
    external_out_bytes: float,
    hw: Hardware = H100_SXM,
    n_internal_edges: int = 0,
) -> float:
    """Detailed fused-op execution time (tier-A ground truth).

    flops: all member flops (duplicate-fused copies included by the caller).
    bytes: only the group's external traffic — fusion's memory saving.
    """
    flops = sum(p.flops * _align_penalty(p, hw) for p in members)
    bytes_total = external_in_bytes + external_out_bytes
    flops_t = flops / (hw.peak_flops * hw.efficiency)
    mem_t = bytes_total / hw.hbm_bw
    # VMEM working-set spill: intermediates elided from HBM must live in
    # VMEM; once the aggregate working set exceeds VMEM the compiler spills
    # them back to HBM (round trip).
    internal_bytes = max(sum(p.out_bytes for p in members) - external_out_bytes, 0.0)
    ws = max((p.out_bytes for p in members), default=0.0) + internal_bytes
    spill = max(0.0, ws - hw.vmem_bytes) * 2.0 / hw.hbm_bw
    # deep fused loop nests lose ILP/pipelining: superlinear in member count
    n = len(members)
    chain_penalty = 1.0 + 0.03 * math.log1p(max(n - 8, 0))
    # single dispatch for the whole fused op
    return max(flops_t, mem_t) * chain_penalty + spill + hw.launch_overhead


def group_time_oracle(g: FusionGraph, gid: int, hw: Hardware = H100_SXM) -> float:
    members = [g.prims[p] for p in g.groups[gid]]
    if len(members) == 1 and members[0].category == OPAQUE:
        return members[0].time if members[0].time > 0 else prim_time(members[0], hw)
    in_b, out_b = g.group_external_io(gid)
    return fused_time_oracle(members, in_b, out_b, hw)


class OracleEstimator:
    """Estimator interface backed by the analytic oracle (with memoisation).

    The GNN estimator in :mod:`repro_torch.core.gnn` exposes the same interface.
    """

    def __init__(self, hw: Hardware = H100_SXM):
        self.hw = hw
        self._cache: dict = {}

    def group_time(self, g: FusionGraph, gid: int) -> float:
        # The fused time depends on (a) the member set, (b) which members
        # this group provides (external-output accounting), and (c) the prim
        # lineage — the same pids carry different flops/bytes across traced /
        # re-profiled graphs, so the family token keeps one shared estimator
        # from returning stale times across graphs.
        key = (g.family_token(), g.groups[gid], g.provided_set(gid))
        t = self._cache.get(key)
        if t is None:
            t = group_time_oracle(g, gid, self.hw)
            self._cache[key] = t
        return t


def total_compute_time(g: FusionGraph, estimator, hw: Hardware = H100_SXM) -> float:
    return sum(estimator.group_time(g, gid) for gid in g.groups)


def total_comm_time(g: FusionGraph, hw: Hardware = H100_SXM,
                    n_devices: int = 256,
                    cluster: ClusterSpec | None = None) -> float:
    """Busy time of the communication channel: each bucket priced by its
    chosen collective algorithm and comm kind (AllReduce or ZeRO-3 RS+AG)
    on ``cluster`` (a legacy ``(hw, n_devices)`` call maps to the flat
    back-compat spec — bit-identical to the seed's per-bucket
    ``allreduce_time`` sum).  Empty/zero-byte buckets transfer nothing and
    are skipped (no fixed latency D charged)."""
    if cluster is None:
        cluster = ClusterSpec.flat(hw, n_devices)
    total = 0.0
    for i, b in enumerate(g.buckets):
        nb = g.bucket_bytes(b)
        if nb <= 0.0:
            continue
        total += comm_time(nb, cluster, g.bucket_algos[i], g.bucket_comm[i])
    return total
