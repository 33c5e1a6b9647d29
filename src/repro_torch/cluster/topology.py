"""Topology model: hierarchical cluster specs for collective cost modeling.

A :class:`ClusterSpec` describes the interconnect of a data-parallel cluster
as a tree of *link levels*, innermost (fastest, e.g. NVLink/ICI) to
outermost (slowest, e.g. IB/DCN).  Level ``l`` joins ``degree_l`` groups of
the levels below it, so ``n_devices = prod(degree_l)``.  Each level carries
an (alpha, beta) latency-bandwidth pair in the classic LogP/alpha-beta
sense, plus two heterogeneity knobs:

* ``straggler`` — slowest-link slowdown at this level (a flapping NIC, a
  cable running at half rate).  Synchronous collectives are gated by their
  slowest link, so it scales the bandwidth term of *every* algorithm that
  crosses the level.
* ``contention`` — penalty charged to traffic patterns that are not aligned
  with physical adjacency: recursive halving's distance-``2^k`` pairwise
  exchanges (link dilation on a torus axis, wide routes on an
  oversubscribed fat tree) and flat rings *spanning* the level from below.
  Rings confined to a single level, and hierarchical collectives' rail-
  aligned per-level rings, are exempt (the BlueConnect/Horovod-hierarchical
  argument).

The **back-compat shim**: :meth:`ClusterSpec.flat` maps the legacy
``(Hardware, n_devices)`` pair onto a one-level spec whose ring-AllReduce
cost is *bit-identical* to :func:`repro_torch.core.hw.allreduce_time` (the paper's
``T = C x + D`` linear model) — the PR-1 golden equivalence tests and every
default-constructed :class:`repro_torch.core.simulator.Simulator` see unchanged
numbers.  See DESIGN.md Sec. 7.

This module is intentionally torch-free and repro_torch.core-free at import
time so the search worker pool (spawned bare interpreters) can load it
cheaply.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LinkLevel:
    """One level of the interconnect hierarchy.

    ``bandwidth`` is the per-device (per-rail) bandwidth through this
    level's links in bytes/s; ``alpha`` is the per-communication-step
    latency of one exchange crossing the level, in seconds.
    """
    name: str
    degree: int               # groups of the level below joined at this level
    bandwidth: float          # bytes/s per device stream
    alpha: float              # seconds per communication step
    straggler: float = 1.0    # slowest-link slowdown (>= 1)
    contention: float = 1.0   # oversubscription penalty for unstructured traffic

    @property
    def beta(self) -> float:
        """Seconds/byte of the slowest link at this level."""
        return self.straggler / self.bandwidth

    def beta_contended(self) -> float:
        """Effective seconds/byte for traffic that fights the fabric
        (flat rings / halving-doubling spanning this level)."""
        return self.straggler * self.contention / self.bandwidth


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Hierarchical cluster description (levels ordered inner -> outer).

    ``compat_hw`` marks the back-compat shim: a flat one-level spec created
    from a legacy ``(Hardware, n_devices)`` pair, whose ring cost delegates
    to ``repro_torch.core.hw.allreduce_time`` for bit-identical results.
    """
    name: str
    levels: tuple[LinkLevel, ...]
    compat_hw: object | None = None   # repro_torch.core.hw.Hardware, duck-typed

    def __post_init__(self):
        if not self.levels:
            raise ValueError("ClusterSpec needs at least one link level")
        for l in self.levels:
            if l.degree < 1:
                raise ValueError(f"level {l.name}: degree must be >= 1")

    @property
    def n_devices(self) -> int:
        n = 1
        for l in self.levels:
            n *= l.degree
        return n

    @property
    def is_flat_compat(self) -> bool:
        return self.compat_hw is not None

    @staticmethod
    def flat(hw, n_devices: int) -> "ClusterSpec":
        """Legacy ``(hw, n_devices)`` -> one homogeneous link level.  Ring
        cost on this spec is bit-identical to ``hw.allreduce_time`` (the
        level's alpha stores the paper's fixed negotiation overhead D)."""
        lvl = LinkLevel("ici", max(int(n_devices), 1), hw.ici_bw,
                        hw.allreduce_latency)
        return ClusterSpec(f"flat_{hw.name}_{n_devices}", (lvl,),
                           compat_hw=hw)

    # ------------------------------------------------------------- helpers
    def group_sizes(self) -> list[int]:
        """Cumulative device counts below/at each level: N_0=1, N_l =
        N_{l-1} * degree_l."""
        sizes = [1]
        for l in self.levels:
            sizes.append(sizes[-1] * l.degree)
        return sizes

    def bottleneck_index(self) -> int:
        """Index of the level a flat collective is gated by (max contended
        beta over levels with fan-out, outermost wins ties — long-haul
        links dominate)."""
        cands = [i for i, l in enumerate(self.levels) if l.degree > 1]
        if not cands:
            return len(self.levels) - 1
        best = cands[0]
        for i in cands[1:]:
            if (self.levels[i].beta_contended()
                    >= self.levels[best].beta_contended()):
                best = i
        return best

    def bottleneck(self) -> LinkLevel:
        return self.levels[self.bottleneck_index()]

    def describe(self) -> dict:
        return {
            "name": self.name,
            "n_devices": self.n_devices,
            "flat_compat": self.is_flat_compat,
            "levels": [
                {
                    "name": l.name, "degree": l.degree,
                    "bandwidth_gbps": l.bandwidth / 1e9,
                    "alpha_us": l.alpha * 1e6,
                    "straggler": l.straggler,
                    "contention": l.contention,
                }
                for l in self.levels
            ],
        }


# ------------------------------------------------------------------ presets
def _torus_dilation(degree: int) -> float:
    """Mean link dilation of recursive halving's distance-2^k exchanges on a
    bidirectional ring axis — neighbour traffic has dilation 1, a
    distance-d/2 exchange occupies d/2 links."""
    if degree <= 2:
        return 1.0
    hops = []
    k = 1
    while k < degree:
        hops.append(min(k, degree - k))
        k *= 2
    return max(1.0, sum(hops) / len(hops))


def _tpu_ici(name: str, degree: int, bw: float = 50e9,
             alpha: float = 1e-6, **kw) -> LinkLevel:
    kw.setdefault("contention", _torus_dilation(degree))
    return LinkLevel(name, degree, bw, alpha, **kw)


def tpu_pod_levels(n_chips: int, bw: float = 50e9,
                   alpha: float = 1e-6) -> tuple[LinkLevel, ...]:
    """ICI levels of a v5e-style pod: a fast 16-wide inner ring axis and,
    past 16 chips, a slower outer axis.  Shared by the presets and the
    ``cluster_from_mesh`` bridge (single source for the ICI constants)."""
    inner = min(int(n_chips), 16)
    if inner < 1 or n_chips % inner:
        return (_tpu_ici("ici", max(int(n_chips), 1), bw, alpha),)
    levels = [_tpu_ici("ici_x", inner, bw, alpha)]
    outer = n_chips // inner
    if outer > 1:
        levels.append(_tpu_ici("ici_y", outer, bw=bw / 2, alpha=2 * alpha))
    return tuple(levels)


def dcn_level(pods: int, bandwidth: float = 6.25e9, alpha: float = 250e-6,
              contention: float = 4.0) -> LinkLevel:
    """Inter-pod data-center-network level (single source for the DCN
    constants, used by the preset zoo and ``cluster_from_mesh``)."""
    return LinkLevel("dcn", pods, bandwidth, alpha, contention=contention)


# A 2D/3D torus is not literally a tree; the hierarchy below approximates a
# pod as "fast inner ring axis x slower outer ring axis" — good enough for
# ranking fusion strategies (the per-axis bandwidth ratio is what matters).
PRESETS: dict[str, ClusterSpec] = {
    # single ICI ring axis: the paper's homogeneous setting, per-hop latency
    "tpu_v5e_pod_16": ClusterSpec("tpu_v5e_pod_16", tpu_pod_levels(16)),
    "tpu_v5e_pod_64": ClusterSpec("tpu_v5e_pod_64", tpu_pod_levels(64)),
    "tpu_v5e_pod_256": ClusterSpec("tpu_v5e_pod_256", tpu_pod_levels(256)),
    # 4 x DGX-A100: 8 GPUs on NVLink, hosts on HDR IB (2:1 oversubscribed
    # fat tree), one IB rail per GPU
    "a100_nvlink_ib": ClusterSpec(
        "a100_nvlink_ib",
        (LinkLevel("nvlink", 8, 300e9, 3e-6),
         LinkLevel("ib_hdr", 4, 25e9, 15e-6, contention=2.0))),
    # 16 x DGX-H100 SuperPOD slice: NVLink4 + NDR IB rail-optimised
    "h100_superpod": ClusterSpec(
        "h100_superpod",
        (LinkLevel("nvlink4", 8, 450e9, 2e-6),
         LinkLevel("ib_ndr", 16, 50e9, 10e-6, contention=1.5))),
    # two TPU pods joined over the data-center network
    "cross_dc_2pod": ClusterSpec(
        "cross_dc_2pod", tpu_pod_levels(256) + (dcn_level(2),)),
    # heterogeneous variant: one flapping IB link running at 1/8 rate drags
    # every synchronous collective that crosses the inter-host level
    "a100_straggler_ib": ClusterSpec(
        "a100_straggler_ib",
        (LinkLevel("nvlink", 8, 300e9, 3e-6),
         LinkLevel("ib_hdr", 4, 25e9, 15e-6, straggler=8.0,
                   contention=2.0))),
}


def get_preset(name: str) -> ClusterSpec:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown cluster preset {name!r}; available: "
            f"{', '.join(sorted(PRESETS))}") from None


def list_presets() -> list[str]:
    return sorted(PRESETS)
