"""Topology-aware cluster & collective-algorithm modeling (port of
``repro/cluster``, DESIGN.md Sec. 7).

``ClusterSpec`` describes hierarchical, heterogeneous interconnects;
``collectives`` prices ring / recursive-halving-doubling / hierarchical
AllReduce on them.  ``repro_torch.core`` threads a spec through the cost
substrate and the backtracking search so the collective algorithm is a
*searched* dimension alongside op and tensor fusion.

Import-light on purpose: no torch, no repro_torch.core at module load (the
search worker pool spawns bare interpreters that must import this cheaply).
The reference's ``from_mesh`` bridge (``repro/launch/mesh.py``) is not
ported.
"""
from .topology import (ClusterSpec, LinkLevel, PRESETS, dcn_level,
                       get_preset, list_presets, tpu_pod_levels)
from .collectives import (ALGO_HIER, ALGO_RING, ALGO_TREE, ALGORITHMS,
                          BUCKET_COMM_KINDS, COLLECTIVE_ALGOS, CommPhase,
                          DEFAULT_ALGO, DEFAULT_COMM_KIND, KIND_AG, KIND_AR,
                          KIND_FUSED, KIND_P2P, KIND_RS, KIND_RS_AG,
                          allreduce_coeffs, best_algo, bucket_time,
                          chunk_phases, comm_coeffs, comm_time, fused_phases,
                          hier_allreduce, level_chunk_phases, phases,
                          ring_allreduce, tree_allreduce)
from .calibrate import (DEFAULT_OVERLAP_DISCOUNT, OVERLAP_DISCOUNTS,
                        overlap_discount_for)

__all__ = [
    "ClusterSpec", "LinkLevel", "PRESETS", "dcn_level", "get_preset",
    "list_presets", "tpu_pod_levels",
    "ALGO_HIER", "ALGO_RING", "ALGO_TREE", "ALGORITHMS", "COLLECTIVE_ALGOS",
    "BUCKET_COMM_KINDS", "CommPhase", "DEFAULT_ALGO", "DEFAULT_COMM_KIND",
    "KIND_AG", "KIND_AR", "KIND_FUSED", "KIND_P2P", "KIND_RS", "KIND_RS_AG",
    "allreduce_coeffs", "best_algo", "bucket_time", "chunk_phases",
    "comm_coeffs", "comm_time", "fused_phases", "hier_allreduce",
    "level_chunk_phases", "phases", "ring_allreduce", "tree_allreduce",
    "DEFAULT_OVERLAP_DISCOUNT", "OVERLAP_DISCOUNTS", "overlap_discount_for",
]
