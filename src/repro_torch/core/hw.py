"""Hardware model constants for the cost substrate (port of
``repro/core/hw.py``).

``Hardware`` and ``TPU_V5E`` are the reference's; ``H100_SXM`` prices the
card the port runs on and is every default ``hw=`` of the port's cost
substrate, simulator, facade and tracer.  The constants drive the analytic
roofline the simulator prices fused ops with.  All values are per chip.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s HBM
    ici_bw: float = 50e9              # bytes/s per ICI link
    vmem_bytes: float = 128 * 2**20   # VMEM capacity
    # Per-dispatched-op overhead.  On GPU this is the kernel-launch cost the
    # paper's op fusion amortises (~5 us); XLA:TPU dispatch is cheaper but
    # non-zero.  Kept configurable — see DESIGN.md "Hardware adaptation".
    launch_overhead: float = 1.5e-6
    # Fixed AllReduce negotiation/synchronisation overhead (the ``D`` of the
    # paper's linear model T = C x + D, Sec. 4.2).
    allreduce_latency: float = 10e-6
    # MXU tile edge — matmul dims are padded up to multiples of this.
    mxu_dim: int = 128
    # Fraction of peak achievable by well-tiled kernels (compiler inefficiency).
    efficiency: float = 0.85


TPU_V5E = Hardware()

# NVIDIA H100 SXM: dense bf16 tensor-core peak, HBM3 rate, NVLink4 per
# direction (the ``h100_superpod`` preset's first level), the 50 MiB L2 as
# the on-chip working set past which a fused op spills, a wgmma's M as the
# tile edge, and the GPU launch cost of the comment above.  The AllReduce
# latency and the efficiency are the reference's until they are fitted on
# the card.
H100_SXM = Hardware(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    vmem_bytes=50 * 2**20,
    launch_overhead=5e-6,
    mxu_dim=64,
)


def ring_allreduce_coeffs(hw: Hardware, n_devices: int) -> tuple[float, float]:
    """Linear AllReduce model T = C*x + D (paper Sec. 4.2, Parallax formula).

    C = 2(N-1)/(N*B) for a full-duplex ring over the slowest link B.

    This single-link model is the *flat* special case: hierarchical,
    heterogeneous interconnects and alternative collective algorithms live
    in :mod:`repro_torch.cluster` (DESIGN.md Sec. 7), whose flat back-compat spec
    reproduces this formula bit-for-bit.
    """
    if n_devices <= 1:
        return 0.0, 0.0
    c = 2.0 * (n_devices - 1) / (n_devices * hw.ici_bw)
    return c, hw.allreduce_latency


def allreduce_time(nbytes: float, hw: Hardware, n_devices: int) -> float:
    c, d = ring_allreduce_coeffs(hw, n_devices)
    return c * nbytes + d
