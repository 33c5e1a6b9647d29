"""Least-squares calibration of per-level ``(alpha, beta)`` from measured
collective timings (ROADMAP: "calibrate per-level alpha/beta from measured
traces").

Every collective cost model in :mod:`repro_torch.cluster.collectives` is, for a
fixed topology *structure* (degrees, straggler, contention), **positively
homogeneous of degree 1** in the vector of level betas (seconds/byte) and,
separately, in the vector of level alphas: the bandwidth coefficient is
``C = sum_l beta_l * wC_l`` and the latency term ``D = sum_l alpha_l *
wD_l``, where the weights depend only on the structure — except for the
flat ring, whose bottleneck selection makes ``C`` *piecewise* linear.  By
Euler's homogeneous-function theorem the exact per-level weights at a
reference point are the partial derivatives there, which we extract by
central finite differences.  A measured timing corpus

    t_i  =  sum_l beta_l * (wC_l[algo_i, kind_i] * nbytes_i)
          + sum_l alpha_l * wD_l[algo_i, kind_i]

is then an ordinary linear least-squares problem in ``(beta_l, alpha_l)``.
Because the ring's active bottleneck can move as the fit updates the betas,
:func:`fit_levels` re-extracts weights at the current iterate for a few
rounds (the fit is exact in one round when the bottleneck does not flip).

Levels no sample can see (zero weight in every row — e.g. degree-1 levels)
keep their datasheet values; fitted betas/alphas are clamped positive.

``samples_from_dryrun`` adapts the ``cluster`` block a
``repro.launch.dryrun`` JSON carries (per-algorithm AllReduce pricing, and
the RS/AG block when the compiled module contains reduce-scatter /
all-gather ops) into :class:`TimingSample` rows; with real-hardware
profiles the same entry point calibrates against measured wall times.

Import-light like the rest of ``repro_torch.cluster``: numpy is imported lazily
inside the solver so worker-pool interpreters never pay for it.
"""
from __future__ import annotations

import dataclasses
import json

from .collectives import KIND_AR, _comm_coeffs_uncached
from .topology import ClusterSpec, LinkLevel


@dataclasses.dataclass(frozen=True)
class TimingSample:
    """One measured collective: ``time_s`` seconds to move ``nbytes`` under
    ``algo`` / ``kind`` on the cluster being calibrated."""
    nbytes: float
    time_s: float
    algo: str = "ring"
    kind: str = KIND_AR


@dataclasses.dataclass
class FitResult:
    spec: ClusterSpec          # spec0 with fitted bandwidth/alpha per level
    betas: list[float]         # fitted seconds/byte (slowest link) per level
    alphas: list[float]        # fitted seconds/step per level
    rel_rmse: float            # relative RMS residual over the samples
    identifiable: list[bool]   # per level: did any sample constrain it?
    clamped: list[bool] = dataclasses.field(default_factory=list)
    # per level: the solver produced a non-physical (<= 0) beta, so the
    # datasheet value was kept — treat the level's fit as unreliable


def _with_params(spec: ClusterSpec, betas, alphas) -> ClusterSpec:
    """Clone ``spec`` with per-level beta/alpha replaced (structure —
    degrees, straggler, contention — preserved; beta = straggler/bw)."""
    levels = tuple(
        # keep the exact original level when nothing moved (the beta ->
        # bandwidth inversion would otherwise round datasheet constants)
        l if (b == l.beta and a == l.alpha)
        else dataclasses.replace(l, bandwidth=l.straggler / b, alpha=a)
        for l, b, a in zip(spec.levels, betas, alphas)
    )
    return ClusterSpec(spec.name, levels, compat_hw=spec.compat_hw)


def _weights(spec: ClusterSpec, algo: str, kind: str):
    """Per-level partial derivatives (wC, wD) of the (C, D) coefficients at
    ``spec``'s current betas/alphas, by central differences."""
    betas = [l.beta for l in spec.levels]
    alphas = [l.alpha for l in spec.levels]
    wC, wD = [], []
    for i in range(len(betas)):
        h = max(abs(betas[i]), 1e-15) * 1e-6
        bp = list(betas); bp[i] += h
        bm = list(betas); bm[i] = max(bm[i] - h, 1e-30)
        cp, _ = _comm_coeffs_uncached(_with_params(spec, bp, alphas), algo, kind)
        cm, _ = _comm_coeffs_uncached(_with_params(spec, bm, alphas), algo, kind)
        wC.append((cp - cm) / (bp[i] - bm[i]))
        h = max(abs(alphas[i]), 1e-15) * 1e-6
        ap = list(alphas); ap[i] += h
        am = list(alphas); am[i] = max(am[i] - h, 0.0)
        _, dp = _comm_coeffs_uncached(_with_params(spec, betas, ap), algo, kind)
        _, dm = _comm_coeffs_uncached(_with_params(spec, betas, am), algo, kind)
        wD.append((dp - dm) / (ap[i] - am[i]) if ap[i] > am[i] else 0.0)
    return wC, wD


def fit_levels(samples: list[TimingSample], spec0: ClusterSpec,
               iters: int = 3) -> FitResult:
    """Fit per-level ``(beta, alpha)`` to the timing corpus by iterated
    linear least squares (re-extracting weights at each iterate so the
    ring's piecewise bottleneck selection can settle)."""
    import numpy as np

    if not samples:
        raise ValueError("fit_levels needs at least one timing sample")
    if spec0.is_flat_compat:
        raise ValueError("cannot calibrate the flat back-compat shim; "
                         "build a real ClusterSpec first")
    spec = spec0
    nlev = len(spec.levels)
    identifiable = [False] * nlev
    clamped = [False] * nlev
    for _ in range(max(iters, 1)):
        wcache: dict[tuple[str, str], tuple] = {}
        rows, y = [], []
        for s in samples:
            key = (s.algo, s.kind)
            if key not in wcache:
                wcache[key] = _weights(spec, s.algo, s.kind)
            wC, wD = wcache[key]
            rows.append([w * s.nbytes for w in wC] + list(wD))
            y.append(s.time_s)
        A = np.asarray(rows, dtype=float)
        b = np.asarray(y, dtype=float)
        # column scaling for conditioning; zero columns (level invisible to
        # every sample) are pinned to the current spec value
        colmax = np.max(np.abs(A), axis=0)
        betas = [l.beta for l in spec.levels]
        alphas = [l.alpha for l in spec.levels]
        current = np.asarray(betas + alphas)
        seen = colmax > 0.0
        identifiable = [bool(seen[i] or seen[nlev + i]) for i in range(nlev)]
        if not seen.any():
            break
        scale = np.where(seen, colmax, 1.0)
        As = A[:, seen] / scale[seen]
        x, *_ = np.linalg.lstsq(As, b, rcond=None)
        fitted = current.copy()
        fitted[seen] = x / scale[seen]
        # a non-physical (<= 0) beta means the corpus does not actually
        # constrain the level (noise, collinearity): keep the datasheet
        # value and flag it rather than silently pricing the level as
        # ~infinite bandwidth
        clamped = [False] * nlev  # judged afresh at each iterate
        betas, alphas = [], []
        for i in range(nlev):
            if fitted[i] > 0.0:
                betas.append(float(fitted[i]))
            else:
                betas.append(spec.levels[i].beta)
                clamped[i] = identifiable[i]
            alphas.append(max(float(fitted[nlev + i]), 0.0))
        spec = _with_params(spec, betas, alphas)
    cd = {}
    for s in samples:
        key = (s.algo, s.kind)
        if key not in cd:
            cd[key] = _comm_coeffs_uncached(spec, s.algo, s.kind)
    pred = np.asarray([
        cd[(s.algo, s.kind)][0] * s.nbytes + cd[(s.algo, s.kind)][1]
        for s in samples
    ])
    meas = np.asarray([s.time_s for s in samples])
    denom = max(float(np.sqrt(np.mean(meas ** 2))), 1e-30)
    rel_rmse = float(np.sqrt(np.mean((pred - meas) ** 2))) / denom
    return FitResult(spec=spec,
                     betas=[l.beta for l in spec.levels],
                     alphas=[l.alpha for l in spec.levels],
                     rel_rmse=rel_rmse, identifiable=identifiable,
                     clamped=clamped)


# ------------------------------------------------ in-kernel overlap discount
# Overlap discount delta of the fused compute+comm kernel path (DESIGN.md
# Sec. 13): a fused bucket's collective may start ``delta x
# producer_duration`` before its producing compute job finishes, because the
# kernel streams gradient chunks onto the wire from inside the producing
# matmul's epilogue instead of waiting for the whole bucket.
#
# Per-preset values are calibrated by ``benchmarks/micro_overlap.py``: a
# single-parameter grid fit of the engine's early-ready pricing against a
# fine-grained per-chunk reference schedule (chunk k of K ready at
# ``start + (k+1)/K x duration``), over a sweep of bucket sizes and chunk
# counts.  Regenerate with ``python benchmarks/micro_overlap.py --fit``;
# ``--check`` asserts the stored table still matches a fresh fit.
DEFAULT_OVERLAP_DISCOUNT = 0.0  # uncalibrated topologies never discount

OVERLAP_DISCOUNTS: dict[str, float] = {
    # regenerated by benchmarks/micro_overlap.py --fit (do not hand-edit).
    # The engine's single-bucket pricing is scale-free, so every preset
    # currently fits the same value (see the benchmark's docstring); the
    # table stays per-preset keyed so measured-kernel truths can
    # differentiate later without an interface change.
    "tpu_v5e_pod_16": 0.525,
    "tpu_v5e_pod_64": 0.525,
    "tpu_v5e_pod_256": 0.525,
    "a100_nvlink_ib": 0.525,
    "h100_superpod": 0.525,
    "cross_dc_2pod": 0.525,
    "a100_straggler_ib": 0.525,
}


def overlap_discount_for(spec) -> float:
    """Calibrated overlap discount for a cluster spec (0.0 when the spec is
    None, flat back-compat, or not in the calibrated table — an
    uncalibrated discount would be a fictitious speedup, so fused buckets
    there price exactly as their base comm kind and ``METHOD_FUSED`` drops
    out of the search)."""
    if spec is None or getattr(spec, "is_flat_compat", False):
        return 0.0
    return float(OVERLAP_DISCOUNTS.get(getattr(spec, "name", None),
                                       DEFAULT_OVERLAP_DISCOUNT))


def fit_overlap_discount(reference, model, grid=None) -> tuple[float, float]:
    """Grid-fit the single overlap-discount parameter: pick the ``delta``
    whose modelled makespans best match the fine-grained reference schedule
    (relative RMS over the sample configs).  ``reference`` is a list of
    reference makespans, ``model`` a callable ``delta -> list of modelled
    makespans`` in the same order.  Returns ``(delta, rel_rmse)``."""
    if grid is None:
        grid = [i / 40.0 for i in range(40)]  # 0.000 .. 0.975
    best_d, best_err = 0.0, float("inf")
    for d in grid:
        pred = model(d)
        err = sum(((p - r) / r) ** 2
                  for p, r in zip(pred, reference) if r > 0.0)
        if err < best_err:
            best_d, best_err = float(d), err
    n = sum(1 for r in reference if r > 0.0)
    return best_d, (best_err / max(n, 1)) ** 0.5


# --------------------------------------------------------- dryrun adapters
def spec_from_describe(d: dict) -> ClusterSpec:
    """Rebuild a ClusterSpec from ``ClusterSpec.describe()`` output (the
    ``cluster.spec`` block of a dryrun JSON)."""
    levels = tuple(
        LinkLevel(l["name"], int(l["degree"]), l["bandwidth_gbps"] * 1e9,
                  l["alpha_us"] * 1e-6, straggler=l.get("straggler", 1.0),
                  contention=l.get("contention", 1.0))
        for l in d["levels"]
    )
    return ClusterSpec(d["name"], levels)


def samples_from_dryrun(doc: dict) -> tuple[list[TimingSample], ClusterSpec]:
    """Extract (samples, spec) from one ``repro.launch.dryrun`` result dict:
    per-algorithm AllReduce timings (mean collective size, per-collective
    time) plus the RS/AG pricing block when present."""
    cl = doc.get("cluster")
    if not cl:
        raise ValueError("dryrun JSON has no 'cluster' block")
    spec = spec_from_describe(cl["spec"])
    samples: list[TimingSample] = []
    count = max(int(cl.get("allreduce_count", 0)), 0)
    if count > 0:
        mean = cl["allreduce_bytes"] / count
        for algo, total in cl.get("allreduce_time_s", {}).items():
            samples.append(TimingSample(mean, total / count, algo, KIND_AR))
    for op, kind in (("reduce-scatter", "rs"), ("all-gather", "ag")):
        blk = (cl.get("rs_ag") or {}).get(op)
        if not blk or not blk.get("count"):
            continue
        mean = blk["bytes"] / blk["count"]
        for algo, total in blk.get("time_s", {}).items():
            samples.append(TimingSample(mean, total / blk["count"], algo, kind))
    return samples, spec


def fit_from_dryrun(paths: list[str], iters: int = 3) -> FitResult:
    """Calibrate one spec from a set of dryrun JSONs (all priced on the same
    topology): pool every timing sample and fit."""
    samples: list[TimingSample] = []
    spec = None
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        s, sp = samples_from_dryrun(doc)
        samples.extend(s)
        if spec is None:
            spec = sp
        elif sp.describe()["levels"] != spec.describe()["levels"]:
            raise ValueError(f"{p}: priced on a different topology than "
                             f"the first file")
    if spec is None:
        raise ValueError("no dryrun files given")
    return fit_levels(samples, spec, iters=iters)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="fit per-level (alpha, beta) from dryrun collective "
                    "timings")
    ap.add_argument("paths", nargs="+", help="dryrun JSON files")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    res = fit_from_dryrun(args.paths, iters=args.iters)
    print(json.dumps({
        "spec": res.spec.describe(),
        "rel_rmse": res.rel_rmse,
        "identifiable": res.identifiable,
    }, indent=1))


if __name__ == "__main__":
    main()
