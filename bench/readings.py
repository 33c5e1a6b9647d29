"""Readings for setting a cell's correctness limits (not run by the
benchmark's own runs).

    python3 bench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control 3] [--faults half_batch,no_exchange] [--out file.jsonl]

For each seed, on the cell's own sizes: the program's checked steps and the
plain reference's, and the numbers ``correct`` compares.  On the first
``--control`` seeds also the control (the reference at float8 matmuls in
the program's place) and each fault planted in the program (``unchanged``,
``half_batch``, ``no_exchange``, ``loss_altered``), each held to the same
reference.  One JSON line a reading, on standard output and in ``--out``.
Needs the cell's CUDA devices, as ``bench/run.py`` does; ``--device cpu``
runs one rank on the host (small configurations only)."""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from perfkit import compare, harness, manifest  # noqa: E402


def readings(cell, seeds, control: int, faults, emit) -> None:
    for k, seed in enumerate(seeds):
        t0 = time.time()
        params, state, prog, _ = cell.checked(seed)
        del params, state
        cell.free()
        t1 = time.time()
        ref = cell.reference(seed)
        cell.free()
        t2 = time.time()
        emit({"seed": seed, "side": "program",
              "numbers": compare.numbers(prog, ref), "program": prog,
              "reference": ref, "program_s": t1 - t0, "reference_s": t2 - t1})
        if k >= control:
            continue
        ctl = cell.reference(seed, "fp8")
        cell.free()
        emit({"seed": seed, "side": "control",
              "numbers": compare.numbers(ctl, ref), "control": ctl,
              "control_s": time.time() - t2})
        for f in faults:
            params, state, got, _ = cell.checked(seed, (f,))
            del params, state
            cell.free()
            emit({"seed": seed, "side": f"fault:{f}",
                  "numbers": compare.numbers(got, ref)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    harness.cache_env()
    w = manifest.cell(args.workload)
    import torch

    chips = w["chips"] if args.device == "cuda" else 1
    if args.device == "cuda" and torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA devices", file=sys.stderr)
        return 3
    rank, kids = args.rank or 0, []
    if chips > 1 and args.rank is None:
        kids = harness._start_ranks(sys.argv[1:] if argv is None else argv,
                                    chips, script=__file__)
        harness._watch(kids)
    elif args.rank is not None:
        harness._orphan_guard()
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    faults = [f for f in args.faults.split(",") if f]
    unknown = set(faults) - set(harness.FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    out = open(args.out, "a") if args.out and rank == 0 else None

    def emit(rec):
        if rank == 0:
            rec = dict(rec, workload=args.workload)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

    cell = harness.Cell(w, rank=rank, world=chips, device=device)
    try:
        readings(cell, [int(s) for s in args.seeds.split(",")], args.control,
                 faults, emit)
    finally:
        cell.close()
        for k in kids:
            k.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
