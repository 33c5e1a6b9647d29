"""Dry-run sweep: every (arch x shape x mesh) of
:func:`repro_torch.launch.dryrun.dryrun_one` in a subprocess of its own, with
retries and a timeout (port of ``repro/launch/sweep.py``).  A combination
that fails is retried, then written as an error record, and the sweep exits
1 at its end.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --arch tinyllama-1.1b,rwkv6-3b --shape decode_32k --meshes single
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..configs import ARCHS
from .shapes import SHAPES

# the directory that holds the repro_torch package, for the subprocesses
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_one(arch: str, shape: str, multi_pod: bool, out: str,
            retries: int = 2, timeout: int = 1800) -> dict:
    """Dry-run one combination in a fresh process, up to ``retries`` more
    times after a failure; writes and returns its result, or an error
    record holding the last failure's end of standard error."""
    tag = f"{arch}__{shape}__{_mesh_tag(multi_pod)}"
    path = os.path.join(out, tag + ".json")
    code = (
        "import json\n"
        "from repro_torch.launch.dryrun import dryrun_one\n"
        f"r = dryrun_one({arch!r}, {shape!r}, {multi_pod!r})\n"
        f"json.dump(r, open({path!r}, 'w'), indent=1, default=str)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if os.path.exists(path):
        os.remove(path)
    last_err = ""
    for attempt in range(retries + 1):
        t0 = time.time()
        try:
            proc = subprocess.run([sys.executable, "-c", code], env=env,
                                  capture_output=True, text=True,
                                  timeout=timeout)
            rc, err = proc.returncode, proc.stderr or ""
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            err = (e.stderr.decode() if isinstance(e.stderr, bytes)
                   else e.stderr or "") + f"\ntimed out after {timeout} s"
        if rc == 0 and os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
            res["attempts"] = attempt + 1
            res["host_s"] = round(time.time() - t0, 2)
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
            return res
        last_err = err[-2000:]
        print(f"  retry {attempt + 1} for {tag} (rc={rc}, "
              f"{time.time() - t0:.0f}s)", flush=True)
    res = {"arch": arch, "shape": shape, "mesh": _mesh_tag(multi_pod),
           "error": last_err}
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--meshes", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.meshes]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{_mesh_tag(mp)}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if "error" not in json.load(f):
                            print(f"  skip {tag} (exists)")
                            continue
                res = run_one(arch, shape, mp, args.out)
                if "error" in res:
                    failures.append(tag)
                    print(f"FAIL {tag}", flush=True)
                elif not res.get("applicable", True):
                    print(f"  {tag}: SKIP ({res['reason'][:60]})",
                          flush=True)
                else:
                    print(f"  {tag}: OK fake step {res.get('fake_step_s')}s "
                          f"flops {res.get('flops'):.3e}", flush=True)
    print(f"sweep done in {(time.time() - t0) / 60:.1f} min; "
          f"{len(failures)} failures")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
