"""Time the ``qmatmul`` / ``qmatmul_packed`` kernels of two checkouts on
one card, in turns (old, new, new, old): ``chip_smoke.py``'s phase 1c
(its correctness checks and its timed cases) from each tree, each run in
a process of its own that builds that tree's kernels.

    git archive <commit> | tar -x -C build/old     # the older tree
    python3 src/repro_torch/launch/qmatmul_old_new.py --old build/old \\
        --new . [--out build/old_new.json]

Run it by path, not with ``-m``: each child imports ``chip_smoke`` and
``repro_torch`` from its own tree.  It prints each run's timed cases
(kernel, plain and ``torch.matmul`` ms, the bound, max |err|), then one
line per case with the old and new times of every run, and the card's
name and power limit.  It fails if either tree's phase 1c fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MARK = "OLD_NEW_RESULT "
ORDER = ("old", "new", "new", "old")


def _child(tree: pathlib.Path) -> None:
    """Phase 1c of ``tree``'s chip_smoke.py; one result line."""
    sys.path.insert(0, str(tree))
    import chip_smoke   # inserts tree/src on sys.path
    from repro_torch.core.device_model import detect_backend_model
    from repro_torch.kernels import _build
    assert pathlib.Path(chip_smoke.__file__).resolve().parent == tree
    _build.build_all(["qmatmul"])
    model = detect_backend_model()
    entries = chip_smoke.phase1c_qmatmul(model.hbm.bandwidth_Bps,
                                         model.peak_flops["bfloat16"])
    keep = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    print(MARK + json.dumps([{k: e[k] for k in keep} for e in entries]),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=pathlib.Path, required=True)
    ap.add_argument("--new", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(args.child.resolve())
        return 0
    trees = {"old": args.old.resolve(), "new": args.new.resolve()}
    runs = []
    for label in ORDER:
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--old", str(trees["old"]), "--new", str(trees["new"]),
             "--child", str(trees[label])],
            capture_output=True, text=True, cwd=trees[label])
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{label} ({trees[label]}): phase 1c failed, "
                             f"exit {proc.returncode}")
        result = [line for line in proc.stdout.splitlines()
                  if line.startswith(MARK)][-1]
        runs.append((label, json.loads(result[len(MARK):])))
    print("\ncase: ms per run in order " + ", ".join(ORDER)
          + "; plain, torch.matmul and bound from the new tree's first run")
    first_new = next(r for label, r in runs if label == "new")
    for i, e in enumerate(first_new):
        times = ", ".join(f"{label} {r[i]['ms']:.4f}" for label, r in runs)
        print(f"{e['name']}: {times}; plain {e['plain_ms']:.4f}, "
              f"torch.matmul {e['library_ms']:.4f}, bound "
              f"{e['bound_ms']:.4f} ({e['bound_by']}), max |err| "
              f"{e['max_abs_err']:.3e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"order": ORDER, "card": smi,
                                        "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
