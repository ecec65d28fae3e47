"""Time the kernels of two checkouts on one card, in turns (old, new,
new, old): the named phases of ``chip_smoke.py`` (their correctness
checks and their timed cases) from each tree, each run in a process of
its own that builds that tree's kernels.

    git archive <commit> | tar -x -C build/old     # the older tree
    python3 src/repro_torch/launch/old_new.py 1 1b --old build/old \\
        --new . [--out build/old_new.json]

Phases: ``1`` (``flash_decode``), ``1b`` (``flash_decode_quant``), ``1c``
(``qmatmul`` / ``qmatmul_packed``).  Run it by path, not with ``-m``:
each child imports ``chip_smoke`` and ``repro_torch`` from its own tree.
It prints each run's timed cases (kernel, plain and PyTorch-call ms, the
bound, max |err|), then one line per case with the times of every run
(a case one tree does not time shows "-"), and the card's name and power
limit.  It fails if a phase fails in either tree.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MARK = "OLD_NEW_RESULT "
ORDER = ("old", "new", "new", "old")
# phase -> (chip_smoke function, kernel sources it builds)
PHASES = {"1": ("phase1_flash_decode", ("flash_decode",)),
          "1b": ("phase1b_flash_decode_quant", ("flash_decode_quant",)),
          "1c": ("phase1c_qmatmul", ("qmatmul",))}
KEEP = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err")


def _child(tree: pathlib.Path, phases) -> None:
    """The phases of ``tree``'s chip_smoke.py; one result line."""
    sys.path.insert(0, str(tree))
    import chip_smoke   # inserts tree/src on sys.path
    from repro_torch.core.device_model import detect_backend_model
    from repro_torch.kernels import _build
    assert pathlib.Path(chip_smoke.__file__).resolve().parent == tree
    _build.build_all([src for p in phases for src in PHASES[p][1]])
    model = detect_backend_model()
    entries = []
    for p in phases:
        out = getattr(chip_smoke, PHASES[p][0])(
            model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"])
        entries += out if isinstance(out, list) else [out]
    print(MARK + json.dumps([{k: e[k] for k in KEEP} for e in entries]),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES))
    ap.add_argument("--old", type=pathlib.Path, required=True)
    ap.add_argument("--new", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(args.child.resolve(), args.phases)
        return 0
    trees = {"old": args.old.resolve(), "new": args.new.resolve()}
    runs = []
    for label in ORDER:
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             *args.phases, "--old", str(trees["old"]), "--new",
             str(trees["new"]), "--child", str(trees[label])],
            capture_output=True, text=True, cwd=trees[label])
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{label} ({trees[label]}): phases "
                             f"{' '.join(args.phases)} failed, exit "
                             f"{proc.returncode}")
        result = [line for line in proc.stdout.splitlines()
                  if line.startswith(MARK)][-1]
        runs.append((label, {e["name"]: e
                             for e in json.loads(result[len(MARK):])}))
    print("\ncase: ms per run in order " + ", ".join(ORDER)
          + "; plain, PyTorch call and bound from the new tree's first run")
    first_new = next(r for label, r in runs if label == "new")
    for name, e in first_new.items():
        times = ", ".join(
            f"{label} {r[name]['ms']:.4f}" if name in r else f"{label} -"
            for label, r in runs)
        lib = ("-" if e["library_ms"] is None
               else f"{e['library_ms']:.4f}")
        print(f"{name}: {times}; plain {e['plain_ms']:.4f}, PyTorch call "
              f"{lib}, bound {e['bound_ms']:.4f} ({e['bound_by']}), max "
              f"|err| {e['max_abs_err']:.3e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"order": ORDER, "card": smi,
                                        "phases": args.phases,
                                        "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
