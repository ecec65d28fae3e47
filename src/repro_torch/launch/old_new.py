"""Time the kernels of two checkouts on one card, in turns (old, new,
new, old): the named phases of ``chip_smoke.py`` (their correctness
checks and their timed cases) from each tree, each run in a process of
its own that builds that tree's kernels.

    git archive <commit> | tar -x -C build/old     # the older tree
    python3 src/repro_torch/launch/old_new.py 1 1b --old build/old \\
        --new . [--out build/old_new.json]

Phases: ``1`` (``flash_decode``), ``1b`` (``flash_decode_quant``), ``1c``
(``qmatmul`` / ``qmatmul_packed``), ``1d`` (the probe kernels; with it,
the Fig 4/5 sweep: ``mma_products`` in bf16 at 128^3 over batch 1, 2,
4, 8, 16, 32 x ilp 1, 2, 4, 6, 8, the kernel's device time and TFLOP/s
at each point), ``1e`` (``ssd_scan``: its cases, then (a) the serving
call and (b) bt 8 x s 2048 timed), ``1f`` (``flash_attention``), ``1h``
(``flash_attention_bwd``, each tree's backward with its own forward and
signature), ``1i`` (``ssd_scan_bwd``: its cases, (a)-(f) timed; a tree
without the phase fails it).  Phases 1-1c take the HBM rate and the
bf16 peak, 1d-1i the device model.  Run it by path, not with ``-m``: each child imports
``chip_smoke`` and ``repro_torch`` from its own tree.  It prints each run's timed cases (kernel, plain and
PyTorch-call ms, the bound, max |err|), then one line per case with the
times of every run (a case one tree does not time shows "-"), and the
card's name and power limit.  It fails if a phase fails in either tree.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MARK = "OLD_NEW_RESULT "
ORDER = ("old", "new", "new", "old")
# phase -> (chip_smoke function, kernel sources it builds, its
# arguments: "rates" (HBM bytes/s, bf16 peak) or "model" (device model))
PHASES = {"1": ("phase1_flash_decode", ("flash_decode",), "rates"),
          "1b": ("phase1b_flash_decode_quant", ("flash_decode_quant",),
                 "rates"),
          "1c": ("phase1c_qmatmul", ("qmatmul",), "rates"),
          "1d": ("phase1d_probes", ("probe_dep_chain", "probe_chase",
                                    "probe_mma"), "model"),
          "1e": ("phase1e_ssd_scan", ("ssd_scan",), "model"),
          "1f": ("phase1f_flash_attention", ("flash_attention",), "model"),
          "1h": ("phase1h_flash_attention_bwd", ("flash_attention",
                                                 "flash_attention_bwd"),
                 "model"),
          "1i": ("phase1i_ssd_scan_bwd", ("ssd_scan", "ssd_scan_bwd"),
                 "model")}
KEEP = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err")
SWEEP_BATCHES = (1, 2, 4, 8, 16, 32)
SWEEP_ILPS = (1, 2, 4, 6, 8)


def _sweep(chip_smoke, model) -> list:
    """The Fig 4/5 sweep: ``mma_products`` bf16, 128^3, each (batch,
    ilp), timed alone (no sum) by ``chip_smoke.time_ms``; each entry
    carries its TFLOP/s."""
    import torch
    from repro_torch.kernels import probe_mma as pm
    hbm, peak = model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]
    out = []
    for b in SWEEP_BATCHES:
        for i in SWEEP_ILPS:
            g = torch.Generator(device="cuda").manual_seed(b * 10 + i)
            x = torch.randn((b, i, 128, 128), generator=g,
                            device="cuda").bfloat16()
            y = torch.randn((b, i, 128, 128), generator=g,
                            device="cuda").bfloat16()
            ms = chip_smoke.time_ms(pm.mma_products, [(x, y)])
            flops = 2 * 128 ** 3 * b * i
            bound_ms, bound_by = chip_smoke.bound(
                2 * x.numel() * 2 + x.numel() * 4, flops, hbm, peak)
            out.append({"name": f"mma_sweep[b{b},ilp{i}]", "ms": ms,
                        "plain_ms": None, "library_ms": None,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "max_abs_err": None,
                        "tflops": flops / ms / 1e9})
    return out


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
        fn, _, takes = PHASES[p]
        args = ((model,) if takes == "model" else
                (model.hbm.bandwidth_Bps, model.peak_flops["bfloat16"]))
        out = getattr(chip_smoke, fn)(*args)
        entries += out if isinstance(out, list) else [out]
        if p == "1d":
            entries += _sweep(chip_smoke, model)
    print(MARK + json.dumps([{k: e.get(k) for k in KEEP + ("tflops",)}
                             for e in entries]), flush=True)


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

    def num(v, fmt):
        return "-" if v is None else format(v, fmt)

    for name, e in first_new.items():
        times = ", ".join(
            f"{label} {r[name]['ms']:.4f}" if name in r else f"{label} -"
            for label, r in runs)
        rates = ", ".join(
            f"{label} {num(r[name].get('tflops'), '.2f')}" if name in r
            else f"{label} -" for label, r in runs)
        print(f"{name}: {times}; plain {num(e['plain_ms'], '.4f')}, "
              f"PyTorch call {num(e['library_ms'], '.4f')}, bound "
              f"{e['bound_ms']:.4f} ({e['bound_by']}), max |err| "
              f"{num(e['max_abs_err'], '.3e')}"
              + (f"; TFLOP/s {rates}" if e.get("tflops") else ""))
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
