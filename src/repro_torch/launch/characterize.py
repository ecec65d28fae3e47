"""Run the microbenchmark probe suite (the paper's methodology) on the card
and print the characterization tables — §IV latency, §V matmul /
precision, §VI memory hierarchy (counterpart of
``examples/characterize.py``, at its sizes).

    PYTHONPATH=src python -m repro_torch.launch.characterize   # the card
    PYTHONPATH=src python -m repro_torch.launch.characterize --device cpu

On the card the probes run the ``dep_chain``, ``chase`` and
``mma_probe`` kernels, and a last section prints each measured figure
beside the paper's GH100 (H100 PCIe) figure.  With ``--device cpu`` they
run the kernels' plain versions on the host.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import compat
from repro_torch.core import timing
from repro_torch.core.device_model import (GH100, PAPER_GH100,
                                           detect_backend_model,
                                           torch_device)
from repro_torch.core.probes import compute, matmul, memory, precision
from repro_torch.core.report import dataclass_table, table

# the reference example's sizes
CHASE_SIZES = tuple(1 << p for p in range(14, 27, 2))     # 16 KiB .. 64 MiB
CHASE_STEPS = 1 << 13
SWEEP = dict(batches=(1, 4, 16), ilps=(1, 2, 4), iters=4)


def run(device=None, *, latency_iters: int = 8,
        sweep: Optional[dict] = None,
        chase_sizes: Sequence[int] = CHASE_SIZES,
        chase_steps: int = CHASE_STEPS, chase_iters: int = 4,
        bw_bytes: int = 1 << 28, bw_iters: int = 4,
        log: Callable[[str], None] = print) -> Dict[str, object]:
    """Run the suite on ``device`` (None: the card; ``"cpu"``: the host),
    print it through ``log`` and return every result by name."""
    dev = detect_backend_model(device)
    out: Dict[str, object] = {"model": dev}
    log(compat.report())
    log("")
    log(f"backend device model: {dev.name} "
        f"(clock {dev.clock_hz/1e9:.2f} GHz)\n")
    if dev.kind == "gpu":
        tdev = torch_device(dev)
        out["clock_hz"] = timing.clock_hz(tdev)
        out["timer_overhead_cycles"] = timing.timer_overhead_cycles(tdev)
        log(f"measured SM clock {out['clock_hz'] / 1e9:.4f} GHz "
            f"(clock64 / globaltimer); timer overhead "
            f"{out['timer_overhead_cycles']:g} cycles (two back-to-back "
            f"clock64 reads)\n")

    log("== §IV execution-pipeline latency (Tab III analogue) ==")
    rows = compute.latency_table(dev, iters=latency_iters)
    out["latency"] = rows
    log(dataclass_table(rows, ["workload", "support", "true_cycles",
                               "completion_cycles"]))

    log("== §IV.C fp64 emulation factor ==")
    out["fp64_factor"] = compute.fp64_emulation_factor(dev,
                                                       iters=latency_iters)
    log(f"fp64/fp32 = {out['fp64_factor']:.2f}x\n")

    log("== §V matmul saturation (Fig 4/5 analogue) ==")
    pts = matmul.warp_ilp_sweep(device=dev, **(sweep or SWEEP))
    sat = matmul.saturation_point(pts)
    out["matmul"], out["saturation"] = pts, sat
    log(f"saturates at tiles={sat.batch} ilp={sat.ilp} "
        f"({sat.tflops:.2f} TFLOP/s)\n")

    log("== §V.A precision support matrix (Tab IV/V analogue) ==")
    out["support"] = precision.support_matrix(dev)
    log(dataclass_table(out["support"],
                        ["fmt", "bits", "representable", "pipeline"]))

    log("== §VI.A memory hierarchy walk (Fig 6 analogue) ==")
    curve = memory.chase_curve(sizes=tuple(chase_sizes), steps=chase_steps,
                               device=dev, iters=chase_iters)
    out["chase"] = curve
    log(dataclass_table(curve))
    out["boundaries"] = memory.find_boundaries(curve)
    log(f"hierarchy boundaries near: {out['boundaries']} bytes\n")

    log("== §VI.D streaming bandwidth (Fig 10 analogue) ==")
    out["bandwidth"] = memory.stream_bandwidth(bw_bytes, iters=bw_iters,
                                               device=dev)
    log(dataclass_table(out["bandwidth"]))

    if dev.kind == "gpu":
        log(f"== §V warp x ILP sweep on {dev.name} (Fig 4/5) ==")
        log(dataclass_table(pts, ["batch", "ilp", "dtype", "runtime_ms",
                                  "tflops"]))
        log(f"== measured on {dev.name} beside the paper's {GH100.name} "
            f"(H100 PCIe, 1.755 GHz, HBM2e) ==")
        log(table(["figure", "measured", "paper GH100", "unit / note"],
                  paper_rows(out)))
    return out


def chase_plateaus(curve: Sequence[memory.ChasePoint]) -> Dict[str, float]:
    """Cycles per load of the hierarchy walk's levels: L1 the smallest
    working set; L2 the median of 1 MiB .. 16 MiB (inside the 50 MB L2);
    ``largest`` the largest working set, in HBM as far as it exceeds
    the L2."""
    mid = [p.cycles_per_load for p in curve
           if 1 << 20 <= p.working_set_bytes <= 16 << 20]
    return {"l1": curve[0].cycles_per_load,
            "l2": statistics.median(mid) if mid else float("nan"),
            "largest": curve[-1].cycles_per_load}


def paper_rows(out: Dict[str, object]) -> List[list]:
    """[figure, measured, paper GH100, note] for each figure the paper
    gives for its H100 PCIe."""
    tab3 = PAPER_GH100["tab3_cycles"]
    rows: List[list] = [
        ["SM clock (GHz)", out["clock_hz"] / 1e9, GH100.clock_hz / 1e9,
         "clock64 / globaltimer vs the PCIe part's boost"],
        ["timer overhead (cycles)", out["timer_overhead_cycles"],
         PAPER_GH100["clock_overhead_cycles"], "two clock64 reads (§IV.A)"],
    ]
    lat = {r.workload: r for r in out["latency"]}
    for w, (t, c) in tab3.items():
        r = lat[w]
        rows.append([f"{w} true (cycles)", r.true_cycles, t,
                     "1 thread, chain 256"])
        rows.append([f"{w} completion (cycles)", r.completion_cycles, c,
                     "4096 threads, 1024 a block"])
    rows.append(["fp64/fp32 completion", out["fp64_factor"],
                 tab3["fp64"][1] / tab3["fp32"][1], "Tab III ratio"])
    plateaus = chase_plateaus(out["chase"])
    l1_lo, l1_hi = PAPER_GH100["chase_cycles"]["l1"]
    rows += [
        ["chase L1 (cycles/load)", plateaus["l1"], f"{l1_lo:g}-{l1_hi:g}",
         f"{out['chase'][0].working_set_bytes} B"],
        ["chase L2 (cycles/load)", plateaus["l2"],
         PAPER_GH100["chase_cycles"]["l2"], "median of 1-16 MiB"],
        ["chase largest (cycles/load)", plateaus["largest"],
         PAPER_GH100["chase_cycles"]["hbm"],
         f"{out['chase'][-1].working_set_bytes} B vs the paper's global"],
        ["hierarchy boundaries (B)", str(out["boundaries"]), "-",
         "latency jumps >= 1.4x"],
    ]
    sat = out["saturation"]
    warps = sat.batch * (sat.m // 16) * (sat.n // 8)
    rows.append(["saturation (batch, ilp)", f"({sat.batch}, {sat.ilp})",
                 f"ilp {PAPER_GH100['saturation']['ilp']}, "
                 f"{PAPER_GH100['saturation']['warps']} warps",
                 f"{sat.tflops:.2f} TFLOP/s; {warps} warps of 16x8 tiles"])
    bw = {r.mode: r.gbps for r in out["bandwidth"]}
    for mode in ("read", "write", "copy"):
        if mode in bw:
            rows.append([f"{mode} GB/s", bw[mode], "-",
                         f"{out['bandwidth'][0].nbytes} B"])
    if "read" in bw and "write" in bw:
        rows.append(["read/write ratio", bw["read"] / bw["write"],
                     PAPER_GH100["read_write_ratio"], "Fig 10"])
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions on the host; "
                         "default: the card")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
