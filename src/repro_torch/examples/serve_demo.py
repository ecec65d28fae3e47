"""Batched serving across precisions (counterpart of
``examples/serve_demo.py``): the fused decode loop and the Tab VIII
precision sweep.  The same GPT-NeoX-family model is served with float32
/ bfloat16 / fp8 / fp6 / fp4 weights, reporting fused (K=16) against
per-step (K=1) throughput, the quantization error, the stored bytes, and
the energy model's watts for one token of the full-width model on the
detected part.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo    # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu

gptneox-1b reduced, the seeded init made on the CPU (a
``torch.Generator`` seeded 0) and moved to the device, so the card
serves the CPU's weights; batch 4, max_seq 96, 8 requests of 16 prompt
tokens x 8 new, greedy.  Each format's weights are quantized and
dequantized to bf16 (``quantize_params``): the engine serves one dense
copy, so the format changes the stored bytes and the error, not what a
decode step computes.  The watts are ``core.energy.estimate`` for one
decode token of gptneox-1b at full width whose weights are read at the
format's stored bytes, at the part's HBM rate -- a model, not a reading
(``chip_smoke.py`` phase 2r holds it beside the card's NVML reading).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.device_model import DeviceModel, detect_backend_model
from repro_torch.core.energy import EnergyEstimate, estimate
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine, quantize_params

ARCH = "gptneox-1b"
FORMATS = ("float32", "bfloat16", "float8_e4m3fn", "float6_e2m3fn",
           "float4_e2m1fn")
BATCH, MAX_SEQ, N_REQUESTS, N_NEW = 4, 96, 8, 8


def init_params(device=None) -> dict:
    """The example's weights: the reduced model's init from a CPU
    generator seeded 0, moved to ``device`` (None: the card)."""
    device = resolve_device(device)
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    return unflatten({k: t.to(device) for k, t in flatten(params).items()})


def _serve(eng: ServeEngine) -> Tuple[float, List[List[int]]]:
    """Enqueue the 8 requests, serve them: (tok/s, each request's
    tokens in request order)."""
    eng.reset()
    for i in range(N_REQUESTS):
        eng.submit(list(range(1 + i, 17 + i)), max_new_tokens=N_NEW)
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    results = sorted(results, key=lambda r: r.request_id)
    return (sum(len(r.tokens) for r in results) / dt,
            [list(r.tokens) for r in results])


def tab8_estimate(part: DeviceModel, fmt: str, frac: float
                  ) -> EnergyEstimate:
    """The energy model for one decode token of gptneox-1b at full
    width on ``part``: 2 flops a parameter, its active parameters' bf16
    bytes scaled by ``frac`` (stored bytes over fp32 bytes) read from
    HBM, at the HBM rate."""
    full = get_config(ARCH)
    hbm = full.active_param_count() * 2 * frac
    return estimate(part, flops=2.0 * full.active_param_count(),
                    dtype=fmt, bytes_by_level={"hbm": hbm},
                    seconds=hbm / part.hbm.bandwidth_Bps)


def run(device=None, part: Optional[DeviceModel] = None,
        params: Optional[dict] = None,
        log: Callable[[str], None] = print) -> List[dict]:
    """Serve every format of :data:`FORMATS` on ``device`` (None: the
    card) from ``params`` (default :func:`init_params`); ``part`` (default
    the detected part) is the energy model's.  Returns a row a format:
    format, tok_s_fused, tok_s_step, quantized_bytes, mse, frac, watts,
    estimate (:func:`tab8_estimate`), fused and per_step (the streams)."""
    device = resolve_device(device)
    part = part or detect_backend_model(device)
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    base = init_params(device) if params is None else params
    base_bytes = sum(t.nbytes for t in flatten(base).values())
    log(f"serving {cfg.name} (reduced: {cfg.param_count()/1e6:.2f}M) on "
        f"{device} across precisions -- fused K=16 loop vs per-token "
        f"dispatch\n")
    log(f"{'precision':16s} {'tok/s fused':>11s} {'tok/s step':>10s} "
        f"{'bytes MiB':>10s} {'rel-MSE':>9s} "
        f"{f'{part.name} W (model)':>22s}")
    rows = []
    for fmt in FORMATS:
        served, q = quantize_params(base, fmt)
        fused = ServeEngine(model, served, batch=BATCH, max_seq=MAX_SEQ,
                            temperature=0.0, decode_block=16, device=device)
        per_step = ServeEngine(model, served, batch=BATCH, max_seq=MAX_SEQ,
                               temperature=0.0, decode_block=1,
                               device=device)
        _serve(fused)                       # warm-up
        _serve(per_step)
        (tps_fused, s_fused), (tps_step, s_step) = (_serve(fused),
                                                    _serve(per_step))
        frac = q["quantized_bytes"] / max(base_bytes, 1)
        est = tab8_estimate(part, fmt, frac)
        rows.append({"format": fmt, "tok_s_fused": tps_fused,
                     "tok_s_step": tps_step,
                     "quantized_bytes": q["quantized_bytes"],
                     "mse": q["mse"], "frac": frac,
                     "watts": est.total_watts, "estimate": est,
                     "fused": s_fused, "per_step": s_step})
        log(f"{fmt:16s} {tps_fused:11.1f} {tps_step:10.1f} "
            f"{q['quantized_bytes']/2**20:10.1f} {q['mse']:9.2e} "
            f"{est.total_watts:22.1f}")
    log("\n(the paper's Tab VIII: H100 57.7-60.2 W flat vs RTX 5080 "
        "58.8 -> 45.1 W from FP32 to FP8 -- decode is weight-read bound, "
        "so storage precision is the power lever; and §IV.A: the "
        "fused-vs-step gap is pure dispatch overhead, which a per-token "
        "loop would otherwise report as model speed.  The watts column "
        "is the energy model, not a reading.)")
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
