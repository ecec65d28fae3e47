#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

0. the card (``nvidia-smi`` name and power limit) and the kernel build;
1. ``flash_decode`` (kernel) against ``flash_decode_plain`` on the card,
   six cases: (a) the serving shape b=8, hq=hkv=16, d=128, S=1024, bf16,
   ragged pos 100..1000; (b) the same in fp32; (c) GQA 32/8 over a cache
   stored (b, hkv, S, d) and passed as a strided (b, S, hkv, d) view;
   (d) window 256 + softcap 50 over wrapped rings; (e) S=1000; (f) a row
   with no visible slot, which must come out finite.  Tolerances: fp32
   atol=rtol=1e-5; bf16 atol 2e-2, because the plain version rounds p to
   bf16 before PV (as the reference does) and the kernel keeps fp32.
   At shape (a) it times the kernel, the plain version and, as a
   yardstick only, ``scaled_dot_product_attention`` (the port never
   calls it), and computes the least time the card could take;
2. full-width gptneox-1b (16 layers, d_model 2048, vocab 50432, bf16,
   seeded random weights) through ``ServeEngine.run`` on the card: 8
   requests x 256-token prompts x 64 new tokens, batch 8, max_seq 1024,
   prefill_chunk 32, decode_block 16.  Every request must end ``ok``
   with 64 tokens and ``flash_decode`` must have launched once per layer
   per decode step; the kernel is then held against its plain version
   on the engine's own pool (case g);
3. the same path on the card and on the CPU in fp32 with TF32 off, full
   width, 2 layers, the same seeded weights: 2 requests x 32-token
   prompts x 16 new tokens, decode_block 7.  Greedy streams must be
   identical and the admission logits within atol 1e-3.

Then it prints the ``kernels`` JSON line and, last, the ``ok`` line.
Any failure raises: the exit code is then non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 peaks by part (NVIDIA data sheets, dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, fp32 (non-tensor) FLOP/s.
PEAKS = {"sxm": (3.35e12, 989e12, 67e12),
         "pcie": (2.0e12, 756e12, 51e12)}

FD_SOURCE = "src/repro_torch/csrc/flash_decode.cu"
FD_REPLACES = "src/repro/kernels/flash_decode.py:120"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    part = "pcie" if "pcie" in name.lower() else "sxm"
    return part, PEAKS[part]


def ring_slot_pos(pos: int, S: int) -> np.ndarray:
    """slot_pos of a ring of capacity S after writing positions 0..pos."""
    sp = np.full(S, -1, np.int32)
    p = np.arange(max(0, pos - S + 1), pos + 1, dtype=np.int32)
    sp[p % S] = p
    return sp


def decode_case(seed, b, S, hq, hkv, d, dtype, pos, head_major=False):
    """q (b,1,hq,d), k/v (b,S,hkv,d) and slot_pos/pos on the card.  With
    ``head_major`` the cache is stored (b, hkv, S, d) and handed over as
    a strided (b, S, hkv, d) view."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to(dev, dtype)

    q = t((b, 1, hq, d))
    if head_major:
        k = t((b, hkv, S, d)).transpose(1, 2)
        v = t((b, hkv, S, d)).transpose(1, 2)
    else:
        k, v = t((b, S, hkv, d)), t((b, S, hkv, d))
    pos = np.asarray(pos, np.int32)
    sp = np.stack([ring_slot_pos(int(p), S) for p in pos])
    return (q, k, v, torch.from_numpy(sp).to(dev),
            torch.from_numpy(pos).to(dev))


def visible(sp: torch.Tensor, pos: torch.Tensor, window=None):
    ok = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        ok &= sp > pos[:, None] - window
    return ok


def time_ms(fn, inputs, reps: int = 25, n: int = 12) -> float:
    """Device time of one call, in ms: the median over ``reps`` of a run
    of ``n`` calls between two CUDA events, divided by ``n``.  Each run
    is queued behind ``torch.cuda._sleep`` so the host's enqueueing
    overlaps it (the events then time the device, not the Python
    wrapper), and consecutive calls cycle through ``inputs`` (sets larger
    together than the 50 MB L2), so each call finds its K/V cold, as a
    decode step does."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def profile_block(eng, k: int):
    """One fused decode block of ``k`` steps under ``torch.profiler``:
    (device busy ms, flash_decode device ms, kernel launches, top kernels
    by device time) from the CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.decode_loop(k)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    fd = sum(e.self_device_time_total for e in kern
             if "flash_decode" in e.key) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return busy, fd, sum(e.count for e in kern), [
        (e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_plain)
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine, quantize_params

    # ---- 0: the card and the build ----------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        log(line)
    name = torch.cuda.get_device_name(0)
    part, (hbm, peak_bf16, peak_f32) = card_peaks(name)
    log(f"[card] {name}; part {part}: HBM {hbm / 1e12} TB/s, bf16 "
        f"{peak_bf16 / 1e12} TFLOP/s, fp32 {peak_f32 / 1e12} TFLOP/s")
    log("[card] " + compat.report().replace("\n", "; "))
    t0 = time.perf_counter()
    _build.build_all(["flash_decode"])
    log(f"[build] flash_decode: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.get("flash_decode", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("[build]   " + line.strip())

    # ---- 1: kernel vs plain on the card ------------------------------ #
    tol = {torch.float32: dict(atol=1e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
    ragged = np.linspace(100, 1000, 8).astype(np.int32)
    wrapped = np.linspace(500, 3000, 8).astype(np.int32)
    cases = {
        "a_serving_bf16": (dict(seed=1, b=8, S=1024, hq=16, hkv=16, d=128,
                                dtype=torch.bfloat16, pos=ragged), {}),
        "b_serving_fp32": (dict(seed=1, b=8, S=1024, hq=16, hkv=16, d=128,
                                dtype=torch.float32, pos=ragged), {}),
        "c_gqa_32_8_strided": (dict(seed=2, b=8, S=1024, hq=32, hkv=8,
                                    d=128, dtype=torch.bfloat16, pos=ragged,
                                    head_major=True), {}),
        "d_window_softcap": (dict(seed=3, b=8, S=1024, hq=16, hkv=16,
                                  d=128, dtype=torch.bfloat16, pos=wrapped),
                             dict(window=256, softcap=50.0)),
        "e_S1000": (dict(seed=4, b=8, S=1000, hq=16, hkv=16, d=128,
                         dtype=torch.bfloat16, pos=ragged), {}),
        "f_empty_row": (dict(seed=5, b=8, S=1024, hq=16, hkv=16, d=128,
                             dtype=torch.bfloat16, pos=ragged), {}),
    }
    errors = {}
    for case, (spec, flags) in cases.items():
        q, k, v, sp, pos = decode_case(**spec)
        if case == "f_empty_row":
            sp[3] = -1
        got = flash_decode(q, k, v, sp, pos, **flags)
        torch.cuda.synchronize()
        want = flash_decode_plain(q, k, v, sp, pos, **flags)
        torch.cuda.synchronize()
        rows = visible(sp, pos, flags.get("window")).any(dim=1)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{case}: kernel output is not finite")
        err = (got[rows].float() - want[rows].float()).abs().max().item()
        errors[case] = err
        log(f"[kernel] {case}: max_abs_err {err:.3e} over "
            f"{int(rows.sum())}/{len(rows)} rows (tol {tol[q.dtype]})")
        torch.testing.assert_close(got[rows].float(), want[rows].float(),
                                   **tol[q.dtype])

    # timing and bound at the serving shape (a): three input sets (3 x 67
    # MB of K/V) cycled so that no call finds its K/V in L2
    spec = cases["a_serving_bf16"][0]
    sets = [decode_case(**dict(spec, seed=s)) for s in (11, 12, 13)]
    q, k, v, sp, pos = sets[0]
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    ms = time_ms(flash_decode, sets)
    plain_ms = time_ms(flash_decode_plain, sets)
    sdpa_sets = [(x[0].transpose(1, 2), x[1].transpose(1, 2),
                  x[2].transpose(1, 2), visible(x[3], x[4])[:, None, None])
                 for x in sets]
    library_ms = time_ms(
        lambda qt, kt, vt, mask: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), sdpa_sets)
    n_vis = int(visible(sp, pos).sum())          # visible (row, slot) pairs
    item = k.element_size()
    nbytes = (2 * n_vis * hkv * d * item + q.numel() * item * 2
              + sp.numel() * 4 + pos.numel() * 4)
    flops = 4 * n_vis * hq * d                   # QK and PV, 2 per MAC
    t_bytes = nbytes / hbm * 1e3
    t_ops = flops / peak_bf16 * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernel] timing at (a): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {flops} flop; {n_vis} visible slots)")

    # ---- 2: full-width engine on the card ---------------------------- #
    cfg = get_config("gptneox-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    params, qstats = quantize_params(params, "bfloat16")
    eng = ServeEngine(model, params, batch=8, max_seq=1024,
                      decode_block=16, prefill_chunk=32, device="cuda")
    log(f"[engine] {cfg.name}: {qstats['quantized_bytes'] / 2**30:.3f} GiB "
        f"params, {eng.kv_stats['kv_bytes'] / 2**30:.3f} GiB KV pool")
    eng.submit(list(range(1, 41)), max_new_tokens=4)       # warm-up
    eng.run()
    eng.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 256).tolist()
               for _ in range(8)]
    for p in prompts:
        eng.submit(p, max_new_tokens=64)
    flash_decode.launches = 0
    t_run = time.monotonic()
    results = eng.run()
    launches, steps = flash_decode.launches, eng.decode_steps
    torch.cuda.synchronize()
    bad = [(r.request_id, r.status, len(r.tokens)) for r in results
           if r.status != "ok" or len(r.tokens) != 64]
    if len(results) != 8 or bad:
        raise AssertionError(f"engine results: {len(results)} requests, "
                             f"not ok: {bad}")
    if not all(0 <= t < cfg.vocab_size for r in results for t in r.tokens):
        raise AssertionError("token id out of range")
    if launches != cfg.n_layers * steps or launches == 0:
        raise AssertionError(f"flash_decode launched {launches} times; "
                             f"expected {cfg.n_layers} x {steps} decode "
                             f"steps")
    t_admitted = max(r.first_token_t for r in results)
    t_done = max(r.finish_t for r in results)
    decode_s = t_done - t_admitted
    step_ms = 1e3 * decode_s / steps
    decode_tok = sum(len(r.tokens) - 1 for r in results)
    ttft = statistics.mean(r.ttft for r in results)
    log(f"[engine] {len(results)} requests ok x 64 tokens; "
        f"{steps} decode steps in {eng.dispatches} blocks; "
        f"flash_decode launches {launches}")
    log(f"[engine] prefill {t_admitted - t_run:.3f} s (8 x 256 tokens), "
        f"decode {decode_tok / decode_s:.1f} tok/s, "
        f"{step_ms:.2f} ms per decode step, "
        f"mean TTFT {1e3 * ttft:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where a decode step's time goes: one more 16-step block, profiled
    eng.reset()
    for p in prompts:
        eng.submit(p, max_new_tokens=40)
    eng.decode_loop(16)                        # admission + first block
    busy, fd_ms, n_kern, top = profile_block(eng, 16)
    log(f"[profile] 16-step decode block: device busy {busy / 16:.3f} ms "
        f"per step ({n_kern / 16:.0f} kernels) against "
        f"{step_ms:.2f} ms per step unprofiled: idle share "
        f"{1 - busy / 16 / step_ms:.3f}; flash_decode {fd_ms / 16:.3f} ms "
        f"per step ({fd_ms / busy:.3f} of device time)")
    for key, count, t in top:
        log(f"[profile]   {t:9.3f} ms  x{count:<5d} {key}")

    # case (g): the kernel on the engine's own pool, layer 0
    kv = eng.cache["pos0"]["kv"]
    qg = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)
                     ).to(torch.bfloat16)
    args = (qg, kv["k"][0], kv["v"][0], kv["slot_pos"][0], eng.state["pos"])
    got = flash_decode(*args)
    torch.cuda.synchronize()
    want = flash_decode_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    log(f"[kernel] g_engine_pool: max_abs_err {err:.3e}")
    torch.testing.assert_close(got.float(), want.float(),
                               **tol[torch.bfloat16])
    del eng, params, kv, args
    torch.cuda.empty_cache()

    # ---- 3: the same path on the card and on the CPU, fp32 ----------- #
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg3 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    model3 = build_model(cfg3)
    params3 = model3.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts3 = [rng.integers(0, cfg3.vocab_size, 32).tolist()
                for _ in range(2)]
    streams, logits = {}, {}
    for dev in ("cuda", "cpu"):
        e = ServeEngine(model3, params3, batch=2, max_seq=64,
                        decode_block=7, prefill_chunk=32, device=dev)
        seen = logits[dev] = []
        prefill = e._prefill_into_slot

        def recording(slot, req, prefill=prefill, seen=seen):
            out = prefill(slot, req)
            seen.append(out.float().cpu())
            return out

        e._prefill_into_slot = recording
        for p in prompts3:
            e.submit(p, max_new_tokens=16)
        streams[dev] = [(r.status, r.tokens) for r in e.run()]
        del e
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"card vs CPU greedy streams differ: "
                             f"{streams}")
    for a, c in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=0.0)
    lerr = max((a - c).abs().max().item()
               for a, c in zip(logits["cuda"], logits["cpu"]))
    log(f"[parity] fp32 2-layer full width: card and CPU streams identical "
        f"({[len(t) for _, t in streams['cuda']]} tokens), admission "
        f"logits max_abs_err {lerr:.3e}")

    # ---- result lines -------------------------------------------------- #
    print(json.dumps({"kernels": [{
        "name": "flash_decode", "route": "cuda", "source": FD_SOURCE,
        "replaces": FD_REPLACES, "launches": launches,
        "max_abs_err": errors["a_serving_bf16"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
