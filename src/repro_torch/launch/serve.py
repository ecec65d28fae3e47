"""Serving launcher of the port: the batched engine with continuous
batching, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gptneox-1b \
        --requests 8 --batch 8 --max-seq 1024 --prompt-len 256 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --requests 8 --batch 8 --max-seq 1024 --prompt-len 512 \
        --max-new 64 --prefill-chunk 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --requests 8 --batch 8 --max-seq 1024 --prompt-len 256 \
        --max-new 64 --temperature 0.8

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --reduced --device cpu --requests 3 \
        --batch 2 --max-seq 64 --max-new 8 --prompt-len 20 \
        --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gptneox-1b \
        --reduced --device cpu --scenario ramp --requests 16 \
        --queue-limit 4 --policy shed_oldest --deadline-ms 500

``--arch`` takes any config of ``repro_torch.configs`` (gptneox-1b,
gemma2-2b, qwen2.5-3b, llama3.2-3b, gemma-2b, mamba2-2.7b,
jamba-v0.1-52b, kimi-k2-1t-a32b, llama4-maverick-400b-a17b; the last
three do not fit one card at full depth: ``--layers`` cuts the depth
to whole block periods).  Requests carry tokens only, as the
reference's launcher makes them: internvl2-2b serves them without a
patch prefix, and seamless-m4t-medium, which needs source frames
(``ServeEngine.submit(frames=)``), refuses them.
``--temperature`` above 0 samples (engine seed 0, every vocabulary
entry a candidate) where 0 decodes greedily, as the reference's
launcher does.

Weights come from the port's own seeded init (``torch.Generator`` seed
0); prompts from ``numpy.random.default_rng(1)``.  ``--device cpu`` runs
the plain versions of the kernels on the host (use ``--reduced`` there).
``--precision`` casts the weights (float32, bfloat16) or quantizes and
dequantizes them blockwise (the fp8 / fp6 / fp4 formats), as the
reference's launcher does.

Traffic mode: ``--scenario poisson|bursty|ramp`` replays a seeded
arrival trace (``repro_torch.serve.traffic``, ``--scenario-seed``) on
the wall clock instead of pre-enqueueing ``--requests`` prompts, and
reports TTFT and per-token tails, goodput and the status accounting.
``--queue-limit``, ``--policy``, ``--scheduler`` and ``--deadline-ms``
set the admission policy in either mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve import (
    AdmissionConfig, ServeEngine, quantize_params, replay)
from repro_torch.serve.traffic import TRACES


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gptneox-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-block", type=int, default=16,
                    help="decode steps fused per host read (1 = per-token)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per pooled-prefill call")
    ap.add_argument("--precision", default="bfloat16",
                    help="float32|bfloat16|float8_e4m3fn|float8_e5m2|"
                         "float6_e2m3fn|float6_e3m2fn|float4_e2m1fn")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                         "of the block period)")
    ap.add_argument("--scenario", default=None,
                    choices=["poisson", "bursty", "ramp"],
                    help="replay a seeded arrival trace instead of "
                         "pre-enqueueing --requests prompts")
    ap.add_argument("--scenario-seed", type=int, default=0)
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the admission queue (queued requests; "
                         "in-flight slots are bounded by --batch)")
    ap.add_argument("--policy", default="reject",
                    choices=["reject", "shed_oldest", "block"],
                    help="what a full queue does to the next submit")
    ap.add_argument("--scheduler", default="fifo", choices=["fifo", "spf"])
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline from submit; expired "
                         "requests finish as deadline_exceeded")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if args.layers % len(cfg.block_pattern()):
            raise SystemExit(f"--layers {args.layers}: not whole periods "
                             f"of {len(cfg.block_pattern())} blocks")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    params, qstats = quantize_params(params, args.precision)
    print(f"[serve] {cfg.name} precision={args.precision} device={device} "
          f"quantized_bytes={qstats['quantized_bytes'] / 2**20:.1f} MiB")

    admission = None
    if (args.queue_limit is not None or args.deadline_ms is not None
            or args.policy != "reject" or args.scheduler != "fifo"):
        admission = AdmissionConfig(
            queue_limit=args.queue_limit, policy=args.policy,
            scheduler=args.scheduler, deadline_ms=args.deadline_ms)
    engine = ServeEngine(model, params, batch=args.batch,
                         max_seq=args.max_seq,
                         temperature=args.temperature,
                         decode_block=args.decode_block,
                         prefill_chunk=args.prefill_chunk, device=device,
                         admission=admission)
    if args.scenario:
        trace_args = {
            "poisson": dict(n=args.requests, rate=200.0),
            "bursty": dict(n_bursts=max(args.requests // 8, 1),
                           burst_size=8, gap_s=0.25),
            "ramp": dict(n=args.requests, rate0=5.0, rate1=400.0),
        }[args.scenario]
        sc = TRACES[args.scenario](
            vocab_size=cfg.vocab_size, seed=args.scenario_seed,
            deadline_ms=args.deadline_ms, **trace_args)
        rep = replay(engine, sc, k=args.decode_block)
        print(f"[serve] scenario={rep.scenario} policy={rep.policy}/"
              f"{rep.scheduler} K={rep.k} submitted={rep.submitted} "
              f"by_status={rep.by_status}")

        def _ms(x):
            return "-" if x is None else f"{1e3 * x:.1f}ms"
        print(f"[serve] goodput={rep.goodput_tok_s:.1f} tok/s "
              f"ttft p50/p99={_ms(rep.ttft_p50)}/{_ms(rep.ttft_p99)} "
              f"tpt p50/p99={_ms(rep.tpt_p50)}/{_ms(rep.tpt_p99)} "
              f"accounting_ok={rep.accounting_ok}")
        if not rep.accounting_ok:
            raise SystemExit("[serve] accounting identity violated")
        return
    rng = np.random.default_rng(1)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
        engine.submit(prompt, max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    results = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, {engine.decode_steps} decode steps)")
    for r in results[:3]:
        print(f"  req {r.request_id} [{r.status}]: {r.tokens[:12]}...")


if __name__ == "__main__":
    main()
