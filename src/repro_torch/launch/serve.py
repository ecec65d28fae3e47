"""Serving launcher of the port: the batched engine with continuous
batching, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gptneox-1b \
        --requests 8 --batch 8 --max-seq 1024 --prompt-len 256 --max-new 64

Weights come from the port's own seeded init (``torch.Generator`` seed
0); prompts from ``numpy.random.default_rng(1)``.  ``--device cpu`` runs
the plain versions of the kernels on the host (use ``--reduced`` there).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine, quantize_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gptneox-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-block", type=int, default=16,
                    help="decode steps fused per host read (1 = per-token)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per pooled-prefill call")
    ap.add_argument("--precision", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    params, qstats = quantize_params(params, args.precision)
    print(f"[serve] {cfg.name} precision={args.precision} device={device} "
          f"quantized_bytes={qstats['quantized_bytes'] / 2**20:.1f} MiB")

    engine = ServeEngine(model, params, batch=args.batch,
                         max_seq=args.max_seq,
                         decode_block=args.decode_block,
                         prefill_chunk=args.prefill_chunk, device=device)
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
