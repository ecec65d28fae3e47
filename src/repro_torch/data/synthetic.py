"""Deterministic synthetic LM data on the host (counterpart of
``repro.data.synthetic``).

:class:`SyntheticStream` makes training batches: each is a pure function
of (seed, step, process index), so a restart resumes mid-stream with
nothing to checkpoint beyond the step.  The batch has the fields, kinds
and dtypes of ``models.model.batch_fields`` (tokens; frame or patch
embeddings N(0, 0.02^2) at the compute dtype for the modal models).
Token kinds:

* ``affine``  — t_{i+1} = (a * t_i + b) mod v on a reduced vocab v; a
  small model learns it in tens of steps;
* ``uniform`` — i.i.d. tokens over the vocabulary (loss floor log V);
* ``zipf``    — Zipf-distributed unigrams.

The draws are numpy's ``default_rng((seed, step, process_index))``: the
bits differ from the reference's ``jax.random`` ones (conformance tests
feed the reference's batches, as numpy, to both packages).

:func:`host_prompt` is one ``affine`` prompt as a list of ints (what
``ServeEngine.submit`` takes), drawn in the reference's order, so a
trace built from these prompts is token for token the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import batch_fields

AFFINE_A = 5
AFFINE_B = 17
AFFINE_VOCAB = 97                 # prime => full cycle


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    kind: str = "affine"          # affine | uniform | zipf
    seed: int = 0
    affine_a: int = AFFINE_A
    affine_b: int = AFFINE_B
    affine_vocab: int = AFFINE_VOCAB
    zipf_alpha: float = 1.2


class SyntheticStream:
    """Stateless stream: ``batch(step)`` is deterministic.  The global
    batch of ``batch`` rows is split over ``process_count`` processes;
    this one makes its ``batch / process_count`` rows on ``device``."""

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 data_cfg: SyntheticConfig = SyntheticConfig(),
                 process_index: int = 0, process_count: int = 1,
                 device="cpu"):
        if batch % process_count:
            raise ValueError(f"batch {batch} % process_count "
                             f"{process_count} != 0")
        if data_cfg.kind not in ("affine", "uniform", "zipf"):
            raise ValueError(f"unknown data kind {data_cfg.kind!r}")
        self.cfg, self.data_cfg = cfg, data_cfg
        self.local_batch = batch // process_count
        self.process_index = process_index
        self.fields = batch_fields(cfg, batch, seq_len)
        self.device = torch.device(device)

    def _tokens(self, rng: np.random.Generator, shape: tuple) -> np.ndarray:
        d, vocab = self.data_cfg, self.cfg.vocab_size
        if d.kind == "uniform":
            return rng.integers(0, vocab, shape).astype(np.int32)
        if d.kind == "zipf":
            p = np.arange(1, vocab + 1, dtype=np.float64) ** -d.zipf_alpha
            return rng.choice(vocab, size=shape, p=p / p.sum()).astype(
                np.int32)
        v = min(d.affine_vocab, vocab)
        seq = np.empty(shape, np.int64)
        seq[..., 0] = rng.integers(0, v, shape[:-1])
        for i in range(1, shape[-1]):
            seq[..., i] = (d.affine_a * seq[..., i - 1] + d.affine_b) % v
        return seq.astype(np.int32)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(
            (self.data_cfg.seed, step, self.process_index))
        out = {}
        for name, (shape, dtype) in self.fields.items():
            local = (self.local_batch,) + tuple(shape[1:])
            if dtype == "int32":
                arr = torch.from_numpy(self._tokens(rng, local))
                out[name] = arr.to(self.device)
            else:
                arr = rng.standard_normal(local, np.float32) * np.float32(
                    0.02)
                out[name] = torch.from_numpy(arr).to(self.device,
                                                     resolve_dtype(dtype))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_stream(cfg: ArchConfig, batch: int, seq_len: int,
                data_cfg: Optional[SyntheticConfig] = None,
                device="cpu") -> SyntheticStream:
    return SyntheticStream(cfg, batch, seq_len,
                           data_cfg or SyntheticConfig(), device=device)


def host_prompt(length: int, seed: int, vocab_size: int) -> list:
    """One deterministic ``affine`` prompt as a list of ints."""
    if length < 1:
        raise ValueError("prompt length must be >= 1")
    rng = np.random.default_rng(seed)
    v = min(AFFINE_VOCAB, vocab_size)
    t = int(rng.integers(0, v))
    out = [t]
    for _ in range(length - 1):
        t = (AFFINE_A * t + AFFINE_B) % v
        out.append(t)
    return out
