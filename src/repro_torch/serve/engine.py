"""Batched serving engine with continuous batching (counterpart of
``repro.serve.engine``, greedy dense slice).

A fixed pool of ``batch`` slots shares one ring KV cache.  Admission is
chunked pooled prefill: a prompt streams into its slot's region in
chunks of ``prefill_chunk`` tokens.  Decode is the fused loop
(:meth:`ServeEngine.decode_loop`): K steps of decode -> greedy sample ->
bookkeeping run back to back on the device with no host read inside;
tokens and emit codes come back in one read per block (:meth:`_harvest`).
Inactive slots ride along masked: they neither sample nor write.

State is updated **in place**, unlike the reference's functional
arrays: the cache's pool rows are written with ``index_put_`` (the pool
is about 1 GB at full gptneox-1b width, batch 8, max_seq 1024), and the
device-resident slot state (``pos``, ``remaining``, ``last_token``,
``active``) with ``copy_`` and indexed writes.

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when there is none.  Pass ``device="cpu"`` to run the plain
versions of the kernels on the host (the CPU tests do).

Not in this slice (they raise ``NotImplementedError``): quantized KV
(``kv_format``), the packed weight store (``weight_format``), mesh
serving, admission policies, speculation, fault injection and cancel,
and sampled decoding (``temperature > 0``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, List, Optional

import torch

from repro_torch.compat import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.sampler import check_temperature, sample_tokens

# terminal request states; every submitted request ends in exactly one
STATUSES = ("ok",                  # full generation delivered
            "truncated",           # run() step budget hit mid-generation
            "shed",                # (admission policies: later slice)
            "deadline_exceeded",   # (deadlines: later slice)
            "faulted")             # in-loop sentinel caught non-finite
                                   # logits; slot recovered via clear_slot

# emitted-mask codes carried out of the fused loop per (step, slot)
EMIT_NONE = 0      # slot inactive this step
EMIT_TOKEN = 1     # token sampled and appended
EMIT_FAULT = 2     # sentinel tripped: logits went non-finite


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]
    status: str = "ok"
    submit_t: Optional[float] = None       # time.monotonic() stamps
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def truncated(self) -> bool:
        return self.status == "truncated"

    @property
    def ttft(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    submit_t: float = 0.0
    first_token_t: Optional[float] = None

    @property
    def trunk_len(self) -> int:
        return len(self.prompt)


def _tree_to(tree: dict, device: torch.device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServeEngine:
    """See module docstring.  ``decode_block`` is K, the number of decode
    steps fused between two host reads by :meth:`run` (1 = the per-token
    pattern)."""

    def __init__(self, model: Model, params: dict, batch: int,
                 max_seq: int, temperature: float = 0.0,
                 decode_block: int = 16, prefill_chunk: int = 32,
                 device=None, *, kv_format: Any = None,
                 weight_format: Optional[str] = None, mesh: Any = None,
                 admission: Any = None, spec: Any = None):
        for name, value in (("kv_format", kv_format),
                            ("weight_format", weight_format),
                            ("mesh", mesh), ("admission", admission),
                            ("spec", spec)):
            if value is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) arrives with a later slice "
                    f"of the port")
        check_temperature(temperature)
        self.device = resolve_device(device)
        self.model = model
        self.params = _tree_to(params, self.device)
        self.batch = batch
        self.max_seq = max_seq
        self.decode_block = max(int(decode_block), 1)
        self.prefill_chunk = max(
            1, min(int(prefill_chunk), model.min_cache_capacity(max_seq)))
        self.cache = model.init_cache(batch, max_seq, self.device)
        self.kv_stats = model.kv_cache_stats(self.cache)
        self.reset()

    def reset(self) -> None:
        """Clear all serving state (cache, slots, queue, results); the
        parameters and the cache's tensors stay (reset in place)."""
        for entry in self.cache.values():
            kv = entry["kv"]
            kv["k"].zero_()
            kv["v"].zero_()
            kv["slot_pos"].fill_(-1)
        self.state = self._init_state()
        self.slot_req: List[Optional[_Request]] = [None] * self.batch
        self.out_tokens: List[List[int]] = [[] for _ in range(self.batch)]
        self.queue: Deque[_Request] = collections.deque()
        self.results: List[GenerationResult] = []
        self._next_id = 0
        self.decode_steps = 0          # fused decode steps run
        self.dispatches = 0            # decode blocks run (host reads)

    # -- device state --------------------------------------------------- #
    def _init_state(self) -> dict:
        b, dev = self.batch, self.device
        return {"pos": torch.zeros(b, dtype=torch.int32, device=dev),
                "remaining": torch.zeros(b, dtype=torch.int32, device=dev),
                "last_token": torch.zeros(b, dtype=torch.int32, device=dev),
                "active": torch.zeros(b, dtype=torch.bool, device=dev)}

    # -- request management -------------------------------------------- #
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        """Enqueue a request (FIFO).  The prompt must leave room for at
        least one generated token, and ``max_new_tokens`` must be >= 1:
        admission always samples one token from the prefill logits."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {max_new_tokens}): "
                f"admission samples the first token from the prefill "
                f"logits, so a 0-token generation does not exist")
        req = _Request(self._next_id, list(prompt), max_new_tokens,
                       submit_t=time.monotonic())
        if req.trunk_len >= self.max_seq:
            raise ValueError(
                f"prompt length {req.trunk_len} >= max_seq {self.max_seq}: "
                f"the cache holds max_seq-1 prompt tokens plus the decode "
                f"stream; truncate the prompt or raise max_seq")
        if req.trunk_len < 1:
            raise ValueError("empty prompt")
        self.queue.append(req)
        self._next_id += 1
        return req.request_id

    def cancel(self, request_id: int, status: str = "shed") -> bool:
        raise NotImplementedError("cancel arrives with the serving-"
                                  "robustness slice")

    def inject_fault(self, request_id: int, kind: str = "logits_nan",
                     **kwargs) -> None:
        raise NotImplementedError("fault injection arrives with the "
                                  "serving-robustness slice")

    def _admit_update(self, logits: torch.Tensor, slot: int, plen: int,
                      max_new: int) -> torch.Tensor:
        """Greedy first token from the prefill logits and the slot's
        state write (indexed, in place).  Returns the token (device)."""
        tok = sample_tokens(logits)[0]
        st = self.state
        st["pos"][slot] = plen
        st["remaining"][slot] = max_new - 1
        st["last_token"][slot] = tok
        st["active"][slot] = max_new > 1
        return tok

    def _prefill_into_slot(self, slot: int, req: _Request) -> torch.Tensor:
        """Evict the slot's previous tenant and stream the prompt into
        its pool region in chunks; returns last-position logits (1, V)."""
        self.model.clear_slot(self.cache, slot)
        chunk = self.prefill_chunk
        logits = None
        for off in range(0, len(req.prompt), chunk):
            part = req.prompt[off:off + chunk]
            valid = len(part)
            tokens = torch.tensor(part + [0] * (chunk - valid),
                                  dtype=torch.int32, device=self.device)
            logits = self.model.prefill_chunk(self.params, self.cache,
                                              tokens, slot, off, valid)
        return logits

    def _admit(self) -> None:
        for slot in range(self.batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            logits = self._prefill_into_slot(slot, req)
            tok = self._admit_update(logits, slot, req.trunk_len,
                                     req.max_new_tokens)
            self.slot_req[slot] = req
            self.out_tokens[slot] = [int(tok)]
            req.first_token_t = time.monotonic()
            if req.max_new_tokens <= 1:
                self._finish(slot)

    # -- fused decode --------------------------------------------------- #
    def _decode_block(self, k: int):
        """K decode steps back to back, with no host read: decode ->
        non-finite sentinel -> greedy sample -> slot bookkeeping, all on
        the device.  Returns (tokens (k, b), emit codes (k, b)) int32.

        A slot whose logits go non-finite emits EMIT_FAULT, keeps its
        pos/remaining/last_token, and drops out of ``active`` in the same
        step, so its cache writes stop and the other slots are
        untouched."""
        st = self.state
        toks, emits = [], []
        for _ in range(k):
            active = st["active"]
            logits = self.model.decode_step(self.params, self.cache,
                                            st["last_token"], st["pos"],
                                            active=active)
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            ok = active & ~bad
            tok = torch.where(ok, sample_tokens(logits), st["last_token"])
            new_pos = torch.where(ok, st["pos"] + 1, st["pos"])
            new_rem = st["remaining"] - ok.to(torch.int32)
            finished = ok & ((new_rem <= 0) | (new_pos >= self.max_seq - 1))
            st["pos"].copy_(new_pos)
            st["remaining"].copy_(new_rem)
            st["last_token"].copy_(tok)
            st["active"].copy_(ok & ~finished)
            toks.append(tok)
            emits.append(ok.to(torch.int32)
                         + EMIT_FAULT * bad.to(torch.int32))
        return torch.stack(toks), torch.stack(emits)

    def _any_active(self) -> bool:
        return any(r is not None for r in self.slot_req)

    def _max_remaining(self) -> int:
        """Largest token budget left among in-flight slots (host-known).
        run() caps the fused block with it, so the last block of a
        request runs only the steps it needs."""
        rem = 0
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                rem = max(rem,
                          req.max_new_tokens - len(self.out_tokens[slot]))
        return max(rem, 1)

    def _finish(self, slot: int, status: str = "ok") -> None:
        req = self.slot_req[slot]
        self.results.append(GenerationResult(
            req.request_id, req.prompt, self.out_tokens[slot],
            status=status, submit_t=req.submit_t,
            first_token_t=req.first_token_t, finish_t=time.monotonic()))
        self.slot_req[slot] = None

    def _dispatch(self, k: int) -> int:
        """One fused block of K decode steps and its one host read."""
        toks, emitted = self._decode_block(k)
        self.decode_steps += k
        self._harvest(toks, emitted)
        return k

    def _harvest(self, toks: torch.Tensor, emitted: torch.Tensor) -> None:
        """Block-boundary host pass: ONE device->host read of the (k, b)
        tokens, codes and the active mask, then per-slot extend / finish
        / fault bookkeeping.  A faulted slot keeps the tokens it emitted
        before the sentinel tripped, finishes ``faulted``, and is evicted
        through ``clear_slot``."""
        k = toks.shape[0]
        host = torch.cat([toks, emitted,
                          self.state["active"].to(torch.int32)[None]]
                         ).cpu().numpy()
        toks_h, codes_h, active_after = host[:k], host[k:2 * k], host[2 * k]
        self.dispatches += 1
        for slot in range(self.batch):
            if self.slot_req[slot] is None:
                continue
            codes = codes_h[:, slot]
            self.out_tokens[slot].extend(
                int(t) for t, e in zip(toks_h[:, slot], codes)
                if e == EMIT_TOKEN)
            if (codes == EMIT_FAULT).any():
                self._finish(slot, status="faulted")
                self.model.clear_slot(self.cache, slot)
            elif not active_after[slot]:
                self._finish(slot)

    def decode_loop(self, k: Optional[int] = None) -> None:
        """Admit from the queue, then run K fused decode steps (K =
        ``decode_block`` by default)."""
        self._admit()
        if self._any_active():
            self._dispatch(k or self.decode_block)

    # -- serving loop ---------------------------------------------------- #
    def run(self, max_steps: int = 1000) -> List[GenerationResult]:
        """Serve until queue and pool drain or ``max_steps`` decode steps
        have been spent.  On budget exhaustion in-flight requests are
        flushed as partial results (``status="truncated"``) and their
        device slots deactivated.  A queue that admission cannot make
        progress on raises instead of spinning."""
        steps = 0
        while steps < max_steps:
            before = (len(self.queue), len(self.results))
            self._admit()
            if not self._any_active():
                if not self.queue:
                    break
                if (len(self.queue), len(self.results)) == before:
                    raise RuntimeError(
                        f"run() stalled: {len(self.queue)} queued "
                        f"request(s), no active slots, and an admission "
                        f"pass made no progress")
                continue
            k = min(self.decode_block, max_steps - steps,
                    self._max_remaining())
            steps += self._dispatch(k)
        if self._any_active():
            for slot in range(self.batch):
                if self.slot_req[slot] is not None:
                    self._finish(slot, status="truncated")
            self.state["active"].zero_()
        return sorted(self.results, key=lambda r: r.request_id)
