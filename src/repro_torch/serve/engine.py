"""Batched serving engine with continuous batching (counterpart of
``repro.serve.engine``).

A fixed pool of ``batch`` slots shares one cache: ring KV for attention
layers, conv carries and the fp32 state for SSM layers, and for an
encoder-decoder model the encoder output and a cross-attention ring per
layer (the slot-state protocol of ``models.slotstate``; the engine does
not know the family).  Admission is chunked pooled prefill: an
encoder-decoder request's source frames (``submit(frames=)``) are
encoded once into the slot (``Model.encode_slot``), a VLM request's
patch prefix (``submit(patches=)``) streams in as embedding chunks, and
the prompt's tokens stream into the slot's region in chunks of
``prefill_chunk`` tokens.  Decode is the fused loop
(:meth:`ServeEngine.decode_loop`): K steps of decode -> sample ->
bookkeeping run back to back on the device with no host read inside;
tokens and emit codes come back in one read per block (:meth:`_harvest`).
Inactive slots ride along masked: they neither sample nor write.

Sampling, as in the reference: ``temperature`` 0 is greedy; above 0 the
logits are divided by it, cut to the ``top_k`` largest (0 = all) and
sampled under a key folded from the engine's ``seed``, the request id
(kept per slot in the device state's ``seed``) and the position the
token will occupy (``serve.sampler.sample_tokens``, bit for bit the
reference's ``jax.random`` draws).  A sampled stream therefore depends
only on (seed, request, position): not on the batch, the slot or the
decode block size.

State is updated **in place**, unlike the reference's functional
arrays: the cache's pool rows are written with ``index_put_`` or
``copy_`` (the pool is about 1 GB at full gptneox-1b width, batch 8,
max_seq 1024, and 1.34 GB of SSM state at full mamba2-2.7b width, batch
8), and the device-resident slot state (``pos``, ``remaining``,
``last_token``, ``active``, ``seed``) with ``copy_`` and indexed
writes.

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when there is none.  Pass ``device="cpu"`` to run the plain
versions of the kernels on the host (the CPU tests do).

Quantized serving, as in the reference: ``kv_format`` (a format name,
or a tuple of one per position-in-period, which becomes
``cfg.kv_formats``) stores the KV pool as packed codes and 1-byte e8m0
scales, and the decode step reads them in the ``flash_decode_quant``
kernel; ``weight_format`` keeps the weights in a quantized store
(``self.weight_store``, bit-packed fp4 / fp6 when ``packed``) and serves
from one dense ``compute_dtype`` copy of it, as the reference's engine
does (``qmatmul`` cannot read this store: it is blocked along each
leaf's last axis, not along k).

Robustness, as in the reference.  The queue is an
:class:`~repro_torch.serve.admission.AdmissionQueue` (``admission=``: a
bounded queue with the ``reject`` / ``shed_oldest`` / ``block``
policies, ``fifo`` / ``spf`` scheduling, deadlines on the engine's
injectable clock); :meth:`ServeEngine.cancel` ends a queued request
without touching the device and an in-flight one with one slot-state
write; :meth:`ServeEngine.inject_fault` arms a logits fault as a write
to the slot's device state (``fault_pos``, ``fault_kind``: the fused
block overwrites that slot's logits when its sampling position comes,
with no host branch) or poisons the slot's cache in place
(``serve.faults``).  Every submitted request ends in exactly one of
:data:`STATUSES`: :meth:`ServeEngine.accounting` checks the identity,
:meth:`ServeEngine.watchdog_report` reconciles host and device slot
state.  ``serve.traffic`` replays seeded arrival traces through it.

Not ported yet (they raise ``NotImplementedError``): mesh serving and
speculation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import resolve_device, resolve_dtype
from repro_torch.models.model import Model, build_model
from repro_torch.serve import faults as fault_lib
from repro_torch.serve.admission import (
    AdmissionConfig, AdmissionQueue, QueueFull)
from repro_torch.serve.quant import dequantize_tree, quantize_tree
from repro_torch.serve.prng import prng_key
from repro_torch.serve.sampler import sample_tokens

# terminal request states; every submitted request ends in exactly one
STATUSES = ("ok",                  # full generation delivered
            "truncated",           # run() step budget hit mid-generation
            "shed",                # dropped by admission policy / cancel
            "deadline_exceeded",   # deadline passed (queued or in-flight)
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
    submit_t: Optional[float] = None       # engine-clock stamps (None
    first_token_t: Optional[float] = None  # where not applicable: shed
    finish_t: Optional[float] = None       # before prefill)

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
    frames: Optional[np.ndarray] = None    # enc-dec source embeddings
    patches: Optional[np.ndarray] = None   # VLM patch-prefix embeddings
    submit_t: float = 0.0                  # engine-clock stamps
    deadline_s: Optional[float] = None     # absolute (engine clock)
    first_token_t: Optional[float] = None

    @property
    def trunk_len(self) -> int:
        """Decoder-trunk length: VLM patch prefix + text tokens."""
        n_pat = 0 if self.patches is None else self.patches.shape[0]
        return n_pat + len(self.prompt)


def _put(t: torch.Tensor, slot: int, value) -> None:
    """``t[slot] = value`` for a host scalar, as a fill of the row's view:
    an indexed assignment of a host value copies it to the card, which
    synchronizes; a fill takes the value as a kernel argument."""
    t[slot].fill_(value)


def _tree_to(tree: dict, device: torch.device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServeEngine:
    """See module docstring.  ``decode_block`` is K, the number of decode
    steps fused between two host reads by :meth:`run` (1 = the per-token
    pattern).  ``enc_len``: the source positions each slot of an
    encoder-decoder pool holds (default ``max_seq``; 0 for any other
    model)."""

    def __init__(self, model: Model, params: dict, batch: int,
                 max_seq: int, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, decode_block: int = 16,
                 prefill_chunk: int = 32,
                 device=None, *, enc_len: Optional[int] = None,
                 kv_format: Any = None,
                 weight_format: Optional[str] = None, packed: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 admission: Optional[AdmissionConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 mesh: Any = None, spec: Any = None):
        for name, value in (("mesh", mesh), ("spec", spec)):
            if value is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) arrives with a later slice "
                    f"of the port")
        self.device = resolve_device(device)
        if kv_format:
            # the model's cache layer quantizes: every prefill and decode
            # write stores codes + e8m0 scales instead of K/V
            if isinstance(kv_format, (tuple, list)):
                cfg = dataclasses.replace(model.cfg,
                                          kv_formats=tuple(kv_format))
            else:
                cfg = dataclasses.replace(model.cfg, kv_format=kv_format)
            model = build_model(cfg)
        self.model = model
        params = _tree_to(params, self.device)
        self.weight_store: Optional[dict] = None
        self.weight_stats: Optional[Dict] = None
        if weight_format is not None:
            self.weight_store, self.weight_stats = quantize_tree(
                params, weight_format, packed=packed)
            params = dequantize_tree(self.weight_store, compute_dtype)
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self._temperature = temperature
        self._top_k = top_k
        # the base key; each token's key is folded from it, the request
        # id and the position on the device (serve.sampler)
        self._sample_key = prng_key(seed, self.device)
        self.decode_block = max(int(decode_block), 1)
        self.prefill_chunk = max(
            1, min(int(prefill_chunk), model.min_cache_capacity(max_seq)))
        # an enc-dec pool holds every request's source at one fixed enc_len
        self.enc_len = ((enc_len or max_seq)
                        if model.cfg.is_encoder_decoder else 0)
        self.cache = model.init_cache(batch, max_seq, self.device,
                                      enc_len=self.enc_len)
        self.kv_stats = model.kv_cache_stats(self.cache)
        self.queue = AdmissionQueue(admission)
        # injectable clock (deadlines, TTFT): a virtual clock makes
        # deadline tests and trace replays deterministic
        self._clock: Callable[[], float] = clock or time.monotonic
        self.reset()

    def reset(self) -> None:
        """Clear all serving state (cache, slots, queue, results); the
        parameters and the cache's tensors stay (reset in place).  The
        admission config survives; :meth:`set_admission` swaps it."""
        for entry in self.cache.values():
            if isinstance(entry, torch.Tensor):      # enc_out
                entry.zero_()
                continue
            for tree in entry.values():      # ring KV or SSM carries/state
                for name, leaf in tree.items():
                    if name == "slot_pos":
                        leaf.fill_(-1)
                    else:
                        leaf.zero_()
        self.state = self._init_state()
        self.slot_req: List[Optional[_Request]] = [None] * self.batch
        self.out_tokens: List[List[int]] = [[] for _ in range(self.batch)]
        self.queue = AdmissionQueue(self.queue.cfg)
        self.results: List[GenerationResult] = []
        self._next_id = 0
        self._submitted = 0
        self._deadlines_live = False
        # slots with a logits fault armed (host-known: inject_fault is
        # host-called); the fused block runs the injector only while
        # this is non-empty
        self._armed: set = set()
        self.decode_steps = 0          # fused decode steps run
        self.dispatches = 0            # decode blocks run (host reads)
        # watchdog: per-slot (token count, dispatch index) at the last
        # block that advanced the slot
        self._slot_progress: List[Tuple[int, int]] = [(0, 0)] * self.batch

    # -- clock / policy injection ---------------------------------------- #
    def _now(self) -> float:
        return self._clock()

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Swap the engine clock (deadlines, TTFT stamps)."""
        self._clock = clock

    def set_admission(self, cfg: Optional[AdmissionConfig]) -> None:
        """Swap the admission policy.  Queued requests are re-offered
        under the new policy (overflow is shed per that policy); device
        state is untouched."""
        pending = self.queue.drain()
        self.queue = AdmissionQueue(cfg)
        for req in pending:
            try:
                _, shed = self.queue.offer(req)
            except QueueFull:          # block policy: nobody to retry a
                shed = [req]           # config swap, so overflow sheds
            for r in shed:
                self._finish_unadmitted(r, "shed")
        if cfg is not None and cfg.deadline_ms is not None:
            self._deadlines_live = True

    # read-only, as in the reference (there they are traced into the
    # compiled loop): build a new engine to change them
    @property
    def temperature(self) -> float:
        return self._temperature

    @property
    def top_k(self) -> int:
        return self._top_k

    # -- device state --------------------------------------------------- #
    def _init_state(self) -> dict:
        """The slot state on the device.  ``fault_pos`` / ``fault_kind``
        arm the in-loop logits fault (disarmed at -1 / 0)."""
        b, dev = self.batch, self.device
        return {"pos": torch.zeros(b, dtype=torch.int32, device=dev),
                "remaining": torch.zeros(b, dtype=torch.int32, device=dev),
                "last_token": torch.zeros(b, dtype=torch.int32, device=dev),
                "active": torch.zeros(b, dtype=torch.bool, device=dev),
                "seed": torch.zeros(b, dtype=torch.int32, device=dev),
                "fault_pos": torch.full((b,), -1, dtype=torch.int32,
                                        device=dev),
                "fault_kind": torch.zeros(b, dtype=torch.int32, device=dev)}

    def _sample(self, logits: torch.Tensor, seed: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """Tokens (b,) from logits (b, V) for requests ``seed`` at
        positions ``pos`` (both (b,) int32 on the device)."""
        return sample_tokens(logits, self._sample_key, self.temperature,
                             self.top_k, slot_seed=seed, pos=pos)

    # -- request management -------------------------------------------- #
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None, frames=None,
               patches=None) -> int:
        """Enqueue a request through the admission policy.  The trunk
        (patch prefix + prompt) must leave room for at least one
        generated token, and ``max_new_tokens`` must be >= 1: admission
        always samples one token from the prefill logits.

        ``frames`` (s_src, d_model): the source embeddings an
        encoder-decoder model needs (s_src <= ``enc_len``), refused by
        any other model.  ``patches`` (n_patches, d_model): a vision
        frontend's patch prefix, refused without one.  Both are
        array-likes, kept on the host until admission and rounded to the
        compute dtype there.

        ``deadline_ms``: a deadline relative to now on the engine clock
        (default: the admission config's).  An expired queued request
        finishes ``deadline_exceeded`` without spending prefill; an
        expired in-flight one is cancelled with its partial tokens.

        Under a bounded queue, ``reject`` finishes the new request as
        ``shed``, ``shed_oldest`` sheds the oldest queued one, and
        ``block`` raises :class:`QueueFull` and consumes no id."""
        cfg = self.model.cfg
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {max_new_tokens}): "
                f"admission samples the first token from the prefill "
                f"logits, so a 0-token generation does not exist")
        if cfg.is_encoder_decoder:
            if frames is None:
                raise ValueError(
                    f"{cfg.name} is encoder-decoder: submit() needs "
                    f"frames=(s_src, d_model) source embeddings")
            frames = np.asarray(frames)
            if frames.ndim != 2 or frames.shape[0] < 1:
                raise ValueError(f"frames must be (s_src, d_model); got "
                                 f"{frames.shape}")
            if frames.shape[0] > self.enc_len:
                raise ValueError(
                    f"source length {frames.shape[0]} > pool enc_len "
                    f"{self.enc_len}: raise ServeEngine(enc_len=...)")
        elif frames is not None:
            raise ValueError(f"{cfg.name} is not encoder-decoder: "
                             f"frames= is not accepted")
        if patches is not None:
            if cfg.frontend != "vision":
                raise ValueError(f"{cfg.name} has no vision frontend: "
                                 f"patches= is not accepted")
            patches = np.asarray(patches)
        now = self._now()
        if deadline_ms is None:
            deadline_ms = self.queue.cfg.deadline_ms
        req = _Request(self._next_id, list(prompt), max_new_tokens,
                       frames=frames, patches=patches, submit_t=now,
                       deadline_s=(None if deadline_ms is None
                                   else now + deadline_ms / 1e3))
        if req.trunk_len >= self.max_seq:
            raise ValueError(
                f"trunk length {req.trunk_len} (prompt + patch prefix) "
                f">= max_seq {self.max_seq}: the cache holds max_seq-1 "
                f"prompt tokens plus the decode stream; truncate the "
                f"prompt or raise max_seq")
        if req.trunk_len < 1:
            raise ValueError("empty prompt")
        # offer before consuming the id: a block-policy QueueFull leaves
        # the engine as it was
        _, shed = self.queue.offer(req)
        self._next_id += 1
        self._submitted += 1
        if req.deadline_s is not None:
            self._deadlines_live = True
        for r in shed:
            self._finish_unadmitted(r, "shed")
        return req.request_id

    # -- cancellation / fault injection ---------------------------------- #
    def _slot_of(self, request_id: int) -> Tuple[int, _Request]:
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.request_id == request_id:
                return slot, req
        raise KeyError(f"request {request_id} is not in flight")

    def _cancel_update(self, slot: int) -> None:
        """Deactivate the slot, so the next fused block neither samples
        nor writes for it, and disarm its fault: fills of the slot's
        rows on the device (:func:`_put`), no host read."""
        st = self.state
        for name, value in (("remaining", 0), ("active", False),
                            ("fault_pos", -1), ("fault_kind", 0)):
            _put(st[name], slot, value)

    def cancel(self, request_id: int, status: str = "shed") -> bool:
        """Cancel a request wherever it is.  Queued: removed without
        touching the device.  In flight: the slot is deactivated
        (:meth:`_cancel_update`) and the partial tokens are delivered
        under ``status``.  Returns False when the id is unknown or
        already finished."""
        if status not in STATUSES:
            raise ValueError(f"status {status!r} not in {STATUSES}")
        req = self.queue.remove(request_id)
        if req is not None:
            self._finish_unadmitted(req, status)
            return True
        try:
            slot, _ = self._slot_of(request_id)
        except KeyError:
            return False
        self._cancel_update(slot)
        self._finish(slot, status=status)
        return True

    def inject_fault(self, request_id: int, kind: str = "logits_nan",
                     delay: int = 0, leaf: str = "k_s",
                     xor: int = 0xFF) -> None:
        """Arm a fault against an in-flight request (see
        ``serve.faults`` for the kinds and which the sentinel detects).

        ``logits_nan`` / ``logits_inf`` arm the in-loop injector: the
        fault fires when the slot samples its ``delay``-th next token (0
        = the first token of the next block).  The cache kinds
        (``e8m0_overflow``, ``kv_bitflip`` over ``leaf`` with ``xor``,
        ``state_inf``) poison the slot's cache in place, now."""
        slot, req = self._slot_of(request_id)
        if kind in fault_lib.LOGITS_FAULTS:
            if delay < 0:
                raise ValueError("delay must be >= 0")
            _put(self.state["fault_pos"], slot,
                 req.trunk_len + len(self.out_tokens[slot]) + delay)
            _put(self.state["fault_kind"], slot,
                 fault_lib.LOGITS_FAULTS[kind])
            self._armed.add(slot)
            return
        if kind not in fault_lib.CACHE_POISONERS:
            raise ValueError(
                f"unknown fault kind {kind!r}; choose from "
                f"{fault_lib.FAULT_KINDS}")
        if kind == "kv_bitflip":
            fault_lib.flip_kv_bytes(self.cache, slot, leaf=leaf, xor=xor)
        else:
            fault_lib.CACHE_POISONERS[kind](self.cache, slot)

    def _admit_update(self, logits: torch.Tensor, slot: int, plen: int,
                      max_new: int, rid: int) -> torch.Tensor:
        """The first token, sampled from the prefill logits at position
        ``plen`` under request ``rid``'s key fold (as the loop samples),
        and the slot's state write (indexed, in place).  Returns the
        token (device)."""
        seed, pos = torch.tensor([[rid], [plen]], dtype=torch.int32,
                                 device=self.device)
        tok = self._sample(logits, seed, pos)[0]
        st = self.state
        for name, value in (("seed", rid), ("pos", plen),
                            ("remaining", max_new - 1),
                            ("active", max_new > 1), ("fault_pos", -1),
                            ("fault_kind", 0)):
            _put(st[name], slot, value)
        st["last_token"][slot] = tok
        return tok

    def _embeddings(self, arr: np.ndarray) -> torch.Tensor:
        """Host embeddings (n, d_model) -> (1, n, d_model) on the device
        at the compute dtype (through float32, as the reference)."""
        return torch.from_numpy(np.asarray(arr, np.float32)[None]).to(
            self.device, resolve_dtype(self.model.cfg.compute_dtype))

    def _prefill_into_slot(self, slot: int, req: _Request) -> torch.Tensor:
        """Evict the slot's previous tenant, encode the source frames once
        (enc-dec), then stream the trunk into the slot's pool region in
        chunks: the patch prefix as embedding chunks (VLM), then the
        tokens.  Returns last-position logits (1, V)."""
        self.model.clear_slot(self.cache, slot)
        chunk = self.prefill_chunk
        if req.frames is not None:
            self.model.encode_slot(self.params, self.cache,
                                   self._embeddings(req.frames), slot,
                                   req.frames.shape[0])
        offset, logits = 0, None
        if req.patches is not None:
            n_pat = req.patches.shape[0]
            zeros = torch.zeros(chunk, dtype=torch.int32, device=self.device)
            for off in range(0, n_pat, chunk):
                part = req.patches[off:off + chunk]
                padded = np.zeros((chunk, part.shape[1]), np.float32)
                padded[:len(part)] = part
                logits = self.model.prefill_chunk(
                    self.params, self.cache, zeros, slot, off, len(part),
                    embeds=self._embeddings(padded))
            offset = n_pat
        for off in range(0, len(req.prompt), chunk):
            part = req.prompt[off:off + chunk]
            valid = len(part)
            tokens = torch.tensor(part + [0] * (chunk - valid),
                                  dtype=torch.int32, device=self.device)
            logits = self.model.prefill_chunk(self.params, self.cache,
                                              tokens, slot, offset + off,
                                              valid)
        return logits

    def _admit(self) -> None:
        for slot in range(self.batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req, expired = self.queue.take(self._now())
            for e in expired:
                # deadline passed while queued: no prefill is spent
                self._finish_unadmitted(e, "deadline_exceeded")
            if req is None:
                continue
            logits = self._prefill_into_slot(slot, req)
            tok = self._admit_update(logits, slot, req.trunk_len,
                                     req.max_new_tokens, req.request_id)
            self.slot_req[slot] = req
            self.out_tokens[slot] = [int(tok)]
            req.first_token_t = self._now()
            self._slot_progress[slot] = (1, self.dispatches)
            if req.max_new_tokens <= 1:
                self._finish(slot)

    # -- fused decode --------------------------------------------------- #
    def _decode_block(self, k: int):
        """K decode steps back to back, with no host read: decode ->
        armed fault -> non-finite sentinel -> sample at ``pos + 1`` ->
        slot bookkeeping, all on the device.  Returns (tokens (k, b),
        emit codes (k, b)) int32.

        An armed logits fault (``fault_kind`` > 0) overwrites the slot's
        logits with NaN or +inf at the step whose sampling position is
        ``fault_pos``.  A slot whose logits go non-finite emits
        EMIT_FAULT, keeps its pos/remaining/last_token, drops out of
        ``active`` in the same step (so its cache writes stop and the
        other slots are untouched) and is disarmed.  The injector runs
        only while a slot is armed (``_armed``, cleared when the slot's
        request finishes), so a run with no fault pays nothing for it."""
        st = self.state
        toks, emits = [], []
        for _ in range(k):
            active = st["active"]
            logits = self.model.decode_step(self.params, self.cache,
                                            st["last_token"], st["pos"],
                                            active=active)
            nxt = st["pos"] + 1
            if self._armed:
                kind = st["fault_kind"]
                hit = active & (kind > 0) & (st["fault_pos"] == nxt)
                bad_val = torch.where(kind == fault_lib.FAULT_INF,
                                      float("inf"), float("nan"))
                logits = torch.where(hit[:, None], bad_val[:, None].to(
                    logits.dtype), logits)
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            ok = active & ~bad
            tok = torch.where(ok, self._sample(logits, st["seed"], nxt),
                              st["last_token"])
            new_pos = torch.where(ok, nxt, st["pos"])
            new_rem = st["remaining"] - ok.to(torch.int32)
            finished = ok & ((new_rem <= 0) | (new_pos >= self.max_seq - 1))
            st["pos"].copy_(new_pos)
            st["remaining"].copy_(new_rem)
            st["last_token"].copy_(tok)
            st["active"].copy_(ok & ~finished)
            if self._armed:
                st["fault_kind"].copy_(torch.where(bad, 0, kind))
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
            first_token_t=req.first_token_t, finish_t=self._now()))
        self.slot_req[slot] = None
        self._armed.discard(slot)

    def _finish_unadmitted(self, req: _Request, status: str) -> None:
        """Account a request that never reached a slot (shed, cancelled
        while queued, or expired before prefill): no tokens."""
        self.results.append(GenerationResult(
            req.request_id, req.prompt, [], status=status,
            submit_t=req.submit_t, finish_t=self._now()))

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
            else:
                self._slot_progress[slot] = (len(self.out_tokens[slot]),
                                             self.dispatches)
        if self._deadlines_live:
            self._expire_inflight()

    def _expire_inflight(self) -> None:
        """Cancel the in-flight requests whose deadline passed: their
        partial tokens finish as ``deadline_exceeded``."""
        now = self._now()
        for slot, req in enumerate(self.slot_req):
            if (req is not None and req.deadline_s is not None
                    and now >= req.deadline_s):
                self._cancel_update(slot)
                self._finish(slot, status="deadline_exceeded")

    # -- accounting / watchdog ------------------------------------------- #
    def accounting(self) -> Dict[str, int]:
        """Request accounting.  ``balanced`` is the identity: submitted
        = ok + truncated + shed + deadline_exceeded + faulted +
        in_flight + queued."""
        by_status = {s: 0 for s in STATUSES}
        for r in self.results:
            by_status[r.status] += 1
        in_flight = sum(r is not None for r in self.slot_req)
        queued = len(self.queue)
        done = sum(by_status.values())
        return dict(by_status, submitted=self._submitted,
                    completed=by_status["ok"] + by_status["truncated"],
                    in_flight=in_flight, queued=queued,
                    balanced=(self._submitted
                              == done + in_flight + queued))

    def watchdog_report(self) -> Dict:
        """Host / device slot reconciliation (one host read; not for a
        timed region).  Flags device-active slots with no host request
        (orphans), host requests on an inactive device slot (lost
        finish), ``remaining`` < 0, ``pos`` >= max_seq, a device
        ``remaining`` other than the host's budget, and slots active
        for 3 blocks or more without a token (stuck)."""
        st = self.state
        active, pos, remaining = torch.stack(
            [st["active"].to(torch.int32), st["pos"], st["remaining"]]
        ).cpu().tolist()
        findings: List[str] = []
        for slot in range(self.batch):
            req = self.slot_req[slot]
            if req is None:
                if active[slot]:
                    findings.append(
                        f"slot {slot}: device-active with no host "
                        f"request (orphaned slot)")
                continue
            if not active[slot]:
                findings.append(
                    f"slot {slot}: host request {req.request_id} on an "
                    f"inactive device slot (lost finish)")
            if remaining[slot] < 0:
                findings.append(f"slot {slot}: remaining="
                                f"{remaining[slot]} < 0")
            if pos[slot] >= self.max_seq:
                findings.append(f"slot {slot}: pos={pos[slot]} >= max_seq "
                                f"{self.max_seq}")
            host_rem = req.max_new_tokens - len(self.out_tokens[slot])
            if active[slot] and remaining[slot] != host_rem:
                findings.append(
                    f"slot {slot}: device remaining={remaining[slot]} != "
                    f"host budget {host_rem}")
            count, seen = self._slot_progress[slot]
            if (active[slot] and self.dispatches - seen >= 3
                    and len(self.out_tokens[slot]) == count):
                findings.append(
                    f"slot {slot}: stuck — no tokens emitted for "
                    f"{self.dispatches - seen} dispatches")
        return {"ok": not findings, "findings": findings,
                "dispatches": self.dispatches}

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
