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

Speculative decoding, as in the reference (``spec=``, a
:class:`~repro_torch.serve.spec.SpecConfig`): each fused step becomes a
block that drafts ``draft_tokens`` tokens (n-gram tables kept per slot
on the device, a small draft model sharing the slot protocol, or a
scripted ``draft_fn``), scores them with the last committed token in
one ``Model.verify_chunk`` pass, samples the true tokens from those
logits under the same per-(request, position) keys, keeps the prefix
the drafts predicted plus one, commits it (``Model.commit_chunk``) and
rolls the draft model's rejected writes back (``Model.rollback_chunk``).
Greedy and sampled streams are the non-speculative engine's; drafts
decide only how many tokens a block keeps.  The block makes no host
read; :meth:`ServeEngine.spec_report` counts from the one read a
dispatch makes.

Not ported yet (it raises ``NotImplementedError``): mesh serving.
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
from repro_torch.serve import spec as spec_lib
from repro_torch.serve.admission import (
    AdmissionConfig, AdmissionQueue, QueueFull)
from repro_torch.serve.quant import dequantize_tree, quantize_tree
from repro_torch.serve.prng import prng_key
from repro_torch.serve.sampler import sample_tokens, sample_tokens_chunk
from repro_torch.serve.spec import SpecConfig

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
    """``tree`` on ``device``, detached: serving takes no gradient, and a
    trained parameter that requires grad would otherwise tie every cache
    write into one growing autograd graph."""
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.detach().to(device) for k, v in tree.items()}


def _reset_cache(cache: dict) -> None:
    """Empty a pooled cache in place: ring ``slot_pos`` -1, every other
    leaf (payload, SSM carries and state, ``enc_out``) zero."""
    for entry in cache.values():
        if isinstance(entry, torch.Tensor):          # enc_out
            entry.zero_()
            continue
        for tree in entry.values():      # ring KV or SSM carries/state
            for name, leaf in tree.items():
                if name == "slot_pos":
                    leaf.fill_(-1)
                else:
                    leaf.zero_()


def _check_draft_model(target: Model, draft: Model) -> None:
    """The reference's restrictions on a draft model and its target."""
    dcfg, cfg = draft.cfg, target.cfg
    if (dcfg.is_encoder_decoder or dcfg.frontend == "vision"
            or any(blk.mixer != "attn" or blk.cross_attn
                   for blk in dcfg.block_pattern())):
        raise ValueError(
            f"draft model {dcfg.name} must be a plain decoder-only "
            f"attention LM (the draft leg reuses the ring slot_pos "
            f"rollback, which only attention caches support)")
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise ValueError(
            f"draft-model speculation needs a plain decoder-only target "
            f"(got {cfg.name}); n-gram drafting covers the other families")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft vocab {dcfg.vocab_size} != target vocab "
                         f"{cfg.vocab_size}")


class ServeEngine:
    """See module docstring.  ``decode_block`` is K, the number of decode
    steps fused between two host reads by :meth:`run` (1 = the per-token
    pattern).  ``enc_len``: the source positions each slot of an
    encoder-decoder pool holds (default ``max_seq``; 0 for any other
    model).  ``spec``: a :class:`SpecConfig` turns speculative decoding
    on (see module docstring)."""

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
                 mesh: Any = None, spec: Optional[SpecConfig] = None):
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=...) arrives with a later slice of the "
                "port")
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
        # speculative decoding: a draft model keeps a pooled cache of its
        # own, prefilled through the same chunk stream as the target's
        self.spec = spec
        self._draft_model: Optional[Model] = None
        self._draft_params: Optional[dict] = None
        self._draft_cache: Optional[dict] = None
        if spec is not None and spec.draft_model is not None:
            _check_draft_model(model, spec.draft_model)
            self._draft_model = spec.draft_model
            self._draft_params = _tree_to(spec.draft_params, self.device)
            self._draft_cache = self._draft_model.init_cache(
                batch, max_seq, self.device)
            self.prefill_chunk = max(1, min(
                self.prefill_chunk,
                self._draft_model.min_cache_capacity(max_seq)))
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
        _reset_cache(self.cache)
        if self._draft_cache is not None:
            _reset_cache(self._draft_cache)
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
        # engine-lifetime speculation totals (spec_report), counted from
        # the codes each dispatch reads anyway
        self._spec_tokens = 0
        self._spec_blocks = 0
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
        arm the in-loop logits fault (disarmed at -1 / 0).  A speculative
        engine adds each slot's n-gram history and table (``spec_hist``
        (b, ngram_context), ``spec_ngram`` (b, ngram_table), -1 empty)
        and its tenant's tokens committed and blocks run
        (``spec_accept``, ``spec_blocks``)."""
        b, dev = self.batch, self.device
        state = {"pos": torch.zeros(b, dtype=torch.int32, device=dev),
                "remaining": torch.zeros(b, dtype=torch.int32, device=dev),
                "last_token": torch.zeros(b, dtype=torch.int32, device=dev),
                "active": torch.zeros(b, dtype=torch.bool, device=dev),
                "seed": torch.zeros(b, dtype=torch.int32, device=dev),
                "fault_pos": torch.full((b,), -1, dtype=torch.int32,
                                        device=dev),
                "fault_kind": torch.zeros(b, dtype=torch.int32, device=dev)}
        if self.spec is not None:
            sp = self.spec
            state["spec_hist"] = torch.full((b, sp.ngram_context), -1,
                                            dtype=torch.int32, device=dev)
            state["spec_ngram"] = torch.full((b, sp.ngram_table), -1,
                                             dtype=torch.int32, device=dev)
            state["spec_accept"] = torch.zeros(b, dtype=torch.int32,
                                               device=dev)
            state["spec_blocks"] = torch.zeros(b, dtype=torch.int32,
                                               device=dev)
        return state

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
        if self._draft_cache is not None:
            self._draft_model.clear_slot(self._draft_cache, slot)
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
            if self._draft_cache is not None:
                # a draft model's target is decoder-only: offset is 0
                self._draft_model.prefill_chunk(
                    self._draft_params, self._draft_cache, tokens, slot,
                    offset + off, valid)
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
            if self.spec is not None:
                self._spec_admit(slot, req.prompt, self.out_tokens[slot][0])
            req.first_token_t = self._now()
            self._slot_progress[slot] = (1, self.dispatches)
            if req.max_new_tokens <= 1:
                self._finish(slot)

    def _spec_admit(self, slot: int, prompt: List[int], first: int) -> None:
        """Seed the slot's n-gram history and table from the last
        ``prompt_tail`` prompt tokens and the first sampled token
        (``spec.seed_from_tail``; the first token is committed already),
        and zero its acceptance counts.  The seeding runs on host tensors
        (all of it is host-known) and lands in the slot's rows by a
        ``copy_`` into their views."""
        sp, st = self.spec, self.state
        got = prompt[-sp.prompt_tail:] if sp.prompt_tail else []
        tail = np.full(sp.prompt_tail + 1, -1, np.int32)
        tail[sp.prompt_tail - len(got):sp.prompt_tail] = got
        tail[-1] = first
        hist, table = spec_lib.seed_from_tail(
            torch.from_numpy(tail), sp.ngram_context, sp.ngram_table)
        st["spec_hist"][slot].copy_(hist, non_blocking=True)
        st["spec_ngram"][slot].copy_(table, non_blocking=True)
        _put(st["spec_accept"], slot, 0)
        _put(st["spec_blocks"], slot, 0)

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

    # -- speculative decode --------------------------------------------- #
    def _draft(self) -> torch.Tensor:
        """(b, D) int32 drafts: ``draft_fn`` of the state, else D greedy
        decode steps of the draft model (its cache written eagerly, rolled
        back after acceptance), else the slots' n-gram tables."""
        sp, st = self.spec, self.state
        D = sp.draft_tokens
        if sp.draft_fn is not None:
            return sp.draft_fn(st).to(torch.int32)
        if self._draft_cache is None:
            return spec_lib.ngram_draft(st["spec_hist"], st["spec_ngram"], D)
        tok, pos, drafts = st["last_token"], st["pos"], []
        for _ in range(D):
            logits = self._draft_model.decode_step(
                self._draft_params, self._draft_cache, tok, pos,
                active=st["active"])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def _spec_block(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One speculative block of s = D+1 token positions, with no host
        read: draft -> verify -> armed fault -> sample the true tokens ->
        acceptance -> sentinel -> commit -> draft rollback -> slot
        bookkeeping -> n-gram update.  Returns (tokens (b, s), emit codes
        (b, s)) int32.

        Row j of the verify scores position pos + j and samples the token
        of position pos + j + 1 under that position's key.  A row keeps e
        = min(leading drafts that match + 1, remaining, max_seq-1-pos)
        tokens (0 when inactive).  An armed logits fault poisons the row
        whose sampling position is ``fault_pos`` (only while a slot is
        armed, as in :meth:`_decode_block`); the first non-finite row
        inside the kept prefix cuts it there, emits EMIT_FAULT after the
        survivors and drops the slot out of ``active``.  The target's
        rejected rows are never written; the draft model's are rolled
        back."""
        st, D = self.state, self.spec.draft_tokens
        s = D + 1
        active, P = st["active"], st["pos"]
        drafts = self._draft()
        tokens = torch.cat([st["last_token"][:, None], drafts], dim=1)
        cols = torch.arange(s, dtype=torch.int32, device=self.device)[None]
        positions = P[:, None] + cols
        logits, info = self.model.verify_chunk(self.params, self.cache,
                                               tokens, positions)
        q_pos = positions + 1
        if self._armed:
            kind = st["fault_kind"]
            hit = ((active & (kind > 0))[:, None]
                   & (st["fault_pos"][:, None] == q_pos))
            bad_val = torch.where(kind == fault_lib.FAULT_INF, float("inf"),
                                  float("nan")).to(logits.dtype)
            logits = torch.where(hit[..., None], bad_val[:, None, None],
                                 logits)
        toks = sample_tokens_chunk(logits, self._sample_key,
                                   self.temperature, self.top_k,
                                   slot_seed=st["seed"], pos=q_pos)
        match = (drafts == toks[:, :D]).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        e0 = torch.minimum(m + 1, st["remaining"])
        e0 = torch.minimum(e0, (self.max_seq - 1 - P).clamp_min(0))
        e0 = torch.where(active, e0, 0)
        # sentinel: the first non-finite row inside the kept prefix
        bad_rows = active[:, None] & ~torch.isfinite(logits).all(dim=-1)
        first_bad = torch.where(bad_rows, cols, s).amin(dim=1)
        fault = active & (first_bad < e0)
        e = torch.where(fault, first_bad, e0).to(torch.int32)
        self.model.commit_chunk(self.cache, info, positions, e)
        if self._draft_cache is not None:
            self._draft_model.rollback_chunk(
                self._draft_cache, positions[:, :D], cols[:, :D] >= e[:, None])
        keep = cols < e[:, None]
        last = toks.gather(1, (e - 1).clamp_min(0).long()[:, None])[:, 0]
        new_pos = P + e
        new_rem = st["remaining"] - e
        finished = active & ~fault & ((new_rem <= 0)
                                      | (new_pos >= self.max_seq - 1))
        hist, table = spec_lib.ngram_update(st["spec_hist"],
                                            st["spec_ngram"], toks, keep)
        st["last_token"].copy_(torch.where(e > 0, last, st["last_token"]))
        st["pos"].copy_(new_pos)
        st["remaining"].copy_(new_rem)
        st["active"].copy_(active & ~fault & ~finished)
        if self._armed:
            st["fault_kind"].copy_(torch.where(fault, 0, kind))
        st["spec_hist"].copy_(hist)
        st["spec_ngram"].copy_(table)
        st["spec_accept"].add_(e)
        st["spec_blocks"].add_(active.to(torch.int32))
        emit = torch.where(keep, EMIT_TOKEN, EMIT_NONE)
        emit = torch.where(fault[:, None] & (cols == e[:, None]), EMIT_FAULT,
                           emit)
        return toks, emit.to(torch.int32)

    def _dispatch_spec(self, k: int) -> int:
        """ceil(k / (D+1)) speculative blocks and their one host read;
        returns the token positions they cover.  The codes of that read
        give the engine totals of :meth:`spec_report`: a (block, slot)
        cell is a run block when any of its codes is not EMIT_NONE."""
        s = self.spec.draft_tokens + 1
        n_blocks = max(1, -(-k // s))
        toks, emits = zip(*(self._spec_block() for _ in range(n_blocks)))

        def rows(blocks):      # n_blocks x (b, s) -> (n_blocks * s, b)
            return torch.stack(blocks).transpose(1, 2).reshape(
                n_blocks * s, self.batch)

        self.decode_steps += n_blocks * s
        codes = self._harvest(rows(toks), rows(emits))
        self._spec_tokens += int((codes == EMIT_TOKEN).sum())
        self._spec_blocks += int(
            (codes.reshape(n_blocks, s, -1) != EMIT_NONE).any(axis=1).sum())
        return n_blocks * s

    def spec_report(self) -> Dict:
        """Engine-lifetime speculation totals, as the reference's:
        ``mean_accepted_len`` is tokens committed a run block (1.0: no
        draft was ever accepted; draft_tokens+1: every block kept
        whole)."""
        blocks = self._spec_blocks
        return {"enabled": self.spec is not None,
                "draft_tokens": (0 if self.spec is None
                                 else self.spec.draft_tokens),
                "blocks": blocks,
                "accepted_tokens": self._spec_tokens,
                "mean_accepted_len": (self._spec_tokens / blocks
                                      if blocks else 0.0)}

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
        """One fused block of K decode steps and its one host read (a
        speculative engine: :meth:`_dispatch_spec`).  Returns the decode
        steps spent."""
        if self.spec is not None:
            return self._dispatch_spec(k)
        toks, emitted = self._decode_block(k)
        self.decode_steps += k
        self._harvest(toks, emitted)
        return k

    def _harvest(self, toks: torch.Tensor, emitted: torch.Tensor
                 ) -> np.ndarray:
        """Block-boundary host pass: ONE device->host read of the (k, b)
        tokens, codes and the active mask, then per-slot extend / finish
        / fault bookkeeping.  A faulted slot keeps the tokens it emitted
        before the sentinel tripped, finishes ``faulted``, and is evicted
        through ``clear_slot`` (from the draft model's cache too).
        Returns the host codes (k, b)."""
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
                if self._draft_cache is not None:
                    self._draft_model.clear_slot(self._draft_cache, slot)
            elif not active_after[slot]:
                self._finish(slot)
            else:
                self._slot_progress[slot] = (len(self.out_tokens[slot]),
                                             self.dispatches)
        if self._deadlines_live:
            self._expire_inflight()
        return codes_h

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
