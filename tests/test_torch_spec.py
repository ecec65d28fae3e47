"""The speculative-decoding primitives of the port against the reference,
on the CPU (``repro_torch.serve.spec``, ``models.attention.
cache_write_rows`` / ``cache_rollback``, ``models.ssm.ssm_verify_chunk``
/ ``ssm_commit_chunk``, ``Model.verify_chunk`` / ``commit_chunk`` /
``rollback_chunk``), on the reference's weights (carried across by
``repro_torch.bridge``) and inputs made with numpy from a seed.

* The n-gram functions bit for bit: ``ngram_index`` (ids near 2^31 so
  the int32 hash wraps, -1 entries), ``ngram_draft``, ``ngram_update``
  and ``seed_from_tail``.
* ``cache_write_rows`` and ``cache_rollback`` on the scripts of
  ``tests/test_rollback_property.py`` (accept-all, reject-all,
  alternating, row skew; the commit flow with ring wrap, the
  write-then-rollback flow), fp8 / fp6 / fp4: ``slot_pos`` and every
  byte under a live entry the reference's, and the oracle's that writes
  only the accepted history; the period-stacked (3-D) ``slot_pos``
  rollback the reference's.
* ``Model.verify_chunk`` logits within atol = rtol = 1e-5 of the
  reference's and of ``s`` decode steps of the port; after
  ``commit_chunk`` the cache is the reference's (ring ``slot_pos`` and
  scales equal, dense K/V and SSM parts within 1e-5, quantized codes
  equal but for rounding-boundary flips) and within 1e-5 of the port's
  own ``e`` decode steps: gptneox-1b dense / fp8 / fp4, mamba2-2.7b,
  jamba-v0.1-52b (capacity factor 8.0) and gemma2-2b with its local ring
  wrapping inside the verified block.
* One SSM layer: the state and conv carries after
  ``ssm_verify_chunk`` + ``ssm_commit_chunk`` equal, bit for bit, those
  of ``e`` ``ssm_decode`` steps on the same input.
"""

import copy
import dataclasses

import torch_modal_cases as cases
from torch_modal_cases import one_torch_thread  # noqa: F401 (fixture)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.serve import spec as ref_spec

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.serve import spec

FP4, FP8, FP6 = "float4_e2m1fn", "float8_e4m3fn", "float6_e2m3fn"


# --------------------------------------------------------------------- #
# n-gram drafting, bit for bit
# --------------------------------------------------------------------- #

def _ids(rng, shape, neg_share=0.2):
    """int32 ids: half near 2^31 (the hash wraps), half small, a share
    of -1."""
    big = rng.integers(2 ** 31 - 2 ** 20, 2 ** 31, shape)
    small = rng.integers(0, 300, shape)
    ids = np.where(rng.random(shape) < 0.5, big, small)
    return np.where(rng.random(shape) < neg_share, -1, ids).astype(np.int32)


@pytest.mark.parametrize("table", [1, 64, 512, 1000])
@pytest.mark.parametrize("context", [1, 3, 5])
def test_ngram_index_matches_reference(table, context):
    ctx = _ids(np.random.default_rng(context * 7 + table), (64, context))
    want = np.asarray(ref_spec.ngram_index(jnp.asarray(ctx), table))
    got = spec.ngram_index(torch.from_numpy(ctx), table).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_update_and_seed_match_reference(seed):
    rng = np.random.default_rng(seed)
    b, C, T, D, s = 6, 3, 64, 4, 5
    hist = _ids(rng, (b, C), 0.3)
    table = np.where(rng.random((b, T)) < 0.5, -1,
                     rng.integers(0, 300, (b, T))).astype(np.int32)
    want = np.asarray(ref_spec.ngram_draft(jnp.asarray(hist),
                                           jnp.asarray(table), D))
    got = spec.ngram_draft(torch.from_numpy(hist), torch.from_numpy(table),
                           D)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    toks = _ids(rng, (b, s), 0.0)
    valid = rng.random((b, s)) < 0.7
    wh, wt = ref_spec.ngram_update(jnp.asarray(hist), jnp.asarray(table),
                                   jnp.asarray(toks), jnp.asarray(valid))
    gh, gt = spec.ngram_update(torch.from_numpy(hist),
                               torch.from_numpy(table),
                               torch.from_numpy(toks),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))

    tail = _ids(rng, (32,), 0.0)
    tail[:rng.integers(0, 32)] = -1                  # left padding
    wh, wt = ref_spec.seed_from_tail(jnp.asarray(tail), C, T)
    gh, gt = spec.seed_from_tail(torch.from_numpy(tail), C, T)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


# --------------------------------------------------------------------- #
# cache_write_rows / cache_rollback on the rollback-property scripts
# --------------------------------------------------------------------- #

B, NKV, DH, T_MAX = 2, 2, 8, 40
_rng = np.random.default_rng(11)
TRUE_K = _rng.standard_normal((B, T_MAX + 8, NKV, DH)).astype(np.float32)
TRUE_V = _rng.standard_normal((B, T_MAX + 8, NKV, DH)).astype(np.float32)
SCRIPTS = {
    "accept_all": [(4, (4, 4))] * 10,
    "reject_all": [(3, (0, 0))] * 4 + [(4, (4, 4))] * 10,
    "alternating": [(4, (2, 2)), (3, (0, 0)), (4, (4, 4)),
                    (2, (1, 1)), (4, (3, 3))] * 4,
    "row_skew": [(4, (4, 1)), (4, (4, 0)), (3, (3, 2)),
                 (4, (2, 4))] * 6,
}


class _Port:
    """The port's cache functions behind the reference's call shape."""

    @staticmethod
    def init(cap, fmt):
        return attn.init_kv_cache(B, cap, NKV, DH, torch.bfloat16, "cpu",
                                  kv_format=fmt)

    @staticmethod
    def write(cache, k, v, positions, valid, fmt):
        return attn.cache_write_rows(
            cache, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(positions),
            None if valid is None else torch.from_numpy(valid),
            kv_format=fmt)

    @staticmethod
    def rollback(cache, positions, reject):
        return attn.cache_rollback(cache, torch.from_numpy(positions),
                                   torch.from_numpy(reject))


class _Ref:
    """The reference's, jitted (one compile a block width and format)."""
    _write = staticmethod(jax.jit(ref_attn.cache_write_rows,
                                  static_argnames=("kv_format",)))
    _rollback = staticmethod(jax.jit(ref_attn.cache_rollback))

    @staticmethod
    def init(cap, fmt):
        return ref_attn.init_kv_cache(B, cap, NKV, DH, jnp.bfloat16,
                                      kv_format=fmt)

    @classmethod
    def write(cls, cache, k, v, positions, valid, fmt):
        return cls._write(
            cache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
            None if valid is None else jnp.asarray(valid), kv_format=fmt)

    @classmethod
    def rollback(cls, cache, positions, reject):
        return cls._rollback(cache, jnp.asarray(positions),
                             jnp.asarray(reject))


def _run_script(api, fmt, cap, script, eager):
    """``tests/test_rollback_property.py::_run_script`` through ``api``:
    the commit flow (accepted rows written under ``valid``) or, with
    ``eager``, the draft flow (every row written, rejected ones with
    garbage, then rolled back)."""
    cache = api.init(cap, fmt)
    p = np.zeros(B, np.int64)
    rows = np.arange(B)[:, None]
    for blk, (s, es) in enumerate(script):
        e = np.minimum(np.minimum(np.asarray(es, np.int64), s), T_MAX - p)
        positions = (p[:, None] + np.arange(s)[None, :]).astype(np.int32)
        accept = np.arange(s)[None, :] < e[:, None]
        k, v = TRUE_K[rows, positions], TRUE_V[rows, positions]
        if eager:
            g = np.random.default_rng(1000 + blk)
            gk, gv = (g.standard_normal((B, s, NKV, DH)).astype(np.float32)
                      for _ in range(2))
            k = np.where(accept[:, :, None, None], k, gk)
            v = np.where(accept[:, :, None, None], v, gv)
            cache = api.write(cache, k, v, positions, None, fmt)
            cache = api.rollback(cache, positions, ~accept)
        else:
            cache = api.write(cache, k, v, positions, accept, fmt)
        p = p + e
    return cache, p


def _oracle(fmt, cap, p_final):
    """The port writing only the accepted history, in chunks of 4."""
    cache = _Port.init(cap, fmt)
    hi = int(p_final.max())
    rows = np.arange(B)[:, None]
    for start in range(0, hi, 4):
        s = min(4, hi - start)
        positions = np.broadcast_to(
            np.arange(start, start + s, dtype=np.int32), (B, s)).copy()
        cache = _Port.write(cache, TRUE_K[rows, positions],
                            TRUE_V[rows, positions], positions,
                            positions < p_final[:, None], fmt)
    return cache


def _live_equal(got: dict, want: dict, label: str):
    """slot_pos equal, and every payload byte under a live entry."""
    sp = cases.raw_bytes(want["slot_pos"])
    np.testing.assert_array_equal(cases.raw_bytes(got["slot_pos"]), sp,
                                  err_msg=label)
    live = sp >= 0
    for leaf in ("k_q", "k_s", "v_q", "v_s"):
        g, w = cases.raw_bytes(got[leaf]), cases.raw_bytes(want[leaf])
        assert (g[live] == w[live]).all(), f"{label}/{leaf}"


@pytest.mark.parametrize("fmt", [FP8, FP6, FP4])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("eager", [False, True])
def test_write_rows_and_rollback_match_reference(fmt, name, eager):
    """The commit flow on a ring that wraps (capacity 12), the draft flow
    on a ring that holds the history (48): the port's cache is the
    reference's and its own accepted-history oracle's."""
    cap = 48 if eager else 12
    got, p_final = _run_script(_Port, fmt, cap, SCRIPTS[name], eager)
    want, p_ref = _run_script(_Ref, fmt, cap, SCRIPTS[name], eager)
    np.testing.assert_array_equal(p_final, p_ref)
    _live_equal(got, want, f"{fmt}/{name}/reference")
    _live_equal(got, _oracle(fmt, cap, p_final), f"{fmt}/{name}/oracle")


def test_write_rows_dense_masks_rows():
    """A dense cache: masked rows keep their bytes and slot_pos, the rest
    are the reference's."""
    pos = np.array([[3, 4, 5], [10, 11, 12]], np.int32)
    valid = np.array([[True, True, False], [False, True, True]])
    k = TRUE_K[:, :3]
    got = attn.cache_write_rows(
        attn.init_kv_cache(B, 8, NKV, DH, torch.bfloat16, "cpu"),
        torch.from_numpy(k), torch.from_numpy(k), torch.from_numpy(pos),
        torch.from_numpy(valid))
    want = ref_attn.cache_write_rows(
        ref_attn.init_kv_cache(B, 8, NKV, DH, jnp.bfloat16),
        jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos), jnp.asarray(valid))
    for leaf in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(
            got[leaf].float().numpy() if leaf != "slot_pos"
            else got[leaf].numpy(),
            np.asarray(want[leaf], np.float32 if leaf != "slot_pos"
                       else np.int32))


def test_rollback_period_stacked_slot_pos():
    """The 3-D (n_periods, b, cap) branch: a pointer is cleared in every
    period where it still holds the rejected position, as the
    reference's; stale positions leave it alone."""
    rng = np.random.default_rng(5)
    sp = rng.integers(-1, 20, (3, B, 8)).astype(np.int32)
    sp[:, 0, 2], sp[1, 1, 3] = 10, 11
    positions = np.array([[10, 11, 12], [9, 11, 28]], np.int32)
    reject = np.array([[True, False, True], [True, True, True]])
    got = attn.cache_rollback({"slot_pos": torch.from_numpy(sp.copy())},
                              torch.from_numpy(positions),
                              torch.from_numpy(reject))
    want = ref_attn.cache_rollback({"slot_pos": jnp.asarray(sp)},
                                   jnp.asarray(positions),
                                   jnp.asarray(reject))
    np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                  np.asarray(want["slot_pos"]))
    assert (got["slot_pos"].numpy() != sp).any()


def test_model_rollback_touches_only_self_attention_pointers():
    """``Model.rollback_chunk`` moves only the self-attention
    ``slot_pos``: cross rings, SSM parts and payloads stay bit for bit
    (``tests/test_rollback_property.py::
    test_model_rollback_touches_only_self_attn_pointers``)."""
    for name, kw in (("seamless-m4t-medium", {"enc_len": 16}),
                     ("jamba-v0.1-52b", {}), ("gemma2-2b", {})):
        model = build_model(get_config(name).reduced())
        cache = model.init_cache(2, 32, "cpu", **kw)
        for entry in cache.values():
            for part in ("kv", "cross_kv"):
                if isinstance(entry, dict) and part in entry:
                    sp = entry[part]["slot_pos"]
                    sp.copy_(torch.arange(sp.shape[-1], dtype=torch.int32)
                             .expand_as(sp))
        before = copy.deepcopy(cache)
        model.rollback_chunk(cache, torch.arange(3, 7).expand(2, 4),
                             torch.ones((2, 4), dtype=torch.bool))
        moved = 0
        for key, entry in cache.items():
            for part, tree in (entry.items() if isinstance(entry, dict)
                               else ()):
                for leaf, t in tree.items():
                    want = before[key][part][leaf]
                    if part == "kv" and leaf == "slot_pos":
                        want = want.clone()
                        want[..., 3:7] = -1
                        moved += 1
                    assert torch.equal(t, want), (name, key, part, leaf)
        assert moved, name


# --------------------------------------------------------------------- #
# verify / commit against the reference and against decode steps
# --------------------------------------------------------------------- #

CASES = {
    "gptneox": ("gptneox-1b", {}, None),
    "gptneox-fp8": ("gptneox-1b", {}, FP8),
    "gptneox-fp4": ("gptneox-1b", {}, FP4),
    "mamba2": ("mamba2-2.7b", {}, None),
    "jamba": ("jamba-v0.1-52b", {"moe_capacity_factor": 8.0}, None),
    "gemma2": ("gemma2-2b", {}, None),
}
S_VER = 5                          # verify width: 4 drafts + 1


@pytest.fixture(scope="module")
def pairs():
    memo = {}

    def get(name, over, fmt):
        if name not in memo:
            ref_cfg = dataclasses.replace(ref_get_config(name).reduced(),
                                          **over)
            ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
            flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
            cfg = dataclasses.replace(get_config(name).reduced(), **over)
            memo[name] = (ref_cfg, ref_params, cfg,
                          bridge.params_from_numpy(flat, cfg, "cpu"))
        ref_cfg, ref_params, cfg, params = memo[name]
        kv = {"kv_format": fmt or ""}
        return (ref_build_model(dataclasses.replace(ref_cfg, **kv)),
                ref_params,
                build_model(dataclasses.replace(cfg, **kv)), params)
    return get


def _prefilled(ref_model, ref_params, model, params, prompts, max_seq=64,
               chunk=8):
    """Both caches (batch len(prompts)) with each prompt prefilled into
    its slot in chunks."""
    ref_cache = ref_model.init_cache(len(prompts), max_seq)
    cache = model.init_cache(len(prompts), max_seq, "cpu")
    prefill = jax.jit(ref_model.prefill_chunk)        # compiles once
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), chunk):
            part = prompt[off:off + chunk]
            padded = part + [0] * (chunk - len(part))
            _, ref_cache = prefill(
                ref_params, ref_cache, jnp.asarray(padded, jnp.int32),
                jnp.int32(slot), jnp.int32(off), jnp.int32(len(part)))
            model.prefill_chunk(params, cache,
                                torch.tensor(padded, dtype=torch.int32),
                                slot, off, len(part))
    return ref_cache, cache


def _check_cache(got: dict, want: dict, fmt, label: str):
    for key, entry in want.items():
        for part, tree in entry.items():
            lab = f"{label}/{key}/{part}"
            if part == "ssm":
                for leaf, w in tree.items():
                    cases.close(got[key][part][leaf], w)
            else:
                cases.check_ring(got[key][part], tree, lab, kv_format=fmt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_and_commit_match_reference_and_decode(pairs, case):
    name, over, fmt = CASES[case]
    ref_model, ref_params, model, params = pairs(name, over, fmt)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    # gemma2's local ring holds 32: row 0 verifies positions 30..34
    lens = (30, 7) if name == "gemma2-2b" else (13, 7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    ref_cache, cache = _prefilled(ref_model, ref_params, model, params,
                                  prompts)
    tokens = rng.integers(0, cfg.vocab_size, (2, S_VER)).astype(np.int32)
    positions = (np.asarray(lens, np.int32)[:, None]
                 + np.arange(S_VER, dtype=np.int32)[None, :])
    want, ref_info = ref_model.verify_chunk(
        ref_params, ref_cache, jnp.asarray(tokens), jnp.asarray(positions))
    pre = copy.deepcopy(cache)
    logits, info = model.verify_chunk(params, cache, torch.from_numpy(tokens),
                                      torch.from_numpy(positions))
    cases.close(logits, want)
    for key in pre:                                   # verify is read-only
        for part, tree in pre[key].items():
            for leaf, t in tree.items():
                assert torch.equal(cache[key][part][leaf], t), (key, leaf)

    # s decode steps of the port from the same cache
    dec = copy.deepcopy(cache)
    for j in range(S_VER):
        step = model.decode_step(params, dec, torch.from_numpy(tokens[:, j]),
                                 torch.from_numpy(positions[:, j]))
        cases.close(logits[:, j], step)

    # commit e = (2, 5): against the reference, and against e decode steps
    e = np.array([2, S_VER], np.int32)
    ref_cache = ref_model.commit_chunk(ref_cache, ref_info,
                                       jnp.asarray(positions), jnp.asarray(e))
    model.commit_chunk(cache, info, torch.from_numpy(positions),
                       torch.from_numpy(e))
    _check_cache(cache, {k: v for k, v in ref_cache.items()
                         if k.startswith("pos")}, fmt, case)
    dec = copy.deepcopy(pre)
    for j in range(S_VER):
        model.decode_step(params, dec, torch.from_numpy(tokens[:, j]),
                          torch.from_numpy(positions[:, j]),
                          active=torch.from_numpy(j < e))
    for key, entry in dec.items():
        for part, tree in entry.items():
            if part == "ssm":
                for leaf, t in tree.items():
                    cases.close(cache[key][part][leaf], t)
            else:
                cases.check_ring(cache[key][part], tree, f"{case}/decode",
                                 kv_format=fmt)


@pytest.mark.parametrize("e", [(0, 5), (1, 3), (5, 2)])
def test_ssm_commit_is_decode_bit_for_bit(pairs, e, monkeypatch):
    """One mamba2 layer on the same input: ``ssm_verify_chunk`` then
    ``ssm_commit_chunk`` leave the state and carries of ``e`` decode
    steps bit for bit, and verify's outputs are decode's.

    The input projections are the one step whose rounding depends on the
    shape (a CPU GEMM of b*s rows sums in another order than one of b
    rows), so both paths here project one position at a time: what is
    held bit for bit is everything after them, the conv windows, the
    discretization, the recurrence and the carries."""
    project = ssm._project
    monkeypatch.setattr(ssm, "_project", lambda p, x: tuple(
        torch.cat(parts, dim=1) for parts in zip(
            *(project(p, x[:, j:j + 1]) for j in range(x.shape[1])))))
    _, _, model, params = pairs("mamba2-2.7b", {}, None)
    cfg = model.cfg
    p = {k: v[0] for k, v in params["layers"]["pos0"]["ssm"].items()}
    rng = np.random.default_rng(9)
    bt = 2
    x = torch.from_numpy(rng.standard_normal((bt, S_VER, cfg.d_model))
                         .astype(np.float32))
    cache = ssm.init_ssm_cache(cfg, bt, torch.float32, "cpu")
    warm = torch.from_numpy(rng.standard_normal((bt, 1, cfg.d_model))
                            .astype(np.float32))
    for _ in range(3):                      # a non-trivial carry and state
        ssm.ssm_decode(p, warm, cache, cfg)
    dec = copy.deepcopy(cache)
    out, info = ssm.ssm_verify_chunk(p, x, cache, cfg)
    e_t = torch.tensor(e, dtype=torch.int32)
    ssm.ssm_commit_chunk(cache, info, e_t, cfg)
    for j in range(S_VER):
        step = ssm.ssm_decode(p, x[:, j:j + 1], dec, cfg,
                              active=torch.tensor([j < n for n in e]))
        # rows still decoding give verify's output at j
        for r in range(bt):
            if j < e[r]:
                cases.close(out[r, j], step[r, 0])
    for leaf, t in dec.items():
        assert torch.equal(cache[leaf], t), leaf
