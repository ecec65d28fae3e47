"""Dependent-instruction chains timed with ``clock64`` (counterpart of
``repro.kernels.probe_dep_chain``, and of the jnp chains of
``repro.core.probes.compute``): the paper's §IV method.

The kernel is CUDA C++ (``repro_torch/csrc/probe_dep_chain.cu``), built
for sm_90a at first use and bound with ctypes (see ``_build``).  Each
thread carries ``ilp`` independent values through ``chain_len``
dependent inline-PTX operations bracketed by two ``%clock64`` reads.

* :func:`dep_chain`: the reference's contract, x (ilp, 8, 128) fp32 ->
  the same after ``chain_len`` serial ``x * a + b`` per value; 1024
  threads, one per (row, lane), each carrying the ilp tiles' values.
* :func:`run_chain`: one of the compute probe's workloads (``int32``,
  ``fp32``, ``fp64``, ``mixed1``, ``mixed2``) on ``lanes`` threads from
  the reference's initial values; returns the values and, on the card,
  each thread's cycles and nanoseconds.

Both dispatch on the device: on the CPU they run the plain versions
(:func:`dep_chain_plain`, :func:`chain_plain`); on a CUDA device they
launch the kernel, or raise.  ``dep_chain.launches`` counts kernel
launches of either entry point; ``dep_chain_plain.calls`` counts calls
of either plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, FrozenSet, Optional, Tuple

import torch

from repro_torch.kernels import _build

# threads of a block: lanes >= 1024 put 32 warps on each SM
MAX_BLOCK = 1024
TILE = (8, 128)

_CODE = {"fp32": 0, "int32": 1, "fp64": 2, "mixed1": 3, "mixed2": 4}
_ARGTYPES = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_double] * 2
             + [ctypes.c_int, ctypes.c_float, ctypes.c_double, ctypes.c_int]
             + [ctypes.c_void_p] * 4)

# the reference's initial values (compute._init_vals): integer chains
# start at 1 with a = 3, b = 1; float chains at 1.0001 with a = 1.0000001,
# b = 1e-7
INT_INIT = (1, 3, 1)
FLOAT_INIT = (1.0001, 1.0000001, 1e-7)


@dataclasses.dataclass
class ChainRun:
    """Values after the chain (``int``, ``float``, ``double`` as the
    workload carries them, each (ilp, lanes)) and, from the kernel, each
    thread's ``cycles`` (clock64) and ``ns`` (globaltimer) across the
    chain and its SM (``smid``); None for the plain version.
    ``unrolled``: the chain ran fully unrolled (nothing else between the
    clock reads)."""

    values: Dict[str, torch.Tensor]
    cycles: Optional[torch.Tensor] = None
    ns: Optional[torch.Tensor] = None
    smid: Optional[torch.Tensor] = None
    unrolled: bool = False


def dep_chain_plain(x: torch.Tensor, chain_len: int, a: float = 1.0001,
                    b: float = 0.5) -> torch.Tensor:
    """``chain_len`` times ``x = x * a + b`` (a multiply and an add, each
    rounded; the kernel's fma rounds once)."""
    dep_chain_plain.calls += 1
    for _ in range(chain_len):
        x = x * a + b
    return x


def dep_chain_closed_form(x: torch.Tensor, chain_len: int,
                          a: float = 1.0001, b: float = 0.5) -> torch.Tensor:
    """Oracle: x*a^n + b*(a^n-1)/(a-1)."""
    an = a ** chain_len
    return x * an + b * (an - 1.0) / (a - 1.0)


def assert_chain_close(got: Dict[str, torch.Tensor],
                       want: Dict[str, torch.Tensor], chain_len: int,
                       reference_constants: bool = True,
                       case: str = "dep_chain") -> float:
    """Holds the kernel's chain values ``got`` to the plain version's
    ``want`` (keyed as ``ChainRun.values``) after ``chain_len`` steps;
    returns the largest absolute difference.

    Integer values must be equal.  float32 values must be equal with the
    reference's constants (``reference_constants``): a = 1 + 2^-23 puts
    x * a 0.0001 ulp above the float x + 1 ulp (x in [1, 2)), and b =
    1e-7 is 0.84 ulp, so the kernel's fma (one rounding) and the plain
    version's multiply and add (two) both land on x + 2 ulps at every
    step; a chain that lost b, a or a step is off by whole ulps.  float64
    values, and float32 values under other constants (the public
    ``dep_chain``'s a = 1.0001, b = 0.5), are within (n + 1) ulps: fma
    against multiply and add differ by at most an ulp a step, and a
    close to 1 does not grow that; a lost b or step is 10^8 ulps off in
    float64."""
    if set(got) != set(want):
        raise AssertionError(f"{case}: values {sorted(got)}, want "
                             f"{sorted(want)}")
    err = 0.0
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{case}: {key} is {tuple(g.shape)} "
                                 f"{g.dtype}, want {tuple(w.shape)} "
                                 f"{w.dtype}")
        if key == "int" or (w.dtype == torch.float32
                            and reference_constants):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{case}: {key} values differ at "
                    f"{int((g != w).sum())} of {w.numel()} (exact)")
        else:
            torch.testing.assert_close(
                g, w, atol=0.0,
                rtol=(chain_len + 1) * torch.finfo(w.dtype).eps,
                msg=lambda m: f"{case}: {key} values: {m}")
        if key != "int":
            err = max(err, (g - w).abs().max().item())
    return err


def _init(workload: str, ilp: int, lanes: int, device
          ) -> Dict[str, torch.Tensor]:
    """The workload's initial values, each (ilp, lanes)."""
    def full(value, dtype):
        return torch.full((ilp, lanes), value, dtype=dtype, device=device)

    out = {}
    if workload in ("int32", "mixed1", "mixed2"):
        out["int"] = full(INT_INIT[0], torch.int32)
    if workload in ("fp32", "mixed1", "mixed2"):
        out["float"] = full(FLOAT_INIT[0], torch.float32)
    if workload == "fp64":
        out["double"] = full(FLOAT_INIT[0], torch.float64)
    return out


def chain_plain(workload: str, chain_len: int, lanes: int = 1,
                ilp: int = 1, device="cpu") -> Dict[str, torch.Tensor]:
    """The workload's chain in plain torch from the reference's initial
    values (``compute._make_chain`` / ``_make_mixed1`` /
    ``_make_mixed2``): int32 wraps, float->int32 truncates toward zero."""
    dep_chain_plain.calls += 1
    v = _init(workload, ilp, lanes, device)
    ai, bi = INT_INIT[1:]

    def consts(dtype):
        return tuple(torch.tensor(c, dtype=dtype, device=device)
                     for c in FLOAT_INIT[1:])

    if workload == "int32":
        x = v["int"]
        for _ in range(chain_len):
            x = x * ai + bi
        return {"int": x}
    if workload in ("fp32", "fp64"):
        key = "float" if workload == "fp32" else "double"
        x = v[key]
        a, b = consts(x.dtype)
        for _ in range(chain_len):
            x = x * a + b
        return {key: x}
    xi, xf = v["int"], v["float"]
    a, b = consts(torch.float32)
    if workload == "mixed1":
        for _ in range(chain_len):
            xi = xi * ai + bi
            xf = xf * a + b
        return {"int": xi, "float": xf}
    for _ in range(chain_len // 2):                      # mixed2
        xf = xf * a + xi.to(torch.float32)
        xi = (xf * 0.5).to(torch.int32) + xi
    return {"int": xi, "float": xf}


@functools.lru_cache(maxsize=None)
def timed_steps() -> FrozenSet[int]:
    """The step counts the fully unrolled timing kernel is built for,
    read from the built kernel library (the source's
    ``REPRO_TIMED_STEPS``: the Fig 2/3 ramp's lengths, 256, and their
    halves)."""
    fn = _build.load("probe_dep_chain").repro_dep_chain_timed_steps
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    n = fn(None, 0)
    out = (ctypes.c_int * n)()
    fn(out, n)
    return frozenset(out)


def _launch(workload: str, values: Dict[str, torch.Tensor], steps: int,
            from_memory: bool, af: float = FLOAT_INIT[1],
            bf: float = FLOAT_INIT[2], unrolled: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel over ``values`` (each (ilp, threads), updated in
    place; with ``from_memory`` False the kernel starts from the initial
    values instead of reading them); the float chains use ``af``, ``bf``,
    the integer chains ``INT_INIT``.  ``unrolled`` takes the fully
    unrolled timing kernel (ilp 1, initial values, ``steps`` in
    :func:`timed_steps`, the ``INT_INIT`` / ``FLOAT_INIT`` constants built
    into its instructions).  Returns each thread's (cycles, ns, smid)."""
    if unrolled and (from_memory or (af, bf) != FLOAT_INIT[1:]):
        raise ValueError("the unrolled chain starts from the initial values "
                         "with the reference's constants")
    t = next(iter(values.values()))
    ilp, threads = t.shape
    if not 1 <= ilp <= 8:
        raise ValueError(f"dep_chain kernel takes ilp 1..8, not {ilp}")
    for name, want in (("int", torch.int32), ("float", torch.float32),
                       ("double", torch.float64)):
        v = values.get(name)
        if v is not None and (v.dtype != want or not v.is_contiguous()
                              or v.shape != t.shape
                              or v.device != t.device):
            raise ValueError(f"dep_chain: {name} values must be contiguous "
                             f"{want} of shape {tuple(t.shape)} on "
                             f"{t.device}")
    lib = _build.load("probe_dep_chain")
    fn = lib.repro_dep_chain
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    cycles = torch.empty(threads, dtype=torch.int64, device=t.device)
    ns = torch.empty(threads, dtype=torch.int64, device=t.device)
    smid = torch.empty(threads, dtype=torch.int32, device=t.device)

    def ptr(name):
        v = values.get(name)
        return None if v is None else v.data_ptr()

    block = min(threads, MAX_BLOCK)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(_CODE[workload], int(unrolled), ilp, steps, threads, block,
                 int(from_memory), ptr("int"), ptr("float"), ptr("double"),
                 INT_INIT[1], INT_INIT[2], af, bf, af, bf, INT_INIT[0],
                 FLOAT_INIT[0], FLOAT_INIT[0], 0, cycles.data_ptr(),
                 ns.data_ptr(), smid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dep_chain kernel launch failed: error {err}")
    dep_chain.launches += 1
    return cycles, ns, smid


def run_chain(workload: str, chain_len: int, lanes: int = 1,
              ilp: int = 1, device="cuda") -> ChainRun:
    """One compute-probe chain on ``lanes`` threads (``lanes == 1``: true
    latency; ``lanes == 4096``: 4 blocks of 1024 threads, completion
    latency).  CPU: the plain version, no cycles; CUDA: the kernel, with
    the values starting from its parameters (no load in the timed
    region), fully unrolled where ``ilp == 1`` and the step count is in
    :func:`timed_steps`, else the looped kernel (its cycles then include
    loop control)."""
    if workload not in _CODE:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(_CODE)}")
    device = torch.device(device)
    if device.type == "cpu":
        return ChainRun(chain_plain(workload, chain_len, lanes, ilp,
                                    device))
    if device.type != "cuda":
        raise ValueError(f"run_chain runs on 'cuda' (kernel) or 'cpu' "
                         f"(plain version), not {device}")
    values = _init(workload, ilp, lanes, device)
    steps = chain_len // 2 if workload == "mixed2" else chain_len
    unrolled = ilp == 1 and steps in timed_steps()
    cycles, ns, smid = _launch(workload, values, steps, False,
                               unrolled=unrolled)
    return ChainRun(values, cycles, ns, smid, unrolled)


def dep_chain(x: torch.Tensor, chain_len: int, ilp: int = 1,
              a: float = 1.0001, b: float = 0.5) -> torch.Tensor:
    """x (ilp, 8, 128) fp32 -> the same shape after ``chain_len`` serial
    ``x * a + b`` per value (the ilp tiles are mutually independent:
    the ILP axis).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (fma: one rounding per step)."""
    if tuple(x.shape) != (ilp,) + TILE or x.dtype != torch.float32:
        raise ValueError(f"dep_chain takes x ({ilp}, 8, 128) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return dep_chain_plain(x, chain_len, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"dep_chain runs on 'cuda' (kernel) or 'cpu' "
                         f"(plain version), not {x.device}")
    out = x.reshape(ilp, -1).clone()
    _launch("fp32", {"float": out}, chain_len, True, a, b)
    return out.view(x.shape)


dep_chain.launches = 0
dep_chain_plain.calls = 0
