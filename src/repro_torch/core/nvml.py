"""The card's power, energy and clocks, read through NVML (the paper's
``nvidia-smi`` readings of §V.C and §VII).

``libnvidia-ml.so.1`` is installed with NVIDIA's GPU kernel module
(``nvidia-smi`` reads through it); it is loaded with ctypes at first
use, so this module imports on a host without it.  Nothing here falls
back: every NVML error raises :class:`NvmlError` with
``nvmlErrorString``'s text, and no reading is ever made up.

* :func:`available` -- (whether NVML loads and starts, why not);
* :class:`Device` -- the NVML device of a torch CUDA device, found by
  the device's UUID (NVML's indices need not follow CUDA's order); its
  name and UUID must equal torch's.  Readings: the energy counter (mJ
  since the kernel module loaded), power (W; NVML's own averaging window),
  the enforced power limit (W), SM and memory clocks (MHz), the
  temperature (C) and the clocks-event reasons (why the clocks are
  below their maximum: idle, the power cap, a thermal slowdown ...);
* :class:`EnergyWindow` -- a ``with`` block's energy: a thread polls
  the counter and keeps each update, and the window's joules, seconds
  and mean watts are taken between the first and the last update seen
  inside it, so that they cover whole counter periods of the block's
  own load.

It is a measurement layer beside ``core/timing.py``; the engine and the
kernels do not use it.  ``chip_smoke.py`` (phase 2r) and the card tests
do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import statistics
import threading
import time
from typing import List, Optional, Tuple

import torch

from repro_torch import compat

LIBRARY = "libnvidia-ml.so.1"
_CLOCK_SM, _CLOCK_MEM, _TEMPERATURE_GPU = 1, 2, 0

# nvmlClocksEventReason* bits (nvml.h)
REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting",
           0x4: "sw_power_cap", 0x8: "hw_slowdown", 0x10: "sync_boost",
           0x20: "sw_thermal_slowdown", 0x40: "hw_thermal_slowdown",
           0x80: "hw_power_brake_slowdown", 0x100: "display_clock_setting"}

_P = ctypes.POINTER
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, _P(ctypes.c_void_p)],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetTotalEnergyConsumption": [ctypes.c_void_p,
                                            _P(ctypes.c_ulonglong)],
    "nvmlDeviceGetPowerUsage": [ctypes.c_void_p, _P(ctypes.c_uint)],
    "nvmlDeviceGetEnforcedPowerLimit": [ctypes.c_void_p, _P(ctypes.c_uint)],
    "nvmlDeviceGetClockInfo": [ctypes.c_void_p, ctypes.c_int,
                               _P(ctypes.c_uint)],
    "nvmlDeviceGetTemperature": [ctypes.c_void_p, ctypes.c_int,
                                 _P(ctypes.c_uint)],
}
# the newer name first (NVML of release 535 on), then the one it replaced
_REASONS_FNS = ("nvmlDeviceGetCurrentClocksEventReasons",
                "nvmlDeviceGetCurrentClocksThrottleReasons")


class NvmlError(RuntimeError):
    """NVML could not be loaded, or a call failed."""


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """NVML, loaded and initialised at first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise NvmlError(f"{LIBRARY} cannot be loaded ({e}): no "
                                f"NVIDIA GPU software on this host") from None
            lib.nvmlErrorString.argtypes = [ctypes.c_int]
            lib.nvmlErrorString.restype = ctypes.c_char_p
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            for name in _REASONS_FNS:
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = [ctypes.c_void_p, _P(ctypes.c_ulonglong)]
                    fn.restype = ctypes.c_int
            _check(lib, "nvmlInit_v2", lib.nvmlInit_v2())
            _lib = lib
    return _lib


def _check(lib: ctypes.CDLL, what: str, ret: int) -> None:
    if ret != 0:
        text = lib.nvmlErrorString(ret).decode(errors="replace")
        raise NvmlError(f"{what}: {text} (NVML return {ret})")


def _call(name: str, *args) -> None:
    lib = _library()
    _check(lib, name, getattr(lib, name)(*args))


def _text(name: str, *args, size: int = 96) -> str:
    buf = ctypes.create_string_buffer(size)
    _call(name, *args, buf, size)
    return buf.value.decode()


def available() -> Tuple[bool, str]:
    """(True, NVML's library and the NVIDIA software's version) where
    NVML loads and starts, else (False, why not)."""
    try:
        return True, (f"NVML ({LIBRARY}), NVIDIA software "
                      f"{_text('nvmlSystemGetDriverVersion', size=80)}")
    except NvmlError as e:
        return False, str(e)


def nvml_uuid(torch_uuid) -> str:
    """NVML's form of a device UUID: torch gives it without the ``GPU-``
    prefix NVML wants."""
    u = str(torch_uuid)
    return u if u.startswith(("GPU-", "MIG-")) else "GPU-" + u


@dataclasses.dataclass(frozen=True)
class Readings:
    """The card's state at one moment."""
    power_w: float
    limit_w: float
    sm_mhz: int
    mem_mhz: int
    temp_c: int
    reasons: int              # nvmlClocksEventReason* bits

    @property
    def reason_names(self) -> Tuple[str, ...]:
        names = [n for bit, n in REASONS.items() if self.reasons & bit]
        rest = self.reasons & ~sum(REASONS)
        return tuple(names + ([f"0x{rest:x}"] if rest else []))

    def describe(self) -> str:
        return (f"{self.power_w:.1f} W of {self.limit_w:.1f} W, SM "
                f"{self.sm_mhz} MHz, memory {self.mem_mhz} MHz, "
                f"{self.temp_c} C, clocks-event reasons "
                f"{'|'.join(self.reason_names) or 'none'} "
                f"(0x{self.reasons:x})")


class Device:
    """The NVML device of torch CUDA device ``device`` (None: the
    current one), found by its UUID; raises if NVML's name or UUID
    differ from torch's."""

    def __init__(self, device=None):
        dev = compat.resolve_device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"NVML reads a CUDA device, not {dev}")
        _library()
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        props = torch.cuda.get_device_properties(index)
        self.index = index
        self.torch_name = props.name
        self.uuid = nvml_uuid(props.uuid)
        self.handle = ctypes.c_void_p()
        _call("nvmlDeviceGetHandleByUUID", self.uuid.encode(),
              ctypes.byref(self.handle))
        self.name = _text("nvmlDeviceGetName", self.handle)
        self.nvml_uuid = _text("nvmlDeviceGetUUID", self.handle)
        if self.name != self.torch_name or self.nvml_uuid != self.uuid:
            raise NvmlError(
                f"NVML's device {self.name!r} {self.nvml_uuid} is not "
                f"torch's cuda:{index} {self.torch_name!r} {self.uuid}")

    def _uint(self, name: str, *args) -> int:
        out = ctypes.c_uint()
        _call(name, self.handle, *args, ctypes.byref(out))
        return out.value

    def energy_mj(self) -> int:
        """The energy counter: mJ since the kernel module loaded."""
        out = ctypes.c_ulonglong()
        _call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
              ctypes.byref(out))
        return out.value

    def power_w(self) -> float:
        return self._uint("nvmlDeviceGetPowerUsage") / 1e3

    def power_limit_w(self) -> float:
        return self._uint("nvmlDeviceGetEnforcedPowerLimit") / 1e3

    def clocks_mhz(self) -> Tuple[int, int]:
        """(SM, memory) clocks now."""
        return (self._uint("nvmlDeviceGetClockInfo", _CLOCK_SM),
                self._uint("nvmlDeviceGetClockInfo", _CLOCK_MEM))

    def temperature_c(self) -> int:
        return self._uint("nvmlDeviceGetTemperature", _TEMPERATURE_GPU)

    def clocks_event_reasons(self) -> int:
        lib = _library()
        for name in _REASONS_FNS:
            fn = getattr(lib, name, None)
            if fn is not None:
                out = ctypes.c_ulonglong()
                _check(lib, name, fn(self.handle, ctypes.byref(out)))
                return out.value
        raise NvmlError(f"{LIBRARY} has none of {_REASONS_FNS}")

    def readings(self) -> Readings:
        sm, mem = self.clocks_mhz()
        return Readings(power_w=self.power_w(),
                        limit_w=self.power_limit_w(), sm_mhz=sm,
                        mem_mhz=mem, temp_c=self.temperature_c(),
                        reasons=self.clocks_event_reasons())


class EnergyWindow:
    """``with EnergyWindow(device) as w:`` -- the energy of the block.

    ``device`` is a :class:`Device` (or anything with its
    ``energy_mj()`` and ``readings()``), or a torch device to make one
    of.  A thread polls the counter every ``poll_s`` and keeps each
    update (time, mJ).  After the block: ``joules``, ``seconds`` and
    ``watts`` between the first and the last update seen in it,
    ``updates`` (counter periods they span), ``period_s`` (the median
    time between two updates seen), ``wall_s`` (the block's
    own time), ``counter_joules`` (the counter read before and after the
    block) and ``end`` (:class:`Readings` at its end).  Fewer than two
    updates inside the block raise :class:`NvmlError`: there is no
    reading to give."""

    def __init__(self, device=None, poll_s: float = 1e-3):
        self.device = device if hasattr(device, "energy_mj") \
            else Device(device)
        self.poll_s = poll_s
        self.points: List[Tuple[float, int]] = []
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _poll(self, last: int) -> None:
        try:
            while not self._stop.is_set():
                e = self.device.energy_mj()
                if e != last:
                    self.points.append((time.perf_counter(), e))
                    last = e
                time.sleep(self.poll_s)
        except Exception as e:            # raised again by __exit__
            self._error = e

    def __enter__(self) -> "EnergyWindow":
        self._e_enter = self.device.energy_mj()
        self._t_enter = time.perf_counter()
        self._thread = threading.Thread(target=self._poll,
                                        args=(self._e_enter,), daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._stop.set()
        self._thread.join()
        if exc_type is not None:
            return False
        if self._error is not None:
            raise self._error
        self.wall_s = time.perf_counter() - self._t_enter
        self.counter_joules = (self.device.energy_mj()
                               - self._e_enter) / 1e3
        self.end = self.device.readings()
        if len(self.points) < 2:
            raise NvmlError(f"the energy counter updated {len(self.points)} "
                            f"times in a {self.wall_s:.3f} s window: no "
                            f"reading")
        (t0, e0), (t1, e1) = self.points[0], self.points[-1]
        self.updates = len(self.points) - 1
        self.joules = (e1 - e0) / 1e3
        self.seconds = t1 - t0
        self.watts = self.joules / self.seconds
        self.period_s = statistics.median(
            b - a for (a, _), (b, _) in zip(self.points, self.points[1:]))
        return False
