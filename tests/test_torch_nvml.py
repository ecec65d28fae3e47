"""The port's NVML readings (``repro_torch.core.nvml``) on a host without
a card, where nothing may come back in place of a reading.

* Without the library, :func:`available` says False and why, and a
  :class:`Device` raises ``NvmlError``; with no CUDA device,
  ``EnergyWindow()`` refuses before it reads anything.
* :class:`EnergyWindow` on a stand-in device whose counter moves 2 J
  every 20 ms (100 W): the update count, joules, seconds and watts taken
  between the first and last updates seen, and the period between
  updates; a counter that never moves, and a counter whose read fails,
  raise.
* The UUID's NVML form, and the clocks-event reasons' names.

The readings on the card: ``tests/test_torch_cuda.py`` (marker
``cuda``).
"""

import time

import pytest
import torch

from repro_torch.core import nvml


@pytest.fixture
def no_library(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    monkeypatch.setattr(nvml, "_lib", None)


def test_unavailable_without_the_library(no_library, monkeypatch):
    ok, why = nvml.available()
    assert ok is False and "libnvidia-ml-absent.so.1" in why
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(nvml.NvmlError, match="cannot be loaded"):
        nvml.Device("cuda:0")


def test_this_host_reports_why():
    ok, why = nvml.available()
    assert isinstance(ok, bool) and why


def test_energy_window_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nvml.EnergyWindow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nvml.Device()


class _Counter:
    """A stand-in device: the counter moves by ``step_mj`` every
    ``period`` s from its creation (0: never); ``readings()`` a fixed
    state."""

    def __init__(self, period=0.005, step_mj=500, fail_after=None):
        self.t0, self.period, self.step = time.perf_counter(), period, step_mj
        self.reads, self.fail_after = 0, fail_after

    def energy_mj(self):
        self.reads += 1
        if self.fail_after is not None and self.reads > self.fail_after:
            raise nvml.NvmlError("nvmlDeviceGetTotalEnergyConsumption: "
                                 "GPU is lost (NVML return 15)")
        if not self.period:
            return 1234
        return 10 ** 6 + self.step * int((time.perf_counter() - self.t0)
                                         / self.period)

    def readings(self):
        return nvml.Readings(power_w=101.5, limit_w=700.0, sm_mhz=1980,
                             mem_mhz=2619, temp_c=41, reasons=0x1)


def test_energy_window_between_counter_updates():
    """A poll that comes late (a loaded host) may see two updates as
    one: the update count is then low, while the joules and seconds
    between the first and last updates seen stay right."""
    with nvml.EnergyWindow(_Counter(period=0.02, step_mj=2000),
                           poll_s=1e-3) as w:
        time.sleep(0.6)
    assert 15 <= w.updates <= 31
    assert w.joules >= 2.0 * w.updates and (w.joules / 2.0).is_integer()
    assert w.seconds == pytest.approx(w.joules / 100.0, rel=0.1)
    assert w.watts == pytest.approx(100.0, rel=0.1)
    assert w.period_s == pytest.approx(0.02, rel=0.25)
    assert w.wall_s >= w.seconds and w.counter_joules >= w.joules
    assert w.end.reason_names == ("gpu_idle",)
    assert [e for _, e in w.points] == sorted({e for _, e in w.points})


def test_energy_window_without_updates_raises():
    with pytest.raises(nvml.NvmlError, match="updated 0 times"):
        with nvml.EnergyWindow(_Counter(period=0), poll_s=5e-4):
            time.sleep(0.05)


def test_energy_window_read_error_raises():
    with pytest.raises(nvml.NvmlError, match="GPU is lost"):
        with nvml.EnergyWindow(_Counter(fail_after=3), poll_s=5e-4):
            time.sleep(0.05)


def test_energy_window_keeps_the_block_error():
    with pytest.raises(ZeroDivisionError):
        with nvml.EnergyWindow(_Counter(), poll_s=5e-4):
            1 / 0


def test_uuid_and_reasons():
    u = "5b2ef7ad-3d6c-19fa-2ac9-1c08d4bd6b1f"
    assert nvml.nvml_uuid(u) == "GPU-" + u
    assert nvml.nvml_uuid("GPU-" + u) == "GPU-" + u
    r = nvml.Readings(power_w=690.0, limit_w=700.0, sm_mhz=1755,
                      mem_mhz=2619, temp_c=60, reasons=0x4 | 0x20 | 0x1000)
    assert r.reason_names == ("sw_power_cap", "sw_thermal_slowdown",
                              "0x1000")
    assert "sw_power_cap|sw_thermal_slowdown|0x1000 (0x1024)" in r.describe()
    assert nvml.Readings(1.0, 2.0, 3, 4, 5, 0).reason_names == ()
