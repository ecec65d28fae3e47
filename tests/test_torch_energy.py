"""The port's energy model (``repro_torch.core.energy``) against the
reference's (``repro.core.energy``), and ``ArchConfig.active_param_count``
against the reference's, on the CPU.

* ``estimate`` for each of the reference's parts (TPU v5e, GH100, GB203,
  the host CPU), every dtype key of ``ENERGY_PER_FLOP_PJ`` and one it
  lacks, with ``seconds`` None (the part's roofline), given, and 0; with
  bytes at every memory level of ``ENERGY_PER_BYTE_PJ`` and one it
  lacks, and at each level alone: every field, the ``breakdown`` and
  ``perf_per_watt`` exactly equal (the same constants and the same float
  operations in the same order).
* ``matmul_energy`` over the same parts, dtypes and ``seconds``.
* The clamp at the part's power limit: ``H100_SXM`` (700 W) held at it,
  through both packages' ``estimate`` on the same part.
* ``active_param_count`` of all eleven configs, full and reduced.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import energy as ref_energy  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import energy  # noqa: E402

PARTS = ("TPU_V5E", "GH100", "GB203", "HOST_CPU")
DTYPES = sorted(energy.ENERGY_PER_FLOP_PJ) + ["float8_e8m0fnu"]
LEVELS = sorted(energy.ENERGY_PER_BYTE_PJ) + ["nvlink"]
SECONDS = {"roofline": None, "given": 3.7e-4, "zero": 0.0}


def _same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.breakdown == want.breakdown
    assert got.perf_per_watt == want.perf_per_watt


def test_constants_are_the_reference():
    assert energy.ENERGY_PER_FLOP_PJ == ref_energy.ENERGY_PER_FLOP_PJ
    assert energy.ENERGY_PER_BYTE_PJ == ref_energy.ENERGY_PER_BYTE_PJ
    assert "float8_e8m0fnu" not in energy.ENERGY_PER_FLOP_PJ
    assert "nvlink" not in energy.ENERGY_PER_BYTE_PJ


@pytest.mark.parametrize("seconds", SECONDS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("part", PARTS)
def test_estimate_matches_reference(part, dtype, seconds):
    nbytes = {level: 1.5e6 * (i + 1) + 0.25 for i, level in
              enumerate(LEVELS)}
    kw = dict(flops=3.1e11, dtype=dtype, bytes_by_level=nbytes,
              seconds=SECONDS[seconds])
    _same(energy.estimate(getattr(core, part), **kw),
          ref_energy.estimate(getattr(ref_core, part), **kw))


@pytest.mark.parametrize("level", LEVELS + [None])
@pytest.mark.parametrize("part", PARTS)
def test_estimate_byte_levels(part, level):
    nbytes = None if level is None else {level: 7.25e8}
    kw = dict(flops=1.0e9, dtype="bfloat16", bytes_by_level=nbytes)
    _same(energy.estimate(getattr(core, part), **kw),
          ref_energy.estimate(getattr(ref_core, part), **kw))


@pytest.mark.parametrize("seconds", SECONDS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("part", PARTS)
def test_matmul_energy_matches_reference(part, dtype, seconds):
    args = (1024, 3072, 768, dtype, SECONDS[seconds])
    _same(energy.matmul_energy(getattr(core, part), *args),
          ref_energy.matmul_energy(getattr(ref_core, part), *args))


def test_clamp_at_the_power_limit():
    part = core.H100_SXM
    kw = dict(flops=2.0e15, dtype="bfloat16", bytes_by_level={"hbm": 3e12},
              seconds=1e-3)
    got = energy.estimate(part, **kw)
    assert got.dynamic_watts + part.idle_watts > part.peak_watts == 700.0
    assert got.total_watts == 700.0
    # the reference's estimate reads only the part's fields it uses
    _same(got, ref_energy.estimate(part, **kw))
    below = energy.estimate(part, flops=1e9, dtype="bfloat16", seconds=1.0)
    assert below.total_watts == below.dynamic_watts + part.idle_watts


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(REF_REGISTRY))
def test_active_param_count_matches_reference(arch, reduced):
    cfg, ref = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, ref = cfg.reduced(), ref.reduced()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.active_param_count() <= cfg.param_count()
