"""The control, the reference in fp8 put in the port's place, and the
half-batch fault come out not correct against each cell's limits: on the
CPU at the port's tiny CLIP, and (marked ``gpu``) on the card at the
cells' own sizes on three seeds."""

import tempfile

import pytest

from cmhbench import control, spec
from cmhbench.run import context
from cmhbench.tests import tiny

READ = {"train": control.train_readings, "search": control.search_readings,
        "valid": control.valid_readings}
TINY = {"dcmht-vitb32-train": ("train-b256", dict(batch=16, min_tokens=4, max_tokens=12,
                                                  reference_chunk=8)),
        "dcmht-vitl14-train": ("train-b100", dict(batch=16, min_tokens=4, max_tokens=12,
                                                  reference_chunk=8)),
        "dcmht-vitb32-search": ("search-text-poisson", dict(rate=40, check_requests=16)),
        "dcmht-vitb32-valid": ("valid-mirflickr", dict(query=50, retrieval=150, batch=32,
                                                       make_chunk=64, reference_chunk=64))}


def fails_a_limit(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_at_the_tiny_size(cell):
    name, changes = TINY[cell]
    tr = tiny.traffic(name, **changes)
    limits = spec.limits(cell)
    with tempfile.TemporaryDirectory() as d:
        readings = READ[tr["kind"]](tiny.context(tiny.config(), tr, d, limits, seed=3,
                                                 seconds=1.0))
    for what in readings.values():
        assert fails_a_limit(what, limits), readings


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(c["name"] for c in spec.load()["workloads"]))
def test_control_fails_at_the_cells_size(cell, card):
    bench = spec.load()
    entry = spec.cell(bench, cell)
    for seed in (2147483911, 2147483912, 2147483913):
        with tempfile.TemporaryDirectory() as d:
            ctx = context(bench, entry, seed, bench["run_seconds"], False, 0.0, d)
            readings = READ[ctx.traffic["kind"]](ctx)
        for what in readings.values():
            assert fails_a_limit(what, ctx.limits), (seed, readings)
