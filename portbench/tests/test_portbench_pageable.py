"""``host.pageable_mb_per_step`` on the hand-written trace and spans of
``test_portbench_program_spans``: nothing where no ``host.put_batch``
span carries a ``pageable_bytes`` count (a program without it, or the
CPU), the count's MB a step where they do, 0 included; and nothing on a
traced run of a tiny cell on the CPU."""
import dataclasses
import time

import pytest
import torch

from portbench import harness, manifest, program_spans
from portbench.tests.test_portbench_program_spans import _readings, _records
from portbench.tests.tiny import tiny_cell

NAME = "host.pageable_mb_per_step"


def _with_pageable(per_step):
    """The hand-written records, each step's ``host.put_batch`` counting
    ``per_step[i]`` pageable bytes."""
    counts = iter(per_step)
    return [dataclasses.replace(r, counts={**r.counts, "pageable_bytes": next(counts)})
            if r.name == "host.put_batch" else r for r in _records()]


@pytest.mark.parametrize("per_step, mb", [(None, None), ((0, 0), 0.0),
                                          ((1_310_720, 0), 0.65536),
                                          ((10_485_760, 10_485_760), 10.48576)])
def test_the_pageable_count_in_mb_a_step(monkeypatch, per_step, mb):
    records = _records() if per_step is None else _with_pageable(per_step)
    monkeypatch.setattr(program_spans, "port_records", lambda: records)
    got = manifest.metric_reader(NAME)(_readings())
    assert got == (None if mb is None else pytest.approx(mb))


def test_nothing_on_a_traced_run_on_the_cpu():
    cell = tiny_cell("dlrm_kaggle.b65536")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = harness.run(cell, 2 ** 40 + 11, 0.2, True, "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    assert NAME not in result["metrics"] and "host.h2d_mb_per_step" in result["metrics"]
