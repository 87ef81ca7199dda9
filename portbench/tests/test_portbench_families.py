"""A model family joins the benchmark by files alone: a stub family, written
into a directory of its own beside ``portbench/families/`` and
``portbench/reference/``, with its CPU test sizes (``TINY``), its faults
(``FAULTS``, one of them its own), and layers of its own (``LAYERS``: one
by kernel prefix, one by the port span its kernels are launched in), and a
cell of it in a manifest dict. ``tiny_cell``, the control test's fault
list, ``faults.plant``, a whole run, ``Trace.parse`` and
``program_spans.align`` all find what it declares; and no module that
every family shares names a family."""
import importlib
import json
import re
import sys
import time

import pytest

from portbench import families, faults, harness, manifest, program_spans, reference, trace
from portbench.tests.tiny import cell_faults, tiny_cell
from recommender_tpu_torch.core.profiling import SpanRecord

STUB = '''"""The tests' stub family: DLRM's model under another name, with a fault
and layers of its own."""
import contextlib

from portbench.families.dlrm import (KERNELS, TINY, build, forward_macs, k1_calls, k2_calls,
                                     leaves)
from portbench.trace import Layer

FAULTS = ("frozen_state", "half_batch", "lr_doubled")
LAYERS = (Layer("recurrence", span="model.recurrence"), Layer("gates", prefixes=("gru_gates_",)))


def _double_lr(prog):
    for group in prog.state.optimizer.param_groups:
        group["lr"] *= 2


@contextlib.contextmanager
def _lr_doubled():
    yield _double_lr


OWN_FAULTS = {"lr_doubled": _lr_doubled}
'''
STUB_REFERENCE = "from portbench.reference.dlrm import loss, loss_and_grads  # noqa: F401\n"
CELL = "stub_cfg.ctr"


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """(bench, root): a checkout's files for one cell of the stub family;
    the family and its reference found by name, as any other."""
    pkg = tmp_path / manifest.PKG.name
    src = manifest.PKG
    for sub in ("configs", "traffic", "checks", "families", "reference"):
        (pkg / sub).mkdir(parents=True)
    config = json.loads((src / "configs" / "dlrm_kaggle.json").read_text())
    config["family"] = "stub"
    (pkg / "configs" / "stub_cfg.json").write_text(json.dumps(config))
    (pkg / "traffic" / "ctr.stub.json").write_text((src / "traffic" / "ctr.b8192.json").read_text())
    (pkg / "checks" / f"{CELL}.json").write_text(
        (src / "checks" / "dlrm_kaggle.b8192.json").read_text())
    (pkg / "families" / "stub.py").write_text(STUB)
    (pkg / "reference" / "stub.py").write_text(STUB_REFERENCE)
    bench = manifest.load()
    bench = {**bench,
             "configs": [{"name": "stub_cfg", "source": "the tests", "reduced": [],
                          "file": f"{pkg.name}/configs/stub_cfg.json", "why": "a stub"}],
             "workloads": [{"name": CELL, "config": "stub_cfg", "traffic": "ctr.stub", "chips": 1,
                            "why": "a stub"}]}
    monkeypatch.setattr(families, "__path__", [*families.__path__, str(pkg / "families")])
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(pkg / "reference")])
    importlib.invalidate_caches()
    yield bench, tmp_path
    for parent, name in ((families, "stub"), (reference, "stub")):
        sys.modules.pop(f"{parent.__name__}.{name}", None)
        vars(parent).pop(name, None)


def test_tiny_cell_and_the_fault_list_find_the_family(stub):
    bench, root = stub
    cell = tiny_cell(CELL, bench, root)
    assert cell.family.__name__ == "portbench.families.stub"
    model, traffic = cell.family.TINY
    assert all(cell.config["model"][k] == v for k, v in model.items())
    assert all(cell.traffic[k] == v for k, v in traffic.items())
    assert cell_faults(bench, root) == [(CELL, f) for f in ("frozen_state", "half_batch",
                                                             "lr_doubled")]


def test_plant_finds_the_familys_own_fault_then_the_shared_ones(stub):
    family = tiny_cell(CELL, *stub).family
    with faults.plant("lr_doubled", family) as plant:
        assert plant is family._double_lr
    with faults.plant("half_batch", family) as plant:
        assert plant is faults._half_batch
    with pytest.raises(KeyError):
        with faults.plant("no_such_fault", family):
            pass


@pytest.mark.parametrize("fault", [None, "lr_doubled"])
def test_a_whole_run_of_the_stub_and_its_own_fault(stub, fault):
    cell = tiny_cell(CELL, *stub)
    if fault is None:
        result = harness.run(cell, 2**31 + 23, 0.2, False, "cpu", time.perf_counter())
        assert result["correct"], result["check"]
        return
    with faults.plant(fault, cell.family) as plant:
        result = harness.run(cell, 2**31 + 23, 0.2, False, "cpu", time.perf_counter(),
                             plant=plant)
    assert not result["correct"], result["check"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


# one step: model.recurrence [200, 300] nested in model.forward [150, 400]
EVENTS = [
    _x("user_annotation", "portbench.profiled", 0, 1000),
    _x("user_annotation", "portbench.put_batch", 0, 100),
    _x("user_annotation", "portbench.train_step", 100, 800),
    _x("user_annotation", "portbench.optimizer", 600, 250),
    _x("user_annotation", "host.step", 0, 900),
    _x("user_annotation", "host.put_batch", 5, 90),
    _x("user_annotation", "model.forward", 150, 250),
    _x("user_annotation", "model.recurrence", 200, 100),
    _x("user_annotation", "model.backward", 400, 190),
    _x("user_annotation", "optimizer.step", 610, 230),
    _x("user_annotation", "ProfilerStep#3", 0, 1000),
    _x("cuda_runtime", "cudaLaunchKernel", 170, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 250, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 260, 2, correlation=3),
    _x("cuda_runtime", "cudaLaunchKernel", 270, 2, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 650, 2, correlation=5),
    _x("kernel", "ampere_sgemm_128x64_tn", 180, 20, correlation=1),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 255, 40,
       correlation=2),
    _x("kernel", "void (anonymous namespace)::chunk_sum_kernel<float>(int const*)", 300, 10,
       correlation=3),
    _x("kernel", "void gru_gates_kernel<float>(float const*)", 320, 30, correlation=4),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 700, 50,
       correlation=5),
]
# the port's records of that step (µs on the trace's clock, parents by index)
RECORDS = [("host.step", 0, 900, None), ("host.put_batch", 5, 95, 0),
           ("model.forward", 150, 400, 0), ("model.recurrence", 200, 300, 2),
           ("model.backward", 400, 590, 0), ("optimizer.step", 610, 840, 0)]


def test_a_family_layer_by_port_span_or_kernel_name(stub):
    cell = tiny_cell(CELL, *stub)
    tr = trace.Trace.parse(EVENTS, steps=1, window_span="portbench.profiled",
                           layers=cell.family.LAYERS)
    # K1 by name before any span; the gates kernel by its prefix; the
    # elementwise kernel launched inside the nested model.recurrence
    assert [o.layer for o in tr.kernels()] == ["model", "recurrence", "embedding.k1", "gates",
                                               "optimizer"]
    assert tr.seconds("recurrence") == pytest.approx(40e-6)
    assert [s[0] for s in tr.port_spans] == [n for n, *_ in RECORDS]
    assert [s[0] for s in tr.spans] == ["portbench.put_batch", "portbench.train_step",
                                        "portbench.optimizer"]
    assert tr.host_at(250) == "train_step"
    assert ["recurrence/at::native::vectorized_elementwise_kernel<4>", pytest.approx(40e-6)] \
        in tr.breakdown()["device_ops"]
    plain = trace.Trace.parse(EVENTS, steps=1, window_span="portbench.profiled")
    assert [o.layer for o in plain.kernels()] == ["model", "model", "embedding.k1", "model",
                                                  "optimizer"]


def _on(tid, event):
    return {**event, "tid": tid}


# the backward of that step on CUDA: autograd's own thread (2) launches while
# model.backward is open on the caller's (1); the recurrence's backward is
# launched once outside a model.recurrence span, once inside one opened there
BACKWARD = [
    _x("user_annotation", "portbench.profiled", 0, 1000),
    _on(1, _x("user_annotation", "model.forward", 150, 250)),
    _on(1, _x("user_annotation", "model.recurrence", 200, 100)),
    _on(1, _x("user_annotation", "model.backward", 400, 190)),
    _on(2, _x("user_annotation", "model.recurrence", 500, 50)),
    _on(1, _x("cuda_runtime", "cudaLaunchKernel", 250, 2, correlation=1)),
    _on(2, _x("cuda_runtime", "cudaLaunchKernel", 450, 2, correlation=2)),
    _on(2, _x("cuda_runtime", "cudaLaunchKernel", 520, 2, correlation=3)),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 255, 40,
       correlation=1),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 455, 30,
       correlation=2),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 525, 20,
       correlation=3),
]


def test_a_span_layer_claims_a_backward_launch_only_inside_its_own_span(stub):
    cell = tiny_cell(CELL, *stub)
    tr = trace.Trace.parse(BACKWARD, steps=1, window_span="portbench.profiled",
                           layers=cell.family.LAYERS)
    # the forward span claims the forward's launch, not the backward's made
    # on autograd's thread after it closed; the span opened in the backward
    # claims the launch made inside it
    assert [o.layer for o in tr.kernels()] == ["recurrence", "model", "recurrence"]
    assert tr.seconds("recurrence") == pytest.approx(60e-6)


def test_align_keeps_the_nested_span():
    tr = trace.Trace.parse(EVENTS, steps=1, window_span="portbench.profiled")
    records = [SpanRecord(i, name, a * 1000, b * 1000, 1, parent, {})
               for i, (name, a, b, parent) in enumerate(RECORDS)]
    a = program_spans.align(tr, 1, records)
    assert [s.name for s in a.spans] == [n for n, *_ in RECORDS[1:]]
    (rec,) = a.of("model.recurrence")
    mid = sum(a.offsets) / 2
    assert (rec.start, rec.end) == pytest.approx((200 + mid, 300 + mid))
    assert a.ms("model.forward") == pytest.approx(0.25)


SHARED_MODULES = ("tests/tiny.py", "faults.py", "trace.py", "program_spans.py",
                  "tests/test_portbench_control.py")


def _non_family_modules():
    """Every module under portbench/ but the families', the references' and
    the tests' (the named shared tests aside)."""
    out = sorted(p for p in manifest.PKG.rglob("*.py") if "__pycache__" not in p.parts
                 and p.relative_to(manifest.PKG).parts[0] not in ("families", "reference", "tests"))
    return out + [manifest.PKG / m for m in SHARED_MODULES if m.startswith("tests/")]


@pytest.mark.parametrize("path", _non_family_modules(),
                         ids=lambda p: p.relative_to(manifest.PKG).as_posix())
def test_no_shared_module_names_a_family(path):
    names = [p.stem for p in (manifest.PKG / "families").glob("*.py") if p.stem != "__init__"]
    assert names
    text = path.read_text()
    for name in names:
        assert not re.search(rf"(?<![A-Za-z]){name}", text, re.IGNORECASE), (path, name)


def test_the_named_modules_are_among_those_checked():
    checked = {p.relative_to(manifest.PKG).as_posix() for p in _non_family_modules()}
    assert set(SHARED_MODULES) <= checked
