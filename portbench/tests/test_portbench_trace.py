"""The reduction of a profiler trace to the per-layer metrics, on a
trace written by hand."""
import pytest

from portbench import manifest, trace
from portbench.harness import Readings
from portbench.tests.tiny import tiny_cell


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "portbench.profiled", 0, 1000),
    _x("user_annotation", "portbench.put_batch", 0, 100),
    _x("user_annotation", "portbench.train_step", 100, 800),
    _x("user_annotation", "portbench.optimizer", 600, 250),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 650, 5, correlation=3),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 40, correlation=9),
    _x("kernel", "ampere_sgemm_128x64_tn", 200, 100, correlation=1),
    _x("kernel", "void chunk_sum_kernel<__nv_bfloat16>(int const*, __nv_bfloat16 const*)", 300, 50,
       correlation=4),
    _x("kernel", "void (anonymous namespace)::flash_bwd_fused_kernel<16>(float const*)", 350, 150,
       correlation=5),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 700, 100,
       correlation=3),
    _x("kernel", "outside", 2000, 10, correlation=2),
]


def test_kernel_names():
    assert trace.base_name("void (anonymous namespace)::join_kernel<float>(int const*)") \
        == "join_kernel"
    assert trace.base_name("void at::native::(anonymous namespace)::join_kernel<4>(int)") \
        == "at::native::join_kernel"
    assert trace.short_name("void (anonymous namespace)::flash_fwd_long_kernel<16, false>"
                            "(float const*)") == "flash_fwd_long_kernel<16, false>"


def test_layers_and_times():
    tr = trace.Trace.parse(EVENTS, steps=1, window_span="portbench.profiled")
    assert [o.layer for o in tr.kernels()] == ["model", "embedding.k1", "attention.k2",
                                               "optimizer"]
    assert tr.seconds("model") == pytest.approx(100e-6)
    assert tr.seconds("optimizer") == pytest.approx(100e-6)
    # busy: [50, 90), [200, 500), [700, 800)
    assert tr.busy_s() == pytest.approx(440e-6) and tr.window_s() == pytest.approx(1000e-6)
    gaps = tr.idle_gaps()
    assert gaps == [(0, 50), (90, 200), (500, 700), (800, 1000)]
    assert tr.host_at(95) == "put_batch" and tr.host_at(950) == "outside_steps"
    assert tr.host_at(650) == "optimizer" and tr.host_at(550) == "train_step"
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "attention.k2/flash_bwd_fused_kernel<16>"
    assert b["idle_gaps"][:2] == [["optimizer", pytest.approx(200e-6)],
                                  ["outside_steps", pytest.approx(200e-6)]]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_metric_readers():
    cell = tiny_cell("bst_taobao.T1000_b1024")
    tr = trace.Trace.parse(EVENTS, steps=1, window_span="portbench.profiled")
    batch = cell.generator.pool(cell.traffic, cell.config["model"], 1, 1)[0]
    r = Readings(trace=tr, steps=1, batches=[batch], model=cell.config["model"],
                 traffic=cell.traffic, family=cell.family, examples_per_s=1000.0)
    got = {m["name"]: manifest.metric_reader(m["name"])(r) for m in cell.per_layer}
    assert got["host.launches_per_step"] == 4
    assert got["model.device_ms_per_step"] == pytest.approx(0.1)
    assert got["optimizer.device_ms_per_step"] == pytest.approx(0.1)
    assert got["device.idle_share"] == pytest.approx(56.0)
    assert 0 < got["embedding.k1_roofline"] and 0 < got["attention.k2_roofline"]
    assert 0 < got["step.mfu"] < 100


def test_readers_return_nothing_where_nothing_ran():
    events = [e for e in EVENTS if "chunk_sum" not in e["name"] and "flash" not in e["name"]]
    tr = trace.Trace.parse(events, steps=1, window_span="portbench.profiled")
    cell = tiny_cell("dlrm_kaggle.b65536")
    r = Readings(trace=tr, steps=1, batches=[], model=cell.config["model"],
                 traffic=cell.traffic, family=cell.family, examples_per_s=1.0)
    assert manifest.metric_reader("embedding.k1_roofline")(r) is None
    assert manifest.metric_reader("attention.k2_roofline")(r) is None
