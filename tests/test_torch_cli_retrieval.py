"""The port's retrieval entry points on the CPU: ``cli.train_pinsage`` and
``cli.train_twotower`` on their synthetic sets (the final hit-rate line,
K1 calls a step, ``--resume`` bit for bit against the straight run, the
three exports) and ``cli.serve`` on each bundle (``--items``, ``--all
--out``, ``--probes`` with its gather cap); the synthetic sets and first
batches against the JAX entry points'; the JAX parsers' flags and
defaults; the card needed by default; no jax import. The ``cuda`` tests
(skipped here) run the int8 product's padding and the entry points on the
card; jax is imported inside the tests that use it, so that they also run
where jax is not installed:

    python -m pytest tests/test_torch_cli_retrieval.py -m cuda --noconftest
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from recommender_tpu_torch.cli import serve, train_pinsage, train_twotower
from recommender_tpu_torch.ops import embedding_kernels
from recommender_tpu_torch.retrieval import export, quantize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMMON = ["--device", "cpu", "--log_every", "10", "--eval_every", "0"]
PINSAGE = ["--synthetic", "--learning_rate", "3e-3"]
TWOTOWER = ["--synthetic", "--train_batch_size", "128", "--learning_rate", "3e-3"]


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.fixture
def k1_calls(monkeypatch):
    """Calls of the sorted scatter-add (its plain version here) per run."""
    calls = []
    real = embedding_kernels.sorted_scatter_add

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(embedding_kernels, "sorted_scatter_add", spy)
    return calls


def _serve(capsys, bundle, *flags):
    recs = serve.main(["--bundle", str(bundle), "--device", "cpu", *flags])
    return recs, _lines(capsys)


# ------------------------------------------------------------ train_pinsage
@pytest.mark.parametrize("export_flags", [[], ["--export_int8"],
                                          ["--export_int8", "--export_ivf_clusters", "8"]],
                         ids=["f32", "int8", "ivf"])
def test_pinsage_cli_exports_and_serves(capsys, tmp_path, k1_calls, export_flags):
    bundle = tmp_path / "pinsage.npz"
    state = train_pinsage.main(COMMON + PINSAGE + ["--steps", "30", "--export", str(bundle)]
                               + export_flags)
    lines = _lines(capsys)
    assert state.step == 30 and [m["step"] for m in lines if "step" in m] == [10, 20, 30]
    assert all(np.isfinite(m["loss"]) for m in lines if "loss" in m)
    final = next(m for m in lines if m.get("final"))
    assert 0.0 <= final["hit_rate"] <= 1.0
    assert lines[-1] == {"exported": str(bundle)}
    assert len(k1_calls) == 4 * 30  # year and id tables, two projections a step
    b = export.load_serving_bundle(str(bundle))
    assert b["metadata"] == {"model": "pinsage", "conv_out": 32}
    assert b["neighbor_ids"].shape == (200, 3)
    assert ("item_reprs_int8" in b) == bool(export_flags)
    assert ("ivf_centroids" in b) == ("--export_ivf_clusters" in export_flags)

    recs, out = _serve(capsys, bundle, "--items", "3,17,42", "--top_k", "5")
    assert recs.shape == (3, 5) and [o["item"] for o in out] == [3, 17, 42]
    assert all(o["item"] not in o["recommendations"] for o in out)
    everything, out = _serve(capsys, bundle, "--all", "--out", str(tmp_path / "recs.npz"),
                             "--batch_size", "64")
    assert out == [{"items": 200, "top_k": 10, "out": str(tmp_path / "recs.npz")}]
    np.testing.assert_array_equal(np.load(tmp_path / "recs.npz")["recommendations"], everything)
    np.testing.assert_array_equal(everything[[3, 17, 42], :5], recs)
    if "--export_ivf_clusters" in export_flags:
        ivf_recs, out = _serve(capsys, bundle, "--all", "--probes", "8")
        np.testing.assert_array_equal(ivf_recs, everything)  # every cluster: brute force


def test_pinsage_cli_resume_matches_the_straight_run(capsys, tmp_path):
    straight = train_pinsage.main(COMMON + PINSAGE + ["--steps", "20"])
    ckpt = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    train_pinsage.main(COMMON + PINSAGE + ["--steps", "10"] + ckpt)
    resumed = train_pinsage.main(COMMON + PINSAGE + ["--steps", "10", "--resume"] + ckpt)
    capsys.readouterr()
    assert resumed.step == 20 and sorted(os.listdir(tmp_path / "ckpt")) == ["step_10.pt",
                                                                          "step_20.pt"]
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ma, mb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert ma["count"] == mb["count"] == 20
    for which in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(ma[which], mb[which]))


def test_pinsage_cli_synthetic_set_is_the_jax_entry_points():
    from recommender_tpu.cli import train_pinsage as jax_train_pinsage
    from recommender_tpu.models.pinsage_task import pinsage_train_batches as jax_batches
    from recommender_tpu_torch.models import pinsage_train_batches

    ours, theirs = train_pinsage._synthetic(seed=2), jax_train_pinsage._synthetic(seed=2)
    g, h = ours[0], theirs[0]
    np.testing.assert_array_equal(g.u2i_indices, h.u2i_indices)
    np.testing.assert_array_equal(ours[1].year, theirs[1].year)
    np.testing.assert_array_equal(ours[1].genre, theirs[1].genre)
    for a, b in zip(ours[2:], theirs[2:]):
        np.testing.assert_array_equal(a, b)
    kw = dict(num_neighbors=3, num_walks=4, walk_length=2)
    it, jit = pinsage_train_batches(g, 32, seed=2, **kw), jax_batches(h, 32, seed=2, **kw)
    for _ in range(2):
        x, y = next(it), next(jit)
        assert all(np.array_equal(x[k], y[k]) for k in y)


# ------------------------------------------------------------ train_twotower
def test_twotower_cli_exports_serves_and_resumes(capsys, tmp_path, k1_calls):
    bundle = tmp_path / "tt.npz"
    straight = train_twotower.main(COMMON + TWOTOWER + ["--steps", "20", "--export", str(bundle),
                                                        "--export_int8"])
    lines = _lines(capsys)
    assert len(k1_calls) == 2 * 20  # the user and item tables
    final = next(m for m in lines if m.get("final"))
    assert 0.0 <= final["hit_rate"] <= 1.0 and lines[-1] == {"exported": str(bundle)}
    b = export.load_serving_bundle(str(bundle))
    assert b["metadata"] == {"model": "two_tower", "repr_dim": 32}
    assert b["item_reprs_int8"].shape == (200, 32)
    recs, _ = _serve(capsys, bundle, "--items", "0,5,9", "--top_k", "5")
    assert recs.shape == (3, 5)

    ckpt = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    train_twotower.main(COMMON + TWOTOWER + ["--steps", "10"] + ckpt)
    resumed = train_twotower.main(COMMON + TWOTOWER + ["--steps", "10", "--resume"] + ckpt)
    capsys.readouterr()
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert resumed.step == 20 and all(torch.equal(a[k], b[k]) for k in a)


def test_twotower_cli_synthetic_set_is_the_jax_entry_points():
    from recommender_tpu.cli import train_twotower as jax_train_twotower

    ours, theirs = train_twotower._synthetic(seed=1), jax_train_twotower._synthetic(seed=1)
    np.testing.assert_array_equal(ours[0].u2i_indices, theirs[0].u2i_indices)
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)


def test_twotower_cli_reads_a_movielens_directory(capsys, tmp_path):
    """``--data_dir``: ratings.dat and movies.dat, the leave-last-two
    split; the final line's hit rate is over the held-out last items."""
    rng = np.random.default_rng(0)
    (tmp_path / "movies.dat").write_text(
        "".join(f"{m}::Movie {m} (19{m % 90:02d})::Drama|Comedy\n" for m in range(1, 31)),
        encoding="latin-1")
    (tmp_path / "ratings.dat").write_text(
        "".join(f"{u}::{rng.integers(1, 31)}::4::{t}\n" for u in range(1, 41) for t in range(6)),
        encoding="latin-1")
    state = train_twotower.main(COMMON + ["--data_dir", str(tmp_path), "--steps", "5",
                                          "--train_batch_size", "32"])
    final = [m for m in _lines(capsys) if m.get("final")]
    assert state.step == 5 and len(final) == 1 and 0.0 <= final[0]["hit_rate"] <= 1.0


# ------------------------------------------------------------ serve
def test_serve_cli_caps_the_ivf_gather(capsys, tmp_path):
    rng = np.random.default_rng(22)
    reprs = rng.normal(size=(300, 8)).astype(np.float32)
    p = tmp_path / "b.npz"
    export.export_serving_bundle(str(p), reprs, quantize=True, ivf_clusters=6)
    recs, out = _serve(capsys, p, "--items", "3,17,42", "--top_k", "5", "--probes", "6")
    assert recs.shape == (3, 5) and out[0]["item"] == 3
    cap = export.load_serving_bundle(str(p))["ivf_bucket_q"].shape[1]
    limit = (1536 << 20) // (6 * cap * 8)
    recs, out = _serve(capsys, p, "--all", "--probes", "6", "--batch_size", str(limit + 1))
    assert out == [{"batch_size_capped": limit, "was": limit + 1,
                    "reason": "ivf candidate gather > 1.5GB"}, {"items": 300, "top_k": 10}]
    assert recs.shape == (300, 10)


@pytest.mark.parametrize("name", ["train_pinsage", "train_twotower", "serve"])
def test_flags_and_defaults_are_the_jax_entry_points(name):
    import argparse
    import importlib

    def parser_of(module):
        class Caught(Exception):
            pass

        def catch(self, args=None, namespace=None):
            raise Caught(self)

        real = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = catch
        try:
            module.main(["--bundle", "x"] if name == "serve" else [])
        except Caught as e:
            return e.args[0]
        finally:
            argparse.ArgumentParser.parse_args = real
        raise AssertionError("the entry point parsed no flags")

    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
                for a in parser._actions if a.dest != "help"}

    ours = flags(parser_of(importlib.import_module(f"recommender_tpu_torch.cli.{name}")))
    theirs = flags(parser_of(importlib.import_module(f"recommender_tpu.cli.{name}")))
    assert ours.pop("device") == ("cuda", None)
    if "dist_backend" in ours:  # the train entry points': gloo for ranks sharing a card
        assert ours.pop("dist_backend") == ("auto", ("auto", "nccl", "gloo"))
    assert ours == theirs


def test_new_entry_points_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs here")
    for entry in (train_pinsage.main, train_twotower.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(["--synthetic", "--steps", "1"])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--bundle", str(tmp_path / "b.npz")])
    with pytest.raises(SystemExit, match="mesh_model"):
        train_twotower.main(["--synthetic", "--mesh_model", "2", "--device", "cpu"])


def test_new_modules_do_not_import_jax():
    code = (
        "import sys\n"
        "import recommender_tpu_torch.cli.train_pinsage, recommender_tpu_torch.cli.train_twotower\n"
        "import recommender_tpu_torch.cli.serve, recommender_tpu_torch.retrieval\n"
        "import recommender_tpu_torch.graph.bipartite, recommender_tpu_torch.data.movielens\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'recommender_tpu')]\n"
        "print(len(sys.modules), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert int(out[0]) > 100 and out[1:] == ["[]"]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch._int_mm's CUDA limits; the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q, V, D", [(1, 3706, 32), (16, 3706, 32), (17, 200, 8), (3, 77, 12),
                                     (1024, 4096, 128)])
def test_int8_product_pads_for_the_card(cuda_device, Q, V, D):
    """``torch._int_mm`` on CUDA refuses Q ≤ 16 and D, V not multiples of
    8: the wrapper pads, and the card's int32 sums equal the CPU's."""
    rng = np.random.default_rng(Q + V)
    qi, sc = quantize.quantize_reprs(rng.normal(size=(V, D)).astype(np.float32))
    qq = torch.from_numpy(qi[rng.integers(0, V, Q)])
    want = quantize.scores_int8(qq, torch.from_numpy(qi), torch.from_numpy(sc))
    got = quantize.scores_int8(qq.to(cuda_device), torch.from_numpy(qi).to(cuda_device),
                               torch.from_numpy(sc).to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    ids = np.arange(0, V, 7)
    np.testing.assert_array_equal(
        quantize.topk_quantized(torch.from_numpy(qi).to(cuda_device),
                                torch.from_numpy(sc).to(cuda_device), ids, k=10),
        quantize.topk_quantized(qi, sc, ids, k=10))


@pytest.mark.cuda
def test_entry_points_run_on_the_card(capsys, tmp_path, cuda_device):
    for entry, args, per_step in ((train_pinsage.main, PINSAGE, 4),
                                  (train_twotower.main, TWOTOWER, 2)):
        bundle = tmp_path / "b.npz"
        before = embedding_kernels.sorted_scatter_add.launches
        state = entry(args + ["--steps", "6", "--log_every", "3", "--eval_every", "0",
                              "--export", str(bundle), "--export_int8",
                              "--export_ivf_clusters", "4"])
        assert next(state.model.parameters()).device.type == "cuda"
        assert embedding_kernels.sorted_scatter_add.launches - before == per_step * 6
        on_card = serve.main(["--bundle", str(bundle), "--all"])
        on_cpu = serve.main(["--bundle", str(bundle), "--all", "--device", "cpu"])
        np.testing.assert_array_equal(on_card, on_cpu)
        ivf_card = serve.main(["--bundle", str(bundle), "--all", "--probes", "4"])
        np.testing.assert_array_equal(ivf_card, on_card)
    capsys.readouterr()
