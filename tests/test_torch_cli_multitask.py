"""The port's ``cli.train_esmm``, ``cli.predict --family esmm`` and
``cli.train_eges`` entry points on the CPU: BASE, ESMM and MMOE on the
synthetic set and on ``.npz`` splits, ``--resume`` bit for bit against the
straight run, ``predict`` on a checkpoint whose tables have one size per
column, BGE, GES and EGES on the synthetic graph and on an Amazon metadata
file with ``--shared_lr_scale``, EGES's ``--export`` / ``--export_int8``
bundles served back, every refusal (BASE in ``predict`` and with a
checkpoint, a test id outside its table), the flags and
defaults of the JAX entry points, and that none of the new modules imports
jax.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from recommender_tpu_torch.cli import predict, train_eges, train_esmm
from recommender_tpu_torch.convert import jax_leaf_order
from recommender_tpu_torch.data import SyntheticMultiTask
from recommender_tpu_torch.ops import embedding_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMMON = ["--device", "cpu", "--log_every", "10", "--eval_every", "0"]
ESMM_TINY = ["--embedding_size", "8", "--train_batch_size", "256", "--test_batch_size", "2048",
             "--learning_rate", "3e-3"]
EGES_TINY = ["--embedding_size", "16", "--train_batch_size", "256", "--learning_rate", "5e-3"]


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


# ------------------------------------------------------------ train_esmm
@pytest.mark.parametrize("model_type", ["BASE", "ESMM", "MMOE"])
def test_esmm_cli_synthetic(capsys, k1_calls, model_type):
    """100 steps on the synthetic set learn: floors a few hundredths under
    the AUCs measured here (BASE's ctcvr 0.734; ESMM's cvr 0.623 and ctcvr
    0.695; MMOE's 0.596 and 0.698). Every table's backward is K1, 18 calls
    a step (for each of BASE's two models)."""
    out = train_esmm.main(COMMON + ESMM_TINY + ["--synthetic", "--model_type", model_type,
                                                "--steps", "100"])
    lines = _lines(capsys)
    final = lines[-1]
    assert final["final"] == 1
    models = 2 if model_type == "BASE" else 1
    assert len(k1_calls) == 18 * 100 * models
    assert all(shape == (256, 8) for shape in k1_calls)
    if model_type == "BASE":
        assert set(out) == {"ctr", "cvr"}
        assert [m["role"] for m in lines[:-1]] == ["ctr"] * 10 + ["cvr"] * 10
        assert set(final) == {"final", "ctcvr_auc"} and final["ctcvr_auc"] > 0.7, final
        return
    assert out.step == 100 and set(final) == {"final", "cvr_auc", "ctcvr_auc"}
    assert {"loss", "ctr_loss", "ctcvr_loss"} <= set(lines[0])
    assert final["cvr_auc"] > 0.57 and final["ctcvr_auc"] > 0.66, final


def test_esmm_cli_resume_matches_the_straight_run(capsys, tmp_path):
    args = COMMON + ESMM_TINY + ["--synthetic", "--model_type", "MMOE"]
    straight = train_esmm.main(args + ["--steps", "12", "--checkpoint_dir",
                                       str(tmp_path / "a")])
    want = _lines(capsys)[-1]
    train_esmm.main(args + ["--steps", "6", "--checkpoint_dir", str(tmp_path / "b")])
    resumed = train_esmm.main(args + ["--steps", "6", "--resume", "--checkpoint_dir",
                                      str(tmp_path / "b")])
    assert _lines(capsys)[-1] == want
    assert resumed.step == 12 and sorted(os.listdir(tmp_path / "b")) == ["step_12.pt",
                                                                          "step_6.pt"]
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ma, mb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert ma["count"] == mb["count"] == 12
    assert all(torch.equal(x, y) for w in ("mu", "nu") for x, y in zip(ma[w], mb[w]))


def _npz_splits(tmp_path, sizes=(30, 7, 50, 2, 9, 13), n_train=4000, n_test=1000):
    """Train and test splits with one vocab per column; every id of the
    test split occurs in the train split's columns."""
    gen = SyntheticMultiTask(num_feats=len(sizes), vocab_sizes=sizes, seed=5)
    train, test = gen.sample(n_train, seed=1), gen.sample(n_test, seed=2)
    assert (test["features"].max(0) <= train["features"].max(0)).all()
    np.savez(tmp_path / "train.npz", **train)
    np.savez(tmp_path / "test.npz", **test)
    return train, test


@pytest.mark.parametrize("model_type", ["ESMM", "MMOE"])
def test_esmm_cli_npz_and_predict(capsys, tmp_path, model_type):
    """An npz-trained run sizes each column's table from its data (``max +
    1``); ``predict --family esmm`` takes those sizes from the checkpoint and
    scores the three heads as the restored model's eval forward does."""
    train, test = _npz_splits(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    state = train_esmm.main(COMMON + ESMM_TINY + [
        "--model_type", model_type, "--train_npz", str(tmp_path / "train.npz"),
        "--test_npz", str(tmp_path / "test.npz"), "--steps", "10", "--checkpoint_dir", ckpt])
    assert "ctcvr_auc" in _lines(capsys)[-1]
    sizes = (train["features"].max(0) + 1).tolist()
    tables = [getattr(state.model.embedder, f"feat_{j}").embedding for j in range(len(sizes))]
    assert [t.shape[0] for t in tables] == sizes == [30, 7, 50, 2, 9, 13]
    scores = predict.main(["--family", "esmm", "--model_type", model_type, "--device", "cpu",
                           "--checkpoint_dir", ckpt, "--input", str(tmp_path / "test.npz"),
                           "--batch_size", "300", "--output", str(tmp_path / "out.npz")])
    (line,) = _lines(capsys)
    assert line["predicted"] == 1000 and line["step"] == 10
    assert line["heads"] == ["ctcvr", "ctr", "cvr"]
    saved = dict(np.load(tmp_path / "out.npz"))
    with torch.no_grad():
        want = state.model.eval()({"features": torch.from_numpy(test["features"])})
    for head in ("ctr", "cvr", "ctcvr"):
        np.testing.assert_array_equal(saved[head], scores[head])
        np.testing.assert_allclose(scores[head], want[head].numpy(), rtol=0, atol=1e-6)


def test_predict_esmm_synthetic_input(capsys, tmp_path):
    _npz_splits(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    train_esmm.main(COMMON + ESMM_TINY + [
        "--model_type", "ESMM", "--train_npz", str(tmp_path / "train.npz"),
        "--test_npz", str(tmp_path / "test.npz"), "--steps", "2", "--checkpoint_dir", ckpt])
    capsys.readouterr()
    scores = predict.main(["--family", "esmm", "--model_type", "ESMM", "--device", "cpu",
                           "--checkpoint_dir", ckpt, "--synthetic", "--batch_size", "64",
                           "--output", str(tmp_path / "out.npz")])
    assert all(v.shape == (256,) and np.isfinite(v).all() for v in scores.values())
    np.testing.assert_allclose(scores["ctcvr"], scores["ctr"] * scores["cvr"], rtol=1e-6)


def test_esmm_refusals(capsys, tmp_path):
    train, test = _npz_splits(tmp_path)
    test["features"][17, 2] = 50  # column 2's table has 50 rows
    np.savez(tmp_path / "bad_test.npz", **test)
    npz = ["--train_npz", str(tmp_path / "train.npz"), "--test_npz",
           str(tmp_path / "bad_test.npz")]
    with pytest.raises(ValueError, match="row 17, column 2: id 50 for a table of 50 rows"):
        train_esmm.main(COMMON + ESMM_TINY + npz + ["--steps", "1"])
    with pytest.raises(SystemExit, match="BASE trains two models"):
        train_esmm.main(COMMON + ["--synthetic", "--model_type", "BASE", "--checkpoint_dir",
                                  str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="no single checkpoint"):
        predict.main(["--family", "esmm", "--model_type", "BASE", "--device", "cpu",
                      "--checkpoint_dir", str(tmp_path), "--output", str(tmp_path / "o.npz")])
    ckpt = str(tmp_path / "ckpt")
    train_esmm.main(COMMON + ESMM_TINY + ["--model_type", "MMOE", "--steps", "1",
                                          "--train_npz", str(tmp_path / "train.npz"),
                                          "--test_npz", str(tmp_path / "test.npz"),
                                          "--checkpoint_dir", ckpt])
    with pytest.raises(ValueError, match="the input: 1 ids fall outside"):
        predict.main(["--family", "esmm", "--model_type", "MMOE", "--device", "cpu",
                      "--checkpoint_dir", ckpt, "--input", str(tmp_path / "bad_test.npz"),
                      "--output", str(tmp_path / "o.npz")])
    dlrm_ckpt = str(tmp_path / "dlrm")
    from recommender_tpu_torch.cli import train_ctr

    train_ctr.main(COMMON + ["--synthetic", "--steps", "1", "--vocab_size", "100",
                             "--embedding_size", "8", "--train_batch_size", "16",
                             "--test_batch_size", "16", "--eval_batches", "1",
                             "--checkpoint_dir", dlrm_ckpt])
    with pytest.raises(SystemExit, match="not a train_esmm ESMM or MMOE checkpoint"):
        predict.main(["--family", "esmm", "--model_type", "ESMM", "--device", "cpu",
                      "--checkpoint_dir", dlrm_ckpt, "--synthetic",
                      "--output", str(tmp_path / "o.npz")])


def test_jax_gathers_out_of_range_ids_without_an_error():
    """What the port's raise stands in for (``PARITY.md``): the JAX model
    scores a test id past its table without an error, as NaN (``jnp.take``
    fills an out-of-range gather), and the other rows as usual."""
    import jax

    from recommender_tpu.models.esmm import ESMM as JaxESMM

    feats = np.zeros((2, 3), np.int32)
    model = JaxESMM(vocab_sizes=(5, 5, 5), embed_dim=4, mlp_units=(8, 1))
    params = model.init(jax.random.PRNGKey(0), {"features": feats})["params"]
    past = feats.copy()
    past[0, 1] = 9
    heads = model.apply({"params": params}, {"features": past})
    inside = model.apply({"params": params}, {"features": feats})
    for head in ("ctr", "cvr", "ctcvr"):
        got = np.asarray(heads[head])
        assert np.isnan(got[0]) and got[1] == np.asarray(inside[head])[1], head


# ------------------------------------------------------------ train_eges
def _meta_file(tmp_path, n=80, seed=0):
    """``tests/test_cli_rawformat.py``'s metadata fixture."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        also = [f"A{int(x)}" for x in rng.integers(0, n, 4)]
        lines.append(json.dumps({"asin": f"A{i}", "main_cat": f"cat{i % 5}",
                                 "brand": f"b{i % 7}", "also_buy": also}))
    path = tmp_path / "meta.json"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("model_type", ["BGE", "GES", "EGES"])
def test_eges_cli_meta_file_with_shared_lr_scale(capsys, tmp_path, k1_calls, model_type):
    state = train_eges.main(COMMON + EGES_TINY + [
        "--model_type", model_type, "--meta_file", _meta_file(tmp_path), "--steps", "20",
        "--shared_lr_scale", "0.5"])
    final = _lines(capsys)[-1]
    assert set(final) == {"final", "link_prediction_auc"}
    assert 0.0 <= final["link_prediction_auc"] <= 1.0
    tables = {"BGE": 2, "GES": 4, "EGES": 5}[model_type]
    assert len(k1_calls) == 20 * tables
    names = [n for n, _ in jax_leaf_order(state.model)]
    want = [0.5 if n.split(".")[0] in ("cat_embedding", "brand_embedding") else 1.0
            for n in names]
    assert (state.optimizer.scales or [1.0] * len(names)) == want
    assert (state.optimizer.scales is None) == (model_type == "BGE")


def test_eges_cli_synthetic_learns(capsys, k1_calls):
    """The synthetic graph's stream, 60 steps of EGES: the skip-gram loss
    falls; K1 runs at D 16 and at the weight table's D 3."""
    state = train_eges.main(COMMON + EGES_TINY + ["--synthetic", "--steps", "60"])
    losses = [m["loss"] for m in _lines(capsys)]
    assert state.step == 60 and len(losses) == 6 and losses[-1] < losses[0] - 0.05, losses
    assert {shape[1] for shape in k1_calls} == {16, 3}


def test_eges_cli_stream_is_the_jax_entry_points():
    """The synthetic graph and its first batches equal the JAX entry
    point's for the same seed (the batch it takes as its init example, then
    the first it trains on)."""
    from recommender_tpu.cli import train_eges as jax_train_eges
    from recommender_tpu.graph.walks import skipgram_batches as jax_skipgram_batches
    from recommender_tpu_torch.graph.walks import skipgram_batches

    g, side, comm = train_eges._synthetic_graph(seed=3)
    h, jside, jcomm = jax_train_eges._synthetic_graph(seed=3)
    np.testing.assert_array_equal(g.indices, h.indices)
    np.testing.assert_array_equal(comm, jcomm)
    for k in side:
        np.testing.assert_array_equal(side[k], jside[k])
    kw = dict(walk_length=10, window=5, num_negatives=5, batch_size=256, walks_per_round=64,
              side_info=side, seed=3)
    ours, theirs = skipgram_batches(g, **kw), jax_skipgram_batches(h, **kw)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("flag", [[], ["--export_int8"]],
                         ids=lambda f: "export_int8" if f else "export")
def test_eges_cli_refuses_export(capsys, tmp_path, flag):
    """``--export`` (f32) and ``--export --export_int8`` write every node's
    ``get_hidden`` as a bundle that ``cli.serve`` answers from."""
    from recommender_tpu_torch.cli import serve
    from recommender_tpu_torch.retrieval import export

    bundle = str(tmp_path / "eges.npz")
    state = train_eges.main(COMMON + ["--synthetic", "--steps", "3", "--model_type", "EGES",
                                      "--export", bundle] + flag)
    assert _lines(capsys)[-1] == {"exported": bundle}
    b = export.load_serving_bundle(bundle)
    assert b["metadata"] == {"model": "EGES", "embed_dim": 128}
    g, side, _ = train_eges._synthetic_graph(seed=0)
    with torch.no_grad():
        hidden = state.model.get_hidden({
            "target": torch.arange(g.num_nodes),
            "target_cat": torch.from_numpy(side["cat"]),
            "target_brand": torch.from_numpy(side["brand"]),
        }).numpy()
    if flag:
        q, scale = export.quantize_reprs(hidden)
        np.testing.assert_array_equal(b["item_reprs_int8"], q)
        np.testing.assert_array_equal(b["item_scale"], scale)
    else:
        np.testing.assert_array_equal(b["item_reprs"], hidden)
    recs = serve.main(["--bundle", bundle, "--items", "1,2,3", "--device", "cpu"])
    assert recs.shape == (3, 10) and all(i not in r for i, r in zip((1, 2, 3), recs))
    np.testing.assert_array_equal(recs, export.serve_topk(b, np.array([1, 2, 3])))
    capsys.readouterr()


def test_new_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs here")
    for entry in (train_esmm.main, train_eges.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(["--synthetic", "--steps", "1"])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--family", "esmm", "--model_type", "MMOE", "--checkpoint_dir", "x",
                      "--output", "y"])


@pytest.mark.parametrize("name", ["train_esmm", "train_eges", "prepare_aliccp"])
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
            module.main([])
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
    if name != "prepare_aliccp":
        assert ours.pop("device") == ("cuda", None)
        # the port's: gloo for ranks sharing a card
        assert ours.pop("dist_backend") == ("auto", ("auto", "nccl", "gloo"))
    assert ours == theirs


def test_new_modules_do_not_import_jax():
    code = (
        "import sys\n"
        "import recommender_tpu_torch.cli.train_esmm, recommender_tpu_torch.cli.train_eges\n"
        "import recommender_tpu_torch.cli.predict, recommender_tpu_torch.cli.prepare_aliccp\n"
        "import recommender_tpu_torch.models.esmm, recommender_tpu_torch.models.eges\n"
        "import recommender_tpu_torch.nn.moe, recommender_tpu_torch.graph.native\n"
        "import recommender_tpu_torch.data.aliccp, recommender_tpu_torch.data.amazon_meta\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'recommender_tpu')]\n"
        "print(len(sys.modules), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert int(out[0]) > 100 and out[1:] == ["[]"]


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_clis_launch_k1_for_every_table_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for entry, args, per_step in (
        (train_esmm.main, ["--model_type", "MMOE"] + ESMM_TINY, 18),
        (train_esmm.main, ["--model_type", "BASE"] + ESMM_TINY, 2 * 18),
        (train_eges.main, ["--model_type", "EGES"] + EGES_TINY, 5),
    ):
        before = embedding_kernels.sorted_scatter_add.launches
        out = entry(["--synthetic", "--steps", "6", "--log_every", "3", "--eval_every", "0"]
                    + args)
        model = out["ctr"][0] if isinstance(out, dict) else out.model
        assert next(model.parameters()).device.type == "cuda"
        assert embedding_kernels.sorted_scatter_add.launches - before == per_step * 6
    capsys.readouterr()
