"""The port's ``cli.train_ctr`` and ``cli.predict`` entry points on the CPU:
the three model types with f32 and bf16 tables, with and without dedup
plans; the Criteo shard stream with one and two workers; ``--resume`` bit
for bit against the straight run; the ``data_stream.json`` pin; the
vocab-size raise; every refused flag; the flags and defaults of the JAX
entry points; and ``predict`` on checkpoints the port wrote.

The JAX package is imported only inside the tests that compare against
it, so that the ``cuda`` test runs where jax is not installed:

    python -m pytest tests/test_torch_cli_ctr.py -m cuda --noconftest
"""
import argparse
import json
import os

import numpy as np
import pytest
import torch

from recommender_tpu_torch.cli import common, predict, train_ctr, train_dien
from recommender_tpu_torch.data import criteo
from recommender_tpu_torch.ops import embedding_kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMMON = ["--device", "cpu", "--log_every", "5", "--eval_every", "0"]
TINY = ["--vocab_size", "2000", "--embedding_size", "8", "--train_batch_size", "64",
        "--test_batch_size", "128", "--eval_batches", "2"]


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.fixture
def k1_calls(monkeypatch):
    """Calls of the sorted scatter-add (its plain version here) per run."""
    calls = []
    real = embedding_kernels.sorted_scatter_add

    def spy(*args, **kw):
        calls.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(embedding_kernels, "sorted_scatter_add", spy)
    return calls


@pytest.mark.parametrize("dedup", ["off", "on"])
@pytest.mark.parametrize("embed_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("model_type", ["DLRM", "DeepFM", "DCN"])
def test_cli_synthetic(capsys, k1_calls, model_type, embed_dtype, dedup):
    state = train_ctr.main(COMMON + TINY + [
        "--synthetic", "--steps", "10", "--model_type", model_type,
        "--embed_dtype", embed_dtype, "--dedup_lookup", dedup])
    lines = _lines(capsys)
    assert [m["step"] for m in lines[:-1]] == [5, 10] and all("loss" in m for m in lines[:-1])
    final = lines[-1]
    assert final["final"] == 1 and final["eval_batches"] == 2 and "eval_auc_exact" in final
    assert state.step == 10 and type(state.model).__name__ == model_type
    table = state.model.embedding.embedding
    assert table.shape == (2000, 8)
    assert table.dtype == (torch.bfloat16 if embed_dtype == "bf16" else torch.float32)
    if model_type == "DLRM":
        assert state.model.bottom_mlp.units == (512, 256, 64, 8)
    # one K1 call a step over the 64 x 26 cotangent rows, or with a plan the
    # segment sum and the scatter of the unique rows (cap 8,192)
    per_step = [64 * 26] if dedup == "off" else [64 * 26, 8192]
    assert k1_calls == per_step * 10
    # the logged examples/s counts rows, not a plan's ids
    assert lines[0]["examples_per_s"] > 0


def test_cli_early_stop(capsys, tmp_path):
    """A frozen model (lr 0) never improves: evals at steps 2, 4 and 6, the
    first one saved (best only), and the run stops two stale evals later."""
    state = train_ctr.main(COMMON + TINY + [
        "--synthetic", "--steps", "20", "--learning_rate", "0", "--eval_every", "2",
        "--early_stop_patience", "2", "--checkpoint_dir", str(tmp_path)])
    assert state.step == 6
    evals = [m["step"] for m in _lines(capsys) if "eval_auc" in m and "final" not in m]
    assert evals == [2, 4, 6]
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_6.pt"]  # best, then the final save


def test_cli_dedup_auto_resolves_off(capsys, k1_calls):
    train_ctr.main(COMMON + TINY + ["--synthetic", "--steps", "2", "--dedup_lookup", "auto"])
    assert k1_calls == [64 * 26] * 2


# ------------------------------------------------------------ the shards
def _criteo_lines(n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ints = ["" if rng.random() < 0.1 else str(int(rng.integers(0, 300))) for _ in range(13)]
        cats = [f"{int(rng.zipf(1.4)) % 300:06x}" for _ in range(26)]
        lines.append("\t".join([str(int(rng.random() < 0.3)), *ints, *cats]) + "\n")
    return lines


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """``train/`` with four shards of 160 rows, ``test/`` with one, and the
    vocab: the layout ``--data_dir`` reads."""
    root = tmp_path_factory.mktemp("criteo")
    lines = _criteo_lines(800, 0)
    vocab = criteo.build_vocab(lines, min_count=2)
    criteo.write_shards(lines[:640], vocab, str(root / "train"), shard_rows=160)
    criteo.write_shards(lines[640:], vocab, str(root / "test"), shard_rows=160)
    criteo.save_vocab(vocab, str(root / "vocab.pkl"))
    return root, len(vocab)


def _shard_args(shard_dir, workers):
    root, _ = shard_dir
    return COMMON + TINY + ["--data_dir", str(root), "--vocab", str(root / "vocab.pkl"),
                            "--prefetch_workers", str(workers), "--test_batch_size", "64"]


@pytest.mark.parametrize("workers", [1, 2])
def test_cli_shard_stream(capsys, shard_dir, workers):
    state = train_ctr.main(_shard_args(shard_dir, workers) + ["--steps", "12",
                                                              "--model_type", "DeepFM"])
    lines = _lines(capsys)
    assert lines[-1]["final"] == 1 and lines[-1]["eval_batches"] == 2
    assert state.step == 12
    assert not any("vocab_size_raised" in m for m in lines)  # 2,000 > the vocab


def test_cli_vocab_size_raised(capsys, shard_dir):
    _, n_vocab = shard_dir
    args = _shard_args(shard_dir, 1) + ["--steps", "2", "--vocab_size", "10"]
    state = train_ctr.main(args)
    lines = _lines(capsys)
    assert lines[0] == {"vocab_size_raised": n_vocab + 1, "was": 10}
    assert state.model.embedding.embedding.shape == (n_vocab + 1, 8)


def test_cli_prefetch_workers_need_enough_shards(shard_dir):
    with pytest.raises(SystemExit, match="needs at least 5 shards"):
        train_ctr.main(_shard_args(shard_dir, 5) + ["--steps", "2"])


# ---------------------------------------------------------------- resume
RESUME = ["--embed_dtype", "bf16", "--dedup_lookup", "on", "--lr_schedule", "dlrm",
          "--warmup_steps", "4", "--decay_steps", "8", "--log_every", "100"]


@pytest.mark.parametrize("stream", ["synthetic", "shards_w2"])
def test_cli_resume_matches_the_straight_run(capsys, tmp_path, shard_dir, stream):
    base = (COMMON + TINY + ["--synthetic"] if stream == "synthetic"
            else _shard_args(shard_dir, 2)) + RESUME
    straight = train_ctr.main(base + ["--steps", "10", "--checkpoint_dir", str(tmp_path / "a")])
    ckpt = ["--checkpoint_dir", str(tmp_path / "b")]
    half = train_ctr.main(base + ["--steps", "4"] + ckpt)
    assert half.step == 4
    resumed = train_ctr.main(base + ["--steps", "6", "--resume"] + ckpt)
    assert resumed.step == 10 and resumed.optimizer.count == 10
    want_files = ["step_10.pt", "step_4.pt"]
    if stream != "synthetic":
        want_files = ["data_stream.json", *want_files]
    assert sorted(os.listdir(tmp_path / "b")) == want_files
    finals = [m for m in _lines(capsys) if "final" in m]
    assert finals[0] == finals[2] != finals[1]
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    assert want["embedding.embedding"].dtype == torch.bfloat16
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for which in ("mu", "nu"):
        for a, b in zip(straight.optimizer.state_dict()[which],
                        resumed.optimizer.state_dict()[which]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--train_batch_size", "32"], ["--seed", "1"],
                                  ["--prefetch_workers", "1"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_cli_resume_refuses_another_stream(capsys, tmp_path, shard_dir, flag):
    ckpt = ["--checkpoint_dir", str(tmp_path), "--steps", "2"]
    train_ctr.main(_shard_args(shard_dir, 2) + ckpt)
    with open(tmp_path / "data_stream.json") as f:
        assert json.load(f) == {"prefetch_workers": 2, "seed": 0, "num_shards": 4,
                                "train_batch_size": 64}
    with pytest.raises(SystemExit, match="data-stream config mismatch"):
        train_ctr.main(_shard_args(shard_dir, 2) + ckpt + ["--resume"] + flag)


# ----------------------------------------------------------------- flags
def test_prepare_criteo_matches_the_jax_cli_then_trains(capsys, tmp_path):
    """``cli.prepare_criteo`` on ``tests/test_cli_rawformat.py``'s raw TSV
    fixture writes the JAX CLI's vocab and shards bit for bit (the same
    names, keys, dtypes and bytes), and ``cli.train_ctr`` trains over them."""
    from recommender_tpu.cli import prepare_criteo as jax_prepare_criteo
    from recommender_tpu_torch.cli import prepare_criteo

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(600):
        ints = ["" if rng.random() < 0.1 else str(int(rng.integers(0, 50)))
                for _ in range(criteo.NUM_INT)]
        cats = [f"c{j}_{int(rng.integers(5))}" for j in range(criteo.NUM_CAT)]
        rows.append(str(int(rng.random() < 0.3)) + "\t" + "\t".join(ints)
                    + "\t" + "\t".join(cats))
    raw = tmp_path / "raw.tsv"
    raw.write_text("\n".join(rows) + "\n")
    outs = {}
    for name, cli in (("port", prepare_criteo), ("jax", jax_prepare_criteo)):
        outs[name] = tmp_path / name
        cli.main(["--train", str(raw), "--test", str(raw), "--out_dir", str(outs[name]),
                  "--min_count", "2", "--shard_rows", "250"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == printed[3:] and printed[1:3] == ["train: 3 shards", "test: 3 shards"]
    port, ref = outs["port"], outs["jax"]
    assert (port / "vocab.pkl").read_bytes() == (ref / "vocab.pkl").read_bytes()
    for split in ("train", "test"):
        names = sorted(os.listdir(ref / split))
        assert sorted(os.listdir(port / split)) == names == [f"shard_{i:05d}.npz" for i in range(3)]
        for n in names:
            got, want = np.load(port / split / n), np.load(ref / split / n)
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), (split, n, k)
    state = train_ctr.main(COMMON + [
        "--model_type", "DLRM", "--data_dir", str(port), "--vocab", str(port / "vocab.pkl"),
        "--vocab_size", "2000", "--train_batch_size", "64", "--test_batch_size", "128",
        "--eval_batches", "2", "--embedding_size", "8", "--steps", "6"])
    final = _lines(capsys)[-1]
    assert state.step == 6 and final["final"] == 1 and final["eval_batches"] == 2


def _assert_same_run(a, b):
    """Two runs' params and optimizer state, bit for bit."""
    want, got = a.model.state_dict(), b.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for which in a.optimizer.slots:
        for x, y in zip(a.optimizer.state_dict()[which], b.optimizer.state_dict()[which]):
            assert torch.equal(x, y)


ACCUM_RESUME = ["--synthetic", "--embed_dtype", "bf16", "--lr_schedule", "dlrm",
                "--warmup_steps", "4", "--decay_steps", "8", "--log_every", "100"]


@pytest.mark.parametrize(
    "flag,refusal",
    [pytest.param(["--accum_steps", "2"], None, id="accum_steps_2-gradient accumulation"),
     pytest.param(["--accum_steps", "2", "--dedup_lookup", "on"],
                  "--dedup_lookup on is incompatible with --accum_steps > 1 "
                  "(plans index the whole-batch id stream)",
                  id="accum_steps_2_--dedup_lookup_on-gradient accumulation")],
)
def test_cli_refuses_unported_flags(capsys, tmp_path, monkeypatch, flag, refusal):
    """No flag is refused for being unported: ``--accum_steps 2`` trains the
    bf16 DLRM in two microbatches a step, and a run stopped at step 4 and
    resumed ends bit for bit where the straight run does. Dedup plans index
    the whole batch, so ``--dedup_lookup on`` with it exits with JAX's
    message."""
    if refusal:
        with pytest.raises(SystemExit) as exc:
            train_ctr.main(COMMON + TINY + ["--synthetic", "--steps", "1"] + flag)
        assert str(exc.value) == refusal
        return
    from recommender_tpu_torch.core.train import Trainer

    calls = []
    real = Trainer._accumulate
    monkeypatch.setattr(Trainer, "_accumulate",
                        lambda self, *a: calls.append(a[2]) or real(self, *a))
    base = COMMON + TINY + ACCUM_RESUME + flag
    straight = train_ctr.main(base + ["--steps", "10"])
    assert calls == [2] * 10 and straight.step == 10
    ckpt = ["--checkpoint_dir", str(tmp_path)]
    assert train_ctr.main(base + ["--steps", "4"] + ckpt).step == 4
    resumed = train_ctr.main(base + ["--steps", "6", "--resume"] + ckpt)
    assert resumed.step == 10 and resumed.optimizer.count == 10
    _assert_same_run(straight, resumed)
    finals = [m for m in _lines(capsys) if "final" in m]
    assert finals[0] == finals[2] != finals[1]
    assert not hasattr(common, "UNPORTED_FLAGS")


@pytest.mark.parametrize(
    "flag,refusal",
    [(["--lookup_mode", "psum"], None), (["--lookup_mode", "a2a"], None),
     (["--mesh_model", "2"], "needs 2 ranks"), (["--mesh_data", "2"], "needs 2 ranks"),
     (["--mesh_dcn", "2"], "needs 2 ranks"), (["--distributed"], "no rendezvous"),
     (["--coordinator_address", "localhost:1"], "needs --num_processes"),
     (["--num_processes", "2"], None), (["--process_id", "0"], None),
     (["--log_all_hosts"], None)],
    ids=lambda x: "_".join(x).lstrip("-") if isinstance(x, list) else None,
)
def test_cli_distribution_flags_on_one_process(capsys, monkeypatch, flag, refusal):
    """Ported: ``tests/test_torch_distributed.py`` runs them across ranks. In
    one process the exchanges leave the table whole (a one-wide model
    axis), a mesh needs its ranks, a launch its identity or torchrun's
    environment."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    argv = COMMON + TINY + ["--synthetic", "--steps", "1"] + flag
    if refusal:
        with pytest.raises(SystemExit, match=refusal):
            train_ctr.main(argv)
        return
    state = train_ctr.main(argv)
    assert state.step == 1 and not state.model.embedding.sharded


@pytest.mark.parametrize("mode", ["auto", "gspmd"])
def test_cli_accepts_replicated_lookup_modes(capsys, mode):
    state = train_ctr.main(COMMON + TINY + ["--synthetic", "--steps", "1", "--lookup_mode", mode,
                                            "--a2a_capacity_factor", "2",
                                            "--replicate_below_mb", "1"])
    assert state.step == 1


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ctr.main(["--synthetic", "--steps", "1"])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--family", "ctr", "--checkpoint_dir", "x", "--output", "y"])


def _parser_of(module):
    """The parser an entry point builds, caught at its ``parse_args``."""

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


def _flags(parser):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["train_ctr", "predict"])
def test_flags_and_defaults_are_the_jax_entry_points(name):
    import importlib

    ours = _flags(_parser_of({"train_ctr": train_ctr, "predict": predict}[name]))
    theirs = _flags(_parser_of(importlib.import_module(f"recommender_tpu.cli.{name}")))
    assert ours.pop("device") == ("cuda", None)
    if name == "train_ctr":  # the port's: gloo for ranks sharing a card
        assert ours.pop("dist_backend") == ("auto", ("auto", "nccl", "gloo"))
    assert ours == theirs
    assert not hasattr(common, "UNPORTED_FLAGS")  # every flag is ported


# --------------------------------------------------------------- predict
def _features(n, seed):
    from recommender_tpu_torch.data import SyntheticCTR

    return SyntheticCTR(vocab_size=2000, seed=7).sample(n, seed=seed)


@pytest.mark.parametrize("embed_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("model_type", ["DLRM", "DeepFM", "DCN"])
def test_predict_scores_the_checkpoint(capsys, tmp_path, model_type, embed_dtype):
    """``--embedding_size 8``: DLRM's bottom MLP ends at 8 and DCN is DCN
    (the JAX entry point builds DeepFM for DCN and a 16-wide bottom MLP).
    100 rows at batch 32: the last batch is padded and sliced back."""
    ckpt = str(tmp_path / "ckpt")
    state = train_ctr.main(COMMON + TINY + [
        "--synthetic", "--steps", "6", "--model_type", model_type, "--embed_dtype", embed_dtype,
        "--checkpoint_dir", ckpt])
    rows = _features(100, 3)
    np.savez(tmp_path / "in.npz", **rows)
    capsys.readouterr()
    scores = predict.main(["--family", "ctr", "--model_type", model_type, "--device", "cpu",
                           "--checkpoint_dir", ckpt, "--vocab_size", "2000",
                           "--embedding_size", "8", "--batch_size", "32",
                           "--input", str(tmp_path / "in.npz"),
                           "--output", str(tmp_path / "out.npz")])
    (line,) = _lines(capsys)
    assert line["predicted"] == 100 and line["heads"] == ["score"] and line["step"] == 6
    saved = dict(np.load(tmp_path / "out.npz"))
    np.testing.assert_array_equal(saved["score"], scores["score"])
    model = state.model.eval()
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in rows.items()}).numpy()
    assert saved["score"].shape == (100,)
    np.testing.assert_allclose(saved["score"], want, rtol=0, atol=1e-6)


def test_predict_synthetic_and_dien(capsys, tmp_path):
    ckpt = str(tmp_path / "dien")
    state = train_dien.main(["--synthetic", "--device", "cpu", "--steps", "4", "--log_every", "2",
                             "--eval_every", "0", "--model_type", "DIN",
                             "--history_max_length", "10", "--embedding_size", "8",
                             "--train_batch_size", "32", "--test_batch_size", "64",
                             "--eval_batches", "1", "--embed_dtype", "bf16",
                             "--checkpoint_dir", ckpt])
    items, cats = state.model.item_embedding.embedding.shape[0], \
        state.model.cat_embedding.embedding.shape[0]
    capsys.readouterr()
    scores = predict.main(["--family", "dien", "--model_type", "DIN", "--device", "cpu",
                           "--checkpoint_dir", ckpt, "--item_vocab", str(items),
                           "--cat_vocab", str(cats), "--embedding_size", "8", "--synthetic",
                           "--batch_size", "16", "--output", str(tmp_path / "out.npz")])
    (line,) = _lines(capsys)
    assert line["predicted"] == 64 and line["step"] == 4
    from recommender_tpu_torch.data import SyntheticSequence

    rows = SyntheticSequence(num_items=items, num_cats=cats, seed=1).sample(64, seed=2)
    with torch.no_grad():
        want = state.model.eval()({k: torch.from_numpy(v) for k, v in rows.items()}).numpy()
    np.testing.assert_allclose(scores["score"], want, rtol=0, atol=1e-6)


def test_predict_refusals(tmp_path):
    with pytest.raises(SystemExit, match="no single checkpoint"):
        predict.main(["--family", "esmm", "--model_type", "BASE", "--checkpoint_dir", str(tmp_path),
                      "--output", str(tmp_path / "o.npz"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        predict.main(["--family", "ctr", "--checkpoint_dir", str(tmp_path / "none"),
                      "--output", str(tmp_path / "o.npz"), "--device", "cpu", "--synthetic"])


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_cli_dedup_launches_k1_twice_a_step_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for dedup, per_step in (("off", 1), ("on", 2)):
        before = embedding_kernels.sorted_scatter_add.launches
        state = train_ctr.main(["--synthetic", "--steps", "6", "--log_every", "3",
                                "--eval_every", "0", "--dedup_lookup", dedup,
                                "--embed_dtype", "bf16"] + TINY)
        assert next(state.model.parameters()).device.type == "cuda"
        assert embedding_kernels.sorted_scatter_add.launches - before == per_step * 6
