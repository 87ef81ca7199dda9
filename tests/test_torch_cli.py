"""The port's ``cli.train_dien`` entry point on the CPU: the four model
types on synthetic data, bf16 tables, the file path on a TSV fixture,
``--resume`` (bit for bit against the straight run), the TensorBoard flag,
``--device``, ``--accum_steps`` with a resume, the launch flags on one process, and that no
file of the port imports jax or the JAX package."""
import json
import os
import re

import numpy as np
import pytest
import torch

from recommender_tpu_torch.cli import common, train_dien
from recommender_tpu_torch.core.tensorboard import read_scalars


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--synthetic", "--device", "cpu", "--steps", "10", "--log_every", "5",
          "--eval_every", "0"]
TINY = ["--history_max_length", "10", "--embedding_size", "8", "--train_batch_size", "64",
        "--test_batch_size", "128", "--eval_batches", "2"]


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("model_type", ["BASE", "DIN", "DIEN", "BST"])
@pytest.mark.parametrize("embed_dtype", ["f32", "bf16"])
def test_cli_synthetic(capsys, model_type, embed_dtype):
    state = train_dien.main(
        COMMON + TINY + ["--model_type", model_type, "--embed_dtype", embed_dtype])
    lines = _lines(capsys)
    assert [m["step"] for m in lines[:-1]] == [5, 10] and all("loss" in m for m in lines[:-1])
    assert ("aux_loss" in lines[0]) == (model_type == "DIEN")
    final = lines[-1]
    assert final["final"] == 1 and final["eval_batches"] == 2 and "eval_auc_exact" in final
    assert state.step == 10 and type(state.model) is train_dien.MODELS[model_type]
    want = torch.bfloat16 if embed_dtype == "bf16" else torch.float32
    assert state.model.item_embedding.embedding.dtype == want
    assert state.model.item_embedding.embedding.shape == (1000, 8)


def _write_tsv(path, n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(n):
        k = int(rng.integers(1, 9))
        items = [f"item{int(i)}" for i in rng.integers(0, 40, size=k + 1)]
        cats = [f"cat{int(i[4:]) % 7}" for i in items]
        lines.append("\t".join([str(u % 2), f"u{u}", items[0], cats[0],
                                "\x02".join(items[1:]), "\x02".join(cats[1:])]))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("model_type", ["DIN", "DIEN"])
def test_cli_file_path(capsys, tmp_path, model_type):
    train = _write_tsv(tmp_path / "train.tsv", 200, 0)
    test = _write_tsv(tmp_path / "test.tsv", 64, 1)
    args = ["--device", "cpu", "--steps", "6", "--log_every", "3", "--eval_every", "0",
            "--model_type", model_type, "--train_file", train, "--test_file", test,
            "--history_max_length", "6", "--embedding_size", "8", "--train_batch_size", "32",
            "--test_batch_size", "32"]
    state = train_dien.main(args)
    lines = _lines(capsys)
    assert lines[-1]["final"] == 1 and lines[-1]["eval_batches"] == 2
    assert state.model.item_embedding.embedding.shape[0] == 40 + 2  # items + mask + unk
    again = train_dien.main(args)  # the negatives are drawn from --seed: the run repeats
    for a, b in zip(state.model.state_dict().values(), again.model.state_dict().values()):
        assert torch.equal(a, b)
    assert _lines(capsys)[-1] == lines[-1]  # the same final eval


@pytest.mark.parametrize("embed_dtype", ["f32", "bf16"])
def test_cli_resume_matches_the_straight_run(capsys, tmp_path, embed_dtype):
    base = COMMON[:3] + TINY + ["--log_every", "100", "--eval_every", "0",
                               "--model_type", "DIEN", "--embed_dtype", embed_dtype]
    straight = train_dien.main(base + ["--steps", "10", "--checkpoint_dir", str(tmp_path / "a")])
    assert os.listdir(tmp_path / "a") == ["step_10.pt"]  # saved at the end
    ckpt = ["--checkpoint_dir", str(tmp_path / "b")]
    half = train_dien.main(base + ["--steps", "4"] + ckpt)
    assert half.step == 4
    resumed = train_dien.main(base + ["--steps", "6", "--resume"] + ckpt)
    assert resumed.step == 10 and resumed.optimizer.count == 10
    assert sorted(os.listdir(tmp_path / "b")) == ["step_10.pt", "step_4.pt"]
    finals = [m for m in _lines(capsys) if "final" in m]
    assert finals[0] == finals[2] != finals[1]
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for which in ("mu", "nu"):
        for a, b in zip(straight.optimizer.state_dict()[which],
                        resumed.optimizer.state_dict()[which]):
            assert torch.equal(a, b)
    # --resume on an empty directory starts from the init
    fresh = train_dien.main(base + ["--steps", "10", "--resume",
                                    "--checkpoint_dir", str(tmp_path / "c")])
    for k in want:
        assert torch.equal(want[k], fresh.model.state_dict()[k]), k


def test_cli_stream_skips_the_first_batch(monkeypatch):
    """The JAX entry point's init consumes the stream's first batch; the port
    trains on the same batches 1, 2, …"""
    seen = []
    real = train_dien.batch_iterator

    def spy(arrays, batch_size, **kw):
        for batch in real(arrays, batch_size, **kw):
            if kw.get("epochs", 1) is None:
                seen.append(batch["target_item"].copy())
            yield batch

    monkeypatch.setattr(train_dien, "batch_iterator", spy)
    train_dien.main(COMMON[:3] + TINY + ["--steps", "3", "--log_every", "100",
                                         "--eval_every", "0", "--model_type", "BASE"])
    stream = real(train_dien.SyntheticSequence(max_len=10, seed=0).sample(50_000, seed=1),
                  64, seed=0, epochs=None)
    for got, want in zip(seen, stream):
        np.testing.assert_array_equal(got, want["target_item"])
    assert len(seen) >= 4  # the skipped one and the three trained on


def test_cli_writes_tensorboard_events(capsys, tmp_path):
    train_dien.main(COMMON + TINY + ["--model_type", "BASE", "--tensorboard_dir", str(tmp_path)])
    (name,) = os.listdir(tmp_path)
    tags = {(s, t) for s, t, _ in read_scalars(str(tmp_path / name))}
    assert {(5, "loss"), (10, "loss"), (10, "eval_auc_exact")} <= tags


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dien.main(["--synthetic", "--steps", "1"])  # --device defaults to cuda
    assert common.base_parser("x").parse_args([]).device == "cuda"


@pytest.mark.parametrize("flag", [["--accum_steps", "2"]], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_flags(capsys, tmp_path, monkeypatch, flag):
    """No flag is refused for being unported: ``--accum_steps 2`` trains
    DIEN (bf16 tables) in two microbatches a step, and a run stopped at
    step 4 and resumed ends bit for bit where the straight run does."""
    from recommender_tpu_torch.core.train import Trainer

    calls = []
    real = Trainer._accumulate
    monkeypatch.setattr(Trainer, "_accumulate",
                        lambda self, *a: calls.append(a[2]) or real(self, *a))
    base = COMMON + TINY + flag + ["--model_type", "DIEN", "--embed_dtype", "bf16"]
    straight = train_dien.main(base)
    assert calls == [2] * 10 and straight.step == 10
    ckpt = ["--checkpoint_dir", str(tmp_path)]
    assert train_dien.main(base + ["--steps", "4"] + ckpt).step == 4
    resumed = train_dien.main(base + ["--steps", "6", "--resume"] + ckpt)
    assert resumed.step == 10 and resumed.optimizer.count == 10
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for which in ("mu", "nu"):
        for a, b in zip(straight.optimizer.state_dict()[which],
                        resumed.optimizer.state_dict()[which]):
            assert torch.equal(a, b)
    finals = [m for m in _lines(capsys) if "final" in m]
    assert finals[0] == finals[2] != finals[1]
    assert not hasattr(common, "UNPORTED_FLAGS")


@pytest.mark.parametrize(
    "flag,refusal",
    [(["--mesh_data", "1"], None), (["--mesh_model", "2"], "needs 2 ranks"),
     (["--mesh_dcn", "2"], "needs 2 ranks"),
     (["--coordinator_address", "localhost:1"], "needs --num_processes"),
     (["--num_processes", "2"], None), (["--process_id", "0"], None),
     (["--log_all_hosts"], None), (["--distributed"], "no rendezvous")],
    ids=lambda f: f[0].lstrip("-") if isinstance(f, list) else None,
)
def test_cli_launch_flags_on_one_process(capsys, monkeypatch, flag, refusal):
    """The mesh and launch flags are ported (``tests/test_torch_distributed.py``
    launches ranks with them); in one process without a rendezvous a mesh
    needs the ranks it names, ``--coordinator_address`` its identity and
    ``--distributed`` torchrun's environment, and the rest run as one rank."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    if refusal:
        with pytest.raises(SystemExit, match=refusal):
            train_dien.main(COMMON + TINY + flag)
        return
    assert train_dien.main(COMMON + TINY + flag).step == 10
    assert _lines(capsys)[-1]["final"] == 1


def test_flags_and_defaults_are_the_jax_entry_points():
    from recommender_tpu.cli.common import base_parser as jax_base_parser

    ours = {a.dest: a.default for a in common.base_parser("x")._actions}
    theirs = {a.dest: a.default for a in jax_base_parser("x")._actions}
    assert ours.pop("device") == "cuda"
    assert ours.pop("dist_backend") == "auto"  # the port's: gloo for ranks sharing a card
    assert ours == theirs
    assert not hasattr(common, "UNPORTED_FLAGS")  # every flag is ported


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|recommender_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "recommender_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    # the CTR slice's modules among them
    names = {os.path.relpath(f, REPO) for f in files}
    assert {f"recommender_tpu_torch/{m}.py" for m in (
        "cli/train_ctr", "cli/predict", "data/criteo", "data/dedup", "data/pipeline",
        "models/deepfm", "models/dcn", "nn/cross", "nn/schedules", "retrieval/scoring")} <= names
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
