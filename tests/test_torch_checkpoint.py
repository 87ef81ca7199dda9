"""Checkpoint and resume of the port's Trainer on the CPU: a straight run
against save + restore into a fresh state, bit for bit, with f32 and with
bf16 tables under stochastic rounding; pruning; restore from an empty
directory; and the copied host modules (TensorBoard writer, Amazon
pipeline) bit for bit against the JAX package's originals."""
import os

import numpy as np
import pytest
import torch

from recommender_tpu.core import tensorboard as jax_tensorboard
from recommender_tpu.data import amazon as jax_amazon
from recommender_tpu_torch.core import tensorboard
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticSequence, amazon, batch_iterator
from recommender_tpu_torch.models import DIEN, init_model, make_aux_loss_task


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = dict(item_vocab=200, cat_vocab=20, item_dim=8, cat_dim=8, mlp_units=(32, 16, 1),
             extract_hidden=12, evolve_hidden=10)
BATCH, T = 32, 9


def _data():
    return SyntheticSequence(num_items=200, num_cats=20, max_len=T).sample(12 * BATCH, 3)


def _trainer(table_dtype, **cfg):
    model = DIEN(**SMALL, embed_param_dtype=table_dtype)
    init_model(model, seed=4)
    loss_fn, eval_fn = make_aux_loss_task(model)
    trainer = Trainer(loss_fn, TrainConfig(log_every=1, eval_every=0, seed=7, **cfg), eval_fn,
                      device="cpu")
    return trainer, trainer.init_state(lambda: model)


def _fit(trainer, state, steps, start=0):
    losses = []
    it = batch_iterator(_data(), BATCH, seed=0, epochs=None, start_batch=start)
    state, _ = trainer.fit(state, it, steps, log_fn=lambda m: losses.append(m["loss"]))
    return state, losses


def _snapshot(state):
    return {
        **{f"model.{k}": v.clone() for k, v in state.model.state_dict().items()},
        **{f"{w}.{i}": m.clone() for w in ("mu", "nu")
           for i, m in enumerate(state.optimizer.state_dict()[w])},
    }


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16_sr"])
def test_restore_continues_bit_for_bit(tmp_path, table_dtype):
    trainer, state = _trainer(table_dtype)
    straight, straight_losses = _fit(trainer, state, 10)

    first, state = _trainer(table_dtype, checkpoint_dir=str(tmp_path))
    state, losses = _fit(first, state, 4)
    path = first.save(state)
    assert os.path.basename(path) == "step_4.pt" and os.listdir(tmp_path) == ["step_4.pt"]

    second, fresh = _trainer(table_dtype, checkpoint_dir=str(tmp_path))
    before = _snapshot(fresh)
    restored = second.restore(fresh)
    assert restored.step == 4 and restored.optimizer.count == 4
    assert restored.model is fresh.model  # loaded in place
    assert any(not torch.equal(v, before[k]) for k, v in _snapshot(restored).items())
    restored, more = _fit(second, restored, 6, start=4)
    assert restored.step == 10 and losses + more == straight_losses
    want, got = _snapshot(straight), _snapshot(restored)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
    if table_dtype is torch.bfloat16:
        assert got["model.item_embedding.embedding"].dtype == torch.bfloat16
        # moments in the tables' dtype: two bf16 pairs among the f32 ones
        assert sum(v.dtype == torch.bfloat16 for k, v in got.items() if k[:2] in ("mu", "nu")) == 4


def test_checkpoint_every_prunes_to_max_to_keep(tmp_path):
    trainer, state = _trainer(torch.float32, checkpoint_dir=str(tmp_path / "ckpt"),
                              checkpoint_every=2, max_to_keep=2)
    state, _ = _fit(trainer, state, 7)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_4.pt", "step_6.pt"]
    trainer.save(state)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_6.pt", "step_7.pt"]
    other, fresh = _trainer(torch.float32, checkpoint_dir=str(tmp_path / "ckpt"))
    assert other.restore(fresh).step == 7  # the newest by step number, not by name


def test_restore_with_no_checkpoint_returns_the_state(tmp_path):
    trainer, state = _trainer(torch.float32, checkpoint_dir=str(tmp_path / "none"))
    assert trainer.restore(state) is state
    os.makedirs(tmp_path / "none")
    (tmp_path / "none" / "step_3.pt.tmp").write_bytes(b"cut off")  # an unfinished write
    assert trainer.restore(state) is state


def test_save_and_restore_need_a_checkpoint_dir():
    trainer, state = _trainer(torch.float32)
    with pytest.raises(ValueError):
        trainer.save(state)
    with pytest.raises(ValueError):
        trainer.restore(state)


def test_restore_refuses_another_models_moments(tmp_path):
    trainer, state = _trainer(torch.float32, checkpoint_dir=str(tmp_path))
    trainer.save(state)
    other, fresh = _trainer(torch.bfloat16, checkpoint_dir=str(tmp_path))
    with pytest.raises((RuntimeError, ValueError)):
        fresh.optimizer.load_state_dict(state.optimizer.state_dict())


# ------------------------------------------------------------ copied modules
def test_tensorboard_writer_writes_the_originals_bytes(tmp_path, monkeypatch):
    clock = iter(np.arange(1000.0, 1100.0, 0.5))
    files = []
    for mod in (jax_tensorboard, tensorboard):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
        mod.SummaryWriter._seq = 0
        w = mod.SummaryWriter(str(tmp_path / mod.__name__))
        w.scalar("train/loss", 0.69, step=1)
        w.scalars({"loss": 0.5, "step": 7, "ok": True, "nan": float("nan"), "n": 3}, 7, "run/")
        w.close()
        files.append(w.path)
    assert next(clock) == 1000.0
    ours, theirs = (open(f, "rb").read() for f in files)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    assert ours == theirs and len(ours) > 100
    assert tensorboard.read_scalars(files[1]) == jax_tensorboard.read_scalars(files[0])
    assert [(s, t) for s, t, _ in tensorboard.read_scalars(files[1])] == [
        (1, "train/loss"), (7, "run/loss"), (7, "run/n")]
    assert tensorboard.crc32c(b"123456789") == 0xE3069283


def _write_tsv(path):
    rng = np.random.default_rng(0)
    lines = []
    for u in range(40):
        n = int(rng.integers(1, 9))
        items = [f"item{int(i)}" for i in rng.integers(0, 30, size=n + 1)]
        cats = [f"cat{int(i[4:]) % 6}" for i in items]
        lines.append("\t".join([str(u % 2), f"u{u}", items[0], cats[0],
                                "\x02".join(items[1:]), "\x02".join(cats[1:])]))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_amazon_pipeline_bit_identical(tmp_path):
    tsv = _write_tsv(tmp_path / "train.tsv")
    ours, ref = amazon.build_vocab(tsv), jax_amazon.build_vocab(tsv)
    assert ours == ref
    iv, cv, i2c = ours
    amazon.save_vocab(str(tmp_path), iv, cv, i2c)
    assert amazon.load_vocab(str(tmp_path)) == jax_amazon.load_vocab(str(tmp_path))
    a, b = amazon.encode_dataset(tsv, iv, cv, 6), jax_amazon.encode_dataset(tsv, iv, cv, 6)
    arr = amazon.make_item2cat_array(iv, cv, i2c)
    np.testing.assert_array_equal(arr, jax_amazon.make_item2cat_array(iv, cv, i2c))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    kw = dict(sample_negative=True, seed=3, epochs=2)
    mine = list(amazon.dien_batches(a, 8, len(iv), arr, **kw))
    theirs = list(jax_amazon.dien_batches(b, 8, len(iv), arr, **kw))
    assert len(mine) == len(theirs) == 10
    for x, y in zip(mine, theirs):
        assert x.keys() == y.keys() and "neg_his_cat" in x
        for k in x:
            assert x[k].tobytes() == y[k].tobytes(), k
