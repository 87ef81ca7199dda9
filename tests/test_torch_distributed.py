"""Multi-process runs of the port: the entry points launched as two CPU
ranks over gloo, checkpoints across meshes, data-parallel training and the
dry run.

Mirrors ``tests/test_multihost.py`` (two processes rendezvous, each feeds
its slice, and the run tracks a single process), ``test_dp_equivalence.py``
(one global batch, the same losses on one rank and on a data axis) and
``__graft_entry__.py::dryrun_multichip``. Ranks are spawned processes
(``torch_dist_workers``); an entry point joins the group from its own
``--coordinator_address`` (a rendezvous file here) ``--num_processes 2
--process_id r``.

Tolerances: ``--lookup_mode psum`` equals the single process bit for bit
(losses and the trained bf16 table): each shard's K1 sums its ids in the
whole table's sorted positions, and the rounding noise is the whole
table's. The all-to-all exchange serves the same vectors; its K1 sums each
row's cotangents as two half-weighted copies: losses within 1e-6. DIN on a
(2, 1) mesh against one rank, the input BatchNorm's statistics the global
batch's: within the JAX test's rtol 1e-4, atol 1e-5 over four steps; one
rank against the JAX Trainer on one device: the first loss within 1e-5,
the four within ``tests/test_torch_dien.py``'s 1e-3.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.data.synthetic import SyntheticSequence
from recommender_tpu.models.dien import DIN as JaxDIN
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu_torch import dryrun
from recommender_tpu_torch.dryrun import dryrun_multichip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CTR = ["--synthetic", "--device", "cpu", "--vocab_size", "2000", "--embedding_size", "8",
       "--train_batch_size", "64", "--test_batch_size", "128", "--eval_batches", "2",
       "--log_every", "1", "--eval_every", "0", "--steps", "6", "--embed_dtype", "bf16"]


def _launch(tmp_path, world=2):
    return ["--coordinator_address", f"file://{tmp_path}/cli_rdzv", "--num_processes", str(world)]


def _whole(ranks, name):
    return np.concatenate([r["tables"][name][0] for r in sorted(
        ranks, key=lambda r: r["tables"][name][1])])


@pytest.fixture(scope="module")
def single_ctr():
    """The single-process run every two-rank run is held to."""
    torch.set_num_threads(1)
    return W.cli_main(0, 1, "", "train_ctr", CTR)


@pytest.mark.parametrize("mode", ["psum", "a2a", "auto"])
def test_train_ctr_two_processes_at_model_2_track_one(tmp_path, single_ctr, mode):
    extra = ["--mesh_model", "2", "--lookup_mode", mode, "--replicate_below_mb", "0"]
    if mode == "a2a":
        extra += ["--log_all_hosts"]
    ranks = W.spawn(W.cli_main, 2, tmp_path, "train_ctr", CTR + extra + _launch(tmp_path),
                    init=False)
    assert all(r["step"] == 6 for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    shards = [r["tables"]["embedding"] for r in ranks]
    assert [s[0].shape for s in shards] == [(1000, 8)] * 2 and shards[1][1] == 1000
    if mode == "a2a":
        np.testing.assert_allclose(ranks[0]["losses"], single_ctr["losses"], rtol=0, atol=1e-6)
        for rank, r in enumerate(ranks):  # every rank logs, tagged
            assert r["lines"] and all(m["process"] == rank for m in r["lines"])
            assert all(m["a2a_overflow"] == 0 for m in r["lines"] if "loss" in m)
        return
    assert ranks[0]["losses"] == single_ctr["losses"]
    np.testing.assert_array_equal(_whole(ranks, "embedding"), single_ctr["tables"]["embedding"][0])
    assert not ranks[1]["lines"]  # only rank 0 logs
    assert ranks[0]["lines"][-1] == single_ctr["lines"][-1]  # the final exact eval
    if mode == "auto":  # the planner's choice, logged
        plan = [m for m in ranks[0]["lines"] if "shard_plan" in m]
        assert plan and plan[0]["lookup_mode"] == "psum" and "row-sharded" in plan[0]["shard_plan"]


def test_train_ctr_on_a_data_axis(tmp_path):
    """(2, 1): each rank streams its rows ``d::2`` at half the batch; the
    losses are the data group's averages, the final AUC the histogram's
    summed over both (the exact AUC is single-rank only)."""
    ranks = W.spawn(W.cli_main, 2, tmp_path, "train_ctr",
                    CTR + ["--mesh_data", "2", "--dedup_lookup", "on"] + _launch(tmp_path),
                    init=False)
    assert ranks[0]["losses"] == ranks[1]["losses"] and np.isfinite(ranks[0]["losses"]).all()
    final = ranks[0]["lines"][-1]
    assert final["final"] == 1 and "eval_auc_exact" not in final and final["eval_auc"] > 0.5
    np.testing.assert_array_equal(ranks[0]["tables"]["embedding"][0],
                                  ranks[1]["tables"]["embedding"][0])


def test_train_esmm_two_processes_with_the_planner(tmp_path):
    args = ["--synthetic", "--device", "cpu", "--model_type", "MMOE", "--embedding_size", "8",
            "--train_batch_size", "256", "--test_batch_size", "2048", "--learning_rate", "3e-3",
            "--log_every", "2", "--eval_every", "0", "--steps", "4"]
    single = W.cli_main(0, 1, "", "train_esmm", args)
    ranks = W.spawn(W.cli_main, 2, tmp_path, "train_esmm",
                    args + ["--mesh_model", "2", "--replicate_below_mb", "0"] + _launch(tmp_path),
                    init=False)
    plan = [m for m in ranks[0]["lines"] if "shard_plan" in m]
    assert plan and plan[0]["shard_plan"].count("row-sharded / psum") == 18
    assert ranks[0]["losses"] == single["losses"] == ranks[1]["losses"]
    assert ranks[0]["lines"][-1] == single["lines"][-1]  # cvr and ctcvr AUC
    for j in (0, 17):
        name = f"embedder.feat_{j}"
        np.testing.assert_array_equal(_whole(ranks, name), single["tables"][name][0])


def test_checkpoint_restores_across_meshes(tmp_path):
    """Saved at (1, 2), restored at (1, 1); saved at (1, 1), restored at
    (1, 2): both continue as the uninterrupted run, bit for bit (bf16 table,
    stochastic rounding, Adam's moments)."""
    straight = W.ctr_checkpoint(0, 1, "", (1, 1), str(tmp_path / "straight"), 6, True)
    W.spawn(W.ctr_checkpoint, 2, tmp_path, (1, 2), str(tmp_path / "a"), 3, True)
    resumed = W.ctr_checkpoint(0, 1, "", (1, 1), str(tmp_path / "a"), 3, False)
    W.ctr_checkpoint(0, 1, "", (1, 1), str(tmp_path / "b"), 3, True)
    regrown = W.spawn(W.ctr_checkpoint, 2, tmp_path, (1, 2), str(tmp_path / "b"), 3, False)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_3.pt"]
    for got in (resumed, *regrown):
        assert got["step"] == 6
        np.testing.assert_array_equal(got["table"], straight["table"])
        np.testing.assert_array_equal(got["mu"], straight["mu"])
        for name, value in straight["dense"].items():
            np.testing.assert_array_equal(got["dense"][name], value)


def _din_setup():
    gen = SyntheticSequence(num_items=64, num_cats=8, max_len=6, seed=0)
    train = gen.sample(512, seed=1)
    it = jax_batch_iterator(train, 64, seed=3, epochs=None)
    batches = [next(it) for _ in range(4)]
    model = JaxDIN(**W.DIN_KW)
    params, model_state = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    return model, params, model_state, batches


def test_dp_matches_one_rank_and_jax(tmp_path):
    model, params, model_state, batches = _din_setup()
    np_params = jax.tree.map(np.asarray, params)  # before the donating steps
    np_stats = jax.tree.map(np.asarray, model_state["batch_stats"])
    loss_fn, _ = jax_make_ctr_task(model)
    tr = JaxTrainer(loss_fn, JaxTrainConfig(learning_rate=1e-3, log_every=1))
    state = tr.init_state(lambda: (params, model_state))
    want = []
    for b in batches:
        state, metrics = tr._train_step(state, tr.put_batch(b), jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    one = W.spawn(W.din_losses, 1, tmp_path, np_params, np_stats, batches, 1e-3)[0]
    two = W.spawn(W.din_losses, 2, tmp_path, np_params, np_stats, batches, 1e-3)
    # one rank against JAX: the bound tests/test_torch_dien.py holds DIN's
    # trajectory to (bf16 MLPs rounding apart under Adam)
    assert abs(one["losses"][0] - want[0]) <= 1e-5
    np.testing.assert_allclose(one["losses"], want, rtol=0, atol=1e-3)
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4, atol=1e-5)
        # the global batch's statistics moved the running mean of both ranks
        np.testing.assert_allclose(r["bn_mean"], one["bn_mean"], rtol=0, atol=1e-6)
        # the init's eval: the histograms and sums of both ranks, summed
        for key in ("eval_auc", "eval_loss", "eval_accuracy"):
            assert abs(r["eval"][key] - one["eval"][key]) <= 1e-6, key
    assert two[0]["eval"]["eval_batches"] == len(batches)


@pytest.mark.parametrize("spec", [(2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_dryrun_multichip(tmp_path, spec):
    ranks = W.spawn(W.dryrun, 4, tmp_path, spec)
    assert all(r == ranks[0] for r in ranks)
    assert all(np.isfinite(v) for v in ranks[0].values())
    single = dryrun_multichip("cpu")
    assert set(single) == {"dlrm", "pinsage"} and all(np.isfinite(v) for v in single.values())


def test_dryrun_entry_point_runs_where_asked(tmp_path):
    """``python -m recommender_tpu_torch.dryrun``: two ranks joining from
    their flags run the (1, 2) mesh on the CPU when asked; the default
    device is the card, and with no card it raises instead of running on
    the CPU."""
    ranks = W.spawn(W.dryrun_cli, 2, tmp_path, init=False)
    assert ranks[0] == ranks[1] and all(np.isfinite(v) for v in ranks[0].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main([])


def test_data_parallel_serving_equals_one_rank(tmp_path):
    """``mesh=`` splits each scoring batch's users (the tail padded to
    divide) and each corpus batch's nodes over the data axis: every rank
    returns one rank's answer."""
    rng = np.random.default_rng(0)
    num_items = 36
    reprs = rng.normal(size=(num_items, 8)).astype(np.float32)
    latest = rng.integers(0, num_items, 23)
    seen = rng.random((23, num_items)) < 0.2
    one = W.serve_sharded(0, 1, "", reprs, latest, seen, num_items, 1)
    for r in W.spawn(W.serve_sharded, 2, tmp_path, reprs, latest, seen, num_items, 1):
        np.testing.assert_array_equal(r["recs"], one["recs"])
        np.testing.assert_allclose(r["corpus"], one["corpus"], rtol=0, atol=1e-6)
    assert one["recs"].shape == (23, 5) and one["corpus"].shape == (num_items, 8)
