"""PinSage entry: GNN retrieval on MovieLens.

Port of ``recommender_tpu/cli/train_pinsage.py``. On a mesh each data rank samples its
own stream (its seed offset by its data coordinate), the tables are built on
the mesh (their lookups average their gradients over the data axis), and
rank 0 writes the export.

Usage:
  python -m recommender_tpu_torch.cli.train_pinsage --synthetic
  python -m recommender_tpu_torch.cli.train_pinsage --data_dir ml-1m/
  python -m recommender_tpu_torch.cli.train_pinsage --synthetic \
      --export bundle.npz --export_int8 --export_ivf_clusters 8
  python -m recommender_tpu_torch.cli.train_pinsage --synthetic --device cpu

Training batches are the host block sampler's
(``models.pinsage_task.pinsage_train_batches``; the native sampler where
``native/libgraph_sampler.so`` loads), read in ``Trainer.fit``'s prefetch
thread. The stream is the JAX entry point's for the same seed: its first
batch is the init example and training starts at the second. ``--resume``
restores the newest checkpoint and advances the stream past the batches
its steps took, so a resumed run continues the straight run's stream.
At the end every item's repr is computed from fresh sampled blocks, each
user's latest item queries the top-k of unseen items, and the final line
holds ``hit_rate``; ``--export`` writes the serving bundle (f32, or int8
with ``--export_int8``, with an IVF index with ``--export_ivf_clusters``).
"""
from __future__ import annotations

import numpy as np

from recommender_tpu_torch.cli.common import (
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    make_logger,
    resolve_device,
    setup_distributed,
)
from recommender_tpu_torch.data.movielens import ground_truth_matrix, parse_movielens
from recommender_tpu_torch.graph.bipartite import BipartiteGraph
from recommender_tpu_torch.models.pinsage import ItemFeatures, PinSage
from recommender_tpu_torch.models.pinsage_task import make_pinsage_task, pinsage_train_batches
from recommender_tpu_torch.models.tasks import init_model
from recommender_tpu_torch.retrieval.eval import full_corpus_reprs, hit_rate, recommend_topk


def _synthetic(seed=0):
    """The JAX entry point's synthetic set, draw for draw: 400 users in 8
    communities, 200 items, 12 interactions a user (90% in-community)."""
    rng = np.random.default_rng(seed)
    num_users, num_items, num_comm = 400, 200, 8
    u_comm = rng.integers(0, num_comm, num_users)
    blocks = np.array_split(np.arange(num_items), num_comm)
    us, its = [], []
    for u in range(num_users):
        pool = blocks[u_comm[u]]
        for _ in range(12):
            it = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(num_items))
            us.append(u)
            its.append(it)
    g = BipartiteGraph(us, its, num_users, num_items)
    feats = ItemFeatures(
        year=rng.integers(0, 10, num_items).astype(np.int32),
        genre=(rng.random((num_items, 8)) < 0.3).astype(np.float32),
    )
    latest = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    test_item = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    seen = np.zeros((num_users, num_items), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    return g, feats, latest, test_item, seen


def read_movielens(data_dir: str):
    """``ratings.dat`` and ``movies.dat`` of a MovieLens directory, parsed."""
    with open(f"{data_dir}/ratings.dat", encoding="latin-1") as f:
        ratings = f.readlines()
    with open(f"{data_dir}/movies.dat", encoding="latin-1") as f:
        movies = f.readlines()
    return parse_movielens(ratings, movies)


def main(argv=None):
    p = base_parser("PinSage training (MovieLens)")
    p.add_argument("--data_dir", type=str, default="", help="dir with ratings.dat/movies.dat")
    p.add_argument("--embedding_size", type=int, default=8)
    p.add_argument("--conv_hidden_size", type=int, default=64)
    p.add_argument("--conv_output_size", type=int, default=32)
    p.add_argument("--num_neighbors", type=int, default=3)
    p.add_argument("--num_random_walks", type=int, default=4)
    p.add_argument("--random_walk_length", type=int, default=2)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of trained item reprs")
    p.add_argument("--export_int8", action="store_true",
                   help="quantize the exported corpus to int8 + per-row "
                        "scales (4x smaller bundle, int8 serving path)")
    p.add_argument("--export_ivf_clusters", type=int, default=0,
                   help="also pack an IVF index (k-means buckets + spill) "
                        "into the bundle; cli/serve --probes N then serves "
                        "the clustered small-Q latency path")
    p.set_defaults(train_batch_size=32)
    args = p.parse_args(argv)
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)

    if args.synthetic or not args.data_dir:
        g, feats, latest, test_item, seen = _synthetic(args.seed)
    else:
        data = read_movielens(args.data_dir)
        g, feats = data.graph, data.features
        latest, test_item, seen = data.latest_train_item, data.test_user_item, data.train_seen

    model = PinSage(
        features=feats, embed_dim=args.embedding_size,
        conv_hidden=args.conv_hidden_size, conv_out=args.conv_output_size, mesh=mesh,
        device=device,
    )
    loss_fn = make_pinsage_task(model)
    sampler_kw = dict(
        num_neighbors=args.num_neighbors, num_walks=args.num_random_walks,
        walk_length=args.random_walk_length,
    )
    # each data rank samples with its own seed: disjoint random streams
    it = pinsage_train_batches(g, host_batch_size(args.train_batch_size, mesh),
                               seed=args.seed + mesh.data_index, **sampler_kw)
    trainer = build_trainer(args, loss_fn, None, device=device, mesh=mesh)
    next(it)  # the batch the JAX entry point's init takes as its shape example
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        for _ in range(state.step):  # the batches the restored steps trained on
            next(it)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    rng = np.random.default_rng(args.seed + 1)
    reprs = full_corpus_reprs(model, g, rng, **sampler_kw)
    recs = recommend_topk(reprs, latest, seen, k=args.top_k, device=device)
    gt = ground_truth_matrix(test_item, g.num_items)
    log({"final": 1, "hit_rate": hit_rate(recs, gt)})
    if args.export and mesh.rank == 0:  # one writer
        from recommender_tpu_torch.retrieval.export import export_serving_bundle

        nbr, w = g.importance_neighbors(
            np.arange(g.num_items), rng=rng,
            num_neighbors=args.num_neighbors, num_walks=args.num_random_walks,
            walk_length=args.random_walk_length,
        )
        export_serving_bundle(
            args.export, reprs, nbr, w,
            metadata={"model": "pinsage", "conv_out": args.conv_output_size},
            quantize=args.export_int8,
            ivf_clusters=args.export_ivf_clusters,
            device=device,
        )
        log({"exported": args.export})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()
