"""Two-tower retrieval entry: dual encoders with in-batch softmax.

Port of ``recommender_tpu/cli/train_twotower.py``. On a mesh each data rank samples its
own stream (its seed offset by its data coordinate) and rank 0 writes the
export.

Usage:
  python -m recommender_tpu_torch.cli.train_twotower --synthetic
  python -m recommender_tpu_torch.cli.train_twotower --data_dir ml-1m/ \
      --export bundle.npz --export_int8
  python -m recommender_tpu_torch.cli.train_twotower --synthetic --device cpu

Training pairs are drawn uniformly over the interaction graph's edges
(``models.two_tower.interaction_batches``); the stream is the JAX entry
point's for the same seed, whose first batch is the init example, and
``--resume`` advances it past the restored steps' batches. The negatives
of the in-batch softmax are the other rows of the batch. At the end every
user's tower repr queries the item-tower corpus with the training
interactions excluded, and the final line holds ``hit_rate``; ``--export``
writes the item-tower corpus as a serving bundle.
"""
from __future__ import annotations

import numpy as np
import torch

from recommender_tpu_torch.cli.common import (
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    make_logger,
    resolve_device,
    setup_distributed,
)
from recommender_tpu_torch.cli.train_pinsage import read_movielens
from recommender_tpu_torch.data.movielens import ground_truth_matrix
from recommender_tpu_torch.graph.bipartite import BipartiteGraph
from recommender_tpu_torch.models.tasks import init_model
from recommender_tpu_torch.models.two_tower import (
    TwoTower,
    corpus_item_reprs,
    interaction_batches,
    make_two_tower_task,
)
from recommender_tpu_torch.retrieval.eval import hit_rate, recommend_topk_from_queries


def _synthetic(seed=0, num_users=400, num_items=200, num_comm=8):
    """The JAX entry point's community-structured interactions, draw for
    draw (intra-community positives, a held-out intra-community test item
    per user)."""
    rng = np.random.default_rng(seed)
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
    test_item = np.array([int(rng.choice(blocks[u_comm[u]])) for u in range(num_users)])
    seen = np.zeros((num_users, num_items), bool)
    seen[np.asarray(us), np.asarray(its)] = True
    return g, test_item, seen


@torch.no_grad()
def user_reprs(model: TwoTower, num_users: int) -> np.ndarray:
    """[U, repr_dim] user-tower queries (the eval forward)."""
    model.eval()
    device = next(model.parameters()).device
    return model.user_repr(torch.arange(num_users, device=device)).cpu().numpy()


def main(argv=None):
    p = base_parser("Two-tower retrieval training")
    p.add_argument("--data_dir", type=str, default="",
                   help="dir with ratings.dat/movies.dat (MovieLens)")
    p.add_argument("--embedding_size", type=int, default=32)
    p.add_argument("--repr_size", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of item-tower reprs")
    p.add_argument("--export_int8", action="store_true")
    p.add_argument("--export_ivf_clusters", type=int, default=0)
    p.set_defaults(train_batch_size=1024)
    args = p.parse_args(argv)
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)

    if args.synthetic or not args.data_dir:
        g, test_item, seen = _synthetic(args.seed)
    else:
        data = read_movielens(args.data_dir)
        g, test_item, seen = data.graph, data.test_user_item, data.train_seen

    model = TwoTower(
        user_vocab=g.num_users, item_vocab=g.num_items,
        embed_dim=args.embedding_size, repr_dim=args.repr_size,
        temperature=args.temperature, device=device, mesh=mesh,
        partition="model" if args.mesh_model > 1 else None,
    )
    loss_fn, eval_fn = make_two_tower_task(model)
    # each data rank draws its own pairs; the loss's negatives are the
    # global batch's items (models.two_tower)
    it = interaction_batches(g, host_batch_size(args.train_batch_size, mesh),
                             seed=args.seed + 1000 * mesh.data_index)
    trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
    next(it)  # the batch the JAX entry point's init takes as its shape example
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        for _ in range(state.step):  # the batches the restored steps trained on
            next(it)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    # full-corpus hit-rate: user-tower queries vs item-tower corpus,
    # train interactions excluded (the dual-encoder eval protocol)
    reprs = corpus_item_reprs(model, g.num_items)
    uq = user_reprs(model, g.num_users)
    recs = recommend_topk_from_queries(uq, reprs, seen, k=args.top_k, device=device)
    gt = ground_truth_matrix(test_item, g.num_items)
    log({"final": 1, "hit_rate": hit_rate(recs, gt)})
    if args.export and mesh.rank == 0:  # one writer
        from recommender_tpu_torch.retrieval.export import export_serving_bundle

        export_serving_bundle(
            args.export, reprs,
            metadata={"model": "two_tower", "repr_dim": args.repr_size},
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
