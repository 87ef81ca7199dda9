"""Graph item-embedding entry: BGE (DeepWalk) / GES / EGES.

Port of ``recommender_tpu/cli/train_eges.py``. On a mesh each data rank samples its
own stream (its seed offset by its data coordinate), the tables are built on
the mesh (their lookups average their gradients over the data axis), and
rank 0 writes the export.

Usage:
  python -m recommender_tpu_torch.cli.train_eges --model_type EGES --synthetic
  python -m recommender_tpu_torch.cli.train_eges --model_type EGES \
      --meta_file meta_Electronics.json --shared_lr_scale 0.5
  python -m recommender_tpu_torch.cli.train_eges --synthetic --device cpu

Training batches come from weighted random walks on the item graph
(``graph.walks.skipgram_batches``, the native sampler where
``native/libgraph_sampler.so`` loads), read in ``Trainer.fit``'s
prefetch thread. The stream is the JAX entry point's for the same seed: its
first batch is the init example and training starts at the second. With
``--meta_file`` (Amazon metadata JSON lines) the held-out edges are scored
at the end and the final line holds ``link_prediction_auc``.
``--shared_lr_scale`` scales the shared cat and brand tables' updates
(``TrainConfig.lr_scales``) for GES and EGES. ``--export`` writes every
node's ``get_hidden`` as a serving bundle (int8 with ``--export_int8``),
computed in blocks of at most 2^20 nodes so that device memory holds one
block's side stacks, not the whole corpus's.
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
from recommender_tpu_torch.data import amazon_meta
from recommender_tpu_torch.graph.store import WeightedGraph
from recommender_tpu_torch.graph.walks import skipgram_batches
from recommender_tpu_torch.models.eges import EGES, GES, DeepWalk
from recommender_tpu_torch.models.tasks import init_model, link_prediction_auc, make_skipgram_task
from recommender_tpu_torch.retrieval.export import export_serving_bundle


def _synthetic_graph(num_nodes=2000, num_comm=16, seed=0):
    """The JAX entry point's synthetic graph, draw for draw: nodes in
    ``num_comm`` communities, ~90% of the edges inside one."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_comm, num_nodes)
    src, dst = [], []
    for v in range(1, num_nodes):
        pool = np.where(comm == comm[v])[0]
        for _ in range(10):
            u = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(1, num_nodes))
            if u not in (0, v):
                src += [v, u]
                dst += [u, v]
    g = WeightedGraph.from_edges(src, dst, num_nodes=num_nodes)
    side = {
        "cat": (comm + 1).astype(np.int32),
        "brand": rng.integers(1, 50, num_nodes).astype(np.int32),
    }
    side["cat"][0] = 0
    return g, side, comm


@torch.no_grad()
def corpus_hidden(model, num_nodes: int, side: dict | None, block: int = 1 << 20) -> np.ndarray:
    """[V, D] ``get_hidden`` of every node (the eval forward), in blocks of
    ``block`` ids; the last block padded with node 0, as in JAX."""
    device = next(model.parameters()).device
    model.eval()
    block = min(block, num_nodes)
    chunks = []
    for s0 in range(0, num_nodes, block):
        n = min(block, num_nodes - s0)
        ids = np.pad(np.arange(s0, s0 + n, dtype=np.int32), (0, block - n))
        b = {"target": ids}
        if side is not None:
            b["target_cat"] = side["cat"][ids]
            b["target_brand"] = side["brand"][ids]
        b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        chunks.append(model.get_hidden(b).cpu().numpy()[:n])
    return np.concatenate(chunks, axis=0)


def main(argv=None):
    p = base_parser("Graph item-embedding training (BGE/GES/EGES)")
    p.add_argument("--model_type", choices=["BGE", "GES", "EGES"], default="EGES")
    p.add_argument("--embedding_size", type=int, default=128)
    p.add_argument("--random_walk_length", type=int, default=10)
    p.add_argument("--window_size", type=int, default=5)
    p.add_argument("--num_negatives", type=int, default=5)
    p.add_argument("--meta_file", type=str, default="")
    p.add_argument("--export", type=str, default="",
                   help="write a serving bundle (npz) of every node's hidden vector")
    p.add_argument("--export_int8", action="store_true",
                   help="with --export: quantize the corpus to int8 + per-row scales")
    p.add_argument("--shared_lr_scale", type=float, default=1.0,
                   help="GES/EGES: multiply the shared side tables' (cat, brand) updates "
                        "after Adam by this factor; 1.0 = reference semantics")
    args = p.parse_args(argv)
    if args.shared_lr_scale != 1.0 and args.model_type != "BGE":
        args.lr_scales = {
            "cat_embedding": args.shared_lr_scale,
            "brand_embedding": args.shared_lr_scale,
        }
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)
    use_side = args.model_type in ("GES", "EGES")

    if args.synthetic or not args.meta_file:
        g, side, _ = _synthetic_graph(seed=args.seed)
        cat_vocab_size = int(side["cat"].max()) + 1
        brand_vocab_size = int(side["brand"].max()) + 1
        triples = None
    else:
        with open(args.meta_file) as f:
            pairs, i2c, i2b = amazon_meta.load_metadata(f)
        train_pairs, test_pairs = amazon_meta.train_test_split(pairs, seed=args.seed)
        item2idx, cat_vocab, brand_vocab = amazon_meta.build_vocab(
            train_pairs, pairs, i2c, i2b
        )
        side = amazon_meta.side_info_arrays(item2idx, cat_vocab, brand_vocab, i2c, i2b)
        g = amazon_meta.build_train_graph(train_pairs, pairs, item2idx)
        cat_vocab_size, brand_vocab_size = len(cat_vocab), len(brand_vocab)
        rng = np.random.default_rng(args.seed)
        triples = amazon_meta.link_prediction_triples(
            test_pairs, item2idx, rng, side if use_side else None
        )

    if args.model_type == "BGE":
        model = DeepWalk(vocab_size=g.num_nodes, embed_dim=args.embedding_size, mesh=mesh,
                         device=device)
    else:
        cls = GES if args.model_type == "GES" else EGES
        model = cls(
            vocab_size=g.num_nodes, cat_vocab=cat_vocab_size,
            brand_vocab=brand_vocab_size, embed_dim=args.embedding_size, mesh=mesh,
            device=device,
        )

    loss_fn, eval_fn = make_skipgram_task(model)
    it = skipgram_batches(
        g, walk_length=args.random_walk_length, window=args.window_size,
        num_negatives=args.num_negatives,
        batch_size=host_batch_size(args.train_batch_size, mesh),
        walks_per_round=max(64, args.train_batch_size // 8),
        # each data rank walks with its own seed: disjoint random streams
        side_info=side if use_side else None, seed=args.seed + mesh.data_index,
    )
    trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
    next(it)  # the batch the JAX entry point's init takes as its shape example
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)
    if triples is not None:
        auc = link_prediction_auc(model, triples)
        log({"final": 1, "link_prediction_auc": auc})
    if args.export and mesh.rank == 0:  # one writer
        export_serving_bundle(
            args.export, corpus_hidden(model, g.num_nodes, side if use_side else None),
            metadata={"model": args.model_type, "embed_dim": args.embedding_size},
            quantize=args.export_int8, device=device,
        )
        log({"exported": args.export})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()
