"""Offline item-to-item retrieval from an exported serving bundle.

Port of ``recommender_tpu/cli/serve.py``, with ``--device`` (``cuda`` by
default; with no card it raises). The bundle's corpus (f32, or int8 with
its scales) and IVF index are copied to the device once; each batch of
queries is then scored there (``retrieval.export.serve_topk``).

Usage:
  python -m recommender_tpu_torch.cli.serve --bundle bundle.npz --items 3,17,42
  python -m recommender_tpu_torch.cli.serve --bundle bundle.npz --all --out recs.npz
  python -m recommender_tpu_torch.cli.serve --bundle ivf.npz --items 3 --probes 8

``--exact`` and ``--recall_target`` are accepted: the reduction is always
the exact top-k (JAX's ``approx_max_k`` is a TPU reduction; off the TPU
JAX computes the exact one too).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from recommender_tpu_torch.cli.common import resolve_device
from recommender_tpu_torch.retrieval.export import device_bundle, load_serving_bundle, serve_topk


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve top-k from a bundle")
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--items", type=str, default="",
                    help="comma-separated query item ids")
    ap.add_argument("--all", action="store_true", help="recommend for every item")
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--out", type=str, default="", help="npz output (with --all)")
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--exact", action="store_true",
                    help="exact top-k ordering (the only reduction here: accepted "
                         "for the JAX entry point's flags)")
    ap.add_argument("--recall_target", type=float, default=0.95,
                    help="approx_max_k's recall target in the JAX entry point; "
                         "accepted and ignored (the reduction is exact)")
    ap.add_argument("--probes", type=int, default=0,
                    help="IVF clustered serving: score only this many "
                         "probed buckets (+ spill) per query instead of "
                         "the full corpus — needs a bundle exported with "
                         "ivf_clusters (retrieval/ivf.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to serve on; 'cuda' needs a card")
    args = ap.parse_args(argv)
    device = resolve_device(args)
    topk_kw = dict(exact=args.exact, recall_target=args.recall_target,
                   probes=args.probes)

    bundle = load_serving_bundle(args.bundle)
    n = len(bundle.get("item_reprs", bundle.get("item_reprs_int8", [])))
    # the corpus, its scales and the IVF index cross to the device once;
    # neighbor tables stay on the host
    bundle = device_bundle(bundle, device)
    if args.probes > 0 and "ivf_bucket_ids" in bundle:
        # the IVF candidate gather materializes [Q, probes, cap, D]; cap
        # the per-call size as JAX's entry point does
        cap, d = bundle["ivf_bucket_q"].shape[1], bundle["ivf_bucket_q"].shape[2]
        limit = (1536 << 20) // max(args.probes * cap * d, 1)
        if args.batch_size > limit:
            print(json.dumps({"batch_size_capped": limit,
                              "was": args.batch_size,
                              "reason": "ivf candidate gather > 1.5GB"}))
            args.batch_size = max(limit, 1)
    if args.all:
        recs = np.concatenate(
            [
                serve_topk(bundle, np.arange(s, min(s + args.batch_size, n)),
                           args.top_k, **topk_kw)
                for s in range(0, n, args.batch_size)
            ],
            axis=0,
        )
        if args.out:
            np.savez_compressed(args.out, recommendations=recs)
            print(json.dumps({"items": n, "top_k": args.top_k, "out": args.out}))
        else:
            print(json.dumps({"items": n, "top_k": args.top_k}))
        return recs
    ids = np.array([int(x) for x in args.items.split(",") if x != ""], np.int64)
    recs = serve_topk(bundle, ids, args.top_k, **topk_kw)
    for i, r in zip(ids.tolist(), recs.tolist()):
        print(json.dumps({"item": i, "recommendations": r}))
    return recs


if __name__ == "__main__":
    main()
