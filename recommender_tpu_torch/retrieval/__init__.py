from recommender_tpu_torch.retrieval.eval import (
    full_corpus_reprs,
    hit_rate,
    recommend_topk,
    recommend_topk_from_queries,
    resolve_seen_format,
)
from recommender_tpu_torch.retrieval.export import (
    device_bundle,
    export_serving_bundle,
    load_serving_bundle,
    serve_topk,
)
from recommender_tpu_torch.retrieval.ivf import IVFIndex, build_ivf, kmeans, search_ivf
from recommender_tpu_torch.retrieval.quantize import (
    quantize_reprs,
    recommend_topk_quantized,
    topk_quantized,
)
from recommender_tpu_torch.retrieval.scoring import make_scorer, score_batches

__all__ = [
    "IVFIndex",
    "build_ivf",
    "device_bundle",
    "export_serving_bundle",
    "full_corpus_reprs",
    "hit_rate",
    "kmeans",
    "load_serving_bundle",
    "make_scorer",
    "quantize_reprs",
    "recommend_topk",
    "recommend_topk_from_queries",
    "recommend_topk_quantized",
    "resolve_seen_format",
    "score_batches",
    "search_ivf",
    "serve_topk",
    "topk_quantized",
]
