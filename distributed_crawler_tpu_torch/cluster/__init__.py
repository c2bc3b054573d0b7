"""cluster/ — streaming clustering of the embedding stream (BASELINE
config #5), the port's counterpart of `distributed_crawler_tpu/cluster/`.

`ClusterWorker` consumes the embedding-carrying result batches `TPUWorker`
publishes on ``TOPIC_INFERENCE_RESULTS`` and folds them into online
spherical mini-batch k-means on the card (`ClusterEngine`, built on
`models/clustering.py`); it writes per-batch assignments idempotently,
checkpoints the model in the reference's layout and announces
`ClusterUpdateMessage`s on ``TOPIC_CLUSTERS``.
"""

from .engine import ClusterEngine, ClusterEngineConfig, cluster_step
from .worker import ClusterWorker, ClusterWorkerConfig, iter_assignments

__all__ = [
    "ClusterEngine",
    "ClusterEngineConfig",
    "ClusterWorker",
    "ClusterWorkerConfig",
    "cluster_step",
    "iter_assignments",
]
