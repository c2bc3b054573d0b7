"""Online spherical mini-batch k-means on the card.

The counterpart of the reference's `distributed_crawler_tpu/cluster/
engine.py`: embeddings stream in as mini-batches and each is folded into
the centroids with the exact per-centre running mean (Sculley's web-scale
mini-batch k-means, WWW 2010, with its 1/n learning rate).  The step is
`cluster_step`, one plain function of tensors per call and no compile,
built from `models/clustering.py`'s `assign` and `update`, so one step is
the Lloyd update applied to one mini-batch.

A mini-batch pads on the host to the smallest row bucket that holds it
(oversized ones chunk by the largest), behind a row mask: pad rows take
the out-of-range id ``k``, whose one-hot row is zero, so they touch
neither sums nor counts.  The centroids ``[K, D]`` and counts ``[K]`` are
f32 tensors on the engine's device; counts stay f32, as the reference's
checkpoint layout has them.  `state_dict` / `load_state` write and read
the reference's JSON layout, so a checkpoint of either engine resumes in
the other.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``.
Each bucket's step is priced at its first dispatch
(`utils/costmodel.kmeans_step_flops`, ``path="cluster"``) and every step
feeds an `EfficiencyMeter` whose tokens are embedding rows, so its
goodput is the assignment rate; `cost_snapshot()` is the engine half of
``/costs``.  The mesh waits for a later slice.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import clustering
from ..utils.costmodel import CostModel, EfficiencyMeter, kmeans_step_flops
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.occupancy import DeviceTimeline

logger = logging.getLogger(__name__)

CHECKPOINT_SCHEMA = "dct-cluster-v1"


@dataclass
class ClusterEngineConfig:
    """Knobs of the online k-means engine (the reference's defaults)."""

    k: int = 16
    # Row-count buckets (ascending): a mini-batch pads to the smallest
    # bucket that fits; oversized groups chunk by the largest.
    buckets: Tuple[int, ...] = (64, 256)
    # Spherical k-means: rows and centroids are L2-normalised, so the
    # assignment is by cosine similarity, the metric of E5 embeddings.
    spherical: bool = True
    seed: int = 0
    # Rolling history of per-step mean inertia.
    inertia_window: int = 256

    def validate(self) -> None:
        if self.k <= 0:
            raise ValueError("cluster k must be positive")
        if not self.buckets or any(int(b) <= 0 for b in self.buckets):
            raise ValueError("cluster buckets must be positive ints")


def cluster_step(centroids: torch.Tensor, counts: torch.Tensor,
                 x: torch.Tensor, mask: torch.Tensor, k: int,
                 spherical: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One online step over a padded mini-batch.  centroids [K, D] f32,
    counts [K] f32, x [B, D], mask [B] (1 = real row) ->
    (new centroids, new counts, assignments [B] int32 with ``k`` on pad
    rows, masked inertia against the new centroids)."""
    x = x.float()
    if spherical:
        x = clustering.l2_normalize(x)
    real = mask != 0
    assigns = clustering.assign(x, centroids)
    assigns = torch.where(real, assigns, k).to(torch.int32)
    sums, bcounts = clustering.update(x, assigns, k)
    new_counts = counts + bcounts
    # c <- (n·c + sum) / (n + batch_n), where the batch has rows.
    fresh = (counts[:, None] * centroids + sums) \
        / torch.clamp_min(new_counts, 1.0)[:, None]
    new_centroids = torch.where((bcounts > 0)[:, None], fresh, centroids)
    if spherical:
        new_centroids = clustering.l2_normalize(new_centroids)
    safe = torch.clamp(assigns, 0, k - 1).long()
    diff = x - new_centroids[safe]
    inertia = torch.sum(torch.sum(diff * diff, dim=1) * real.float())
    return new_centroids, new_counts, assigns, inertia


class ClusterEngine:
    """Streaming mini-batch k-means state and its step.

    ``observe`` / ``state_dict`` / ``load_state`` / ``snapshot`` serialise
    on one lock; the worker's feed loop is the only writer.
    """

    def __init__(self, cfg: ClusterEngineConfig = ClusterEngineConfig(),
                 mesh=None, registry: MetricsRegistry = REGISTRY,
                 device: Optional[Union[str, torch.device]] = None):
        cfg.validate()
        if mesh is not None:
            raise NotImplementedError(
                "multi-device clustering is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.dim: Optional[int] = None
        self.centroids: Optional[torch.Tensor] = None   # [K, D] f32
        self.counts: Optional[torch.Tensor] = None      # [K] f32
        self.step = 0
        self.vectors = 0
        self.resumed_from_step: Optional[int] = None
        self._inertia: "deque[float]" = deque(maxlen=cfg.inertia_window)
        self._buckets = tuple(sorted(int(b) for b in cfg.buckets))
        # Buckets dispatched so far: the first dispatch of each counts as
        # a miss, as the reference counts its jit compiles.
        self._programs: set = set()
        self.m_compile_miss = registry.counter(
            "tpu_engine_compile_cache_misses_total",
            "first dispatches by bucket and path")
        # path="cluster": the meter's gauges become labelled children, so
        # a text engine on the same registry keeps its unlabelled series.
        self.costs = CostModel(registry=registry)
        self.meter = EfficiencyMeter(registry=registry, path="cluster",
                                     device=self.device)
        # Dispatch to readback per step: the card's busy share and the
        # bubbles between the steps of one feed stream.
        self.timeline = DeviceTimeline(registry=registry, path="cluster")

    def _program(self, bucket: int, dim: int) -> None:
        with self._lock:
            first = bucket not in self._programs
            self._programs.add(bucket)
        if first:
            self.m_compile_miss.labels(bucket=str(bucket),
                                       path="cluster").inc()
            self.costs.capture(bucket, "cluster",
                               kmeans_step_flops(self.cfg.k, dim, bucket),
                               batch=bucket, seq=dim)

    def _bucket_for(self, rows: int) -> int:
        for b in self._buckets:
            if rows <= b:
                return b
        return self._buckets[-1]

    # -- seeding -----------------------------------------------------------
    def _seed(self, x: np.ndarray) -> None:
        """k-means++ over all rows of the first mini-batch, normalised
        before and after."""
        xd = torch.from_numpy(x).to(self.device)
        if self.cfg.spherical:
            xd = clustering.l2_normalize(xd)
        centroids = clustering.kmeans_plus_plus_init(
            xd, self.cfg.k, torch.Generator().manual_seed(self.cfg.seed))
        if self.cfg.spherical:
            centroids = clustering.l2_normalize(centroids)
        with self._lock:  # re-entrant: observe() already holds it
            self.centroids = centroids
            self.counts = torch.zeros((self.cfg.k,), dtype=torch.float32,
                                      device=self.device)
        logger.info("cluster engine seeded: k=%d dim=%d from %d rows",
                    self.cfg.k, x.shape[1], x.shape[0])

    # -- public API --------------------------------------------------------
    def observe(self, vectors: Sequence[Sequence[float]]) -> List[int]:
        """Fold one mini-batch of embeddings into the model; returns the
        cluster of each input row, in input order.

        The first call fixes ``dim`` and seeds the centroids; a later
        mini-batch of another dim raises.  Atomic across bucket chunks:
        the chunks step on local state, and the model is committed only
        when every chunk succeeded, so a failure on chunk 2 leaves it as
        it was and the caller's per-batch retry cannot fold chunk 1
        twice.  The device work runs outside the state lock; the single
        writer (one feed loop per engine) makes the commit safe."""
        if not len(vectors):
            return []
        x_all = np.asarray(vectors, dtype=np.float32)
        if x_all.ndim != 2:
            raise ValueError(
                f"embeddings must be a [N, D] matrix, got shape "
                f"{x_all.shape}")
        with self._lock:
            if self.dim is None:
                self.dim = int(x_all.shape[1])
            elif int(x_all.shape[1]) != self.dim:
                raise ValueError(
                    f"embedding dim {x_all.shape[1]} != model dim "
                    f"{self.dim}")
            if self.centroids is None:
                self._seed(x_all)
            centroids, counts = self.centroids, self.counts
        out: List[int] = []
        inertias: List[float] = []
        steps = 0
        cap = self._buckets[-1]
        for off in range(0, x_all.shape[0], cap):
            chunk = x_all[off:off + cap]
            centroids, counts, assigns, inertia = self._dispatch_chunk(
                centroids, counts, chunk)
            out.extend(assigns)
            inertias.append(inertia / max(1, len(chunk)))
            steps += 1
        with self._lock:  # every chunk succeeded: commit
            self.centroids, self.counts = centroids, counts
            self.step += steps
            self.vectors += int(x_all.shape[0])
            self._inertia.extend(inertias)
        return out

    def _dispatch_chunk(self, centroids: torch.Tensor, counts: torch.Tensor,
                        x: np.ndarray):
        """One padded bucket step over explicit state: (new centroids, new
        counts, the real rows' assignments, inertia); the model is left to
        observe()'s commit."""
        rows = int(x.shape[0])
        bucket = self._bucket_for(rows)
        padded = np.zeros((bucket, self.dim), dtype=np.float32)
        padded[:rows] = x
        mask = np.zeros((bucket,), dtype=np.float32)
        mask[:rows] = 1.0
        self._program(bucket, self.dim)
        t0 = time.perf_counter()
        xd = torch.from_numpy(padded).to(self.device)
        md = torch.from_numpy(mask).to(self.device)
        new_centroids, new_counts, assigns, inertia = cluster_step(
            centroids, counts, xd, md, self.cfg.k, self.cfg.spherical)
        # The readback synchronises: the assignments are on the host
        # before the caller commits them.
        host_assigns = assigns[:rows].cpu().tolist()
        host_inertia = inertia.item()
        t1 = time.perf_counter()
        self.timeline.record(t0, t1)
        self.meter.record(t1 - t0, self.costs.flops_for(bucket, "cluster"),
                          real_tokens=rows, slot_tokens=bucket)
        return new_centroids, new_counts, host_assigns, host_inertia

    def assign_only(self, vectors: Sequence[Sequence[float]]) -> List[int]:
        """Nearest-centroid assignment without folding the vectors in: the
        redelivery path (a batch already folded is reassigned for its
        writeback, not counted twice).  Host numpy, as in the reference:
        the rare path."""
        with self._lock:
            if self.centroids is None:
                raise ValueError("cluster model not seeded")
            c = self.centroids.cpu().numpy()
        x = np.asarray(vectors, dtype=np.float32)
        if self.cfg.spherical:
            x = x / np.maximum(
                np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        scores = -2.0 * (x @ c.T) + np.sum(c * c, axis=1)[None, :]
        return [int(i) for i in np.argmin(scores, axis=1)]

    def warmup(self, dim: int) -> None:
        """Dispatch every bucket's step once against throwaway state.  The
        model is untouched: a warmup never seeds."""
        with self._lock:
            if self.centroids is not None and self.dim is not None:
                dim = self.dim  # the live shapes
        k = self.cfg.k
        dummy_c = torch.zeros((k, dim), dtype=torch.float32,
                              device=self.device)
        dummy_n = torch.zeros((k,), dtype=torch.float32, device=self.device)
        for bucket in self._buckets:
            self._program(bucket, dim)
            x = torch.zeros((bucket, dim), dtype=torch.float32,
                            device=self.device)
            mask = torch.ones((bucket,), dtype=torch.float32,
                              device=self.device)
            out = cluster_step(dummy_c, dummy_n, x, mask, k,
                               self.cfg.spherical)
            out[2].cpu()

    # -- checkpoint state --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe model state, in the reference's layout."""
        with self._lock:
            return {
                "schema": CHECKPOINT_SCHEMA,
                "k": self.cfg.k,
                "dim": self.dim,
                "spherical": self.cfg.spherical,
                "step": self.step,
                "vectors": self.vectors,
                "centroids": self.centroids.cpu().numpy().tolist()
                if self.centroids is not None else None,
                "counts": self.counts.cpu().numpy().tolist()
                if self.counts is not None else None,
                "inertia_window": list(self._inertia),
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Resume from a checkpoint written by either package's
        ``state_dict``: the model continues (``resumed_from_step``), it is
        never re-seeded.  Another k or another geometry raises."""
        if int(state.get("k") or 0) != self.cfg.k:
            raise ValueError(
                f"checkpoint k={state.get('k')} != configured k="
                f"{self.cfg.k}")
        if "spherical" in state \
                and bool(state["spherical"]) != self.cfg.spherical:
            raise ValueError(
                f"checkpoint spherical={state['spherical']} != "
                f"configured spherical={self.cfg.spherical}")
        with self._lock:
            self.dim = int(state["dim"]) if state.get("dim") else None
            if state.get("centroids") is not None:
                self.centroids = torch.tensor(
                    state["centroids"], dtype=torch.float32,
                    device=self.device)
                self.counts = torch.tensor(
                    state.get("counts") or [0.0] * self.cfg.k,
                    dtype=torch.float32, device=self.device)
            self.step = int(state.get("step") or 0)
            self.vectors = int(state.get("vectors") or 0)
            self._inertia.clear()
            self._inertia.extend(
                float(v) for v in state.get("inertia_window") or [])
            self.resumed_from_step = self.step

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The model half of the ``/clusters`` body (JSON-safe)."""
        with self._lock:
            sizes = [int(c) for c in self.counts.cpu().tolist()] \
                if self.counts is not None else []
            norms = [round(float(n), 6) for n in torch.linalg.vector_norm(
                self.centroids, dim=1).cpu().tolist()] \
                if self.centroids is not None else []
            inertia = [round(v, 6) for v in self._inertia]
            return {
                "k": self.cfg.k,
                "dim": self.dim,
                "spherical": self.cfg.spherical,
                "buckets": list(self._buckets),
                "n_devices": 1,
                "step": self.step,
                "vectors": self.vectors,
                "seeded": self.centroids is not None,
                "sizes": sizes,
                "nonempty": sum(1 for s in sizes if s > 0),
                "centroid_norms": norms,
                "inertia": inertia,
                "inertia_per_vector": inertia[-1] if inertia else None,
                "resumed_from_step": self.resumed_from_step,
            }

    def underpopulated(self, min_fraction: float = 0.5) -> List[int]:
        """Cluster ids whose share of assignments is under
        ``min_fraction`` of the uniform share (1/k)."""
        with self._lock:
            if self.counts is None or self.vectors <= 0:
                return []
            counts = self.counts.cpu().tolist()
            floor = min_fraction * self.vectors / self.cfg.k
            return [i for i in range(self.cfg.k) if counts[i] < floor]

    def compile_cache_stats(self) -> Dict[str, Any]:
        """Which buckets were dispatched, and the cumulative first-dispatch
        count."""
        misses: Dict[str, float] = {}
        total = 0.0
        for labels, value in self.m_compile_miss.series():
            if not labels or labels.get("path") != "cluster":
                continue
            misses[f"cluster:{labels.get('bucket', '?')}"] = value
            total += value
        with self._lock:
            programs = sorted(self._programs)
        return {"programs_cluster": programs, "misses_total": total,
                "misses": misses}

    def efficiency_snapshot(self) -> Dict[str, Any]:
        """Rolling MFU/goodput map for heartbeats; {} before the first
        step."""
        return self.meter.snapshot()

    def occupancy_snapshot(self) -> Dict[str, Any]:
        """The heartbeat's occupancy map; it also refreshes the
        path="cluster" busy/overlap gauges."""
        return self.timeline.snapshot()

    def cost_snapshot(self) -> Dict[str, Any]:
        """The engine half of the /costs body."""
        return {
            "model": f"kmeans-k{self.cfg.k}",
            "k": self.cfg.k,
            "dim": self.dim,
            "buckets": list(self._buckets),
            "n_devices": 1,
            "costs": self.costs.snapshot(),
            "efficiency": self.meter.snapshot(),
        }
