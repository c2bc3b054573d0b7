"""k-means over embeddings in PyTorch: the counterpart of the reference's
`distributed_crawler_tpu/models/clustering.py` (BASELINE config #5:
snowball crawl -> E5-large embed -> clustering).

The same arithmetic as the reference, op for op:

- assignment is one ``[N, D] x [D, K]`` product: ``||x - c||²`` less the
  per-row ``||x||²`` is ``-2 x·c + ||c||²``, taken in f32 in that order
  (not `torch.cdist`), since its rounding decides ties and k-means++'s
  zero distances; ``argmin`` returns the first minimum in both libraries;
- the update is the one-hot product ``onehotᵀ @ x`` in f32, a fixed-order
  segment sum (``index_add_`` sums with atomics on the card, in no fixed
  order); id ``k`` (a padding row) has an all-zero one-hot row, as
  ``jax.nn.one_hot`` gives it;
- `fit` is a Python loop of those two (no compile); k-means++ seeding
  draws one row per round, by the inverse CDF the reference's
  ``jax.random.choice`` uses, from a ``torch.Generator``.  JAX's PRNG
  cannot be reproduced, so the seeded centroids differ from the
  reference's; `_lloyd` runs the iterations from given centroids.

On the card, the two products run without TF32 (`full_f32`).
``fit_sharded`` waits for the port's mesh.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Optional, Tuple

import torch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # [K, D] f32
    assignments: torch.Tensor   # [N] int32
    inertia: torch.Tensor       # scalar f32: sum of squared distances


@contextlib.contextmanager
def full_f32(device: torch.device) -> Iterator[None]:
    """f32 products at full precision on the card for the block: TF32
    would move near-tie assignments.  Only writes the flag when it was
    on, and puts it back after."""
    flags = torch.backends.cuda.matmul
    if device.type != "cuda" or not flags.allow_tf32:
        yield
        return
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = True


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm, the norm clamped at 1e-12."""
    return x / torch.linalg.vector_norm(x, dim=1,
                                        keepdim=True).clamp_min(1e-12)


def _pairwise_neg_scores(x: torch.Tensor,
                         centroids: torch.Tensor) -> torch.Tensor:
    """-2 x·c + ||c||² for argmin distance (x² is constant per row).
    x [N, D], centroids [K, D] -> [N, K] f32."""
    x = x.float()
    c = centroids.float()
    with full_f32(x.device):
        return -2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment [N] int32."""
    return torch.argmin(_pairwise_neg_scores(x, centroids),
                        dim=1).to(torch.int32)


def update(x: torch.Tensor, assignments: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums [K, D] and counts [K] (f32) by the one-hot product.
    An id outside [0, k) (padding rows carry ``k``) adds nothing."""
    ids = torch.arange(k, device=assignments.device)
    onehot = (assignments.long()[:, None] == ids[None, :]).float()  # [N, K]
    with full_f32(x.device):
        sums = onehot.T @ x.float()                                 # [K, D]
    counts = torch.sum(onehot, dim=0)                               # [K]
    return sums, counts


def _choice(probs: torch.Tensor, generator: torch.Generator) -> int:
    """One index drawn with probabilities ``probs``, by the inverse CDF of
    ``jax.random.choice``: the first index whose running sum reaches
    ``total·(1 - u)``.  A zero-probability row is never drawn while others
    remain; when every probability is 0 (fewer distinct rows than
    rounds) the draw is index 0, as the reference's is.  The draw is made
    on the host, so the card and the CPU agree on the same ``probs``."""
    cum = torch.cumsum(probs.detach().to("cpu", torch.float32), dim=0)
    u = torch.rand((), generator=generator)
    r = cum[-1] * (1.0 - u)
    idx = int(torch.searchsorted(cum, r.reshape(1)).item())
    return min(idx, cum.numel() - 1)


def kmeans_plus_plus_init(x: torch.Tensor, k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Distance-weighted seeding, one new centre per round.  Like the
    reference, the first pick is tiled ``k`` times and each round's
    squared distances are taken against all ``k`` rows, clamped at 0."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=generator).item())
    xf = x.float()
    centroids = xf[first][None, :].repeat(k, 1)
    x_sq = torch.sum(xf ** 2, dim=1, keepdim=True)
    for i in range(1, k):
        d2 = torch.min(torch.clamp_min(
            _pairwise_neg_scores(x, centroids) + x_sq, 0.0), dim=1).values
        probs = d2 / torch.clamp_min(torch.sum(d2), 1e-12)
        centroids[i] = xf[_choice(probs, generator)]
    return centroids


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, k: int,
          iters: int) -> KMeansResult:
    """``iters`` Lloyd iterations from ``centroids``; an empty cluster
    keeps its previous centroid.  The inertia is taken against the final
    centroids."""
    centroids = centroids.float()
    for _ in range(iters):
        assignments = assign(x, centroids)
        sums, counts = update(x, assignments, k)
        fresh = sums / torch.clamp_min(counts, 1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], fresh, centroids)
    assignments = assign(x, centroids)
    diff = x.float() - centroids[assignments.long()]
    inertia = torch.sum(diff * diff)
    return KMeansResult(centroids=centroids, assignments=assignments,
                        inertia=inertia)


def fit(x: torch.Tensor, k: int, iters: int = 25,
        generator: Optional[torch.Generator] = None,
        init: str = "kmeans++") -> KMeansResult:
    """Lloyd's algorithm on ``x``'s device.  x [N, D] (any float dtype;
    accumulation in f32).  ``generator`` (default seed 0) draws the seeds:
    k-means++ (``init="kmeans++"``) or ``k`` distinct rows
    (``init="random"``)."""
    if init not in ("kmeans++", "random"):
        raise ValueError(f"unknown init {init!r}")
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    if init == "kmeans++":
        centroids = kmeans_plus_plus_init(x, k, gen)
    else:
        idx = torch.randperm(x.shape[0], generator=gen)[:k]
        centroids = x[idx.to(x.device)].float()
    return _lloyd(x, centroids, k, iters)
