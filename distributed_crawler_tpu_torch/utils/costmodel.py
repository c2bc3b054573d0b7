"""Analytic cost of one embed+classify batch.

`encoder_forward_flops` is the reference's formula
(`distributed_crawler_tpu/utils/costmodel.py:66-75`); the cost table, the
efficiency meter and the H100 peak wait for a later slice.
"""

from __future__ import annotations


def encoder_forward_flops(cfg, batch: int, seq: int) -> float:
    """Analytic forward FLOPs for one embed+classify batch.

    Per token per layer: QKV+out projections (8·d²), attention score+value
    matmuls (4·seq·d), MLP up+down (4·d·ff); a multiply-accumulate counts
    as 2 FLOPs.  Embedding lookup and the d×n_labels head are negligible.
    """
    d, ff, n_layers = cfg.hidden, cfg.mlp_dim, cfg.n_layers
    per_token = n_layers * (8 * d * d + 4 * seq * d + 4 * d * ff)
    return float(batch * seq * per_token)
