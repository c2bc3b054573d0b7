"""Analytic cost of one embed+classify batch, one greedy ASR batch and
one online k-means step.

`encoder_forward_flops`, `whisper_forward_flops` and `kmeans_step_flops`
are the reference's formulas (`distributed_crawler_tpu/utils/
costmodel.py:66-132`); the cost table, the efficiency meter and the H100
peak wait for a later slice.
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


def whisper_forward_flops(cfg, batch: int, decode_len: int) -> float:
    """Analytic forward FLOPs for one greedy ASR batch.

    Encoder (per 30 s window): the two stem convs (3-tap, stride 1 then
    2) plus ``n_audio_layer`` layers over ``n_audio_ctx`` positions —
    QKV+out projections (8·d²), score+value matmuls (4·ctx·d), MLP up+down
    (16·d², ff = 4d) per position.  Cross K/V once per utterance.  Decoder:
    ``decode_len - 1`` single-token steps, each paying the self-attention
    projections and a read of the whole ``n_text_ctx`` cache, the cross
    attention against ``n_audio_ctx`` cached K/V, the MLP and the tied
    logits (d·n_vocab).  A multiply-accumulate counts as 2 FLOPs.
    """
    da, dt = cfg.n_audio_state, cfg.n_text_state
    ctx_a, ctx_t = cfg.n_audio_ctx, cfg.n_text_ctx
    mel_frames = ctx_a * 2
    conv = 2 * (mel_frames * 3 * cfg.n_mels * da
                + ctx_a * 3 * da * da)
    enc_layer = ctx_a * (8 * da * da + 4 * ctx_a * da + 16 * da * da)
    encoder = conv + cfg.n_audio_layer * enc_layer
    cross_kv = cfg.n_text_layer * 2 * (2 * ctx_a * dt * dt)
    steps = max(1, int(decode_len) - 1)
    dec_step_layer = (8 * dt * dt            # self q/k/v/out projections
                      + 4 * ctx_t * dt       # self score+value vs cache
                      + 4 * dt * dt          # cross q + out projections
                      + 4 * ctx_a * dt       # cross score+value vs audio
                      + 16 * dt * dt)        # MLP (ff = 4d)
    logits = 2 * dt * cfg.n_vocab
    decoder = steps * (cfg.n_text_layer * dec_step_layer + logits)
    return float(batch) * (encoder + cross_kv + decoder)


def kmeans_step_flops(k: int, dim: int, rows: int) -> float:
    """Analytic FLOPs for one online mini-batch k-means step.

    Assignment: one ``[rows, dim] x [dim, k]`` product (2·R·D·K) plus the
    ``||c||²`` bias row (2·K·D).  Update: the one-hot segment-sum product
    ``[k, rows] x [rows, dim]`` (2·R·D·K) plus the running-mean fold and
    the spherical renormalisation over the centroid table (~6·K·D).
    Normalising the incoming rows costs ~3·R·D.  A multiply-accumulate
    counts as 2 FLOPs, as in `encoder_forward_flops`.
    """
    r, d, kk = float(rows), float(dim), float(k)
    return 4.0 * r * d * kk + 3.0 * r * d + 8.0 * kk * d
