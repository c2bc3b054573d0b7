"""Hardware-efficiency cost accounting: what a batch costs against what
the card could do.

The counterpart of the reference's `distributed_crawler_tpu/utils/
costmodel.py`:

- the analytic FLOP counts: `encoder_forward_flops`,
  `whisper_forward_flops` and `kmeans_step_flops` are the reference's
  formulas; `moe_forward_flops` prices a Switch-MoE encoder's experts,
  which the reference's analytic fallback leaves out (its XLA capture
  counts them);
- :func:`peak_flops` — the dense bf16 peak of the card, matched on
  ``torch.cuda.get_device_name()`` (NVIDIA's H100 data sheet), with the
  reference's conservative CPU estimate so the MFU path stays exercised on
  the CPU, and ``(0, "unknown")`` otherwise;
- :class:`CostModel` — one row per (bucket, path) dispatched, captured at
  its first dispatch.  Nothing in the port lowers a program the way XLA's
  ``cost_analysis()`` does, so every row is the analytic count
  (``source: "analytic"``, ``bytes_accessed: None``);
- :class:`TenantLedger` and :class:`EfficiencyMeter` — the reference's
  per-tenant spend rows and rolling goodput/MFU window, exported as
  ``tpu_engine_mfu`` / ``tpu_engine_goodput_tokens_per_s`` /
  ``tpu_engine_padding_density`` and carried in heartbeats.

Nothing here reads the card before the process has initialised CUDA, and
nothing synchronises the device.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry

logger = logging.getLogger("dct.costmodel")

# Dense bf16 tensor-core peak of one card, by lower-cased substring of
# its CUDA device name, first match wins (NVIDIA H100 data sheet, without
# sparsity; the SXM part at its 700 W limit).
PEAK_BF16_FLOPS: List[Tuple[str, float, str]] = [
    ("h100 nvl", 835e12, "cuda:h100-nvl"),
    ("h100 pcie", 756e12, "cuda:h100-pcie"),
    ("h100 sxm", 989e12, "cuda:h100-sxm"),
    ("h100 80gb hbm3", 989e12, "cuda:h100-sxm"),
]

# Conservative per-host CPU peak (a few AVX cores' worth of f32 FMA): it
# keeps the MFU path exercised on the CPU, clearly labelled
# ``peak_source: "cpu_estimate"``, and never claims a real utilisation.
CPU_PEAK_FLOPS_ESTIMATE = 5e11

# Tokens per routing group of capacity dispatch (`models.encoder.SwitchMoE`).
MOE_GROUP = 4096


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


def moe_forward_flops(ecfg, batch: int, seq: int, dispatch: str) -> float:
    """Forward FLOPs of a Switch-MoE encoder: `encoder_forward_flops`
    without its MLP term, plus per layer the router (2·h·E per token) and
    the experts' up and down products (4·h·m per token slot): E slots per
    token for dense dispatch, ``cap·E`` per group of ``g`` tokens for
    capacity dispatch (``cap = ceil(g / E · capacity_factor)``)."""
    h, m, e = ecfg.hidden, ecfg.mlp_dim, ecfg.n_experts
    n = batch * seq
    if dispatch == "capacity":
        g = min(n, MOE_GROUP)
        cap = max(1, int(math.ceil(g / e * ecfg.moe_capacity_factor)))
        slots = int(math.ceil(n / g)) * e * cap
    else:
        slots = n * e
    per_layer = 2 * n * h * e + 4 * h * m * slots
    return (encoder_forward_flops(replace(ecfg, mlp_dim=0), batch, seq)
            + ecfg.n_layers * per_layer)


def forward_flops(ecfg, batch: int, seq: int) -> float:
    """One embed+classify dispatch of ``ecfg``: `moe_forward_flops` in the
    config's own dispatch for an encoder with experts, the reference's
    `encoder_forward_flops` for a dense one."""
    if getattr(ecfg, "n_experts", 0):
        return moe_forward_flops(ecfg, batch, seq,
                                 ecfg.moe_dispatch or "dense")
    return encoder_forward_flops(ecfg, batch, seq)


def peak_flops(device_kind: str = "", platform: str = "",
               n_devices: int = 1) -> Tuple[float, str]:
    """(aggregate peak FLOP/s over ``n_devices``, source tag): a CUDA card
    by :data:`PEAK_BF16_FLOPS`, the CPU by its estimate, anything else
    ``(0, "unknown")`` so MFU is omitted rather than invented."""
    kind = (device_kind or "").lower()
    n = max(1, int(n_devices))
    if platform == "cuda":
        for sub, peak, tag in PEAK_BF16_FLOPS:
            if sub in kind:
                return peak * n, tag
        return 0.0, "unknown"
    if platform == "cpu":
        return CPU_PEAK_FLOPS_ESTIMATE * n, "cpu_estimate"
    return 0.0, "unknown"


def default_peak_flops(n_devices: Optional[int] = None,
                       device=None) -> Tuple[float, str]:
    """The peak of the device an engine dispatches to: ``device`` is a
    ``torch.device`` (or its string), and None stands for the current card.
    A card is read only once the process has initialised CUDA, so this
    never creates a context; before that the answer is
    ``(0, "unknown")``.  ``n_devices`` is the count one dispatch covers
    (1 without a mesh)."""
    import torch

    n = 1 if n_devices is None else max(1, int(n_devices))
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return peak_flops("", "cpu", n)
    try:
        if not torch.cuda.is_initialized():
            return 0.0, "unknown"
        index = dev.index if dev is not None and dev.index is not None \
            else torch.cuda.current_device()
        return peak_flops(torch.cuda.get_device_name(index), "cuda", n)
    except Exception as e:  # a wedged card must not kill telemetry
        logger.debug("peak-FLOPs resolution failed: %s", e)
        return 0.0, "unknown"


class CostModel:
    """Per-(bucket, path) cost, captured once at the first dispatch.

    ``capture()`` is idempotent and thread-safe.  The count is the
    analytic one: the port has no compiler whose cost analysis it could
    read, so ``source`` is ``"analytic"`` and ``bytes_accessed`` None."""

    def __init__(self, registry: MetricsRegistry = REGISTRY):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.m_bucket_flops = registry.gauge(
            "tpu_engine_bucket_flops",
            "forward FLOPs of one (bucket, path) batch program (analytic "
            "count)")

    def has(self, bucket: int, path: str) -> bool:
        with self._lock:
            return (str(bucket), path) in self._entries

    def capture(self, bucket: int, path: str, flops: float,
                batch: int = 0, seq: int = 0) -> Dict[str, Any]:
        """Record the (bucket, path) program's cost; the first capture of
        a key wins."""
        key = (str(bucket), path)
        entry: Dict[str, Any] = {
            "bucket": int(bucket), "path": path,
            "batch": int(batch), "seq": int(seq or bucket),
            "flops": float(flops), "bytes_accessed": None,
            "source": "analytic", "captured_at": time.time(),
        }
        with self._lock:
            entry = self._entries.setdefault(key, entry)
        self.m_bucket_flops.labels(bucket=str(bucket),
                                   path=path).set(entry["flops"])
        return entry

    def flops_for(self, bucket: int, path: str,
                  default: float = 0.0) -> float:
        with self._lock:
            entry = self._entries.get((str(bucket), path))
        return float(entry["flops"]) if entry else default

    def snapshot(self) -> List[Dict[str, Any]]:
        """Entries sorted by (path, bucket): the /costs body's core."""
        with self._lock:
            entries = list(self._entries.values())
        return sorted((dict(e) for e in entries),
                      key=lambda e: (e["path"], e["bucket"]))


class TenantLedger:
    """Per-tenant spend attribution: which workload consumed
    which chip-seconds/FLOPs/tokens, plus a rolling queue-wait read per
    tenant.

    The ledger keeps its OWN cumulative rows (registry counters with the
    same name are shared across every meter in a process, so exposition
    counters alone cannot answer "this engine's split").  ``totals`` are
    accumulated independently of the per-tenant rows under the same
    lock, so the conservation property — per-tenant rows sum to the
    total — is checkable against this snapshot.

    Charging is proportional: one device batch's duration/FLOPs/tokens
    split by the caller-supplied weights (the worker weighs by real
    token counts per tenant in the coalesced group).  Warmup and other
    unweighted dispatches charge nothing — they predate any tenant, so
    they must not show up as "unattributed spend"."""

    _QUEUE_WINDOW = 512  # rolling queue-wait samples kept per tenant

    def __init__(self, registry: MetricsRegistry = REGISTRY):
        self._lock = threading.Lock()
        self._rows: Dict[str, Dict[str, float]] = {}
        self._totals = {"chip_seconds": 0.0, "flops": 0.0,
                        "real_tokens": 0.0, "batches": 0.0}
        self._queue_waits: Dict[str, "deque[float]"] = {}
        self.m_chip_seconds = registry.counter(
            "tenant_chip_seconds_total",
            "cumulative device-batch seconds attributed to one tenant "
            "(proportional split of each dispatch by real-token weight)")
        self.m_flops = registry.counter(
            "tenant_flops_total",
            "cumulative forward FLOPs attributed to one tenant")
        self.m_tokens = registry.counter(
            "tenant_real_tokens_total",
            "cumulative REAL (non-pad) tokens attributed to one tenant")
        self.m_queue_wait = registry.gauge(
            "tenant_queue_wait_p95_seconds",
            "p95 queue wait over the last samples observed for one tenant")

    def charge(self, weights: Dict[str, float], duration_s: float,
               flops: float, real_tokens: float) -> None:
        """Attribute one dispatch across ``weights`` proportionally."""
        total_w = sum(w for w in weights.values() if w > 0)
        if total_w <= 0:
            return
        with self._lock:
            self._totals["chip_seconds"] += float(duration_s)
            self._totals["flops"] += float(flops)
            self._totals["real_tokens"] += float(real_tokens)
            self._totals["batches"] += 1.0
            for tenant, w in weights.items():
                if w <= 0:
                    continue
                frac = w / total_w
                row = self._rows.setdefault(tenant, {
                    "chip_seconds": 0.0, "flops": 0.0,
                    "real_tokens": 0.0, "batches": 0.0})
                row["chip_seconds"] += duration_s * frac
                row["flops"] += flops * frac
                row["real_tokens"] += real_tokens * frac
                row["batches"] += frac
                self.m_chip_seconds.labels(tenant=tenant).inc(
                    duration_s * frac)
                self.m_flops.labels(tenant=tenant).inc(flops * frac)
                self.m_tokens.labels(tenant=tenant).inc(real_tokens * frac)

    def observe_queue_wait(self, tenant: str, seconds: float) -> None:
        """Feed one batch's queue wait into the tenant's rolling window."""
        with self._lock:
            dq = self._queue_waits.setdefault(
                tenant, deque(maxlen=self._QUEUE_WINDOW))
            dq.append(float(seconds))
            samples = sorted(dq)
        # Nearest-rank p95, same convention as utils/slo.py.
        p95 = samples[max(0, -(-len(samples) * 95 // 100) - 1)]
        self.m_queue_wait.labels(tenant=tenant).set(round(p95, 6))

    def snapshot(self) -> Dict[str, Any]:
        """{"rows": [...], "totals": {...}} — the /costs "tenants" map.
        Row ``share`` is the tenant's chip-second fraction of the
        total."""
        with self._lock:
            totals = dict(self._totals)
            rows = {t: dict(r) for t, r in self._rows.items()}
            waits = {t: sorted(dq) for t, dq in self._queue_waits.items()
                     if dq}
        out_rows = []
        denom = totals["chip_seconds"]
        for tenant in sorted(rows):
            row = rows[tenant]
            entry: Dict[str, Any] = {
                "tenant": tenant,
                "chip_seconds": round(row["chip_seconds"], 6),
                "flops": round(row["flops"], 1),
                "real_tokens": round(row["real_tokens"], 1),
                "batches": round(row["batches"], 4),
                "share": round(row["chip_seconds"] / denom, 6)
                if denom > 0 else 0.0,
            }
            samples = waits.get(tenant)
            if samples:
                entry["queue_wait_p95_s"] = round(
                    samples[max(0, -(-len(samples) * 95 // 100) - 1)], 6)
                entry["queue_wait_samples"] = len(samples)
            out_rows.append(entry)
        # Tenants that only ever waited (no spend yet) still get a row.
        for tenant in sorted(set(waits) - set(rows)):
            samples = waits[tenant]
            out_rows.append({
                "tenant": tenant, "chip_seconds": 0.0, "flops": 0.0,
                "real_tokens": 0.0, "batches": 0.0, "share": 0.0,
                "queue_wait_p95_s": round(
                    samples[max(0, -(-len(samples) * 95 // 100) - 1)], 6),
                "queue_wait_samples": len(samples),
            })
        return {
            "rows": out_rows,
            "totals": {
                "chip_seconds": round(totals["chip_seconds"], 6),
                "flops": round(totals["flops"], 1),
                "real_tokens": round(totals["real_tokens"], 1),
                "batches": round(totals["batches"], 4),
            },
        }


class EfficiencyMeter:
    """Rolling-window goodput/MFU over dispatched batches.

    One record per device batch: wall time, dispatch→host duration, the
    program's FLOPs, and the real-vs-slot token split.  The window is
    time-bounded (``window_s``) so the gauges answer "how efficient is
    serving NOW", not "since process start".

    MFU here is *achieved FLOP/s over the wall window* vs peak — it
    includes idle gaps between batches, which is the serving-utilisation
    number an operator wants (a chip that computes at 60% MFU for 1 s
    out of every 10 is a 6% chip).  ``mfu_busy`` (over summed batch
    durations only) is also reported for kernel-efficiency reads.

    Mesh-aware: ``n_devices`` is how many chips one recorded dispatch
    covers (the engine's mesh size; 1 single-device).  Peak resolves as
    the N-chip aggregate — same achieved FLOPs over N× the denominator —
    and ``per_device_real_tokens`` (one real-token count per chip's data
    shard, from the host-side mask before device_put) feeds a per-chip
    goodput split: a feed whose padded rows starve the high shards shows
    those chips' goodput collapsing while the aggregate still looks
    healthy.  Under SPMD every chip runs the identical program, so
    per-chip MFU equals the aggregate MFU; goodput is where per-chip
    truth lives.
    """

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 window_s: float = 60.0, max_records: int = 1024,
                 peak: Optional[float] = None, peak_source: str = "",
                 n_devices: int = 1,
                 device_labels: Optional[List[str]] = None,
                 path: str = "", device=None):
        self.window_s = window_s
        self._records: "deque[Tuple[float, float, float, int, int, Any]]" \
            = deque(maxlen=max_records)
        self._ever_recorded = False
        self._lock = threading.Lock()
        # Per-tenant attribution: the worker sets the pending
        # tenant weights before handing the engine a group; every record()
        # while weights are in force charges the ledger proportionally.
        # No weights (warmup, organic unlabeled runs) → nothing charged.
        self.tenants = TenantLedger(registry)
        self._tenant_weights: Dict[str, float] = {}
        # Peak injected for tests; otherwise resolved lazily from the
        # engine's ``device`` once a batch has run there.
        self._peak = peak
        self._peak_source = peak_source
        self._device = device
        self._n_devices = max(1, int(n_devices))
        self.device_labels = list(device_labels) if device_labels else [
            str(i) for i in range(self._n_devices)]
        self.m_mfu = registry.gauge(
            "tpu_engine_mfu",
            "rolling-window achieved FLOP/s over the MESH-AGGREGATE peak "
            "(n_devices x one chip; wall-clock window incl. idle; 0 when "
            "peak is unknown)")
        self.m_goodput = registry.gauge(
            "tpu_engine_goodput_tokens_per_s",
            "rolling-window REAL (non-pad) tokens per second")
        self.m_density = registry.gauge(
            "tpu_engine_padding_density",
            "rolling-window real tokens / dispatched slot tokens")
        self.m_chip_goodput = registry.gauge(
            "tpu_engine_per_chip_goodput_tokens_per_s",
            "rolling-window REAL tokens/s attributed to one chip's data "
            "shard (uniform split when per-shard masks weren't recorded)")
        if path:
            # A second engine kind in the same process (the cluster
            # engine next to the text engine on one registry) must
            # not clobber the default meter's gauges: a ``path`` scopes
            # this meter's mfu/goodput/density series to labeled
            # children.  The per-chip gauge stays shared (its device
            # label already splits series, and labels() on a labeled
            # child would raise).
            self.m_mfu = self.m_mfu.labels(path=path)
            self.m_goodput = self.m_goodput.labels(path=path)
            self.m_density = self.m_density.labels(path=path)

    def _resolve_peak(self) -> Tuple[float, str]:
        if self._peak is None:
            peak, source = default_peak_flops(self._n_devices, self._device)
            if not peak:
                return peak, source  # resolved again at the next read
            self._peak, self._peak_source = peak, source
        return self._peak, self._peak_source

    def set_tenants(self, weights: Dict[str, float]) -> None:
        """Declare which tenants (by positive weight, e.g. real-token
        counts) the NEXT recorded dispatches belong to.  Weights persist
        until the next call, so one coalesced group's multiple device
        batches all charge the same split."""
        with self._lock:
            self._tenant_weights = {
                t: float(w) for t, w in (weights or {}).items() if w > 0}

    def record(self, duration_s: float, flops: float,
               real_tokens: int, slot_tokens: int,
               per_device_real_tokens: Optional[List[int]] = None) -> None:
        """Account one device batch; updates the gauges.

        ``per_device_real_tokens`` — real (non-pad) tokens per chip's data
        shard, length ``n_devices`` — lets the per-chip goodput split be
        exact; omitted, the batch's real tokens attribute uniformly."""
        now = time.monotonic()
        per_dev = None
        if per_device_real_tokens is not None \
                and len(per_device_real_tokens) == self._n_devices:
            per_dev = tuple(int(v) for v in per_device_real_tokens)
        with self._lock:
            self._ever_recorded = True
            self._records.append((now, float(duration_s), float(flops),
                                  int(real_tokens), int(slot_tokens),
                                  per_dev))
            self._prune(now)
            weights = dict(self._tenant_weights)
        if weights:
            self.tenants.charge(weights, float(duration_s), float(flops),
                                float(real_tokens))
        self.snapshot()  # refreshes the gauges as a side effect

    def reset(self) -> None:
        """Forget the recorded batches (warmup exclusion): the next
        snapshot is {} until a batch lands."""
        with self._lock:
            self._records.clear()
            self._ever_recorded = False

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._records and self._records[0][0] < cutoff:
            self._records.popleft()

    def _window_totals(self) -> Tuple[int, float, float, float, int, int,
                                      List[float]]:
        """(batches, span_s, busy_s, flops, real, slot, per_device_real)
        under the lock."""
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            records = list(self._records)
        if not records:
            return 0, 0.0, 0.0, 0.0, 0, 0, [0.0] * self._n_devices
        busy = sum(r[1] for r in records)
        flops = sum(r[2] for r in records)
        real = sum(r[3] for r in records)
        slot = sum(r[4] for r in records)
        per_dev = [0.0] * self._n_devices
        for r in records:
            if r[5] is not None:
                for i, v in enumerate(r[5]):
                    per_dev[i] += v
            else:  # no shard detail: uniform attribution
                share = r[3] / self._n_devices
                for i in range(self._n_devices):
                    per_dev[i] += share
        # Window span: oldest dispatch start to now, floored by busy time
        # (a single just-landed batch must not divide by ~0 wall).
        span = max(now - (records[0][0] - records[0][1]), busy, 1e-9)
        return len(records), span, busy, flops, real, slot, per_dev

    def snapshot(self) -> Dict[str, Any]:
        """The telemetry-heartbeat / /costs ``efficiency`` map, refreshing
        the gauges as a side effect (heartbeats call this every beat, so
        the gauges DECAY to 0 when the batch stream stops instead of
        freezing at the last busy window's value).  {} until the first
        batch ever lands, so never-fed workers don't report fantasy 0s —
        but a worker that went idle genuinely IS at MFU 0."""
        n, span, busy, flops, real, slot, per_dev = self._window_totals()
        with self._lock:
            ever = self._ever_recorded
        if n == 0:
            if not ever:
                return {}
            idle = {
                "window_s": self.window_s, "batches": 0,
                "achieved_flops_per_s": 0.0,
                "goodput_tokens_per_s": 0.0,
                "real_tokens": 0, "slot_tokens": 0,
                "padding_density": None,
                "mfu": 0.0 if self._resolve_peak()[0] else None,
                "mfu_busy": None,
                "peak_flops_per_s": self._resolve_peak()[0] or None,
                "peak_source": self._resolve_peak()[1],
                "n_devices": self._n_devices,
            }
            if self._n_devices > 1:
                # mfu mirrors the aggregate: 0.0 when idle-but-measured,
                # None when peak is unknown (0.0 would read as a DEAD
                # chip on a backend where MFU is simply unmeasurable).
                idle["per_chip"] = self._per_chip(
                    [0.0] * self._n_devices, 1.0, idle["mfu"])
            self._set_gauges(idle)
            return idle
        peak, source = self._resolve_peak()
        achieved = flops / span
        out: Dict[str, Any] = {
            "window_s": round(span, 3),
            "batches": n,
            "achieved_flops_per_s": round(achieved, 1),
            "goodput_tokens_per_s": round(real / span, 1),
            "real_tokens": real,
            "slot_tokens": slot,
            "padding_density": round(real / slot, 4) if slot else None,
            "peak_flops_per_s": peak or None,
            "peak_source": source,
            # 9 decimals: a tiny-model CPU window has a REAL mfu of ~1e-5
            # — and the k-means path's ~1e-7 — which must not round to a
            # dead-chip-looking 0.0.
            "mfu": round(achieved / peak, 9) if peak else None,
            "mfu_busy": round(flops / busy / peak, 9)
            if peak and busy > 0 else None,
            "n_devices": self._n_devices,
        }
        if self._n_devices > 1:
            # Per-chip rows: goodput from each chip's REAL data shard;
            # MFU is the aggregate number on every row (SPMD — one
            # program, identical per-chip FLOPs, shared wall window).
            out["per_chip"] = self._per_chip(per_dev, span,
                                             out.get("mfu"))
        self._set_gauges(out)
        return out

    def _per_chip(self, per_dev: List[float], span: float,
                  mfu) -> List[Dict[str, Any]]:
        rows = []
        for i, label in enumerate(self.device_labels):
            goodput = round(per_dev[i] / span, 1)
            self.m_chip_goodput.labels(device=label).set(goodput)
            rows.append({"device": label,
                         "goodput_tokens_per_s": goodput,
                         "real_tokens": int(per_dev[i]),
                         "mfu": mfu})
        return rows

    def _set_gauges(self, snap: Dict[str, Any]) -> None:
        self.m_mfu.set(snap.get("mfu") or 0.0)
        self.m_goodput.set(snap.get("goodput_tokens_per_s") or 0.0)
        self.m_density.set(snap.get("padding_density") or 0.0)
