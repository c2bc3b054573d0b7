"""The device modes' configuration: the port's copy of the inference and
media settings of the reference's `distributed_crawler_tpu/config/
crawler.py`, at the reference's defaults.

`InferenceConfig` and `MediaConfig` are copied whole.  `CrawlerConfig`
keeps the fields the port's modes read: the results sink, the crawl
identity, the tenant, the object-store URL, the two blocks above, and the
crawl settings the orchestrator copies into every work item
(`bus/messages.WorkItemConfig`).  The crawler's client, validator and
chunker settings belong to the reference's crawler.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import List, Optional

PLATFORM_TELEGRAM = "telegram"


@dataclass
class InferenceConfig:
    """Inference stage settings: which models run over crawled posts, how
    batches are formed, and how the device mesh is laid out."""

    enabled: bool = False
    embed_model: str = "e5-small"  # model registry key
    classify_model: str = "xlmr-base-classifier"
    asr_model: str = "whisper-small"
    batch_size: int = 256
    max_seq_len: int = 512
    bucket_sizes: List[int] = field(
        default_factory=lambda: [64, 128, 256, 512])
    batch_deadline_ms: int = 50  # flush a partial batch after this long
    # Serving mesh (`parallel:` config block / --mesh-* flags).  All
    # defaults = single-device serving, the only layout the port has.
    mesh_data: int = 0     # dp axis; 0 = auto (devices / (seq*tensor))
    mesh_seq: int = 1      # sp axis
    mesh_tensor: int = 1   # tp axis
    mesh_devices: int = 0  # 0 = off unless an axis >1; -1 = all visible
    #                        devices; N = first N visible devices
    dtype: str = "bfloat16"
    # Serving-time parameter cast ("" keeps f32; "bfloat16" halves weight
    # traffic — see EngineConfig.param_dtype).
    param_dtype: str = ""
    # Serving-time projection-GEMM quantization ("" off; "int8" dynamic
    # per-token scales; "int8_static" calibrated per-tensor scales).
    quantize: str = ""
    # Attention dispatch ("" = the engine's default; on the card every
    # mode but "xla" serves on the kernel).
    attention: str = ""
    # Switch-MoE dispatch for MoE checkpoints ("" keeps the model's
    # default "dense"; "capacity" packs static expert slots).
    moe_dispatch: str = ""
    # Local HF checkpoint dirs (real weights + vocab; offline only).  Empty
    # string -> registry config with random init + hashing tokenizer.
    pretrained_dir: str = ""
    asr_pretrained_dir: str = ""


@dataclass
class MediaConfig:
    """Media/ASR serving settings: the crawl-side media bridge and the
    ``mode=asr-worker`` service."""

    # Ship stored audio refs to TOPIC_MEDIA_BATCHES (the crawler's half).
    enabled: bool = False
    batch_size: int = 8          # audio refs per AudioBatchMessage
    batch_deadline_ms: int = 250  # flush a partial ref batch after this
    # Window-count buckets the ASR pipeline serves; empty = powers of two
    # up to inference.asr_batch_size.
    window_buckets: List[int] = field(default_factory=list)
    # Cap on 30 s windows taken from one file (0 = unbounded).
    max_windows_per_file: int = 0
    # Audio batches coalesced per ASR device group (`ASRWorkerConfig`).
    coalesce_batches: int = 2


@dataclass
class CrawlerConfig:
    """What the port's modes read of the crawl configuration."""

    storage_root: str = "/tmp/crawls"
    crawl_id: str = ""
    crawl_label: str = ""
    # Tenant label stamped onto published batches; empty = the
    # documented "default" tenant.
    tenant: str = ""
    platform: str = PLATFORM_TELEGRAM
    # Remote blob target ("memory://" | "file:///path"); empty = results
    # land under storage_root.
    object_store_url: str = ""
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    media: MediaConfig = field(default_factory=MediaConfig)
    # The crawl's settings, carried to the crawl workers in each work item.
    concurrency: int = 1
    timeout: int = 30
    min_post_date: Optional[datetime] = None
    post_recency: Optional[datetime] = None
    date_between_min: Optional[datetime] = None
    date_between_max: Optional[datetime] = None
    sample_size: int = 0
    min_users: int = 0
    max_comments: int = -1
    max_posts: int = -1
    max_depth: int = 0
    max_pages: int = 108000
    skip_media_download: bool = False
    youtube_api_key: str = ""
    sampling_method: str = "channel"  # channel | random | snowball
    min_channel_videos: int = 0
    # --max-crawl-duration, in seconds: 0 = unlimited.
    max_crawl_duration_s: float = 0.0


def generate_crawl_id(now: Optional[datetime] = None) -> str:
    """Timestamp-format crawl ID, ``YYYYMMDDHHMMSS`` (UTC)."""
    now = now or datetime.now(timezone.utc)
    return now.strftime("%Y%m%d%H%M%S")
