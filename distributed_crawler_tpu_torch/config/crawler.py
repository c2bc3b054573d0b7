"""The device modes' configuration: the port's copy of the inference and
media settings of the reference's `distributed_crawler_tpu/config/
crawler.py`, at the reference's defaults.

`InferenceConfig`, `MediaConfig` and `TelegramRateLimitConfig` are
copied whole.  `CrawlerConfig` keeps the fields the port's modes and its
channel crawl read: the results sink, the crawl identity, the tenant, the
object-store URL, the two blocks above, the crawl settings the
orchestrator copies into every work item (`bus/messages.WorkItemConfig`),
the native Telegram client's pool (seed-DB URLs, or a DC gateway's
address with its TLS, wire, key and DC table, and the credentials
directory) and its rate limits (`TelegramRateLimitConfig`), the
null-field rules, the random walk's ``seed_size`` and ``walkback_rate``,
and the tandem crawl's and its validator's settings.  The chunker's
settings wait for its module (ROADMAP Queue 1 part C).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import List, Optional

PLATFORM_TELEGRAM = "telegram"


@dataclass
class TelegramRateLimitConfig:
    """Per-connection Telegram API rate limits, in calls per minute; the
    jitter adds a random delay after each limited call.  GetMessage is
    limited reactively: a token is spent only when the call misses the
    client's local cache and reaches the server."""

    get_chat_history_rate: float = 30.0
    search_public_chat_rate: float = 6.0
    get_supergroup_info_rate: float = 20.0
    get_chat_history_jitter_ms: int = 500
    search_public_chat_jitter_ms: int = 1500
    get_supergroup_info_jitter_ms: int = 800
    get_message_server_hit_rate: float = 60.0
    get_message_server_hit_jitter_ms: int = 300


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
    sampling_method: str = "channel"  # channel | random | snowball | random-walk
    # Random-walk seeds drawn from the seed pool when no URL is given.
    seed_size: int = 0
    # The random walk's chance, in percent, of walking back although new
    # channels were found (`crawl/runner._walkback_decision`).
    walkback_rate: int = 0
    min_channel_videos: int = 0
    # --max-crawl-duration, in seconds: 0 = unlimited.
    max_crawl_duration_s: float = 0.0
    # The native Telegram client's connection pool (`crawl/runner.
    # setup_pool_from_config`): one connection per seed-DB URL, or
    # `concurrency` wire connections to the DC gateway at dc_address.
    tdlib_database_url: str = ""
    tdlib_database_urls: List[str] = field(default_factory=list)
    # The credentials directory: gen-code writes credentials.json here
    # and a gateway pool reads it back.
    tdlib_dir: str = ".tdlib"
    dc_address: str = ""
    dc_tls: bool = False
    dc_tls_insecure: bool = False  # a self-signed gateway
    dc_sni: str = ""
    # "" or "dct": the DCT-v1 JSON frames; "mtproto" waits for the wire's
    # half of ROADMAP Queue 1 part D.
    dc_wire: str = ""
    dc_pubkey_file: str = ""
    # {dc_id: {address, pubkey_file}}: where PHONE_MIGRATE_X redirects go.
    dc_table_file: str = ""
    rate_limit: TelegramRateLimitConfig = field(
        default_factory=TelegramRateLimitConfig)
    # Null handling: user JSON overriding the default rules
    # (`datamodel/validation.py`).
    null_config: str = ""
    # The tandem crawl and its validator (`crawl/validator.py`): the
    # crawler streams a page's outlinks to the SQL pending-edge queue and
    # the validator pod checks them against t.me.
    tandem_crawl: bool = False
    validate_only: bool = False
    validator_request_rate: float = 6.0  # HTTP calls per minute
    # t.me transport: "urllib" (stdlib) or "chrome" (the native client's
    # Chrome-shaped TLS).
    validator_transport: str = "urllib"
    # Validation endpoint base; a mirror or forward proxy may stand in.
    validator_base_url: str = "https://t.me"
    validator_request_jitter_ms: int = 200
    validator_claim_batch_size: int = 10
    validator_timeout_s: float = 0.0  # 0 = disabled


def generate_crawl_id(now: Optional[datetime] = None) -> str:
    """Timestamp-format crawl ID, ``YYYYMMDDHHMMSS`` (UTC)."""
    now = now or datetime.now(timezone.utc)
    return now.strftime("%Y%m%d%H%M%S")
