"""The crawl-side work consumer: the port's copy of the reference's
`distributed_crawler_tpu/worker/`.  The text worker on the card lives in
`inference/worker.py`."""

from .worker import (
    CrawlWorker,
    WorkerConfig,
    should_retry_error,
    work_item_config_to_crawler_config,
)

__all__ = ["CrawlWorker", "WorkerConfig", "should_retry_error",
           "work_item_config_to_crawler_config"]
