"""The layerless random walk: the port's copy of the reference's
`distributed_crawler_tpu/modes/layerless.py`.

Pages live only in the page buffer.  Workers take pages, crawl them (the
crawl writes the next hop back into the buffer) and delete them when
done.  Each error has its route:

- WalkbackExhaustedError -> the page stays in the buffer for a restart;
- FloodWaitRetireError -> the page stays; the crawl stops if the pool
  has no connection left;
- TDLib400Error -> the 400-replacement, then the page is deleted;
- any other error -> logged, and the page deleted.

A page left for a restart is parked: this run does not dispatch it again.

In a tandem crawl the walk is complete when the buffer is empty, no
worker is in flight and no batch is incomplete; with
``validator_timeout_s`` set, a validator that makes no progress for that
long trips the circuit breaker.  ``max_crawl_duration_s`` ends the walk
after that many seconds (a tandem walk never empties its buffer).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..config.crawler import CrawlerConfig
from ..crawl import runner as crawl_runner
from ..crawl.errors import (
    FloodWaitRetireError,
    TDLib400Error,
    WalkbackExhaustedError,
)
from ..crawl.replacement import handle_400_replacement
from ..state.datamodels import Page

logger = logging.getLogger("dct.modes.layerless")

# The sleep between page-buffer polls; module-level so tests shrink it.
LAYERLESS_POLL_INTERVAL_S = 5.0
BUSY_WAIT_S = 0.5


class ValidatorCircuitBreakerError(RuntimeError):
    """Raised when the validator makes no progress within the timeout."""


def run_random_walk_layerless(sm, cfg: CrawlerConfig,
                              poll_interval_s: Optional[float] = None,
                              clock=time.monotonic, sleep=time.sleep) -> None:
    """Walk the page buffer until it is done (see the module docstring)."""
    poll = (LAYERLESS_POLL_INTERVAL_S if poll_interval_s is None
            else poll_interval_s)
    crawl_start = clock()
    should_stop = threading.Event()
    max_workers = max(1, cfg.concurrency)

    sem = threading.Semaphore(max_workers)
    in_flight: dict = {}
    in_flight_lock = threading.Lock()
    # Pages parked for a restart stay in the page buffer, but this run
    # must not dispatch them again, or the poll loop would spin on them.
    parked: set = set()
    threads: list = []
    validator_wait_since: Optional[float] = None

    def in_flight_count() -> int:
        with in_flight_lock:
            return len(in_flight)

    def worker(page: Page) -> None:
        try:
            try:
                crawl_runner.run_for_channel_with_pool(
                    page, cfg.storage_root, sm, cfg)
            except WalkbackExhaustedError as e:
                logger.error("walkback exhausted, page left in buffer",
                             extra={"url": page.url, "error": str(e)})
                parked.add(page.id)
            except FloodWaitRetireError:
                logger.warning("connection retired due to FLOOD_WAIT, "
                               "page left in buffer", extra={"url": page.url})
                parked.add(page.id)
                if crawl_runner.pool_is_empty():
                    logger.error("all connections retired due to FLOOD_WAIT, "
                                 "aborting crawl")
                    should_stop.set()
            except TDLib400Error as e:
                logger.error("TDLib 400, finding replacement edge", extra={
                    "url": page.url, "error": str(e)})
                try:
                    handle_400_replacement(sm, page, cfg)
                except Exception as repl_err:
                    logger.error("failed to find 400 replacement", extra={
                        "url": page.url, "error": str(repl_err)})
                _delete(page)
            except Exception as e:
                logger.error("error processing channel", extra={
                    "url": page.url, "error": str(e)})
                _delete(page)
            else:
                _delete(page)
            if cfg.max_crawl_duration_s > 0 and \
                    clock() - crawl_start >= cfg.max_crawl_duration_s:
                should_stop.set()
        finally:
            with in_flight_lock:
                in_flight.pop(page.id, None)
            sem.release()

    def _delete(page: Page) -> None:
        try:
            sm.delete_page_buffer_pages([page.id], [page.url])
        except Exception as e:
            logger.error("failed to delete page from buffer", extra={
                "url": page.url, "error": str(e)})

    while not should_stop.is_set():
        if cfg.max_crawl_duration_s > 0 and \
                clock() - crawl_start >= cfg.max_crawl_duration_s:
            logger.info("max crawl duration reached, stopping")
            break

        # No page-buffer poll while every worker slot is taken.
        if in_flight_count() >= max_workers:
            sleep(BUSY_WAIT_S)
            continue

        try:
            pages = sm.get_pages_from_page_buffer(max_workers + len(parked))
        except Exception as e:
            logger.error("failed to get pages from page buffer: %s", e)
            sleep(poll)
            continue
        pages = [p for p in pages if p.id not in parked]
        if not pages and parked and in_flight_count() == 0 \
                and not cfg.tandem_crawl:
            logger.info("only parked pages remain in buffer; leaving them "
                        "for the next run", extra={"parked": len(parked)})
            break

        if not pages:
            if cfg.tandem_crawl:
                if in_flight_count() == 0:
                    try:
                        pending = sm.count_incomplete_batches(cfg.crawl_id)
                    except Exception as e:
                        logger.warning("tandem: could not check incomplete "
                                       "batches: %s", e)
                        validator_wait_since = None
                        sleep(poll)
                        continue
                    if pending == 0:
                        logger.info("tandem: buffer empty and no pending "
                                    "batches, crawl complete")
                        break
                    if validator_wait_since is None:
                        validator_wait_since = clock()
                    if cfg.validator_timeout_s > 0 and \
                            clock() - validator_wait_since >= \
                            cfg.validator_timeout_s:
                        _join(threads)
                        raise ValidatorCircuitBreakerError(
                            f"no progress from validator after "
                            f"{clock() - validator_wait_since:.0f}s "
                            f"({pending} incomplete batches) — validator pod "
                            f"may have crashed")
                    logger.info("tandem: buffer empty, waiting for validator",
                                extra={"incomplete_batches": pending})
                else:
                    validator_wait_since = None
            else:
                if in_flight_count() == 0:
                    logger.info("buffer empty and no workers in flight, "
                                "random walk complete")
                    break
            sleep(poll)
            continue

        validator_wait_since = None
        dispatched = 0
        for page in pages:
            with in_flight_lock:
                if page.id in in_flight:
                    continue
                in_flight[page.id] = True
            sem.acquire()  # back-pressure against max_workers
            t = threading.Thread(target=worker, args=(page,), daemon=True,
                                 name=f"dct-rw-{page.url[:24]}")
            t.start()
            threads.append(t)
            dispatched += 1
        # Keep only live threads, so a long walk holds no Thread object
        # per page it ever crawled.
        threads = [t for t in threads if t.is_alive()]
        if dispatched == 0:
            sleep(BUSY_WAIT_S)

    _join(threads)


def _join(threads, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
