"""The crawl's coordinator (the reference's `orchestrator/`): BFS work
distribution, result fan-in, worker health, crash recovery, the fleet
view, trace collector and watchtower behind ``/cluster``, ``/dtraces``,
``/alerts`` and ``/tenants``, and the autoscaler behind ``/autoscaler``."""

from .autoscaler import (
    Autoscaler,
    InProcessSupervisor,
    PoolPolicy,
    SubprocessSupervisor,
    pools_from_config,
)
from .fleet import FleetView, WorkerTrack
from .journal import CrawlJournal, RecoveredCrawl
from .orchestrator import Orchestrator, OrchestratorConfig, WorkerInfo

__all__ = ["Autoscaler", "CrawlJournal", "FleetView", "InProcessSupervisor",
           "Orchestrator", "OrchestratorConfig", "PoolPolicy",
           "RecoveredCrawl", "SubprocessSupervisor", "WorkerInfo",
           "WorkerTrack", "pools_from_config"]
