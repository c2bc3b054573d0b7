"""The crawl's coordinator (the reference's `orchestrator/`): BFS work
distribution, result fan-in, worker health, crash recovery, and the fleet
view, trace collector and watchtower behind ``/cluster``, ``/dtraces``,
``/alerts`` and ``/tenants``.  The autoscaler is not ported yet (ROADMAP
Queue 1)."""

from .fleet import FleetView, WorkerTrack
from .journal import CrawlJournal, RecoveredCrawl
from .orchestrator import Orchestrator, OrchestratorConfig, WorkerInfo

__all__ = ["CrawlJournal", "FleetView", "Orchestrator", "OrchestratorConfig",
           "RecoveredCrawl", "WorkerInfo", "WorkerTrack"]
