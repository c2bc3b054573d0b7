"""State layer of the port: the crawl's page state and post sink
(`state/local.py`, `state/composite.py`) and the workers' results sinks
(the local filesystem, or an object store with ``--object-store``)."""

from .composite import CompositeStateManager
from .interface import LocalConfig, StateConfig
from .local import LocalStateManager
from .objectstore import ObjectStorageProvider, make_object_client
from .providers import LocalStorageProvider, StorageProvider

__all__ = ["CompositeStateManager", "LocalConfig", "LocalStateManager",
           "LocalStorageProvider", "ObjectStorageProvider", "StateConfig",
           "StorageProvider", "make_object_client"]
