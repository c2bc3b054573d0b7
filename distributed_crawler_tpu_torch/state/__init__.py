"""State layer of the port: the workers' results sinks (the local
filesystem, or an object store with ``--object-store``) and the crawl's
post sink that the transcript re-entry writes through."""

from .local import LocalStateManager, create_state_manager
from .objectstore import ObjectStorageProvider, make_object_client
from .providers import LocalStorageProvider, StorageProvider

__all__ = ["LocalStateManager", "LocalStorageProvider",
           "ObjectStorageProvider", "StorageProvider",
           "create_state_manager", "make_object_client"]
