"""State layer of the port: the workers' results sink."""

from .providers import LocalStorageProvider, StorageProvider

__all__ = ["LocalStorageProvider", "StorageProvider"]
