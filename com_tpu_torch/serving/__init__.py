from .server import BatchServer, ServerStats

__all__ = ["BatchServer", "ServerStats"]
