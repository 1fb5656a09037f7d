from .web_server import WebServer

__all__ = ["WebServer"]
