from .engine import ServeEngine, serve_max_len

__all__ = ["ServeEngine", "serve_max_len"]
