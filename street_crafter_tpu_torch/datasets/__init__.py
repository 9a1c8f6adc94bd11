from .cameras import Camera

__all__ = ["Camera"]
