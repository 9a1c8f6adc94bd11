from .scene import Scene, create_scene

__all__ = ["Scene", "create_scene"]
