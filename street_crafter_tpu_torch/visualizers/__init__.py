from .visualizer import Visualizer, depth_colormap, save_image, save_video

__all__ = ["Visualizer", "save_image", "save_video", "depth_colormap"]
