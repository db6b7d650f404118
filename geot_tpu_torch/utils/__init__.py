"""Utilities: point clouds and images to files (``vis3d``, ``vis2d``)."""
from .vis2d import show_imgs
from .vis3d import (read_obj, save_ply, vis_multi_points, vis_neighbors,
                    vis_points, write_obj)

__all__ = ["vis_points", "vis_multi_points", "vis_neighbors", "save_ply",
           "write_obj", "read_obj", "show_imgs"]
