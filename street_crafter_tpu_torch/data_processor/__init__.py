from .pointcloud import PointCloudProcessor, WaymoPointCloudProcessor


def get_pointcloud_processor(dataset_type: str, *args, **kw):
    if dataset_type.lower() == "waymo":
        return WaymoPointCloudProcessor(*args, **kw)
    raise ValueError(f"unknown dataset type {dataset_type!r}")


__all__ = ["PointCloudProcessor", "WaymoPointCloudProcessor",
           "get_pointcloud_processor"]
