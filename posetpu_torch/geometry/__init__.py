from posetpu_torch.geometry.cameras import (
    CameraParams,
    camera_to_world_frame,
    distort_opencv,
    project_points,
    project_pose,
    undistort_opencv,
    world_to_camera_frame,
)
from posetpu_torch.geometry.triangulate import (
    ransac_filter,
    reproject_poses,
    triangulate_points,
    triangulate_poses,
)

__all__ = [
    "CameraParams",
    "project_pose",
    "project_points",
    "world_to_camera_frame",
    "camera_to_world_frame",
    "distort_opencv",
    "undistort_opencv",
    "triangulate_points",
    "triangulate_poses",
    "ransac_filter",
    "reproject_poses",
]
