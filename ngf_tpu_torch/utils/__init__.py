"""Metrics, grid math, visualisation and I/O, checkpoints, marching cubes
and profiling: the names `ngf_tpu/utils/__init__.py` exports. All but the
marching cubes load on first use, so importing a module of the package
pulls in neither scipy nor the profiler."""

from importlib import import_module

# Imported here, as in `ngf_tpu`, so that the package's ``marching_cubes``
# is the function and not its module (numpy and the PNG writer only).
from .marching_cubes import convert_density_to_ply, marching_cubes

_EXPORTS = {
    "n_to_reso": "grid",
    "cal_n_samples": "grid",
    "grid_step_size": "grid",
    "grid_n_samples": "grid",
    "mse2psnr": "metrics",
    "rgb_ssim": "metrics",
    "rgb_lpips": "metrics",
    "tv_loss_2d": "metrics",
    "save_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint",
    "Visualizer": "viz",
    "save_ply": "viz",
    "save_obj": "viz",
    "save_pointcloud_pcd": "viz",
    "depth_to_pointcloud": "viz",
    "trace": "profiling",
    "annotate": "profiling",
}

__all__ = [*_EXPORTS, "marching_cubes", "convert_density_to_ply"]


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
