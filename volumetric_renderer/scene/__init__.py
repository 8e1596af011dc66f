from volumetric_renderer.scene.camera import OrbitCamera, ray_grid

__all__ = ["OrbitCamera", "ray_grid"]
