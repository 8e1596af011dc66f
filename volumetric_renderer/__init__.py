"""volumetric_renderer — a differentiable volume renderer for GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
C++/Vulkan application ``TomBeacock/volumetric-renderer`` (interactive scalar-
volume ray-marching with a user-editable transfer function):

  * the fragment-shader ray-march (``res/shaders/volume.frag``) becomes a
    ray-march kernel (``kernels/``) with a pure-``jnp`` oracle (``core/``),
  * the Vulkan 3D/1D textures become sharded ``jnp`` arrays (``data/``,
    ``transfer/``),
  * the ImGui transfer-function editor becomes a differentiable 1D TF table,
  * single-GPU rasterizer parallelism becomes pixel-tile sharding over a
    ``jax.sharding.Mesh`` with psum'd parameter gradients (``parallel/``).

Everything in the compute path is differentiable: pixel losses backpropagate
to the voxel grid and the transfer-function table.
"""

__version__ = "0.1.0"

from volumetric_renderer.utils.config import RenderSettings
from volumetric_renderer.scene.camera import OrbitCamera
from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.data.volume import Volume
from volumetric_renderer.render.api import render, render_loss_and_grads

__all__ = [
    "RenderSettings",
    "OrbitCamera",
    "Gradient",
    "Volume",
    "render",
    "render_loss_and_grads",
]
