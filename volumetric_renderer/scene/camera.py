"""Orbit camera + per-pixel ray generation.

Mirrors the reference's quaternion orbit camera
(``src/scene/camera.cpp:7-48``) and its projection setup
(``src/rendering/offscreen_pass.cpp:1152-1171``): 40 deg vertical FoV
perspective (``glm::perspectiveRH`` with ``GLM_FORCE_DEPTH_ZERO_TO_ONE``,
near 0.1 / far 10) composed with the GL->Vulkan coordinate conversion
``rotX(90deg) * scale(-1,1,1)``.

The reference never generates rays on the CPU: the rasterizer projects the
unit cube and each fragment gets its ray as
``normalize(frag_world_pos - camera_pos)`` (``res/shaders/volume.frag:23``).
Here rays are generated analytically by unprojecting pixel centers through
``inverse(proj * view)``; the directions are identical to the rasterized ones
because both are straight lines through the camera center and the pixel.

Conventions: image row 0 is the top of the screen (Vulkan NDC y=-1 with the
default positive-height viewport), column 0 is the left.  World space is the
app's z-up space containing the volume cube ``[-0.5, 0.5]^3``; texture space
is ``world + 0.5``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from volumetric_renderer.utils import quaternion as quat

# Camera matrices are tiny 4x4 products: always use full-precision matmuls
# (a default-precision f32 matmul may run in TF32 or bf16 on an
# accelerator, ~1e-3 error — fatal for ray generation).
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


@jax.tree_util.register_pytree_node_class
class OrbitCamera:
    """Quaternion orbit camera around ``center`` (``src/scene/camera.cpp``).

    Functional: ``rotate``/``zoom`` return new cameras.  A camera is a pytree
    so it can be passed through ``jit``/``grad``/``vmap``.
    """

    #: drag sensitivity in degrees per pixel (``camera.cpp:18``)
    SENSITIVITY = 0.25
    #: zoom radius clamp (``camera.cpp:33``)
    MIN_RADIUS, MAX_RADIUS = 0.1, 10.0

    def __init__(self, center, orientation, radius):
        self.center = jnp.asarray(center, dtype=jnp.float32)
        self.orientation = jnp.asarray(orientation, dtype=jnp.float32)
        self.radius = jnp.asarray(radius, dtype=jnp.float32)

    @classmethod
    def create(cls) -> "OrbitCamera":
        """Initial pose: 180 deg about +z, radius 3 (``camera.cpp:7-13``)."""
        return cls(
            center=jnp.zeros(3, jnp.float32),
            orientation=quat.from_axis_angle(
                jnp.array([0.0, 0.0, 1.0]), jnp.pi
            ),
            radius=3.0,
        )

    # -- pytree plumbing ---------------------------------------------------
    def tree_flatten(self):
        return (self.center, self.orientation, self.radius), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        # Bypass __init__: unflatten must accept arbitrary leaves (tracers,
        # jit .lower() ArgInfo sentinels, None from tree_map) untouched.
        obj = object.__new__(cls)
        obj.center, obj.orientation, obj.radius = children
        return obj

    # -- interaction (``camera.cpp:15-34``) --------------------------------
    def rotate(self, delta_xy) -> "OrbitCamera":
        """Drag rotation: yaw about world z by ``-dx*0.25`` degrees, then
        pitch about the camera's right axis by ``dy*0.25`` degrees."""
        delta_xy = jnp.asarray(delta_xy, dtype=jnp.float32)
        ang = delta_xy * self.SENSITIVITY
        yaw = quat.from_axis_angle(
            jnp.array([0.0, 0.0, 1.0]), -jnp.deg2rad(ang[0])
        )
        o = quat.multiply(yaw, self.orientation)
        right = quat.rotate_vector(o, jnp.array([1.0, 0.0, 0.0]))
        pitch = quat.from_axis_angle(right, jnp.deg2rad(ang[1]))
        o = quat.multiply(pitch, o)
        return OrbitCamera(self.center, o, self.radius)

    def zoom(self, delta) -> "OrbitCamera":
        r = jnp.clip(self.radius - delta, self.MIN_RADIUS, self.MAX_RADIUS)
        return OrbitCamera(self.center, self.orientation, r)

    @classmethod
    def from_angles(cls, yaw_deg=0.0, pitch_deg=0.0, radius=3.0) -> "OrbitCamera":
        """Convenience pose: start from the default camera and apply a drag
        equivalent to (yaw, pitch) degrees."""
        cam = cls.create()
        cam = OrbitCamera(cam.center, cam.orientation, jnp.float32(radius))
        return cam.rotate(
            jnp.array([yaw_deg, pitch_deg], jnp.float32) / cls.SENSITIVITY
        )

    # -- matrices (``camera.cpp:36-48``, ``offscreen_pass.cpp:1152-1171``) -
    def position(self):
        """``center - radius * (q * (0,-1,0))`` (``camera.cpp:36-40``)."""
        forward = quat.rotate_vector(self.orientation, jnp.array([0.0, -1.0, 0.0]))
        return self.center - self.radius * forward

    def view_matrix(self):
        """``transpose(mat4_cast(q)) * translate(-position)``."""
        r = quat.to_rotation_matrix(self.orientation).T
        pos = self.position()
        m = jnp.eye(4, dtype=jnp.float32)
        m = m.at[:3, :3].set(r)
        m = m.at[:3, 3].set(-_mm(r, pos))
        return m


def perspective_rh_zo(fov_y_rad, aspect, near, far):
    """glm::perspectiveRH_ZO (GLM_FORCE_DEPTH_ZERO_TO_ONE is defined by the
    reference, ``offscreen_pass.cpp:3``)."""
    t = jnp.tan(fov_y_rad / 2.0)
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(1.0 / (aspect * t))
    m = m.at[1, 1].set(1.0 / t)
    m = m.at[2, 2].set(far / (near - far))
    m = m.at[2, 3].set(-(far * near) / (far - near))
    m = m.at[3, 2].set(-1.0)
    return m


def coordinate_conversion():
    """GL->Vulkan world conversion ``rotX(90deg) * scale(-1,1,1)``
    (``offscreen_pass.cpp:1158-1162``): maps (x,y,z) -> (-x, -z, y)."""
    return jnp.array(
        [
            [-1.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, -1.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=jnp.float32,
    )


def projection_matrix(camera: OrbitCamera, aspect, fov_y_degrees=40.0,
                      near=0.1, far=10.0):
    """Full clip-from-world matrix ``P * C * V`` as the reference composes it
    (``ubo.proj = perspectiveRH(...) * coordinate_conversion`` then the
    shader does ``proj * view * pos``, ``volume.vert:23``)."""
    p = perspective_rh_zo(jnp.deg2rad(fov_y_degrees), aspect, near, far)
    return _mm(_mm(p, coordinate_conversion()), camera.view_matrix())


def ray_grid(camera: OrbitCamera, height: int, width: int,
             fov_y_degrees: float = 40.0, near: float = 0.1,
             far: float = 10.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel world-space rays through pixel centers.

    Returns ``(origin[3], dirs[H, W, 3])`` with unit-norm directions,
    identical to the shader's ``normalize(frag_pos - camera_pos)``
    (``volume.frag:23``) for every point of the rasterized cube.
    """
    aspect = float(width) / float(height)
    m = projection_matrix(camera, aspect, fov_y_degrees, near, far)
    m_inv = jnp.linalg.inv(m)

    ys = (2.0 * (jnp.arange(height, dtype=jnp.float32) + 0.5) / height) - 1.0
    xs = (2.0 * (jnp.arange(width, dtype=jnp.float32) + 0.5) / width) - 1.0
    ndc_y, ndc_x = jnp.meshgrid(ys, xs, indexing="ij")

    def unproject(z):
        clip = jnp.stack(
            [ndc_x, ndc_y, jnp.full_like(ndc_x, z), jnp.ones_like(ndc_x)],
            axis=-1,
        )
        w = _mm(clip, m_inv.T)
        return w[..., :3] / w[..., 3:4]

    p_near = unproject(0.25)
    p_far = unproject(0.75)
    d = p_far - p_near
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return camera.position(), d
