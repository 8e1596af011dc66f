"""Camera parity: JAX OrbitCamera vs the NumPy transliteration of
``src/scene/camera.cpp`` + ``offscreen_pass.cpp:1152-1171``."""

import numpy as np
import pytest

from reference_marcher import RefCamera, ref_projection, ref_rays

from volumetric_renderer.scene.camera import (
    OrbitCamera,
    coordinate_conversion,
    perspective_rh_zo,
    projection_matrix,
    ray_grid,
)


def drag_sequence():
    return [(30.0, 0.0), (0.0, -45.0), (123.0, 77.0), (-200.0, 15.0)]


def make_pair():
    ref = RefCamera()
    cam = OrbitCamera.create()
    for d in drag_sequence():
        ref.rotate(np.array(d))
        cam = cam.rotate(np.array(d, np.float32))
    ref.zoom(0.75)
    cam = cam.zoom(0.75)
    return ref, cam


def test_initial_pose():
    ref, cam = RefCamera(), OrbitCamera.create()
    np.testing.assert_allclose(np.asarray(cam.position()), ref.position(), atol=1e-6)
    # initial camera sits at (0, -3, 0) looking at the origin
    np.testing.assert_allclose(ref.position(), [0.0, -3.0, 0.0], atol=1e-12)


def test_rotate_zoom_matches_reference():
    ref, cam = make_pair()
    np.testing.assert_allclose(np.asarray(cam.position()), ref.position(), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(cam.view_matrix()), ref.view(), atol=1e-5
    )


def test_zoom_clamps():
    cam = OrbitCamera.create()
    assert float(cam.zoom(100.0).radius) == pytest.approx(0.1)
    assert float(cam.zoom(-100.0).radius) == pytest.approx(10.0)


def test_projection_matrix_matches_reference():
    ref, cam = make_pair()
    np.testing.assert_allclose(
        np.asarray(perspective_rh_zo(np.deg2rad(40.0), 1.5, 0.1, 10.0))
        @ np.asarray(coordinate_conversion()),
        ref_projection(1.5),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(projection_matrix(cam, 1.5)),
        ref_projection(1.5) @ ref.view(),
        atol=1e-5,
    )


def test_ray_grid_matches_reference():
    ref, cam = make_pair()
    o_ref, d_ref = ref_rays(ref, 8, 12)
    o, d = ray_grid(cam, 8, 12)
    np.testing.assert_allclose(np.asarray(o), o_ref, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-5)


def test_rays_unit_norm_and_through_center():
    cam = OrbitCamera.create()
    o, d = ray_grid(cam, 9, 9)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), np.ones((9, 9)), atol=1e-6
    )
    # center pixel ray should point from camera straight at the origin
    center_dir = np.asarray(d)[4, 4]
    expected = -np.asarray(o) / np.linalg.norm(np.asarray(o))
    np.testing.assert_allclose(center_dir, expected, atol=1e-3)
