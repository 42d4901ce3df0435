"""Host-side geometry: quaternions, headings, polar/global transforms.

Self-contained replacement for the `quaternion` + habitat geometry utilities
used by the reference (reference habitat_extensions/utils.py:683-773,
habitat.utils.geometry_utils). Conventions match Habitat: y-up world, agent
forward is -z, heading angle phi in [0, 2pi) measured so that the agent's
forward direction in the global XZ plane is (-sin(phi), -cos(phi)).

Quaternions are numpy arrays [x, y, z, w].
"""

from __future__ import annotations

import math
from typing import List, Tuple, Union

import numpy as np

Vec = Union[List[float], np.ndarray]

FRONT = np.array([0.0, 0.0, -1.0])  # habitat_sim.geo.FRONT
UP = np.array([0.0, 1.0, 0.0])  # habitat_sim.geo.UP

IDENTITY_QUAT = np.array([0.0, 0.0, 0.0, 1.0])


def quat_from_angle_axis(angle: float, axis: Vec) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    s = math.sin(half)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(half)])


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    n = float(np.dot(q, q))
    return np.array([-q[0], -q[1], -q[2], q[3]]) / n


def quat_rotate_vector(q: np.ndarray, v: Vec) -> np.ndarray:
    """Rotate vector v by quaternion q (active rotation)."""
    v = np.asarray(v, dtype=np.float64)
    qvec = q[:3]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[3] * uv + uuv)


def quat_from_heading(heading: float) -> np.ndarray:
    """Quaternion rotating FRONT to the direction of the given heading angle.

    heading_from_quaternion(quat_from_heading(phi)) == phi.
    """
    return quat_from_angle_axis(heading, UP)


def angle_between_quaternions(q1: np.ndarray, q2: np.ndarray) -> float:
    """Rotation angle between two unit quaternions (habitat
    geometry_utils.angle_between_quaternions equivalent)."""
    dot = abs(float(np.dot(q1, q2)))
    return 2.0 * math.acos(min(1.0, max(-1.0, dot)))


def quat_from_two_vectors(v0: Vec, v1: Vec) -> np.ndarray:
    """Quaternion rotating v0 onto v1 (habitat
    geometry_utils.quaternion_from_two_vectors equivalent)."""
    v0 = np.asarray(v0, dtype=np.float64)
    v1 = np.asarray(v1, dtype=np.float64)
    v0 = v0 / np.linalg.norm(v0)
    v1 = v1 / np.linalg.norm(v1)
    c = float(np.dot(v0, v1))
    if c < -1 + 1e-8:
        # opposite vectors: rotate pi around any orthogonal axis
        axis = np.cross(np.array([1.0, 0.0, 0.0]), v0)
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(np.array([0.0, 1.0, 0.0]), v0)
        axis = axis / np.linalg.norm(axis)
        return np.array([axis[0], axis[1], axis[2], 0.0])
    axis = np.cross(v0, v1)
    s = math.sqrt((1.0 + c) * 2.0)
    q = np.array([axis[0] / s, axis[1] / s, axis[2] / s, s * 0.5])
    return q / np.linalg.norm(q)


def heading_from_quaternion(q: np.ndarray) -> float:
    """Heading angle phi in [0, 2pi).

    Mirrors reference habitat_extensions/utils.py:707-713: rotate [0,0,-1]
    by the inverse rotation and take atan2 over the XZ plane.
    """
    direction = quat_rotate_vector(quat_inverse(q), FRONT)
    phi = math.atan2(direction[0], -direction[2])
    return phi % (2 * math.pi)


def heading_to_forward_xz(heading: float) -> np.ndarray:
    """Unit forward direction in the XZ plane for a heading angle."""
    return np.array([-math.sin(heading), -math.cos(heading)])


def cartesian_to_polar(x: float, y: float) -> Tuple[float, float]:
    return math.hypot(x, y), math.atan2(y, x)


def euclidean_distance(pos_a: Vec, pos_b: Vec) -> float:
    return float(np.linalg.norm(np.asarray(pos_b, dtype=np.float64) - np.asarray(pos_a, dtype=np.float64)))


def compute_heading_to(pos_from: Vec, pos_to: Vec) -> Tuple[List[float], float]:
    """Heading (quat list + scalar) that points from pos_from to pos_to in the
    global XZ frame. Mirrors reference habitat_extensions/utils.py:683-704
    (including its (angle + pi) % 2pi convention and the from_euler_angles
    quaternion construction, which for a pure y rotation equals
    quat_from_angle_axis(angle/?, UP) with half-angle folding)."""
    delta_x = pos_to[0] - pos_from[0]
    delta_z = pos_to[-1] - pos_from[-1]
    xz_angle = math.atan2(delta_x, delta_z)
    xz_angle = (xz_angle + math.pi) % (2 * math.pi)
    quat = quat_from_angle_axis(xz_angle, UP)
    return [float(x) for x in quat], xz_angle


def rtheta_to_global_coordinates(
    position: Vec,
    heading: float,
    r: float,
    theta: float,
    y_delta: float = 0.0,
    dimensionality: int = 2,
) -> List[float]:
    """Map polar (r, theta) relative to an agent pose to global coordinates.

    theta is measured counterclockwise (leftward) from the agent's forward
    axis, matching the reference's quat_from_angle_axis(theta, UP) rotation of
    the forward vector (reference habitat_extensions/utils.py:747-773). Not
    validated for navigability.
    """
    assert dimensionality in (2, 3)
    position = np.asarray(position, dtype=np.float64)
    forward = quat_rotate_vector(quat_from_heading(heading), FRONT)
    move_ax = quat_rotate_vector(quat_from_angle_axis(theta, UP), forward)
    new_pos = position + move_ax * r
    new_pos[1] += y_delta
    if dimensionality == 2:
        return [float(new_pos[0]), float(new_pos[2])]
    return [float(x) for x in new_pos]


def predictions_to_global_xz(
    pano: np.ndarray,
    offset: np.ndarray,
    distance: np.ndarray,
    current_position: np.ndarray,
    current_heading: np.ndarray,
    num_panos: int = 12,
) -> np.ndarray:
    """Batched (pano, offset, distance) waypoint predictions -> global (x, z).

    mirrors
    reference habitat_extensions/utils.py:716-744.
    """
    radians_per_pano = 2.0 * np.pi / num_panos
    phi = (current_heading + pano * radians_per_pano + offset) % (2 * np.pi)
    x = current_position[:, 0] - distance * np.sin(phi)
    z = current_position[:, -1] - distance * np.cos(phi)
    return np.stack([x, z], axis=1)
