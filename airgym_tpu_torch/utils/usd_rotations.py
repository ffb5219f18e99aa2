"""Offline asset-tooling rotation conversions, scalar-first quaternions
(counterpart of airgym_tpu/utils/usd_rotations.py; reference
airgym/utils/rotations.py:1-158) without the pxr dependency: numpy and
scipy throughout, and ``gf_quat_to_tensor`` duck-types any object with
``GetReal()`` / ``GetImaginary()`` (pxr's Gf.Quat* where pxr is
installed, a stand-in where it is not).

Conventions are the reference's:
  * quaternions here are SCALAR-FIRST ``[w, x, y, z]`` (the USD / Gf
    convention), while the simulation core
    (``airgym_tpu_torch.math.rotations``) uses IsaacGym's scalar-last
    ``[x, y, z, w]``; these helpers serve offline asset pipelines only;
  * euler angles are extrinsic XYZ.
The ``device`` arguments of the reference's signatures are accepted and
ignored: the results are numpy arrays.
"""
import numpy as np
from scipy.spatial.transform import Rotation


def _to_scalar_first(q_xyzw: np.ndarray) -> np.ndarray:
    idx = [3, 0, 1, 2]
    return q_xyzw[idx] if q_xyzw.ndim == 1 else q_xyzw[:, idx]


def _to_scalar_last(q_wxyz: np.ndarray) -> np.ndarray:
    idx = [1, 2, 3, 0]
    return q_wxyz[idx] if q_wxyz.ndim == 1 else q_wxyz[:, idx]


def gf_quat_to_tensor(orientation, device=None) -> np.ndarray:
    """pxr Gf.Quat{d,f,ernion} (or any GetReal/GetImaginary object) ->
    ``[w, x, y, z]`` array (reference rotations.py:7-19)."""
    quat = np.zeros(4)
    quat[1:] = orientation.GetImaginary()
    quat[0] = orientation.GetReal()
    return quat


def euler_angles_to_quats(euler_angles: np.ndarray, degrees: bool = False,
                          device=None) -> np.ndarray:
    """Extrinsic-XYZ euler (N,3)/(3,) -> scalar-first quats
    (reference rotations.py:22-38)."""
    rot = Rotation.from_euler("xyz", euler_angles, degrees=degrees)
    return _to_scalar_first(rot.as_quat())


def quats_to_euler_angles(quaternions: np.ndarray, degrees: bool = False,
                          device=None) -> np.ndarray:
    """Scalar-first quats -> extrinsic-XYZ euler (reference :41-57)."""
    rot = Rotation.from_quat(_to_scalar_last(quaternions))
    return rot.as_euler("xyz", degrees)


def rot_matrices_to_quats(rotation_matrices: np.ndarray,
                          device=None) -> np.ndarray:
    """(N,3,3)/(3,3) rotation matrices -> scalar-first quats
    (reference :60-75)."""
    rot = Rotation.from_matrix(rotation_matrices)
    return _to_scalar_first(rot.as_quat())


def quats_to_rot_matrices(quaternions: np.ndarray,
                          device=None) -> np.ndarray:
    """Scalar-first quats -> (N,3,3)/(3,3) rotation matrices
    (reference :78-92)."""
    rot = Rotation.from_quat(_to_scalar_last(quaternions))
    return rot.as_matrix()


def rotvecs_to_quats(rotation_vectors: np.ndarray, degrees: bool = False,
                     device=None) -> np.ndarray:
    """Rotation vectors (axis * angle) -> scalar-first quats
    (reference :95-112)."""
    rot = Rotation.from_rotvec(rotation_vectors, degrees)
    return _to_scalar_first(rot.as_quat())


def quats_to_rotvecs(quaternions: np.ndarray, device=None) -> np.ndarray:
    """Scalar-first quats -> rotation vectors (reference :115-131)."""
    rot = Rotation.from_quat(_to_scalar_last(quaternions))
    return rot.as_rotvec()


def rad2deg(radian_value: np.ndarray, device=None) -> np.ndarray:
    """(reference :134-144)."""
    return np.rad2deg(radian_value)


def deg2rad(degree_value: np.ndarray, device=None) -> np.ndarray:
    """(reference :147-157)."""
    return np.deg2rad(degree_value)
