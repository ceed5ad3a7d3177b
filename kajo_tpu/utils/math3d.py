"""GLM-0.9.3-compatible 3D transform math.

The reference scene DSL (see /root/reference/scene/Parser.cpp:101-166) composes
``lookat``/``translate``/``scale``/``rotate`` strings into a single mat4 using GLM
0.9.3 semantics: angles in **degrees**, column-major composition ``result * X``
(math convention ``result @ X`` here), and the classic OpenGL ``lookAt`` /
symmetric-frustum ``perspective`` matrices.

These helpers are host-side scene-construction utilities; they accept and return
plain numpy arrays (float32) so scene loading never touches the accelerator.
Everything works equally with jax.numpy inputs (used by the differentiable
camera path), because only generic array ops are used.

Matrix convention: arrays of shape (4, 4) applied to column vectors, ``M @ v``.
This matches GLM's mathematical behavior (GLM stores column-major, but
``M * v`` computes the same product).
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray


def identity(xp=np) -> Array:
    return xp.eye(4, dtype=xp.float32)


def translate(m: Array, v, xp=np) -> Array:
    """GLM translate: ``m * T(v)`` (glm/gtc/matrix_transform.inl translate)."""
    t = xp.eye(4, dtype=xp.float32)
    t = t.copy() if xp is np else t
    if xp is np:
        t[:3, 3] = xp.asarray(v, dtype=xp.float32)
    else:  # jax path
        t = t.at[:3, 3].set(xp.asarray(v, dtype=xp.float32))
    return (m @ t).astype(xp.float32)


def scale(m: Array, v, xp=np) -> Array:
    """GLM scale: ``m * S(v)``."""
    s = xp.eye(4, dtype=xp.float32)
    v = xp.asarray(v, dtype=xp.float32)
    if xp is np:
        s = s.copy()
        s[0, 0], s[1, 1], s[2, 2] = v[0], v[1], v[2]
    else:
        s = s.at[0, 0].set(v[0]).at[1, 1].set(v[1]).at[2, 2].set(v[2])
    return (m @ s).astype(xp.float32)


def rotation_matrix(angle_deg: float, axis, xp=np) -> Array:
    """GLM rotate matrix (angle in degrees, axis normalized internally)."""
    a = xp.deg2rad(xp.asarray(angle_deg, dtype=xp.float32))
    c = xp.cos(a)
    s = xp.sin(a)
    axis = xp.asarray(axis, dtype=xp.float32)
    axis = axis / xp.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    omc = 1.0 - c
    r = xp.stack(
        [
            xp.stack([c + omc * x * x, omc * x * y - s * z, omc * x * z + s * y]),
            xp.stack([omc * y * x + s * z, c + omc * y * y, omc * y * z - s * x]),
            xp.stack([omc * z * x - s * y, omc * z * y + s * x, c + omc * z * z]),
        ]
    )
    out = xp.eye(4, dtype=xp.float32)
    if xp is np:
        out = out.copy()
        out[:3, :3] = r
    else:
        out = out.at[:3, :3].set(r)
    return out.astype(xp.float32)


def rotate(m: Array, angle_deg: float, axis, xp=np) -> Array:
    """GLM rotate: ``m * R(angle_deg, axis)``."""
    return (m @ rotation_matrix(angle_deg, axis, xp=xp)).astype(xp.float32)


def look_at(eye, center, up, xp=np) -> Array:
    """GLM lookAt view matrix (right-handed)."""
    eye = xp.asarray(eye, dtype=xp.float32)
    center = xp.asarray(center, dtype=xp.float32)
    up = xp.asarray(up, dtype=xp.float32)
    f = center - eye
    f = f / xp.linalg.norm(f)
    s = xp.cross(f, up)
    s = s / xp.linalg.norm(s)
    u = xp.cross(s, f)
    m = xp.stack(
        [
            xp.concatenate([s, xp.reshape(-xp.dot(s, eye), (1,))]),
            xp.concatenate([u, xp.reshape(-xp.dot(u, eye), (1,))]),
            xp.concatenate([-f, xp.reshape(xp.dot(f, eye), (1,))]),
            xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=xp.float32),
        ]
    )
    return m.astype(xp.float32)


def perspective(fovy_deg: float, aspect: float, z_near: float, z_far: float, xp=np) -> Array:
    """GLM 0.9.3 perspective (fovy in **degrees**, symmetric frustum).

    Spec: /root/reference/third_party/glm/glm/gtc/matrix_transform.inl:222-245.
    Note the scene parser passes only 3 numbers to ``perspective(fovy, near, far)``
    and aspect comes from the CLI (scene/Parser.cpp:156-161).
    """
    rng = np.tan(np.deg2rad(float(fovy_deg)) / 2.0) * float(z_near)
    left, right = -rng * float(aspect), rng * float(aspect)
    bottom, top = -rng, rng
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 * z_near / (right - left)
    m[1, 1] = 2.0 * z_near / (top - bottom)
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return xp.asarray(m)


def project(p, view: Array, proj: Array, xp=np):
    """Inverse of :func:`unproject`: world point -> ((x, y, depth) in [0,1]^3,
    clip-space w). Batched over leading dims; differentiable under jnp.

    ``clip_w > 0`` means the point is in front of the camera."""
    p = xp.asarray(p, dtype=xp.float32)
    if xp is np:
        pv = (proj @ view).astype(np.float32)
        h = p @ pv[:3, :3].T + pv[:3, 3]
        w = p @ pv[3, :3] + pv[3, 3]
    else:
        import jax

        hi = jax.lax.Precision.HIGHEST
        pv = xp.matmul(xp.asarray(proj, xp.float32), xp.asarray(view, xp.float32), precision=hi)
        h = xp.matmul(p, pv[:3, :3].T, precision=hi) + pv[:3, 3]
        w = xp.matmul(p, pv[3, :3], precision=hi) + pv[3, 3]
    ndc = h / w[..., None]
    return (ndc + 1.0) * 0.5, w


def unproject(win, view: Array, proj: Array, xp=np) -> Array:
    """GLM unProject with unit viewport (0,0,1,1).

    Spec: cpu camera-basis construction, /root/reference/renderer/cpu/Renderer.cpp:30-34.
    ``win`` is (x, y, depth) in [0,1]^3; returns the world-space point.
    """
    win = xp.asarray(win, dtype=xp.float32)
    ndc = win * 2.0 - 1.0
    v = xp.concatenate([ndc, xp.asarray([1.0], dtype=xp.float32)])
    if xp is np:
        inv = np.linalg.inv((proj @ view).astype(np.float32))
        out = inv @ v
    else:
        # full f32: on a GPU a float32 product may otherwise run in TF32,
        # which keeps about three decimal digits, and a 1e-4 camera-basis
        # error visibly shifts the image
        import jax

        hi = jax.lax.Precision.HIGHEST
        pv = jax.numpy.matmul(proj, view, precision=hi).astype(xp.float32)
        inv = xp.linalg.inv(pv)
        out = jax.numpy.matmul(inv, v, precision=hi)
    return (out[:3] / out[3]).astype(xp.float32)
