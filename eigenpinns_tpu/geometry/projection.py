"""Point-to-surface projection on triangle meshes.

Parity with `Mesh.project_new_point` / `project_point_check`
(src/Mesh.py:81-160): project arbitrary 3D points onto the mesh surface —
nearest-node seeding, barycentric projection onto candidate incident
triangles, edge/vertex clamping. Vectorized numpy (host-side utility);
a fully vmapped JAX variant handles batches on device.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from eigenpinns_tpu.geometry.mesh import TriMesh


def _project_to_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p + barycentric coords.

    Ericson's 'Real-Time Collision Detection' region test — exact clamped
    projection (the reference approximates with in-triangle checks and
    nearest-node fallback, src/Mesh.py:102-160).
    """
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return a, (1.0, 0.0, 0.0)
    bp = p - b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return b, (0.0, 1.0, 0.0)
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        v = d1 / (d1 - d3)
        return a + v * ab, (1 - v, v, 0.0)
    cp = p - c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return c, (0.0, 0.0, 1.0)
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        w = d2 / (d2 - d6)
        return a + w * ac, (1 - w, 0.0, w)
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        w = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        return b + w * (c - b), (0.0, 1 - w, w)
    denom = 1.0 / (va + vb + vc)
    v = vb * denom
    w = vc * denom
    return a + ab * v + ac * w, (1 - v - w, v, w)


def project_points(mesh: TriMesh, points: np.ndarray,
                   n_candidates: int = 8):
    """Project each query point onto the mesh surface.

    Returns (projected (Q,3), face_index (Q,), barycentric (Q,3)).
    Candidate triangles: all faces incident to the n_candidates nearest
    vertices (the reference's nearest-node seeding, src/Mesh.py:91).
    """
    verts, faces = mesh.verts, mesh.faces
    tree = cKDTree(verts)
    # vertex -> incident faces
    vert_faces: list[list[int]] = [[] for _ in range(mesh.n_verts)]
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces[v].append(fi)

    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    _, nearest = tree.query(points, k=min(n_candidates, mesh.n_verts))
    if nearest.ndim == 1:
        nearest = nearest[:, None]

    out_p = np.empty_like(points)
    out_f = np.empty(len(points), dtype=np.int64)
    out_b = np.empty((len(points), 3))
    for qi, p in enumerate(points):
        cand = set()
        for v in nearest[qi]:
            cand.update(vert_faces[v])
        best_d, best = np.inf, None
        for fi in cand:
            a, b, c = verts[faces[fi]]
            proj, bary = _project_to_triangle(p, a, b, c)
            d = np.sum((proj - p) ** 2)
            if d < best_d:
                best_d, best = d, (proj, fi, bary)
        out_p[qi], out_f[qi], out_b[qi] = best[0], best[1], best[2]
    return out_p, out_f, out_b


def project_points_device(verts, faces, points):
    """Brute-force vmapped projection over ALL faces on device (JAX).

    O(Q * F) — the right trade on an accelerator for moderate F; exact minimum
    (no candidate-set approximation).
    """
    import jax
    import jax.numpy as jnp

    verts = jnp.asarray(verts)
    faces = jnp.asarray(faces)
    points = jnp.atleast_2d(jnp.asarray(points))
    tri = verts[faces]  # (F, 3, 3)

    def one_point(p):
        def tri_dist(t):
            a, b, c = t[0], t[1], t[2]
            ab, ac, ap = b - a, c - a, p - a
            # Unclamped barycentric least-squares, then clamp to the
            # triangle (projected-gradient style closed form).
            g11, g12, g22 = ab @ ab, ab @ ac, ac @ ac
            r1, r2 = ab @ ap, ac @ ap
            det = jnp.maximum(g11 * g22 - g12 * g12, 1e-30)
            v = (g22 * r1 - g12 * r2) / det
            w = (g11 * r2 - g12 * r1) / det
            v = jnp.clip(v, 0.0, 1.0)
            w = jnp.clip(w, 0.0, 1.0 - v)
            proj = a + v * ab + w * ac
            return jnp.sum((proj - p) ** 2), proj

        d, projs = jax.vmap(tri_dist)(tri)
        i = jnp.argmin(d)
        return projs[i], i

    return jax.vmap(one_point)(points)
