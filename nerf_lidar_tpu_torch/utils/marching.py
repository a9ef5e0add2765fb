# Copy of nerf_lidar_tpu/utils/marching.py (see tests/test_torch_host.py).
"""Isosurface extraction via marching tetrahedra (numpy).

The reference uses skimage.measure.marching_cubes (extract.py:397-400);
skimage isn't in this environment, and the MC lookup tables are 256-entry
transcriptions anyway. Marching tetrahedra splits each cube into 6 tets
whose 16 sign cases reduce to two shapes (1-vs-3 -> one triangle,
2-vs-2 -> two), which we enumerate programmatically — same capability,
simpler and fully testable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Cube corners (z-minor order) and the 6-tetrahedron decomposition around
# the main diagonal 0-7.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)


def marching_tetrahedra(values: np.ndarray, level: float,
                        origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface `values == level` from a dense grid.

    values: [X, Y, Z] scalar field. Returns (vertices [V, 3] in world units
    via origin+spacing, faces [F, 3] int). Vertices are not deduplicated
    across tets (use weld_vertices for a compact mesh).
    """
    vals = np.asarray(values, np.float64)
    nx, ny, nz = vals.shape
    # All cube base indices.
    bx, by, bz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)  # [C, 3]

    # Corner values per cube: [C, 8].
    cidx = base[:, None, :] + _CORNERS[None, :, :]
    cv = vals[cidx[..., 0], cidx[..., 1], cidx[..., 2]]
    # Skip cubes with no crossing.
    crossing = (cv.min(1) < level) & (cv.max(1) > level)
    base, cv, cidx = base[crossing], cv[crossing], cidx[crossing]

    verts_out = []
    spacing = np.asarray(spacing, np.float64)
    origin = np.asarray(origin, np.float64)

    def edge_interp(p0, v0, p1, v1):
        t = (level - v0) / (v1 - v0)
        return p0 + t[:, None] * (p1 - p0)

    for tet in _TETS:
        tv = cv[:, tet]  # [C, 4]
        tp = cidx[:, tet, :].astype(np.float64)  # [C, 4, 3]
        inside = tv > level  # [C, 4]
        n_in = inside.sum(1)

        # Case A: exactly one vertex on one side -> single triangle.
        for flip in (False, True):
            io = ~inside if flip else inside
            one = io.sum(1) == 1
            if not one.any():
                continue
            sel = np.where(one)[0]
            apex = io[sel].argmax(1)
            others = np.array([[j for j in range(4) if j != a]
                               for a in apex])
            p_apex = tp[sel, apex]
            v_apex = tv[sel, apex]
            tri = []
            for k in range(3):
                p_o = tp[sel, others[:, k]]
                v_o = tv[sel, others[:, k]]
                tri.append(edge_interp(p_apex, v_apex, p_o, v_o))
            tri = np.stack(tri, axis=1)  # [S, 3, 3]
            if flip:
                tri = tri[:, ::-1]  # keep consistent winding
            verts_out.append(tri.reshape(-1, 3))

        # Case B: 2-2 split -> quad as two triangles.
        two = n_in == 2
        if two.any():
            sel = np.where(two)[0]
            ins = inside[sel]
            # Identify the two inside (a, b) and two outside (c, d).
            order = np.argsort(~ins, axis=1)  # inside first
            a, b, c, d = order[:, 0], order[:, 1], order[:, 2], order[:, 3]
            g = lambda col: (tp[sel, col], tv[sel, col])
            (pa, va), (pb, vb), (pc, vc), (pd, vd) = g(a), g(b), g(c), g(d)
            e_ac = edge_interp(pa, va, pc, vc)
            e_ad = edge_interp(pa, va, pd, vd)
            e_bc = edge_interp(pb, vb, pc, vc)
            e_bd = edge_interp(pb, vb, pd, vd)
            quad1 = np.stack([e_ac, e_ad, e_bd], axis=1)
            quad2 = np.stack([e_ac, e_bd, e_bc], axis=1)
            verts_out.append(quad1.reshape(-1, 3))
            verts_out.append(quad2.reshape(-1, 3))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_out, axis=0)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    verts = origin + verts * spacing
    return verts, faces


def weld_vertices(verts: np.ndarray, faces: np.ndarray,
                  decimals: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate vertices (quantized) and reindex faces."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq, inv[faces]


def _drop_degenerate_faces(faces: np.ndarray) -> np.ndarray:
    """Faces with a repeated vertex index."""
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return faces[ok]


def _face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)


def _remove_unreferenced(verts, faces):
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[faces]


def _connected_components(n_verts: int, faces: np.ndarray):
    """Per-vertex component labels via scipy csgraph over face edges."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                        shape=(n_verts, n_verts))
    _, labels = connected_components(adj, directed=False)
    return labels


def clean_mesh(verts: np.ndarray, faces: np.ndarray, v_pct: float = 1.0,
               min_f: int = 8, min_d: float = 5.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side mesh cleanup with the reference's filter ladder
    (reference extract.py:187-253 clean_mesh, which calls pymeshlab —
    absent in this environment; this is a numpy/scipy re-implementation
    of the same capabilities):

      remove unreferenced vertices
      merge close vertices        (v_pct/10000 of the bbox diagonal,
                                   the reference's documented threshold)
      remove duplicate faces      (same vertex set in any order)
      remove null faces           (zero area)
      remove small components     (< min_f faces, or diameter < min_d%
                                   of the bbox diagonal)

    The reference's non-manifold repair + isotropic remeshing stages are
    specific meshlab algorithms; downstream consumers here (PLY export,
    projection coloring) don't require manifoldness, so those stages are
    intentionally not reproduced.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return verts[:0], faces
    verts, faces = _remove_unreferenced(verts, faces)
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    if v_pct > 0 and diag > 0:
        # Quantized close-vertex merge at the reference threshold.
        cell = v_pct * diag / 10000.0
        key = np.floor(verts / cell).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        # Cluster representative = mean of members.
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, verts)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        verts = sums / counts[:, None]
        faces = inv[faces]
    faces = _drop_degenerate_faces(faces)
    # Duplicate faces: same sorted vertex triple.
    tri_key = np.sort(faces, axis=1)
    _, keep = np.unique(tri_key, axis=0, return_index=True)
    faces = faces[np.sort(keep)]
    # Null faces.
    faces = faces[_face_areas(verts, faces) > 1e-20]
    if len(faces) and (min_f > 0 or min_d > 0):
        labels = _connected_components(len(verts), faces)
        flab = labels[faces[:, 0]]
        drop = np.zeros(labels.max() + 1, bool)
        if min_f > 0:
            fcount = np.bincount(flab, minlength=len(drop))
            drop |= (fcount > 0) & (fcount < min_f)
        if min_d > 0 and diag > 0:
            # One O(V) pass for all component bboxes (a per-component
            # boolean rescan is O(components x V) — minutes on noisy
            # marching-tets output with thousands of floaters).
            vmin = np.full((len(drop), 3), np.inf)
            vmax = np.full((len(drop), 3), -np.inf)
            np.minimum.at(vmin, labels, verts)
            np.maximum.at(vmax, labels, verts)
            d = np.linalg.norm(vmax - vmin, axis=1)
            drop |= d < (min_d / 100.0 * diag)
        faces = faces[~drop[flab]]
    verts, faces = _remove_unreferenced(verts, faces)
    return verts, faces


def _qem_quadric_setup(verts, faces):
    """Per-vertex Garland-Heckbert quadrics ([V,10] upper-triangular
    symmetric 4x4: a11 a12 a13 a14 a22 a23 a24 a33 a34 a44) from
    area-weighted face planes."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    area2 = np.linalg.norm(n, axis=-1)
    ok = area2 > 1e-20
    nn = np.where(ok[:, None], n / np.maximum(area2, 1e-20)[:, None], 0.0)
    d = -np.einsum("fi,fi->f", nn, v0)
    w = np.where(ok, 0.5 * area2, 0.0)
    p = np.concatenate([nn, d[:, None]], axis=1)  # [F, 4]
    kf = w[:, None] * np.stack([
        p[:, 0] * p[:, 0], p[:, 0] * p[:, 1], p[:, 0] * p[:, 2],
        p[:, 0] * p[:, 3], p[:, 1] * p[:, 1], p[:, 1] * p[:, 2],
        p[:, 1] * p[:, 3], p[:, 2] * p[:, 2], p[:, 2] * p[:, 3],
        p[:, 3] * p[:, 3]], axis=1)  # [F, 10]
    quad = np.zeros((len(verts), 10))
    for i in range(3):
        np.add.at(quad, faces[:, i], kf)
    return quad


def _qem_eval(q, x):
    return (q[0] * x[0] * x[0] + 2 * q[1] * x[0] * x[1]
            + 2 * q[2] * x[0] * x[2] + 2 * q[3] * x[0]
            + q[4] * x[1] * x[1] + 2 * q[5] * x[1] * x[2] + 2 * q[6] * x[1]
            + q[7] * x[2] * x[2] + 2 * q[8] * x[2] + q[9])


def _qem_best_point(q, pa, pb):
    """Minimizer of the quadric. Rank-deficient quadrics (coplanar or
    two-plane neighborhoods) have an affine SET of minimizers (a plane /
    a line — e.g. a crease edge); the pseudo-inverse solve anchored at
    the segment midpoint picks the minimizer nearest the collapsing edge,
    which keeps crease and face vertices exactly on their feature instead
    of cutting the corner the way an endpoint/midpoint fallback does."""
    a = np.array([[q[0], q[1], q[2]], [q[1], q[4], q[5]],
                  [q[2], q[5], q[7]]])
    b = -np.array([q[3], q[6], q[8]])
    xm = 0.5 * (pa + pb)
    w, vec = np.linalg.eigh(a)
    cut = 1e-8 * max(abs(w[0]), abs(w[2]))
    winv = np.where(np.abs(w) > cut, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    x = xm + vec @ (winv * (vec.T @ (b - a @ xm)))
    return x, _qem_eval(q, x)


def _qem_decimate_py(verts, faces, target):
    """Pure-Python QEM edge collapse — same semantics as the native
    kernel (native/mesh_native.cpp:qem_decimate): lazy-invalidated heap,
    normal-flip guard over the optimal/endpoints/midpoint candidate
    ladder. Returns (verts, faces, reached)."""
    import heapq

    pos = np.asarray(verts, np.float64).copy()
    faces = _drop_degenerate_faces(np.asarray(faces, np.int64))
    quad = _qem_quadric_setup(pos, faces)
    face_alive = np.ones(len(faces), bool)
    faces_left = len(faces)
    vert_alive = np.ones(len(pos), bool)
    stamp = np.zeros(len(pos), np.int64)
    inc = [[] for _ in range(len(pos))]
    for f, tri in enumerate(faces):
        for v in tri:
            inc[v].append(f)

    heap = []

    def push_edge(a, b):
        if a > b:
            a, b = b, a
        q = quad[a] + quad[b]
        x, cost = _qem_best_point(q, pos[a], pos[b])
        heapq.heappush(heap, (cost, a, b, stamp[a], stamp[b],
                              (x[0], x[1], x[2])))

    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    for a, b in e:
        push_edge(int(a), int(b))

    def flips(f, moved, newp):
        tri = faces[f]
        p = pos[tri]
        q = np.where((tri == moved)[:, None], newp, p)
        n0 = np.cross(p[1] - p[0], p[2] - p[0])
        n1 = np.cross(q[1] - q[0], q[2] - q[0])
        return float(n0 @ n1) <= 0.0

    while faces_left > target and heap:
        cost, a, b, sa, sb, x = heapq.heappop(heap)
        if not (vert_alive[a] and vert_alive[b]):
            continue
        if sa != stamp[a] or sb != stamp[b]:
            continue
        pa, pb = pos[a], pos[b]
        chosen = None
        # Optimal first, then the endpoints (existing surface points — a
        # half-edge collapse), midpoint last: a midpoint across a crease
        # invents an off-feature position.
        for cand in (np.asarray(x), pa, pb, 0.5 * (pa + pb)):
            bad = False
            for v in (a, b):
                for f in inc[v]:
                    if not face_alive[f]:
                        continue
                    tri = faces[f]
                    if (tri == a).any() and (tri == b).any():
                        continue  # dies in the collapse
                    if flips(f, v, cand):
                        bad = True
                        break
                if bad:
                    break
            if not bad:
                chosen = cand
                break
        if chosen is None:
            continue
        pos[a] = chosen
        quad[a] += quad[b]
        vert_alive[b] = False
        stamp[a] += 1
        for f in inc[b]:
            if not face_alive[f]:
                continue
            tri = faces[f]
            if (tri == a).any():
                face_alive[f] = False
                faces_left -= 1
            else:
                faces[f] = np.where(tri == b, a, tri)
                inc[a].append(f)
        inc[b] = []
        nbrs = set()
        for f in inc[a]:
            if face_alive[f]:
                nbrs.update(int(v) for v in faces[f] if v != a)
        for nb in sorted(nbrs):
            if vert_alive[nb]:
                push_edge(a, nb)

    out_f = _drop_degenerate_faces(faces[face_alive])
    v2, f2 = _remove_unreferenced(pos, out_f)
    return v2, f2, faces_left <= target


def decimate_mesh(verts: np.ndarray, faces: np.ndarray, target: int,
                  max_iters: int = 12, method: str = "qem"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decimate to <= target faces.

    method="qem" (default): quadric edge collapse — the algorithm behind
    the reference's pymeshlab meshing_decimation_quadric_edge_collapse
    stage (reference extract.py:254-289) — pure Python up to 100,000
    faces, clustering above (the JAX package's path without its native
    library). If the
    normal-flip guard drains the edge heap above `target`, the remainder
    is finished by clustering so the <= target contract always holds.

    method="cluster": uniform-grid vertex clustering (the
    meshing_decimation_clustering alternative the reference's own code
    lists next to quadric collapse, extract.py:273-275): vertices
    collapse to the mean of their cell; cell size is bisected for
    `max_iters` rounds until the face count lands at or below `target`.
    """
    if method == "qem":
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        if len(faces) <= target or len(faces) == 0:
            return verts, faces
        # The port loads no native library: this is the JAX package's
        # path without one (its native QEM is not taken).
        if len(faces) > 100_000:
            # Pure-Python QEM is O(collapses) of numpy small-ops — tens
            # of minutes at marching-lattice scale. Without a C++
            # toolchain, clustering is the honest fallback there.
            return _cluster_decimate(verts, faces, target, max_iters)
        v2, f2, reached = _qem_decimate_py(verts, faces, target)
        if not reached and len(f2) > target:
            return decimate_mesh(v2, f2, target, max_iters,
                                 method="cluster")
        return v2, f2
    if method != "cluster":
        raise ValueError(f"unknown decimation method: {method!r}")
    return _cluster_decimate(verts, faces, target, max_iters)


def _cluster_decimate(verts: np.ndarray, faces: np.ndarray, target: int,
                      max_iters: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) <= target or len(faces) == 0:
        return verts, faces
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    lo, hi = diag / 1024.0, diag / 2.0
    best = None

    def cluster(cell):
        key = np.floor(verts / cell).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, verts)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        v2 = sums / counts[:, None]
        f2 = _drop_degenerate_faces(inv[faces])
        if len(f2):
            tri_key = np.sort(f2, axis=1)
            _, keep = np.unique(tri_key, axis=0, return_index=True)
            f2 = f2[np.sort(keep)]
        return _remove_unreferenced(v2, f2)

    for _ in range(max_iters):
        cell = 0.5 * (lo + hi)
        v2, f2 = cluster(cell)
        if len(f2) <= target:
            best = (v2, f2)
            hi = cell  # try finer (more faces, closer to target)
        else:
            lo = cell  # too many faces: coarsen
    if best is None:
        # Even the coarsest bisected cell left > target faces. Keep
        # coarsening until the <= target contract holds; warn if a tiny
        # target is genuinely unreachable rather than silently violating
        # the CLI's "--decimate to <= N faces" promise.
        cell = hi
        for _ in range(8):
            best = cluster(cell)
            if len(best[1]) <= target:
                break
            cell *= 2.0
        if len(best[1]) > target:
            import warnings
            warnings.warn(
                f"decimate_mesh: could not reach <= {target} faces "
                f"(best {len(best[1])}) — returning the coarsest mesh")
    return best


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """ASCII PLY writer (replaces trimesh/pymeshlab export)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, c8):
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
