"""Point-pattern matching, the similarity transform between two point
sets: a copy of ``lightcurver_tpu/utilities/pattern_matching.py``.

Both alternate plate solvers call it. Triangles among the brightest points
on each side are matched by their scale- and rotation-invariant side
ratios with a KD-tree, then a similarity transform is taken by RANSAC
from the proposed correspondences and refined on its inliers.
"""

import itertools

import numpy as np
from scipy.spatial import cKDTree


class SimilarityTransform:
    """x' = s R x + t (no reflection)."""

    def __init__(self, matrix, translation):
        self.params = np.eye(3)
        self.params[:2, :2] = matrix
        self.params[:2, 2] = translation
        self.matrix = np.asarray(matrix, dtype=float)
        self.translation = np.asarray(translation, dtype=float)

    @property
    def scale(self):
        return float(np.sqrt(abs(np.linalg.det(self.matrix))))

    @property
    def rotation(self):
        return float(np.arctan2(self.matrix[1, 0], self.matrix[0, 0]))

    @property
    def inverse(self):
        inv = np.linalg.inv(self.matrix)
        return SimilarityTransform(inv, -inv @ self.translation)

    def __call__(self, points):
        points = np.atleast_2d(np.asarray(points, dtype=float))
        return points @ self.matrix.T + self.translation


def estimate_similarity(src, dst, allow_reflection=False):
    """Least-squares similarity transform (Umeyama) mapping src -> dst."""
    src = np.asarray(src, dtype=float)
    dst = np.asarray(dst, dtype=float)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(2)
    if not allow_reflection and np.linalg.det(U @ Vt) < 0:
        S[1, 1] = -1.0
    R = U @ S @ Vt
    var_s = (sc**2).sum() / len(src)
    scale = np.trace(np.diag(D) @ S) / var_s
    matrix = scale * R
    return SimilarityTransform(matrix, mu_d - matrix @ mu_s)


def _triangles(points, n_neighbors=5):
    """Triangle vertex triples among each point's nearest neighbours."""
    tree = cKDTree(points)
    k = min(n_neighbors + 1, len(points))
    _, nbrs = tree.query(points, k=k)
    tris = set()
    for i, row in enumerate(nbrs):
        for j, l in itertools.combinations(row[1:], 2):
            tris.add(tuple(sorted((i, int(j), int(l)))))
    return list(tris)


def _invariants(points, triangles):
    """(L2/L1, L1/L0) of sorted side lengths + vertex order by role.

    Vertices are reordered so that correspondence is implied by the
    invariant match: vertex 0 is opposite the longest side, etc.
    """
    feats, orders = [], []
    for tri in triangles:
        p = points[list(tri)]
        # side k is opposite vertex k
        sides = np.array([
            np.linalg.norm(p[1] - p[2]),
            np.linalg.norm(p[0] - p[2]),
            np.linalg.norm(p[0] - p[1])])
        if sides.min() <= 0:
            continue
        order = np.argsort(sides)  # ascending side length
        L0, L1, L2 = sides[order]
        feats.append((L2 / L1, L1 / L0))
        # vertex opposite the shortest side first, etc.
        orders.append(tuple(np.asarray(tri)[order]))
    return np.asarray(feats), orders


def find_transform(source, target, max_control_points=50,
                   pixel_tolerance=2.0, min_matches=4,
                   invariant_tolerance=0.03, max_candidates=500):
    """Find the similarity transform mapping source points onto target.

    Args:
        source, target: (N, 2) arrays (brightest-first works best).
        max_control_points: use at most this many points per side.
        pixel_tolerance: inlier radius in target units.
        min_matches: minimum inlier correspondences to accept.

    Returns:
        (SimilarityTransform, (source_idx, target_idx)) of inliers.

    Raises:
        ValueError when no acceptable transform exists.
    """
    src = np.asarray(source, dtype=float)[:max_control_points]
    dst = np.asarray(target, dtype=float)[:max_control_points]
    if len(src) < 3 or len(dst) < 3:
        raise ValueError("need at least 3 points on each side")

    tri_s = _triangles(src)
    tri_d = _triangles(dst)
    feat_s, order_s = _invariants(src, tri_s)
    feat_d, order_d = _invariants(dst, tri_d)
    if not len(feat_s) or not len(feat_d):
        raise ValueError("could not build triangles")

    tree = cKDTree(feat_d)
    dist, idx = tree.query(feat_s, k=1,
                           distance_upper_bound=invariant_tolerance)
    candidates = [(d, order_s[i], order_d[j])
                  for i, (d, j) in enumerate(zip(dist, idx))
                  if np.isfinite(d)]
    if not candidates:
        raise ValueError("no matching triangles")
    # BEST invariant matches first (smallest KD-tree distance), then cap
    # the RANSAC work — an unsorted cap could drop every true
    # correspondence in a dense field
    candidates.sort(key=lambda c: c[0])
    candidates = [(vs, vd) for _, vs, vd in candidates[:max_candidates]]

    dst_tree = cKDTree(dst)
    best = None
    best_inliers = None
    for vs, vd in candidates:
        t = estimate_similarity(src[list(vs)], dst[list(vd)])
        if not (0.1 < t.scale < 10.0):
            continue
        proj = t(src)
        d, j = dst_tree.query(proj, k=1)
        inlier = d < pixel_tolerance
        # one-to-one: keep the closest source per target
        pairs = {}
        for si in np.flatnonzero(inlier):
            ti = int(j[si])
            if ti not in pairs or d[si] < d[pairs[ti]]:
                pairs[ti] = si
        n_in = len(pairs)
        if n_in >= min_matches and (best is None
                                    or n_in > len(best_inliers[0])):
            s_idx = np.array(sorted(pairs.values()))
            t_idx = np.array([ti for ti, si in sorted(
                pairs.items(), key=lambda kv: kv[1])])
            best_inliers = (s_idx, t_idx)
            best = t
            if n_in >= min(len(src), len(dst)) * 0.8:
                break
    if best is None:
        raise ValueError("no similarity transform found")

    # refine on all inliers
    s_idx, t_idx = best_inliers
    best = estimate_similarity(src[s_idx], dst[t_idx])
    return best, (s_idx, t_idx)
