"""Plain PyTorch tracking for the reference: the frame's point cloud,
source covariances, the frame-to-map G-ICP and the target export's
covariances.

A frozen copy of the port's plain path (gs_icp_slam_torch utils/se3.py,
utils/quat.py, utils/pointcloud.py, ops/eigh3.py, ops/covariance.py,
ops/knn.py's grid k-NN and ops/gicp.py at this repository's first
benchmark), with kernel K2 replaced by a brute-force 1-NN in blocks.  It
imports nothing of the program.  `q` rounds a tensor to the precision
being checked: the identity for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 3.4e38


def ident(x):
    return x


def bf16(x):
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x


# ------------------------------------------------------------ SE(3), quat --

def skew(w):
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack([torch.stack([zero, -wz, wy], -1),
                        torch.stack([wz, zero, -wx], -1),
                        torch.stack([-wy, wx, zero], -1)], dim=-2)


def se3_exp(xi):
    omega, v = xi[:3], xi[3:]
    theta2 = torch.sum(omega * omega)
    theta = torch.sqrt(theta2)
    K = skew(omega)
    K2 = K @ K
    small = theta2 < 1e-12
    one = torch.ones_like(theta)
    st = torch.where(small, one, theta)
    st2 = torch.where(small, one, theta2)
    st3 = torch.where(small, one, theta2 * theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / st)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / st2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / st3)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    T = torch.zeros((4, 4), dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = (V @ v[:, None])[:, 0]
    T[3, 3] = 1.0
    return T


def invert_se3(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def transform(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=eps)


def rotmat_to_quat(R):
    """Shepperd's method, branch-free, xyzw."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    sw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 2.0
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 2.0
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 2.0
    cw = (0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw)
    cx = ((m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx)
    cy = ((m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy)
    cz = ((m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz)
    c0 = tr > 0.0
    c1 = (m00 >= m11) & (m00 >= m22)
    c2 = m11 >= m22

    def sel(j):
        return torch.where(c0, cw[j], torch.where(
            c1, cx[j], torch.where(c2, cy[j], cz[j])))

    # candidates are (w, x, y, z); the result is xyzw
    return quat_normalize(torch.stack([sel(1), sel(2), sel(3), sel(0)], -1))


def quat_multiply(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def quat_rot_components(quat):
    """The nine entries of the rotation of xyzw quaternions (N, 4)."""
    n = torch.clamp(torch.sqrt(torch.sum(quat * quat, dim=-1)), min=1e-12)
    x, y, z, w = (quat[:, 0] / n, quat[:, 1] / n, quat[:, 2] / n,
                  quat[:, 3] / n)
    return (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
            2.0 * (x * z + w * y), 2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
            2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y))


# ------------------------------------------------------------- eigh 3x3 ---

_TWO_PI_3 = 2.0943951023931953


def _det3(a):
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _eigvals(A):
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-1, -2)), min=1e-30)
    As = A / scale[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (As[..., 0, 0] + As[..., 1, 1] + As[..., 2, 2]) / 3.0
    B = As - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(B * B, dim=(-1, -2)) / 6.0,
                               min=0.0))
    safe_p = torch.where(p > 1e-12, p, torch.ones_like(p))
    r = torch.clamp(_det3(B / safe_p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    lam1 = 3.0 * q - lam0 - lam2
    vals = torch.stack([lam0, lam1, lam2], dim=-1)
    vals = torch.where((p <= 1e-12)[..., None],
                       torch.stack([q, q, q], dim=-1), vals)
    return vals * scale[..., None]


def _null_vector(M, fallback):
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    b12 = n12 > n02
    c_b = torch.where(b12[..., None], c12, c02)
    n_b = torch.where(b12, n12, n02)
    b01 = n01 > n_b
    c = torch.where(b01[..., None], c01, c_b)
    n = torch.where(b01, n01, n_b)
    ok = n > 1e-24
    unit = c / torch.sqrt(torch.where(ok, n, torch.ones_like(n)))[..., None]
    return torch.where(ok[..., None], unit, fallback)


def _any_orthonormal(v):
    use_x = torch.abs(v[..., 0]) < 0.9
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype,
                      device=v.device).expand_as(v)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype,
                      device=v.device).expand_as(v)
    u = torch.linalg.cross(v, torch.where(use_x[..., None], ex, ey))
    return u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True),
                           min=1e-20)


def eigh3(A):
    """Ascending eigenvalues and right-handed eigenvector columns of
    symmetric (..., 3, 3): trigonometric eigenvalues, cross-product
    eigenvectors (the order and signs seed the map's quaternions)."""
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-1, -2)), min=1e-30)
    As = A / scale[..., None, None]
    vals = _eigvals(As)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    rs = As[..., 0, :].shape
    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device)
    v0 = _null_vector(As - vals[..., 0, None, None] * eye, e_z.expand(rs))
    v2 = _null_vector(As - vals[..., 2, None, None] * eye, e_x.expand(rs))
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = torch.linalg.norm(v2, dim=-1, keepdim=True)
    v2 = torch.where(n2 > 1e-10, v2 / torch.clamp(n2, min=1e-20),
                     _any_orthonormal(v0))
    v1 = torch.linalg.cross(v2, v0)
    return vals * scale[..., None], torch.stack([v0, v1, v2], dim=-1)


def cov6(C):
    return torch.stack([C[:, 0, 0], C[:, 0, 1], C[:, 0, 2], C[:, 1, 1],
                        C[:, 1, 2], C[:, 2, 2]], dim=0)


def reg_cov6_from_quat_scale(quat, scales, eps):
    """Plane-regularised covariance components (6, N) of R diag(s^2) R^T:
    the smallest s^2 becomes eps, the others 1."""
    r = quat_rot_components(quat)
    amin = torch.argmin(scales * scales, dim=-1)
    one = torch.ones_like(r[0])
    d = [torch.where(amin == j, eps, one) for j in range(3)]

    def m(a, b):
        return sum(d[j] * r[3 * a + j] * r[3 * b + j] for j in range(3))

    return torch.stack([m(0, 0), m(0, 1), m(0, 2), m(1, 1), m(1, 2),
                        m(2, 2)], dim=0)


# ------------------------------------------------------------- the frame ---

def downsample_filter(width, height, fx, fy, cx, cy, rate):
    """The reference system's pixel-grid subsample: every rate-th column
    on rows {0, rate-1, 2 rate-1, ...}; (flat indices, x_pre, y_pre, gh,
    gw)."""
    h_val = rate * np.arange(0, int(height / rate) + 1) - 1
    h_val[0] = 0
    a, b = np.meshgrid(h_val * width, np.arange(0, width, rate),
                       indexing="ij")
    flat = (a + b).reshape(-1).astype(np.int32)
    x_pre = ((flat % width).astype(np.float32) - cx) / fx
    y_pre = ((flat // width).astype(np.float32) - cy) / fy
    return (flat, x_pre.astype(np.float32), y_pre.astype(np.float32),
            len(h_val), len(range(0, width, rate)))


def grid_knn(points, valid, gh, gw, k, span):
    """k-NN inside a (2 span + 1)^2 window of the pixel grid, ordered by
    (distance, window position); missing candidates give (self, BIG)."""
    W = 2 * span + 1
    S = gh * gw
    dev = points.device
    pg = points.reshape(gh, gw, 3)
    pad = torch.zeros((gh + 2 * span, gw + 2 * span, 3), dtype=points.dtype,
                      device=dev)
    pad[span:span + gh, span:span + gw] = pg
    ok = torch.zeros((gh + 2 * span, gw + 2 * span), dtype=torch.bool,
                     device=dev)
    ok[span:span + gh, span:span + gw] = valid.reshape(gh, gw)
    pid = torch.zeros((gh + 2 * span, gw + 2 * span), dtype=torch.int64,
                      device=dev)
    pid[span:span + gh, span:span + gw] = torch.arange(
        S, device=dev).reshape(gh, gw)
    ds, ids = [], []
    for dy in range(W):
        for dx in range(W):
            d2 = torch.sum((pad[dy:dy + gh, dx:dx + gw] - pg) ** 2, dim=-1)
            ds.append(torch.where(ok[dy:dy + gh, dx:dx + gw], d2, BIG))
            ids.append(pid[dy:dy + gh, dx:dx + gw])
    d2 = torch.stack(ds).reshape(W * W, S)
    ci = torch.stack(ids).reshape(W * W, S)
    vals, order = torch.sort(d2, dim=0, stable=True)
    sqd = vals[:k].T
    idx = torch.gather(ci, 0, order[:k]).T
    self_i = torch.arange(S, device=dev)[:, None]
    return torch.where(sqd < BIG, idx, self_i), sqd


def grid_span(k, span):
    if span > 0:
        return span
    span = 1
    while (2 * span + 1) ** 2 < 2.4 * k:
        span += 1
    return span


def source_covariances(points, valid, gh, gw, g, q=ident):
    """Raw covariances of the k grid neighbours -> (cov6 of the plane-
    regularised covariance (6, S), quats (S, 4), scales (S, 3))."""
    idx, sqd = grid_knn(points, valid, gh, gw, g["k_neighbors"],
                        grid_span(g["k_neighbors"], g["grid_knn_span"]))
    nb = points[idx]
    if g["knn_max_distance"] < 1e4:
        keep = (sqd <= g["knn_max_distance"] ** 2)[..., None]
        cnt = torch.clamp(keep.sum(dim=1), min=1).to(points.dtype)
        mean = torch.where(keep, nb, 0.0).sum(1, keepdim=True) / cnt[:, None]
        cen = torch.where(keep, nb - mean, 0.0)
        cov = torch.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]
    else:
        cen = nb - nb.mean(dim=1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", cen, cen) / idx.shape[1]
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    cov = q(torch.where(valid[:, None, None], cov, eye))
    vals, vecs = eigh3(cov)
    scales = torch.sqrt(torch.clamp(vals, min=1e-12))
    d = torch.tensor([g["plane_eps"], 1.0, 1.0], dtype=cov.dtype,
                     device=cov.device)
    reg = torch.einsum("nij,j,nkj->nik", vecs, d, vecs)
    return q(cov6(reg)), q(rotmat_to_quat(vecs)), q(scales)


# ------------------------------------------------------------------ G-ICP --

def nn1(query, ref, ref_valid, block=2048):
    """Exact 1-NN of each query (Q, 3) among the valid refs (3, R):
    (index, squared distance), ties to the lowest index, (0, BIG) with no
    valid ref."""
    bias = torch.where(ref_valid, 0.0, BIG).to(query.dtype)[None]
    idx = torch.zeros(query.shape[0], dtype=torch.int64, device=query.device)
    sqd = torch.full((query.shape[0],), BIG, dtype=query.dtype,
                     device=query.device)
    for s in range(0, query.shape[0], block):
        qb = query[s:s + block]
        dx = qb[:, 0:1] - ref[0:1]
        dy = qb[:, 1:2] - ref[1:2]
        dz = qb[:, 2:3] - ref[2:3]
        d, i = torch.min(dx * dx + dy * dy + dz * dz + bias, dim=1)
        found = d < BIG
        idx[s:s + block] = torch.where(found, i, 0)
        sqd[s:s + block] = torch.where(found, d, BIG)
    return idx, sqd


def _inv_sym(b00, b01, b02, b11, b12, b22):
    A = b11 * b22 - b12 * b12
    B = b02 * b12 - b01 * b22
    C = b01 * b12 - b02 * b11
    det = b00 * A + b01 * B + b02 * C
    inv = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    D = b00 * b22 - b02 * b02
    E = b01 * b02 - b00 * b12
    F = b00 * b11 - b01 * b01
    return A * inv, B * inv, C * inv, D * inv, E * inv, F * inv


def _rotate6(R, c):
    """Components of R Sigma R^T from (6, S) components."""
    full = torch.stack([torch.stack([c[0], c[1], c[2]], -1),
                        torch.stack([c[1], c[3], c[4]], -1),
                        torch.stack([c[2], c[4], c[5]], -1)], -2)
    return cov6(R @ full @ R.T)


def _chol_solve(A, b):
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(torch.clamp(s, min=1e-20)) if i == j
                       else s / L[j][j])
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def gn_step(T, pts, c6, ok, tgt_pts, tgt_c6, tgt_valid, g, q=ident):
    """One Gauss-Newton linearisation of the point-to-distribution cost
    (left perturbation, rotation first): (T_new, delta, sqd)."""
    R = T[:3, :3]
    p = q(pts @ R.T + T[:3, 3])
    idx, sqd = nn1(p, tgt_pts, tgt_valid)
    w = (ok & (sqd < g["max_correspondence_distance"] ** 2)).to(p.dtype)
    tp = tgt_pts[:, idx]
    tc = tgt_c6[:, idx]
    e = (tp - p.T)                                      # (3, S)
    rc = _rotate6(R, c6)
    m = _inv_sym(*(tc[j] + rc[j] for j in range(6)))
    m = [q(x * w) for x in m]
    M = torch.stack([torch.stack([m[0], m[1], m[2]], -1),
                     torch.stack([m[1], m[3], m[4]], -1),
                     torch.stack([m[2], m[4], m[5]], -1)], -2)   # (S, 3, 3)
    # residual r = t - (R p + t): d r / d(omega, v) = [skew(p), -I]
    J = torch.cat([skew(p), -torch.eye(3, dtype=p.dtype,
                                       device=p.device).expand(
                                           p.shape[0], 3, 3)], dim=2)
    JtM = J.transpose(1, 2) @ M                          # (S, 6, 3)
    H = q((JtM @ J).sum(0))
    grad = q((JtM @ e.T[:, :, None]).sum(0)[:, 0])
    H = H + g["lm_init_lambda"] * torch.trace(H) * torch.eye(
        6, dtype=H.dtype, device=H.device)
    delta = _chol_solve(H, -grad)
    if g["degeneracy_thresh"] > 0.0:
        evals, evecs = torch.linalg.eigh(H)
        keep = (evals >= g["degeneracy_thresh"] * evals[-1]).to(delta.dtype)
        delta = evecs @ (keep * (evecs.T @ delta))
    return se3_exp(delta) @ T, delta, sqd


def rotation_deg(T1, T2):
    tr = torch.trace(T1[:3, :3].T @ T2[:3, :3])
    cos_half = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    return 2.0 * torch.rad2deg(torch.arccos(torch.clamp(cos_half, -1.0, 1.0)))


def gicp_align(pts, c6, ok, tgt, init_T, init_T2, g, q=ident):
    """Gauss-Newton from the adaptive seed until the update is below the
    epsilons: (T, iterations, the last linearisation's sqd)."""
    T = init_T
    if init_T2 is not None and g["motion_model"] == "adaptive":
        if float(rotation_deg(init_T, init_T2)) > g["adaptive_trigger_deg"]:
            T = init_T2
    sqd = None
    it = 0
    while it < g["max_iterations"]:
        T, delta, sqd = gn_step(T, pts, c6, ok, tgt["points"], tgt["cov6"],
                                tgt["valid"], g, q)
        it += 1
        if (float(delta[:3].abs().max()) < g["rotation_epsilon"]
                and float(delta[3:].abs().max())
                < g["transformation_epsilon"]):
            break
    return T, it, sqd
