"""3DGS-ecosystem PLY import/export (counterpart of
gs_icp_slam_tpu/io/ply.py; the same bytes for the same map).

Attribute layout matches the reference exactly
(scene/gaussian_model.py:269-281, save_ply :619-636):
  x y z nx ny nz f_dc_{0..2} f_rest_{0..3R-1} opacity scale_{0..2}
  rot_{0..3}, all float32, binary little-endian, element name 'vertex'.
Raw (pre-activation) values are stored: log scales, opacity logits,
un-normalized quaternions — so maps round-trip bit-exactly and standard
3DGS viewers (SIBR, web viewers) load them directly.

Self-contained writer/reader (no plyfile dependency).  The writer takes
tensors on any device (or numpy arrays) and writes through the host; the
reader returns numpy arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(x, dtype) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _attribute_names(n_rest: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(path: str, xyz, f_dc, f_rest, opacity_logit, log_scaling,
             rotation, mask=None) -> int:
    """Write Gaussians to PLY.  Arrays are (N, ...) raw parameter values;
    `mask` selects live rows.  Returns the number of rows written.

    Channel order: the reference stores f_dc/f_rest transposed to
    channel-major ((N, 3, K).flatten), reproduced here.
    """
    xyz = _host(xyz, np.float32)
    f_dc = _host(f_dc, np.float32).reshape(len(xyz), -1, 3)
    f_rest = _host(f_rest, np.float32).reshape(len(xyz), -1, 3)
    opacity = _host(opacity_logit, np.float32).reshape(len(xyz), 1)
    scales = _host(log_scaling, np.float32)
    rots = _host(rotation, np.float32)
    if mask is not None:
        m = _host(mask, bool)
        xyz, f_dc, f_rest = xyz[m], f_dc[m], f_rest[m]
        opacity, scales, rots = opacity[m], scales[m], rots[m]

    n = len(xyz)
    n_rest = f_rest.shape[1]
    # channel-major flatten: (N, K, 3) -> (N, 3, K) -> (N, 3K)
    f_dc_flat = f_dc.transpose(0, 2, 1).reshape(n, -1)
    f_rest_flat = f_rest.transpose(0, 2, 1).reshape(n, -1)
    normals = np.zeros_like(xyz)
    table = np.concatenate([xyz, normals, f_dc_flat, f_rest_flat, opacity,
                            scales, rots], axis=1).astype("<f4")

    names = _attribute_names(n_rest)
    assert table.shape[1] == len(names)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {a}" for a in names]
    header += ["end_header", ""]

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(np.ascontiguousarray(table).tobytes())
    return n


def load_ply(path: str) -> dict:
    """Read a 3DGS PLY back into raw parameter arrays (numpy).

    Returns dict(xyz, f_dc (N,1,3), f_rest (N,R,3), opacity_logit (N,1),
    log_scaling (N,3), rotation (N,4)).  Mirrors load_ply
    (scene/gaussian_model.py:351-392) including the channel-major
    de-interleave.
    """
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            chunk = f.readline()
            if not chunk:
                raise ValueError("truncated PLY header")
            header += chunk
        lines = header.decode("ascii").splitlines()
        n = None
        names = []
        fmt = None
        for ln in lines:
            parts = ln.split()
            if parts[:2] == ["format", "binary_little_endian"]:
                fmt = "binary"
            elif parts[:2] == ["element", "vertex"]:
                n = int(parts[2])
            elif parts[0] == "property":
                if parts[1] != "float":
                    raise ValueError(f"non-float property {ln}")
                names.append(parts[2])
        if fmt != "binary" or n is None:
            raise ValueError("expected binary_little_endian vertex PLY")
        data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
        table = data.reshape(n, len(names))

    col = {a: i for i, a in enumerate(names)}
    xyz = table[:, [col["x"], col["y"], col["z"]]]
    n_dc = sum(1 for a in names if a.startswith("f_dc_"))
    n_rest = sum(1 for a in names if a.startswith("f_rest_"))
    f_dc = table[:, [col[f"f_dc_{i}"] for i in range(n_dc)]]
    f_dc = f_dc.reshape(n, 3, -1).transpose(0, 2, 1)  # (N, K_dc, 3)
    if n_rest:
        f_rest = table[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
        f_rest = f_rest.reshape(n, 3, -1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    opacity = table[:, [col["opacity"]]]
    scales = table[:, [col[f"scale_{i}"] for i in range(3)]]
    rots = table[:, [col[f"rot_{i}"] for i in range(4)]]
    return dict(xyz=xyz, f_dc=f_dc, f_rest=f_rest, opacity_logit=opacity,
                log_scaling=scales, rotation=rots)
