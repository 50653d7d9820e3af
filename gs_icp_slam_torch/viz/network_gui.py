"""SIBR remote-viewer TCP bridge (the reference's network_gui; counterpart
of gs_icp_slam_tpu/viz/network_gui.py, the same wire protocol).

Speaks the exact wire protocol of the reference's
`gaussian_renderer/network_gui.py:18-86` so the stock SIBR `remote` app
(SIBR_remoteGaussian_app) can watch a live run:

  request : 4-byte LE length + JSON {resolution_x, resolution_y, train,
            fov_y, fov_x, z_near, z_far, shs_python, rot_scale_python,
            keep_alive, scaling_modifier, view_matrix (16),
            view_projection_matrix (16)}
  response: raw RGB bytes (H*W*3, row-major uint8) followed by
            4-byte LE length + verify string (the dataset path upstream;
            mp_Mapper.py:290)

The render canvas is rounded up to 64-pixel multiples with the principal
point kept at the REQUESTED image centre, and the top-left crop is the
requested view, as in the JAX package (a window resize then lands on one
of few canvas shapes).  The view matrix arrives in the torch row-vector
convention with flipped y/z columns (network_gui.py:73-75); transposing
after the sign flips yields the column-vector w2c.

Non-blocking: `poll(render_fn)` costs ~a socket syscall when no viewer
is attached; the engine calls it once per frame (run(net_gui=...)).
"""
from __future__ import annotations

import json
import math
import socket
from typing import Callable, Optional

import numpy as np

# render_fn(w2c (4,4) f32, width, height, fx, fy) -> (H, W, 3) uint8
RenderFn = Callable[[np.ndarray, int, int, float, float], np.ndarray]


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 verify: str = "gs_icp_slam_torch"):
        self.verify = verify.encode("ascii")
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.port = self.listener.getsockname()[1]

    # ---------------------------------------------------------------- wire
    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            b = self.conn.recv(n - got)
            if not b:
                raise ConnectionError("peer closed")
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    def _read_message(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _send(self, image_bytes: Optional[bytes]):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(self.verify).to_bytes(4, "little"))
        self.conn.sendall(self.verify)

    def _drop(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        self.conn = None

    @staticmethod
    def _view(msg: dict):
        """(w2c, w, h, fx, fy) of a request, or None for a keep-alive (zero
        resolution)."""
        w = int(msg["resolution_x"])
        h = int(msg["resolution_y"])
        if not (w and h):
            return None
        m = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        m[:, 1] *= -1.0
        m[:, 2] *= -1.0
        w2c = m.T  # row-vector convention -> column-vector
        fx = w / (2.0 * math.tan(float(msg["fov_x"]) / 2.0))
        fy = h / (2.0 * math.tan(float(msg["fov_y"]) / 2.0))
        return w2c, w, h, fx, fy

    # ---------------------------------------------------------------- api
    def poll(self, render_fn: RenderFn, timeout: float = 0.02) -> bool:
        """Serve at most one pending viewer request; True if one was
        served.  Never raises on a viewer disconnect or a malformed request
        (conn resets to None, matching mp_Mapper.py:293-294); a failing
        render_fn raises."""
        if self.conn is None:
            try:
                self.conn, _ = self.listener.accept()
            except OSError:  # no viewer waiting (BlockingIOError)
                return False
        try:
            self.conn.settimeout(timeout)
            try:
                msg = self._read_message()
            except (socket.timeout, BlockingIOError):
                return False
            self.conn.settimeout(None)
            view = self._view(msg)
        except (OSError, ValueError, KeyError, TypeError):
            self._drop()
            return False
        img_bytes = None
        if view is not None:
            w2c, w, h, fx, fy = view
            img = render_fn(w2c, w, h, fx, fy)
            if img.shape != (h, w, 3) or img.dtype != np.uint8:
                raise ValueError(f"render_fn gave {img.shape} {img.dtype}, "
                                 f"not ({h}, {w}, 3) uint8")
            img_bytes = np.ascontiguousarray(img).tobytes()
        try:
            self._send(img_bytes)
        except OSError:
            self._drop()
            return False
        return True

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()


def make_map_render_fn(params, live, sh_degree: int, bg=None) -> RenderFn:
    """A RenderFn over a Gaussian-map snapshot (params: the map's parameter
    tensors, live: its mask, on one device; the render runs there, kernel
    K1-fwd on the card): 32-pixel tiles, tile span 2, K 256, the canvas
    rounded up to 64-pixel multiples and cropped."""
    import torch

    from ..ops.rasterize import rasterize_tiled

    dev = params["xyz"].device
    bg = torch.zeros(3) if bg is None else torch.as_tensor(bg)
    bg = bg.to(device=dev, dtype=torch.float32)

    @torch.no_grad()
    def render(w2c, w, h, fx, fy):
        wq = -(-w // 64) * 64
        hq = -(-h // 64) * 64
        out = rasterize_tiled(
            params["xyz"], params["rotation"],
            torch.exp(params["log_scaling"]),
            torch.sigmoid(params["opacity_logit"][:, 0]),
            torch.cat([params["f_dc"][:, None, :], params["f_rest"]], dim=1),
            torch.as_tensor(np.asarray(w2c, np.float32), device=dev), live,
            bg, fx, fy, (w - 1) / 2.0, (h - 1) / 2.0,
            sh_degree=sh_degree, width=wq, height=hq, tile=32,
            visible_cap=min(1 << 16, params["xyz"].shape[0]),
            tile_span=2, tile_cap=256)
        img = out.color[:, :h, :w].cpu().numpy()  # (3, h, w)
        img = np.clip(img, 0.0, 1.0)
        return (img.transpose(1, 2, 0) * 255).astype(np.uint8)

    return render
