"""SIBR-compatible live-viewer network protocol.

Re-implementation of the reference's socket viewer bridge
(`gaussian_renderer/network_gui.py` — wire format: 4-byte little-endian
length prefix + JSON request {resolution_x/y, train, fov_x/y, z_near/far,
shs_python, rot_scale_python, keep_alive, scaling_modifier, view_matrix,
view_projection_matrix}; response: raw RGB bytes + length-prefixed verify
string). PyTorch-port counterpart of `fourdgs_tpu/viewer.py` (sockets and
numpy only); `render_cli --viewer` serves a checkpoint through
`ViewerServer.poll(render_fn)`.

Matrices arrive in the reference's transposed row-vector convention with
SIBR's Y/Z flips (`network_gui.py:73-77`); `decode_camera` converts them
to this framework's M @ [x; 1] convention.
"""

from __future__ import annotations

import json
import select
import socket
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class ViewerRequest:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    viewmatrix: np.ndarray       # (4, 4), applies as M @ [x; 1]
    full_proj: np.ndarray        # (4, 4)


def decode_camera(message: dict) -> Optional[ViewerRequest]:
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = np.array(message["view_projection_matrix"],
                    np.float32).reshape(4, 4)
    proj[:, 1] *= -1
    # The reference stores transposed (row-vector) matrices; ours apply as
    # M @ [x; 1].
    return ViewerRequest(
        width=width, height=height,
        fovx=message["fov_x"], fovy=message["fov_y"],
        znear=message["z_near"], zfar=message["z_far"],
        do_training=bool(message["train"]),
        keep_alive=bool(message["keep_alive"]),
        scaling_modifier=float(message["scaling_modifier"]),
        viewmatrix=view.T, full_proj=proj.T)


class ViewerServer:
    """Non-blocking listener; call `poll` in the caller's loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def _try_accept(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read_message(self) -> dict:
        assert self.conn is not None
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        assert self.conn is not None
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def _send(self, image_bytes: Optional[bytes], verify: str):
        assert self.conn is not None
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn: Callable[[ViewerRequest], np.ndarray],
             verify: str = "") -> bool:
        """Serve at most one pending viewer request.

        render_fn: ViewerRequest -> (H, W, 3) float image in [0, 1].
        Returns whether training should continue (reference `do_training`).
        """
        if self.conn is None:
            self._try_accept()
            if self.conn is None:
                return True
        # Only read when a request header is already pending: a keep-alive
        # client with no new request must not block the caller's loop.
        ready, _, _ = select.select([self.conn], [], [], 0)
        if not ready:
            return True
        try:
            message = self._read_message()
            req = decode_camera(message)
            if req is None:
                self._send(None, verify)
                return True
            img = render_fn(req)
            rgb = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
            self._send(memoryview(rgb).tobytes(), verify)
            if not req.do_training and not req.keep_alive:
                self.close_client()
            return req.do_training
        except (ConnectionError, OSError):
            self.close_client()
            return True

    def close_client(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self):
        self.close_client()
        self.listener.close()
