"""The port's SIBR viewer bridge: request decoding equal to the JAX
package's, one socket round trip on the CPU through
`render_cli.viewer_render_fn` and `Evaluator.render_arrays` (the bytes are
the render's 8-bit image; tolerance: none), and the resize of a request at
another resolution."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from fourdgs_tpu import viewer as jax_viewer
from fourdgs_tpu.engine import checkpoint as jax_ckpt
from fourdgs_tpu_torch import render_cli
from fourdgs_tpu_torch import viewer as port_viewer
from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine.evaluator import Evaluator

from torch_helpers import SYNTH_GATE_OVERRIDES as OVERRIDES
from torch_helpers import jax_synth_gate_state as _jax_state


def _message(cam, width, height, **over):
    """A SIBR-format request for a scene camera: row-vector (transposed)
    matrices with the y/z flips that `decode_camera` undoes."""
    view = cam.viewmatrix.T.copy()
    view[:, 1:3] *= -1
    proj = cam.full_proj.T.copy()
    proj[:, 1] *= -1
    msg = {"resolution_x": width, "resolution_y": height, "train": False,
           "fov_x": cam.fovx, "fov_y": cam.fovy, "z_near": 0.01,
           "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": False, "scaling_modifier": 1.0,
           "view_matrix": view.flatten().tolist(),
           "view_projection_matrix": proj.flatten().tolist()}
    msg.update(over)
    return msg


def _client_request(port, message, result):
    with socket.create_connection(("127.0.0.1", port), timeout=20) as c:
        payload = json.dumps(message).encode()
        c.sendall(len(payload).to_bytes(4, "little") + payload)
        h, w = message["resolution_y"], message["resolution_x"]
        buf = b""
        while len(buf) < h * w * 3:
            chunk = c.recv(h * w * 3 - len(buf))
            if not chunk:
                break
            buf += chunk
        vlen = int.from_bytes(c.recv(4), "little")
        result["verify"] = c.recv(vlen).decode()
        result["img"] = np.frombuffer(buf, np.uint8).reshape(h, w, 3)


@pytest.fixture(scope="module")
def evaluator(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viewer") / "chkpnt40.pkl")
    state, env = _jax_state()
    jax_ckpt.save_checkpoint(path, state, env, 40)
    ev = Evaluator(load_config(None, OVERRIDES), device="cpu", verbose=False)
    ev.eval_infer = True
    ev.load(path)
    return ev


def test_decode_camera_equals_jax(evaluator):
    cam = evaluator.scene.test_cameras[0]
    msg = _message(cam, 48, 40, train=True, keep_alive=True,
                   scaling_modifier=2.0)
    got, want = port_viewer.decode_camera(msg), jax_viewer.decode_camera(msg)
    for f in ("width", "height", "fovx", "fovy", "znear", "zfar",
              "do_training", "keep_alive", "scaling_modifier"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.viewmatrix, want.viewmatrix)
    np.testing.assert_array_equal(got.full_proj, want.full_proj)
    # The encoding above is the inverse of the decoding.
    np.testing.assert_array_equal(got.viewmatrix, cam.viewmatrix)
    np.testing.assert_array_equal(got.full_proj, cam.full_proj)
    assert port_viewer.decode_camera({**msg, "resolution_x": 0}) is None


@pytest.mark.parametrize("size", [(48, 48), (24, 20)],
                         ids=["native", "resized"])
def test_viewer_round_trip_serves_the_render(evaluator, size):
    cam = evaluator.scene.test_cameras[0]
    w, h = size
    server = port_viewer.ViewerServer(port=0)
    port = server.listener.getsockname()[1]
    result = {}
    thread = threading.Thread(
        target=_client_request, args=(port, _message(cam, w, h), result))
    thread.start()
    render_fn = render_cli.viewer_render_fn(evaluator, cam.timestamp)
    deadline = time.monotonic() + 20.0
    keeps = set()
    while "img" not in result and time.monotonic() < deadline:
        keeps.add(server.poll(render_fn, verify="ok"))
        time.sleep(0.001)
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert "img" in result, "viewer request was never served"
    assert result["verify"] == "ok"
    assert server.conn is None          # keep_alive False: client closed
    server.close()
    assert False in keeps               # the request's `train` flag

    color = evaluator.render_view(cam)[0].numpy()
    want = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    if size == (48, 48):
        np.testing.assert_array_equal(result["img"], want)
    else:
        from PIL import Image
        resized = np.asarray(Image.fromarray(want).resize((w, h)))
        np.testing.assert_array_equal(result["img"], resized)
    assert result["img"].max() > 0
