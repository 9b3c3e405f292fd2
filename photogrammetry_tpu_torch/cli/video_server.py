"""MJPEG streaming server (port of photogrammetry_tpu/cli/video_server.py).

Reference analogue: python_src/scripts/video_server.py:9-52 — Flask MJPEG
stream from a PiCamera with a condition-variable frame buffer.  Here the
frame source is pluggable: a camera when OpenCV can open one, else the
synthetic star-pan scene (so the endpoint is exercisable in CI/headless).

Usage: python -m photogrammetry_tpu_torch.cli.video_server [--port 8000]
       [--source camera|synthetic]
Routes: /            — minimal HTML page embedding the stream
        /video-feed  — multipart/x-mixed-replace MJPEG stream
"""
from __future__ import annotations

import argparse
import io
import itertools
import threading
import time


class FrameBuffer:
    """Latest-frame buffer with condition-variable hand-off
    (StreamingOutput semantics, video_server.py:9-21)."""

    def __init__(self):
        self.frame = None
        self.condition = threading.Condition()

    def write(self, buf: bytes) -> None:
        with self.condition:
            self.frame = buf
            self.condition.notify_all()

    def read(self) -> bytes:
        with self.condition:
            self.condition.wait()
            return self.frame


def synthetic_frames(fps: float = 10.0):
    """Endless loop over the star-pan sequence as JPEG bytes."""
    import numpy as np
    from PIL import Image

    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, generate_sequence,
    )

    scene = generate_sequence(StarSceneConfig(num_frames=24))
    jpegs = []
    for f in scene["frames"]:
        buf = io.BytesIO()
        Image.fromarray(np.asarray(f)).save(buf, format="JPEG")
        jpegs.append(buf.getvalue())
    for jpeg in itertools.cycle(jpegs + jpegs[::-1]):
        yield jpeg
        time.sleep(1.0 / fps)


def camera_frames(fps: float = 10.0):
    import cv2

    cap = cv2.VideoCapture(0)
    if not cap.isOpened():
        raise RuntimeError("no camera available")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        ok, jpeg = cv2.imencode(".jpg", frame)
        if ok:
            yield jpeg.tobytes()
        time.sleep(1.0 / fps)


PAGE = """<html><head><title>photogrammetry_tpu_torch stream</title></head>
<body><h1>photogrammetry_tpu_torch</h1><img src="/video-feed" /></body></html>"""


def make_app(buffer: FrameBuffer):
    try:
        from flask import Flask, Response
    except ImportError as e:  # flask is optional (capture hosts only)
        raise RuntimeError(
            "the video server requires flask (reference: video_server.py "
            "runs on the capture host, not the compute host)") from e

    app = Flask(__name__)

    @app.route("/")
    def index():
        return PAGE

    @app.route("/video-feed")
    def video_feed():
        def generate():
            while True:
                frame = buffer.read()
                yield (b"--frame\r\nContent-Type: image/jpeg\r\n\r\n"
                       + frame + b"\r\n")

        return Response(generate(),
                        mimetype="multipart/x-mixed-replace; boundary=frame")

    return app


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--source", choices=["camera", "synthetic"],
                    default="synthetic")
    args = ap.parse_args(argv)

    buffer = FrameBuffer()
    source = camera_frames if args.source == "camera" else synthetic_frames

    def pump():
        for jpeg in source(args.fps):
            buffer.write(jpeg)

    threading.Thread(target=pump, daemon=True).start()
    make_app(buffer).run(host="0.0.0.0", port=args.port, threaded=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
