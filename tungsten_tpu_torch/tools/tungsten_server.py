"""The HTTP render server on the card: tools/tungsten_server.py (:1-138),
the analog of src/tungsten-server (civetweb).

    python -m tungsten_tpu_torch.tools.tungsten_server scene.json [scene2.json ...] \\
        [--port 8080] [--spp N] [--seed S] [--cpu]

A worker thread renders the queue through the port's render_buffers, its
checkpoint callback publishing the live framebuffer, while the server
answers /status (JSON: state, scene, currentSpp, totalSpp, queue), /render
(a PNG of the tonemapped framebuffer) and /log (the recent log lines). It
renders on the CUDA card, and raises where there is none; --cpu renders on
the CPU. --port 0 takes an ephemeral port. `RenderServer` is the same
server as an object, to start and stop from code.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

LOG_LINES = 200  # the log lines /log keeps
CHECKPOINT_S = 2.0  # seconds between the worker's framebuffer updates


def png_bytes(ldr: np.ndarray) -> bytes:
    """An (H, W, 3) image in [0, 1] as PNG bytes (floor quantization, as
    save_image)."""
    from PIL import Image

    u8 = np.clip((ldr * 255).astype(np.int32), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8, "RGB").save(buf, "PNG")
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    server_state = None  # the RenderServer, set on each server's subclass

    def log_message(self, *a):
        pass

    def _send(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server_state
        if self.path.startswith("/status"):
            self._send(200, "application/json", json.dumps(srv.status()).encode())
        elif self.path.startswith("/render"):
            frame, tm = srv.frame()
            if frame is None:
                self._send(404, "text/plain", b"no frame yet")
                return
            from ..models.cameras.tonemap import tonemap

            ldr = np.clip(tonemap(tm, torch.as_tensor(frame)).numpy(), 0, 1)
            self._send(200, "image/png", png_bytes(ldr))
        elif self.path.startswith("/log"):
            self._send(200, "text/plain", "\n".join(srv.log_lines()).encode())
        else:
            self._send(404, "text/plain", b"endpoints: /status /render /log")


class RenderServer:
    """The server and its render worker. start() begins both in threads;
    shutdown() stops the server (the worker is a daemon thread)."""

    def __init__(self, scenes, device, spp=None, seed=0xBA5EBA11, host="0.0.0.0", port=8080,
                 checkpoint_interval=CHECKPOINT_S):
        self.scenes, self.device, self.spp, self.seed = list(scenes), device, spp, seed
        self.checkpoint_interval = checkpoint_interval
        self.lock = threading.Lock()
        self.state = {"state": "idle", "scene": "", "currentSpp": 0, "totalSpp": 0,
                      "queue": list(scenes), "log": [], "frame": None, "tonemap": "gamma"}
        handler = type("Handler", (_Handler,), {"server_state": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self.worker = threading.Thread(target=self.render_worker, daemon=True)
        self.serving = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def log(self, msg):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        with self.lock:
            self.state["log"] = (self.state["log"] + [line])[-LOG_LINES:]
        print(line, flush=True)

    def status(self) -> dict:
        with self.lock:
            return {k: self.state[k] for k in ("state", "scene", "currentSpp", "totalSpp",
                                               "queue")}

    def frame(self):
        with self.lock:
            return self.state["frame"], self.state["tonemap"]

    def log_lines(self):
        with self.lock:
            return list(self.state["log"])

    def render_worker(self):
        from ..renderer.render import render_buffers
        from ..scene.flatten import flatten_scene
        from ..scene.load import load_scene

        for path in self.scenes:
            try:
                self.log(f"loading {path}")
                scene = flatten_scene(load_scene(path), self.device)
                spp = self.spp or scene.meta.spp
                with self.lock:
                    self.state.update(state="rendering", scene=path, totalSpp=spp, currentSpp=0,
                                      tonemap=scene.meta.tonemap)

                def on_ckpt(bufs, done_passes, path=path, spp=spp):
                    with self.lock:
                        self.state["frame"] = bufs.color()
                        self.state["currentSpp"] = int(bufs.count.min())
                    self.log(f"{path}: {int(bufs.count.min())}/{spp} spp")

                bufs = render_buffers(scene, spp=spp, seed=self.seed, checkpoint_cb=on_ckpt,
                                      checkpoint_interval=self.checkpoint_interval)
                with self.lock:
                    self.state["frame"] = bufs.color()
                    self.state["currentSpp"] = spp
                self.log(f"finished {path}")
            except Exception as e:  # the server reports a failed scene and goes on
                self.log(f"FAILED {path}: {e}")
        with self.lock:
            self.state["state"] = "idle"

    def start(self):
        self.log(f"serving on :{self.port} ({self.device})")
        self.worker.start()
        self.serving.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _args(argv):
    ap = argparse.ArgumentParser(description="tungsten-tpu render server (PyTorch + CUDA port)")
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--port", type=int, default=8080, help="0 takes an ephemeral port")
    ap.add_argument("--spp", type=int)
    ap.add_argument("--seed", type=int, default=0xBA5EBA11)
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    from .. import device

    dev = device("cpu" if args.cpu else "cuda")
    srv = RenderServer(args.scenes, dev, spp=args.spp, seed=args.seed, port=args.port).start()
    try:
        srv.serving.join()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
