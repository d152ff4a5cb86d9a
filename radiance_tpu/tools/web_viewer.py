"""Browser-served interactive viewer: the windowed-GUI analog.

The reference's inspector is a GLFW/OpenGL/ImGui window
(reference: visualization/inspector.cpp:71-246 -- live texture
upload per frame, camera/light/debug sliders, a Save button
:234-243).  Without a display, the shape of
the same capability is a tiny stdlib HTTP server: the render loop
keeps running in the main thread exactly as in `render_loop`
(viewer.py), while a background `ThreadingHTTPServer` serves

  GET  /           the control page (canvas + sliders, no deps)
  GET  /frame.png  the latest rendered frame (PNG, frame id header)
  GET  /state      render stats JSON (frame, ms, controls echo)
  POST /control    {key: value} updates -- the SAME dotted keys as
                   ControlChannel (camera.x, light.dir, debug, batch,
                   depth), handed to on_change(updates) next frame,
                   which resets accumulation exactly like the
                   reference's ImGui-changed path (sample1.cpp:479-490)
  POST /save       timestamped PNG next to out_path (Save button)
  POST /quit       stop the loop

No new dependencies: http.server + Pillow (already the PNG writer).
Drive it with a browser, curl, or tests/test_web_viewer.py's
urllib client.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>radiance_tpu viewer</title><style>
 body { background:#14141e; color:#d8d8e0; font:13px sans-serif;
        display:flex; gap:16px; margin:16px; }
 #frame { image-rendering:pixelated; border:1px solid #333;
          max-width:70vw; }
 .panel { min-width:260px; display:flex; flex-direction:column;
          gap:6px; }
 label { display:flex; justify-content:space-between; gap:8px; }
 input[type=number] { width:70px; background:#222; color:#eee;
                      border:1px solid #444; }
 button { background:#2a2a3a; color:#eee; border:1px solid #555;
          padding:4px 10px; cursor:pointer; }
 #stats { color:#8a8; white-space:pre; }
</style></head><body>
 <img id="frame" src="/frame.png">
 <div class="panel">
  <b>radiance_tpu inspector</b>
  <div id="stats">connecting...</div>
  <label>camera.x <input type="number" step="0.1" id="camera.x"></label>
  <label>camera.y <input type="number" step="0.1" id="camera.y"></label>
  <label>camera.z <input type="number" step="0.1" id="camera.z"></label>
  <label>camera.wx <input type="number" step="0.05" id="camera.wx"></label>
  <label>camera.wy <input type="number" step="0.05" id="camera.wy"></label>
  <label>camera.wz <input type="number" step="0.05" id="camera.wz"></label>
  <label>debug mode <input type="number" step="1" min="0" max="17"
         id="debug"></label>
  <label>batch <input type="number" step="1" min="1" id="batch"></label>
  <label>depth <input type="number" step="1" min="1" id="depth"></label>
  <button onclick="post('/save')">Save</button>
  <button onclick="post('/quit')">Quit</button>
 </div>
<script>
 const img = document.getElementById('frame');
 let busy = false;
 async function refresh() {
   if (!busy) {
     busy = true;
     try {
       const r = await fetch('/frame.png?t=' + Date.now());
       const b = await r.blob();
       img.src = URL.createObjectURL(b);
       const s = await (await fetch('/state')).json();
       document.getElementById('stats').textContent =
         'frame ' + s.frame + '  ' + s.ms.toFixed(1) + ' ms' +
         (s.extra ? '\\n' + s.extra : '');
       for (const k of ['camera.x','camera.y','camera.z','camera.wx',
                        'camera.wy','camera.wz','debug','batch',
                        'depth']) {
         const el = document.getElementById(k);
         if (el && document.activeElement !== el && k in s.controls)
           el.value = s.controls[k];
       }
     } catch (e) {}
     busy = false;
   }
   setTimeout(refresh, 250);
 }
 async function post(path, body) {
   await fetch(path, {method:'POST',
                      body: body ? JSON.stringify(body) : ''});
 }
 for (const el of document.querySelectorAll('input'))
   el.addEventListener('change', () =>
     post('/control', {[el.id]: parseFloat(el.value)}));
 refresh();
</script></body></html>"""


class WebViewer:
    """Shared state between the render loop and the HTTP threads."""

    def __init__(self, out_path: str = "viewer_output.png",
                 controls: Optional[Dict] = None):
        self.out_path = out_path
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.frame = 0
        self.ms = 0.0
        self.extra = ""
        self.controls = dict(controls or {})   # echoed to the page
        self.pending: Dict = {}
        self.quit = False
        self.save_req = False

    # ---- render-loop side -------------------------------------------
    def publish(self, image: np.ndarray, ms: float, extra: str = ""):
        from PIL import Image as PILImage
        buf = io.BytesIO()
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
        PILImage.fromarray(arr).save(buf, format="PNG")
        with self.lock:
            self.png = buf.getvalue()
            self.frame += 1
            self.ms = ms
            self.extra = extra

    def poll(self) -> Dict:
        """Drain pending control updates (ControlChannel.poll shape:
        `_save` / `_quit` keys plus dotted parameter keys)."""
        with self.lock:
            upd = self.pending
            self.pending = {}
            if self.save_req:
                upd["_save"] = True
                self.save_req = False
            if self.quit:
                upd["_quit"] = True
            self.controls.update(
                {k: v for k, v in upd.items() if not k.startswith("_")})
        return upd

    # ---- HTTP side --------------------------------------------------
    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/frame.png":
                    with viewer.lock:
                        png, fid = viewer.png, viewer.frame
                    self.send_response(200 if png else 503)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("X-Frame-Id", str(fid))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                elif path == "/state":
                    with viewer.lock:
                        body = json.dumps({
                            "frame": viewer.frame, "ms": viewer.ms,
                            "extra": viewer.extra,
                            "controls": viewer.controls,
                        }).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                if self.path == "/control":
                    try:
                        upd = json.loads(raw or b"{}")
                        assert isinstance(upd, dict)
                    except (ValueError, AssertionError):
                        self._send(400, b"bad json")
                        return
                    with viewer.lock:
                        viewer.pending.update(upd)
                    self._send(200, b"ok")
                elif self.path == "/save":
                    with viewer.lock:
                        viewer.save_req = True
                    self._send(200, b"ok")
                elif self.path == "/quit":
                    with viewer.lock:
                        viewer.quit = True
                    self._send(200, b"ok")
                else:
                    self._send(404, b"not found")

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start the HTTP server on a daemon thread; returns the bound
        (host, port)."""
        self.httpd = ThreadingHTTPServer((host, port), self._handler())
        t = threading.Thread(target=self.httpd.serve_forever,
                             daemon=True)
        t.start()
        return self.httpd.server_address

    def shutdown(self):
        if getattr(self, "httpd", None) is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def render_loop_web(callback: Callable, data=None, *, frames: int = 0,
                    out_path: str = "viewer_output.png",
                    host: str = "127.0.0.1", port: int = 0,
                    controls: Optional[Dict] = None,
                    on_change: Optional[Callable] = None,
                    on_start: Optional[Callable] = None,
                    save_every: int = 0):
    """Progressive render loop served to a browser (renderLoop +
    inspector window, reference inspector.cpp:71-283, as one call).

    callback(data) -> [H, W, 4] u8 frame, same contract as
    viewer.render_loop; on_change(updates) mutates bound buffers and
    resets accumulation.  frames=0 loops until POST /quit.
    on_start(addr) runs once with the bound (host, port).
    Returns the last frame."""
    from radiance_tpu.utils import image as image_io

    viewer = WebViewer(out_path=out_path, controls=controls)
    addr = viewer.serve(host, port)
    print(f"web viewer at http://{addr[0]}:{addr[1]}/", flush=True)
    if on_start is not None:
        on_start(addr)

    image = None
    frame = 0
    try:
        while frames == 0 or frame < frames:
            updates = viewer.poll()
            if updates.pop("_quit", None):
                break
            if updates.pop("_save", None) and image is not None:
                d = os.path.dirname(os.path.abspath(out_path))
                p = os.path.join(
                    d, image_io.timestamped_path("output", "png"))
                image_io.write_image(p, image)
                print(f"saved {p}", flush=True)
            if updates and on_change is not None:
                on_change(updates)
            t0 = time.time()
            image = np.asarray(callback(data))
            dt = time.time() - t0
            viewer.publish(image, dt * 1e3)
            if save_every and frame % save_every == 0:
                image_io.write_image(out_path, image)
            frame += 1
    except KeyboardInterrupt:
        print("\nviewer stopped.", flush=True)
    finally:
        viewer.shutdown()
    if image is not None:
        image_io.write_image(out_path, image)
    return image
