"""Browser-based duplicate resolver.

The reference ships an optional Slint desktop GUI for resolving duplicate
groups (``vid_dup_finder/src/app/gui_slint/mod.rs:75-1151``).  This build
re-imagines that surface as a LOCAL WEB APP over the same headless
resolution engine — stdlib ``http.server`` only, one self-contained HTML
page plus a tiny JSON API, no frameworks.  Behaviors mirrored:

* group carousel with wrap-around navigation and jump-to-group
  (``gui_slint/mod.rs`` next/prev/jump callbacks; ``Modulo`` wrap)
* per-entry file details, duration, and on-demand visual-quality stats
  (recompression sizes + Canny edge PNG size, ``lru_cache.rs:443-495``)
* thumbnail strips of <= 3 frames stepped by 8, LRU-cached by
  (path, mtime) and prerendered for the NEXT group in the background
  (``prerender.rs:97-129``, ``lru_cache.rs:28-73``)
* keep-expression entry per group (``resolution_thunk.rs:255-339``:
  ``"1"``, ``"1 as 2"``, ``"1 at 2"``, ``"u1"`` untrash)
* open-in-external-player per entry (``vlc_thread.rs:10-51``)

Thumbnails and player launches are addressed by (group, entry) INDEX —
the server never reads a client-supplied path.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .resolution_thunk import ResolutionThunk
from .resolver_tui import (
    PlayerThread,
    Prerenderer,
    ThumbLruCache,
    quality_stats,
)

THUMB_FRAMES = 3  # <= 3 thumbs per strip (prerender.rs:115)
THUMB_FRAME_STEP = 8  # frames stepped by 8 (prerender.rs:112)
THUMB_HEIGHT = 150  # px, like the montage thumbs (match_group_ext.rs:126)
THUMB_CACHE_SIZE = 50  # lru_cache.rs:31


def _thumb_strip_jpeg(path: str, n_frames: int = THUMB_FRAMES) -> bytes | None:
    """Decode <= n_frames frames (step 8), resize to 150 px height,
    hstack into one strip, JPEG-encode.  None if undecodable."""
    import cv2
    import numpy as np

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        for k in range(n_frames):
            cap.set(cv2.CAP_PROP_POS_FRAMES, k * THUMB_FRAME_STEP)
            ok, img = cap.read()
            if not ok:
                break
            h, w = img.shape[:2]
            scale = THUMB_HEIGHT / max(1, h)
            img = cv2.resize(
                img,
                (max(1, int(w * scale)), THUMB_HEIGHT),
                interpolation=cv2.INTER_AREA,
            )
            frames.append(img)
    finally:
        cap.release()
    if not frames:
        return None
    strip = np.hstack(frames)
    ok, buf = cv2.imencode(".jpg", strip, [cv2.IMWRITE_JPEG_QUALITY, 80])
    return bytes(buf) if ok else None


class ResolverWebApp:
    """State shared by the request handlers: the thunk carousel, thumb
    cache + prerenderer (shared with the TUI front end), player thread,
    and an action log."""

    def __init__(
        self,
        thunks: list[ResolutionThunk],
        player: PlayerThread | None = None,
        max_thumbs: int | None = None,
    ) -> None:
        self.thunks = thunks
        # the TUI's (path, mtime)-keyed LRU, rendering JPEG strips here;
        # --gui-max-thumbs caps the frames per strip
        n_frames = (
            max(1, min(THUMB_FRAMES, max_thumbs))
            if max_thumbs
            else THUMB_FRAMES
        )
        self.thumbs = ThumbLruCache(
            capacity=THUMB_CACHE_SIZE,
            render=lambda p: _thumb_strip_jpeg(p, n_frames),
        )
        self._prerender = Prerenderer(self.thumbs)
        self.player = player or PlayerThread()
        self.lock = threading.Lock()  # resolve actions are serialized
        self.log: list[str] = []

    # -- JSON state ----------------------------------------------------------

    def state(self, gi: int, with_stats: bool) -> dict:
        from ..utils.modulo import wrapping_add  # noqa: F401  (API parity)

        n = len(self.thunks)
        gi = max(0, min(gi, n - 1)) if n else 0
        entries = []
        if n:
            t = self.thunks[gi]
            for i, p in enumerate(t.entries):
                h = t.hashes.get(p)
                info = {
                    "idx": i,
                    "path": p,
                    "exists": os.path.exists(p),
                    "trashed": p in t.trashed,
                    "size_mb": (
                        round(os.path.getsize(p) / 2**20, 2)
                        if os.path.exists(p)
                        else None
                    ),
                    "duration": getattr(h, "duration", None),
                }
                if with_stats and os.path.exists(p):
                    info["stats"] = quality_stats(p)
                entries.append(info)
        md = None
        if n and self.thunks[gi].hashes:
            md = self.thunks[gi].max_distance()
        return {
            "group": gi,
            "n_groups": n,
            "max_distance": md,
            "entries": entries,
            "log": self.log[-20:],
        }

    def prerender_next(self, gi: int) -> None:
        """Render the NEXT group's strips in the background while the
        user looks at this one (prerender.rs behavior; the shared
        Prerenderer tracks in-flight paths so repeated navigation can't
        pile up duplicate decode threads on this 1-core host)."""
        if gi + 1 >= len(self.thunks):
            return
        self._prerender.request(
            [p for p in self.thunks[gi + 1].entries if os.path.exists(p)]
        )

    def resolve(self, gi: int, expr: str) -> tuple[bool, list[str]]:
        with self.lock:
            try:
                actions = self.thunks[gi].resolve(expr)
            except (ValueError, OSError, IndexError) as e:
                self.log.append(f"group {gi + 1}: error: {e}")
                return False, [str(e)]
        for a in actions:
            self.log.append(f"group {gi + 1}: {a}")
        return True, actions


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>vid-dup-finder — resolve duplicates</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#15171a;color:#e8e6e3}
 header{display:flex;gap:.75rem;align-items:baseline;padding:.7rem 1rem;
        background:#1f2227;position:sticky;top:0}
 header h1{font-size:1rem;margin:0;color:#9ecbff}
 button{background:#2d323a;color:#e8e6e3;border:1px solid #444;border-radius:4px;
        padding:.25rem .7rem;cursor:pointer}
 button:hover{background:#3a404a}
 input[type=text]{background:#101214;color:#e8e6e3;border:1px solid #444;
        border-radius:4px;padding:.3rem .5rem}
 #groupno{width:3.5rem}
 main{padding:1rem;max-width:70rem;margin:auto}
 .entry{display:flex;gap:1rem;margin:.6rem 0;padding:.6rem;background:#1c1f24;
        border-radius:6px;align-items:center}
 .entry.trashed{opacity:.45}
 .entry img{border-radius:4px;max-height:150px}
 .meta{font-size:.85rem;line-height:1.5}
 .idx{font-size:1.3rem;color:#9ecbff;min-width:2rem;text-align:center}
 .path{word-break:break-all}
 .stats{color:#9aa3ad}
 #log{font-family:monospace;font-size:.8rem;color:#9aa3ad;white-space:pre-wrap;
      margin-top:1rem;border-top:1px solid #333;padding-top:.5rem}
 #expr{width:18rem}
 .badge{color:#e06c75;font-weight:bold}
</style></head><body>
<header>
 <h1>vid-dup-finder</h1>
 <button onclick="nav(-1)">&#8592; prev</button>
 <button onclick="nav(1)">next &#8594;</button>
 <span>group <input id="groupno" type="text" onchange="jump()"> / <span id="ngroups">?</span></span>
 <span id="dist"></span>
 <input id="expr" type="text" placeholder="keep-expression: 0 | 0 as 1 | u0"
        onkeydown="if(event.key==='Enter')resolve()">
 <button onclick="resolve()">apply</button>
 <label><input id="stats" type="checkbox" onchange="render()"> quality stats</label>
</header>
<main><div id="entries"></div><div id="log"></div></main>
<script>
let gi = 0, state = null;
function esc(s){
  return String(s).replace(/[&<>"']/g, c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
async function render(){
  const s = document.getElementById('stats').checked ? '&stats=1' : '';
  state = await (await fetch(`/api/state?g=${gi}${s}`)).json();
  gi = state.group;
  document.getElementById('groupno').value = gi + 1;
  document.getElementById('ngroups').textContent = state.n_groups;
  document.getElementById('dist').textContent =
    state.max_distance == null ? '' : `max distance ${state.max_distance.toFixed(3)}`;
  const box = document.getElementById('entries');
  box.innerHTML = '';
  for(const e of state.entries){
    const d = document.createElement('div');
    d.className = 'entry' + (e.trashed ? ' trashed' : '');
    d.innerHTML = `<div class="idx">${e.idx}</div>`
      + (e.exists ? `<img loading="lazy" src="/thumb?g=${gi}&e=${e.idx}" alt="">` : '')
      + `<div class="meta"><div class="path">${esc(e.path)}`
      + (e.trashed ? ' <span class="badge">[trashed]</span>' : '')
      + `</div><div>${e.size_mb != null ? e.size_mb + ' MB' : '&lt;gone&gt;'}`
      + (e.duration != null ? ` &middot; ${e.duration}s` : '') + `</div>`
      + (e.stats ? `<div class="stats">${esc(e.stats)}</div>` : '')
      + `<button onclick="openIn(${e.idx})">open in player</button></div>`;
    box.appendChild(d);
  }
  document.getElementById('log').textContent = state.log.join('\\n');
}
function nav(d){ if(!state || !state.n_groups) return;
  gi = ((gi + d) % state.n_groups + state.n_groups) % state.n_groups; render(); }
function jump(){ if(!state || !state.n_groups) return;
  const k = parseInt(document.getElementById('groupno').value); if(k >= 1 && k <= state.n_groups){ gi = k - 1; render(); } }
async function resolve(){
  const expr = document.getElementById('expr').value.trim();
  if(!expr) return;
  await fetch('/api/resolve', {method:'POST', headers:{'Content-Type':'application/json'},
                               body: JSON.stringify({g: gi, expr})});
  document.getElementById('expr').value = '';
  render();
}
async function openIn(e){
  await fetch('/api/open', {method:'POST', headers:{'Content-Type':'application/json'},
                            body: JSON.stringify({g: gi, e})});
  render();
}
document.addEventListener('keydown', ev => {
  if(ev.target.tagName === 'INPUT') return;
  if(ev.key === 'n') nav(1);
  if(ev.key === 'p') nav(-1);
});
render();
</script></body></html>
"""


def _index(val, limit: int) -> int:
    """Parse a non-negative index below ``limit`` (negative values must
    NOT fall through to Python's negative indexing — a request for
    group -1 would act on the LAST group)."""
    i = int(val)
    if not 0 <= i < limit:
        raise IndexError(val)
    return i


class _Handler(BaseHTTPRequestHandler):
    app: ResolverWebApp  # set by the server factory

    def log_message(self, *args) -> None:  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._send(
            code, json.dumps(obj).encode(), "application/json"
        )

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        if url.path == "/":
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/state":
            try:
                gi = int(q.get("g", ["0"])[0])
            except ValueError:
                self._json(400, {"error": "bad group index"})
                return
            st = self.app.state(gi, with_stats="stats" in q)
            self._json(200, st)
            # use the CLAMPED index: raw negative g crashed (or
            # prerendered the wrong group via negative indexing)
            self.app.prerender_next(st["group"])
        elif url.path == "/thumb":
            try:
                t = self.app.thunks[_index(q["g"][0], len(self.app.thunks))]
                path = t.entries[_index(q["e"][0], len(t.entries))]
            except (KeyError, ValueError, IndexError):
                self._json(404, {"error": "no such entry"})
                return
            data = self.app.thumbs.get_or_render(path)
            if data is None:
                self._json(404, {"error": "undecodable"})
            else:
                self._send(200, data, "image/jpeg")
        else:
            self._json(404, {"error": "not found"})

    def _reject_cross_origin(self) -> bool:
        """Mutating endpoints drive file moves/deletes: refuse requests a
        hostile web page could forge.  A cross-origin fetch either sends
        an Origin that is not this server, or (no-cors) cannot set
        Content-Type: application/json — both are rejected."""
        origin = self.headers.get("Origin")
        host = self.headers.get("Host", "")
        if origin is not None and origin != f"http://{host}":
            self._json(403, {"error": "cross-origin request rejected"})
            return True
        ctype = self.headers.get("Content-Type", "")
        if ctype.split(";")[0].strip() != "application/json":
            self._json(403, {"error": "expected application/json"})
            return True
        return False

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if self._reject_cross_origin():
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"error": "bad request body"})
            return
        if url.path == "/api/resolve":
            try:
                gi = _index(body["g"], len(self.app.thunks))
                expr = str(body["expr"])
            except (KeyError, ValueError, IndexError, TypeError):
                self._json(400, {"error": "bad group or expression"})
                return
            ok, actions = self.app.resolve(gi, expr)
            self._json(200 if ok else 400, {"ok": ok, "actions": actions})
        elif url.path == "/api/open":
            try:
                t = self.app.thunks[_index(body["g"], len(self.app.thunks))]
                path = t.entries[_index(body["e"], len(t.entries))]
            except (KeyError, ValueError, IndexError, TypeError):
                self._json(400, {"error": "bad group or entry"})
                return
            self._json(200, {"msg": self.app.player.open(path)})
        else:
            self._json(404, {"error": "not found"})


def start_resolver_web(
    groups,
    cache=None,
    trash_dir: str | None = None,
    host: str = "127.0.0.1",
    port: int = 0,
    max_thumbs: int | None = None,
) -> tuple[ThreadingHTTPServer, ResolverWebApp]:
    """Start the resolver web server on a background thread; returns the
    (server, app) pair — the caller owns shutdown (tests drive this)."""
    thunks = [
        ResolutionThunk.from_matchgroup(g, cache=cache, trash_dir=trash_dir)
        for g in groups
    ]
    app = ResolverWebApp(thunks, max_thumbs=max_thumbs)
    handler = type("BoundHandler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, app


def run_resolver_web(
    groups,
    cache=None,
    trash_dir: str | None = None,
    host: str = "127.0.0.1",
    port: int = 8917,
    max_thumbs: int | None = None,
) -> None:
    """Blocking entry point for the CLI (--gui-web): serve until Ctrl-C."""
    server, app = start_resolver_web(
        groups, cache=cache, trash_dir=trash_dir, host=host, port=port,
        max_thumbs=max_thumbs,
    )
    bound = server.server_address
    print(
        f"resolver web UI: http://{bound[0]}:{bound[1]}/ "
        f"({len(app.thunks)} duplicate groups; Ctrl-C to stop)"
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
