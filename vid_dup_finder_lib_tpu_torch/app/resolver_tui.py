"""Interactive terminal duplicate resolver.

The reference ships an optional Slint GUI for resolving duplicate groups
(``vid_dup_finder/src/app/gui_slint/mod.rs:75-186``: show a group's
entries with file details and thumbnails, accept a keep-expression,
advance through groups).  This build re-imagines it as a TTY carousel
over the headless ``ResolutionThunk`` engine — same resolution
semantics (``resolution_thunk.rs:255-339``'s expression language, trash
with sha-dedup and untrash), driveable both interactively and from a
scripted stdin (tests use a pty).

Controls at the prompt:

* ``<expr>``     — a keep-expression (``1``, ``1 as 2``, ``1 at 2``,
                   ``1 as 2 at 3``, ``u1`` to untrash), applied to the
                   current group
* ``n`` / Enter  — next group (skip)
* ``p``          — previous group
* ``t``          — toggle ANSI thumbnails
* ``q``          — quit

Thumbnails render as 256-color half-block art straight in the terminal
(the reference's thumbnail strip, minus a windowing system).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import IO

from .resolution_thunk import ResolutionThunk

THUMB_COLS = 40  # terminal cells per thumbnail
THUMB_ROWS = 12  # text rows (2 pixel rows per cell with half blocks)
THUMB_CACHE_SIZE = 50  # entries, like the GUI's LruCache (lru_cache.rs:31)


class ThumbLruCache:
    """Rendered-thumbnail LRU, keyed by (path, mtime) so an edited file
    re-renders (the GUI's 50-entry LruCache, lru_cache.rs:28-73).

    Generic over the rendered value: the TUI stores ANSI line lists
    (default ``render``), the web resolver JPEG strip bytes.  Failed
    renders are cached as None so a broken file is not re-decoded on
    every view."""

    def __init__(
        self, capacity: int = THUMB_CACHE_SIZE, render=None
    ) -> None:
        self._cap = capacity
        self._render = render if render is not None else _ansi_thumb
        self._d: OrderedDict[tuple[str, int], object] = OrderedDict()
        self._lock = threading.Lock()

    def _key(self, path: str) -> tuple[str, int]:
        try:
            mtime = int(os.stat(path).st_mtime)
        except OSError:
            mtime = -1
        return (path, mtime)

    def get(self, path: str):
        k = self._key(path)
        with self._lock:
            if k in self._d:
                self._d.move_to_end(k)  # promote (lru_cache.rs:49-51)
                return self._d[k]
        return None

    def put(self, path: str, value) -> None:
        k = self._key(path)
        with self._lock:
            self._d[k] = value
            self._d.move_to_end(k)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    def get_or_render(self, path: str):
        k = self._key(path)
        with self._lock:
            if k in self._d:  # membership, not value: None is cached too
                self._d.move_to_end(k)
                return self._d[k]
        try:
            value = self._render(path)
        except Exception:
            value = None
        self.put(path, value)
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class Prerenderer:
    """Background thumbnail prerender of the NEXT group while the user
    looks at the current one (the GUI's prerender worker pool,
    prerender.rs:24-129, sized down to one daemon thread per request)."""

    def __init__(self, cache: ThumbLruCache) -> None:
        self._cache = cache
        self._inflight: set[str] = set()
        self._lock = threading.Lock()

    def request(self, paths: list[str]) -> None:
        todo = []
        with self._lock:
            for p in paths:
                if p not in self._inflight and self._cache.get(p) is None:
                    self._inflight.add(p)
                    todo.append(p)
        if not todo:
            return

        def work() -> None:
            for p in todo:
                try:
                    self._cache.get_or_render(p)
                except Exception:
                    pass
                finally:
                    with self._lock:
                        self._inflight.discard(p)

        threading.Thread(target=work, daemon=True).start()


class PlayerThread:
    """External-player launcher (the GUI's VLC thread,
    vlc_thread.rs:10-51): each open request first kills the previously
    launched player, then spawns the configured command on the path."""

    def __init__(self, player_cmd: str | None = None) -> None:
        self._player = player_cmd or os.environ.get("VDF_PLAYER", "vlc")
        self._proc: subprocess.Popen | None = None
        self._lock = threading.Lock()

    def open(self, path: str) -> str:
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                self._proc.kill()  # vlc_thread.rs:17-27
                self._proc.wait()
            try:
                self._proc = subprocess.Popen(
                    [self._player, path],
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
            except FileNotFoundError:
                return (
                    f"error: player {self._player!r} not found "
                    "(set VDF_PLAYER)"
                )
        return f"opened {path} in {self._player}"


def _ansi_thumb(path: str, cols: int = THUMB_COLS, rows: int = THUMB_ROWS) -> list[str]:
    """One decoded frame -> 256-color half-block art lines."""
    import cv2
    import numpy as np

    cap = cv2.VideoCapture(path)
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if total > 2:
            cap.set(cv2.CAP_PROP_POS_FRAMES, total // 2)
        ok, img = cap.read()
        if not ok:
            return ["<undecodable>"]
    finally:
        cap.release()
    img = cv2.resize(img, (cols, rows * 2), interpolation=cv2.INTER_AREA)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.int32)

    def c256(px) -> int:
        r, g, b = (int(v) * 5 // 255 for v in px)
        return 16 + 36 * r + 6 * g + b

    lines = []
    for y in range(0, rows * 2, 2):
        row = []
        for x in range(cols):
            top, bot = c256(img[y, x]), c256(img[y + 1, x])
            row.append(f"\x1b[38;5;{top}m\x1b[48;5;{bot}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return lines


def _file_details(path: str) -> str:
    try:
        size = os.path.getsize(path)
        mb = size / 2**20
        return f"{mb:7.2f} MB"
    except OSError:
        return "  <gone>"


# visual-quality signal thresholds (canny_thresholds.rs:1-2)
CANNY_MIN = 5.0
CANNY_MAX = 30.0


def quality_stats(path: str) -> str:
    """Per-video visual-quality signals, as the GUI computes per thumb
    (lru_cache.rs:66-73, 443-495): the middle frame's compressed sizes
    under PNG and JPEG plus the PNG size of its Canny edge map (5/30
    thresholds) — recompression size discriminates sharp originals from
    blurry re-encodes of the same content."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if total > 2:
            cap.set(cv2.CAP_PROP_POS_FRAMES, total // 2)
        ok, img = cap.read()
        if not ok:
            return "stats: <undecodable>"
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    ok_p, png = cv2.imencode(".png", img)
    ok_j, jpg = cv2.imencode(".jpg", img)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    edges = cv2.Canny(gray, CANNY_MIN, CANNY_MAX)
    ok_c, canny_png = cv2.imencode(".png", edges)
    parts = [f"{w}x{h}"]
    if ok_p:
        parts.append(f"png {len(png) // 1024} KiB")
    if ok_j:
        parts.append(f"jpg {len(jpg) // 1024} KiB")
    if ok_c:
        parts.append(f"canny {len(canny_png) // 1024} KiB")
    return "stats: " + "  ".join(parts)


@dataclass
class ResolverTui:
    """Carousel over a list of ``ResolutionThunk``s."""

    thunks: list[ResolutionThunk]
    inp: IO[str] = field(default_factory=lambda: sys.stdin)
    out: IO[str] = field(default_factory=lambda: sys.stdout)
    thumbs: bool = False
    stats: bool = False
    cache: object | None = None
    thumb_cache: ThumbLruCache = field(default_factory=ThumbLruCache)
    player: PlayerThread = field(default_factory=PlayerThread)

    def __post_init__(self) -> None:
        self._prerender = Prerenderer(self.thumb_cache)

    def _println(self, s: str = "") -> None:
        self.out.write(s + "\n")

    def _show_group(self, gi: int) -> None:
        t = self.thunks[gi]
        self._println()
        self._println(
            f"=== group {gi + 1}/{len(self.thunks)}"
            + (
                f"  (max distance {t.max_distance():.3f})"
                if t.hashes and t.max_distance() is not None
                else ""
            )
            + " ==="
        )
        for i, p in enumerate(t.entries):
            trashed = "  [trashed]" if p in t.trashed else ""
            dur = ""
            h = t.hashes.get(p)
            if h is not None and hasattr(h, "duration"):
                dur = f"  {h.duration:5d}s"
            self._println(
                f"  [{i}] {_file_details(p)}{dur}  {p}{trashed}"
            )
            if self.stats and os.path.exists(p):
                self._println("        " + quality_stats(p))
            if self.thumbs and os.path.exists(p):
                for line in (
                    self.thumb_cache.get_or_render(p) or ["<undecodable>"]
                ):
                    self._println("        " + line)
        if self.thumbs and gi + 1 < len(self.thunks):
            # render the next group's thumbnails in the background while
            # the user reads this one (prerender.rs behavior)
            self._prerender.request(
                [
                    p
                    for p in self.thunks[gi + 1].entries
                    if os.path.exists(p)
                ]
            )

    def run(self) -> None:
        """Drive the carousel until 'q' or scripted-input EOF.

        Navigation wraps around like the GUI carousel (utils.modulo,
        the reference's Modulo helper)."""
        from ..utils.modulo import wrapping_add, wrapping_sub

        if not self.thunks:
            self._println("no duplicate groups to resolve")
            return
        n_groups = len(self.thunks)
        gi = 0
        while True:
            self._show_group(gi)
            self._println(
                "keep-expr (e.g. '0', '0 as 1', 'u0') | n=next p=prev "
                "g<N>=jump t=thumbs s=stats o<N>=open q=quit"
            )
            self.out.write("> ")
            self.out.flush()
            line = self.inp.readline()
            if not line:  # EOF: scripted input exhausted
                return
            cmd = line.strip()
            if cmd in ("q", "quit"):
                return
            if cmd in ("", "n", "next"):
                gi = wrapping_add(gi, 1, n_groups)
                continue
            if cmd in ("p", "prev"):
                gi = wrapping_sub(gi, 1, n_groups)
                continue
            if cmd.startswith("g") and cmd[1:].strip().isdigit():
                k = int(cmd[1:].strip())
                if 1 <= k <= n_groups:
                    gi = k - 1
                else:
                    self._println(f"error: group {k} out of range")
                continue
            if cmd in ("t", "thumbs"):
                self.thumbs = not self.thumbs
                continue
            if cmd in ("s", "stats"):
                self.stats = not self.stats
                continue
            if cmd.startswith("o") and cmd[1:].strip().isdigit():
                k = int(cmd[1:].strip())
                entries = self.thunks[gi].entries
                if 0 <= k < len(entries):
                    self._println(self.player.open(entries[k]))
                else:
                    self._println(f"error: entry index {k} out of range")
                continue
            try:
                for action in self.thunks[gi].resolve(cmd):
                    self._println(action)
                # stay on the group (like the GUI): the user can still
                # untrash or re-resolve, and advances with 'n'
            except (ValueError, OSError) as e:
                self._println(f"error: {e}")


def run_resolver(
    groups,
    cache=None,
    trash_dir: str | None = None,
    inp: IO[str] | None = None,
    out: IO[str] | None = None,
    thumbs: bool | None = None,
) -> ResolverTui:
    """Build and run the TUI over MatchGroups; returns the TUI (tests
    inspect its thunks afterwards)."""
    thunks = [
        ResolutionThunk.from_matchgroup(g, cache=cache, trash_dir=trash_dir)
        for g in groups
    ]
    tui = ResolverTui(
        thunks=thunks,
        inp=inp if inp is not None else sys.stdin,
        out=out if out is not None else sys.stdout,
        thumbs=(
            thumbs
            if thumbs is not None
            else (out is None and sys.stdout.isatty())
        ),
        cache=cache,
    )
    tui.run()
    return tui
