"""Path filtering + parallel directory walking.

Equivalent of the reference's ``FilenamePattern``
(``…/video_hash_filesystem_cache/filename_pattern.rs:13-144``): include
path prefixes, exclude path prefixes, and a case-insensitive extension
blacklist, plus a threaded directory walker streaming matching files.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from queue import Queue
from typing import Iterator


@dataclass(frozen=True)
class FilenamePattern:
    includes: tuple[str, ...] = ()
    excludes: tuple[str, ...] = ()
    excl_exts: tuple[str, ...] = ()  # stored lowercase with leading dot

    @staticmethod
    def new(
        includes: list[str] | tuple[str, ...] = (),
        excludes: list[str] | tuple[str, ...] = (),
        excl_exts: list[str] | tuple[str, ...] = (),
    ) -> "FilenamePattern":
        norm_exts = tuple(
            e.lower() if e.startswith(".") else "." + e.lower()
            for e in excl_exts
        )
        return FilenamePattern(
            tuple(os.path.abspath(p) for p in includes),
            tuple(os.path.abspath(p) for p in excludes),
            norm_exts,
        )

    def includes_path(self, path: str) -> bool:
        path = os.path.abspath(path)
        if self.includes and not any(
            _is_under(path, inc) for inc in self.includes
        ):
            return False
        if any(_is_under(path, exc) for exc in self.excludes):
            return False
        ext = os.path.splitext(path)[1].lower()
        if ext in self.excl_exts:
            return False
        return True

    def iterate_from_fs(self, workers: int = 8) -> Iterator[str]:
        """Walk every include root in parallel, yielding matching files
        (filename_pattern.rs:89-143's walker + bounded channel)."""
        roots = [p for p in self.includes if os.path.exists(p)]
        # overlapping roots (a root nested under another, a file root
        # inside a dir root, or plain duplicates) must not yield — and
        # decode — the same file twice
        seen: set[str] = set()
        for p in roots:
            if os.path.isfile(p) and self.includes_path(p):
                if p not in seen:
                    seen.add(p)
                    yield p
        dir_roots = [p for p in roots if os.path.isdir(p)]
        dir_roots = [
            d
            for d in sorted(set(dir_roots))
            if not any(
                other != d and _is_under(d, other) for other in dir_roots
            )
        ]
        if not dir_roots:
            return

        import queue as queue_mod
        import threading

        q: Queue = Queue(maxsize=4096)
        _SENTINEL = object()
        # abandoned consumer (generator closed / caller broke out):
        # without this flag, workers block forever on the full bounded
        # queue and every early exit leaks the whole walker pool
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def walk_root(root: str) -> None:
            stack = [root]
            while stack and not stop.is_set():
                d = stack.pop()
                try:
                    with os.scandir(d) as it:
                        for entry in it:
                            try:
                                if entry.is_dir(follow_symlinks=False):
                                    if not any(
                                        _is_under(entry.path, e)
                                        for e in self.excludes
                                    ):
                                        stack.append(entry.path)
                                elif entry.is_file(follow_symlinks=False):
                                    if self.includes_path(entry.path):
                                        if not _put(entry.path):
                                            return
                            except OSError:
                                continue
                except OSError:
                    continue

        def run_all() -> None:
            try:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    list(pool.map(walk_root, dir_roots))
            finally:
                _put(_SENTINEL)

        t = threading.Thread(target=run_all, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if item not in seen:  # file roots may overlap dir walks
                    seen.add(item)
                    yield item
            t.join()
        finally:
            stop.set()


def _is_under(path: str, prefix: str) -> bool:
    try:
        return os.path.commonpath([path, prefix]) == prefix
    except ValueError:
        return False
