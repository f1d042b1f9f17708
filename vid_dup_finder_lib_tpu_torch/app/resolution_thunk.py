"""Headless duplicate-resolution engine.

Port of the GUI's ``ResolutionThunk`` (``…/app/resolution_thunk.rs:123-643``)
without the Slint front end: a match group prepared for interactive
resolution, with the reference's keep-expression mini-language:

* ``"1"``          — keep entry 1, trash the others
* ``"1 as 2"``     — keep entry 1 but give it entry 2's filename
* ``"1 at 2"``     — keep entry 1 but place it in entry 2's directory
* ``"1 as 2 at 3"``— combine both
* ``"u1"``         — untrash entry 1

Trashing moves files into a trash directory with sha256 dedup of
already-trashed content, cross-device copy+delete fallback, and
``" (1)"`` name-collision suffixing (:377-643).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from dataclasses import dataclass, field

from ..match_group import MatchGroup

# the reference's six keep-expression patterns (resolution_thunk.rs:
# 256-292): both "as X at Y" orders, zero-or-more spaces around the
# keywords, and untrash STRICTLY alone ("u1 as 2" is unparseable there)
_RE_AS_AT = re.compile(r"^\s*(\d+)\s*as\s*(\d+)\s*at\s*(\d+)\s*$")
_RE_AT_AS = re.compile(r"^\s*(\d+)\s*at\s*(\d+)\s*as\s*(\d+)\s*$")
_RE_AT = re.compile(r"^\s*(\d+)\s*at\s*(\d+)\s*$")
_RE_AS = re.compile(r"^\s*(\d+)\s*as\s*(\d+)\s*$")
_RE_PLAIN = re.compile(r"^\s*(\d+)\s*$")
_RE_UNTRASH = re.compile(r"^\s*u(\d+)\s*$")


def _parse_expression(
    expression: str,
) -> tuple[bool, str, str | None, str | None] | None:
    """-> (untrash, keep, as_idx, at_idx) or None if unparseable."""
    if m := _RE_UNTRASH.match(expression):
        return True, m.group(1), None, None
    if m := _RE_AS_AT.match(expression):
        return False, m.group(1), m.group(2), m.group(3)
    if m := _RE_AT_AS.match(expression):
        return False, m.group(1), m.group(3), m.group(2)
    if m := _RE_AT.match(expression):
        return False, m.group(1), None, m.group(2)
    if m := _RE_AS.match(expression):
        return False, m.group(1), m.group(2), None
    if m := _RE_PLAIN.match(expression):
        return False, m.group(1), None, None
    return None


@dataclass
class ResolutionThunk:
    entries: list[str]  # reference first, then duplicates, sorted (:142-171)
    trash_dir: str | None = None
    hashes: dict[str, object] = field(default_factory=dict)
    trashed: dict[str, str] = field(default_factory=dict)  # orig -> trash loc

    @staticmethod
    def from_matchgroup(
        group: MatchGroup, cache=None, trash_dir: str | None = None
    ) -> "ResolutionThunk":
        entries = []
        if group.reference is not None:
            entries.append(group.reference)
        entries.extend(sorted(group.duplicates))
        t = ResolutionThunk(entries=entries, trash_dir=trash_dir)
        if cache is not None:
            for p in entries:
                try:
                    t.hashes[p] = cache.fetch(p)
                except Exception:
                    pass
        return t

    def max_distance(self) -> float | None:
        """Max pairwise normalized distance (resolution_thunk.rs:176-215)."""
        hs = [self.hashes[p] for p in self.entries if p in self.hashes]
        best = None
        for i in range(len(hs)):
            for j in range(i + 1, len(hs)):
                d = hs[i].normalized_hamming_distance(hs[j])
                best = d if best is None or d > best else best
        return best

    # -- resolution ------------------------------------------------------------

    def resolve(self, expression: str) -> list[str]:
        """Execute a keep-expression; returns a log of actions taken."""
        parsed = _parse_expression(expression)
        if parsed is None:
            raise ValueError(f"unparseable resolution: {expression!r}")
        untrash, keep_s, as_s, at_s = parsed
        keep = int(keep_s)
        self._check_idx(keep)

        if untrash:
            return [self._untrash(self.entries[keep])]

        keep_path = self.entries[keep]
        # validate BEFORE indexing: entries[9] on a 3-entry group must be
        # the ValueError the front ends catch, not an IndexError
        new_name = new_dir = None
        if as_s:
            self._check_idx(int(as_s))
            new_name = os.path.basename(self.entries[int(as_s)])
        if at_s:
            self._check_idx(int(at_s))
            new_dir = os.path.dirname(self.entries[int(at_s)])

        log = []
        # trash everything except the keeper
        for i, p in enumerate(self.entries):
            if i != keep and os.path.exists(p):
                log.append(self._trash(p))

        # then rename/move the keeper if requested
        if new_name or new_dir:
            dst_dir = new_dir or os.path.dirname(keep_path)
            dst_name = new_name or os.path.basename(keep_path)
            dst = _collision_free(os.path.join(dst_dir, dst_name))
            _move_with_exdev_fallback(keep_path, dst)
            self.entries[keep] = dst
            log.append(f"moved {keep_path} -> {dst}")
        return log

    def _check_idx(self, i: int) -> None:
        if not 0 <= i < len(self.entries):
            raise ValueError(f"entry index {i} out of range")

    def _trash(self, path: str) -> str:
        trash_dir = self.trash_dir or os.path.join(
            os.path.dirname(path), ".vdf_trash"
        )
        os.makedirs(trash_dir, exist_ok=True)
        # already-trashed dedup compares ONLY against the same-basename
        # trash target, like the reference (resolution_thunk.rs:500-547's
        # is_already_trashed on get_trash_path) — scanning the whole
        # trash dir re-hashed every trashed file per operation.  Sizes
        # gate the sha256 (different size can never be identical).
        target = os.path.join(trash_dir, os.path.basename(path))
        if (
            os.path.isfile(target)
            and os.path.getsize(target) == os.path.getsize(path)
            and _sha256(target) == _sha256(path)
        ):
            os.unlink(path)
            self.trashed[path] = target
            return f"deleted {path} (identical file already trashed)"
        dst = _collision_free(target)
        _move_with_exdev_fallback(path, dst)
        self.trashed[path] = dst
        return f"trashed {path} -> {dst}"

    def _untrash(self, path: str) -> str:
        src = self.trashed.get(path)
        if not src or not os.path.exists(src):
            raise ValueError(f"no trashed copy of {path}")
        # the original slot may have been reused (e.g. '0 as 1' renamed
        # the keeper onto it): never clobber — restore beside it
        dst = _collision_free(path)
        _move_with_exdev_fallback(src, dst)
        del self.trashed[path]
        if dst != path:
            return f"untrashed {path} -> {dst} (original name taken)"
        return f"untrashed {path}"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 20)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _collision_free(dst: str) -> str:
    """Append " (1)", " (2)", ... before the extension until free."""
    if not os.path.exists(dst):
        return dst
    stem, ext = os.path.splitext(dst)
    i = 1
    while True:
        cand = f"{stem} ({i}){ext}"
        if not os.path.exists(cand):
            return cand
        i += 1


def _move_with_exdev_fallback(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        os.rename(src, dst)
    except OSError:
        shutil.copy2(src, dst)
        os.unlink(src)
