"""Match database: human-curated duplicate truth.

Behavioral port of the reference's ``MatchDb``
(``vid_dup_finder_app/src/app/match_db.rs:231-759``):

* ``confirmed``: a union-find of path groups humans confirmed as duplicates,
  with a content digest per path (re-linkable after moves);
* ``falsepos``: a symmetric map of known false-positive pairs;
* persisted under a db directory (JSON here instead of bincode) with
  timestamped ``.bak`` backups on save (:354-465);
* ``fix_moved_files`` re-links moved files by content-digest equality
  (:709-758);
* manual-input ingestion: a directory of resolution files produced by a
  human review pass (:539-688).

The reference's ``confirmed_and_falsepos_entries`` is a ``todo!()`` that
panics (:271-284); here it is implemented (pairs present in both maps), so
``--display-match-db-validation-failures`` actually works.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from itertools import combinations
from typing import Iterable, Iterator

from ..cache.file_content_cache import FileContentCache
from ..match_group import MatchGroup, TooFewEntries
from .disjoint_set import DisjointSet


def _atomic_write_json(path: str, obj) -> None:
    """tmp file + fsync + replace in the target dir (the base_cache save
    discipline): a crash mid-dump must never leave a partial file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".vdf_matchdb_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class MatchDb:
    def __init__(self, db_path: str | os.PathLike) -> None:
        self.db_path = os.fspath(db_path)
        self.confirmed = DisjointSet()
        self.content_hashes: dict[str, str] = {}
        self.falsepos: dict[str, set[str]] = {}
        self.content_cache = FileContentCache(
            os.path.join(self.db_path, "content_cache.json"),
            save_threshold=200,
        )

    # -- paths ---------------------------------------------------------------

    def _confirmed_path(self) -> str:
        return os.path.join(self.db_path, "confirmed.json")

    def _falsepos_path(self) -> str:
        return os.path.join(self.db_path, "falsepos.json")

    @staticmethod
    def exists_on_disk(db_path: str) -> bool:
        return os.path.exists(
            os.path.join(db_path, "confirmed.json")
        ) and os.path.exists(os.path.join(db_path, "falsepos.json"))

    @staticmethod
    def raw_data_path(db_path: str) -> str:
        return os.path.join(db_path, "..", "manual_inputs")

    # -- queries ---------------------------------------------------------------

    def is_confirmed(self, p1: str, p2: str) -> bool:
        return self.confirmed.same_group(p1, p2)

    def all_confirmed(self, paths: Iterable[str], cand_path: str) -> bool:
        return all(self.is_confirmed(p, cand_path) for p in paths)

    def is_falsepos(self, p1: str, p2: str) -> bool:
        return p2 in self.falsepos.get(p1, set()) or p1 in self.falsepos.get(
            p2, set()
        )

    def confirmed_groups(self) -> Iterator[MatchGroup]:
        for group in self.confirmed.groups():
            try:
                yield MatchGroup.new(sorted(group))
            except TooFewEntries:
                pass

    def falsepos_groups(self) -> Iterator[MatchGroup]:
        seen = set()
        for a, others in sorted(self.falsepos.items()):
            for b in sorted(others):
                key = (min(a, b), max(a, b))
                if key not in seen:
                    seen.add(key)
                    yield MatchGroup.new(list(key))

    def confirmed_and_falsepos_entries(self) -> list[tuple[str, str]]:
        """Pairs that are both confirmed-duplicate AND false-positive —
        validation failures.  (Implements match_db.rs:271-284's todo!().)"""
        out = []
        for group in self.confirmed.groups():
            for a, b in combinations(sorted(group), 2):
                if self.is_falsepos(a, b):
                    out.append((a, b))
        return out

    # -- mutation -----------------------------------------------------------------

    def insert_confirmed_pair(self, p1: str, p2: str) -> None:
        self.confirmed.insert_pair(p1, p2)
        for p in (p1, p2):
            if os.path.exists(p) and p not in self.content_hashes:
                try:
                    self.content_hashes[p] = self.content_cache.fetch(p)
                except Exception:
                    pass

    def insert_confirmed_group(self, paths: Iterable[str]) -> None:
        paths = list(paths)
        for other in paths[1:]:
            self.insert_confirmed_pair(paths[0], other)

    def insert_falsepos_pair(self, p1: str, p2: str) -> None:
        self.falsepos.setdefault(p1, set()).add(p2)
        self.falsepos.setdefault(p2, set()).add(p1)

    def remove_deleted_items(self) -> None:
        for p in [p for p in self.confirmed.items() if not os.path.exists(p)]:
            self.confirmed.remove(p)
            self.content_hashes.pop(p, None)
        for p in [p for p in self.falsepos if not os.path.exists(p)]:
            others = self.falsepos.pop(p)
            for o in others:
                self.falsepos.get(o, set()).discard(p)

    def fix_moved_files(self, candidate_paths: Iterable[str]) -> int:
        """Re-link db entries whose file moved, by content-digest equality
        (match_db.rs:709-758)."""
        from ..cache.file_content_cache import canonical_digest

        digest_to_new = {}
        for p in candidate_paths:
            if os.path.exists(p):
                try:
                    digest_to_new[
                        canonical_digest(self.content_cache.fetch(p))
                    ] = p
                except Exception:
                    pass
        fixed = 0
        for old in [
            p for p in self.confirmed.items() if not os.path.exists(p)
        ]:
            digest = self.content_hashes.get(old)
            new = (
                digest_to_new.get(canonical_digest(digest))
                if digest
                else None
            )
            if new and new != old and not self.confirmed.contains(new):
                self.confirmed.rename(old, new)
                self.content_hashes[new] = self.content_hashes.pop(old)
                fixed += 1
        return fixed

    # -- persistence ------------------------------------------------------------------

    def to_disk(self) -> None:
        os.makedirs(self.db_path, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        # .bak by COPY (the good file stays in place), then atomic
        # tmp+fsync+replace writes: the previous scheme moved the good
        # copy away and wrote in place, so a crash mid-dump left the
        # curated db truncated or missing (match_db.rs:354-465 backups)
        for path in (self._confirmed_path(), self._falsepos_path()):
            if os.path.exists(path):
                shutil.copy2(path, f"{path}.{stamp}.bak")
        _atomic_write_json(
            self._confirmed_path(),
            {
                "groups": [sorted(g) for g in self.confirmed.groups()],
                "content_hashes": self.content_hashes,
            },
        )
        _atomic_write_json(
            self._falsepos_path(),
            {k: sorted(v) for k, v in self.falsepos.items()},
        )
        self.content_cache.save()

    @staticmethod
    def from_disk(db_path: str | os.PathLike) -> "MatchDb":
        db = MatchDb(db_path)
        with open(db._confirmed_path(), "r", encoding="utf-8") as f:
            raw = json.load(f)
        for group in raw.get("groups", []):
            db.confirmed.insert_group(group)
        db.content_hashes = dict(raw.get("content_hashes", {}))
        with open(db._falsepos_path(), "r", encoding="utf-8") as f:
            fp = json.load(f)
        db.falsepos = {k: set(v) for k, v in fp.items()}
        return db

    @staticmethod
    def load_or_new(db_path: str | os.PathLike) -> "MatchDb":
        if MatchDb.exists_on_disk(os.fspath(db_path)):
            return MatchDb.from_disk(db_path)
        return MatchDb(db_path)

    # -- manual-input ingestion (match_db.rs:539-688) ---------------------------------

    def update_from_raw_parts(self, manual_inputs_dir: str) -> int:
        """Ingest human resolutions: ``idx.json`` maps an index to the group
        of paths it showed; files named ``<idx>`` under ``confirmed/``,
        ``falsepos/`` or ``unmatch/`` record the human's verdict."""
        idx_path = os.path.join(manual_inputs_dir, "idx.json")
        if not os.path.exists(idx_path):
            return 0
        with open(idx_path, "r", encoding="utf-8") as f:
            entries = json.load(f)
        idx_map = {
            int(e["idx"]): list(e["matchset"]) for e in entries
        }
        ingested = 0
        for verdict in ("confirmed", "falsepos", "unmatch"):
            d = os.path.join(manual_inputs_dir, verdict)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                try:
                    group = idx_map[int(os.path.splitext(name)[0])]
                except (ValueError, KeyError):
                    continue
                if verdict == "confirmed":
                    self.insert_confirmed_group(group)
                elif verdict == "falsepos":
                    for a, b in combinations(group, 2):
                        self.insert_falsepos_pair(a, b)
                else:  # unmatch: forget any confirmed links
                    for p in group:
                        self.confirmed.remove(p)
                ingested += 1
        return ingested
