"""Union-find over path groups.

Equivalent of the reference's ``DisjointSet<PathBuf>``
(``vid_dup_finder_app/src/app/disjoint_set.rs:8-164``): groups of paths with
merge-on-insert semantics, removal, and group enumeration.
"""

from __future__ import annotations

from typing import Iterable, Iterator


class DisjointSet:
    def __init__(self) -> None:
        self._group_of: dict[str, int] = {}
        self._groups: dict[int, set[str]] = {}
        self._next_id = 0

    def insert_pair(self, a: str, b: str) -> None:
        ga = self._group_of.get(a)
        gb = self._group_of.get(b)
        if ga is None and gb is None:
            gid = self._next_id
            self._next_id += 1
            self._groups[gid] = {a, b}
            self._group_of[a] = gid
            self._group_of[b] = gid
        elif ga is None:
            self._groups[gb].add(a)
            self._group_of[a] = gb
        elif gb is None:
            self._groups[ga].add(b)
            self._group_of[b] = ga
        elif ga != gb:
            # merge the smaller group into the larger
            if len(self._groups[ga]) < len(self._groups[gb]):
                ga, gb = gb, ga
            for item in self._groups[gb]:
                self._group_of[item] = ga
            self._groups[ga] |= self._groups.pop(gb)

    def insert_group(self, items: Iterable[str]) -> None:
        items = list(items)
        for other in items[1:]:
            self.insert_pair(items[0], other)

    def contains(self, item: str) -> bool:
        return item in self._group_of

    def same_group(self, a: str, b: str) -> bool:
        ga = self._group_of.get(a)
        return ga is not None and ga == self._group_of.get(b)

    def group_of(self, item: str) -> frozenset[str] | None:
        gid = self._group_of.get(item)
        return frozenset(self._groups[gid]) if gid is not None else None

    def remove(self, item: str) -> bool:
        gid = self._group_of.pop(item, None)
        if gid is None:
            return False
        group = self._groups[gid]
        group.discard(item)
        if len(group) <= 1:
            for leftover in group:
                self._group_of.pop(leftover, None)
            del self._groups[gid]
        return True

    def rename(self, old: str, new: str) -> bool:
        gid = self._group_of.pop(old, None)
        if gid is None:
            return False
        self._groups[gid].discard(old)
        self._groups[gid].add(new)
        self._group_of[new] = gid
        return True

    def groups(self) -> Iterator[frozenset[str]]:
        for group in self._groups.values():
            yield frozenset(group)

    def items(self) -> Iterator[str]:
        return iter(self._group_of.keys())

    def __len__(self) -> int:
        return len(self._groups)

    def __contains__(self, item: str) -> bool:
        return item in self._group_of
