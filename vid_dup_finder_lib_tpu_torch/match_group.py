"""Groups of duplicate videos returned by searches.

Behavioral port of ``MatchGroup``
(``vid_dup_finder_lib/src/video_hashing/matches/match_group.rs:10-105``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Iterable, Iterator, Optional


class TooFewEntries(ValueError):
    pass


@dataclass(frozen=True)
class MatchGroup:
    reference: Optional[str] = None
    duplicates: tuple[str, ...] = field(default_factory=tuple)

    @staticmethod
    def new(entries: Iterable[str]) -> "MatchGroup":
        """Group without a reference; requires >= 2 members (match_group.rs:21-33)."""
        dups = tuple(entries)
        if len(dups) < 2:
            raise TooFewEntries()
        return MatchGroup(None, dups)

    @staticmethod
    def new_with_reference(reference: str, entries: Iterable[str]) -> "MatchGroup":
        """Group with a reference; requires >= 1 duplicate (match_group.rs:36-47)."""
        dups = tuple(entries)
        if len(dups) < 1:
            raise TooFewEntries()
        return MatchGroup(reference, dups)

    def __len__(self) -> int:
        return len(self.duplicates)

    def contained_paths(self) -> Iterator[str]:
        """Duplicates then the reference, if any (match_group.rs:69-81)."""
        yield from self.duplicates
        if self.reference is not None:
            yield self.reference

    def dup_combinations(self) -> list["MatchGroup"]:
        """Pairwise expansion (match_group.rs:88-105)."""
        if self.reference is not None:
            return [
                MatchGroup.new_with_reference(self.reference, (d,))
                for d in self.duplicates
            ]
        return [MatchGroup.new(pair) for pair in combinations(self.duplicates, 2)]

    def to_json(self) -> dict:
        obj: dict = {"duplicates": list(self.duplicates)}
        if self.reference is not None:
            obj["reference"] = self.reference
        return obj

    @staticmethod
    def from_json(obj: dict) -> "MatchGroup":
        return MatchGroup(obj.get("reference"), tuple(obj["duplicates"]))
