"""Search results container: sorting and artifact outputs.

Port of ``SearchOutput`` (``vid_dup_finder_app/src/app/search_output.rs``):
sort groups by size / max pairwise hash distance / duration (with the
reference's exact u32-complement key construction, :43-79), write
``idx.json`` plus one thumbnail montage per group (:81-150).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from ..match_group import MatchGroup
from .app_cfg import Sorting

U32_MAX = 0xFFFFFFFF


class SearchOutput:
    def __init__(self, dup_groups: list[MatchGroup]) -> None:
        self.groups = list(dup_groups)

    def __len__(self) -> int:
        return len(self.groups)

    def dup_groups(self) -> Iterator[MatchGroup]:
        return iter(self.groups)

    def dup_paths(self) -> Iterator[str]:
        for g in self.groups:
            yield from g.duplicates

    def sort(self, sorting: Sorting, cache) -> None:
        def sort_num_matches(g: MatchGroup) -> int:
            return U32_MAX - len(g)

        def sort_distance(g: MatchGroup) -> int:
            hashes = []
            for p in g.contained_paths():
                try:
                    hashes.append(cache.fetch(p))
                except Exception:
                    hashes.append(None)
            dists = []
            for i in range(len(hashes)):
                for j in range(i + 1, len(hashes)):
                    if hashes[i] is not None and hashes[j] is not None:
                        dists.append(hashes[i].hamming_distance(hashes[j]))
                    else:
                        dists.append(U32_MAX)
            return max(dists) if dists else 0

        def sort_duration(g: MatchGroup) -> int:
            first = next(g.contained_paths(), None)
            if first is None:
                return 0
            try:
                return U32_MAX - cache.fetch(first).duration
            except Exception:
                return U32_MAX // 2

        keyers = {
            Sorting.NUM_MATCHES: sort_num_matches,
            Sorting.REV_NUM_MATCHES: lambda g: U32_MAX - sort_num_matches(g),
            Sorting.DISTANCE: sort_distance,
            Sorting.REV_DISTANCE: lambda g: U32_MAX - sort_distance(g),
            Sorting.DURATION: sort_duration,
            Sorting.REV_DURATION: lambda g: U32_MAX - sort_duration(g),
        }
        self.groups.sort(key=keyers[sorting])

    def save_debug_imgs(self, output_thumbs_dir: str) -> None:
        """idx.json + {i}.jpg montage per group (search_output.rs:81-150)."""
        os.makedirs(output_thumbs_dir, exist_ok=True)
        idx = [
            {"idx": i, "matchset": list(g.contained_paths())}
            for i, g in enumerate(self.groups)
        ]
        with open(
            os.path.join(output_thumbs_dir, "idx.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(idx, f, indent=2)

        from .match_group_ext import group_to_image

        def render(args):
            i, group = args
            out = os.path.join(output_thumbs_dir, f"{i}.jpg")
            try:
                img = group_to_image(group)
                img.save(out, quality=85)
            except Exception as e:  # noqa: BLE001 - parity: warn, don't die
                import logging

                logging.getLogger("write_image").warning(
                    "failed to save output image %s: %r", out, e
                )

        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(render, enumerate(self.groups)))

    def resolution_thunks(self, cache, trash_path=None):
        from .resolution_thunk import ResolutionThunk

        return [
            ResolutionThunk.from_matchgroup(g, cache, trash_path)
            for g in self.groups
        ]
