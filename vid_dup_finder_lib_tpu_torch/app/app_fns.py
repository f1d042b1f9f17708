"""The application pipeline on the port (counterpart of
``vid_dup_finder_lib_tpu/app/app_fns.py``).

Port of ``run_app_inner`` (``vid_dup_finder_app/src/app/app_fns.rs:37-255``):
raise the fd limit -> validate directories -> open the hash cache (autosave
threshold 2000) -> update the cache from the filesystem (batched device
hashing) -> optional match-db load/update/fix/save -> search or
matchdb-display -> text/JSON/thumbnail outputs.  :func:`run_app` takes
the ``device`` that the cache hashes and the search sweeps on; the flag
surface and the output formats are the JAX CLI's.
"""

from __future__ import annotations

import json
import logging
import os
import sys

import torch

from ..cache.filename_pattern import FilenamePattern
from ..cache.hash_cache import VideoHashFilesystemCache
from ..ingest.backend import force_backend
from ..match_group import MatchGroup, TooFewEntries
from ..models.builder import CreationOptions
from ..search import search, search_with_references
from ..utils.device import resolve_device
from ..utils.logging import configure_logs
from ..utils.timers import maybe_torch_trace, phase_timer
from .app_cfg import AppCfg, OutputFormat
from .arg_parse import parse_args
from .match_db import MatchDb
from .search_output import SearchOutput

log = logging.getLogger("vid_dup_finder")

CACHE_SAVE_THRESHOLD = 2000  # app_fns.rs:139-146


class AppError(Exception):
    pass


def run_app(
    argv: list[str] | None = None, device: torch.device | str | None = None
) -> int:
    """CLI entry point on ``device``; returns the process exit code
    (main.rs:32-39).  An unusable ``device`` raises before any work."""
    dev = resolve_device(device)
    try:
        cfg = parse_args(argv)
    except SystemExit as e:
        # argparse exits with an int; expand_args_file raises SystemExit
        # with a message string: print it and exit 2 (argparse's usage code)
        if e.code is None:
            return 0
        if isinstance(e.code, int):
            return e.code
        print(e.code, file=sys.stderr)
        return 2
    except OSError as e:
        # e.g. an unreadable --args-file
        print(f"error: {e}", file=sys.stderr)
        return 2
    configure_logs(cfg.verbosity.value)
    try:
        run_app_inner(cfg, dev)
        return 0
    except AppError as e:
        log.error("%s", e)
        return 1
    except Exception as e:  # noqa: BLE001 - the CLI's last boundary
        log.error("unexpected error: %r", e)
        return 1
    finally:
        if cfg.hash_cfg.decode_backend != "auto":
            force_backend(None)  # embedders may call run_app repeatedly


def _raise_fd_limit() -> None:
    """RLIMIT_NOFILE -> 16384, best effort (app_fns.rs:56-80)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(16384, hard if hard > 0 else 16384)
        if soft < want:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    except Exception:
        pass


def _validate_dirs(cfg: AppCfg) -> None:
    """Candidate/ref/excl paths must exist and not collide
    (app_fns.rs:86-133)."""
    for kind, paths in (
        ("--files", cfg.dir_cfg.cand_dirs),
        ("--with-refs", cfg.dir_cfg.ref_dirs),
    ):
        for p in paths:
            if not os.path.exists(p):
                raise AppError(f"{kind} path does not exist: {p}")
    overlap = set(cfg.dir_cfg.cand_dirs) & set(cfg.dir_cfg.ref_dirs)
    if overlap:
        raise AppError(
            f"paths given in both --files and --with-refs: {sorted(overlap)}"
        )


def _all_files_pattern(cfg: AppCfg) -> FilenamePattern:
    return FilenamePattern.new(
        includes=list(cfg.dir_cfg.cand_dirs) + list(cfg.dir_cfg.ref_dirs),
        excludes=list(cfg.dir_cfg.excl_dirs),
        excl_exts=list(cfg.dir_cfg.excl_exts),
    )


def _cands_pattern(cfg: AppCfg) -> FilenamePattern:
    return FilenamePattern.new(
        includes=list(cfg.dir_cfg.cand_dirs),
        excludes=list(cfg.dir_cfg.excl_dirs) + list(cfg.dir_cfg.ref_dirs),
        excl_exts=list(cfg.dir_cfg.excl_exts),
    )


def _refs_pattern(cfg: AppCfg) -> FilenamePattern:
    return FilenamePattern.new(
        includes=list(cfg.dir_cfg.ref_dirs),
        excludes=list(cfg.dir_cfg.excl_dirs),
        excl_exts=list(cfg.dir_cfg.excl_exts),
    )


def run_app_inner(cfg: AppCfg, device: torch.device) -> None:
    """(app_fns.rs:37-255) on ``device``."""
    _raise_fd_limit()
    _validate_dirs(cfg)

    if cfg.hash_cfg.decode_backend != "auto":
        # pin the decode backend before the cache opens: the metadata
        # sidecar records the active backend as a hash-affecting setting
        force_backend(cfg.hash_cfg.decode_backend)

    opts = CreationOptions(
        skip_forward_amount=cfg.hash_cfg.skip_forward,
        duration=cfg.hash_cfg.duration,
        cropdetect=cfg.hash_cfg.cropdetect,
    )
    with phase_timer("cache_load"):
        cache = VideoHashFilesystemCache(
            cfg.cache_cfg.cache_path,
            save_threshold=CACHE_SAVE_THRESHOLD,
            creation_options=opts,
            device=device,
        )

    if cfg.cache_cfg.update_cache:
        with phase_timer("cache_update"):
            update_hash_cache(cfg, cache)

    match_db = None
    if cfg.matchdb_cfg.db_path:
        match_db = MatchDb.load_or_new(cfg.matchdb_cfg.db_path)
        raw = MatchDb.raw_data_path(cfg.matchdb_cfg.db_path)
        if os.path.isdir(raw):
            match_db.update_from_raw_parts(raw)
        if cfg.matchdb_cfg.fix_moved_files:
            fixed = match_db.fix_moved_files(cache.all_cached_paths())
            log.info("matchdb: re-linked %d moved files", fixed)
        match_db.to_disk()

    if cfg.display_match_db_matches and match_db:
        _print_groups(list(match_db.confirmed_groups()), cfg.output_cfg.text.format)
        return
    if cfg.display_match_db_falsepos and match_db:
        _print_groups(list(match_db.falsepos_groups()), cfg.output_cfg.text.format)
        return
    if cfg.display_match_db_validation_failures and match_db:
        for a, b in match_db.confirmed_and_falsepos_entries():
            print(a)
            print(b)
            print()
        return

    if cfg.cache_cfg.update_cache_only:
        return

    with maybe_torch_trace(), phase_timer("search"):
        search_output = search_disk(cfg, cache, match_db, device)
    do_app_outputs(cfg, search_output, cache)


def update_hash_cache(cfg: AppCfg, cache: VideoHashFilesystemCache) -> int:
    """(app_fns.rs:808-854); returns the number of (re)hashed files."""
    if cfg.cache_cfg.reload_all_vids:
        cache.clear()
    paths = list(_all_files_pattern(cfg).iterate_from_fs())
    rehashed = cache.update_using_fs(paths, reload_errors=cfg.cache_cfg.reload_err_vids)
    pruned = cache.prune_deleted()
    cache.save()
    log.info(
        "cache update: %d files seen, %d (re)hashed, %d pruned",
        len(paths), rehashed, pruned,
    )
    return rehashed


def search_disk(
    cfg: AppCfg,
    cache: VideoHashFilesystemCache,
    match_db: MatchDb | None,
    device: torch.device,
) -> SearchOutput:
    """(app_fns.rs:428-652), searching on ``device``."""
    all_hash_paths = cache.all_cached_paths()
    cands_filter = _cands_pattern(cfg)
    cand_hashes = [cache.fetch(p) for p in all_hash_paths if cands_filter.includes_path(p)]
    refs_filter = _refs_pattern(cfg)
    ref_hashes = (
        [cache.fetch(p) for p in all_hash_paths if refs_filter.includes_path(p)]
        if cfg.dir_cfg.ref_dirs
        else []
    )

    if not cand_hashes:
        log.warning(
            "No files were found at the paths given by --files. "
            "No results will be returned."
        )
    if cfg.dir_cfg.ref_dirs and not ref_hashes:
        log.warning(
            "No reference files were found at the paths given by "
            "--with-refs. No results will be returned."
        )

    if not ref_hashes:
        matchset = search(cand_hashes, cfg.tolerance, device=device)
    else:
        matchset = search_with_references(
            ref_hashes, cand_hashes, cfg.tolerance, device=device
        )

    if cfg.output_cfg.cartesian_product:
        matchset = [g for grp in matchset for g in grp.dup_combinations()]

    filtering_required = match_db is not None and (
        cfg.matchdb_cfg.remove_falsepos or cfg.matchdb_cfg.remove_known_matches
    )
    if filtering_required:
        out = _matchdb_filter(cfg, match_db, matchset)
    else:
        out = SearchOutput(matchset)
    if cfg.show_missed_matches and match_db is not None:
        out = _show_missed_matches(match_db, out)
    return out
def _matchdb_filter(
    cfg: AppCfg, match_db: MatchDb, matchset: list[MatchGroup]
) -> SearchOutput:
    """remove-known-matches regrouping + falsepos filtering
    (app_fns.rs:541-635)."""
    num_pre = len(matchset)
    num_falsepos_removed = 0

    if cfg.matchdb_cfg.remove_known_matches:
        regrouped: list[MatchGroup] = []
        for group in matchset:
            buckets: list[list[str]] = []
            for src_path in group.contained_paths():
                # first bucket NOT fully confirmed with this path
                placed = False
                for bucket in buckets:
                    if not match_db.all_confirmed(bucket, src_path):
                        bucket.append(src_path)
                        placed = True
                        break
                if not placed:
                    buckets.append([src_path])
            for b in buckets:
                try:
                    regrouped.append(MatchGroup.new(b))
                except TooFewEntries:
                    pass
        matchset = regrouped

    if cfg.matchdb_cfg.remove_falsepos:
        filtered: list[MatchGroup] = []
        for group in matchset:
            kept: list[str] = []
            for src_path in group.contained_paths():
                if not kept:
                    kept.append(src_path)
                elif not any(
                    match_db.is_falsepos(g, src_path) for g in kept
                ):
                    kept.append(src_path)
                else:
                    num_falsepos_removed += 1
            try:
                filtered.append(MatchGroup.new(kept))
            except TooFewEntries:
                pass
        matchset = filtered

    out = SearchOutput(matchset)
    num_db_matches = sum(
        len(g.dup_combinations()) for g in match_db.confirmed_groups()
    )
    print(
        f"There were {num_pre} groups pre filtering and {len(out)} groups "
        "after."
    )
    print(
        f"Search failed to find {num_db_matches - num_pre} groups in the "
        "match_db"
    )
    if cfg.matchdb_cfg.remove_falsepos:
        print(f"Removed {num_falsepos_removed} false positive matches.")
    return out


def _show_missed_matches(
    match_db: MatchDb, curr_output: SearchOutput
) -> SearchOutput:
    """Confirmed pairs the search failed to find (app_fns.rs:655-698)."""
    found_pairs = set()
    for g in curr_output.dup_groups():
        for combo in g.dup_combinations():
            paths = sorted(combo.contained_paths())
            found_pairs.add(tuple(paths))
    missed = []
    for g in match_db.confirmed_groups():
        for combo in g.dup_combinations():
            paths = tuple(sorted(combo.contained_paths()))
            if paths not in found_pairs:
                try:
                    missed.append(MatchGroup.new(list(paths)))
                except TooFewEntries:
                    pass
    return SearchOutput(missed)


def _print_groups(groups: list[MatchGroup], fmt: OutputFormat) -> None:
    if fmt is OutputFormat.JSON:
        out = [
            {
                "reference": g.reference,
                "duplicates": list(g.duplicates),
            }
            for g in groups
        ]
        json.dump(out, sys.stdout, indent=2)
        print()
    else:
        for g in groups:
            if g.reference is not None:
                print(g.reference)
            for d in g.duplicates:
                print(d)
            print()


def do_app_outputs(
    cfg: AppCfg, search_output: SearchOutput, cache: VideoHashFilesystemCache
) -> None:
    """(app_fns.rs:258-426)"""
    text = cfg.output_cfg.text
    if text.kind == "unique":
        dup_paths = set(search_output.dup_paths())
        cands_filter = _cands_pattern(cfg)
        cands = {
            p
            for p in cache.all_cached_paths()
            if cands_filter.includes_path(p)
        }
        unique_paths = sorted(cands - dup_paths)
        if text.format is OutputFormat.JSON:
            json.dump(unique_paths, sys.stdout, indent=2)
            print()
        else:
            for p in unique_paths:
                print(p)
    elif text.kind == "dups":
        search_output.sort(text.sorting, cache)
        _print_groups(list(search_output.dup_groups()), text.format)

    thumbs = cfg.output_cfg.thumbs
    if thumbs.thumbs_dir:
        search_output.sort(thumbs.sorting, cache)
        search_output.save_debug_imgs(thumbs.thumbs_dir)

    if cfg.output_cfg.gui.web_port is not None:
        # the reference's optional Slint GUI, re-imagined as a local
        # browser app over the same resolution engine
        from .resolver_web import run_resolver_web

        search_output.sort(cfg.output_cfg.gui.sorting, cache)
        run_resolver_web(
            list(search_output.dup_groups()),
            cache=cache,
            trash_dir=cfg.output_cfg.gui.trash_path,
            port=cfg.output_cfg.gui.web_port,
            max_thumbs=cfg.output_cfg.gui.max_thumbs,
        )
    elif cfg.output_cfg.gui.enabled:
        # ... or as a TTY carousel (--gui-slint maps here)
        from .resolver_tui import run_resolver

        search_output.sort(cfg.output_cfg.gui.sorting, cache)
        run_resolver(
            list(search_output.dup_groups()),
            cache=cache,
            trash_dir=cfg.output_cfg.gui.trash_path,
        )
