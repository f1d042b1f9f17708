"""The application pipeline on the port (counterpart of
``vid_dup_finder_lib_tpu/app/app_fns.py``).

Only the functions that name the cache, the hash or the search are the
port's own: :func:`run_app`, :func:`run_app_inner`,
:func:`update_hash_cache` and :func:`search_disk`, which open the port's
hash cache and search on an explicit ``device``.  Argument parsing, the
match database, the filters and every output are the JAX package's, by
import, so the flag surface and the output formats are the same.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from vid_dup_finder_lib_tpu.app.app_cfg import AppCfg
from vid_dup_finder_lib_tpu.app.app_fns import (
    CACHE_SAVE_THRESHOLD,
    AppError,
    _all_files_pattern,
    _cands_pattern,
    _matchdb_filter,
    _print_groups,
    _raise_fd_limit,
    _refs_pattern,
    _show_missed_matches,
    _validate_dirs,
    do_app_outputs,
)
from vid_dup_finder_lib_tpu.app.arg_parse import parse_args
from vid_dup_finder_lib_tpu.app.match_db import MatchDb
from vid_dup_finder_lib_tpu.app.search_output import SearchOutput
from vid_dup_finder_lib_tpu.utils.logging import configure_logs
from vid_dup_finder_lib_tpu.utils.timers import phase_timer

from ..cache.hash_cache import VideoHashFilesystemCache
from ..ingest import force_backend
from ..models.builder import CreationOptions
from ..search import search, search_with_references
from ..utils.device import resolve_device

log = logging.getLogger("vid_dup_finder")

__all__ = ["AppError", "run_app", "run_app_inner", "search_disk", "update_hash_cache"]


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

    with phase_timer("search"):
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
