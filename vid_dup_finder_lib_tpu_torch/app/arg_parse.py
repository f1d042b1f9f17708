"""Command-line argument parsing.

Flag surface mirrors the reference's clap model (arg_parse.rs:120-496),
including the quirky defaults: ``--tolerance`` defaults to "0.3" (the
library default is 0.35), ``--cropdetect`` defaults to none, and the
extension blacklist default is the reference's literal (arg_parse.rs:183).
``--args-file`` reads arguments from a file after stripping ``#`` comments
and shell-splitting (arg_parse.rs:664-698; the reference vendors a whole
comment-stripping crate for this — here it is a few lines).
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys

from ..definitions import Cropdetect
from .app_cfg import (
    AppCfg,
    CacheCfg,
    DirCfg,
    GuiOutputCfg,
    HashCfg,
    MatchDbCfg,
    OutputCfg,
    OutputFormat,
    ReportVerbosity,
    Sorting,
    TextOutputCfg,
    ThumbOutputCfg,
    default_cache_file,
)

# arg_parse.rs:183 — default extension blacklist, verbatim
DEFAULT_EXCL_EXTS = (
    "png,jpg,bmp,jpeg,txt,text,db,gif,rb,py,mp3,wma,wav,ogg,db,flac,zip,rar,"
    "7z,pdf,htm,html,xls,doc,ppt,odt,ods,docx,xlsx,rtf,log,trashinfo,js,css,"
    "py,rs,aac,txt~,sh,DS_Store,kdenlive,part,webp,srt"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vid-dup-finder",
        description=(
            "Find near-duplicate video files (PyTorch/CUDA rebuild of "
            "vid_dup_finder)."
        ),
    )
    p.add_argument("--files", nargs="+", default=[], metavar="PATH",
                   help="Directories/files to search for duplicates.")
    p.add_argument("--with-refs", nargs="+", default=[], metavar="PATH",
                   help="Reference directories: find files duplicating these.")
    p.add_argument("--exclude", nargs="+", default=[], metavar="PATH",
                   help="Paths to exclude from the search.")
    p.add_argument("--exclude-exts", default=DEFAULT_EXCL_EXTS,
                   metavar="EXTS", help="Comma-separated extension blacklist.")

    p.add_argument("--cache-file", default=None, metavar="FILE",
                   help=f"Hash cache location (default {default_cache_file()}).")
    p.add_argument("--update-cache-only", action="store_true",
                   help="Refresh the hash cache, skip searching.")
    p.add_argument("--no-update-cache", action="store_true",
                   help="Search using only already-cached hashes.")
    p.add_argument("--reload-errs", action="store_true",
                   help="Retry videos whose hashing previously failed.")
    p.add_argument("--reload-all", action="store_true",
                   help="Clear the cache and rehash everything.")

    p.add_argument("--tolerance", default="0.3", metavar="TOL",
                   help="Search tolerance in [0.0, 1.0] (default 0.3).")
    p.add_argument("--cropdetect", default="none",
                   choices=["none", "letterbox", "motion"],
                   help="Letterbox removal before hashing (default none).")
    p.add_argument("--decode-backend", default="auto",
                   choices=["auto", "gstreamer", "ffmpeg", "opencv"],
                   help="Decode backend (runtime equivalent of the "
                        "reference's compile-time gstreamer_backend "
                        "feature switch; default: first available).")
    p.add_argument("--skip-forward", default="15", metavar="SECS",
                   help="Seconds to skip past intros before hashing.")
    p.add_argument("--hash-duration", default="10", metavar="SECS",
                   help="Seconds of content to build the hash from.")

    p.add_argument("--output", default="dups",
                   choices=["dups", "unique", "none"],
                   help="Print duplicate files, unique files, or nothing.")
    p.add_argument("--output-format", default="normal",
                   choices=["normal", "json"])
    p.add_argument("--sort", default="num-matches",
                   choices=[s.value for s in Sorting])
    p.add_argument("--cartesian", action="store_true",
                   help="Expand each group into all its pairs.")
    p.add_argument("--match-thumbnails-dir", default=None, metavar="DIR",
                   help="Write a thumbnail montage per group to DIR.")

    p.add_argument("--matchdb", default=None, metavar="DIR",
                   help="Match database directory.")
    p.add_argument("--matchdb-fix-moved-files", action="store_true")
    p.add_argument("--matchdb-remove-known-matches", action="store_true")
    p.add_argument("--matchdb-remove-falsepos", action="store_true")
    p.add_argument("--matchdb-show-missed-matches", action="store_true")
    p.add_argument("--display-match-db-matches", action="store_true")
    p.add_argument("--display-match-db-falsepos", action="store_true")
    p.add_argument("--display-match-db-validation-failures",
                   action="store_true")

    p.add_argument("--gui-slint", action="store_true",
                   help="(not available in this build; headless resolver "
                        "via vid_dup_finder_lib_tpu_torch.app.resolution_thunk)")
    p.add_argument("--gui-trash-path", default=None, metavar="DIR")
    p.add_argument("--gui-max-thumbs", default=None, type=int)
    p.add_argument("--gui-web", nargs="?", const=8917, default=None,
                   type=int, metavar="PORT",
                   help="Serve the browser-based resolver on PORT "
                        "(default 8917) — this build's windowed front "
                        "end over the same resolution engine.")

    from .. import __version__

    p.add_argument(
        "--version", action="version",
        version=f"vid-dup-finder {__version__}",
    )  # clap crate_version parity (arg_parse.rs:140)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--args-file", default=None, metavar="FILE",
                   help="Read arguments from FILE ('#' comments allowed).")
    return p


def strip_comments(text: str) -> str:
    """Drop '#'-to-end-of-line comments, shell-dialect: a '#' inside
    single or double quotes is literal (the vendored crate's shell
    dialect respected quoting; a naive find('#') corrupted quoted paths
    containing '#')."""
    out_lines = []
    for line in text.splitlines():
        quote: str | None = None
        cut = len(line)
        for i, ch in enumerate(line):
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"":
                quote = ch
            elif ch == "#":
                cut = i
                break
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def expand_args_file(argv: list[str]) -> list[str]:
    """Replace the arg list with the file's contents when --args-file is
    given (arg_parse.rs:664-698)."""
    if "--args-file" not in argv:
        return argv
    i = argv.index("--args-file")
    if i + 1 >= len(argv):
        raise SystemExit("--args-file requires a value")
    path = argv[i + 1]
    with open(path, "r", encoding="utf-8") as f:
        content = strip_comments(f.read())
    try:
        file_args = shlex.split(content)
    except ValueError as e:  # e.g. unbalanced quotes
        raise SystemExit(f"error: malformed --args-file {path}: {e}")
    return argv[:i] + file_args + argv[i + 2 :]


def _abspaths(paths: list[str]) -> tuple[str, ...]:
    # absolutify + canonicalize (arg_parse.rs:700-712)
    return tuple(os.path.realpath(p) for p in paths)


def parse_args(argv: list[str] | None = None) -> AppCfg:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = expand_args_file(argv)
    ns = build_parser().parse_args(argv)

    # numeric flags are string-typed for reference default parity
    # ("0.3"); a bad value must be a clean usage error, not a traceback
    for flag, value in (
        ("--tolerance", ns.tolerance),
        ("--skip-forward", ns.skip_forward),
        ("--hash-duration", ns.hash_duration),
    ):
        try:
            float(value)
        except (TypeError, ValueError):
            raise SystemExit(
                f"error: invalid value {value!r} for {flag}: expected a "
                "number"
            )

    # clap marks the match-db display flags `.requires(MATCH_DB_PATH)`
    # (arg_parse.rs:190,205,220): silently running a full search instead
    # of the requested db display is the wrong surprise
    if not ns.matchdb and (
        ns.display_match_db_matches
        or ns.display_match_db_falsepos
        or ns.display_match_db_validation_failures
    ):
        raise SystemExit(
            "error: --display-match-db-* requires --matchdb"
        )

    verbosity = ReportVerbosity.DEFAULT
    if ns.quiet:
        verbosity = ReportVerbosity.QUIET
    if ns.verbose:
        verbosity = ReportVerbosity.VERBOSE

    sorting = Sorting(ns.sort)
    fmt = OutputFormat(ns.output_format)
    text = TextOutputCfg(
        kind={"dups": "dups", "unique": "unique", "none": "no-output"}[
            ns.output
        ],
        format=fmt,
        sorting=sorting,
    )

    return AppCfg(
        cache_cfg=CacheCfg(
            cache_path=os.path.realpath(ns.cache_file)
            if ns.cache_file
            else default_cache_file(),
            update_cache=not ns.no_update_cache,
            reload_err_vids=ns.reload_errs,
            reload_all_vids=ns.reload_all,
            update_cache_only=ns.update_cache_only,
        ),
        dir_cfg=DirCfg(
            cand_dirs=_abspaths(ns.files),
            ref_dirs=_abspaths(ns.with_refs),
            excl_dirs=_abspaths(ns.exclude),
            excl_exts=tuple(
                e.strip() for e in ns.exclude_exts.split(",") if e.strip()
            ),
        ),
        hash_cfg=HashCfg(
            cropdetect={
                "none": Cropdetect.NONE,
                "letterbox": Cropdetect.LETTERBOX,
                "motion": Cropdetect.MOTION,
            }[ns.cropdetect],
            skip_forward=float(ns.skip_forward),
            duration=float(ns.hash_duration),
            decode_backend=ns.decode_backend,
        ),
        output_cfg=OutputCfg(
            text=text,
            thumbs=ThumbOutputCfg(
                thumbs_dir=os.path.realpath(ns.match_thumbnails_dir)
                if ns.match_thumbnails_dir
                else None,
                sorting=sorting,
            ),
            gui=GuiOutputCfg(
                enabled=ns.gui_slint,
                sorting=sorting,
                trash_path=ns.gui_trash_path,
                max_thumbs=ns.gui_max_thumbs,
                web_port=ns.gui_web,
            ),
            cartesian_product=ns.cartesian,
        ),
        matchdb_cfg=MatchDbCfg(
            db_path=os.path.realpath(ns.matchdb) if ns.matchdb else None,
            fix_moved_files=ns.matchdb_fix_moved_files,
            remove_known_matches=ns.matchdb_remove_known_matches,
            remove_falsepos=ns.matchdb_remove_falsepos,
        ),
        tolerance=float(ns.tolerance),
        verbosity=verbosity,
        display_match_db_matches=ns.display_match_db_matches,
        display_match_db_falsepos=ns.display_match_db_falsepos,
        display_match_db_validation_failures=(
            ns.display_match_db_validation_failures
        ),
        show_missed_matches=ns.matchdb_show_missed_matches,
    )
