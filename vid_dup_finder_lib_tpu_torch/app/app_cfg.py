"""Application configuration tree (app_cfg.rs:14-136)."""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Optional

from ..definitions import Cropdetect


class ReportVerbosity(enum.Enum):
    QUIET = "quiet"
    DEFAULT = "default"
    VERBOSE = "verbose"


class Sorting(enum.Enum):
    NUM_MATCHES = "num-matches"
    REV_NUM_MATCHES = "rev-num-matches"
    DISTANCE = "distance"
    REV_DISTANCE = "rev-distance"
    DURATION = "duration"
    REV_DURATION = "rev-duration"


class OutputFormat(enum.Enum):
    NORMAL = "normal"
    JSON = "json"


@dataclass(frozen=True)
class TextOutputCfg:
    # kind: "no-output" | "dups" | "unique"
    kind: str = "dups"
    format: OutputFormat = OutputFormat.NORMAL
    sorting: Sorting = Sorting.NUM_MATCHES


@dataclass(frozen=True)
class ThumbOutputCfg:
    thumbs_dir: Optional[str] = None
    sorting: Sorting = Sorting.NUM_MATCHES


@dataclass(frozen=True)
class GuiOutputCfg:
    enabled: bool = False
    sorting: Sorting = Sorting.NUM_MATCHES
    trash_path: Optional[str] = None
    max_thumbs: Optional[int] = None
    web_port: Optional[int] = None  # --gui-web: browser front end


@dataclass(frozen=True)
class OutputCfg:
    text: TextOutputCfg = TextOutputCfg()
    thumbs: ThumbOutputCfg = ThumbOutputCfg()
    gui: GuiOutputCfg = GuiOutputCfg()
    cartesian_product: bool = False


@dataclass(frozen=True)
class DirCfg:
    cand_dirs: tuple[str, ...] = ()
    ref_dirs: tuple[str, ...] = ()
    excl_dirs: tuple[str, ...] = ()
    excl_exts: tuple[str, ...] = ()


@dataclass(frozen=True)
class MatchDbCfg:
    db_path: Optional[str] = None
    fix_moved_files: bool = False
    remove_known_matches: bool = False
    remove_falsepos: bool = False


@dataclass(frozen=True)
class CacheCfg:
    cache_path: Optional[str] = None
    update_cache: bool = True
    reload_err_vids: bool = False
    reload_all_vids: bool = False
    update_cache_only: bool = False


@dataclass(frozen=True)
class HashCfg:
    cropdetect: Cropdetect = Cropdetect.NONE  # CLI default (arg_parse.rs:543)
    skip_forward: float = 15.0
    duration: float = 10.0
    # runtime equivalent of the reference's compile-time backend switch
    # (ffmpeg_gst_wrapper/Cargo.toml:13-15); "auto" = first available
    decode_backend: str = "auto"


@dataclass(frozen=True)
class AppCfg:
    cache_cfg: CacheCfg = CacheCfg()
    dir_cfg: DirCfg = DirCfg()
    hash_cfg: HashCfg = HashCfg()
    output_cfg: OutputCfg = OutputCfg()
    matchdb_cfg: MatchDbCfg = MatchDbCfg()
    # NOTE: the CLI default differs from the library default 0.35 on
    # purpose (arg_parse.rs:136 vs definitions.rs:5) — reference parity.
    tolerance: float = 0.3
    verbosity: ReportVerbosity = ReportVerbosity.DEFAULT
    display_match_db_matches: bool = False
    display_match_db_falsepos: bool = False
    display_match_db_validation_failures: bool = False
    show_missed_matches: bool = False


def default_cache_file() -> str:
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(base, "vid_dup_finder", "hash_cache.json")
