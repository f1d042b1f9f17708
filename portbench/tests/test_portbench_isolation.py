"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program: by its sources, and by runs in which those
packages cannot be imported."""

import ast
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vid_dup_finder_lib_tpu"}
PROGRAM = "vid_dup_finder_lib_tpu_torch"
# the yardstick: none of it may load the program
INDEPENDENT = ("reference.py", "library.py", "peaks.py", "timeline.py", "control.py")


def imported_top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_sources_import_no_jax_and_the_yardstick_no_program():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        names = imported_top_names(f)
        assert not names & FORBIDDEN, f
        if f.name in INDEPENDENT:
            assert PROGRAM not in names, f


BLOCK = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # import raises ImportError
sys.path.insert(0, {root!r})
"""


def run_blocked(blocked, body: str):
    code = BLOCK.format(blocked=blocked, root=str(ROOT)) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_a_run_with_jax_and_the_jax_package_unimportable(tmp_path):
    r = run_blocked(sorted(FORBIDDEN), f"""
        import json, time
        from pathlib import Path
        sys.path.insert(0, {str(ROOT / 'portbench/tests')!r})
        from conftest import add_small_cell
        import shutil
        root = Path({str(tmp_path)!r})
        shutil.copy({str(ROOT / 'BENCHMARK.json')!r}, root / 'BENCHMARK.json')
        shutil.copytree({str(ROOT / 'portbench')!r}, root / 'portbench')
        add_small_cell(root)
        from portbench import harness
        line, tail = harness.run_cell(harness.Registry(root), 'small', 5, 0.5, False,
                                      time.perf_counter(), device='cpu', check_chip=False)
        assert line['correct'], line
        assert harness.forbidden_modules() == []
        print('ok')
    """)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_the_reference_runs_with_the_program_unimportable():
    r = run_blocked([PROGRAM], """
        import json
        from portbench import library, reference
        cfg = json.load(open('portbench/configs/library_8m.json'))
        cfg.update(hashes=8000, clusters=30, boundary_pairs=4, edge_pairs=4)
        lib = library.make_library(cfg, 3)
        groups = reference.self_search_groups(lib.packed, lib.durations, lib.paths_bytes, 0.35)
        assert len(groups) == 30 + 4 + 4, len(groups)
        assert not [m for m, v in sys.modules.items() if v is not None and m.split('.')[0] == 'vid_dup_finder_lib_tpu_torch']
        print('ok')
    """)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
