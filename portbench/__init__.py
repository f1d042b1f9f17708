"""The benchmark of ``vid_dup_finder_lib_tpu_torch``: ``portbench/run.py``
runs one cell of ``BENCHMARK.json`` once (see ``portbench/README.md``)."""
