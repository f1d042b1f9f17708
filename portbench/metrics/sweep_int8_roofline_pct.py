"""sweep_int8_roofline_pct: the least time one H100 needs for a search's
sweep (its in-band pairs x the hash's 1000 bits x 2 int8 operations at the peak in
``portbench/peaks.py``), over the device time per search of the program's
own kernels (neither a copy nor PyTorch's), summed over the cards.  The
work comes from the inputs, so it stays right whatever kernels sweep."""

from portbench import peaks


def read(run):
    t = run.trace
    if t is None:
        return None
    kernel_s = sum(t.program_kernel_s.values()) / t.calls
    if kernel_s <= 0:
        return None
    return 100.0 * peaks.sweep_bound_s(run.comps_per_call, run.config["hash_bits"]) / kernel_s
