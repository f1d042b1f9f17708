"""peak_device_gib: ``torch.cuda.max_memory_allocated`` over the window,
after ``reset_peak_memory_stats``, on the fullest card, in GiB."""


def read(run):
    if not run.devices:
        return None
    return run.peak_bytes / 2**30
