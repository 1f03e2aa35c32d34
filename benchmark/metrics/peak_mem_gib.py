"""The CUDA allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at the window's start), GiB: the headroom that
decides how large a population one program can train."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2.0 ** 30
