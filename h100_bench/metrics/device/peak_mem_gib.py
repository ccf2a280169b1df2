"""device.peak_mem_gib: torch.cuda.max_memory_allocated() over the window,
after a reset at its start."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2**30
