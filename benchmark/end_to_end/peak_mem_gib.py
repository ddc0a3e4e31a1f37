"""The card memory the run's process reserved at its peak, over set-up
and window (torch.cuda.max_memory_reserved, read as the window closes,
before the check)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
