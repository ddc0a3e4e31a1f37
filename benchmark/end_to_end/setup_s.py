"""Seconds from the start of the run's process (the first line of
benchmark/run.py) to the hand-off of the window's first item: imports,
the card's start, the kernel library (built in the first run of a
checkout), the inputs, and the warm-up that captures the CUDA graphs."""


def read(run):
    return run.setup_s
