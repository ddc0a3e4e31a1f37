"""Items completed in the window over the window's seconds (an item: a
stereo pair, or a frame of a stream)."""


def read(run):
    return len(run.latencies) / run.window_s if run.window_s > 0 else None
