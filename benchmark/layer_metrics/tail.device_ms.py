"""Device ms a pair of every kernel that is not a hand-written one (the
plain-torch tail: WTA/LR, speckle, post-filters, WLS, depth, grayscale;
copies and fills left out) in the traced stretch; pairs counted by the
K1 launches seen."""

from benchlib import work


def read(view):
    pairs = sum(1 for name, _, _ in view.device_ops
                if work.base_name(name).startswith("cost_volume"))
    if not pairs:
        return None
    ms = sum(b - a for name, a, b in view.device_ops
             if not work.is_hand_written(name) and not work.is_copy(name)) / 1e3
    return ms / pairs
