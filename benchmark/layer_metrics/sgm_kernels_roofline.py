"""Share of their roofline that the SGM matcher's hand-written kernels (K1
cost_volume, K2 hscan, K3 rowsweep) reach in a pair cell's traced
stretch, in %: the least time of every launch seen (each input byte read
once, each output byte written once, at the card's memory rate;
benchlib/work.py) over the device time of those launches."""

from benchlib import work


def read(view):
    bounds = work.sgm_launch_bounds(view.config)
    least = spent = 0.0
    for name, a, b in view.device_ops:
        base = work.base_name(name)
        if work.is_sgm(base):
            least += next(v for k, v in bounds.items() if base.startswith(k))
            spent += (b - a) / 1e3
    return 100.0 * least / spent if spent > 0 else None
