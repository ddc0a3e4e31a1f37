"""The demo programs, each a module with main(argv=None) -> int:

    python -m depthestimation_torch.examples.stereo [LEFT RIGHT] [--calib FILE]
    python -m depthestimation_torch.examples.stereo_live [LEFT RIGHT]
    python -m depthestimation_torch.examples.mono [IMAGE]

They run on the card unless given --device cpu, and --no-viz skips the
matplotlib windows. Without input files they fall back to the synthetic
demo scene.
"""
