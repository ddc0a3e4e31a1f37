"""Command-line tools, each a module with main(argv=None) -> int:

    python -m depthestimation_torch.tools.convert_hf_checkpoint SNAPSHOT OUT [--verify]
    python -m depthestimation_torch.tools.halo_sweep [H W D]
    python -m depthestimation_torch.tools.profile_kernels
"""
