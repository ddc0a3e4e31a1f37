"""Host-side image input."""

from .input import load_image, load_stereo_pair  # noqa: F401
