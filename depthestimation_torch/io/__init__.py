"""Host-side I/O: image/video input and the threaded capture stage."""

from .input import load_image, load_stereo_pair, open_capture, stereo_stream  # noqa: F401
from .threaded import ThreadedStereoCapture  # noqa: F401
