"""The PyTorch port's user-facing surface on the CPU, part 1: PNG files
without an imaging package (held to PIL on every byte: integer decoding
on both sides), RectificationCache's host maps (held to the JAX
package's), the dry run's mesh factoring, and two multi-process checks
marked slow.

The surface's tests are split over four files so that the suite's
scheduler, which hands out files with the most tests first, reaches its
slowest file (the interpret-mode Pallas tests, 4 tests) before the heavy
ones here: tests/test_torch_surface.py (PNG, the rectification cache,
the mesh factoring: fast), and test_torch_surface_examples.py,
test_torch_surface_tools.py and test_torch_surface_entry.py (against
JAX, 4 tests or fewer each).
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import depthestimation_tpu as det
from depthestimation_tpu import calib as jcalib
import depthestimation_torch as dt
from depthestimation_torch import calib, entry
from depthestimation_torch.io import png
from depthestimation_torch.io.input import load_image
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


# The other surface files import these.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "stereo_pairs")
# examples/example_stereo.py's defaults.
MIDDLEBURY = dict(num_disp=280, focal_length=3997.684, baseline=193.001 / 1000.0,
                  doffs=131.111, sgbm_mode="sgbm_3way")


# ---- PNG --------------------------------------------------------------------


def _pil_image(mode, h, w, rng):
    if mode == "P":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(64)
    if mode == "P4":  # 5 colors: PIL writes 4-bit indices
        im = Image.fromarray(rng.integers(0, 5, (h, w), dtype=np.uint8), "L").convert("P")
        im.putpalette([int(v) for v in rng.integers(0, 256, 15)])
        return im
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w), dtype=np.uint8) * 255).convert("1")
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # Ramps with noise: PIL's filter choice varies from row to row.
    a = np.cumsum(rng.integers(0, 9, (h, w, ch)), axis=1).astype(np.uint8)
    return Image.fromarray(a[..., 0] if ch == 1 else a, mode)


def _pil_png(mode, h, w, optimize, seed=0):
    buf = io.BytesIO()
    _pil_image(mode, h, w, np.random.default_rng(seed)).save(buf, "PNG", optimize=optimize)
    return buf.getvalue()


def _filter_types(data: bytes) -> set:
    """The row filter bytes of an 8-bit PNG's image data."""
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += n + 12
    w, h, depth, color = header[:4]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    row = (w * ch * depth + 7) // 8 + 1
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)[::row][:h].tolist())


MODES = ["L", "LA", "RGB", "RGBA", "P", "P4", "1"]
SIZES = [(1, 1), (7, 13), (33, 65)]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw", SIZES)
def test_png_reads_pil_files(hw, mode, optimize):
    data = _pil_png(mode, *hw, optimize)
    pixels, info = png.read_png(data)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
        native = np.asarray(im)
    assert np.array_equal(png.to_rgb(pixels, info), want)
    if mode != "1":  # PIL holds 1-bit gray as bool
        assert np.array_equal(pixels, native)


def test_png_cases_cover_every_filter():
    seen = set()
    for hw in SIZES:
        for mode in ("L", "LA", "RGB", "RGBA"):
            for optimize in (False, True):
                seen |= _filter_types(_pil_png(mode, *hw, optimize))
    seen |= _filter_types(open(os.path.join(ASSETS, "im0.png"), "rb").read())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", ["im0.png", "im1.png"])
def test_png_reads_the_committed_assets(name):
    path = os.path.join(ASSETS, name)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    assert np.array_equal(load_image(path), want)


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (17, 29)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_reads_back_in_pil(tmp_path, channels, hw):
    rng = np.random.default_rng(channels)
    a = rng.integers(0, 256, (*hw, channels), dtype=np.uint8)
    a = a[..., 0] if channels == 1 else a
    path = tmp_path / "out.png"
    png.write_png(path, a)
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), a)
    assert _filter_types(path.read_bytes()) == {2}
    assert np.array_equal(png.read_png(path)[0], a)


def _png_bytes(rows_of_passes, w, h, depth, color, interlace):
    """A PNG of the given header whose image data is the given rows,
    each filtered with None."""
    body = b"".join(b"\0" + row.tobytes() for rows in rows_of_passes for row in rows)
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + png._chunk(b"IDAT", zlib.compress(body)) + png._chunk(b"IEND", b""))


# Adam7's passes: (x0, y0, dx, dy).
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2)]


def _png_file(kind):
    """PNG bytes that io/png.py refuses but PIL reads: an interlaced RGB
    image, a 16-bit RGB one and a 16-bit gray one."""
    rng = np.random.default_rng(3)
    h, w = 11, 21
    if kind == "interlaced":
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        passes = [a[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        return _png_bytes([p for p in passes if p.size], w, h, 8, 2, 1)
    if kind == "16-bit RGB":
        return _png_bytes([rng.integers(0, 65536, (h, w * 3)).astype(">u2")], w, h, 16, 2, 0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 300, (h, w)).astype(np.uint16)).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("source", ["path", "file object"])
@pytest.mark.parametrize("kind", ["interlaced", "16-bit RGB", "16-bit gray"])
def test_load_image_falls_back_to_pil(tmp_path, kind, source):
    """A PNG that io/png.py refuses, or a file object, goes to PIL, as
    the JAX package's load_image reads it."""
    from depthestimation_tpu.io.input import load_image as jax_load_image

    data = _png_file(kind)
    with pytest.raises(ValueError):
        png.read_png(data)
    path = tmp_path / "im.png"
    path.write_bytes(data)
    arg = (lambda: str(path)) if source == "path" else (lambda: io.BytesIO(data))
    want = jax_load_image(arg())
    got = load_image(arg())
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_load_image_without_pil_or_imageio(tmp_path, monkeypatch):
    """Without PIL and imageio a PNG that io/png.py refuses raises its
    ValueError, and another source an ImportError."""
    for name in ("PIL", "PIL.Image", "imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, name, None)
    path = tmp_path / "im.png"
    path.write_bytes(_png_file("interlaced"))
    with pytest.raises(ValueError, match="interlaced"):
        load_image(str(path))
    with pytest.raises(ImportError, match="Pillow or imageio"):
        load_image(io.BytesIO(path.read_bytes()))
    ok = tmp_path / "ok.png"
    png.write_png(ok, np.full((3, 5, 3), 7, np.uint8))
    assert np.array_equal(load_image(str(ok)), np.full((3, 5, 3), 7, np.uint8))


def _tampered(kind):
    if kind == "interlaced":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(buf, "PNG")
        data = bytearray(buf.getvalue())
        data[28] = 1  # IHDR interlace byte; fix the CRC so only it is wrong
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        return bytes(data), "interlaced"
    if kind == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8), np.uint16)).save(buf, "PNG")
        return buf.getvalue(), "16-bit"
    data = bytearray(_pil_png("RGB", 7, 13, False))
    data[45] ^= 0xFF  # a byte of the IDAT payload
    return bytes(data), "CRC"


@pytest.mark.parametrize("kind", ["interlaced", "16-bit", "crc"])
def test_png_refuses_what_it_does_not_read(kind):
    data, words = _tampered(kind)
    with pytest.raises(ValueError, match=words):
        png.read_png(data)


@pytest.mark.parametrize("n,shape", [(1, (1, 1, 1)), (2, (1, 2, 1)), (3, (3, 1, 1)),
                                     (4, (1, 2, 2)), (6, (3, 2, 1)), (8, (2, 2, 2))])
def test_dryrun_mesh_shape_as_jax(n, shape):
    """__graft_entry__.py's factoring of n devices into (data, tile, model)."""
    assert entry.mesh_shape(n) == shape



@pytest.mark.slow
def test_dryrun_four_gloo_processes():
    """Repeats tests/test_torch_parallel.py's and test_torch_train.py's
    four-rank coverage (tiles, the disparity split, data x model train
    step) through the entry point; slow under the suite's load."""
    assert entry.dryrun(4, device="cpu") is None


_REPLICA_SCRIPT = """
import sys
import numpy as np
import torch
from depthestimation_torch.models import train
from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.mono import MonoDepthNet
from depthestimation_torch.models.vit import ViTConfig
from depthestimation_torch.parallel import mesh as pm

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
pm.initialize_distributed(store, world, rank, device="cpu")
mesh = pm.make_mesh((1, 1, world), device="cpu")
net = MonoDepthNet(ViTConfig(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
                             num_heads=2, out_layers=(0, 0, 1, 1)),
                   DPTConfig(features=32, reassemble_channels=(16, 16, 32, 32),
                             head_features=16))
local, opt, shardings = train.make_sharded_train_state(net, mesh, (56, 56))
step = train.make_train_step(local, opt, mesh, shardings)
rng = np.random.default_rng(0)
images = rng.uniform(0, 1, (2, 56, 56, 3)).astype(np.float32) + np.float32(1e-3 * rank)
targets = rng.uniform(0.1, 10, (2, 56, 56)).astype(np.float32)
step(images, targets)
np.savez(f"{out}/rank{rank}.npz", **{n: p.detach().numpy() for n, p in local.named_parameters()
                                     if shardings[n] is None})
"""


@pytest.mark.slow
def test_replicated_parameters_stay_equal_across_model_ranks(tmp_path):
    """Two 'model' ranks whose replicated gradients differ (each feeds a
    slightly other batch, as kernels that add with atomics make them
    differ on the card): after a step every replicated parameter is equal
    on both. Four gloo processes take ~200 s under the suite's load, two
    about half: slow."""
    import gloo_launch

    gloo_launch.start(_REPLICA_SCRIPT, tmp_path, world=2).wait()
    a, b = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    assert len(a.files) > 10
    for name in a.files:
        assert np.array_equal(a[name], b[name]), name


# ---- the rectification cache's host maps ------------------------------------


def _rig():
    from test_torch_rectify import rig_kwargs

    return rig_kwargs()


def test_rectification_cache_identity():
    """tests/test_rectification.py:89-97's semantics, and the host maps
    equal to the JAX package's."""
    cache = calib.RectificationCache()
    c = dt.SGMConfig().updated(**_rig()).calib
    m1 = cache.get_maps(c, baseline=0.5)
    assert cache.get_maps(c, baseline=0.5) is m1
    m3 = cache.get_maps(c, baseline=0.6)
    assert m3 is not m1
    cache.clear()
    assert cache.get_maps(c, baseline=0.6) is not m3
    want = jcalib.RectificationCache().get_maps(
        det.SGMConfig().updated(**_rig()).calib, baseline=0.6)
    got = cache.get_maps(c, baseline=0.6)
    assert sorted(got) == sorted(want) == ["map_x_l", "map_x_r", "map_y_l", "map_y_r"]
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


def test_rectification_cache_device_maps_follow_the_entry():
    cache = calib.RectificationCache()
    c = dt.SGMConfig().updated(**_rig()).calib
    mx, my = cache.device_maps(c, 0.5, 1.0, "cpu")
    host = cache.get_maps(c, 0.5)
    assert np.array_equal(mx.numpy(), np.stack([host["map_x_l"], host["map_x_r"]]))
    assert np.array_equal(my.numpy(), np.stack([host["map_y_l"], host["map_y_r"]]))
    assert cache.device_maps(c, 0.5, 1.0, "cpu")[0] is mx
    cache.clear()
    assert cache.device_maps(c, 0.5, 1.0, "cpu")[0] is not mx
    cache.get_maps(c, 0.7)
    assert cache.device_maps(c, 0.7, 1.0, "cpu")[0].shape == mx.shape
