"""The PyTorch port's entry module on the CPU, and the surface on a
machine without jax, PIL, imageio or matplotlib (part 4 of the surface's
tests; tests/test_torch_surface.py says why they are split): entry()'s
function equal to JAX entry()'s bit for bit (integer pair, fast mode: the
matcher and a median), dryrun(1) with sharded prediction within 1e-4 of
the single forward, as JAX's, and one subprocess in which those packages
cannot be imported.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from depthestimation_torch import entry
from test_torch_surface import ASSETS, REPO
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


_BLOCKED_SCRIPT = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'PIL', 'imageio', 'matplotlib',
                                  'flax', 'depthestimation_tpu'):
            raise ImportError(name)
sys.meta_path.insert(0, Block())
import numpy as np
from depthestimation_torch.io.input import load_image
from depthestimation_torch.io.png import read_png
from depthestimation_torch.io.synthetic import synthesize_stereo_pair, write_demo_assets
from depthestimation_torch.examples import mono, stereo, stereo_live
from depthestimation_torch.tools import convert_hf_checkpoint, halo_sweep, profile_kernels
from depthestimation_torch import entry
img = load_image(sys.argv[1])
assert img.shape == (480, 640, 3) and img.dtype == np.uint8, img.shape
p = write_demo_assets('demo')
assert np.array_equal(read_png(p['left'])[0], synthesize_stereo_pair()[0])
try:
    load_image('not_a_png.jpg')
    raise SystemExit('a non-PNG file loaded without PIL')
except ImportError as e:
    assert 'PIL' in str(e), e
assert stereo.main(['--device', 'cpu', '--no-viz', '--downscale', '0.2']) == 0
assert 'matplotlib' not in sys.modules and 'PIL' not in sys.modules
"""


@pytest.fixture(scope="module", autouse=True)
def blocked_run(tmp_path_factory):
    """The subprocess of test_surface_runs_without_jax_pil_imageio_or_
    matplotlib, started with the module's first test so that it runs beside
    the others; that test, the module's last, waits for it."""
    cwd = tmp_path_factory.mktemp("blocked")
    (cwd / "not_a_png.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    proc = subprocess.Popen([sys.executable, "-c", _BLOCKED_SCRIPT,
                             os.path.join(ASSETS, "im0.png")],
                            cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, cwd
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---- entry points -----------------------------------------------------------


def test_entry_equals_jax_entry():
    from __graft_entry__ import entry as jax_entry

    jfn, (jl, jr) = jax_entry()
    fn, (left, right) = entry.entry("cpu")
    assert left.device.type == "cpu" and tuple(left.shape) == (270, 480)
    assert np.array_equal(left.numpy(), np.asarray(jl))
    assert np.array_equal(right.numpy(), np.asarray(jr))
    rng = np.random.default_rng(3)
    lsmall = rng.integers(0, 255, (48, 160)).astype(np.float32)
    rsmall = np.roll(lsmall, -5, axis=1)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(lsmall), jnp.asarray(rsmall)))
    got = fn(torch.from_numpy(lsmall), torch.from_numpy(rsmall)).numpy()
    assert got.shape == want.shape == (48, 96)
    assert np.array_equal(got, want)


def test_dryrun_one_rank_in_process():
    running = dist.is_initialized()
    out = entry.dryrun(1, device="cpu")
    assert out["mesh"] == [1, 1, 1] and out["backend"] == "gloo"
    assert np.isfinite(out["loss"]) and out["predict_sharded_err"] < 1e-4
    assert out["stereo_tiles"] == [1, 32, 48] and out["stereo_whole_frames"] == [1, 16, 368]
    assert dist.is_initialized() == running


# ---- the card's machine: no jax, PIL, imageio or matplotlib ------------------


def test_surface_runs_without_jax_pil_imageio_or_matplotlib(blocked_run):
    """The card's machine: import every example, tool and the entry
    module, load the committed PNGs, write the demo assets and run
    examples.stereo on them (its calibrated path), with none of those
    packages importable; a non-PNG file names what is missing."""
    proc, cwd = blocked_run
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, out
    assert "disparity: shape (480, 624)" in out, out
    assert (cwd / "assets" / "calib.txt").exists()
