"""The PyTorch port's monocular depth path on the CPU against the JAX
package on the same inputs: the ViT taps, the DPT head fed the same taps,
the whole net (with JAX's weights carried across by from_flax_params),
the resizes, PIL-free preprocessing, HF weights, the checkpoint and the
MonocularDepthEstimator facade.

The tiny net is tests/test_mono.py's (56 px, hidden 64, two layers). JAX
builds it once per module and runs each forward once per shape: (56, 56)
at the net's own grid, (84, 112) for the upward position-embedding
interpolation and (28, 42) for the downward, antialiased one. Tolerances,
with their reasons:
- taps, head and net: max abs diff <= 1e-4 x the max abs value (float32,
  sums in other orders on two backends; measured ~1e-7-1e-6 relative);
- the weight-matrix resize against jax.image.resize: <= 1e-5 (the same
  float32 weights, contracted in another order);
- _resize_align_corners: <= 1e-6 (the same gather-and-blend arithmetic);
- preprocess_image against PIL's BICUBIC: equal on every pixel (integer
  arithmetic on both sides);
- the tiny HF model against HF's own forward: rel < 0.02, as
  tests/test_convert_hf.py holds JAX (JAX, and so the port, use tanh-GELU
  and a = -0.5 bicubic where HF uses exact GELU and a = -0.75);
- the same weights through JAX's converter: <= 1e-4 x the max abs value;
- the checkpoint round trip: bit-equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import depthestimation_tpu as det
from depthestimation_tpu.models import convert as jconvert
from depthestimation_tpu.models import dpt as jdpt
from depthestimation_tpu.models import mono as jmono
from depthestimation_tpu.models import vit as jvit
import depthestimation_torch as dt
from depthestimation_torch.models import convert, dpt, mono, vit
from depthestimation_torch.ops import color
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
            num_heads=2, out_layers=(0, 0, 1, 1))
TINY_DPT = dict(features=32, reassemble_channels=(16, 16, 32, 32), head_features=16)
SHAPES = [(56, 56), (84, 112), (28, 42)]
REL = 1e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def numpy_params(shapes, seed=0):
    """JAX's parameter tree for `shapes`, filled from a numpy seed (no
    jitted init, which takes ~10 s to compile here): kernels normal with
    1/sqrt(fan-in) scale; biases, cls token and position embedding
    non-zero; LayerNorm and LayerScale near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name in ("scale", "gamma"):
            a = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == "pos_embed":
            a = rng.normal(0, 0.5, s.shape)
        else:
            a = rng.normal(0, 0.1, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's tiny net with numpy-seeded params, and per shape a seeded
    batch with JAX's taps and output from one jitted forward."""
    net = jmono.MonoDepthNet(jvit.ViTConfig(**TINY), jdpt.DPTConfig(**TINY_DPT))
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))
    params = numpy_params(nn.meta.unbox(shapes)["params"])

    @jax.jit
    def forward(p, x):
        return net.apply({"params": p}, x,
                         capture_intermediates=lambda m, _: m.name == "backbone")

    runs = {}
    for i, hw in enumerate(SHAPES):
        x = np.random.default_rng(i).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
        out, state = forward(params, x)
        taps = state["intermediates"]["backbone"]["__call__"][0]
        runs[hw] = (x, jax.tree.map(np.asarray, taps), np.asarray(out))
    return net, params, runs


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    net = mono.MonoDepthNet(vit.ViTConfig(**TINY), dpt.DPTConfig(**TINY_DPT))
    net.load_state_dict(convert.from_flax_params(jax_tiny[1]), strict=True)
    return mono.MonoDepthModel(net=net.eval())


@pytest.mark.parametrize("hw", SHAPES)
def test_vit_taps_match_jax(jax_tiny, port_tiny, hw):
    x, want, _ = jax_tiny[2][hw]
    with torch.no_grad():
        got = port_tiny.net.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for (tok, cls), (jtok, jcls) in zip(got, want):
        assert rel_err(tok, jtok) <= REL
        assert rel_err(cls, jcls) <= REL


@pytest.mark.parametrize("hw", SHAPES)
def test_dpt_head_matches_jax(jax_tiny, port_tiny, hw):
    """The port's head fed JAX's taps against JAX's whole net, whose head
    saw the same taps."""
    _, taps, want = jax_tiny[2][hw]
    taps = [(torch.tensor(t), torch.tensor(c)) for t, c in taps]
    with torch.no_grad():
        got = port_tiny.net.head(taps, (hw[0] // 14, hw[1] // 14), hw)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("hw", SHAPES)
def test_net_matches_jax(jax_tiny, port_tiny, hw):
    x, _, want = jax_tiny[2][hw]
    with torch.no_grad():
        got = port_tiny.net(torch.from_numpy(x))
    assert got.shape == (1, *hw) and (got >= 0).all()
    assert (want > 0).mean() > 0.05  # not a vacuous comparison
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("shape,out", [((4, 4), (6, 8)), ((4, 4), (37, 37)),
                                       ((4, 4), (2, 3)), ((37, 37), (16, 9)),
                                       ((5, 9), (5, 4))])
def test_weight_mat_resize_matches_jax(method, shape, out):
    """Upward and downward (antialiased) along each axis, and an axis
    that keeps its size."""
    x = np.random.default_rng(3).normal(0, 1, (1, *shape, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, *out, 5), method=method))
    got = color.resize(torch.from_numpy(x), {1: out[0], 2: out[1]}, method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out", [((7, 9), (14, 18)), ((37, 37), (518, 518)),
                                       ((9, 12), (5, 7)), ((1, 6), (3, 6))])
def test_resize_align_corners_matches_jax(shape, out):
    x = np.random.default_rng(4).normal(0, 1, (2, *shape, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jdpt._resize_align_corners, static_argnums=1)(x, out))
    got = dpt._resize_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,target", [((60, 80), 56), ((100, 200), 56),
                                          ((40, 60), 56), ((1080, 1920), 518)])
def test_preprocess_equals_pil(shape, target):
    """PIL's BICUBIC, downward (widened support) and upward, without PIL."""
    img = np.random.default_rng(5).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = jmono.preprocess_image(img, target=target, patch=14)
    got = mono.preprocess_image(img, target=target, patch=14)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if shape == (1080, 1920):
        assert want.shape == (518, 924, 3)


# ---- HF weights -------------------------------------------------------------

_MEAN = np.array([0.485, 0.456, 0.406])
_STD = np.array([0.229, 0.224, 0.225])


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """tests/test_convert_hf.py's tiny DepthAnythingForDepthEstimation,
    built locally and saved as safetensors and as a .bin."""
    with pytest.MonkeyPatch.context() as mp:
        # HF's model code imports TensorFlow when it finds it (~5 s here)
        # unless told not to; these tests use torch only.
        mp.setenv("USE_TF", "0")
        transformers = pytest.importorskip("transformers")
    bb = transformers.Dinov2Config(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=256, patch_size=14, image_size=56,
        out_indices=[1, 2, 3, 4], apply_layernorm=True,
        reshape_hidden_states=False, initializer_range=0.06,
    )
    cfg = transformers.DepthAnythingConfig(
        backbone_config=bb, fusion_hidden_size=32, reassemble_hidden_size=64,
        neck_hidden_sizes=[16, 32, 48, 64], head_hidden_size=16,
        initializer_range=0.06,
    )
    torch.manual_seed(0)
    model = transformers.DepthAnythingForDepthEstimation(cfg).eval()
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"hf_tiny_{fmt}")
        model.save_pretrained(str(d), safe_serialization=safe)
        dirs[fmt] = str(d)
    return model, dirs


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_weight_files_read_without_packages(tiny_hf, fmt):
    d = tiny_hf[1][fmt]
    got = convert._load_state_dict(d)
    if fmt == "safetensors":
        from safetensors.torch import load_file

        want = load_file(os.path.join(d, "model.safetensors"))
    else:
        want = torch.load(os.path.join(d, "pytorch_model.bin"), weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("hw", [(56, 56), (84, 112)])
def test_hf_tiny_matches_hf_forward(tiny_hf, hw):
    model, dirs = tiny_hf
    x = np.random.default_rng(0).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    xt = torch.tensor(((x - _MEAN) / _STD).transpose(0, 3, 1, 2).astype(np.float32))
    with torch.no_grad():
        want = model(pixel_values=xt).predicted_depth.numpy()
        got = mono.MonoDepthModel.load(dirs["safetensors"], device="cpu").net(torch.from_numpy(x))
    assert rel_err(got, want) < 0.02


def test_hf_tiny_matches_jax_converter(tiny_hf):
    d = tiny_hf[1]["safetensors"]
    x = np.random.default_rng(1).uniform(0, 1, (1, 84, 112, 3)).astype(np.float32)
    jmodel = jconvert.load_hf_depth_anything(d)
    want = np.asarray(jax.jit(jmodel.net.apply)({"params": jmodel.params}, x))
    port = convert.load_hf_depth_anything(d, device="cpu")
    assert port.net.vit_cfg.out_layers == jmodel.net.vit_cfg.out_layers == (0, 1, 2, 3)
    with torch.no_grad():
        got = port.net(torch.from_numpy(x))
    assert rel_err(got, want) <= REL


# ---- checkpoint, init, facade -----------------------------------------------


def test_checkpoint_roundtrip(port_tiny, tmp_path):
    port_tiny.save(str(tmp_path / "ckpt"), size="tiny")
    back = mono.MonoDepthModel.load(str(tmp_path / "ckpt"), device="cpu")
    assert back.net.vit_cfg == port_tiny.net.vit_cfg
    assert back.net.dpt_cfg == port_tiny.net.dpt_cfg
    want = port_tiny.net.state_dict()
    got = back.net.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    x = torch.rand(1, 56, 84, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(back.net(x), port_tiny.net(x))


def test_create_draws_flax_distributions():
    """Seeded, and each parameter from its Flax initialiser's law."""
    a = mono.MonoDepthModel.create("small", seed=0, image_size=56,
                                  device="cpu").net.state_dict()
    b = mono.MonoDepthModel.create("small", seed=0, image_size=56,
                                  device="cpu").net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["backbone.pos_embed"].shape == (1, 17, 384)
    assert abs(a["backbone.pos_embed"].std().item() - 0.02) < 0.002
    assert not a["backbone.cls_token"].any()
    assert (a["backbone.block_0.ls1.gamma"] == 1).all()
    qkv = a["backbone.block_0.attn.qkv.weight"]  # xavier: |w| <= sqrt(6/(384+1152))
    assert qkv.abs().max() <= (6 / (384 + 1152)) ** 0.5
    assert abs(qkv.std().item() - (2 / (384 + 1152)) ** 0.5) < 1e-3
    conv = a["head.layer_rn_0.weight"]  # lecun normal, truncated at 2 sigma
    std = (1 / (48 * 9)) ** 0.5 / 0.87962566103423978
    assert conv.abs().max() <= 2 * std + 1e-6
    assert abs(conv.std().item() - (1 / (48 * 9)) ** 0.5) < 0.1 * std
    assert not a["head.head_conv1.bias"].any()


@pytest.fixture(scope="module")
def facade_png(jax_tiny, port_tiny, tmp_path_factory):
    """The tiny net as a JAX checkpoint and as the port's, and a PNG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mono_facade")
    net, params, _ = jax_tiny
    jmono.MonoDepthModel(net=net, params=params, _jit_cache={}).save(
        str(root / "jax"), size="tiny")
    port_tiny.save(str(root / "torch"), size="tiny")
    img = np.random.default_rng(6).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    Image.fromarray(img).save(root / "img.png")
    return root


@pytest.fixture(scope="module")
def jax_facade_depths(facade_png):
    """JAX's facade on the PNG at both factors, one facade (one jit
    cache): (48, 64) and (24, 32) both preprocess to 518x686, so JAX
    compiles two shapes, the warm-up's 518x518 and that."""
    est = det.MonocularDepthEstimator(str(facade_png / "jax"), device="cpu")
    out = {}
    for factor in (1.0, 0.5):
        est.downscale_factor = factor
        out[factor] = est.estimate_depth(str(facade_png / "img.png"))
    return out


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_facade_matches_jax(facade_png, jax_facade_depths, factor):
    est = dt.MonocularDepthEstimator(str(facade_png / "torch"), device="cpu",
                                     downscale_factor=factor)
    got = est.estimate_depth(str(facade_png / "img.png"))
    want = jax_facade_depths[factor]
    assert got.shape == want.shape == (518, 686)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert rel_err(got, want) <= REL
    assert est.depth_map is got


def test_facade_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.MonocularDepthEstimator("small")
    with pytest.raises(ValueError):
        dt.MonocularDepthEstimator("", device="cpu")


def test_model_default_device_needs_cuda(monkeypatch, tiny_hf, port_tiny, tmp_path):
    """create, from_configs, load and the HF loader put the net on the
    card by default, and raise without one instead of running on the CPU."""
    port_tiny.save(str(tmp_path / "ckpt"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: mono.MonoDepthModel.create("small"),
             lambda: mono.MonoDepthModel.from_configs(vit.ViTConfig(**TINY),
                                                      dpt.DPTConfig(**TINY_DPT)),
             lambda: mono.MonoDepthModel.load("small"),
             lambda: mono.MonoDepthModel.load(str(tmp_path / "ckpt")),
             lambda: mono.MonoDepthModel.load(tiny_hf[1]["safetensors"]),
             lambda: convert.load_hf_depth_anything(tiny_hf[1]["safetensors"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model = mono.MonoDepthModel.load(str(tmp_path / "ckpt"), device="cpu")
    assert model.device.type == "cpu"
    assert next(model.net.parameters()).device.type == "cpu"


def test_cached_resize_tensors_serve_inference_and_autograd(port_tiny):
    """The weight matrices and PIL taps are built once per shape and
    device; made under inference_mode, they still serve a forward that
    is differentiated later (the position embedding is resized at 84x112)."""
    import copy

    x = torch.rand(1, 84, 112, 3, generator=torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    with torch.inference_mode():
        first = port_tiny.net(x)
        mono.preprocess_image(img)
    hits, taps = color._weight_mat.cache_info().hits, mono._device_taps.cache_info().hits
    with torch.inference_mode():
        assert torch.equal(port_tiny.net(x), first)
        mono.preprocess_image(img)
    assert color._weight_mat.cache_info().hits > hits
    assert mono._device_taps.cache_info().hits == taps + 2
    net = copy.deepcopy(port_tiny.net).train()
    net(x).sum().backward()
    grad = net.backbone.pos_embed.grad
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0


def test_mono_path_needs_no_jax_pil_or_hf_packages(tiny_hf, tmp_path):
    """In a process where jax, PIL, safetensors and transformers cannot be
    imported: load the HF snapshot, save and reload the port's checkpoint,
    and run the facade's array path on it."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'PIL', 'safetensors',\n"
        "                                  'transformers', 'depthestimation_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import depthestimation_torch as dt\n"
        "from depthestimation_torch.models.mono import MonoDepthModel\n"
        f"m = MonoDepthModel.load({tiny_hf[1]['safetensors']!r}, device='cpu')\n"
        f"m.save({str(tmp_path / 'ckpt')!r})\n"
        f"est = dt.MonocularDepthEstimator({str(tmp_path / 'ckpt')!r}, device='cpu')\n"
        "img = np.random.default_rng(0).integers(0, 256, (30, 40, 3), dtype=np.uint8)\n"
        "d = est._estimate_image(img)\n"
        "assert d.shape == (518, 686) and (d >= 0).all(), d.shape\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
