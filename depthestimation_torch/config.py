"""Typed, frozen configuration for the PyTorch stereo depth engine.

A copy of ``depthestimation_tpu/config.py`` (numpy only), kept separate so
the port never imports the JAX package. Capability parity with the
reference's mutable 19-key ``sgbm_params`` dict (reference:
depthlib/stereo_core.py:16-39) plus its validation (stereo_core.py:105-109)
and downscale-rescaling rules (stereo_core.py:111-117), as an immutable
dataclass.

The JAX config's two TPU-only switches (``compute_dtype``, ``use_pallas``)
select between XLA and Pallas there and have no counterpart here; the
CUDA route always runs the hand-written kernels. ``config_from_dict``
accepts and drops them so a JAX config converts directly.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["SGMConfig", "CalibConfig", "parse_calib_file", "config_from_dict",
           "DEFAULT_CONFIG"]

# Aggregation path-topology names. The reference delegates to OpenCV modes
# ('sgbm', 'hh', 'sgbm_3way', 'hh4' — stereo_core.py:55-61); we map them onto
# path counts of our own SGM aggregation. 'hh' = full 8-path two-sweep,
# 'sgbm' = 5-path, 'sgbm_3way' = 3-path, 'hh4' = 4-path.
_MODE_TO_PATHS = {"sgbm": 5, "hh": 8, "sgbm_3way": 3, "hh4": 4}


@dataclass(frozen=True)
class CalibConfig:
    """Full stereo calibration (enables the rectification path).

    Mirrors the calibration subset of the reference's sgbm_params
    (stereo_core.py:30-38) and the Middlebury calib.txt format
    (assets/calib.txt).
    """

    cam_matrix_l: Optional[Tuple[float, ...]] = None  # row-major 3x3
    cam_matrix_r: Optional[Tuple[float, ...]] = None  # row-major 3x3
    image_width: Optional[int] = None
    image_height: Optional[int] = None
    dist_coeff_l: Optional[Tuple[float, ...]] = None  # (k1,k2,p1,p2,k3)
    dist_coeff_r: Optional[Tuple[float, ...]] = None
    rotation: Optional[Tuple[float, ...]] = None  # row-major 3x3, L->R
    translation: Optional[Tuple[float, ...]] = None  # 3-vector, L->R

    def K_l(self) -> np.ndarray:
        return np.asarray(self.cam_matrix_l, dtype=np.float64).reshape(3, 3)

    def K_r(self) -> np.ndarray:
        return np.asarray(self.cam_matrix_r, dtype=np.float64).reshape(3, 3)

    def dist_l(self) -> np.ndarray:
        if self.dist_coeff_l is None:
            return np.zeros(5, dtype=np.float64)
        return np.asarray(self.dist_coeff_l, dtype=np.float64)

    def dist_r(self) -> np.ndarray:
        if self.dist_coeff_r is None:
            return np.zeros(5, dtype=np.float64)
        return np.asarray(self.dist_coeff_r, dtype=np.float64)

    def R(self) -> np.ndarray:
        if self.rotation is None:
            return np.eye(3, dtype=np.float64)
        return np.asarray(self.rotation, dtype=np.float64).reshape(3, 3)

    def T(self, baseline: float) -> np.ndarray:
        # Reference default extrinsics: T=[-baseline, 0, 0], R=I
        # (rectify.py:205-206).
        if self.translation is None:
            return np.array([-baseline, 0.0, 0.0], dtype=np.float64)
        return np.asarray(self.translation, dtype=np.float64).reshape(3)


# The 19 user-visible keys of the reference dict, in its order
# (stereo_core.py:16-39). 'hole_filling' included; calibration keys are
# grouped into `calib` here but remain settable one-by-one through the
# facade for API parity.
_REFERENCE_KEYS = frozenset(
    {
        "min_disp",
        "num_disp",
        "block_size",
        "disp12_max_diff",
        "prefilter_cap",
        "uniqueness_ratio",
        "speckle_window_size",
        "speckle_range",
        "sgbm_mode",
        "focal_length",
        "baseline",
        "doffs",
        "max_depth",
        "cam_matrix_L",
        "cam_matrix_R",
        "image_width",
        "image_height",
        "dist_coeff_L",
        "dist_coeff_R",
        "rotation",
        "translation",
        "hole_filling",
    }
)


@dataclass(frozen=True)
class SGMConfig:
    """Frozen SGM / pipeline configuration.

    Defaults match the reference defaults (stereo_core.py:17-39). P1/P2 are
    derived as in _build_sgbm (stereo_core.py:51-52): P1 = 8*bs^2,
    P2 = 32*bs^2 for single-channel input.
    """

    min_disp: int = 0
    num_disp: int = 128
    block_size: int = 5
    disp12_max_diff: int = 1
    prefilter_cap: int = 31
    uniqueness_ratio: int = 10
    speckle_window_size: int = 50
    speckle_range: int = 2
    sgbm_mode: str = "sgbm_3way"
    focal_length: Optional[float] = None
    baseline: Optional[float] = None
    doffs: float = 0.0
    max_depth: Optional[float] = None
    hole_filling: bool = False
    calib: Optional[CalibConfig] = None
    # Knobs with no reference analogue:
    cost: str = "bt"  # 'bt' (Birchfield-Tomasi, OpenCV-like) or 'census'
    # WLS-style edge-preserving refinement + temporal smoothing (BASELINE
    # north star / config #3; ops/wls.py):
    wls_filter: bool = False
    wls_radius: int = 8
    wls_eps: float = 100.0
    temporal_alpha: float = 0.0  # 0 disables; else EMA weight of the new frame
    temporal_max_change: float = 4.0

    def __post_init__(self):
        if self.num_disp <= 0 or self.num_disp % 16 != 0:
            raise ValueError("num_disp must be a positive multiple of 16")
        if self.block_size < 1 or self.block_size % 2 == 0:
            raise ValueError("block_size must be odd and >= 1")
        if self.sgbm_mode not in _MODE_TO_PATHS:
            raise ValueError(
                f"Invalid sgbm_mode '{self.sgbm_mode}'. "
                f"Valid: {sorted(_MODE_TO_PATHS)}"
            )
        if self.cost not in ("bt", "census"):
            raise ValueError("cost must be 'bt' or 'census'")

    # ---- derived ----
    @property
    def p1(self) -> int:
        return 8 * self.block_size**2

    @property
    def p2(self) -> int:
        return 32 * self.block_size**2

    @property
    def num_paths(self) -> int:
        return _MODE_TO_PATHS[self.sgbm_mode]

    @property
    def invalid_disp(self) -> float:
        # OpenCV marks invalid as minDisparity-1 (after /16 decode); the
        # reference then treats disparity <= 0 as invalid downstream
        # (postprocess.py:55, visualizations.py:41).
        return float(self.min_disp - 1)

    # ---- reference-semantics updates ----
    def updated(self, *, downscale_factor: float = 1.0, **kwargs) -> "SGMConfig":
        """Return a new config with reference configure_sgbm semantics.

        Unknown keys raise ValueError listing valid keys
        (stereo_core.py:105-109). num_disp / focal_length / doffs incoming
        values are scaled by downscale_factor at configure time
        (stereo_core.py:111-117) — scaling happens here, not at use.
        """
        for key in kwargs:
            if key not in _REFERENCE_KEYS and key not in _EXTRA_KEYS:
                raise ValueError(
                    f"Invalid parameter '{key}'. Valid parameters: "
                    f"{sorted(_REFERENCE_KEYS | _EXTRA_KEYS)}"
                )
        kw = dict(kwargs)
        if "num_disp" in kw and kw["num_disp"] is not None:
            # Reference truncates (stereo_core.py:112) which can produce a
            # count OpenCV's own divisible-by-16 rule rejects (280 * 0.5 =
            # 140); round up to the next multiple of 16 instead (Middlebury
            # at 0.5 downscale -> 144).
            scaled = int(kw["num_disp"] * downscale_factor)
            kw["num_disp"] = max(16, -(-scaled // 16) * 16)
        if "focal_length" in kw and kw["focal_length"] is not None:
            kw["focal_length"] = kw["focal_length"] * downscale_factor
        if "doffs" in kw and kw["doffs"] is not None:
            kw["doffs"] = kw["doffs"] * downscale_factor

        calib_kw = {}
        for ref_key, our_key in (
            ("cam_matrix_L", "cam_matrix_l"),
            ("cam_matrix_R", "cam_matrix_r"),
            ("image_width", "image_width"),
            ("image_height", "image_height"),
            ("dist_coeff_L", "dist_coeff_l"),
            ("dist_coeff_R", "dist_coeff_r"),
            ("rotation", "rotation"),
            ("translation", "translation"),
        ):
            if ref_key in kw:
                val = kw.pop(ref_key)
                if val is not None and not isinstance(val, (int, float)):
                    val = tuple(np.asarray(val, dtype=np.float64).flatten().tolist())
                calib_kw[our_key] = val

        new = dataclasses.replace(self, **kw)
        if calib_kw:
            base = new.calib
            merged = dict(
                cam_matrix_l=base.cam_matrix_l if base else None,
                cam_matrix_r=base.cam_matrix_r if base else None,
                image_width=base.image_width if base else None,
                image_height=base.image_height if base else None,
                dist_coeff_l=base.dist_coeff_l if base else None,
                dist_coeff_r=base.dist_coeff_r if base else None,
                rotation=base.rotation if base else None,
                translation=base.translation if base else None,
            )
            merged.update(calib_kw)
            # Partial calibration is retained; the rectification path only
            # activates once the full required set is present (mirrors
            # _prepare_rectified's all-present gate, stereo_core.py:138).
            new = dataclasses.replace(new, calib=CalibConfig(**merged))
        return new

    def has_full_calibration(self) -> bool:
        """True when the rectification path is enabled (needs calib matrices,
        image size AND baseline — stereo_core.py:138)."""
        c = self.calib
        return (
            c is not None
            and self.baseline is not None
            and c.cam_matrix_l is not None
            and c.cam_matrix_r is not None
            and c.image_width is not None
            and c.image_height is not None
        )

    def as_reference_dict(self) -> dict:
        """Expose state in the reference's 19-key dict shape
        (get_sgbm_params parity, stereo_core.py:202-210)."""
        c = self.calib

        def mat(t, shape):
            return None if t is None else np.asarray(t, dtype=np.float64).reshape(shape)

        return {
            "min_disp": self.min_disp,
            "num_disp": self.num_disp,
            "block_size": self.block_size,
            "disp12_max_diff": self.disp12_max_diff,
            "prefilter_cap": self.prefilter_cap,
            "uniqueness_ratio": self.uniqueness_ratio,
            "speckle_window_size": self.speckle_window_size,
            "speckle_range": self.speckle_range,
            "sgbm_mode": self.sgbm_mode,
            "focal_length": self.focal_length,
            "baseline": self.baseline,
            "doffs": self.doffs,
            "max_depth": self.max_depth,
            "cam_matrix_L": mat(c.cam_matrix_l, (3, 3)) if c else None,
            "cam_matrix_R": mat(c.cam_matrix_r, (3, 3)) if c else None,
            "image_width": c.image_width if c else None,
            "image_height": c.image_height if c else None,
            "dist_coeff_L": mat(c.dist_coeff_l, (-1,)) if c and c.dist_coeff_l else None,
            "dist_coeff_R": mat(c.dist_coeff_r, (-1,)) if c and c.dist_coeff_r else None,
            "rotation": mat(c.rotation, (3, 3)) if c and c.rotation else None,
            "translation": mat(c.translation, (3,)) if c and c.translation else None,
            "hole_filling": self.hole_filling,
        }


_EXTRA_KEYS = frozenset({
    "cost", "calib",
    "wls_filter", "wls_radius", "wls_eps",
    "temporal_alpha", "temporal_max_change",
})

# Fields of the JAX package's SGMConfig that only choose between its XLA
# and Pallas routes.
_JAX_ONLY_KEYS = frozenset({"compute_dtype", "use_pallas"})

DEFAULT_CONFIG = SGMConfig()


def config_from_dict(d: dict) -> SGMConfig:
    """Build an SGMConfig from a plain dict shaped like
    ``dataclasses.asdict(cfg)`` of either package's config (the ``calib``
    entry a dict or None). The JAX-only route switches are dropped."""
    kw = {k: v for k, v in d.items() if k not in _JAX_ONLY_KEYS}
    calib = kw.pop("calib", None)
    if calib is not None:
        calib = CalibConfig(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in calib.items()
        })
    return SGMConfig(calib=calib, **kw)


_CALIB_MATRIX_RE = re.compile(r"\[(.*?)\]", re.S)


def parse_calib_file(path) -> dict:
    """Parse a Middlebury-format calib.txt (assets/calib.txt shape).

    The reference expects users to hand-copy these numbers into
    configure_sgbm (example_stereo.py:9-12); we parse them. Returns a dict
    with keys usable directly as ``configure_sgbm(**d)`` kwargs plus raw
    entries.
    """
    text = open(path).read()
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip()
        m = _CALIB_MATRIX_RE.search(val)
        if m:
            rows = [r.strip() for r in m.group(1).split(";")]
            mat = np.array([[float(x) for x in r.split()] for r in rows])
            out[key] = mat
        else:
            try:
                out[key] = float(val) if "." in val else int(val)
            except ValueError:
                out[key] = val

    kwargs = {}
    if "cam0" in out:
        kwargs["cam_matrix_L"] = out["cam0"]
        kwargs["focal_length"] = float(out["cam0"][0, 0])
    if "cam1" in out:
        kwargs["cam_matrix_R"] = out["cam1"]
    if "width" in out:
        kwargs["image_width"] = int(out["width"])
    if "height" in out:
        kwargs["image_height"] = int(out["height"])
    if "ndisp" in out:
        kwargs["num_disp"] = int(np.ceil(out["ndisp"] / 16.0) * 16)
    if "doffs" in out:
        kwargs["doffs"] = float(out["doffs"])
    if "baseline" in out:
        # Middlebury baselines are in mm; reference examples divide by 1000
        # (example_stereo.py:24).
        kwargs["baseline"] = float(out["baseline"]) / 1000.0
    out["sgbm_kwargs"] = kwargs
    return out
