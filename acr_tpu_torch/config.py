"""Typed configuration with reference-compatible flag names.

A copy of ``acr_tpu/config.py`` for the PyTorch port, with ``yaml``
imported only when a YAML file is read. The port imports nothing of the
JAX package, so it carries its own copy; ``tests/test_torch_port_host.py``
holds the field names and defaults equal to the original's, but for the
port's own fields (``PORT_ONLY``). The port
runs a slice of these options: ``acr_tpu_torch.pipeline.infer.check_slice``
raises ``NotImplementedError`` for every value it does not run.

Mirrors the surface of the reference config system (reference:
acr/config.py:19-222) — ~same flag names, same CLI > YAML > default
precedence — but as a plain dataclass instead of a global argparse
namespace mutated via ``exec()``. No import-time parsing, no global
mutable state: a ``Config`` is constructed explicitly and passed down.

YAML overlay semantics (reference: acr/config.py:194-209): values from
the YAML file referenced by ``--configs_yml`` override dataclass
defaults, but any flag explicitly passed on the CLI beats the YAML.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the fields the port has and acr_tpu's Config has not
PORT_ONLY = ("architecture",)


@dataclass
class Config:
    # ------ top-level demo options (reference: acr/config.py:23-41) ------
    tab: str = "ACR"
    configs_yml: str = os.path.join(_REPO_ROOT, "configs", "demo.yml")
    inputs: Optional[str] = None
    output_dir: Optional[str] = None
    interactive_vis: bool = False
    temporal_optimization: bool = False          # -t
    smooth_coeff: float = 4.0
    save_dict_results: bool = False              # -s
    save_visualization_on_img: bool = True       # -v flips to False
    renderer: str = "tpu"                        # tpu | native | none (reference: pyrender/pytorch3d)
    show_items: Tuple[str, ...] = ("mesh",)      # mesh | org_img | pj2d | centermap | j3d
    render_size: int = 512
    cam_id: int = 0
    demo_mode: str = "image"                     # image | video | folder | webcam

    # ------ camera options (reference: acr/config.py:29-30,50) ------
    # camera_model selects the render projection: 'intrinsics' is the
    # pyrender IntrinsicsCamera (reference: renderer_pyrd.py:20-47, the
    # demo default); 'pt3d' mirrors the pytorch3d backend's rule —
    # FoVPerspective(fov=FOV) when perspective_proj else FoVOrthographic
    # (reference: renderer_pt3d.py:74-110); 'fov'/'ortho' force one.
    camera_model: str = "intrinsics"             # intrinsics | pt3d | fov | ortho
    perspective_proj: bool = False
    FOV: float = 22.5
    focal_length: float = 1265.0

    # ------ run options ------
    val_batch_size: int = 1
    input_size: int = 512

    # ------ model settings (reference: acr/config.py:95-101) ------
    model_precision: str = "fp32"                # fp32 | bf16 (reference: fp32/fp16)
    head_block_num: int = 2

    # ------ part / cross-hand settings (reference: acr/config.py:81-89) ------
    offset_mode: str = "concat"                  # offset | replace | concat
    attention_mode: str = "pred-part"            # pred-part | gt-part
    inter_prior: bool = True
    prior_mode: str = "cross"                    # cross | merge | none
    prior_gate_px: float = 32.0                  # center-distance gate (reference: acr/result_parser.py:42-47)

    # ------ center map options (reference: acr/config.py:130-134) ------
    centermap_size: int = 64
    centermap_conf_thresh: float = 0.35
    kernel_sizes: Tuple[int, ...] = (5,)        # [-1] = NMS pool kernel (reference: result_parser.py:219)
    max_hand: int = 4                           # top-K candidate slots per hand (reference: result_parser.py:221-224)

    # ------ checkpoint / assets (reference: acr/config.py:143,173) ------
    model_path: str = os.path.join(_REPO_ROOT, "checkpoints", "wild.npz")
    mano_model_path: str = os.path.join(_REPO_ROOT, "model_data", "mano")

    # ------ mano options (reference: acr/config.py:165-176) ------
    mano_mesh_root_align: bool = True
    Rot_type: str = "6D"                        # 6D (Gram-Schmidt decode) | angular (raw axis-angle, reference: result_parser.py:30-33)
    rot_dim: int = 6
    cam_dim: int = 3
    align_idx: int = 9
    beta_dim: int = 10
    mano_theta_num: int = 16

    # ------ dataset tag: gates the cross-hand prior exactly like the
    # reference (acr/result_parser.py:125-165): inter_prior requires a
    # non-FreiHand dataset; disabling inter_prior requires prior_mode
    # 'none'. Violations raise, mirroring the reference's ValueError.
    dataset: str = "internet"

    # ------ TPU-native additions (no reference equivalent; the
    # reference's DDP flags were dead, acr/config.py:136-138) ------
    mesh_axes: Tuple[str, ...] = ("data",)       # device mesh axis names
    data_parallel: int = 1                       # number of chips to shard batch over
    coordinator: Optional[str] = None            # host:port -> jax.distributed multi-host DP
    num_processes: int = 1                       # processes in the distributed runtime
    process_id: int = 0                          # this process's rank
    use_pallas_mano: str = "auto"                # fused Pallas MANO kernel: auto (batch>=128 on TPU,
                                                 # the measured crossover) | on | off
    s2d_highres: bool = True                     # exact space-to-depth rewrite of HRNet's high-res
                                                 # branch (quarter-lane -> full-lane convs; models/s2d.py)
    s2d_segm: bool = True                        # same rewrite for the segm head's 256px convs
    s2d_stem: bool = True                        # packed uint8 input: avoids the lane-padded
                                                 # 3-channel 512px tensor (2.7% MXU profiled)
    merged_heads: bool = True                    # one dense 512ch transition conv for all 8
                                                 # head stacks instead of 8 half-lane 64ch ones
    quantize: str = "none"                       # 'int8': W8A8 backbone+segm convs (2x MXU,
                                                 # APPROXIMATE — calibrated at load; ops/quant.py);
                                                 # 'int8_pc': per-input-channel activation scales;
                                                 # 'int8_r': also quantizes regressor out/fuse convs;
                                                 # 'int4w': int4 weight grid on the int8 conv (W4A8)
                                                 # (experimental, measured in docs/PERFORMANCE.md)
    jit_translation_solve: bool = True           # closed-form weighted-LS on device (reference: host solvePnPRansac)
    raster_overflow_every: int = 0               # probe binned-raster tile capacity every N rendered
                                                 # frames (0 = off); overflows are logged as warnings
    profile_dir: Optional[str] = None            # torch.profiler Chrome trace, with the acr.* spans

    # ------ port only: not in acr_tpu's Config (PORT_ONLY) ------
    architecture: str = "acr"                    # acr | hamer: ACR's heads, or HaMeR
                                                 # (pipeline/hamer.py) on ACR's detections

    # free-form overflow for YAML keys that aren't first-class fields
    extras: Dict[str, Any] = field(default_factory=dict)

    # -------------------------------------------------------------
    @property
    def params_num(self) -> int:
        """Per-hand parameter-vector width: cam + 6D rots + betas.

        Layout contract (reference: acr/result_parser.py:11-14):
        ``[cam(3) | global_orient(rot_dim) | hand_pose((theta_num-1)*rot_dim) | betas(10)]``.
        """
        return self.cam_dim + self.rot_dim * self.mano_theta_num + self.beta_dim

    @property
    def map_channels(self) -> int:
        """Channels of params/prior maps emitted by the heads (no cam)."""
        return self.params_num - self.cam_dim

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        """Reject configurations the reference also rejects (or cannot
        represent), instead of silently ignoring a flag.

        The raise semantics mirror the reference parser exactly
        (acr/result_parser.py:125-165): ``inter_prior`` with the
        FreiHand (single-hand) dataset raises; disabling ``inter_prior``
        is only valid with ``prior_mode='none'``.
        """
        if self.renderer in ("pyrender", "pytorch3d"):
            # the reference's own renderer values (acr/config.py:37; its
            # demo.yml ships renderer:'pyrender') — remap to the TPU
            # rasterizer with the matching camera model so reference
            # configs stay drop-in: pyrender used IntrinsicsCamera
            # (renderer_pyrd.py:20-47, our 'intrinsics' default),
            # pytorch3d used FoVPerspective/FoVOrthographic
            # (renderer_pt3d.py:74-110, our 'pt3d' rule)
            import logging
            legacy = self.renderer
            if legacy == "pytorch3d" and self.camera_model == "intrinsics":
                self.camera_model = "pt3d"
            self.renderer = "tpu"
            logging.getLogger("acr_tpu_torch").warning(
                "renderer=%r is a reference (GPU-era) backend name; "
                "remapped to the TPU rasterizer (renderer='tpu', "
                "camera_model=%r)", legacy, self.camera_model)
        if self.renderer not in ("tpu", "native", "none"):
            raise ValueError(f"renderer must be tpu|native|none "
                             f"(legacy pyrender|pytorch3d are remapped), "
                             f"got {self.renderer!r}")
        if self.camera_model not in ("intrinsics", "pt3d", "fov", "ortho"):
            raise ValueError(f"camera_model must be intrinsics|pt3d|fov|"
                             f"ortho, got {self.camera_model!r}")
        if self.offset_mode not in ("offset", "replace", "concat"):
            raise ValueError(f"offset_mode must be offset|replace|concat, "
                             f"got {self.offset_mode!r}")
        if self.quantize not in ("none", "int8", "int8_pc", "int8_r",
                                 "int4w"):
            raise ValueError(f"quantize must be "
                             f"none|int8|int8_pc|int8_r|int4w, "
                             f"got {self.quantize!r}")
        if "pred" not in self.attention_mode:
            # 'gt-part' feeds ground-truth part maps into the attention
            # pooling — a training-time mode (reference: acr/model.py:62
            # emits segms only for 'pred*'); inference has no GT parts.
            raise ValueError(
                f"attention_mode {self.attention_mode!r} is train-only in "
                "the reference (needs GT part maps); inference supports "
                "'pred-part'")
        if self.inter_prior and self.dataset == "FreiHand":
            raise ValueError(
                "inter_prior with dataset='FreiHand' is invalid (single-"
                "hand dataset; reference raises, acr/result_parser.py:161)")
        if not self.inter_prior and self.prior_mode != "none":
            raise ValueError(
                "inter_prior=False requires prior_mode='none' "
                "(reference raises otherwise, acr/result_parser.py:159-165)")
        if self.Rot_type == "6D":
            if self.rot_dim != 6:
                raise ValueError("Rot_type='6D' requires rot_dim=6")
        elif self.Rot_type == "angular":
            if self.rot_dim != 3:
                raise ValueError("Rot_type='angular' requires rot_dim=3")
        else:
            raise ValueError(f"Rot_type must be 6D|angular, "
                             f"got {self.Rot_type!r}")
        if self.architecture not in ("acr", "hamer"):
            raise ValueError(f"architecture must be acr|hamer, "
                             f"got {self.architecture!r}")
        if self.architecture == "hamer" and (
                self.model_precision != "fp32" or self.quantize != "none"
                or self.data_parallel > 1 or not self.jit_translation_solve):
            raise ValueError(
                "architecture='hamer' runs in fp32 on one device with the "
                "device translation: model_precision='fp32', quantize="
                "'none', data_parallel=1, jit_translation_solve=True")
        if not self.kernel_sizes:
            raise ValueError("kernel_sizes must be non-empty (the last "
                             "entry selects the NMS pool kernel)")
        # normalize legacy boolean values for the MANO kernel switch
        if isinstance(self.use_pallas_mano, bool):
            self.use_pallas_mano = "on" if self.use_pallas_mano else "off"
        self.use_pallas_mano = str(self.use_pallas_mano).lower()
        if self.use_pallas_mano in ("true", "1", "yes"):
            self.use_pallas_mano = "on"
        elif self.use_pallas_mano in ("false", "0", "no"):
            self.use_pallas_mano = "off"
        if self.use_pallas_mano not in ("auto", "on", "off"):
            raise ValueError(f"use_pallas_mano must be auto|on|off, "
                             f"got {self.use_pallas_mano!r}")


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}


def _coerce(name: str, value: Any) -> Any:
    """Coerce a YAML/CLI value to the declared field type."""
    ftype = str(_FIELD_TYPES.get(name, ""))
    if value is None:
        return None
    if "bool" in ftype and not isinstance(value, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if "int" in ftype and "Tuple" not in ftype:
        return int(value)
    if "float" in ftype:
        return float(value)
    if "Tuple" in ftype:
        if isinstance(value, (list, tuple)):
            return tuple(value)
        # scalar YAML like `show_items: pj2d` means a 1-tuple, not
        # character-wise iteration
        return (value,)
    return value


def load_yaml_overrides(path: str) -> Dict[str, Any]:
    """Read the ``ARGS:`` section of a reference-style YAML config."""
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return dict(data.get("ARGS", data) or {})


def make_config(yaml_path: Optional[str] = None,
                cli_overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a Config with CLI > YAML > default precedence."""
    cli_overrides = dict(cli_overrides or {})
    cfg_kwargs: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}

    yml = cli_overrides.get("configs_yml", yaml_path)
    explicit = yml is not None
    if yml is None:
        yml = Config.configs_yml          # default demo.yml, like the reference
    if explicit and yml and not os.path.exists(yml):
        # a user-supplied config path that doesn't exist is an error,
        # not a silent fall-back to defaults
        raise FileNotFoundError(f"--configs_yml not found: {yml}")
    if yml and os.path.exists(yml):
        for key, value in load_yaml_overrides(yml).items():
            if key in cli_overrides:   # CLI beats YAML
                continue
            if key in _FIELD_TYPES:
                cfg_kwargs[key] = _coerce(key, value)
            else:
                extras[key] = value

    for key, value in cli_overrides.items():
        if key in _FIELD_TYPES:
            cfg_kwargs[key] = _coerce(key, value)
        else:
            extras[key] = value

    cfg_kwargs["extras"] = extras
    return Config(**cfg_kwargs)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI with reference-compatible flag names, generated from Config."""
    p = argparse.ArgumentParser(
        description="acr_tpu_torch: arbitrary two-hand 3D reconstruction (PyTorch)")
    short = {"temporal_optimization": "-t", "save_dict_results": "-s",
             "save_visualization_on_img": "-v"}
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name == "extras":
            continue
        flag = "--{}".format(f.name)
        names = [short[f.name], flag] if f.name in short else [flag]
        ftype = str(f.type)
        default_val = getattr(defaults, f.name)
        if "bool" in ftype:
            if f.name == "save_visualization_on_img":
                # reference: -v *disables* rendering (store_false, acr/config.py:33)
                p.add_argument(*names, dest=f.name, action="store_false",
                               default=argparse.SUPPRESS)
            elif default_val is True:
                p.add_argument(flag, dest=f.name, type=str,
                               default=argparse.SUPPRESS, metavar="BOOL")
            else:
                p.add_argument(*names, dest=f.name, action="store_true",
                               default=argparse.SUPPRESS)
        elif "Tuple" in ftype:
            elem = str if "str" in ftype else int
            p.add_argument(flag, dest=f.name, type=elem, nargs="+",
                           default=argparse.SUPPRESS)
        else:
            base = float if "float" in ftype else (int if "int" in ftype else str)
            p.add_argument(*names, dest=f.name, type=base,
                           default=argparse.SUPPRESS)
    return p


def parse_args(argv: Optional[List[str]] = None) -> Config:
    """Parse CLI args; unknown flags are warned about and ignored so
    reference-era invocations (train/eval/aug flags, jupyter's -f)
    remain drop-in compatible."""
    ns, unknown = build_arg_parser().parse_known_args(argv)
    if unknown:
        import logging
        logging.getLogger("acr_tpu_torch").warning(
            "ignoring unknown flags: %s", unknown)
    return make_config(cli_overrides=vars(ns))
