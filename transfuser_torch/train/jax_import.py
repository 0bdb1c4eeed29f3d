"""Weight bridge between the JAX package's variables and the port.

``state_dict_from_jax`` is the exact inverse of the JAX package's
``convert_lidar_centernet_statedict`` (transfuser_tpu/train/torch_import.py)
for every backbone family (transFuser, late_fusion, latentTF,
geometric_fusion) on every trunk (RegNetY, ResNet, ConvNeXt): it takes the
``{'params', 'batch_stats'}`` tree as numpy arrays (no JAX import needed)
and returns a state dict in the reference checkpoint's names, which
``LidarCenterNet.load_state_dict(strict=True)`` accepts. The JAX latentTF
nests its backbone as ``inner``; the reference's (and the port's) names
are flat, so the bridge strips and adds that level.

Conventions: conv kernels HWIO -> OIHW; dense kernels (in, out) ->
(out, in); the GRU's two dense layers -> ``decoder.weight_ih`` /
``weight_hh`` with separate biases; BatchNorm ``scale/bias/mean/var`` ->
``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``);
LayerNorm ``scale/bias`` -> ``weight/bias``.

PointPillars: the JAX ``point_pillar_net/DynamicPointNet_0/{fc,bn}{i}``
map to ``point_pillar_net.point_net.net.{3i,3i+1}``, the names of LAV's
``DynamicPointNet`` (Linear, BatchNorm1d, ReLU in an ``nn.Sequential``)
that the reference's ``point_pillar_net`` wraps. Those names are assumed
from LAV's source: no reference checkpoint with pillars is at hand, and
the JAX package's own converter has no pillar mapping.

The map is linear (transposes only), so it also carries a JAX gradient
tree into the port's names. ``variables_from_state_dict`` is its inverse
(port state dict -> the flax tree, the counterpart of
``convert_lidar_centernet_statedict`` itself): the port's trained weights
leave in the JAX package's layout, and port -> flax -> port is bit-exact.

``load_reference_checkpoint`` reads a reference ``model_*.pth``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import GlobalConfig
from ..models.encoders import trunk_family

StateDict = Dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(a: Any) -> torch.Tensor:
    """(H, W, I, O) -> (O, I, H, W)."""
    return _t(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _dense(a: Any) -> torch.Tensor:
    """(in, out) -> (out, in)."""
    return _t(np.transpose(np.asarray(a), (1, 0)))


def _put_conv(out: StateDict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _put_dense(out: StateDict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _dense(p["kernel"])
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _put_bn(out: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_convbn(out: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.conv.weight"] = _conv(p["Conv_0"]["kernel"])
    _put_bn(out, f"{key}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


def _point_net(out: StateDict, p: Mapping, s: Mapping) -> None:
    p, s = p["DynamicPointNet_0"], s["DynamicPointNet_0"]
    n_layer = sum(1 for k in p if k.startswith("fc"))
    for i in range(n_layer):
        key = "point_pillar_net.point_net.net"
        _put_dense(out, f"{key}.{3 * i}", p[f"fc{i}"])
        _put_bn(out, f"{key}.{3 * i + 1}", p[f"bn{i}"], s[f"bn{i}"])


def _regnety(out: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    _put_convbn(out, f"{prefix}stem", p["_stem"], s["_stem"])
    stage_re = re.compile(r"_stages_(\d+)$")
    for sname in sorted(k for k in p if stage_re.match(k)):
        si = int(stage_re.match(sname).group(1))
        for bname in sorted(p[sname], key=lambda n: int(n.rsplit("_", 1)[1])):
            bi = int(bname.rsplit("_", 1)[1])
            dst = f"{prefix}s{si + 1}.b{bi + 1}"
            bp, bs = p[sname][bname], s[sname][bname]
            _put_convbn(out, f"{dst}.conv1", bp["ConvBN_0"], bs["ConvBN_0"])
            _put_convbn(out, f"{dst}.conv2", bp["ConvBN_1"], bs["ConvBN_1"])
            _put_conv(out, f"{dst}.se.fc1", bp["SEModule_0"]["Conv_0"])
            _put_conv(out, f"{dst}.se.fc2", bp["SEModule_0"]["Conv_1"])
            _put_convbn(out, f"{dst}.conv3", bp["ConvBN_2"], bs["ConvBN_2"])
            if "ConvBN_3" in bp:
                _put_convbn(out, f"{dst}.downsample", bp["ConvBN_3"],
                            bs["ConvBN_3"])


def _resnet(out: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    """The JAX ResNet's ``_conv1``, ``_bn1``, ``_stages_{L}_{B}/ConvBN_k``
    -> timm's ``conv1``, ``bn1``, ``layer{L+1}.{B}.*``."""
    _put_conv(out, f"{prefix}conv1", p["_conv1"])
    _put_bn(out, f"{prefix}bn1", p["_bn1"], s["_bn1"])
    for name, (li, bi) in _grid_names(p, "_stages"):
        dst = f"{prefix}layer{li + 1}.{bi}"
        bp, bs = p[name], s[name]
        for k in (0, 1):
            _put_conv(out, f"{dst}.conv{k + 1}", bp[f"ConvBN_{k}"]["Conv_0"])
            _put_bn(out, f"{dst}.bn{k + 1}", bp[f"ConvBN_{k}"]["BatchNorm_0"],
                    bs[f"ConvBN_{k}"]["BatchNorm_0"])
        if "ConvBN_2" in bp:
            _put_conv(out, f"{dst}.downsample.0", bp["ConvBN_2"]["Conv_0"])
            _put_bn(out, f"{dst}.downsample.1", bp["ConvBN_2"]["BatchNorm_0"],
                    bs["ConvBN_2"]["BatchNorm_0"])


def _put_ln(out: StateDict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _convnext(out: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    """The JAX ConvNeXt's ``_stem_conv``, ``_stem_norm``,
    ``_stages_{S}_{B}``, ``_downs_{S-1}_{0,1}`` -> timm's ``stem.{0,1}``,
    ``stages.S.blocks.B.*``, ``stages.S.downsample.{0,1}``."""
    _put_conv(out, f"{prefix}stem.0", p["_stem_conv"])
    _put_ln(out, f"{prefix}stem.1", p["_stem_norm"])
    for name, (si, bi) in _grid_names(p, "_stages"):
        dst = f"{prefix}stages.{si}.blocks.{bi}"
        bp = p[name]
        _put_conv(out, f"{dst}.conv_dw", bp["Conv_0"])
        _put_ln(out, f"{dst}.norm", bp["LayerNorm_0"])
        _put_dense(out, f"{dst}.mlp.fc1", bp["Dense_0"])
        _put_dense(out, f"{dst}.mlp.fc2", bp["Dense_1"])
        out[f"{dst}.gamma"] = _t(bp["gamma"])
    for name, (di, j) in _grid_names(p, "_downs"):
        dst = f"{prefix}stages.{di + 1}.downsample.{j}"
        (_put_ln if j == 0 else _put_conv)(out, dst, p[name])


def _grid_names(tree: Mapping, base: str):
    """flax's names of a list of lists, ``{base}_{i}_{j}``, with (i, j),
    in order."""
    rx = re.compile(re.escape(base) + r"_(\d+)_(\d+)$")
    found = [(k, (int(m.group(1)), int(m.group(2))))
             for k in tree if (m := rx.match(k))]
    return sorted(found, key=lambda kv: kv[1])


_TRUNK_TO_STATE = {"regnety": _regnety, "resnet": _resnet,
                   "convnext": _convnext}


def _gpt(out: StateDict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}pos_emb"] = _t(p["pos_emb"])
    if "vel_emb" in p:
        _put_dense(out, f"{prefix}vel_emb", p["vel_emb"])
    n_layer = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layer):
        bp = p[f"block_{i}"]
        dst = f"{prefix}blocks.{i}"
        for ln in ("ln1", "ln2"):
            out[f"{dst}.{ln}.weight"] = _t(bp[ln]["scale"])
            out[f"{dst}.{ln}.bias"] = _t(bp[ln]["bias"])
        for lin in ("key", "query", "value", "proj"):
            _put_dense(out, f"{dst}.attn.{lin}", bp["attn"][lin])
        _put_dense(out, f"{dst}.mlp.0", bp["mlp_fc"])
        _put_dense(out, f"{dst}.mlp.2", bp["mlp_proj"])
    out[f"{prefix}ln_f.weight"] = _t(p["ln_f"]["scale"])
    out[f"{prefix}ln_f.bias"] = _t(p["ln_f"]["bias"])


def _backbone(out: StateDict, mcfg, bb: Mapping, bbs: Mapping) -> None:
    """The JAX ``backbone`` subtree of any family -> ``_model.*``."""
    family = mcfg.backbone
    if family == "latentTF":
        bb, bbs = bb["inner"], bbs.get("inner", {})
    for branch, prefix, arch in (
            ("image_encoder", "_model.image_encoder.features.",
             mcfg.image_architecture),
            ("lidar_encoder", "_model.lidar_encoder._model.",
             mcfg.lidar_architecture)):
        _TRUNK_TO_STATE[trunk_family(arch)](out, prefix, bb[branch],
                                            bbs.get(branch, {}))
    if family in ("transFuser", "latentTF"):
        for i in (1, 2, 3, 4):
            _gpt(out, f"_model.transformer{i}.", bb[f"transformer{i}"])
    elif family == "late_fusion":
        for name in ("reduce_channels_conv_image",
                     "reduce_channels_conv_lidar"):
            if name in bb:
                _put_conv(out, f"_model.{name}", bb[name])
        for name in ("norm_after_pool_img", "norm_after_pool_lidar"):
            if name in bb:
                _put_ln(out, f"_model.{name}", bb[name])
        if "vel_emb" in bb:
            _put_dense(out, "_model.vel_emb", bb["vel_emb"])
    elif family == "geometric_fusion":
        for i in range(4):
            if f"image_convs_{i}" not in bb:
                continue  # a scale n_scale leaves out
            s = i + 1
            for src, dst in (("image_convs", "image_conv"),
                             ("image_deconvs", "image_deconv"),
                             ("lidar_convs", "lidar_conv"),
                             ("lidar_deconvs", "lidar_deconv")):
                _put_conv(out, f"_model.{dst}{s}", bb[f"{src}_{i}"])
            for src, dst in (("image_projections", "image_projection"),
                             ("lidar_projections", "lidar_projection")):
                for j in range(3):
                    _put_dense(out, f"_model.{dst}{s}.{2 * j}",
                               bb[f"{src}_{i}"][f"fc{j}"])
            if f"vel_embs_{i}" in bb:
                _put_dense(out, f"_model.vel_emb{s}", bb[f"vel_embs_{i}"])
    for name in ("change_channel_conv_image", "change_channel_conv_lidar"):
        if name in bb:
            _put_conv(out, f"_model.{name}", bb[name])
    for name in ("c5_conv", "up_conv5", "up_conv4", "up_conv3"):
        _put_conv(out, f"_model.{name}", bb["top_down"][name])


def state_dict_from_jax(variables: Mapping[str, Any],
                        config: GlobalConfig) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> port state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: StateDict = {}
    _backbone(out, config.model, params["backbone"],
              stats.get("backbone", {}))

    for dec in ("seg_decoder", "depth_decoder"):
        if dec in params:
            stack = params[dec]["stack"]
            for k in (1, 2, 3):
                _put_conv(out, f"{dec}.deconv{k}.0", stack[f"deconv{k}_0"])
                _put_conv(out, f"{dec}.deconv{k}.2", stack[f"deconv{k}_1"])
    _put_conv(out, "pred_bev.0", params["pred_bev_conv0"])
    _put_conv(out, "pred_bev.2", params["pred_bev_conv1"])

    for branch, bp in params["head"].items():
        _put_conv(out, f"head.{branch}_head.0", bp["conv0"])
        _put_conv(out, f"head.{branch}_head.2", bp["conv1"])

    gru = params["wp_gru"]
    for i, j in enumerate((0, 2, 4)):
        _put_dense(out, f"join.{j}", gru[f"join_{i}"])
    out["decoder.weight_ih"] = _dense(gru["cell"]["weight_ih"]["kernel"])
    out["decoder.bias_ih"] = _t(gru["cell"]["weight_ih"]["bias"])
    out["decoder.weight_hh"] = _dense(gru["cell"]["weight_hh"]["kernel"])
    out["decoder.bias_hh"] = _t(gru["cell"]["weight_hh"]["bias"])
    _put_dense(out, "output", gru["output"])
    if "point_pillar_net" in params:
        _point_net(out, params["point_pillar_net"],
                   stats["point_pillar_net"])
    return out


def strip_ddp_prefix(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the DDP 'module.' prefix (submission_agent.py:95)."""
    return {k[7:] if k.startswith("module.") else k: v
            for k, v in state.items()}


# The reference's timm surgery (transfuser.py:383-416, 478-488) registers
# alias names for tensors that also sit under their canonical timm names
# (RegNetY and ConvNeXt: conv1 -> the stem conv, layer{1-4} -> the stages)
# and keeps timm's unused classifier head. Aliases and the classifier are
# dropped. Its LiDAR branch replaces the first conv with one of the
# LiDAR's in-channels: on ResNet it keeps the name ``conv1``, which is
# canonical there; on RegNetY and ConvNeXt it is re-registered as a
# top-level ``conv1`` (weight, and bias on ConvNeXt) and is the stem conv.
_TRUNKS = ("_model.image_encoder.features.", "_model.lidar_encoder._model.")
_TIMM_ALIASES = re.compile(r"(conv1|bn1|act1|maxpool|layer[1-4]|head|fc)\.")
_ALIAS_RE = {"regnety": _TIMM_ALIASES, "convnext": _TIMM_ALIASES,
             "resnet": re.compile(r"fc\.")}
_STEM_CONV = {"regnety": "stem.conv", "convnext": "stem.0"}
_SCALE_KEY_RE = re.compile(
    r"_model\.(?:image_conv|image_deconv|lidar_conv|lidar_deconv|"
    r"image_projection|lidar_projection|vel_emb)(\d)\.")


def canonical_reference_state(state: Mapping[str, Any],
                              config: GlobalConfig) -> Dict[str, Any]:
    """A reference state dict in the port's names: the DDP prefix, the
    trunks' aliases and classifier dropped, the LiDAR stem conv renamed,
    by the trunk families of ``config``."""
    archs = (config.model.image_architecture,
             config.model.lidar_architecture)
    families = {t: trunk_family(a) for t, a in zip(_TRUNKS, archs)}
    state = strip_ddp_prefix(state)
    out = {}
    for key, val in state.items():
        trunk = next((t for t in _TRUNKS if key.startswith(t)), None)
        if trunk is not None:
            family = families[trunk]
            rest = key[len(trunk):]
            stem = _STEM_CONV.get(family)
            if (stem is not None and rest.startswith("conv1.") and
                    f"{trunk}{stem}.weight" not in state):
                key = f"{trunk}{stem}.{rest[len('conv1.'):]}"
            elif _ALIAS_RE[family].match(rest):
                continue
        out[key] = val
    return out


def load_reference_checkpoint(path: str, config: GlobalConfig) -> StateDict:
    """Read a reference ``model_*.pth`` (a torch.save'd state dict, with or
    without the DDP prefix) into a state dict that a port
    ``LidarCenterNet(config)`` loads with ``strict=True``. Under
    geometric_fusion the reference's parameters of the scales that
    ``gpt.n_scale`` leaves out are dropped (the port builds none)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    state = canonical_reference_state(state, config)
    blk_re = re.compile(r"_model\.transformer1\.blocks\.(\d+)\.")
    blocks = {int(m.group(1)) for k in state if (m := blk_re.match(k))}
    if blocks and 1 + max(blocks) != config.model.gpt.n_layer:
        raise ValueError(
            f"checkpoint GPT has {1 + max(blocks)} layers but "
            f"config.model.gpt.n_layer={config.model.gpt.n_layer}")
    if config.model.backbone == "geometric_fusion":
        n_scale = config.model.gpt.n_scale
        state = {k: v for k, v in state.items()
                 if not ((m := _SCALE_KEY_RE.match(k)) and
                         n_scale < 5 - int(m.group(1)))}
    return state


# ------------------------------------------------ port state dict -> flax tree

Tree = Dict[str, Any]


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _get_conv(state: Mapping, key: str) -> Tree:
    p = {"kernel": np.ascontiguousarray(
        np.transpose(_a(state[f"{key}.weight"]), (2, 3, 1, 0)))}
    if f"{key}.bias" in state:
        p["bias"] = _a(state[f"{key}.bias"])
    return p


def _get_dense(state: Mapping, key: str) -> Tree:
    p = {"kernel": np.ascontiguousarray(_a(state[f"{key}.weight"]).T)}
    if f"{key}.bias" in state:
        p["bias"] = _a(state[f"{key}.bias"])
    return p


def _get_bn(state: Mapping, key: str):
    return ({"scale": _a(state[f"{key}.weight"]),
             "bias": _a(state[f"{key}.bias"])},
            {"mean": _a(state[f"{key}.running_mean"]),
             "var": _a(state[f"{key}.running_var"])})


def _get_convbn(state: Mapping, key: str):
    p, s = _get_bn(state, f"{key}.bn")
    return ({"Conv_0": {"kernel": _get_conv(state, f"{key}.conv")["kernel"]},
             "BatchNorm_0": p}, {"BatchNorm_0": s})


def _indices(state: Mapping, pattern: str) -> list:
    rx = re.compile(pattern)
    return sorted({int(m.group(1)) for k in state if (m := rx.match(k))})


def _regnety_from(state: Mapping, prefix: str):
    p, s = {}, {}
    p["_stem"], s["_stem"] = _get_convbn(state, f"{prefix}stem")
    for si in _indices(state, re.escape(prefix) + r"s(\d+)\."):
        sname = f"_stages_{si - 1}"
        p[sname], s[sname] = {}, {}
        block_re = re.escape(f"{prefix}s{si}.") + r"b(\d+)\."
        for bi in _indices(state, block_re):
            src = f"{prefix}s{si}.b{bi}"
            bp, bs = {}, {}
            for j, name in enumerate(("conv1", "conv2")):
                bp[f"ConvBN_{j}"], bs[f"ConvBN_{j}"] = _get_convbn(
                    state, f"{src}.{name}")
            bp["SEModule_0"] = {"Conv_0": _get_conv(state, f"{src}.se.fc1"),
                                "Conv_1": _get_conv(state, f"{src}.se.fc2")}
            bp["ConvBN_2"], bs["ConvBN_2"] = _get_convbn(state, f"{src}.conv3")
            if f"{src}.downsample.conv.weight" in state:
                bp["ConvBN_3"], bs["ConvBN_3"] = _get_convbn(
                    state, f"{src}.downsample")
            p[sname][f"RegNetYBlock_{bi - 1}"] = bp
            s[sname][f"RegNetYBlock_{bi - 1}"] = bs
    return p, s


def _get_ln(state: Mapping, key: str) -> Tree:
    return {"scale": _a(state[f"{key}.weight"]),
            "bias": _a(state[f"{key}.bias"])}


def _resnet_from(state: Mapping, prefix: str):
    p: Tree = {"_conv1": _get_conv(state, f"{prefix}conv1")}
    s: Tree = {}
    p["_bn1"], s["_bn1"] = _get_bn(state, f"{prefix}bn1")
    block_re = re.compile(re.escape(prefix) + r"layer(\d+)\.(\d+)\.")
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for k in state if (m := block_re.match(k))})
    for li, bi in blocks:
        src = f"{prefix}layer{li}.{bi}"
        bp, bs = {}, {}
        for k in (0, 1):
            bn_p, bn_s = _get_bn(state, f"{src}.bn{k + 1}")
            bp[f"ConvBN_{k}"] = {
                "Conv_0": _get_conv(state, f"{src}.conv{k + 1}"),
                "BatchNorm_0": bn_p}
            bs[f"ConvBN_{k}"] = {"BatchNorm_0": bn_s}
        if f"{src}.downsample.0.weight" in state:
            bn_p, bn_s = _get_bn(state, f"{src}.downsample.1")
            bp["ConvBN_2"] = {
                "Conv_0": _get_conv(state, f"{src}.downsample.0"),
                "BatchNorm_0": bn_p}
            bs["ConvBN_2"] = {"BatchNorm_0": bn_s}
        p[f"_stages_{li - 1}_{bi}"], s[f"_stages_{li - 1}_{bi}"] = bp, bs
    return p, s


def _convnext_from(state: Mapping, prefix: str):
    p: Tree = {"_stem_conv": _get_conv(state, f"{prefix}stem.0"),
               "_stem_norm": _get_ln(state, f"{prefix}stem.1")}
    block_re = re.compile(re.escape(prefix) + r"stages\.(\d+)\.blocks\.(\d+)\.")
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for k in state if (m := block_re.match(k))})
    for si, bi in blocks:
        src = f"{prefix}stages.{si}.blocks.{bi}"
        p[f"_stages_{si}_{bi}"] = {
            "Conv_0": _get_conv(state, f"{src}.conv_dw"),
            "LayerNorm_0": _get_ln(state, f"{src}.norm"),
            "Dense_0": _get_dense(state, f"{src}.mlp.fc1"),
            "Dense_1": _get_dense(state, f"{src}.mlp.fc2"),
            "gamma": _a(state[f"{src}.gamma"])}
    for si in _indices(state, re.escape(prefix) +
                       r"stages\.(\d+)\.downsample\."):
        src = f"{prefix}stages.{si}.downsample"
        p[f"_downs_{si - 1}_0"] = _get_ln(state, f"{src}.0")
        p[f"_downs_{si - 1}_1"] = _get_conv(state, f"{src}.1")
    return p, {}


_TRUNK_FROM_STATE = {"regnety": _regnety_from, "resnet": _resnet_from,
                     "convnext": _convnext_from}


def _gpt_from(state: Mapping, prefix: str) -> Tree:
    p: Tree = {"pos_emb": _a(state[f"{prefix}pos_emb"])}
    if f"{prefix}vel_emb.weight" in state:
        p["vel_emb"] = _get_dense(state, f"{prefix}vel_emb")
    for i in _indices(state, re.escape(prefix) + r"blocks\.(\d+)\."):
        src = f"{prefix}blocks.{i}"
        bp: Tree = {ln: {"scale": _a(state[f"{src}.{ln}.weight"]),
                         "bias": _a(state[f"{src}.{ln}.bias"])}
                    for ln in ("ln1", "ln2")}
        bp["attn"] = {lin: _get_dense(state, f"{src}.attn.{lin}")
                      for lin in ("key", "query", "value", "proj")}
        bp["mlp_fc"] = _get_dense(state, f"{src}.mlp.0")
        bp["mlp_proj"] = _get_dense(state, f"{src}.mlp.2")
        p[f"block_{i}"] = bp
    p["ln_f"] = {"scale": _a(state[f"{prefix}ln_f.weight"]),
                 "bias": _a(state[f"{prefix}ln_f.bias"])}
    return p


def _backbone_from(state: Mapping, mcfg):
    """``_model.*`` of any family -> the JAX ``backbone`` subtree (params,
    batch_stats)."""
    family = mcfg.backbone
    bb: Tree = {}
    bbs: Tree = {}
    for branch, prefix, arch in (
            ("image_encoder", "_model.image_encoder.features.",
             mcfg.image_architecture),
            ("lidar_encoder", "_model.lidar_encoder._model.",
             mcfg.lidar_architecture)):
        bb[branch], bbs[branch] = _TRUNK_FROM_STATE[trunk_family(arch)](
            state, prefix)
    if family in ("transFuser", "latentTF"):
        for i in (1, 2, 3, 4):
            bb[f"transformer{i}"] = _gpt_from(state, f"_model.transformer{i}.")
    elif family == "late_fusion":
        for name in ("reduce_channels_conv_image",
                     "reduce_channels_conv_lidar"):
            if f"_model.{name}.weight" in state:
                bb[name] = _get_conv(state, f"_model.{name}")
        for name in ("norm_after_pool_img", "norm_after_pool_lidar"):
            if f"_model.{name}.weight" in state:
                bb[name] = _get_ln(state, f"_model.{name}")
        if "_model.vel_emb.weight" in state:
            bb["vel_emb"] = _get_dense(state, "_model.vel_emb")
    elif family == "geometric_fusion":
        for i in range(4):
            s = i + 1
            if f"_model.image_conv{s}.weight" not in state:
                continue  # a scale n_scale leaves out
            for dst, src in (("image_convs", "image_conv"),
                             ("image_deconvs", "image_deconv"),
                             ("lidar_convs", "lidar_conv"),
                             ("lidar_deconvs", "lidar_deconv")):
                bb[f"{dst}_{i}"] = _get_conv(state, f"_model.{src}{s}")
            for dst, src in (("image_projections", "image_projection"),
                             ("lidar_projections", "lidar_projection")):
                bb[f"{dst}_{i}"] = {
                    f"fc{j}": _get_dense(state, f"_model.{src}{s}.{2 * j}")
                    for j in range(3)}
            if f"_model.vel_emb{s}.weight" in state:
                bb[f"vel_embs_{i}"] = _get_dense(state, f"_model.vel_emb{s}")
    for name in ("change_channel_conv_image", "change_channel_conv_lidar"):
        if f"_model.{name}.weight" in state:
            bb[name] = _get_conv(state, f"_model.{name}")
    bb["top_down"] = {name: _get_conv(state, f"_model.{name}")
                      for name in ("c5_conv", "up_conv5", "up_conv4",
                                   "up_conv3")}
    if family == "latentTF":
        return {"inner": bb}, {"inner": bbs}
    return bb, bbs


def variables_from_state_dict(state: Mapping[str, torch.Tensor],
                              config: GlobalConfig) -> Dict[str, Tree]:
    """Port state dict -> the JAX package's ``{'params', 'batch_stats'}``
    as nested dicts of numpy arrays: the exact inverse of
    ``state_dict_from_jax`` (every family and trunk, PointPillars). A
    subtree with no BatchNorm (ConvNeXt) has an empty ``batch_stats``
    entry, which flax's restore ignores."""
    mcfg = config.model
    params: Tree = {}
    stats: Tree = {}
    params["backbone"], stats["backbone"] = _backbone_from(state, mcfg)

    for dec in ("seg_decoder", "depth_decoder"):
        if f"{dec}.deconv1.0.weight" in state:
            stack = {}
            for k in (1, 2, 3):
                stack[f"deconv{k}_0"] = _get_conv(state, f"{dec}.deconv{k}.0")
                stack[f"deconv{k}_1"] = _get_conv(state, f"{dec}.deconv{k}.2")
            params[dec] = {"stack": stack}
    params["pred_bev_conv0"] = _get_conv(state, "pred_bev.0")
    params["pred_bev_conv1"] = _get_conv(state, "pred_bev.2")

    branch_re = re.compile(r"head\.(\w+)_head\.0\.weight$")
    branches = [m.group(1) for k in state if (m := branch_re.match(k))]
    params["head"] = {b: {"conv0": _get_conv(state, f"head.{b}_head.0"),
                          "conv1": _get_conv(state, f"head.{b}_head.2")}
                      for b in branches}

    gru: Tree = {f"join_{i}": _get_dense(state, f"join.{j}")
                 for i, j in enumerate((0, 2, 4))}
    gru["cell"] = {
        "weight_ih": {"kernel": np.ascontiguousarray(
            _a(state["decoder.weight_ih"]).T),
            "bias": _a(state["decoder.bias_ih"])},
        "weight_hh": {"kernel": np.ascontiguousarray(
            _a(state["decoder.weight_hh"]).T),
            "bias": _a(state["decoder.bias_hh"])}}
    gru["output"] = _get_dense(state, "output")
    params["wp_gru"] = gru

    if mcfg.point_pillars.use_point_pillars:
        key = "point_pillar_net.point_net.net"
        net_p: Tree = {}
        net_s: Tree = {}
        for i in range(len(mcfg.point_pillars.num_features)):
            net_p[f"fc{i}"] = _get_dense(state, f"{key}.{3 * i}")
            net_p[f"bn{i}"], net_s[f"bn{i}"] = _get_bn(state,
                                                       f"{key}.{3 * i + 1}")
        params["point_pillar_net"] = {"DynamicPointNet_0": net_p}
        stats["point_pillar_net"] = {"DynamicPointNet_0": net_s}
    return {"params": params, "batch_stats": stats}
