"""Weight bridge between the JAX package's variables and the port.

``state_dict_from_jax`` is the exact inverse of the JAX package's
``convert_lidar_centernet_statedict`` (transfuser_tpu/train/torch_import.py)
for the transFuser / RegNetY family: it takes the ``{'params',
'batch_stats'}`` tree as numpy arrays (no JAX import needed) and returns a
state dict in the reference checkpoint's names, which
``LidarCenterNet.load_state_dict(strict=True)`` accepts.

Conventions: conv kernels HWIO -> OIHW; dense kernels (in, out) ->
(out, in); the GRU's two dense layers -> ``decoder.weight_ih`` /
``weight_hh`` with separate biases; BatchNorm ``scale/bias/mean/var`` ->
``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``).

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


def state_dict_from_jax(variables: Mapping[str, Any],
                        config: GlobalConfig) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> port state dict."""
    mcfg = config.model
    if mcfg.backbone != "transFuser":
        raise NotImplementedError(
            f"weight bridge covers the transFuser family only, not "
            f"'{mcfg.backbone}' (ROADMAP.md queue 1)")
    for arch in (mcfg.image_architecture, mcfg.lidar_architecture):
        if not arch.startswith("regnety"):
            raise NotImplementedError(
                f"weight bridge covers RegNetY trunks only, not '{arch}'")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: StateDict = {}
    bb, bbs = params["backbone"], stats["backbone"]
    _regnety(out, "_model.image_encoder.features.", bb["image_encoder"],
             bbs["image_encoder"])
    _regnety(out, "_model.lidar_encoder._model.", bb["lidar_encoder"],
             bbs["lidar_encoder"])
    for i in (1, 2, 3, 4):
        _gpt(out, f"_model.transformer{i}.", bb[f"transformer{i}"])
    for name in ("change_channel_conv_image", "change_channel_conv_lidar"):
        if name in bb:
            _put_conv(out, f"_model.{name}", bb[name])
    for name in ("c5_conv", "up_conv5", "up_conv4", "up_conv3"):
        _put_conv(out, f"_model.{name}", bb["top_down"][name])

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


# The reference's timm surgery (transfuser.py:383-393, 478-488) registers
# alias names for tensors that also sit under their canonical timm names
# (conv1 -> stem, layer{1-4} -> s{1-4}), and keeps timm's unused classifier
# head. Aliases and the classifier are dropped; the LiDAR branch's
# replacement stem conv, registered as top-level `conv1`, is its stem conv.
_TRUNKS = ("_model.image_encoder.features.", "_model.lidar_encoder._model.")
_ALIAS_RE = re.compile(r"(conv1|bn1|act1|maxpool|layer[1-4]|head|fc)\.")


def canonical_reference_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    state = strip_ddp_prefix(state)
    out = {}
    for key, val in state.items():
        trunk = next((t for t in _TRUNKS if key.startswith(t)), None)
        if trunk is not None:
            rest = key[len(trunk):]
            if rest == "conv1.weight" and f"{trunk}stem.conv.weight" not in state:
                key = f"{trunk}stem.conv.weight"
            elif _ALIAS_RE.match(rest):
                continue
        out[key] = val
    return out


def load_reference_checkpoint(path: str, config: GlobalConfig) -> StateDict:
    """Read a reference ``model_*.pth`` (a torch.save'd state dict, with or
    without the DDP prefix) into a state dict that a port
    ``LidarCenterNet(config)`` loads with ``strict=True``."""
    if config.model.backbone != "transFuser":
        raise NotImplementedError(
            f"only transFuser checkpoints load so far, not "
            f"'{config.model.backbone}' (ROADMAP.md queue 1)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    state = canonical_reference_state(state)
    blk_re = re.compile(r"_model\.transformer1\.blocks\.(\d+)\.")
    blocks = {int(m.group(1)) for k in state if (m := blk_re.match(k))}
    if blocks and 1 + max(blocks) != config.model.gpt.n_layer:
        raise ValueError(
            f"checkpoint GPT has {1 + max(blocks)} layers but "
            f"config.model.gpt.n_layer={config.model.gpt.n_layer}")
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


def variables_from_state_dict(state: Mapping[str, torch.Tensor],
                              config: GlobalConfig) -> Dict[str, Tree]:
    """Port state dict -> the JAX package's ``{'params', 'batch_stats'}``
    as nested dicts of numpy arrays: the exact inverse of
    ``state_dict_from_jax`` (transFuser / RegNetY, PointPillars)."""
    mcfg = config.model
    if mcfg.backbone != "transFuser":
        raise NotImplementedError(
            f"weight bridge covers the transFuser family only, not "
            f"'{mcfg.backbone}' (ROADMAP.md Queue 1 item 11)")
    for arch in (mcfg.image_architecture, mcfg.lidar_architecture):
        if not arch.startswith("regnety"):
            raise NotImplementedError(
                f"weight bridge covers RegNetY trunks only, not '{arch}' "
                "(ROADMAP.md Queue 1 item 11)")
    params: Tree = {}
    stats: Tree = {}
    bb: Tree = {}
    bbs: Tree = {}
    bb["image_encoder"], bbs["image_encoder"] = _regnety_from(
        state, "_model.image_encoder.features.")
    bb["lidar_encoder"], bbs["lidar_encoder"] = _regnety_from(
        state, "_model.lidar_encoder._model.")
    for i in (1, 2, 3, 4):
        bb[f"transformer{i}"] = _gpt_from(state, f"_model.transformer{i}.")
    for name in ("change_channel_conv_image", "change_channel_conv_lidar"):
        if f"_model.{name}.weight" in state:
            bb[name] = _get_conv(state, f"_model.{name}")
    bb["top_down"] = {name: _get_conv(state, f"_model.{name}")
                      for name in ("c5_conv", "up_conv5", "up_conv4",
                                   "up_conv3")}
    params["backbone"], stats["backbone"] = bb, bbs

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
