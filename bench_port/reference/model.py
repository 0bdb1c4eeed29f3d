"""Plain fp32 TransFuser (RegNetY trunks, GPT fusion, optional PointPillars
LiDAR encoder): the benchmark's frozen reference of the model that
``transfuser_torch.models.LidarCenterNet`` runs (reference
team_code_transfuser/model.py, transfuser.py, point_pillar.py).

Plain PyTorch only: attention is softmax(q k^T / sqrt(D)) v written out,
the pillar pooling a plain ``index_reduce``. Imports nothing of the port;
module names follow the reference checkpoint's, so one state dict loads
into both. Every tensor is fp32 and TF32 is off (``plain_fp32``).

``lowp("fp8")`` is the control of the benchmark's comparison: where the
port computes in bf16, the reference computes in fp8 as fp8 training
does. Every convolution and linear (not the fp32 islands: the GRU and its
join MLP) takes its operands and gives its output rounded to float8 e4m3,
and the gradient that reaches its output rounded to e5m2; the attention
products take e4m3 operands. Each rounding has a per-tensor scale; values
stay fp32 between them.

This module is the reference ``model`` of the harness's contract
(``harness.py``), and the base of every other: a configuration whose
file says ``"reference": "<name>"`` runs ``reference/<name>.py``, which
adds trunks or a backbone family without copying or patching this file.
It imports from here what the contract names (``namespace``,
``plain_fp32``, ``lowp``, ``_resizing``) and the layers (``Conv2d``,
``Linear``, ``BatchNorm``, ``LayerNorm``: rounded under ``lowp`` as
``reference/train.py`` expects), writes its trunk classes in plain fp32
PyTorch with the port's parameter names, and defines

* ``build(cfg, device)``, which returns ``model.build(cfg, device,
  trunks=dict(TRUNK_FACTORIES, <arch>=<factory>))`` and, for a family,
  ``backbones=dict(BACKBONES, <family>=<class>)``: a trunk factory takes
  ``in_channels`` and gives a module with ``stem(x)``, ``stage(i, x)``
  for i in 0..3 and ``widths``; a backbone class takes ``(cfg,
  lidar_in, trunks)`` and answers ``forward`` as ``TransfuserBackbone``
  does;
* ``seed_rules(model)``: this module's rules and one for each leaf its
  classes add (``weights.py``: a leaf with no rule is an error);
* ``TINY_TRUNK``: the trunk of the CPU-size runs of the harness's tests.
"""

from __future__ import annotations

import contextlib
import functools
import math
from types import SimpleNamespace
import torch
import torch.nn as nn
import torch.nn.functional as F

FLAX_BN_MOMENTUM = 0.9
NEG_INF = -1e30
PIXELS_PER_METER = 8
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BRANCHES = ("heatmap", "wh", "offset", "yaw_class", "yaw_res", "velocity",
            "brake")

_precision = {"mode": "fp32"}
E4M3_MAX = 448.0
# > 0 while the matrix products of a resize run: the FLOP count
# (bench_port/flops.py) leaves resizes out, as PyTorch's interpolation
_resizing = [0]


@contextlib.contextmanager
def plain_fp32():
    """Full fp32 matrix products on the card inside: TF32 off for both
    matrix products and convolutions; both flags restored on leaving, so
    that the program runs as it would alone."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def lowp(mode: str = "fp8"):
    """Run the reference with its bf16 operands rounded to ``mode``."""
    old = _precision["mode"]
    _precision["mode"] = mode
    try:
        yield
    finally:
        _precision["mode"] = old


E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def q(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under ``lowp`` (identity in fp32);
    straight-through gradient."""
    if _precision["mode"] == "fp32":
        return x
    return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
                - x).detach()


class _Out(torch.autograd.Function):
    """A layer's output: e4m3 forward, its gradient e5m2 backward."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def qo(y: torch.Tensor) -> torch.Tensor:
    return y if _precision["mode"] == "fp32" else _Out.apply(y)


def namespace(d):
    """A configuration dict as nested attributes."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(namespace(v) for v in d)
    return d


# ----------------------------------------------------------------- layers

class Conv2d(nn.Conv2d):
    def forward(self, x):
        return qo(self._conv_forward(q(x), q(self.weight), self.bias))


class Linear(nn.Linear):
    island = False  # an fp32 island of the port: never rounded

    def forward(self, x):
        if self.island:
            return F.linear(x, self.weight, self.bias)
        return qo(F.linear(q(x), q(self.weight), self.bias))


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """flax BatchNorm(momentum 0.9, eps 1e-5): batch mean and biased
    variance in training (the running statistics take the biased one
    too), running statistics in eval."""

    def _check_input_dim(self, x):
        pass

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            m = FLAX_BN_MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class LayerNorm(nn.LayerNorm):
    pass


# ----------------------------------------------------------------- image ops

def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def adaptive_avg_pool(x, out_hw):
    n, c, h, w = x.shape
    oh, ow = out_hw
    if h % oh or w % ow:
        return F.adaptive_avg_pool2d(x, (oh, ow))
    return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


def _linear_weights(in_size, out_size, x):
    """jax.image.resize(method="linear") weights along one axis, widened
    where the axis shrinks (antialiasing)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    kw = dict(dtype=torch.float32, device=x.device)
    sample = (torch.arange(out_size, **kw) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, **kw)[:, None]).abs()
    weights = (1.0 - dist / kernel_scale).clamp(min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(x.dtype)


def resize_bilinear(x, out_hw, align_corners=False):
    """NCHW bilinear resize; a shrinking axis antialiased as jax does."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    if align_corners or (oh >= h and ow >= w):
        return F.interpolate(x, size=(oh, ow), mode="bilinear",
                             align_corners=align_corners)
    _resizing[0] += 1
    try:
        if ow != w:
            x = torch.matmul(x, _linear_weights(w, ow, x))
        if oh != h:
            x = torch.matmul(_linear_weights(h, oh, x).t(), x)
    finally:
        _resizing[0] -= 1
    return x


def normalize_imagenet(x):
    mean = torch.tensor(IMAGENET_MEAN, device=x.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=x.device) * 255.0
    return (x - mean.reshape(1, 3, 1, 1)) / std.reshape(1, 3, 1, 1)


# ----------------------------------------------------------------- RegNetY

class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                           groups=groups, bias=False)
        self.bn = BatchNorm(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class SEModule(nn.Module):
    def __init__(self, channels, rd):
        super().__init__()
        self.fc1 = Conv2d(channels, rd, 1)
        self.fc2 = Conv2d(rd, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class RegNetYBlock(nn.Module):
    def __init__(self, cin, cout, stride, group_width):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 1)
        self.conv2 = ConvBN(cout, cout, 3, stride, cout // group_width)
        self.se = SEModule(cout, int(round(cin * 0.25)))
        self.conv3 = ConvBN(cout, cout, 1, act=False)
        self.downsample = (ConvBN(cin, cout, 1, stride, act=False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = self.conv3(self.se(self.conv2(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class RegNetStage(nn.Module):
    def __init__(self, depth, cin, cout, group_width):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"b{i + 1}", RegNetYBlock(
                cin if i == 0 else cout, cout, 2 if i == 0 else 1,
                group_width))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"b{i + 1}")(x)
        return x


class RegNetY(nn.Module):
    def __init__(self, depths, widths, group_width, stem_width, in_channels):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = ConvBN(in_channels, stem_width, 3, 2)
        ins = (stem_width,) + self.widths[:-1]
        for si, (d, i, o) in enumerate(zip(depths, ins, self.widths)):
            self.add_module(f"s{si + 1}", RegNetStage(d, i, o, group_width))

    def stage(self, i, x):
        return getattr(self, f"s{i + 1}")(x)


# timm's regnety_032, and the port's micro trunk for CPU tests
TRUNKS = {
    "regnety_032": dict(depths=(2, 5, 13, 1), widths=(72, 216, 576, 1512),
                        group_width=24, stem_width=32),
    "regnety_micro": dict(depths=(1, 2, 1, 1), widths=(24, 48, 96, 192),
                          group_width=24, stem_width=32),
}
# the trunks ``build`` knows by default: architecture -> factory of
# ``in_channels``
TRUNK_FACTORIES = {name: functools.partial(RegNetY, **kw)
                   for name, kw in TRUNKS.items()}
TINY_TRUNK = "regnety_micro"


def make_trunk(arch, in_channels, trunks):
    if arch not in trunks:
        raise ValueError(
            f"the reference has no trunk {arch!r} (it has {sorted(trunks)}); "
            "a module bench_port/reference/<name>.py adds one by passing "
            "trunks= to model.build, and the configuration's file names it "
            'as "reference": "<name>"')
    return trunks[arch](in_channels=in_channels)


class _Holder(nn.Module):
    """Keeps the reference checkpoint's ``image_encoder.features`` and
    ``lidar_encoder._model`` names."""

    def __init__(self, name, trunk):
        super().__init__()
        self.add_module(name, trunk)


# ----------------------------------------------------------------- GPT

def dropout(x, rate, gen, heads=None):
    """Keep with probability 1 - rate; the masks are the port's draws:
    ``torch.rand`` of x's (or all heads') shape from ``gen``, in order."""
    if rate == 0.0:
        return x
    shape = x.shape if heads is None else \
        (x.shape[0], heads) + tuple(x.shape[2:])
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention(qh, kh, vh):
    """softmax(q k^T / sqrt(D)) v over (B, T, H, D)."""
    d = qh.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q(qh), q(kh))
    p = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=-1)
    return torch.einsum("bhts,bshd->bthd", q(p), q(vh))


class SelfAttention(nn.Module):
    def __init__(self, n_embd, n_head, attn_pdrop, resid_pdrop):
        super().__init__()
        self.key = Linear(n_embd, n_embd)
        self.query = Linear(n_embd, n_embd)
        self.value = Linear(n_embd, n_embd)
        self.proj = Linear(n_embd, n_embd)
        self.n_head = n_head
        self.attn_pdrop = attn_pdrop
        self.resid_pdrop = resid_pdrop

    def forward(self, x, gen=None):
        b, t, c = x.shape
        hs = c // self.n_head
        qh = self.query(x).reshape(b, t, self.n_head, hs)
        kh = self.key(x).reshape(b, t, self.n_head, hs)
        vh = self.value(x).reshape(b, t, self.n_head, hs)
        if self.training and self.attn_pdrop > 0.0:
            att = torch.einsum("bthd,bshd->bhts", q(qh), q(kh))
            att = torch.softmax(att * (1.0 / math.sqrt(hs)), dim=-1)
            att = dropout(att, self.attn_pdrop, gen, self.n_head)
            y = torch.einsum("bhts,bshd->bthd", q(att), q(vh))
        else:
            y = attention(qh, kh, vh)
        y = self.proj(y.reshape(b, t, c))
        return dropout(y, self.resid_pdrop, gen) if self.training else y


class Block(nn.Module):
    def __init__(self, n_embd, n_head, block_exp, attn_pdrop, resid_pdrop):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, eps=1e-5)
        self.ln2 = LayerNorm(n_embd, eps=1e-5)
        self.attn = SelfAttention(n_embd, n_head, attn_pdrop, resid_pdrop)
        self.mlp = nn.Sequential(Linear(n_embd, block_exp * n_embd),
                                 nn.ReLU(),
                                 Linear(block_exp * n_embd, n_embd))
        self.resid_pdrop = resid_pdrop

    def forward(self, x, gen=None):
        x = x + self.attn(self.ln1(x), gen)
        h = self.mlp(self.ln2(x))
        return x + (dropout(h, self.resid_pdrop, gen) if self.training
                    else h)


class GPTFusion(nn.Module):
    def __init__(self, n_embd, g, use_velocity):
        super().__init__()
        self.n_embd = n_embd
        self.img_anchors = (g.img_vert_anchors, g.img_horz_anchors)
        self.lidar_anchors = (g.lidar_vert_anchors, g.lidar_horz_anchors)
        self.view_unpack = g.reference_view_unpack
        n_tok = (self.img_anchors[0] * self.img_anchors[1]
                 + self.lidar_anchors[0] * self.lidar_anchors[1])
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tok, n_embd))
        self.vel_emb = Linear(1, n_embd) if use_velocity else None
        self.embd_pdrop = g.embd_pdrop
        self.blocks = nn.ModuleList(
            Block(n_embd, g.n_head, g.block_exp, g.attn_pdrop, g.resid_pdrop)
            for _ in range(g.n_layer))
        self.ln_f = LayerNorm(n_embd, eps=1e-5)

    def forward(self, img_tok, lid_tok, velocity=None, gen=None):
        b = img_tok.shape[0]
        hi, wi = self.img_anchors
        hl, wl = self.lidar_anchors
        n_img = hi * wi
        x = torch.cat([img_tok.reshape(b, n_img, self.n_embd),
                       lid_tok.reshape(b, hl * wl, self.n_embd)], dim=1)
        x = x + self.pos_emb
        if self.vel_emb is not None:
            x = x + self.vel_emb(velocity.reshape(b, 1))[:, None, :]
        if self.training:
            x = dropout(x, self.embd_pdrop, gen)
        for block in self.blocks:
            x = block(x, gen)
        x = self.ln_f(x)
        if self.view_unpack:
            io = x[:, :n_img].reshape(b, self.n_embd, hi, wi)
            lo = x[:, n_img:].reshape(b, self.n_embd, hl, wl)
            return io.permute(0, 2, 3, 1), lo.permute(0, 2, 3, 1)
        return (x[:, :n_img].reshape(b, hi, wi, self.n_embd),
                x[:, n_img:].reshape(b, hl, wl, self.n_embd))


# ----------------------------------------------------------------- backbone

class TransfuserBackbone(nn.Module):
    def __init__(self, cfg, lidar_in, trunks):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        self.image_encoder = _Holder(
            "features", make_trunk(m.image_architecture, 3, trunks))
        self.lidar_encoder = _Holder(
            "_model", make_trunk(m.lidar_architecture, lidar_in, trunks))
        dims = self.image_encoder.features.widths
        for i in range(4):
            self.add_module(f"transformer{i + 1}",
                            GPTFusion(dims[i], m.gpt, m.use_velocity))
        feats = m.perception_output_features
        self.change = dims[-1] != feats
        if self.change:
            self.change_channel_conv_image = Conv2d(dims[-1], feats, 1)
            self.change_channel_conv_lidar = Conv2d(dims[-1], feats, 1)
        ch = cfg.bev.bev_features_channels
        self.c5_conv = Conv2d(feats, ch, 1)
        self.up_conv5 = Conv2d(ch, ch, 1)
        self.up_conv4 = Conv2d(ch, ch, 1)
        self.up_conv3 = Conv2d(ch, ch, 1)

    def forward(self, image, lidar, velocity=None, gen=None):
        g = self.cfg.model.gpt
        img_anchors = (g.img_vert_anchors, g.img_horz_anchors)
        lid_anchors = (g.lidar_vert_anchors, g.lidar_horz_anchors)
        ie = self.image_encoder.features
        le = self.lidar_encoder._model
        x_img = ie.stem(normalize_imagenet(image))
        x_lid = le.stem(lidar)
        for i in range(4):
            x_img = ie.stage(i, x_img)
            x_lid = le.stage(i, x_lid)
            io, lo = getattr(self, f"transformer{i + 1}")(
                to_nhwc(adaptive_avg_pool(x_img, img_anchors)),
                to_nhwc(adaptive_avg_pool(x_lid, lid_anchors)),
                velocity, gen)
            x_img = x_img + resize_bilinear(to_nchw(io), x_img.shape[2:])
            x_lid = x_lid + resize_bilinear(to_nchw(lo), x_lid.shape[2:])
        if self.change:
            x_img = self.change_channel_conv_image(x_img)
            x_lid = self.change_channel_conv_lidar(x_lid)
        fused = x_img.mean(dim=(2, 3)) + x_lid.mean(dim=(2, 3))
        f = self.cfg.bev.bev_upsample_factor

        def up(t):
            return resize_bilinear(t, (t.shape[2] * f, t.shape[3] * f))

        p5 = F.relu(self.c5_conv(x_lid))
        p4 = F.relu(self.up_conv5(up(p5)))
        p3 = F.relu(self.up_conv4(up(p4)))
        p2 = F.relu(self.up_conv3(up(p3)))
        return (p2, p3, p4, p5), x_img, fused


class Deconv(nn.Module):
    def __init__(self, cin, c1, c2, c3, cout, s1, s2):
        super().__init__()
        self.deconv1 = nn.Sequential(Conv2d(cin, c1, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c1, c2, 3, 1, 1), nn.ReLU())
        self.deconv2 = nn.Sequential(Conv2d(c2, c3, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c3, c3, 3, 1, 1), nn.ReLU())
        self.deconv3 = nn.Sequential(Conv2d(c3, c3, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c3, cout, 3, 1, 1))
        self.scales = (s1, s2)

    def forward(self, x):
        x = self.deconv1(x)
        h, w = x.shape[2:]
        x = self.deconv2(resize_bilinear(
            x, (h * self.scales[0], w * self.scales[0])))
        h, w = x.shape[2:]
        return self.deconv3(resize_bilinear(
            x, (h * self.scales[1], w * self.scales[1])))


class Head(nn.Module):
    def __init__(self, cin, ch, num_classes, num_dir_bins):
        super().__init__()
        outs = dict(heatmap=num_classes, wh=2, offset=2,
                    yaw_class=num_dir_bins, yaw_res=1, velocity=1, brake=2)
        for name in BRANCHES:
            self.add_module(f"{name}_head", nn.Sequential(
                Conv2d(cin, ch, 3, padding=1), nn.ReLU(),
                Conv2d(ch, outs[name], 1)))

    def forward(self, feat):
        out = {n: getattr(self, f"{n}_head")(feat) for n in BRANCHES}
        out["heatmap"] = torch.sigmoid(out["heatmap"])
        return out


# ----------------------------------------------------------------- pillars

class _SegmentMax(torch.autograd.Function):
    """Per-segment max (empty segments 0); a segment's gradient split
    evenly among the points that equal its max."""

    @staticmethod
    def forward(ctx, values, ids, num_segments):
        out = values.new_full((num_segments, values.shape[-1]), NEG_INF)
        out = out.index_reduce(0, ids, values, "amax", include_self=True)
        out = torch.where(out <= NEG_INF / 2, torch.zeros_like(out), out)
        ctx.save_for_backward(values, ids, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        values, ids, out = ctx.saved_tensors
        tie = values == out.index_select(0, ids)
        count = torch.zeros_like(out).index_add_(0, ids, tie.to(out.dtype))
        share = grad_out.index_select(0, ids) / \
            count.index_select(0, ids).clamp_min(1.0)
        return torch.where(tie, share, torch.zeros_like(share)), None, None


def segment_mean(values, ids, n):
    sums = values.new_zeros((n, values.shape[-1])).index_add(0, ids, values)
    counts = values.new_zeros((n, 1)).index_add(
        0, ids, values.new_ones((values.shape[0], 1)))
    return sums / counts.clamp_min(1.0)


class PointNet(nn.Module):
    def __init__(self, num_input, widths):
        super().__init__()
        layers = []
        for w in widths:
            layers += [Linear(num_input, w), BatchNorm(w, eps=1e-5),
                       nn.ReLU()]
            num_input = w
        self.net = nn.Sequential(*layers)


class PointPillarNet(nn.Module):
    def __init__(self, pp):
        super().__init__()
        self.pp = pp
        self.point_net = PointNet(pp.num_input, pp.num_features)

    def forward(self, points, num_points):
        pp = self.pp
        ppm = PIXELS_PER_METER
        nx = int((pp.max_x - pp.min_x) * ppm)
        ny = int((pp.max_y - pp.min_y) * ppm)
        cells = nx * ny
        b, n, _ = points.shape
        x, y = points[..., 0], points[..., 1]
        idx = torch.arange(n, device=points.device)
        valid = ((x >= pp.min_x) & (x < pp.max_x) & (y >= pp.min_y)
                 & (y < pp.max_y) & (idx[None] < num_points.reshape(-1, 1)))
        cx = torch.floor((x - pp.min_x) * ppm).to(torch.int32)
        cy = torch.floor((y - pp.min_y) * ppm).to(torch.int32)
        cell = cy.clamp(0, ny - 1) * nx + cx.clamp(0, nx - 1)
        cell = torch.where(valid, cell, cells).to(torch.int32)
        off = torch.arange(b, device=points.device,
                           dtype=torch.int32) * (cells + 1)
        ids = (cell + off[:, None]).reshape(-1)
        # 9-feature decoration: xyzi, offset from the pillar's mean,
        # offset from the pillar's centre
        xyz = points[..., :3]
        masked = torch.where(valid[..., None], xyz, torch.zeros_like(xyz))
        means = segment_mean(masked.reshape(b * n, 3), ids, b * (cells + 1))
        cluster = xyz - means.index_select(0, ids).reshape(b, n, 3)
        ccx = (cell % nx).to(points.dtype) / ppm + pp.min_x
        ccy = torch.div(cell, nx, rounding_mode="floor").to(points.dtype) \
            / ppm + pp.min_y
        feats = torch.cat([points, cluster, xyz[..., 0:1] - ccx[..., None],
                           xyz[..., 1:2] - ccy[..., None]], dim=-1)
        feats = torch.where(valid[..., None], feats, torch.zeros_like(feats))
        h = feats.reshape(b * n, -1)
        keep = valid.reshape(b * n, 1)
        net = self.point_net.net
        for i in range(0, len(net), 3):
            h = torch.relu(net[i + 1](net[i](h)))
            h = torch.where(keep, h, torch.zeros_like(h))
        h = h.masked_fill(~keep, NEG_INF)
        pooled = _SegmentMax.apply(h, ids, b * (cells + 1))
        canvas = pooled.reshape(b, cells + 1, -1)[:, :-1]
        return canvas.reshape(b, ny, nx, -1).flip(1)


# ----------------------------------------------------------------- model

BACKBONES = {"transFuser": TransfuserBackbone}


class LidarCenterNet(nn.Module):
    """forward(...) -> pred_wp (B, pred_len, 2) and the seven NHWC head
    maps, with ``compute_aux`` the BEV, semantic and depth maps.
    ``backbones`` maps the configuration's ``backbone`` to its class,
    which builds its trunks from ``trunks``."""

    def __init__(self, cfg, trunks, backbones):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        pp = m.point_pillars
        lidar_ch = pp.num_features[-1] if pp.use_point_pillars \
            else 2 * m.lidar_seq_len
        lidar_ch += int(m.use_target_point_image)
        if m.backbone not in backbones:
            raise ValueError(
                f"the reference has no backbone {m.backbone!r}; a module "
                "bench_port/reference/<name>.py adds one by passing "
                "backbones= to model.build")
        self._model = backbones[m.backbone](cfg, lidar_ch, trunks)
        feats = m.perception_output_features
        if m.multitask:
            args = (feats, m.deconv_channel_num_1, m.deconv_channel_num_2,
                    m.deconv_channel_num_3)
            scales = (m.deconv_scale_factor_1, m.deconv_scale_factor_2)
            self.seg_decoder = Deconv(*args, m.num_class, *scales)
            self.depth_decoder = Deconv(*args, 1, *scales)
        ch = m.centernet.channel
        bev_ch = cfg.bev.bev_features_channels
        self.pred_bev = nn.Sequential(Conv2d(bev_ch, ch, 3, 1, 1), nn.ReLU(),
                                      Conv2d(ch, cfg.bev.bev_num_classes, 1))
        self.head = Head(bev_ch, ch, m.centernet.num_classes,
                         m.centernet.num_dir_bins)
        self.join = nn.Sequential(Linear(feats, 256), nn.ReLU(),
                                  Linear(256, 128), nn.ReLU(),
                                  Linear(128, m.gru_hidden_size), nn.ReLU())
        self.decoder = nn.GRUCell(4 if m.gru_concat_target_point else 2,
                                  m.gru_hidden_size)
        self.output = Linear(m.gru_hidden_size, 3)
        for layer in (self.join[0], self.join[2], self.join[4], self.output):
            layer.island = True
        if pp.use_point_pillars:
            self.point_pillar_net = PointPillarNet(pp)

    def forward(self, rgb, lidar, target_point, target_point_image=None,
                velocity=None, num_points=None, compute_aux=False, gen=None):
        cfg = self.cfg
        m = cfg.model
        if m.point_pillars.use_point_pillars:
            canvas = self.point_pillar_net(lidar, num_points)
            lid = to_nchw(torch.rot90(canvas, k=-1, dims=(1, 2)))
        else:
            lid = to_nchw(lidar)
        if m.use_target_point_image:
            lid = torch.cat([lid, to_nchw(target_point_image)], 1)
        pyramid, image_grid, fused = self._model(to_nchw(rgb), lid, velocity,
                                                 gen)
        # waypoint GRU (fp32 island)
        z = self.join(fused)
        tp = target_point * torch.tensor([1.0, -1.0], device=z.device)
        x = torch.zeros((z.shape[0], 2), device=z.device)
        wps = []
        for _ in range(m.pred_len):
            x_in = torch.cat([x, tp], -1) if m.gru_concat_target_point else x
            z = self.decoder(x_in, z)
            x = self.output(z)[:, :2] + x
            wps.append(x)
        pred_wp = torch.stack(wps, 1) - torch.tensor(
            [cfg.sensors.lidar_pos[0], 0.0], device=z.device)
        out = {"pred_wp": pred_wp}
        for name, v in self.head(pyramid[0]).items():
            out[f"head_{name}"] = to_nhwc(v)
        if compute_aux:
            out["pred_bev"] = to_nhwc(resize_bilinear(
                self.pred_bev(pyramid[0]),
                (cfg.bev.bev_resolution_height, cfg.bev.bev_resolution_width),
                align_corners=True))
            if m.multitask:
                out["pred_semantic"] = to_nhwc(self.seg_decoder(image_grid))
                out["pred_depth"] = torch.sigmoid(
                    self.depth_decoder(image_grid)[:, 0])
        return out

    @torch.no_grad()
    def forward_ego(self, rgb, lidar, target_point, target_point_image=None,
                    velocity=None, num_points=None):
        """Eval-mode waypoints and the decoded top-k boxes (B, k, 8)."""
        was = self.training
        self.eval()
        try:
            out = self(rgb, lidar, target_point, target_point_image,
                       velocity, num_points)
        finally:
            self.train(was)
        c = self.cfg.model.centernet
        boxes = decode_heatmap(out, c.top_k_center_keypoints,
                               c.center_net_max_pooling_kernel,
                               c.num_dir_bins)
        return out["pred_wp"], boxes


def decode_heatmap(out, k, kernel, num_dir_bins, ratio=4.0):
    """Top-k peaks of the heatmap (stable sort: ties lowest index first)
    -> (B, k, 8) [x, y, w, h, yaw, velocity, brake, score]."""
    heatmap = out["head_heatmap"]
    bsz, h, w, _ = heatmap.shape
    pad = (kernel - 1) // 2
    hmax = to_nhwc(F.max_pool2d(to_nchw(heatmap), kernel, 1, pad))
    heat = torch.where(hmax == heatmap, heatmap, torch.zeros_like(heatmap))
    flat = to_nchw(heat).reshape(bsz, -1)
    scores, order = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, inds = scores[:, :k], order[:, :k]
    pix = inds % (h * w)
    ys = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def gather(name):
        f = out[name].reshape(bsz, h * w, -1)
        return torch.gather(f, 1, pix[..., None].expand(-1, -1, f.shape[-1]))

    wh, off = gather("head_wh"), gather("head_offset")
    yaw_cls = torch.argmax(gather("head_yaw_class"), dim=-1)
    yaw = yaw_cls.to(torch.float32) * (2.0 * math.pi / num_dir_bins) \
        + gather("head_yaw_res")[..., 0]
    yaw = torch.where(yaw > math.pi, yaw - 2.0 * math.pi, yaw)
    brake = torch.argmax(gather("head_brake"), dim=-1).to(torch.float32)
    return torch.stack([
        (xs + off[..., 0]) * ratio, (ys + off[..., 1]) * ratio,
        wh[..., 0] * ratio, wh[..., 1] * ratio, yaw,
        gather("head_velocity")[..., 0], brake, scores], dim=-1)


def build(cfg: SimpleNamespace, device="cpu", trunks=TRUNK_FACTORIES,
          backbones=BACKBONES) -> LidarCenterNet:
    """The reference model with empty weights on ``device`` ("meta" for
    shapes and FLOPs); load a state dict before use. ``trunks`` and
    ``backbones``: the tables the configuration's architecture and
    backbone names are looked up in (another reference module passes its
    own, this module's entries included)."""
    with torch.device(device):
        model = LidarCenterNet(cfg, trunks, backbones)
    return model.eval()


def seed_rules(model: nn.Module):
    """The seeded-weight rules (``weights.py``: key -> (kind, value)) of
    the leaves that only this module's classes hold: the GPTs' position
    embeddings start at zero, as the configuration initialises them."""
    return {f"{name}.pos_emb": ("zero", 0.0)
            for name, m in model.named_modules() if isinstance(m, GPTFusion)}
