"""EMA-VFI, stage-3 2x frame interpolation (counterpart of
``streamingt2v_tpu/models/vfi.py``).

A MotionFormer appearance + motion feature pyramid with windowed
inter-frame attention, two coarse-to-fine flow heads with PixelShuffle
upsampling, backward warping (``ops/warp.py``) and a residual refinement
UNet, with the reference's flip-TTA averaging (``interpolate_pair``).

Layout: channel-last (N, H, W, C); the two frames are stacked along the
batch as (img0s ‖ img1s).  Images are in [0, 1].  Parameter names are the
flax paths (``feature_bone.block_3_0.attn.q.kernel``); the network runs in
f32, as the JAX package runs it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.config import VFIConfig
from streamingt2v_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    norm_pair,
    norm_params,
    prelu,
    prelu_param,
)
from streamingt2v_torch.ops.norms import layer_norm
from streamingt2v_torch.ops.warp import backward_warp


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, H, W, C*f^2) -> (N, H*f, W*f, C), in torch PixelShuffle's channel
    order (out-channel slowest, then fy, fx)."""
    n, h, w, c = x.shape
    oc = c // (factor * factor)
    x = x.reshape(n, h, w, oc, factor, factor).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * factor, w * factor, oc)


def resize_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear to (int(H*scale), int(W*scale)) with half-pixel centres and
    no antialiasing (torch ``F.interpolate(align_corners=False)``)."""
    n, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(int(h * scale), int(w * scale)),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class ConvPReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.conv = Conv(cin, features, kernel, stride=stride,
                         padding=(kernel // 2) * dilation, dilation=dilation, **fk)
        prelu_param(self, "prelu", features, **fk)

    def forward(self, x):
        return prelu(self.conv(x), self.prelu)


class ConvBlock(nn.Module):
    """depth x (conv3x3 + PReLU)."""

    def __init__(self, cin: int, features: int, depth: int, **fk):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", ConvPReLU(cin if i == 0 else features, features, **fk))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"layer_{i}")(x)
        return x


# ---------------------------------------------------------------------------
# windowed inter-frame attention
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, ws: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws0*ws1, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws[0] * ws[1], c)


def window_reverse(windows: torch.Tensor, ws: Tuple[int, int], h: int, w: int) -> torch.Tensor:
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws[0] // ws[1])
    x = windows.reshape(b, h // ws[0], w // ws[1], ws[0], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _center_pad_hw(h: int, w: int, ws: Tuple[int, int]):
    ph = math.ceil(h / ws[0]) * ws[0] - h
    pw = math.ceil(w / ws[1]) * ws[1] - w
    return ph, pw


def _window_masks(h: int, w: int, ws: Tuple[int, int], shift: Tuple[int, int],
                  pad: Tuple[int, int]) -> Optional[np.ndarray]:
    """Swin-style additive attention masks (nW, N, N) for centre padding
    and/or a cyclic shift, or None when neither applies."""
    ph, pw = pad
    hp, wp = h + ph, w + pw
    if ph == 0 and pw == 0 and shift == (0, 0):
        return None
    region = np.zeros((hp, wp), np.int32)
    cnt = 0
    if ph > 0 or pw > 0:
        h_sl = [(0, ph // 2), (ph // 2, h + ph // 2), (h + ph // 2, hp)]
        w_sl = [(0, pw // 2), (pw // 2, w + pw // 2), (w + pw // 2, wp)]
        for (h0, h1) in h_sl:
            for (w0, w1) in w_sl:
                region[h0:h1, w0:w1] = cnt
                cnt += 1
    if shift != (0, 0):
        shift_region = np.zeros((hp, wp), np.int32)
        cnt = 0
        h_sl = [(0, hp - ws[0]), (hp - ws[0], hp - shift[0]), (hp - shift[0], hp)]
        w_sl = [(0, wp - ws[1]), (wp - ws[1], wp - shift[1]), (wp - shift[1], wp)]
        for (h0, h1) in h_sl:
            for (w0, w1) in w_sl:
                shift_region[h0:h1, w0:w1] = cnt
                cnt += 1
        # the pad-region map rolled with the shift, paired with the shift map
        region = np.roll(region, (-shift[0], -shift[1]), axis=(0, 1)) * 16 + shift_region
    m = region.reshape(hp // ws[0], ws[0], wp // ws[1], ws[1]).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws[0] * ws[1])
    return (m[:, None, :] != m[:, :, None]).astype(np.float32) * -100.0


class InterFrameAttention(nn.Module):
    """Windowed cross-frame attention and motion features: q from x1, k/v
    from x2 (the other frame's windows); motion = proj(P @ cor_embed -
    cor_embed).  The probabilities P serve both products, so they are
    formed explicitly (f32 softmax) rather than inside a fused attention."""

    def __init__(self, dim: int, motion_dim: int, heads: int, **fk):
        super().__init__()
        self.heads = heads
        self.motion_dim = motion_dim
        self.q = Dense(dim, dim, **fk)
        self.kv = Dense(dim, 2 * dim, **fk)
        self.cor_embed = Dense(2, motion_dim, **fk)
        self.motion_proj = Dense(motion_dim, motion_dim, **fk)
        self.proj = Dense(dim, dim, **fk)

    def forward(self, x1, x2, cor, mask: Optional[torch.Tensor] = None):
        b, n, c = x1.shape
        hd = c // self.heads
        q = self.q(x1)
        k, v = self.kv(x2).chunk(2, dim=-1)
        cor_embed = self.cor_embed(cor)

        def heads_of(t, d):
            return t.reshape(b, n, self.heads, d).transpose(1, 2)

        qh, kh, vh = heads_of(q, hd), heads_of(k, hd), heads_of(v, hd)
        ch = heads_of(cor_embed, self.motion_dim // self.heads)
        attn = torch.matmul(qh, kh.transpose(-1, -2)).float() * (hd ** -0.5)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, self.heads, n, n) + mask[None, :, None])
            attn = attn.reshape(b, self.heads, n, n)
        p = torch.softmax(attn, dim=-1).to(vh.dtype)
        x = torch.matmul(p, vh).transpose(1, 2).reshape(b, n, c)
        c_rev = torch.matmul(p, ch).transpose(1, 2).reshape(b, n, -1)
        motion = self.motion_proj(c_rev - cor_embed)
        return self.proj(x), motion


class MotionFormerBlock(nn.Module):
    def __init__(self, dim: int, motion_dim: int, heads: int, window_size: int, shift: bool,
                 mlp_ratio: int = 4, **fk):
        super().__init__()
        self.ws = (window_size, window_size)
        self.shift = (window_size // 2, window_size // 2) if shift else (0, 0)
        norm_params(self, "norm1", dim, **fk)
        self.attn = InterFrameAttention(dim, motion_dim, heads, **fk)
        norm_params(self, "norm2", dim, **fk)
        hidden = dim * mlp_ratio
        self.mlp_fc1 = Dense(dim, hidden, **fk)
        self.mlp_dwconv = Conv(hidden, hidden, 3, groups=hidden, **fk)
        self.mlp_fc2 = Dense(hidden, dim, **fk)

    def forward(self, x, cor, h: int, w: int):
        """x: (2B, H*W, C); cor: (2B, H*W, 2) normalized coordinates."""
        ws, shift = self.ws, self.shift
        ph, pw = _center_pad_hw(h, w, ws)
        mask_np = _window_masks(h, w, ws, shift, (ph, pw))
        mask = None if mask_np is None else torch.from_numpy(mask_np).to(x.device)

        pad = (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
        x_pad = F.pad(x.reshape(-1, h, w, x.shape[-1]), pad)
        cor_pad = F.pad(cor.reshape(-1, h, w, 2), pad)
        if shift != (0, 0):
            x_pad = torch.roll(x_pad, (-shift[0], -shift[1]), dims=(1, 2))
            cor_pad = torch.roll(cor_pad, (-shift[0], -shift[1]), dims=(1, 2))
        hp, wp = x_pad.shape[1:3]

        x_win = window_partition(x_pad, ws)
        cor_win = window_partition(cor_pad, ws)
        nwb = x_win.shape[0]
        x_norm = layer_norm(x_win, *norm_pair(self, "norm1"), eps=1e-6)
        # swap the frame halves so that each frame attends to the other
        x_rev = torch.cat([x_norm[nwb // 2:], x_norm[:nwb // 2]], dim=0)
        x_app, x_motion = self.attn(x_norm, x_rev, cor_win, mask)
        x_norm = x_norm + x_app

        back = window_reverse(x_norm, ws, hp, wp)
        motion = window_reverse(x_motion, ws, hp, wp)
        if shift != (0, 0):
            back = torch.roll(back, shift, dims=(1, 2))
            motion = torch.roll(motion, shift, dims=(1, 2))
        back = back[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w].reshape(x.shape)
        motion = motion[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w].reshape(x.shape[0], h * w, -1)

        hmlp = self.mlp_fc1(layer_norm(back, *norm_pair(self, "norm2"), eps=1e-6))
        hmlp = self.mlp_dwconv(hmlp.reshape(-1, h, w, hmlp.shape[-1])).reshape(hmlp.shape)
        hmlp = F.gelu(hmlp.float()).to(hmlp.dtype)
        return back + self.mlp_fc2(hmlp), motion


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, embed_dim: int, patch: int = 3, stride: int = 2, **fk):
        super().__init__()
        self.proj = Conv(cin, embed_dim, patch, stride=stride, padding=patch // 2, **fk)
        norm_params(self, "norm", embed_dim, **fk)

    def forward(self, x):
        x = self.proj(x)
        n, h, w, c = x.shape
        return layer_norm(x.reshape(n, h * w, c), *norm_pair(self, "norm"), eps=1e-6), h, w


class CrossScalePatchEmbed(nn.Module):
    """Merge the conv pyramid into one token map by dilated strided convs."""

    def __init__(self, in_dims: Sequence[int], embed_dim: int, **fk):
        super().__init__()
        base = in_dims[0]
        self.taps = []      # (pyramid level counted from the top, stride, dilation)
        for i in range(len(in_dims)):
            for j in range(2 ** i):
                k = len(self.taps)
                self.add_module(f"layer_{k}", Conv(in_dims[-1 - i], base, 3, stride=2 ** (i + 1),
                                                   padding=1 + j, dilation=1 + j, **fk))
                self.taps.append(i)
        self.proj = Conv(base * len(self.taps), embed_dim, 1, **fk)
        norm_params(self, "norm", embed_dim, **fk)

    def forward(self, xs: Sequence[torch.Tensor]):
        ys = [getattr(self, f"layer_{k}")(xs[-1 - i]) for k, i in enumerate(self.taps)]
        x = self.proj(torch.cat(ys, dim=-1))
        n, h, w, c = x.shape
        return layer_norm(x.reshape(n, h * w, c), *norm_pair(self, "norm"), eps=1e-6), h, w


class MotionFormer(nn.Module):
    """Appearance + motion feature pyramid of (img0 ‖ img1)."""

    def __init__(self, cfg: VFIConfig, **fk):
        super().__init__()
        self.cfg = cfg
        num_stages = len(cfg.embed_dims)
        self.conv_stages = num_stages - len(cfg.num_heads)
        cin = 3
        for i in range(num_stages):
            dim = cfg.embed_dims[i]
            if i < self.conv_stages:
                if i > 0:
                    self.add_module(f"patch_embed_{i}_conv",
                                    Conv(cin, dim, 3, stride=2, padding=1, **fk))
                    prelu_param(self, f"patch_embed_{i}_prelu", dim, **fk)
                    cin = dim
                self.add_module(f"block_{i}", ConvBlock(cin, dim, cfg.depths[i], **fk))
            else:
                s = i - self.conv_stages
                embed = (CrossScalePatchEmbed(cfg.embed_dims[:i], dim, **fk) if s == 0
                         else OverlapPatchEmbed(cin, dim, **fk))
                self.add_module(f"patch_embed_{i}", embed)
                for j in range(cfg.depths[i]):
                    self.add_module(f"block_{i}_{j}", MotionFormerBlock(
                        dim, cfg.motion_dims[i], cfg.num_heads[s], cfg.window_sizes[s],
                        shift=(j % 2 == 1), **fk))
                norm_params(self, f"norm_{i}", dim, **fk)
            cin = dim

    def forward(self, img0, img1):
        cfg = self.cfg
        x = torch.cat([img0, img1], dim=0)
        appearance: List[torch.Tensor] = []
        motion: List[Optional[torch.Tensor]] = []
        for i in range(len(cfg.embed_dims)):
            if i < self.conv_stages:
                if i > 0:
                    x = prelu(getattr(self, f"patch_embed_{i}_conv")(x),
                              getattr(self, f"patch_embed_{i}_prelu"))
                x = getattr(self, f"block_{i}")(x)
                appearance.append(x)
                motion.append(None)
                continue
            embed = getattr(self, f"patch_embed_{i}")
            x, h, w = embed(appearance) if i == self.conv_stages else embed(x)
            # normalized coordinate grid (x, y) in [-1, 1]
            cx = np.linspace(-1, 1, w, dtype=np.float32)
            cy = np.linspace(-1, 1, h, dtype=np.float32)
            cor = np.stack(np.meshgrid(cx, cy), axis=-1).reshape(1, h * w, 2)
            cor = torch.from_numpy(cor).to(x.device, x.dtype).expand(x.shape[0], h * w, 2)
            motions = []
            for j in range(cfg.depths[i]):
                x, m = getattr(self, f"block_{i}_{j}")(x, cor, h, w)
                motions.append(m.reshape(x.shape[0], h, w, -1))
            x = layer_norm(x, *norm_pair(self, f"norm_{i}"), eps=1e-6).reshape(x.shape[0], h, w, -1)
            appearance.append(x)
            motion.append(torch.cat(motions, dim=-1))
        return appearance, motion


class FlowHead(nn.Module):
    """Coarse-to-fine flow (4 channels: both frames' flows) and mask head."""

    def __init__(self, cin: int, scale: int, hidden: int, **fk):
        super().__init__()
        self.scale = scale
        self.conv_0 = ConvPReLU(cin, hidden, **fk)
        self.conv_1 = ConvPReLU(hidden, hidden, **fk)
        self.conv_2 = ConvPReLU(hidden, 5, **fk)

    def forward(self, motion_feature, x, flow):
        mf = pixel_shuffle(pixel_shuffle(motion_feature, 2), 2)
        if self.scale != 4:
            x = resize_bilinear(x, 4.0 / self.scale)
        if flow is not None:
            if self.scale != 4:
                flow = resize_bilinear(flow, 4.0 / self.scale) * (4.0 / self.scale)
            x = torch.cat([x, flow], dim=-1)
        h = self.conv_2(self.conv_1(self.conv_0(torch.cat([mf, x], dim=-1))))
        if self.scale != 4:
            h = resize_bilinear(h, self.scale / 4.0)
            return h[..., :4] * (self.scale // 4), h[..., 4:5]
        return h[..., :4], h[..., 4:5]


class RefineUnet(nn.Module):
    """Residual refinement UNet over the images, their warps, the mask, the
    flow and the warped feature pyramids."""

    def __init__(self, c: int, embed_dims: Sequence[int], **fk):
        super().__init__()
        e = embed_dims
        cin = 3 * 4 + 1 + 4 + 2 * e[0]
        for k, feats in enumerate((2 * c, 4 * c, 8 * c, 16 * c)):
            if k > 0:
                cin += 2 * e[k]
            self.add_module(f"down{k}_0", ConvPReLU(cin, feats, stride=2, **fk))
            self.add_module(f"down{k}_1", ConvPReLU(feats, feats, **fk))
            cin = feats
        ups = ((16 * c + 2 * e[4], 8 * c), (16 * c, 4 * c), (8 * c, 2 * c), (4 * c, c))
        for k, (cin, feats) in enumerate(ups):
            self.add_module(f"up{k}_deconv", ConvTranspose(cin, feats, 4, stride=2, **fk))
            prelu_param(self, f"up{k}_prelu", feats, **fk)
        self.conv = Conv(c, 3, 3, **fk)

    def _down(self, k, x):
        return getattr(self, f"down{k}_1")(getattr(self, f"down{k}_0")(x))

    def _up(self, k, x):
        return prelu(getattr(self, f"up{k}_deconv")(x), getattr(self, f"up{k}_prelu"))

    def forward(self, img0, img1, w0, w1, mask, flow, c0, c1):
        s0 = self._down(0, torch.cat([img0, img1, w0, w1, mask, flow, c0[0], c1[0]], -1))
        s1 = self._down(1, torch.cat([s0, c0[1], c1[1]], -1))
        s2 = self._down(2, torch.cat([s1, c0[2], c1[2]], -1))
        s3 = self._down(3, torch.cat([s2, c0[3], c1[3]], -1))
        x = self._up(0, torch.cat([s3, c0[4], c1[4]], -1))
        x = self._up(1, torch.cat([x, s2], -1))
        x = self._up(2, torch.cat([x, s1], -1))
        x = self._up(3, torch.cat([x, s0], -1))
        return torch.sigmoid(self.conv(x))


class MultiScaleFlow(nn.Module):
    """The full EMA-VFI network."""

    def __init__(self, cfg: VFIConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.feature_bone = MotionFormer(cfg, **fk)
        last = len(cfg.embed_dims) - 1
        for i in range(len(cfg.hidden_dims)):
            s = last - i
            cin = 2 * (cfg.motion_dims[s] * cfg.depths[s] + cfg.embed_dims[s]) // 16
            cin += 6 if i == 0 else 17      # img0, img1 (+ warps, mask, flow)
            self.add_module(f"head_{i}", FlowHead(cin, cfg.scales[-1 - i],
                                                  cfg.hidden_dims[-1 - i], **fk))
        self.unet = RefineUnet(cfg.embed_dims[0] * 2, cfg.embed_dims, **fk)

    def calculate_flow(self, img0, img1, timestep: float = 0.5, af=None, mf=None):
        """Coarse-to-fine flow (B, H, W, 4) and mask logits (B, H, W, 1);
        the features may be given (hr and multi inference)."""
        b = img0.shape[0]
        if af is None or mf is None:
            af, mf = self.feature_bone(img0, img1)
        flow = mask = None
        warped0, warped1 = img0, img1
        for i in range(len(self.cfg.hidden_dims)):
            mfi, afi = mf[-1 - i], af[-1 - i]
            motion_feat = torch.cat([timestep * mfi[:b], (1 - timestep) * mfi[b:],
                                     afi[:b], afi[b:]], dim=-1)
            head = getattr(self, f"head_{i}")
            if flow is not None:
                x_in = torch.cat([img0, img1, warped0, warped1, mask], dim=-1)
                flow_d, mask_d = head(motion_feat, x_in, flow)
                flow = flow + flow_d
                mask = mask + mask_d
            else:
                flow, mask = head(motion_feat, torch.cat([img0, img1], dim=-1), None)
            warped0 = backward_warp(img0, flow[..., 0:2])
            warped1 = backward_warp(img1, flow[..., 2:4])
        return flow, mask

    def warp_and_refine(self, img0, img1, af, flow, mask):
        b = img0.shape[0]
        warped0 = backward_warp(img0, flow[..., 0:2])
        warped1 = backward_warp(img1, flow[..., 2:4])
        c0, c1 = [], []
        fl = flow
        for feat in af[:len(self.cfg.embed_dims)]:
            c0.append(backward_warp(feat[:b], fl[..., 0:2]))
            c1.append(backward_warp(feat[b:], fl[..., 2:4]))
            fl = resize_bilinear(fl, 0.5) * 0.5
        res = self.unet(img0, img1, warped0, warped1, mask, flow, c0, c1) * 2.0 - 1.0
        m = torch.sigmoid(mask)
        merged = warped0 * m + warped1 * (1 - m)
        return (merged + res).clamp(0.0, 1.0)

    def hr_forward(self, img0, img1, timestep: float = 0.5, down_scale: float = 0.5):
        """Flow at ``down_scale``, refinement at full resolution."""
        flow, mask = self.calculate_flow(resize_bilinear(img0, down_scale),
                                         resize_bilinear(img1, down_scale), timestep)
        flow = resize_bilinear(flow, 1.0 / down_scale) * (1.0 / down_scale)
        mask = resize_bilinear(mask, 1.0 / down_scale)
        af, _ = self.feature_bone(img0, img1)
        return self.warp_and_refine(img0, img1, af, flow, mask)

    def multi_forward(self, img0, img1, time_list):
        """One backbone pass, one prediction per timestep."""
        af, mf = self.feature_bone(img0, img1)
        return [self.warp_and_refine(img0, img1, af, *self.calculate_flow(img0, img1, t, af, mf))
                for t in time_list]

    def forward(self, img0, img1, timestep: float = 0.5):
        af, mf = self.feature_bone(img0, img1)
        flow, mask = self.calculate_flow(img0, img1, timestep, af, mf)
        return self.warp_and_refine(img0, img1, af, flow, mask)


def interpolate_pair(model: MultiScaleFlow, img0: torch.Tensor, img1: torch.Tensor,
                     timestep: float = 0.5, tta: bool = True) -> torch.Tensor:
    """The frame at ``timestep`` between img0 and img1 (B, H, W, 3) in [0, 1];
    with ``tta`` the mean of the plain prediction and the unflipped
    prediction on the flipped pair."""
    if not tta:
        return model(img0, img1, timestep)
    flip = lambda x: torch.flip(x, dims=(1, 2))  # noqa: E731
    b = img0.shape[0]
    pred = model(torch.cat([img0, flip(img0)]), torch.cat([img1, flip(img1)]), timestep)
    return (pred[:b] + flip(pred[b:])) / 2.0
