"""VideoUNet building blocks (counterpart of
``streamingt2v_tpu/models/unet_blocks.py``), channel-last.

  - ``FeedForward`` (GEGLU), ``CrossAttention``, ``APMContextMixer``,
    ``BasicTransformerBlock``
  - ``VideoTransformerBlock`` (temporal transformer)
  - ``SpatialVideoTransformer`` (spatial + temporal pair, AlphaBlender)
  - ``UNetResBlock``, ``TemporalUNetResBlock``, ``UNetVideoResBlock``
  - UNet ``Downsample`` / ``Upsample``

Layouts: 5-D activations (B, T, H, W, C); spatial modules fold T into the
batch, the temporal transformer keeps the spatial-major (B*T, S, C) layout
and hands its attention q/k/v in that layout to ``ops.temporal_attention``.
The kernels enter here: the GEGLU FF (K3) from ``FeedForward``, the temporal
conv (K4) from ``_time_conv``, flash attention (K1, or K2 under the
``flash_packed`` routing) through the attention dispatcher, and K6 (under
the ``temporal_attention`` routing) from the temporal self-attentions, each
only for tensors on a CUDA device and inside its gate.

Under a mesh (``parallel/sharding.py``): ``shard_params`` splits the
tensor-parallel units (``FeedForward``, ``CrossAttention`` by heads, the
transformer's ``proj_in``), each of which then computes its part and
reduces (or gathers) over ``model``; ``SpatialVideoTransformer`` splits its
tokens over ``seq`` after ``proj_in`` and gathers them before
``proj_out``, its spatial self-attentions going around the seq ring, and
names the parameters used in between (``seq_partial_parameters``), whose
gradients the training step sums over seq.

``UNetVideoResBlock`` and ``SpatialVideoTransformer`` built with
``use_checkpoint`` recompute their activations in the backward
(``torch.utils.checkpoint``, non-reentrant) whenever grad is on: the
blocks the JAX package wraps in ``nn.remat`` under the same flag
(``streamingt2v_tpu/models/video_unet.py:93-99``).  Inference is unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from streamingt2v_torch.models.layers import (
    Conv, Conv1D, Dense, TimeConv, _param, norm_pair, norm_params, silu_f32)
from streamingt2v_torch.ops import (
    alpha_blend, attention, group_norm, layer_norm, timestep_embedding)
from streamingt2v_torch.ops.fused_ff import geglu_ff
from streamingt2v_torch.ops.norms import group_norm_affine
from streamingt2v_torch.ops.temporal_attention import temporal_attention
from streamingt2v_torch.ops.temporal_conv import fits_temporal_conv, temporal_conv
from streamingt2v_torch.parallel.mesh import AXIS_MODEL, AXIS_SEQ
from streamingt2v_torch.parallel.sharding import (
    copy_to, copy_to_model, gather_dim, get_active_mesh, reduce_from_model, seq_partial,
    shard_dim, split_over)
from streamingt2v_torch.utils.profiling import span


class FeedForward(nn.Module):
    """GEGLU feed-forward: proj to 2*inner, a * gelu(b), project back.  On
    a CUDA device, at >= 256 rows and inner % 128 == 0 (the JAX package's
    Pallas gate), the whole pre-LN residual block is one K3 launch.

    Split by ``shard_params`` (``tp``), each model rank holds matching
    column blocks of a and b and the rows of W2 for them, computes LN on
    the whole x and its partial output (K3 on its own inner width; the
    residual and b2 on model rank 0 only), and the partials are summed."""

    def __init__(self, dim: int, dim_out: int, mult: int = 4, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = dim * mult
        self.proj = Dense(dim, inner * 2, **fk)
        self.out = Dense(inner, dim_out, **fk)
        self.tp = None

    def tp_divides(self, m: int) -> bool:
        return self.out.kernel.shape[1] % m == 0

    @span("st2v.ff")
    def forward(self, x: torch.Tensor, ln=None, residual: bool = False) -> torch.Tensor:
        if self.tp is None:
            return self._ff(x, ln, residual, self.out.bias, 1)
        mesh = self.tp
        m = mesh.shape[AXIS_MODEL]
        first = mesh.axis_index(AXIS_MODEL) == 0
        # the replicated operands (x, the LN affine, b2) enter every rank's
        # partial: their gradients are the sum of the ranks' (copy_to_model)
        if ln is not None:
            ln = (copy_to_model(ln[0], mesh), copy_to_model(ln[1], mesh))
        b2 = copy_to_model(self.out.bias, mesh)
        if not first:
            b2 = b2 * 0.0
        y = self._ff(copy_to_model(x, mesh), ln, residual and first, b2, m)
        return reduce_from_model(y, mesh)

    def _ff(self, x, ln, residual: bool, b2, m: int) -> torch.Tensor:
        """x + (a * gelu(b)) W2 + b2 on this rank's inner width (the gate
        reads the whole width, inner * m)."""
        if x.is_cuda and _k3_geometry(x, self, m):
            return geglu_ff(
                x.contiguous(), self.proj.kernel.to(x.dtype), self.proj.bias.float(),
                self.out.kernel.to(x.dtype), b2.float().contiguous(),
                ln_scale=None if ln is None else ln[0].float(),
                ln_bias=None if ln is None else ln[1].float(),
                residual=residual)
        x_in = x
        if ln is not None:
            x = layer_norm(x, ln[0], ln[1])
        a, b = self.proj(x).chunk(2, dim=-1)
        # exact (erf) GELU in f32
        h = self.out.apply_bias(a * F.gelu(b.float()).to(b.dtype), b2)
        return x_in + h if residual else h


def _k3_geometry(x: torch.Tensor, ff: FeedForward, m: int) -> bool:
    """Whether ``FeedForward._ff`` sends x to K3 on a CUDA device: the JAX
    package's Pallas gate, >= 256 rows and the whole inner width (``m``
    model ranks of this rank's) a multiple of 128."""
    return x.numel() // x.shape[-1] >= 256 and (ff.out.kernel.shape[1] * m) % 128 == 0


class CrossAttention(nn.Module):
    """q/k/v projections (no bias) + output projection; self-attention when
    context is None.  ``frames=(batch, T)`` makes it a self-attention over
    the frame axis of a spatial-major (B*T, S, C) input, computed on that
    layout by ``ops.temporal_attention``.

    Split by ``shard_params`` (``tp``, whole heads only), each model rank
    projects its heads' q/k/v, attends over them, and sums its part of the
    output projection with the other ranks' before the bias."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        ctx = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, **fk)
        self.to_k = Dense(ctx, inner, bias=False, **fk)
        self.to_v = Dense(ctx, inner, bias=False, **fk)
        self.to_out = Dense(inner, query_dim, **fk)
        self.tp = None

    def tp_divides(self, m: int) -> bool:
        return self.heads % m == 0

    def _project_out(self, o: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.to_out(o)
        y = reduce_from_model(self.to_out.apply_bias(o, None), self.tp)
        return y + self.to_out.bias.to(y.dtype)

    @span("st2v.attention")
    def forward(self, x, context=None, frames: Optional[Tuple[int, int]] = None):
        if self.tp is not None:
            x, context = copy_to_model(x, self.tp), copy_to_model(context, self.tp)
            with split_over(AXIS_MODEL):
                return self._attend(x, context, frames)
        return self._attend(x, context, frames)

    def _attend(self, x, context, frames):
        heads = self.to_q.kernel.shape[0] // self.dim_head      # this rank's heads
        if frames is not None:
            b, t = frames
            # the projections go as temporaries, so that the op's plain
            # version frees them once it has folded them
            return self._project_out(temporal_attention(
                self.to_q(x), self.to_k(x), self.to_v(x), batch=b, frames_q=t, frames_kv=t,
                num_heads=heads))
        if context is not None and context.shape[1] == 1:
            # one key: the softmax is exactly 1, so the output is v for
            # every query (the SVD pooled-CLIP context)
            out = self._project_out(self.to_v(context))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        return self._project_out(attention(q, k, v, num_heads=heads,
                                           over_tokens=context is None))


class APMContextMixer(nn.Module):
    """Appearance Preservation Module context mixing: the ``n_tokens`` APM
    context (the SVD pooled token and one CLIP token per anchor frame) is
    mixed by a width-3 conv over the embedding axis with the tokens as
    in-channels, layer-normed, and gated into the first token by
    silu(``apm_alpha``) (zero at init, so the mixer starts as the identity on
    the first token).  A one-token context passes through."""

    def __init__(self, n_tokens: int, dim: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.apm_conv = Conv1D(n_tokens, 1, 3, **fk)
        norm_params(self, "apm_ln", dim, **fk)
        self.apm_alpha = _param((), device, dtype)

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        if context.shape[1] <= 1:
            return context
        mixed = layer_norm(self.apm_conv(context), *norm_pair(self, "apm_ln"))  # (B, 1, D)
        gate = F.silu(self.apm_alpha.float()).to(context.dtype)
        return context[:, :1] + mixed.to(context.dtype) * gate


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> GEGLU-FF, each pre-LN residual.  With
    ``use_apm`` an ``APMContextMixer`` over ``apm_tokens`` tokens first
    reduces the context to one mixed token."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, use_apm: bool = False, apm_tokens: int = 17,
                 *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.disable_self_attn = disable_self_attn
        self.apm = APMContextMixer(apm_tokens, context_dim or dim, **fk) if use_apm else None
        for name in ("norm1", "norm2", "norm3"):
            norm_params(self, name, dim, **fk)
        self.attn1 = CrossAttention(dim, heads, dim_head,
                                    context_dim if disable_self_attn else None, **fk)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, **fk)
        self.ff = FeedForward(dim, dim, **fk)

    @span("st2v.transformer")
    def forward(self, x, context=None, *, frames=None):
        """``frames`` goes to both attentions: valid only when both are
        self-attentions over the frame axis (the temporal use,
        ``TransformerTemporal``)."""
        if self.apm is not None and context is not None:
            context = self.apm(context)
        x = x + self.attn1(layer_norm(x, *norm_pair(self, "norm1")),
                           context if self.disable_self_attn else None, frames)
        x = x + self.attn2(layer_norm(x, *norm_pair(self, "norm2")), context, frames)
        return self.ff(x, ln=norm_pair(self, "norm3"), residual=True)


class VideoTransformerBlock(nn.Module):
    """Temporal transformer block: ff_in -> temporal self-attn -> cross-attn
    to the time context -> FF, residuals throughout.  Input is spatial-major
    (B*T, S, C); its self-attention attends over T in that layout."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 ff_in: bool = True, disable_temporal_crossattention: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.has_ff_in = ff_in
        self.disable_temporal_crossattention = disable_temporal_crossattention
        if ff_in:
            norm_params(self, "norm_in", dim, **fk)
            self.ff_in = FeedForward(dim, dim, **fk)
        norm_params(self, "norm1", dim, **fk)
        self.attn1 = CrossAttention(dim, heads, dim_head, **fk)
        if not disable_temporal_crossattention:
            norm_params(self, "norm2", dim, **fk)
            self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, **fk)
        norm_params(self, "norm3", dim, **fk)
        self.ff = FeedForward(dim, dim, **fk)

    @span("st2v.transformer")
    def forward(self, x, context=None, *, batch: int, frames: int):
        if self.has_ff_in:
            x = self.ff_in(x, ln=norm_pair(self, "norm_in"), residual=True)
        x = x + self.attn1(layer_norm(x, *norm_pair(self, "norm1")), frames=(batch, frames))
        if not self.disable_temporal_crossattention:
            x = x + self.attn2(layer_norm(x, *norm_pair(self, "norm2")), context)
        return self.ff(x, ln=norm_pair(self, "norm3"), residual=True)


def blend_with_images(mix_factor, spatial, temporal, image_only_indicator):
    """UNet AlphaBlender (``alpha_blend``, ``learned_with_images``): alpha =
    sigmoid(mix) weights the SPATIAL branch; image rows take alpha = 1.
    Indicator (B, T); branches (B, T, ..., C)."""
    return alpha_blend(spatial, temporal, mix_factor, strategy="learned_with_images",
                       image_indicator=image_only_indicator)


def _remat(block: nn.Module, forward, *args):
    """``forward(*args)``, recomputed in the backward when ``block`` remats
    and grad is on.  The blocks draw no random numbers, so no RNG state is
    kept for the recompute."""
    if block.use_checkpoint and torch.is_grad_enabled():
        return checkpoint(forward, *args, use_reentrant=False, preserve_rng_state=False)
    return forward(*args)


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer + parallel temporal stack per depth.  Input
    (B, T, H, W, C); context (B, T, L, D).  The temporal blocks attend to
    frame 0's whole context row (all L tokens; with APM the spatial blocks
    mix them into one first)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_apm: bool = False,
                 apm_tokens: int = 17, disable_temporal_crossattention: bool = False,
                 max_time_embed_period: float = 10000.0, use_checkpoint: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        c, inner = channels, heads * dim_head
        self.use_checkpoint = use_checkpoint
        self.depth = depth
        self.disable_temporal_crossattention = disable_temporal_crossattention
        self.max_time_embed_period = max_time_embed_period
        norm_params(self, "norm", c, **fk)
        self.proj_in = Dense(c, inner, **fk)
        self.time_pos_embed_0 = Dense(c, c * 4, **fk)
        self.time_pos_embed_2 = Dense(c * 4, c, **fk)
        self.time_mixer_mix_factor = _param((1,), device, dtype)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, use_apm=use_apm, apm_tokens=apm_tokens,
                **fk))
            self.add_module(f"time_block_{d}", VideoTransformerBlock(
                inner, heads, dim_head, context_dim, ff_in=True,
                disable_temporal_crossattention=disable_temporal_crossattention, **fk))
        self.proj_out = Dense(inner, c, zero_init=True, **fk)
        self.tp = None

    def tp_divides(self, m: int) -> bool:
        return self.proj_in.kernel.shape[0] % m == 0

    def seq_partial_parameters(self) -> list:
        """The parameters used between the seq split and the gather (the
        spatial and temporal stacks, the frame embedding, the mixer): each
        seq rank's gradient of them covers its own tokens only."""
        names = [f"{stack}_{d}" for d in range(self.depth) for stack in ("block", "time_block")]
        names += ["time_pos_embed_0", "time_pos_embed_2"]
        return [p for n in names for p in getattr(self, n).parameters()] + [
            self.time_mixer_mix_factor]

    @span("st2v.transformer")
    def forward(self, x, context, image_only_indicator):
        return _remat(self, self._forward, x, context, image_only_indicator)

    def _forward(self, x, context, image_only_indicator):
        b, t, hh, ww, c = x.shape
        s = hh * ww
        h = group_norm(x.reshape(b * t, hh, ww, c), *norm_pair(self, "norm"), eps=1e-6)
        if self.tp is None:
            h = self.proj_in(h)
        else:   # column-parallel, gathered
            h = gather_dim(self.proj_in(copy_to_model(h, self.tp)), self.tp, AXIS_MODEL, -1)
        inner = h.shape[-1]
        mesh = get_active_mesh()
        seq = mesh is not None and mesh.shape[AXIS_SEQ] > 1 and s % mesh.shape[AXIS_SEQ] == 0
        if seq:
            seq_partial(self.seq_partial_parameters())
        with split_over(AXIS_SEQ) if seq else contextlib.nullcontext():
            h = self._blocks(h.reshape(b * t, s, inner), context, image_only_indicator, b, t, c,
                             mesh if seq else None)
        h = self.proj_out(h)
        return x + h.reshape(b, t, hh, ww, c)

    def _blocks(self, h, context, image_only_indicator, b: int, t: int, c: int, seq_mesh):
        """The spatial and temporal stacks on (B*T, S, inner); with
        ``seq_mesh`` the tokens are split over its seq ranks on the way in
        and gathered on the way out (the context, whole on every rank, then
        takes the sum of the ranks' partial gradients)."""
        if seq_mesh is not None:
            h = shard_dim(h, seq_mesh, AXIS_SEQ, 1)
            context = copy_to(context, seq_mesh, AXIS_SEQ)
        s, inner = h.shape[1], h.shape[2]

        frame_ids = torch.arange(t, dtype=torch.float32, device=h.device)
        t_emb = timestep_embedding(frame_ids, c, max_period=self.max_time_embed_period)
        pos = self.time_pos_embed_2(F.silu(self.time_pos_embed_0(t_emb))).to(h.dtype)  # (T, C)

        ctx_sp = context.reshape((b * t,) + context.shape[2:]) if context is not None else None
        ctx_rep = None
        if context is not None and not self.disable_temporal_crossattention:
            ctx_time = context[:, 0]  # (B, L, D)
            ctx_rep = ctx_time[:, None].expand((b, t) + ctx_time.shape[1:]).reshape(
                (b * t,) + ctx_time.shape[1:])

        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, ctx_sp)
            h_time_in = h + pos[:, None, :].repeat(b, 1, 1)
            h_time = getattr(self, f"time_block_{d}")(h_time_in, ctx_rep, batch=b, frames=t)
            h = blend_with_images(self.time_mixer_mix_factor, h.reshape(b, t, s, inner),
                                  h_time.reshape(b, t, s, inner),
                                  image_only_indicator).reshape(b * t, s, inner)
        return h if seq_mesh is None else gather_dim(h, seq_mesh, AXIS_SEQ, 1)


class UNetResBlock(nn.Module):
    """openaimodel ResBlock (dims=2): GN(1e-5)+SiLU+conv, +emb,
    GN+SiLU+zero-conv, 1x1 skip.  Input (N, H, W, C), emb (N, D)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "in_norm", in_channels, **fk)
        self.in_conv = Conv(in_channels, out_channels, 3, **fk)
        self.emb_proj = Dense(emb_dim, out_channels, **fk)
        norm_params(self, "out_norm", out_channels, **fk)
        self.out_conv = Conv(out_channels, out_channels, 3, zero_init=True, **fk)
        self.skip = Conv(in_channels, out_channels, 1, **fk) if in_channels != out_channels else None

    @span("st2v.resblock")
    def forward(self, x, emb):
        h = group_norm(x, *norm_pair(self, "in_norm"), eps=1e-5, act="silu")
        h = self.in_conv(h)
        h = h + self.emb_proj(silu_f32(emb))[:, None, None, :]
        h = group_norm(h, *norm_pair(self, "out_norm"), eps=1e-5, act="silu")
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


def _k4_geometry(h: torch.Tensor, conv: TimeConv) -> bool:
    """Whether ``_time_conv`` sends (B, T, H, W, C) to K4 on a CUDA device:
    the geometries the JAX package sends to its Pallas kernel (H*W >= 64 and
    its ``fits_temporal_conv``)."""
    b, t, hh, ww, c = h.shape
    kt, _, c_out = conv.kernel.shape
    return hh * ww >= 64 and fits_temporal_conv(t, c, c_out, kt, s=hh * ww, batch=b)


@span("st2v.conv")
def _time_conv(h: torch.Tensor, conv: TimeConv, *, res=None, res_w=None, gn=None):
    """(kt,1,1) temporal conv of (B, T, H, W, C), optionally with the
    GroupNorm(eps 1e-5)+SiLU prologue ``gn=(scale, bias[, groups])`` (32
    groups unless given) and the ``res + res_w[b, t] * conv`` epilogue.  On a
    CUDA device ``_k4_geometry``'s geometries launch K4 with the GroupNorm
    folded into a per-(row, channel) affine."""
    b, t, hh, ww, c = h.shape
    c_out = conv.kernel.shape[2]
    groups = gn[2] if gn is not None and len(gn) > 2 else 32
    if h.is_cuda and _k4_geometry(h, conv):
        pa = pb = None
        if gn is not None:
            pa, pb = group_norm_affine(h, gn[0], gn[1], num_groups=groups, eps=1e-5)
        out = temporal_conv(
            h.reshape(b, t, hh * ww, c).contiguous(), conv.kernel.to(h.dtype).contiguous(),
            conv.bias.float(),
            None if res is None else res.reshape(b, t, hh * ww, c_out).contiguous(),
            None if res_w is None else res_w.float().contiguous(), pa, pb)
        return out.reshape(b, t, hh, ww, c_out)
    if gn is not None:
        h = group_norm(h, gn[0], gn[1], num_groups=groups, eps=1e-5, act="silu")
    out = conv(h)
    if res is not None:
        out = res + res_w[:, :, None, None, None].to(res.dtype) * out
    return out


class TemporalUNetResBlock(nn.Module):
    """openaimodel ResBlock with dims=3, kernel (3,1,1): the UNet
    VideoResBlock's time stack.  Input (B, T, H, W, C), emb (B, T, D)."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 kernel: Tuple[int, int, int] = (3, 1, 1), *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        norm_params(self, "in_norm", in_channels, **fk)
        self.in_conv = TimeConv(in_channels, out_channels, kernel, **fk)
        self.emb_proj = Dense(emb_dim, out_channels, **fk)
        norm_params(self, "out_norm", out_channels, **fk)
        self.skip = Conv(in_channels, out_channels, 1, **fk) if in_channels != out_channels else None
        self.out_conv = TimeConv(out_channels, out_channels, kernel, zero_init=True, **fk)

    @span("st2v.resblock")
    def forward(self, x, emb, blend_weight=None):
        """With ``blend_weight`` ((B, T) f32) returns
        x + blend_weight * out_conv(...), fused into K4's epilogue."""
        h = _time_conv(x, self.in_conv, gn=norm_pair(self, "in_norm"))
        h = h + self.emb_proj(silu_f32(emb))[:, :, None, None, :]
        if self.skip is not None:
            x = self.skip(x)
        if blend_weight is None:
            blend_weight = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        return _time_conv(h, self.out_conv, res=x, res_w=blend_weight,
                          gn=norm_pair(self, "out_norm"))


class UNetVideoResBlock(nn.Module):
    """Spatial ResBlock + temporal ResBlock, AlphaBlended.  The blend
    alpha*h + (1-alpha)*(h + conv) = h + (1-alpha)*conv (weight 0 on image
    rows) is the temporal block's scaled residual."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 video_kernel_size: Tuple[int, int, int] = (3, 1, 1),
                 use_checkpoint: bool = False, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.use_checkpoint = use_checkpoint
        self.spatial = UNetResBlock(in_channels, out_channels, emb_dim, **fk)
        self.time_mixer_mix_factor = _param((1,), device, dtype)
        self.time_stack = TemporalUNetResBlock(out_channels, out_channels, emb_dim,
                                               video_kernel_size, **fk)

    @span("st2v.resblock")
    def forward(self, x, emb, image_only_indicator):
        return _remat(self, self._forward, x, emb, image_only_indicator)

    def _forward(self, x, emb, image_only_indicator):
        b, t, hh, ww, c = x.shape
        h = self.spatial(x.reshape(b * t, hh, ww, c), emb.reshape(b * t, -1))
        h = h.reshape(b, t, hh, ww, h.shape[-1])
        alpha = torch.sigmoid(self.time_mixer_mix_factor.float())
        bw = torch.where(image_only_indicator, torch.zeros_like(alpha), 1.0 - alpha)
        return self.time_stack(h, emb, blend_weight=bw)


class Downsample(nn.Module):
    """Strided 3x3 conv with symmetric padding 1.  Input (N, H, W, C)."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 3, stride=2, padding=1,
                         device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv.  Input (N, H, W, C)."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 3, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
