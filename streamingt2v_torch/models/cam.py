"""CAM fusion (counterpart of ``streamingt2v_tpu/models/cam.py``): per-pixel
temporal cross-attention merging ControlNet features into the base UNet's
skips.  Query = the UNet activation, every pixel attending over frames;
key/value = the ControlNet activation over the F_cond conditional frames
at the same pixel; zero-initialised proj_out.

Under a mesh: split by ``shard_params`` (``tp``, whole heads), proj_in is
column-parallel and gathered, q/k/v column-parallel by heads and to_out
row-parallel with a reduction over ``model``; with a seq axis that divides
the pixels, the per-pixel attention runs on this rank's pixels (the GroupNorm
before it on the whole activation) and they are gathered after proj_out:
the layers in between are named for the training step's sum over seq
(``seq_partial_parameters``)."""

from __future__ import annotations

import torch
from torch import nn

from streamingt2v_torch.models.layers import Dense, norm_pair, norm_params
from streamingt2v_torch.ops import group_norm
from streamingt2v_torch.ops.attention import attention_pre_split
from streamingt2v_torch.parallel.mesh import AXIS_MODEL, AXIS_SEQ
from streamingt2v_torch.parallel.sharding import (
    copy_to_model, gather_dim, get_active_mesh, reduce_from_model, seq_partial, shard_dim,
    split_over)
from streamingt2v_torch.utils.profiling import span


class CAMConditionalModel(nn.Module):
    """Fuse ``sample`` (B, F, H, W, C) with ``conditioning`` (B, F_cond, H, W, C)."""

    def __init__(self, channels: int, attention_head_dim: int = 64, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        c = channels
        self.attention_head_dim = attention_head_dim
        norm_params(self, "norm", c, **fk)
        self.proj_in = Dense(c, c, **fk)
        self.to_q = Dense(c, c, bias=False, **fk)
        self.to_k = Dense(c, c, bias=False, **fk)
        self.to_v = Dense(c, c, bias=False, **fk)
        self.to_out = Dense(c, c, **fk)
        self.proj_out = Dense(c, c, zero_init=True, **fk)
        self.tp = None

    def tp_divides(self, m: int) -> bool:
        return (self.to_out.kernel.shape[1] // self.attention_head_dim) % m == 0

    def seq_partial_parameters(self) -> list:
        """The layers that run on this rank's pixels under a seq split."""
        return [p for n in ("to_q", "to_k", "to_v", "to_out", "proj_out")
                for p in getattr(self, n).parameters()]

    @span("st2v.cam")
    def forward(self, sample: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = sample.shape
        f_cond = conditioning.shape[1]
        d = self.attention_head_dim
        tp = self.tp

        # GroupNorm over (F, H, W) per channel group
        hn = group_norm(sample, *norm_pair(self, "norm"), eps=1e-6).reshape(b, f, h * w, c)
        kv = conditioning.reshape(b, f_cond, h * w, c)
        if tp is not None:
            hn, kv = copy_to_model(hn, tp), copy_to_model(kv, tp)
            hn = gather_dim(self.proj_in(hn), tp, AXIS_MODEL, -1)
        else:
            hn = self.proj_in(hn)
        mesh = get_active_mesh()
        seq = mesh is not None and mesh.shape[AXIS_SEQ] > 1 and (h * w) % mesh.shape[AXIS_SEQ] == 0
        if seq:     # this rank's pixels
            hn, kv = shard_dim(hn, mesh, AXIS_SEQ, 2), shard_dim(kv, mesh, AXIS_SEQ, 2)
            seq_partial(self.seq_partial_parameters())
        s = hn.shape[2]
        heads = self.to_q.kernel.shape[0] // d      # this rank's heads

        def fold(z, fz):  # (b f) s (h d) -> (b s h) f d
            return z.reshape(b, fz, s, heads, d).permute(0, 2, 3, 1, 4).reshape(b * s * heads, fz, d)

        split = ((AXIS_SEQ,) if seq else ()) + ((AXIS_MODEL,) if tp is not None else ())
        with split_over(*split):    # this rank's pixels and heads
            o = attention_pre_split(fold(self.to_q(hn), f), fold(self.to_k(kv), f_cond),
                                    fold(self.to_v(kv), f_cond))
        o = o.reshape(b, s, heads, f, d).permute(0, 3, 1, 2, 4).reshape(b, f, s, heads * d)
        if tp is not None:
            o = reduce_from_model(self.to_out.apply_bias(o, None), tp)
            o = o + self.to_out.bias.to(o.dtype)
        else:
            o = self.to_out(o)
        residual = self.proj_out(o)
        if seq:
            residual = gather_dim(residual, mesh, AXIS_SEQ, 2)
        return sample + residual.reshape(b, f, h, w, c)
