"""The operations and bytes behind ``mfu.*`` and ``*_roofline``: closed forms
at small shapes, and the counted total of a tiny network equal to the sum
of its layers' closed forms."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import flops, run
from benchmark.reference import layers
from benchmark.tests import tiny

MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("m,c", [(256, 64), (1000, 320)])
def test_geglu_ff_is_24_m_c2(m, c):
    f, nbytes = flops.geglu_ff(m, c, 4 * c)
    assert f == 24 * m * c * c
    assert nbytes == 2 * (2 * m * c + 12 * c * c)


@pytest.mark.parametrize("b,l,heads,d", [(2, 64, 5, 64), (1, 300, 2, 32)])
def test_spatial_self_attention_is_4_b_l2_c(b, l, heads, d):
    f, _ = flops.attention(b * heads, l, l, d)
    assert f == 4 * b * l * l * heads * d


@pytest.mark.parametrize("m,c", [(128, 64), (1000, 128)])
def test_time_conv_is_2_m_3_c2(m, c):
    f, nbytes = flops.time_conv(1, 1, m, c, c, 3)
    assert f == 2 * m * 3 * c * c
    assert flops.time_conv(1, 1, m, c, c, 3, residual=True)[1] == nbytes + 2 * m * c


def test_bound_is_the_longer_of_operations_and_bytes():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_gates_select_the_kernels_calls():
    log = [dict(kind="attention", bh=250, lq=9216, lk=9216, d=64),
           dict(kind="attention", bh=500, lq=576, lk=576, d=64),
           dict(kind="attention", bh=190, lq=14400, lk=145, d=64),
           dict(kind="attention", bh=5, lq=3600, lk=145, d=64),
           dict(kind="geglu_ff", m=100, c=320, inner=1280),
           dict(kind="geglu_ff", m=460800, c=320, inner=1280),
           dict(kind="time_conv", b=1, t=8, s=32, c=512, c_out=512, kt=3, residual=False),
           dict(kind="time_conv", b=1, t=8, s=9216, c=512, c_out=512, kt=3, residual=True)]
    assert [o["lq"] for o in flops.flash_d64_calls(log)] == [9216, 14400]
    assert [o["m"] for o in flops.k3_calls(log)] == [460800]
    assert [o["s"] for o in flops.k4_calls(log)] == [9216]


def layer_flops(mod, args, out) -> int:
    """The closed form of one Dense, Conv or TimeConv call."""
    x = args[0]
    if isinstance(mod, layers.Dense):
        return 2 * (x.numel() // x.shape[-1]) * mod.kernel.shape[0] * mod.kernel.shape[1]
    if isinstance(mod, layers.Conv):
        return 2 * (out.numel() // out.shape[-1]) * mod.kernel.shape[0] * mod.kernel[0].numel()
    kt, cin, cout = mod.kernel.shape
    return 2 * (x.numel() // cin) * kt * cin * cout


@pytest.mark.parametrize("name", CELLS)
def test_counted_total_is_the_sum_of_the_parts(name):
    """FlopCounterMode's total of one unit of the tiny reference equals the
    sum of its layers' closed forms and its attentions' 4 B H Lq Lk D."""
    spec = run.resolve(MANIFEST, name)
    cfg, traffic = tiny.cell(name)
    cell = spec["entry"].Cell(cfg, traffic, 0, "cpu")
    parts = []

    def hook(mod, args, out):
        if isinstance(mod, layers.KERNEL_LAYERS):
            parts.append(layer_flops(mod, args, out))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        counted, log = flops.model_flops(cell.meta_unit())
    finally:
        handle.remove()
    attn = sum(flops.attention(o["bh"], o["lq"], o["lk"], o["d"])[0]
               for o in log if o["kind"] == "attention")
    assert parts and counted > 0
    assert counted == sum(parts) + attn
