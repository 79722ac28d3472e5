"""The ``program_span`` readers over traces built by hand: each device
operation goes to the innermost ``st2v.`` span open at its launch; the
sampler's share leaves out the network spans, the harness's hooks and the
steps the trace holds in part; every reader returns None where the
program opened no span or a launch is missing."""

from __future__ import annotations

import os

import pytest

from benchmark import program_spans, run
from benchmark.readers import Context
from benchmark.trace import DeviceOp, Trace

MANIFEST = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
NEW = ("sampler_span_ms.step", "norm_share.step", "norm_share.decode", "unspanned_share.step",
       "unspanned_share.decode")
MS = 1_000_000      # ns


def op(name: str, launch_ms: float, dur_ms: float) -> DeviceOp:
    return DeviceOp(name, int((launch_ms + 0.5) * MS), int(dur_ms * MS), int(launch_ms * MS))


def trace(ops, host, harness=(), found=None) -> Trace:
    host = [(n, int(a * MS), int(b * MS)) for n, a, b in host]
    spans = [(n, int(a * MS), int(b * MS)) for n, a, b in harness]
    return Trace(ops=ops, spans=spans, host=host, window_s=1.0, units=2,
                 launch_found=len(ops) if found is None else found)


# two guided steps (spans 0-100 and 100-200), each: a sampler op, the
# harness's hook copy inside its span, a UNet call holding a norm, a conv
# and an op of its own, then the sampler's update; a third step opened at
# the end holds only its first sampler op (the trace stopped inside it)
HOST = [("st2v.step", 0, 100), ("st2v.unet", 10, 80), ("st2v.resblock", 20, 60),
        ("st2v.norm", 25, 35), ("st2v.conv", 40, 50), ("aten::add", 90, 91),
        ("st2v.step", 100, 200), ("st2v.unet", 110, 180), ("st2v.resblock", 120, 160),
        ("st2v.norm", 125, 135), ("st2v.conv", 140, 150),
        ("st2v.step", 200, 230)]
HARNESS = [("bench.network", 8, 81), ("bench.network", 108, 181)]
OPS = [op("elementwise_kernel add", 5, 1.0), op("Memcpy DtoH", 9, 0.5),
       op("reduce_kernel mean", 30, 4.0), op("cudnn conv", 45, 8.0),
       op("elementwise_kernel mul", 55, 2.0), op("cat", 70, 1.0),
       op("elementwise_kernel add", 90, 1.0),
       op("elementwise_kernel add", 105, 1.0), op("Memcpy DtoH", 109, 0.5),
       op("reduce_kernel mean", 130, 4.0), op("cudnn conv", 145, 8.0),
       op("elementwise_kernel mul", 155, 2.0), op("cat", 170, 1.0),
       op("elementwise_kernel add", 190, 1.0),
       op("elementwise_kernel add", 205, 3.0)]


def ctx(tr: Trace, steps: int = 2) -> Context:
    return Context(trace=tr, units=tr.units, steps=steps, frames=0, unit_flops=0.0, unit_log=[])


def test_innermost_attribution():
    opened = program_spans.open_spans(trace(OPS, HOST, HARNESS))
    inner = [program_spans.innermost(names) for names in opened]
    assert inner == ["st2v.step", "st2v.step", "st2v.norm", "st2v.conv", "st2v.resblock",
                     "st2v.unet", "st2v.step"] * 2 + ["st2v.step"]
    assert opened[2] == ("st2v.step", "st2v.unet", "st2v.resblock", "st2v.norm")
    # a launch on a span's edge is inside it; after its end, outside
    edge = [op("k", 25, 1.0), op("k", 35, 1.0), op("k", 36, 1.0), op("k", 300, 1.0)]
    inner = [program_spans.innermost(n) for n in program_spans.open_spans(trace(edge, HOST))]
    assert inner == ["st2v.norm", "st2v.norm", "st2v.resblock", program_spans.NONE]


def test_breakdown_splits_the_elementwise_class():
    rows = program_spans.breakdown(trace(OPS, HOST, HARNESS))
    assert rows["st2v.norm"]["device_s"] == pytest.approx(8e-3)
    assert rows["st2v.resblock"] == pytest.approx({"device_s": 4e-3, "elementwise_s": 4e-3})
    assert sum(r["device_s"] for r in rows.values()) == pytest.approx(
        trace(OPS, HOST).device_s())


def test_shares():
    tr = trace(OPS, HOST, HARNESS)
    total = tr.device_s()
    readers = {m["name"]: mod for m, mod in run.resolve(MANIFEST, "streamingsvd.ar_chunk")
               ["per_layer"] + run.resolve(MANIFEST, "streamingsvd.vae_decode")["per_layer"]}
    for cell in ("step", "decode"):
        assert readers[f"norm_share.{cell}"].read(ctx(tr)) == pytest.approx(
            100 * 8e-3 / total)
        # the UNet's own ops: the cat of each call
        assert readers[f"unspanned_share.{cell}"].read(ctx(tr)) == pytest.approx(
            100 * 2e-3 / total)


def test_sampler_span_excludes_networks_hooks_and_partial_steps():
    """Per whole step (those holding a network call) the sampler's ops are
    2 ms of 17.5 ms launched inside it; the harness's copies (0.5 ms a
    step, inside ``bench.network``) and the third step's op (inside no
    whole step) are left out; the share scales the trace's device time a
    step."""
    tr = trace(OPS, HOST, HARNESS)
    got = program_spans.sampler_ms(tr, 2, "bench.network")
    assert got == pytest.approx(1e3 * tr.device_s() / 2 * (4.0 / 35.0))
    mod = dict((m["name"], mod) for m, mod in run.resolve(
        MANIFEST, "streamingsvd.ar_chunk")["per_layer"])["sampler_span_ms.step"]
    assert mod.read(ctx(tr)) == pytest.approx(got)
    # without the harness's span its copies count as the sampler's
    assert program_spans.sampler_ms(trace(OPS, HOST), 2, "bench.network") == pytest.approx(
        1e3 * tr.device_s() / 2 * (5.0 / 35.0))
    assert program_spans.sampler_ms(tr, 0, "bench.network") is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no_spans", "launch_missing", "no_ops"])
def test_readers_return_none(name, case):
    cell = "streamingsvd.vae_decode" if name.endswith(".decode") else "streamingsvd.ar_chunk"
    mod = dict((m["name"], mod) for m, mod in run.resolve(MANIFEST, cell)["per_layer"])[name]
    if case == "no_spans":
        tr = trace(OPS, [h for h in HOST if not h[0].startswith("st2v.")], HARNESS)
    elif case == "launch_missing":
        tr = trace(OPS, HOST, HARNESS, found=len(OPS) - 1)
    else:
        tr = trace([], HOST, HARNESS)
    assert mod.read(ctx(tr)) is None


def test_new_metrics_in_the_manifest():
    """The five readers' entries: ``program_span``, each moving the
    end-to-end metric of its cells and listing at least the cells it was
    given (a later cell may be added to them)."""
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        step = name.endswith(".step")
        assert m["moves"] == ("step_ms" if step else "frames_per_s")
        assert set(m["workloads"]) >= ({"streamingsvd.ar_chunk", "i2vgen_xl.enhance_chunk"}
                                       if step else {"streamingsvd.vae_decode"})
