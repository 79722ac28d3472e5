"""PyTorch port, the native y4m feeder (``streamingt2v_torch/native``): its
bytes against the port's Python writer and the JAX package's
``save_video`` (its Python writer: the JAX native feeder takes float frames
in [-1, 1] and writes limited range, so it is no reference for uint8
bytes), where the library lands, its queue, and which writer
``save_video`` reports.  The feeder repeats the Python writer's float32
arithmetic operation for operation, so the bytes are equal, not within a
level.  Skipped only where there is no ``g++``."""

import os
import shutil

import numpy as np
import pytest

from streamingt2v_torch import native
from streamingt2v_torch.utils import media
from streamingt2v_torch.utils.profiling import reset_timers, timing_report

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the feeder")


def _videos():
    rng = np.random.RandomState(7)
    noise = rng.randint(0, 256, (4, 18, 26, 3)).astype(np.uint8)
    edges = np.zeros((3, 18, 26, 3), np.uint8)
    edges[0] = 255
    edges[1, :, ::2] = 255               # every 2x2 block half black, half white
    edges[2, ::2, :, 0] = 255
    yy, xx = np.meshgrid(np.linspace(0, 6, 18), np.linspace(0, 9, 26), indexing="ij")
    smooth = np.clip(128 + 127 * np.sin(yy[..., None] + xx[..., None] * [1.0, 0.7, 0.3]),
                     0, 255).astype(np.uint8)[None]
    return {"noise": noise, "edges": edges, "smooth": smooth,
            "720p": rng.randint(0, 256, (2, 720, 1280, 3)).astype(np.uint8)}


def _write_python(path, video, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return media.save_video(path, video, fps=24)


@pytest.mark.parametrize("name", ["noise", "edges", "smooth", "720p"])
def test_feeder_bytes_match_the_python_writers(tmp_path, monkeypatch, name):
    from streamingt2v_tpu import native as jnative
    from streamingt2v_tpu.utils import media as jmedia

    video = _videos()[name]
    assert native.available()
    ours = media.save_video(str(tmp_path / "native.y4m"), video, fps=24)
    python = _write_python(str(tmp_path / "python.y4m"), video, monkeypatch)
    monkeypatch.setattr(jnative, "available", lambda: False)
    jax = jmedia.save_video(str(tmp_path / "jax.y4m"), video, fps=24)
    got, want, ref = (open(p, "rb").read() for p in (ours, python, jax))
    assert want == ref
    assert got == want
    f, h, w, _ = video.shape
    assert media.y4m_info(ours) == {"width": w, "height": h, "fps": 24.0, "frames": f}


def test_feeder_builds_under_the_build_directory():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT and lib.name == native.LIB_NAME
    assert native.BUILD_ROOT.name == "_build"
    src_dir = os.path.dirname(native.__file__)
    assert not [p for p in os.listdir(src_dir) if p.endswith(".so")]
    assert native.build() == lib          # cached: no second compile


def test_writer_queue_and_errors(tmp_path):
    frames = np.random.RandomState(1).randint(0, 256, (12, 64, 64, 3)).astype(np.uint8)
    path = str(tmp_path / "q.y4m")
    w = native.AsyncVideoWriter(path, 64, 64, fps=8)
    w.write(frames[:6])
    w.write(frames[6:])
    assert 0 <= w.pending <= 12
    w.close()
    w.close()                              # a second close is a no-op
    assert media.y4m_info(path) == {"width": 64, "height": 64, "fps": 8.0, "frames": 12}
    with pytest.raises(RuntimeError):
        native.AsyncVideoWriter(str(tmp_path / "odd.y4m"), 33, 16)
    with native.AsyncVideoWriter(str(tmp_path / "t.y4m"), 64, 64) as w:
        with pytest.raises(ValueError):
            w.write(frames.astype(np.float32))
        with pytest.raises(ValueError):
            w.write(frames[:, :32])


def test_save_video_names_the_writer(tmp_path, monkeypatch):
    video = _videos()["noise"]
    reset_timers()
    media.save_video(str(tmp_path / "a.y4m"), video)
    assert set(timing_report()) == {"save_y4m_native"}
    reset_timers()
    _write_python(str(tmp_path / "b.y4m"), video, monkeypatch)
    assert set(timing_report()) == {"save_y4m_python"}
    reset_timers()
