"""Media I/O (counterpart of ``streamingt2v_tpu/utils/media.py``): range
conversion and geometry on uint8 numpy videos (F, H, W, C), the float <->
uint8 moves and the 720p resize as torch on the video's device, image
loading, and export.

The card's path needs neither OpenCV nor Pillow: ``resize_video`` is torch,
``resize_to_stage1`` returns an image that already has the stage-1 size
as it is, and ``.y4m`` files are written by the port's native feeder
(``streamingt2v_torch/native``) or, without a compiler, here.  ``cv2`` (mp4, video
reading) and ``PIL`` (image files, the stage-1 resize) are imported only
inside the functions that need them.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from streamingt2v_torch.utils.profiling import stage_timer


# ---------------------------------------------------------------------------
# range conversion
# ---------------------------------------------------------------------------

def convert_range(video: np.ndarray, input_range: Tuple[float, float],
                  output_range: Tuple[float, float]) -> np.ndarray:
    i0, i1 = input_range
    o0, o1 = output_range
    return (video.astype(np.float32) - i0) / (i1 - i0) * (o1 - o0) + o0


def to_uint8(video: np.ndarray, input_range=(-1.0, 1.0)) -> np.ndarray:
    out = convert_range(video, input_range, (0.0, 255.0))
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def concat_chunks(chunks: Sequence[np.ndarray]) -> np.ndarray:
    """Temporal concatenation."""
    return np.concatenate(list(chunks), axis=0)


def fetch_uint8(video: torch.Tensor, input_range=(-1.0, 1.0)) -> np.ndarray:
    """Float video (F, H, W, C) -> host uint8, converted on the video's
    device with ``to_uint8``'s operations (round half to even, then clip),
    so the bytes are the same."""
    i0, i1 = input_range
    out = (video.float() - i0) / (i1 - i0) * 255.0
    return torch.round(out).clamp(0, 255).to(torch.uint8).cpu().numpy()


def put_unit_range(video_u8: np.ndarray, device) -> torch.Tensor:
    """Host uint8 video -> float32 [0, 1] on ``device`` (``video / 255``)."""
    return torch.tensor(video_u8, device=device).float() / 255.0


def to_model_range(img):
    """uint8 -> float32 [-1, 1]; a numpy array or a tensor (on its device)."""
    x = img.float() if isinstance(img, torch.Tensor) else img.astype(np.float32)
    return x / 127.5 - 1.0


# ---------------------------------------------------------------------------
# image loading and resizing
# ---------------------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """-> (H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def resize_to_stage1(img: np.ndarray, height: int = 576, width: int = 1024) -> np.ndarray:
    """Resize keeping the aspect to ``height`` (bicubic), then centre-crop
    or edge-pad to ``width``.  An image of that size is returned as it is
    (Pillow's resize to the same size is a copy)."""
    if img.shape[:2] == (height, width):
        return img
    from PIL import Image

    pil = Image.fromarray(img)
    scale = height / pil.size[1]
    wsize = int(round(pil.size[0] * scale))
    arr = np.asarray(pil.resize((wsize, height), Image.BICUBIC))
    if wsize > width:
        x0 = (wsize - width) // 2
        arr = arr[:, x0:x0 + width]
    elif wsize < width:
        pad = width - wsize
        arr = np.pad(arr, ((0, 0), (pad // 2, pad - pad // 2), (0, 0)), mode="edge")
    return arr


# OpenCV's fixed-point bilinear weights: 11 fractional bits.
_COEF_BITS = 11


def _linear_taps(n_in: int, n_out: int, clamp_weight: bool, device) -> tuple:
    """cv2 ``INTER_LINEAR`` source rows (or columns) and weights along one
    axis: half-pixel centres, the coordinate in f32 from a double scale.
    Columns clamp the coordinate at the borders; rows keep the weight and
    clamp only the indices (both give the border pixel)."""
    scale = 1.0 / (n_out / n_in)
    f = torch.from_numpy(((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32))
    s = torch.floor(f)
    f = f - s
    s = s.long()
    if clamp_weight:
        f = torch.where((s < 0) | (s >= n_in - 1), torch.zeros_like(f), f)
        s = s.clamp(0, n_in - 1)
    i0, i1 = s.clamp(0, n_in - 1), (s + 1).clamp(0, n_in - 1)
    return i0.to(device), i1.to(device), (1.0 - f).to(device), f.to(device)


def resize_video(video: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-frame bilinear resize of a (F, H, W, C) uint8 or float video on its
    device, as OpenCV's ``resize(INTER_LINEAR)`` computes it: half-pixel
    centres, no antialiasing, and for uint8 its 11-bit fixed-point weights,
    a horizontal pass in integers and its vectorised vertical pass
    (``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``)."""
    dev = video.device
    y0, y1, wy0, wy1 = _linear_taps(video.shape[1], height, False, dev)
    x0, x1, wx0, wx1 = _linear_taps(video.shape[2], width, True, dev)
    if video.dtype != torch.uint8:
        v = video.float()
        h = v[:, :, x0] * wx0[:, None] + v[:, :, x1] * wx1[:, None]
        return h[:, y0] * wy0[:, None, None] + h[:, y1] * wy1[:, None, None]
    one = float(1 << _COEF_BITS)
    ax0, ax1 = (torch.round(w * one).int() for w in (wx0, wx1))
    by0, by1 = (torch.round(w * one).int() for w in (wy0, wy1))
    v = video.int()
    h = v[:, :, x0] * ax0[:, None] + v[:, :, x1] * ax1[:, None]
    out = ((((h[:, y0] >> 4) * by0[:, None, None]) >> 16)
           + (((h[:, y1] >> 4) * by1[:, None, None]) >> 16))
    return ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# geometry (pad / crop / stack / grid)
# ---------------------------------------------------------------------------

def _as_video(x: np.ndarray) -> np.ndarray:
    """Accept (H, W, C) images or (F, H, W, C) videos; return 4D."""
    return x[None] if x.ndim == 3 else x


def pad(video: np.ndarray, top: int = 0, bottom: int = 0, left: int = 0,
        right: int = 0, mode: str = "constant", value: int = 0) -> np.ndarray:
    """Spatial padding; mode: numpy pad mode ('constant', 'edge', 'reflect')."""
    v = _as_video(video)
    widths = ((0, 0), (top, bottom), (left, right), (0, 0))
    if mode == "constant":
        out = np.pad(v, widths, mode="constant", constant_values=value)
    else:
        out = np.pad(v, widths, mode=mode)
    return out if video.ndim == 4 else out[0]


def crop(video: np.ndarray, x0: int, y0: int, width: int, height: int) -> np.ndarray:
    """Spatial crop: box given as left, top, width, height."""
    v = _as_video(video)
    out = v[:, y0:y0 + height, x0:x0 + width]
    return out if video.ndim == 4 else out[0]


def hstack(items: Sequence[np.ndarray]) -> np.ndarray:
    """Side by side; heights must match."""
    return np.concatenate([_as_video(v) for v in items], axis=2)


def vstack(items: Sequence[np.ndarray]) -> np.ndarray:
    """Top to bottom; widths must match."""
    return np.concatenate([_as_video(v) for v in items], axis=1)


def grid(items: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """Tile images/videos into a grid, row-major; the list is padded with
    black tiles to fill the last row."""
    vs = [_as_video(v) for v in items]
    shape = vs[0].shape
    if any(v.shape != shape for v in vs):
        raise ValueError(f"grid tiles differ in shape: {[v.shape for v in vs]}")
    rows = -(-len(vs) // cols)
    vs = vs + [np.zeros(shape, vs[0].dtype)] * (rows * cols - len(vs))
    return vstack([hstack(vs[r * cols:(r + 1) * cols]) for r in range(rows)])


# ---------------------------------------------------------------------------
# export and reading
# ---------------------------------------------------------------------------

def save_video(path: str, video: np.ndarray, fps: int = 24) -> str:
    """video: (F, H, W, 3) uint8 RGB.  ``.y4m``: BT.601 YUV 4:2:0 written
    here; anything else: OpenCV's mp4v writer."""
    if video.dtype != np.uint8 or video.ndim != 4 or video.shape[-1] != 3:
        raise ValueError(f"expected a (F, H, W, 3) uint8 video, got {video.dtype} "
                         f"{video.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if path.endswith(".y4m"):
        return _save_y4m(path, video, fps)

    import cv2

    f, h, w, _ = video.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {path}")
    for frame in video:
        writer.write(frame[:, :, ::-1])  # RGB -> BGR
    writer.release()
    return path


def _save_y4m(path: str, video: np.ndarray, fps: int) -> str:
    """BT.601 full-range RGB -> YUV 4:2:0 planes (chroma averaged over 2x2),
    header ``C420jpeg``: by the native feeder (``streamingt2v_torch/native``)
    where it builds, else in Python; the two write the same bytes.  The
    write is timed as ``save_y4m_native`` or ``save_y4m_python`` in
    ``utils/profiling.timing_report``, which so names the writer used."""
    from streamingt2v_torch import native

    f, h, w, _ = video.shape
    if native.available():
        with stage_timer("save_y4m_native"), native.AsyncVideoWriter(path, w, h, fps) as wr:
            wr.write(video)
        return path
    with stage_timer("save_y4m_python"), open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for frame in video:
            rgb = frame.astype(np.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            yy = 0.299 * r + 0.587 * g + 0.114 * b
            u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
            v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
            fh.write(b"FRAME\n")
            fh.write(np.clip(np.round(yy), 0, 255).astype(np.uint8).tobytes())
            for plane in (u, v):
                sub = plane.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
                fh.write(np.clip(np.round(sub), 0, 255).astype(np.uint8).tobytes())
    return path


def y4m_info(path: str) -> dict:
    """The header's width, height, fps and the number of frames in the file
    (each ``FRAME`` marker checked at its offset)."""
    with open(path, "rb") as fh:
        header = fh.readline().decode()
        if not header.startswith("YUV4MPEG2 "):
            raise ValueError(f"not a y4m file: {header[:40]!r}")
        tok = {t[0]: t[1:] for t in header.split()[1:]}
        w, h = int(tok["W"]), int(tok["H"])
        num, den = tok["F"].split(":")
        frame_bytes = w * h + 2 * (w // 2) * (h // 2)
        frames = 0
        while True:
            marker = fh.read(6)
            if not marker:
                break
            if marker != b"FRAME\n" or len(fh.read(frame_bytes)) != frame_bytes:
                raise ValueError(f"{path}: frame {frames} is malformed")
            frames += 1
    return {"width": w, "height": h, "fps": float(num) / float(den), "frames": frames}


def video_fps(path: str) -> float:
    """fps of a saved container (y4m from its header, mp4 through OpenCV)."""
    if path.endswith(".y4m"):
        return y4m_info(path)["fps"]
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps)


def load_video(path: str) -> np.ndarray:
    """(F, H, W, 3) uint8 RGB through OpenCV."""
    import cv2

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    cap.release()
    return np.stack(frames)
