"""Self-contained RIFF/WAVE codec (NumPy only) — the port's copy of
audio_suite_tpu/utils/wavcodec.py.

The reference relies on `soundfile` everywhere (e.g. microsound_0.2.1/
main_v2.py:1405,1519; grid_audio_app_0.2/grid_audio_app.py:65; tape-tuc-main/
Tape_TUC_23-11-25_auto-slice_n_record.py:261,342) — that library is not
available in this environment, so the framework ships its own codec.

Supports reading PCM 8/16/24/32-bit and IEEE float32/float64 (including
WAVE_FORMAT_EXTENSIBLE) and writing PCM_16, PCM_24, PCM_32 and FLOAT subtypes.
Read always returns float32 in [-1, 1] with shape [N] (mono) or [N, C].
"""
from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, always_2d: bool = False):
    """Read a WAV file -> (float32 array in [-1,1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        csize = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + csize]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            raw = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"missing fmt/data chunk: {path}")

    (audio_fmt, channels, sr, _byte_rate, _block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_fmt == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40:
        audio_fmt = struct.unpack_from("<H", fmt, 24)[0]

    if audio_fmt == WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    elif audio_fmt == WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            val = (b[:, 0].astype(np.int32)
                   | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= (1 << 23), val - (1 << 24), val)
            x = val.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: {audio_fmt}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    elif always_2d:
        x = x.reshape(-1, 1)
    return x, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "FLOAT"):
    """Write float audio ([-1,1], shape [N] or [N,C]) to WAV.

    subtype in {"FLOAT", "PCM_16", "PCM_24", "PCM_32"}. PCM conversions
    scale by 2^(bits-1) with clipping (libsndfile's convention: read and
    write are symmetric, full-scale -1.0 is representable, +1.0 clips to
    the max positive code).
    """
    x = np.asarray(audio)
    if x.ndim == 1:
        x = x.reshape(-1, 1)
    n, channels = x.shape

    if subtype == "FLOAT":
        fmt_tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = x.astype("<f4").tobytes()
    elif subtype == "PCM_16":
        fmt_tag, bits = WAVE_FORMAT_PCM, 16
        q = np.clip(np.rint(x.astype(np.float64) * 32768.0), -32768, 32767)
        payload = q.astype("<i2").tobytes()
    elif subtype == "PCM_24":
        fmt_tag, bits = WAVE_FORMAT_PCM, 24
        q = np.clip(np.rint(x.astype(np.float64) * 8388608.0),
                    -8388608, 8388607).astype(np.int32)
        b = np.empty((q.size, 3), dtype=np.uint8)
        flat = q.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
    elif subtype == "PCM_32":
        fmt_tag, bits = WAVE_FORMAT_PCM, 32
        q = np.clip(np.rint(x.astype(np.float64) * 2147483648.0),
                    -2147483648, 2147483647)
        payload = q.astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = sr * block_align
    fmt_chunk = struct.pack("<HHIIHH", fmt_tag, channels, int(sr),
                            byte_rate, block_align, bits)
    data_size = len(payload)
    riff_size = 4 + (8 + len(fmt_chunk)) + (8 + data_size + (data_size & 1))

    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
        f.write(b"data" + struct.pack("<I", data_size) + payload)
        if data_size & 1:
            f.write(b"\x00")
