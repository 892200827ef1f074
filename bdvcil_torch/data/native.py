"""ctypes binding for the port's native JPEG decoder (``csrc/host/decoder.cpp``)
and its JPEG writer (``csrc/host/jpeg_write.cpp``): the port's counterpart of
``bdvcil_tpu/data/native.py``.

Both are host code on the port's own baseline JPEG codec
(``csrc/host/jpeg_codec.h``), which reproduces libjpeg-turbo 2.1 bit for bit
and needs no libjpeg: they build wherever g++ does, on one code path. At
first use they are compiled (``g++ -O3 -march=native ... -lpthread``, or
``$CXX``) into ``bdvcil_torch/_build/host-<hash>/``, where the hash covers the
sources, the codec, the flags and this machine's CPU (``-march=native``
makes the libraries good for this machine only). Concurrent first uses in
several processes build once, under a file lock.

When the build or the load fails, ``available()`` is False and
``build_error()`` holds the compiler's first error line. Nothing falls back to
another decoder: every decode function raises, and so do the loaders. A file
the codec refuses (progressive, arithmetic-coded, 12-bit, 4 components, other
sampling, truncated or corrupt) fails its call with the codec's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
DECODER_SRC = _PKG / "csrc" / "host" / "decoder.cpp"
WRITER_SRC = _PKG / "csrc" / "host" / "jpeg_write.cpp"
CODEC_SRC = _PKG / "csrc" / "host" / "jpeg_codec.h"  # included by both
BUILD_ROOT = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17")
LDLIBS = ("-lpthread",)
BUILD_TIMEOUT_S = 600

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_u8_p = ctypes.POINTER(ctypes.c_uint8)
_c_str_p = ctypes.POINTER(ctypes.c_char_p)
# (restype, argtypes) of every entry point the port calls
_DECODER_API = {
    "bdvc_decode_file": (ctypes.c_int, [ctypes.c_char_p, _c_u8_p, ctypes.c_long, _c_int_p,
                                        _c_int_p]),
    "bdvc_decode_resize_crop_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_int, ctypes.c_int, _c_int_p,
                                                     _c_int_p, _c_u8_p, ctypes.c_int]),
    "bdvc_decode_resize2_crop_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, _c_int_p,
                                                      _c_int_p, ctypes.c_int, ctypes.c_int,
                                                      _c_int_p, _c_int_p, _c_u8_p, ctypes.c_int]),
    "bdvc_decode_yuv420_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, _c_int_p, _c_int_p,
                                                ctypes.c_int, _c_int_p, _c_int_p, _c_u8_p,
                                                _c_u8_p, ctypes.c_int]),
    "bdvc_decode_tencrop_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int, _c_u8_p, ctypes.c_int]),
    "bdvc_decode_yuv420_full_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, _c_int_p,
                                                     _c_int_p, ctypes.c_int, ctypes.c_int,
                                                     _c_u8_p, _c_u8_p, ctypes.c_int]),
    "bdvc_fetch_planes_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, _c_u8_p, _c_u8_p, _c_int_p,
                                               ctypes.c_int]),
    "bdvc_probe_dims_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, _c_int_p, _c_int_p,
                                             ctypes.c_int]),
    "bdvc_cache_stats": (None, [ctypes.POINTER(ctypes.c_long)] * 4),
    "bdvc_cache_clear": (None, []),
    "bdvc_cache_set_budget_mb": (None, [ctypes.c_long]),
}
# why a file does not decode (not part of the JAX package's ABI)
_EXPLAIN_API = {
    "bdvc_explain_failure": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
}
_WRITER_API = {
    "bdvc_write_jpeg_batch": (ctypes.c_int, [_c_str_p, ctypes.c_int, _c_u8_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int]),
}

_lock = threading.Lock()
_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL]] = None
_error: Optional[str] = None


def _cpu_id() -> str:
    """This machine's CPU model and feature flags (what -march=native reads)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine() + platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep)))


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join((_cxx(),) + CXXFLAGS + LDLIBS).encode())
    h.update(_cpu_id().encode())
    for src in (DECODER_SRC, WRITER_SRC, CODEC_SRC):
        h.update(src.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}"


class BuildError(RuntimeError):
    pass


def _first_error_line(log: str) -> str:
    lines = [ln.strip() for ln in log.splitlines() if ln.strip()]
    errors = [ln for ln in lines if "error" in ln.lower()]
    return (errors or lines or ["(no compiler output)"])[0]


def _build() -> Path:
    """Compile both libraries (two compiler processes at once) unless this
    machine has them already; return their directory."""
    for src in (DECODER_SRC, WRITER_SRC, CODEC_SRC):
        if not src.exists():
            raise BuildError(f"{src} not found")
    out = build_dir()
    targets = {src: out / f"lib{src.stem}.so" for src in (DECODER_SRC, WRITER_SRC)}
    if all(t.exists() for t in targets.values()):
        return out
    out.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
        pending = {s: t for s, t in targets.items() if not t.exists()}
        procs = []
        for src, target in pending.items():
            tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
            cmd = [_cxx(), *CXXFLAGS, str(src), "-o", str(tmp), *LDLIBS]
            procs.append((target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for target, tmp, proc in procs:
            try:
                log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                log = f"error: the compiler ran over {BUILD_TIMEOUT_S} s\n{log}"
            (out / f"{target.stem}.log").write_text(log)
            if proc.returncode == 0:
                os.replace(tmp, target)
            else:
                failed.append(_first_error_line(log))
        if failed:
            raise BuildError(failed[0])
    return out


def _bind(path: Path, api) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in api.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> Optional[Tuple[ctypes.CDLL, ctypes.CDLL]]:
    global _libs, _error
    with _lock:
        if _libs is None and _error is None:
            try:
                out = _build()
                _libs = (_bind(out / f"lib{DECODER_SRC.stem}.so",
                               {**_DECODER_API, **_EXPLAIN_API}),
                         _bind(out / f"lib{WRITER_SRC.stem}.so", _WRITER_API))
            except (BuildError, OSError, AttributeError) as e:
                _error = _first_error_line(str(e))
        return _libs


def available() -> bool:
    """The decoder and the writer built and loaded (building them on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why ``available()`` is False: the compiler's first error line, or the
    loader's error; None when the libraries loaded (or were not tried)."""
    return _error


def _decoder() -> ctypes.CDLL:
    libs = _load()
    if libs is None:
        raise RuntimeError(f"native decoder unavailable: {_error}")
    return libs[0]


def has_yuv420() -> bool:
    return available()


def has_fetch_planes() -> bool:
    return available()


def has_yuv420_full() -> bool:
    return available()


def default_threads(share: int = 1) -> int:
    """Decode-pool size when the caller passes ``num_threads <= 0``: the CPUs
    this process may run on (at least 4 where the affinity mask reports 2 or
    fewer, as cgroup quotas hide there), divided among ``share`` concurrent
    callers (the loaders' ``num_workers``). ``BDVC_DECODE_THREADS`` overrides
    it per pool."""
    env = os.environ.get("BDVC_DECODE_THREADS")
    if env:
        return max(1, int(env))
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        n = os.cpu_count() or 1
    if n <= 2:
        n = 4
    return max(1, n // max(1, share))


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _ptr(a: np.ndarray, kind=_c_int_p):
    return a.ctypes.data_as(kind)


def _xy(pairs: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    a = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    return np.ascontiguousarray(a[:, 0]), np.ascontiguousarray(a[:, 1])


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else default_threads()


def explain_failure(path: str) -> str:
    """The codec's reason why ``path`` does not decode ("" when it does)."""
    msg = ctypes.create_string_buffer(512)
    _decoder().bdvc_explain_failure(path.encode(), msg, len(msg))
    return msg.value.decode(errors="replace")


def _check(rc: int, paths: Sequence[str], what: str = "decode") -> None:
    if rc != 0:
        raise IOError(f"{what} failed for {paths[rc - 1]}: {explain_failure(paths[rc - 1])}")


def decode_file(path: str, max_bytes: int = 64 * 1024 * 1024) -> np.ndarray:
    """Full-size decode of one JPEG to (H, W, 3) uint8 RGB."""
    buf = np.empty(max_bytes, dtype=np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _decoder().bdvc_decode_file(path.encode(), _ptr(buf, _c_u8_p), max_bytes,
                                     ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode failed ({rc}) for {path}: {explain_failure(path)}")
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_resize_crop_batch(paths: Sequence[str], short_side: int, out_h: int, out_w: int,
                             crops: Optional[Sequence[Tuple[int, int]]] = None,
                             num_threads: int = 0) -> np.ndarray:
    """Decode -> short-side resize -> crop at ``crops`` (x, y) (None: centre)
    into (N, out_h, out_w, 3) uint8."""
    lib = _decoder()
    out = np.empty((len(paths), out_h, out_w, 3), dtype=np.uint8)
    if crops is None:
        cx_p = cy_p = ctypes.cast(None, _c_int_p)
    else:
        cx, cy = _xy(crops)
        cx_p, cy_p = _ptr(cx), _ptr(cy)
    rc = lib.bdvc_decode_resize_crop_batch(_paths(paths), len(paths), short_side, out_h, out_w,
                                           cx_p, cy_p, _ptr(out, _c_u8_p), _threads(num_threads))
    _check(rc, paths)
    return out


def decode_resize2_crop_batch(paths: Sequence[str], resize_dims: np.ndarray, out_h: int,
                              out_w: int, crops: Sequence[Tuple[int, int]],
                              num_threads: int = 0) -> np.ndarray:
    """Per image: decode, resize to ``resize_dims[i]`` = (w, h) with separate
    x and y factors, crop out_h x out_w at ``crops[i]`` -> (N, out_h, out_w, 3)."""
    lib = _decoder()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    rw, rh = _xy(resize_dims)
    cx, cy = _xy(crops)
    rc = lib.bdvc_decode_resize2_crop_batch(_paths(paths), n, _ptr(rw), _ptr(rh), out_h, out_w,
                                            _ptr(cx), _ptr(cy), _ptr(out, _c_u8_p),
                                            _threads(num_threads))
    _check(rc, paths)
    return out


def decode_yuv420_batch(paths: Sequence[str], resize_dims: np.ndarray, out_size: int,
                        crops: Sequence[Tuple[int, int]],
                        num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The yuv420 wire of :func:`decode_resize2_crop_batch`: y (N, out, out)
    luma and c (N, out/2, out/2, 2) interleaved CbCr, at the JPEG's stored
    2x2 chroma subsampling."""
    lib = _decoder()
    if out_size % 2:
        raise ValueError(f"out_size must be even, got {out_size}")
    n, half = len(paths), out_size // 2
    out_y = np.empty((n, out_size, out_size), dtype=np.uint8)
    out_c = np.empty((n, half, half, 2), dtype=np.uint8)
    rw, rh = _xy(resize_dims)
    cx, cy = _xy(crops)
    rc = lib.bdvc_decode_yuv420_batch(_paths(paths), n, _ptr(rw), _ptr(rh), out_size, _ptr(cx),
                                      _ptr(cy), _ptr(out_y, _c_u8_p), _ptr(out_c, _c_u8_p),
                                      _threads(num_threads))
    _check(rc, paths)
    return out_y, out_c


def decode_tencrop_batch(paths: Sequence[str], short_side: int, crop: int,
                         num_threads: int = 0) -> np.ndarray:
    """Decode each frame once, short-side resize, and cut the 5 FiveCrop
    positions: (N, 5, crop, crop, 3) uint8 (the flips are added on the
    device, ``ops.augment.tencrop_expand``)."""
    lib = _decoder()
    out = np.empty((len(paths), 5, crop, crop, 3), dtype=np.uint8)
    rc = lib.bdvc_decode_tencrop_batch(_paths(paths), len(paths), short_side, crop,
                                       _ptr(out, _c_u8_p), _threads(num_threads))
    _check(rc, paths)
    return out


def decode_yuv420_full_batch(paths: Sequence[str], resize_dims: np.ndarray, pad_w: int,
                             pad_h: int, num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The full-frame eval wire: each frame resized to ``resize_dims[i]`` = (w,
    h) and laid at the origin of a zero-padded slot, y (N, pad_h, pad_w) and c
    (N, pad_h/2, pad_w/2, 2) interleaved CbCr. A crop of it equals
    :func:`decode_yuv420_batch` at the same offsets
    (``ops.augment.eval_yuv_full_crops`` cuts them on the device)."""
    lib = _decoder()
    if pad_w % 2 or pad_h % 2:
        raise ValueError(f"pad dims must be even, got {(pad_w, pad_h)}")
    n = len(paths)
    dims = np.ascontiguousarray(resize_dims, dtype=np.int32).reshape(n, 2)
    if (dims[:, 0] > pad_w).any() or (dims[:, 1] > pad_h).any():
        raise ValueError("resize dims exceed pad dims")
    out_y = np.empty((n, pad_h, pad_w), dtype=np.uint8)
    out_c = np.empty((n, pad_h // 2, pad_w // 2, 2), dtype=np.uint8)
    rw, rh = _xy(dims)
    rc = lib.bdvc_decode_yuv420_full_batch(_paths(paths), n, _ptr(rw), _ptr(rh), pad_w, pad_h,
                                           _ptr(out_y, _c_u8_p), _ptr(out_c, _c_u8_p),
                                           _threads(num_threads))
    _check(rc, paths)
    return out_y, out_c


def fetch_planes_batch(paths: Sequence[str], pad_w: int, pad_h: int,
                       num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The planes wire: stored-resolution YCbCr 4:2:0 planes in fixed pads, y
    (N, pad_h, pad_w), c (N, pad_h/2, pad_w/2, 2), and dims (N, 2) int32 stored
    (w, h), (0, 0) for a frame the caller must resize on the host (not 4:2:0,
    unreadable, or larger than the pad)."""
    lib = _decoder()
    if pad_w % 2 or pad_h % 2:
        raise ValueError(f"pad dims must be even, got {(pad_w, pad_h)}")
    n = len(paths)
    out_y = np.empty((n, pad_h, pad_w), dtype=np.uint8)
    out_c = np.empty((n, pad_h // 2, pad_w // 2, 2), dtype=np.uint8)
    dims = np.empty((n, 2), dtype=np.int32)
    rc = lib.bdvc_fetch_planes_batch(_paths(paths), n, pad_w, pad_h, _ptr(out_y, _c_u8_p),
                                     _ptr(out_c, _c_u8_p), _ptr(dims), _threads(num_threads))
    if rc != 0:
        raise ValueError(f"fetch_planes_batch: bad pad dims {(pad_w, pad_h)}")
    return out_y, out_c, dims


def probe_dims_batch(paths: Sequence[str], num_threads: int = 0) -> np.ndarray:
    """(N, 2) int32 (w, h) of each JPEG, from its header alone."""
    lib = _decoder()
    n = len(paths)
    widths = np.empty(n, dtype=np.int32)
    heights = np.empty(n, dtype=np.int32)
    rc = lib.bdvc_probe_dims_batch(_paths(paths), n, _ptr(widths), _ptr(heights),
                                   _threads(num_threads))
    _check(rc, paths, "probe")
    return np.stack([widths, heights], axis=1)


def decode_cache_stats() -> dict:
    """The decoded-plane cache's counters: hits, misses, bytes, entries."""
    vals = [ctypes.c_long(0) for _ in range(4)]
    _decoder().bdvc_cache_stats(*[ctypes.byref(v) for v in vals])
    return dict(zip(("hits", "misses", "bytes", "entries"), (v.value for v in vals)))


def decode_cache_clear() -> None:
    _decoder().bdvc_cache_clear()


def decode_cache_set_budget_mb(mb: int) -> None:
    """The plane cache's budget in MB (<= 0 disables and flushes it); the
    start-up budget is ``BDVC_DECODE_CACHE_MB`` (512)."""
    _decoder().bdvc_cache_set_budget_mb(int(mb))


def write_jpeg_batch(paths: Sequence[str], frames: np.ndarray, quality: int = 95,
                     num_threads: int = 0) -> None:
    """Write (N, H, W, 3) uint8 RGB ``frames`` as JPEG files (4:2:0), the
    bytes libjpeg-turbo writes after ``jpeg_set_defaults`` and
    ``jpeg_set_quality(quality, TRUE)``."""
    libs = _load()
    if libs is None:
        raise RuntimeError(f"native JPEG writer unavailable: {_error}")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3 or len(frames) != len(paths):
        raise ValueError(f"frames {frames.shape} for {len(paths)} paths; want (N, H, W, 3)")
    n, h, w, _ = frames.shape
    rc = libs[1].bdvc_write_jpeg_batch(_paths(paths), n, _ptr(frames, _c_u8_p), w, h, quality,
                                       _threads(num_threads))
    if rc != 0:
        raise IOError(f"JPEG write failed for {paths[rc - 1]}")
