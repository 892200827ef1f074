"""The port's JPEG codec (``bdvcil_torch/csrc/host/jpeg_codec.h``, under the
port's ``decoder.cpp`` and ``jpeg_write.cpp``) against libjpeg-turbo, which
the JAX package's decoder (``bdvcil_tpu.data.native``, ``native/decoder.cpp``)
links.

  * every decoder entry point, bit for bit, on files written by cv2 and by
    the port's writer from a numpy seed: qualities 50, 75, 95, 100; sizes
    320x240 to 1x1; gray, 4:2:0, 4:2:2, 4:4:4; with and without a restart
    interval; resize targets that make the DCT scale 1, 2, 4 and 8; with the
    plane cache off, cold and warm;
  * the forms the codec refuses raise, naming the form, where the JAX
    decoder reads a progressive or a truncated file (ROADMAP §C), and so do
    a corrupt Huffman table and a frame header too large for its file
    (refused before anything is allocated for it);
  * the writer's files are byte-identical to libjpeg's at the settings the
    writer reproduces (``jpeg_set_defaults`` + ``jpeg_set_quality(q, TRUE)``),
    held against a small libjpeg writer the test compiles.
"""

import ctypes
import itertools
import re
import subprocess

import cv2
import numpy as np
import pytest

from bdvcil_torch.data import native
from tests.torch_port_helpers import jax_native

QUALITIES = (50, 75, 95, 100)
SIZES = ((320, 240), (340, 256), (321, 241), (17, 9), (8, 8), (1, 1))
SAMPLINGS = {"gray": None, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
RESTARTS = (0, 2)  # MCUs a restart interval (0: none)
DENOMS = (1, 2, 4, 8)  # resize targets of 1/d the stored size make the DCT scale d
GROUPS = (*SAMPLINGS, "port")  # cv2's samplings, and the port's writer (4:2:0)


def frame(rng, w, h, kind):
    """A seeded RGB frame: the corpus's base colour plus noise, or a smooth
    gradient with a little noise, or full-range noise (which overshoots the
    IDCT's range at high quality)."""
    if kind == 0:
        return (rng.integers(0, 200, 3) + rng.integers(0, 56, (h, w, 3))).astype(np.uint8)
    if kind == 1:
        yy, xx = np.mgrid[0:h, 0:w]
        a = rng.uniform(0, 6, 6)
        img = np.stack([128 + 100 * np.sin(xx / (w + 1) * a[i] + yy / (h + 1) * a[i + 3])
                        for i in range(3)], -1)
        return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{group: {(w, h): [paths]}} over every quality (and restart interval)."""
    assert native.available(), native.build_error()
    jax_native()
    root = tmp_path_factory.mktemp("jpeg")
    rng = np.random.default_rng(0)
    out = {g: {size: [] for size in SIZES} for g in GROUPS}
    for n, ((w, h), q) in enumerate(itertools.product(SIZES, QUALITIES)):
        for s, flag in SAMPLINGS.items():
            for rst in RESTARTS:
                img = frame(rng, w, h, (n + rst) % 3)
                params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if flag is None:
                    img = img[..., 0]
                else:
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]
                path = str(root / f"cv2_{s}_{w}x{h}_q{q}_rst{rst}.jpg")
                assert cv2.imwrite(path, img, params)
                out[s][(w, h)].append(path)
        path = str(root / f"port_{w}x{h}_q{q}.jpg")
        native.write_jpeg_batch([path], frame(rng, w, h, n % 3)[None], quality=q)
        out["port"][(w, h)].append(path)
    return out


@pytest.fixture(params=["cache", "no_cache"])
def cache_mode(request):
    """Both decoders with the plane cache at 512 MB (cleared), or off."""
    mb = 512 if request.param == "cache" else 0
    libs = (native, jax_native())
    for lib in libs:
        lib.decode_cache_set_budget_mb(mb)
        lib.decode_cache_clear()
    yield request.param
    for lib in libs:
        lib.decode_cache_set_budget_mb(512)
        lib.decode_cache_clear()


def _calls(entry, size, paths, rng):
    """(name, function of a native module) for each call of ``entry`` on the
    files of one stored ``size``: one call a DCT scale where the entry point
    scales."""
    w, h = size
    n = len(paths)
    calls = []
    for d in DENOMS:
        short = max(1, min(w, h) // d)
        rw, rh = max(1, w // d), max(1, h // d)
        crop = max(1, min(rw, rh) // 2)
        crops = [(int(rng.integers(0, rw - crop + 1)), int(rng.integers(0, rh - crop + 1)))
                 for _ in range(n)]
        even = 2 * max(1, min(rw, rh) // 4)
        dims = np.array([[max(2, rw), max(2, rh)]] * n, dtype=np.int32)
        if entry == "decode_resize_crop_batch":
            calls += [(f"1/{d} centre", lambda m, s=short, c=crop: m.decode_resize_crop_batch(
                paths, s, c, c)),
                (f"1/{d} crops", lambda m, s=short, c=crop, cr=crops: m.decode_resize_crop_batch(
                    paths, s, c, c, crops=cr))]
        elif entry == "decode_resize2_crop_batch":
            calls.append((f"1/{d}", lambda m, c=crop, cr=crops, dm=np.array(
                [[rw, rh]] * n, dtype=np.int32): m.decode_resize2_crop_batch(paths, dm, c, c, cr)))
        elif entry == "decode_yuv420_batch":
            calls.append((f"1/{d}", lambda m, e=even, dm=dims: m.decode_yuv420_batch(
                paths, dm, e, [(0, 0)] * n)))
        elif entry == "decode_yuv420_full_batch":
            calls.append((f"1/{d}", lambda m, dm=dims: m.decode_yuv420_full_batch(
                paths, dm, int(dm[0, 0] + 1) // 2 * 2, int(dm[0, 1] + 1) // 2 * 2)))
        elif entry == "decode_tencrop_batch":
            calls.append((f"1/{d}", lambda m, s=short, c=crop: m.decode_tencrop_batch(
                paths, s, c)))
    if entry == "decode_file":
        calls.append(("full", lambda m: np.stack([m.decode_file(p) for p in paths])))
    elif entry == "fetch_planes_batch":
        calls.append(("pad", lambda m: m.fetch_planes_batch(paths, (w + 3) // 2 * 2,
                                                            (h + 3) // 2 * 2)))
    elif entry == "probe_dims_batch":
        calls.append(("header", lambda m: m.probe_dims_batch(paths)))
    return calls


ENTRY_POINTS = ("decode_file", "decode_resize_crop_batch", "decode_resize2_crop_batch",
                "decode_yuv420_batch", "decode_yuv420_full_batch", "decode_tencrop_batch",
                "fetch_planes_batch", "probe_dims_batch")


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_equals_libjpeg_bit_for_bit(files, cache_mode, entry, group):
    rng = np.random.default_rng(1)
    jnative = jax_native()
    checked = 0
    for size, paths in files[group].items():
        for name, call in _calls(entry, size, paths, rng):
            for visit in ("cold", "warm"):  # a second call is served by the plane cache
                got, want = call(native), call(jnative)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, r in zip(got, want):
                    assert g.shape == r.shape and g.dtype == r.dtype, (size, name, visit)
                    diff = int((g != r).sum())
                    assert diff == 0, f"{entry} {group} {size} {name} {visit}: {diff} differ"
                checked += 1
    assert checked >= 2 * len(SIZES)


def test_the_plane_cache_served_the_warm_calls(files, cache_mode):
    paths = files["420"][(320, 240)]
    native.decode_yuv420_batch(paths, np.array([[320, 240]] * len(paths)), 224,
                               [(0, 0)] * len(paths))
    native.decode_yuv420_batch(paths, np.array([[320, 240]] * len(paths)), 224,
                               [(0, 0)] * len(paths))
    stats = native.decode_cache_stats()
    if cache_mode == "cache":
        assert stats["hits"] == len(paths) and stats["entries"] == len(paths), stats
    else:
        assert stats["entries"] == 0, stats


# --- refused forms ---------------------------------------------------------------------

REF_WRITER = r"""
#include <cstddef>
#include <cstdio>
#include <jpeglib.h>
#include <csetjmp>
struct Err { jpeg_error_mgr pub; jmp_buf jump; };
static void fail(j_common_ptr c) { longjmp(reinterpret_cast<Err*>(c->err)->jump, 1); }
// The settings bdvcil_torch/csrc/host/jpeg_write.cpp reproduces (mode 0), and
// forms the codec refuses: 1 arithmetic coding, 2 CMYK, 3 4:4:0 sampling.
extern "C" int ref_write(const char* path, const unsigned char* rgb, int w, int h,
                         int quality, int mode) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct c;
  Err err;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = fail;
  if (setjmp(err.jump)) { jpeg_destroy_compress(&c); fclose(f); return 1; }
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = mode == 2 ? 4 : 3;
  c.in_color_space = mode == 2 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  if (mode == 1) c.arith_code = TRUE;
  if (mode == 3) { c.comp_info[0].h_samp_factor = 1; c.comp_info[0].v_samp_factor = 2; }
  jpeg_start_compress(&c, TRUE);
  const int stride = w * c.input_components;
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + (size_t)c.next_scanline * stride);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return fclose(f) != 0;
}
"""


@pytest.fixture(scope="module")
def ref_writer(tmp_path_factory):
    """A small libjpeg writer, compiled into a temporary directory (g++ ... -ljpeg)."""
    d = tmp_path_factory.mktemp("ref_writer")
    (d / "ref_writer.cpp").write_text(REF_WRITER)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(d / "ref_writer.cpp"), "-o",
                    str(d / "libref_writer.so"), "-ljpeg"], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(d / "libref_writer.so"))
    lib.ref_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int]
    return lib


def _ref_write(lib, path, img, quality, mode=0):
    img = np.ascontiguousarray(img)
    assert lib.ref_write(str(path).encode(), img.ctypes.data, img.shape[1], img.shape[0],
                         quality, mode) == 0


@pytest.mark.parametrize("quality", QUALITIES)
def test_writer_is_byte_identical_to_libjpeg(tmp_path, ref_writer, quality):
    rng = np.random.default_rng(quality)
    for n, (w, h) in enumerate(SIZES):
        for kind in range(3):
            img = frame(rng, w, h, (n + kind) % 3)
            mine, ref = tmp_path / "port.jpg", tmp_path / "libjpeg.jpg"
            native.write_jpeg_batch([str(mine)], img[None], quality=quality)
            _ref_write(ref_writer, ref, img, quality)
            assert mine.read_bytes() == ref.read_bytes(), (w, h, kind)


def _refused(tmp_path, ref_writer, form):
    """A file of ``form`` the codec refuses, and the words its message holds."""
    rng = np.random.default_rng(5)
    img = frame(rng, 64, 48, 0)
    path = tmp_path / f"{form}.jpg"
    if form == "progressive":
        assert cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        return path, "progressive JPEG (SOF2)"
    if form == "truncated":
        assert cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        data = path.read_bytes()
        path.write_bytes(data[: len(data) // 2])
        return path, "truncated"
    if form == "arithmetic":
        _ref_write(ref_writer, path, img, 90, mode=1)
        return path, "arithmetic-coded JPEG (SOF9)"
    if form == "cmyk":
        _ref_write(ref_writer, path, np.dstack([img, img[..., :1]]), 90, mode=2)
        return path, "4-component JPEG"
    if form == "sampling_440":
        _ref_write(ref_writer, path, img, 90, mode=3)
        return path, "sampling 1x2,1x1,1x1"
    if form == "12bit":  # the frame header's precision byte says 12
        assert cv2.imwrite(str(path), img)
        data = bytearray(path.read_bytes())
        data[data.index(b"\xff\xc0") + 4] = 12
        path.write_bytes(bytes(data))
        return path, "12-bit JPEG"
    if form == "bad_huffman_table":  # three 1-bit codes: more than 1 bit can hold
        native.write_jpeg_batch([str(path)], img[None], quality=90)
        data = bytearray(path.read_bytes())
        counts = data.index(b"\xff\xc4") + 5  # the first DHT: luma DC, 0 1 5 1 ...
        assert data[counts:counts + 3] == b"\x00\x01\x05"
        data[counts:counts + 3] = b"\x03\x01\x02"  # the same 12 symbols in all
        path.write_bytes(bytes(data))
        return path, "bad Huffman table"
    if form == "huge_frame":  # a frame header of 65535 x 65535 on a 64 x 48 file
        native.write_jpeg_batch([str(path)], img[None], quality=90)
        data = bytearray(path.read_bytes())
        sof = data.index(b"\xff\xc0")
        data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
        path.write_bytes(bytes(data))
        return path, "too short for the frame's blocks"
    raise ValueError(form)


REFUSED = ("progressive", "truncated", "arithmetic", "cmyk", "sampling_440", "12bit",
           "bad_huffman_table", "huge_frame")


@pytest.mark.parametrize("form", REFUSED)
def test_refused_forms_raise_naming_the_form(tmp_path, ref_writer, form):
    path, words = _refused(tmp_path, ref_writer, form)
    p = str(path)
    calls = [lambda: native.decode_file(p),
             lambda: native.decode_resize_crop_batch([p], 32, 16, 16),
             lambda: native.decode_yuv420_batch([p], np.array([[64, 48]]), 32, [(0, 0)]),
             lambda: native.decode_yuv420_full_batch([p], np.array([[64, 48]]), 64, 48),
             lambda: native.decode_tencrop_batch([p], 32, 16)]
    if form not in ("truncated", "huge_frame"):  # their headers are whole
        calls.append(lambda: native.probe_dims_batch([p]))
    for call in calls:
        with pytest.raises(IOError, match=f"{re.escape(p)}: .*{re.escape(words)}"):
            call()
    # the plane wire reports a frame it cannot serve, as for any non-4:2:0 file
    _, _, dims = native.fetch_planes_batch([p], 64, 48)
    assert dims.tolist() == [[0, 0]]
    if form in ("progressive", "truncated"):  # the deliberate divergence: libjpeg reads both
        assert jax_native().decode_file(p).shape == (48, 64, 3)


def test_the_failure_message_is_empty_for_a_good_file(files):
    assert native.explain_failure(files["420"][(17, 9)][0]) == ""
    assert "cannot open" in native.explain_failure("/nonexistent/frame.jpg")


FUZZ_DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
#include "jpeg_codec.h"
// Mutations of each file (byte changes, in the header or anywhere, cuts,
// repeated chunks, Huffman code counts moved between lengths), each decoded to raw planes and to RGB at 1/1 to 1/8:
// every one decodes or throws Failure; the sanitizers catch anything else.
int main(int argc, char** argv) {
  std::mt19937 rng(std::atoi(argv[1]));
  const int rounds = std::atoi(argv[2]);
  long decoded = 0, refused = 0;
  for (int a = 3; a < argc; ++a) {
    std::vector<uint8_t> base;
    bdvc_jpeg::read_file(argv[a], base);
    for (int it = 0; it < rounds; ++it) {
      std::vector<uint8_t> d = base;
      const size_t n = d.size();
      switch (rng() % 5) {
        case 4: {  // move code counts between lengths of a DHT, the total kept
          size_t c = 0;
          for (size_t i = 0; i + 21 < n && !c; ++i)
            if (d[i] == 0xFF && d[i + 1] == 0xC4) c = i + 5;
          if (!c) break;
          const int from = rng() % 16, to = rng() % 16;
          const int k = std::min<int>(d[c + from], 1 + rng() % 4);
          d[c + from] -= k;
          d[c + to] += k;
          break;
        }
        case 0: for (int i = 1 + rng() % 8; i > 0; --i) d[rng() % n] = rng() & 255; break;
        case 1: d.resize(rng() % n); break;
        case 2: {
          const size_t at = rng() % n, from = rng() % n, len = rng() % (n - from);
          std::vector<uint8_t> chunk(d.begin() + from, d.begin() + from + len);
          d.insert(d.begin() + at, chunk.begin(), chunk.end());
          break;
        }
        default: d[2 + rng() % (std::min<size_t>(n, 700) - 2)] = rng() & 255;
      }
      for (int mode = 0; mode < 5; ++mode) {
        try {
          bdvc_jpeg::Decoder dec(d.data(), d.size());
          std::vector<uint8_t> out, y, cb, cr;
          int w, h, ys, cs;
          if (mode == 4) {
            if (dec.is_ycc420()) dec.decode_raw420(y, cb, cr, ys, cs);
          } else {
            dec.decode_rgb(1 << mode, out, w, h);
          }
          ++decoded;
        } catch (const bdvc_jpeg::Failure&) {
          ++refused;
        }
      }
    }
  }
  std::printf("decoded %ld refused %ld\n", decoded, refused);
  return 0;
}
"""


def test_corrupt_files_decode_or_raise_under_the_sanitizers(files, tmp_path):
    """Mutated files through the codec built with AddressSanitizer and
    UBSan: each decodes or is refused; no out-of-bounds access, no signed
    overflow (libjpeg computes the IDCTs in 64-bit JLONG), no unbounded
    allocation, no other exception."""
    src = tmp_path / "fuzz.cpp"
    src.write_text(FUZZ_DRIVER)
    exe = tmp_path / "fuzz"
    subprocess.run(["g++", "-O1", "-std=c++17", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", f"-I{native.CODEC_SRC.parent}", str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    seeds = [files["420"][(321, 241)][2], files["422"][(17, 9)][1], files["444"][(8, 8)][3],
             files["gray"][(340, 256)][0], files["port"][(320, 240)][0]]
    res = subprocess.run([str(exe), "7", "150", *seeds], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    decoded, refused = (int(v) for v in re.findall(r"\d+", res.stdout))
    assert decoded > 0 and refused > 0, res.stdout
