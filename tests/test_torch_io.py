"""The port's io/: the cases of tests/test_io.py against
bevy_raytrace_tpu_torch.io, the same bytes as the JAX package's io for the
same array, and torch tensors in."""

import os

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch.io import native, tonemap, write_exr, write_png, write_ppm
from bevy_raytrace_tpu_torch.io.image import _write_png_py


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return rng.random((13, 17, 3), dtype=np.float32)


def test_native_library_builds():
    assert native.load() is not None, native.BUILD_ERROR
    assert native.route() == "native"
    assert native.library_path().parent.name == "_build"


def test_tonemap_matches_reference_formula(img):
    got = tonemap(img)
    want = (np.sqrt(np.clip(img, 0, 1)) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_tonemap_clips():
    x = np.array([[[-1.0, 0.0, 2.0]]], np.float32)
    np.testing.assert_array_equal(tonemap(x)[0, 0], [0, 0, 255])


def test_png_roundtrip(img, tmp_path):
    from PIL import Image

    p = os.path.join(tmp_path, "x.png")
    write_png(p, img)
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back, tonemap(img))


def test_png_native_matches_python(img, tmp_path):
    from PIL import Image

    pn = os.path.join(tmp_path, "n.png")
    pp = os.path.join(tmp_path, "p.png")
    write_png(pn, img)  # native path (asserted built above)
    _write_png_py(pp, tonemap(img))
    np.testing.assert_array_equal(
        np.asarray(Image.open(pn)), np.asarray(Image.open(pp))
    )


def test_ppm_roundtrip(img, tmp_path):
    p = os.path.join(tmp_path, "x.ppm")
    write_ppm(p, img)
    with open(p, "rb") as f:
        assert f.readline() == b"P6\n"
        w, h = map(int, f.readline().split())
        assert f.readline() == b"255\n"
        data = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
    np.testing.assert_array_equal(data, tonemap(img))


def test_exr_roundtrip_exact(img, tmp_path):
    """EXR is linear float32 — lossless round trip through OpenEXR/imageio
    if available, else validate the header manually."""
    p = os.path.join(tmp_path, "x.exr")
    write_exr(p, img)
    try:
        import OpenEXR  # noqa
        have_reader = True
    except ImportError:
        have_reader = False
    if have_reader:
        import Imath, OpenEXR

        f = OpenEXR.InputFile(p)
        dw = f.header()["dataWindow"]
        w = dw.max.x - dw.min.x + 1
        h = dw.max.y - dw.min.y + 1
        pt = Imath.PixelType(Imath.PixelType.FLOAT)
        chans = [
            np.frombuffer(f.channel(c, pt), np.float32).reshape(h, w)
            for c in ("R", "G", "B")
        ]
        back = np.stack(chans, axis=-1)
        np.testing.assert_array_equal(back, img)
    else:
        with open(p, "rb") as f:
            magic, version = np.frombuffer(f.read(8), np.uint32)
        assert magic == 20000630
        assert version == 2
        # data payload present: header + offsets + h*(8 + w*3*4) bytes
        assert os.path.getsize(p) > img.shape[0] * img.shape[1] * 3 * 4


def test_assemble_tiles_native_and_fallback():
    """Stripe assembly (the multi-host IO gather) must reproduce the
    full framebuffer exactly, with the native brt_assemble_tiles and the
    numpy fallback agreeing."""
    import numpy as np

    from bevy_raytrace_tpu_torch.io import assemble_tiles
    from bevy_raytrace_tpu_torch.io import native as native_mod

    rng = np.random.RandomState(3)
    full = rng.rand(300, 3).astype(np.float32)
    splits = [0, 80, 128, 300]
    tiles = [full[a:b] for a, b in zip(splits[:-1], splits[1:])]
    got = assemble_tiles(tiles, splits[:-1], 300)
    np.testing.assert_array_equal(got, full)

    # numpy fallback path (force lib absent)
    orig = native_mod.load
    native_mod.load = lambda: None
    try:
        got2 = assemble_tiles(tiles, splits[:-1], 300)
    finally:
        native_mod.load = orig
    np.testing.assert_array_equal(got2, full)


def test_frame_writer_matches_sync_writes(tmp_path):
    """Async writeback (native worker pool) produces byte-identical files
    to the synchronous path — same encoders behind a queue."""
    from bevy_raytrace_tpu_torch.io import FrameWriter, write_image

    rng = np.random.default_rng(7)
    frames = [rng.random((24, 32, 3), np.float32).astype(np.float32)
              for _ in range(5)]
    with FrameWriter(n_threads=3) as fw:
        for i, img in enumerate(frames):
            fw.submit(str(tmp_path / f"a_{i}.png"), img)
            fw.submit(str(tmp_path / f"a_{i}.ppm"), img)
    for i, img in enumerate(frames):
        write_image(str(tmp_path / f"s_{i}.png"), img)
        write_image(str(tmp_path / f"s_{i}.ppm"), img)
        for ext in ("png", "ppm"):
            a = (tmp_path / f"a_{i}.{ext}").read_bytes()
            s = (tmp_path / f"s_{i}.{ext}").read_bytes()
            assert a == s, f"frame {i} .{ext} differs"


def test_frame_writer_u8_frames(tmp_path):
    """Pre-tone-mapped uint8 frames (the device-side tone-map path used
    by cli animate) encode byte-identically to tone-mapping the same
    linear floats on the host, interleave with float submissions, and
    are rejected for EXR (which needs linear float)."""
    import pytest

    from bevy_raytrace_tpu_torch.io import FrameWriter, write_image
    from bevy_raytrace_tpu_torch.io.image import tonemap

    rng = np.random.default_rng(11)
    lin = rng.random((24, 32, 3), np.float32).astype(np.float32)
    u8 = tonemap(lin)
    with FrameWriter() as fw:
        fw.submit(str(tmp_path / "u8.png"), u8)
        fw.submit(str(tmp_path / "f32.png"), lin)  # mixed queues drain
        with pytest.raises(ValueError, match="EXR"):
            fw.submit(str(tmp_path / "u8.exr"), u8)
    write_image(str(tmp_path / "sync.png"), lin)
    assert ((tmp_path / "u8.png").read_bytes()
            == (tmp_path / "sync.png").read_bytes())
    assert ((tmp_path / "f32.png").read_bytes()
            == (tmp_path / "sync.png").read_bytes())


def test_frame_writer_submit_returns_before_write(tmp_path):
    """submit() copies the buffer: mutating the source after submit must
    not corrupt the output."""
    from bevy_raytrace_tpu_torch.io import FrameWriter, write_image

    img = np.full((16, 16, 3), 0.25, np.float32)
    ref = str(tmp_path / "ref.png")
    write_image(ref, img.copy())
    with FrameWriter() as fw:
        fw.submit(str(tmp_path / "async.png"), img)
        img[:] = 0.9  # trash the source immediately
    assert (tmp_path / "async.png").read_bytes() == open(ref, "rb").read()


def test_frame_writer_error_surfaces_on_wait(tmp_path):
    """A failing frame (unwritable directory) raises at wait(), not
    silently."""
    import pytest as _pytest

    from bevy_raytrace_tpu_torch.io import FrameWriter

    img = np.zeros((8, 8, 3), np.float32)
    fw = FrameWriter()
    try:
        fw.submit(str(tmp_path / "no_such_dir" / "x.png"), img)
        with _pytest.raises((IOError, OSError)):
            fw.wait()
    finally:
        fw.close()


def test_frame_writer_rejects_bad_inputs(tmp_path):
    from bevy_raytrace_tpu_torch.io import FrameWriter

    with FrameWriter() as fw:
        import pytest as _pytest

        with _pytest.raises(ValueError, match="extension"):
            fw.submit(str(tmp_path / "x.bmp"), np.zeros((4, 4, 3), np.float32))


def test_assemble_tiles_length_mismatch_rejected():
    from bevy_raytrace_tpu_torch.io import assemble_tiles

    tiles = [np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32)]
    with pytest.raises(ValueError, match="starts"):
        assemble_tiles(tiles, [0], 8)


# --- against the JAX package's io, and tensors in ---------------------------


def test_bytes_equal_the_reference(img, tmp_path):
    """PNG (in memory and on disk), PPM and EXR bytes equal the JAX
    package's for the same array."""
    from bevy_raytrace_tpu import io as ref_io
    from bevy_raytrace_tpu_torch import io as port_io

    np.testing.assert_array_equal(port_io.tonemap(img), ref_io.tonemap(img))
    assert port_io.png_bytes(img) == ref_io.png_bytes(img)
    for ext in ("png", "ppm", "exr"):
        a, b = str(tmp_path / f"port.{ext}"), str(tmp_path / f"ref.{ext}")
        port_io.write_image(a, img)
        ref_io.write_image(b, img)
        assert open(a, "rb").read() == open(b, "rb").read(), ext


def test_torch_tensor_in(img, tmp_path):
    """A torch tensor (with a graph attached, non-contiguous, or uint8)
    goes through every entry point like the array it holds."""
    from bevy_raytrace_tpu_torch.io import (
        FrameWriter,
        assemble_tiles,
        png_bytes,
        write_image,
    )

    t = torch.from_numpy(img.copy()).requires_grad_(True)
    np.testing.assert_array_equal(tonemap(t), tonemap(img))
    assert png_bytes(t) == png_bytes(img)
    u8 = torch.from_numpy(tonemap(img))
    assert png_bytes(u8) == png_bytes(img)
    tr = torch.from_numpy(np.ascontiguousarray(img.transpose(1, 0, 2)))
    assert png_bytes(tr.permute(1, 0, 2)) == png_bytes(img)
    for ext in ("png", "ppm", "exr"):
        a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"n.{ext}")
        write_image(a, t)
        write_image(b, img)
        assert open(a, "rb").read() == open(b, "rb").read(), ext
    with FrameWriter() as fw:
        fw.submit(str(tmp_path / "fw.png"), t)
        fw.submit(str(tmp_path / "fw_u8.png"), u8)
    want = open(str(tmp_path / "n.png"), "rb").read()
    assert (tmp_path / "fw.png").read_bytes() == want
    assert (tmp_path / "fw_u8.png").read_bytes() == want
    full = torch.from_numpy(img.reshape(-1, 3).copy())
    got = assemble_tiles([full[:100], full[100:]], [0, 100], full.shape[0])
    np.testing.assert_array_equal(got, full.numpy())


def test_frame_writer_copies_u8_frames(tmp_path):
    """A uint8 frame is copied by submit() too: a staging buffer may be
    reused as soon as submit returns."""
    from bevy_raytrace_tpu_torch.io import FrameWriter, write_image

    u8 = np.full((16, 16, 3), 64, np.uint8)
    write_image(str(tmp_path / "ref.png"), u8.copy())
    with FrameWriter() as fw:
        fw.submit(str(tmp_path / "async.png"), u8)
        u8[:] = 200
    assert ((tmp_path / "async.png").read_bytes()
            == (tmp_path / "ref.png").read_bytes())
