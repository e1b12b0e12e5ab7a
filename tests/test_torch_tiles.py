"""The port's tile decoding against the JAX package's on the same files.

``decode_tile_paths`` gives the same uint8 bytes in both packages: through
the native threaded loader (each package builds its own copy of the same
source), through PIL, and for a chunk that mixes JPEG and PNG; ``scaled_dct``
on sources of twice the tile size. ``parse_coords`` and
``imagenet_normalize`` are exact copies."""

import numpy as np
import pytest
from PIL import Image

from transmil_deepgraft_tpu.data import native_tiles as jax_native
from transmil_deepgraft_tpu.data.jpg_bags import parse_coords as jax_parse_coords
from transmil_deepgraft_tpu.data.transforms import imagenet_normalize as jax_normalize
from transmil_deepgraft_tpu.inference import decode_tile_paths as jax_decode
from transmil_deepgraft_tpu_torch.data import native_tiles
from transmil_deepgraft_tpu_torch.data.tiles import imagenet_normalize, parse_coords
from transmil_deepgraft_tpu_torch.inference import decode_tile_paths

SIZE = 32


def _write(tmp_path, rng, n, size, ext, start=0):
    paths = []
    for i in range(start, start + n):
        arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        p = tmp_path / f"tile_({i}-{2 * i}){ext}"
        Image.fromarray(arr).save(p, **({"quality": 90} if ext == ".jpg" else {}))
        paths.append(p)
    return paths


@pytest.fixture
def native_or_skip():
    if not (native_tiles.available() and jax_native.available()):
        pytest.skip("no libjpeg headers or compiler here: the native loader cannot build")


def test_native_loader_builds_outside_the_jax_package(native_or_skip):
    so = native_tiles.library_path()
    assert so.exists() and so.parts[-4:-2] == ("build", "native")
    assert native_tiles.SOURCE.read_bytes() == (
        jax_native.Path(jax_native.__file__).parents[1] / "native" / "tileloader.cpp").read_bytes()


@pytest.mark.parametrize("scaled_dct", [False, True], ids=["full", "scaled_dct"])
@pytest.mark.parametrize("source", [SIZE, 2 * SIZE + 8], ids=["same_size", "2x_source"])
def test_native_route_matches_jax_byte_for_byte(native_or_skip, tmp_path, source, scaled_dct):
    paths = _write(tmp_path, np.random.default_rng(source), 5, source, ".jpg")
    got = decode_tile_paths(paths, SIZE, scaled_dct=scaled_dct)
    want = jax_decode(paths, SIZE, scaled_dct=scaled_dct)
    assert got.dtype == np.uint8 and got.shape == (5, SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)
    normalized, n_ok = native_tiles.load_tiles(paths, SIZE, scaled_dct=scaled_dct)
    want_n, want_ok = jax_native.load_tiles(paths, SIZE, scaled_dct=scaled_dct)
    assert n_ok == want_ok == 5
    np.testing.assert_array_equal(normalized, want_n)


@pytest.mark.parametrize("source", [SIZE, 2 * SIZE + 8], ids=["same_size", "resized"])
def test_pil_route_matches_jax_byte_for_byte(tmp_path, monkeypatch, source):
    """With the native loader off in both packages, every tile goes through
    PIL (convert to RGB, resize only when the size differs)."""
    monkeypatch.setattr(native_tiles, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    rng = np.random.default_rng(source + 1)
    paths = _write(tmp_path, rng, 3, source, ".jpg") + _write(tmp_path, rng, 2, source, ".png", 3)
    got = decode_tile_paths(paths, SIZE)
    np.testing.assert_array_equal(got, jax_decode(paths, SIZE))


def test_mixed_chunk_and_failed_decode_take_pil(tmp_path):
    """A chunk with a PNG in it decodes tile by tile with PIL in both
    packages, whatever loader is available; a JPEG that fails in the native
    loader sends its whole chunk to PIL, which then raises."""
    rng = np.random.default_rng(5)
    paths = _write(tmp_path, rng, 3, SIZE, ".jpg") + _write(tmp_path, rng, 1, SIZE, ".png", 3)
    got = decode_tile_paths(paths, SIZE)
    np.testing.assert_array_equal(got, jax_decode(paths, SIZE))
    np.testing.assert_array_equal(got[3], np.asarray(Image.open(paths[3]).convert("RGB")))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(OSError):
        decode_tile_paths(paths[:2] + [bad], SIZE)


def test_parse_coords_and_normalize_are_exact():
    for name in ("tile_(12-7).jpg", "x_(0-0)_(3-4).png", "no_coords.jpg", "(123456-9).jpeg"):
        assert parse_coords(name) == jax_parse_coords(name)
    img = np.random.default_rng(0).integers(0, 256, (4, 5, 3), dtype=np.uint8)
    got = imagenet_normalize(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_normalize(img))
