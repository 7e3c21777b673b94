"""The port's LAION loader (``data/laion.py``, ``data/png.py``, ``obs/images.py::resize_u8``)
against JAX's (``tinydiffusion_tpu/data/laion.py``) and Pillow, on the CPU.

Both packages' ``LAIONImageTextDataset`` read the same records: synthetic
ones and http ones served by a loopback server in a thread (a JPEG, a 4:4:4
JPEG and an RGBA PNG from ``tests/fixtures/``, a 503 then a 200, a 429 with
a Retry-After, a 404, a lasting 503, a black image, a short body, a cut
JPEG, a file that is no image). Each package has its own cache directory;
the arrays, the cache files, the failed-URL lists and the request counts
must be equal, and each package must read the other's warm cache as its
own. Pillow is an oracle here; the port never imports it, nor requests,
urllib3 or datasets.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_tpu.experiments import vae_laion as jax_vae_laion
from tinydiffusion_torch.data import laion
from tinydiffusion_torch.data.jpeg import encode_jpeg
from tinydiffusion_torch.data.png import decode_png
from tinydiffusion_torch.experiments import conditional_diffusion_laion, vae_laion
from tinydiffusion_torch.obs.images import resize_u8

FIXTURES = Path(__file__).parent / "fixtures"
SIZE = 64


# --- PNG and the resize against Pillow ---------------------------------------------


def _png(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG", **kw)
    return buf.getvalue()


def _pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _test_image(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1]))[..., None]
            * np.array([3, 5, 7])) % 256
    return np.where(rng.random(shape + (1,)) < 0.3, noise, ramp).astype(np.uint8)


_PNG_MODES = {
    "RGB": lambda a: Image.fromarray(a),
    "RGBA": lambda a: Image.fromarray(np.dstack([a, a[..., 1]]), "RGBA"),
    "L": lambda a: Image.fromarray(a[..., 0]),
    "LA": lambda a: Image.fromarray(a[..., 0]).convert("LA"),
    "1": lambda a: Image.fromarray(a[..., 0]).convert("1"),
    "P": lambda a: Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=200),
    "P16": lambda a: Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=16),
    "P4": lambda a: Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=4),
    "P2": lambda a: Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=2),
}


@pytest.mark.parametrize("mode", sorted(_PNG_MODES))
def test_decode_png_equals_pillow_for_each_colour_type(mode):
    """Every colour type and bit depth Pillow writes (palettes of 1, 2, 4 and
    8 bits, a 1-bit greyscale), each with Pillow's default filters and with
    ``optimize``, at sizes whose rows do not fill whole bytes."""
    for shape in ((1, 1), (7, 13), (33, 17)):
        image = _PNG_MODES[mode](_test_image(shape, shape[0]))
        kws = [{}, {"optimize": True}]
        if mode.startswith("P") and mode != "P":
            kws.append({"bits": {"P16": 4, "P4": 2, "P2": 1}[mode]})
        for kw in kws:
            data = _png(image, **kw)
            np.testing.assert_array_equal(decode_png(data), _pillow_rgb(data),
                                          err_msg=f"{mode} {shape} {kw}")


def test_decode_png_reads_the_fixture_and_refuses_broken_files():
    data = (FIXTURES / "laion_loader_rgba.png").read_bytes()
    np.testing.assert_array_equal(decode_png(data), _pillow_rgb(data))
    with pytest.raises(ValueError, match="truncated|corrupt"):
        decode_png(data[:len(data) // 2])
    broken = bytearray(data)
    broken[40] ^= 0xFF  # inside the first chunk after IHDR: its CRC fails
    with pytest.raises(ValueError, match="CRC|corrupt"):
        decode_png(bytes(broken))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


@pytest.mark.parametrize("source,target", [
    ((256, 256), (64, 64)), ((100, 76), (64, 64)), ((76, 100), (64, 64)), ((48, 40), (64, 64)),
    ((64, 64), (256, 256)), ((300, 200), (64, 64)), ((9, 5), (64, 64)), ((1, 1), (3, 3)),
    ((200, 300), (13, 7)), ((65, 63), (64, 64)),
])
def test_resize_equals_pillow_bilinear(source, target):
    """Down- and up-scales, non-square inputs and outputs: Pillow 12.1's
    ``resize(size, BILINEAR)`` byte for byte (its support widens by the
    scale when downscaling)."""
    image = _test_image(source, source[0] * 7 + source[1])
    want = np.asarray(Image.fromarray(image).resize(target[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(resize_u8(image, target[1], target[0], "bilinear"), want)


# --- the loopback server ------------------------------------------------------------


def _jpeg(i: int, shape=(80, 96)) -> bytes:
    """A non-square synthetic JPEG as a web server would serve it (resized
    on read)."""
    image = laion.synthesize_image(i, max(shape))[0][:shape[0], :shape[1]]
    return encode_jpeg(image, 90)


_BLACK = _png(Image.new("RGB", (SIZE, SIZE)))


def _routes() -> dict:
    """The server's routes: name -> (hit -> (status, headers, body)); the
    request count is per path, query included."""
    photo444 = (FIXTURES / "laion_loader_444.jpg").read_bytes()
    rgba = (FIXTURES / "laion_loader_rgba.png").read_bytes()
    short = _jpeg(11)
    return {
        "photo.jpg": lambda hit: (200, {}, _jpeg(3)),
        "photo444.jpg": lambda hit: (200, {}, photo444),
        "rgba.png": lambda hit: (200, {}, rgba),
        # a 503, then the image
        "flaky.jpg": lambda hit: (503, {}, b"busy") if hit == 1 else (200, {}, _jpeg(7)),
        # a 429 that asks for a second's wait, then the image
        "later.jpg": lambda hit: ((429, {"Retry-After": "1"}, b"slow down") if hit == 1
                                  else (200, {}, _jpeg(9))),
        "down.jpg": lambda hit: (503, {}, b"down"),
        "black.png": lambda hit: (200, {}, _BLACK),
        # a Content-Length the body never reaches
        "short.jpg": lambda hit: (200, {"Content-Length": str(len(short))},
                                  short[:len(short) // 2]),
        "cut.jpg": lambda hit: (200, {}, _jpeg(13)[:700]),  # a whole response of half a JPEG
        "text.jpg": lambda hit: (200, {}, b"<html>not an image</html>"),
    }


@pytest.fixture(scope="module")
def server():
    """``chip_smoke.py``'s loopback server (127.0.0.1, a thread) on ``_routes``."""
    import chip_smoke

    s = chip_smoke._LoopbackServer(_routes())
    yield s
    s.close()


_HTTP = ("photo.jpg", "photo444.jpg", "rgba.png", "flaky.jpg", "later.jpg", "missing.jpg",
         "down.jpg", "black.png", "short.jpg", "cut.jpg", "text.jpg")


def _records(server, tag: str) -> list[dict]:
    """Synthetic records and one of each http case (the query keeps each
    package's request counts apart); record 2 has no caption."""
    records = laion.load_laion_dataset(4)
    records[2] = {"URL": records[2]["URL"], "TEXT": ""}
    return records + [{"URL": f"{server.base}/{name}?{tag}", "TEXT": f"web {name}"}
                      for name in _HTTP]


def _datasets(tmp_path, records_jax, records_port, **kw):
    jax_ds = jax_laion.LAIONImageTextDataset(
        records_jax, cache_dir=str(tmp_path / "jax_cache"),
        failed_urls_cache=str(tmp_path / "jax_failed.json"), image_size=SIZE, **kw)
    port_ds = laion.LAIONImageTextDataset(
        records_port, cache_dir=str(tmp_path / "port_cache"),
        failed_urls_cache=str(tmp_path / "port_failed.json"), image_size=SIZE, **kw)
    return jax_ds, port_ds


def _cache(path) -> dict[str, bytes]:
    return {name: (Path(path) / name).read_bytes() for name in sorted(os.listdir(path))}


def _urls_as(urls, tag: str, to: str) -> list[str]:
    return sorted(u.replace(f"?{tag}", f"?{to}") for u in urls)


def test_datasets_give_equal_arrays_caches_and_failures(server, tmp_path):
    """Cold reads: equal arrays for every record, equal cache files (the
    port's bytes are Pillow's), the same failed URLs and the same number of
    requests a case (one retry on 503 and 429, none on 404); the 429's
    Retry-After is slept. Then warm reads, each package of its own cache
    and of the other's: equal arrays again."""
    records_jax, records_port = _records(server, "jax"), _records(server, "port")
    jax_ds, port_ds = _datasets(tmp_path, records_jax, records_port, normalize=False,
                                on_error="zero", as_uint8=True)
    t0 = time.perf_counter()
    cold_port = [port_ds[i] for i in range(len(port_ds))]
    port_seconds = time.perf_counter() - t0
    cold_jax = [jax_ds[i] for i in range(len(jax_ds))]
    for i, ((a, ta), (b, tb)) in enumerate(zip(cold_jax, cold_port)):
        assert ta == tb and a.dtype == b.dtype == np.uint8, i
        np.testing.assert_array_equal(b, a, err_msg=records_port[i]["URL"])
    assert port_seconds >= 1.0  # the Retry-After: 1
    # The cache names hash the URL; the queries differ, so compare by record.
    for rj, rp in zip(records_jax, records_port):
        pj, pp = jax_ds._cache_path(rj["URL"]), port_ds._cache_path(rp["URL"])
        assert os.path.exists(pj) == os.path.exists(pp), rp["URL"]
        if os.path.exists(pj):
            assert Path(pj).read_bytes() == Path(pp).read_bytes(), rp["URL"]
    failed_jax = json.loads((tmp_path / "jax_failed.json").read_text())
    failed_port = json.loads((tmp_path / "port_failed.json").read_text())
    assert _urls_as(failed_port, "port", "x") == _urls_as(failed_jax, "jax", "x")
    assert {u.split("/")[-1].split("?")[0] for u in failed_port} == {
        "missing.jpg", "down.jpg", "black.png", "short.jpg", "cut.jpg", "text.jpg"}
    for name in _HTTP:
        assert server.hits[f"/{name}?port"] == server.hits[f"/{name}?jax"], name
    assert server.hits["/flaky.jpg?port"] == server.hits["/down.jpg?port"] == 2
    assert server.hits["/missing.jpg?port"] == 1
    # Warm: each package reads its own cache and the other's.
    swapped = tmp_path / "swapped"
    shutil.copytree(tmp_path / "jax_cache", swapped / "port_cache")
    shutil.copytree(tmp_path / "port_cache", swapped / "jax_cache")
    warm_jax = [jax_ds[i][0] for i in range(len(jax_ds))]
    warm_port = [port_ds[i][0] for i in range(len(port_ds))]
    for a, b in zip(warm_jax, warm_port):
        np.testing.assert_array_equal(b, a)
    # The other's files, renamed to this package's URLs.
    for name, ds, records, other in (("port", port_ds, records_port, records_jax),
                                     ("jax", jax_ds, records_jax, records_port)):
        cache = swapped / f"{name}_cache"
        for mine, theirs in zip(records, other):
            src = cache / os.path.basename(ds._cache_path(theirs["URL"]))
            if src.exists():
                os.replace(src, cache / os.path.basename(ds._cache_path(mine["URL"])))
    jax_swapped, port_swapped = _datasets(swapped, records_jax, records_port, normalize=False,
                                          on_error="zero", as_uint8=True)
    for i in range(len(records_port)):
        np.testing.assert_array_equal(port_swapped[i][0], warm_jax[i])
        np.testing.assert_array_equal(jax_swapped[i][0], warm_port[i])


def test_on_error_normalize_and_precache(server, tmp_path):
    """``on_error="raise"`` raises ValueError for a failed record in both
    packages; ``"zero"`` gives literal zeros whatever the normalisation; the
    float outputs are equal; ``precache_dataset`` keeps the same sorted
    valid indices (no caption, failed fetches and black images out)."""
    records_jax, records_port = _records(server, "jax2"), _records(server, "port2")
    for normalize in (False, True):
        jax_ds, port_ds = _datasets(tmp_path / str(normalize), records_jax, records_port,
                                    normalize=normalize, on_error="zero")
        for i in range(len(records_port)):
            a, b = jax_ds[i][0], port_ds[i][0]
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(b, a)
    jax_ds, port_ds = _datasets(tmp_path / "raise", records_jax, records_port, on_error="raise",
                                as_uint8=True)
    missing = next(i for i, r in enumerate(records_port) if "missing" in r["URL"])
    for ds in (jax_ds, port_ds):
        with pytest.raises(ValueError, match="Failed to load sample"):
            ds[missing]
    jax_ds, port_ds = _datasets(tmp_path / "pre", records_jax, records_port, on_error="raise",
                                as_uint8=True)
    valid = laion.precache_dataset(port_ds)
    assert valid == jax_laion.precache_dataset(jax_ds)
    assert valid == [0, 1, 3, 4, 5, 6, 7, 8]  # synthetic 0, 1, 3 and the five good http
    with pytest.raises(ValueError, match="on_error"):
        laion.LAIONImageTextDataset([], str(tmp_path / "c"), str(tmp_path / "f.json"),
                                    on_error="skip")


def test_corrupted_cache_is_fetched_again(tmp_path):
    """A cache file that does not decode is deleted and fetched again, in
    both packages, which then write equal files and return equal arrays; a
    failed-URL list that is not JSON is dropped."""
    records = laion.load_laion_dataset(3)
    jax_ds, port_ds = _datasets(tmp_path, records, records, as_uint8=True)
    for ds in (jax_ds, port_ds):
        for i in range(3):
            ds[i]
        path = ds._cache_path(records[1]["URL"])
        Path(path).write_bytes(Path(path).read_bytes()[:300])  # a truncated JPEG
        Path(ds._cache_path(records[2]["URL"])).write_bytes(b"garbage")
    for i in range(3):
        np.testing.assert_array_equal(port_ds[i][0], jax_ds[i][0])
    assert _cache(tmp_path / "port_cache") == _cache(tmp_path / "jax_cache")
    (tmp_path / "bad.json").write_text("{not json")
    ds = laion.LAIONImageTextDataset(records, str(tmp_path / "c"), str(tmp_path / "bad.json"))
    assert ds.failed_urls == set()


def test_failed_urls_persist_across_instances(server, tmp_path):
    """A URL that failed once is refused from the saved list by a new
    instance of either package, without a request."""
    url = f"{server.base}/missing.jpg?persist"
    records = [{"URL": url, "TEXT": "x"}]
    port_ds = laion.LAIONImageTextDataset(records, str(tmp_path / "c"), str(tmp_path / "f.json"),
                                          on_error="zero", as_uint8=True)
    assert not port_ds[0][0].any() and server.hits[f"/missing.jpg?persist"] == 1
    for cls in (laion.LAIONImageTextDataset, jax_laion.LAIONImageTextDataset):
        again = cls(records, str(tmp_path / "c"), str(tmp_path / "f.json"), on_error="raise",
                    as_uint8=True)
        with pytest.raises(ValueError, match="Failed URL"):
            again[0]
    assert server.hits[f"/missing.jpg?persist"] == 1
    assert json.loads((tmp_path / "f.json").read_text()) == [url]


def test_fetch_times_out_and_retries_once(server, tmp_path, monkeypatch):
    """The timeout is ``FETCH_TIMEOUT_S``: a server that never answers in
    time is asked twice (one retry), then the record fails. Other schemes
    than http(s) fail as requests fails on them."""
    import socket

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(8)  # accepts, never answers
    monkeypatch.setattr(laion, "FETCH_TIMEOUT_S", 0.2)
    url = f"http://127.0.0.1:{listener.getsockname()[1]}/slow.jpg"
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        laion.http_get(url)
    assert 0.35 < time.perf_counter() - t0 < 3.0
    listener.close()
    records = [{"URL": "file:///etc/hostname", "TEXT": "x"}]
    ds = laion.LAIONImageTextDataset(records, str(tmp_path / "c"), str(tmp_path / "f.json"),
                                     on_error="raise", as_uint8=True)
    with pytest.raises(ValueError, match="download failed"):
        ds[0]


def test_online_dataset_needs_the_datasets_package(monkeypatch, tmp_path):
    """``offline=False`` imports ``datasets`` and, without it, raises JAX's
    RuntimeError (nothing is fetched here: the package is refused first)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="'datasets' package"):
        laion.load_laion_dataset(3, offline=False)
    config = vae_laion.VAELaionConfig(image_size=32, n_records=4, offline=False, device="cpu",
                                      out_dir=str(tmp_path / "o"),
                                      image_cache_dir=str(tmp_path / "c"),
                                      failed_urls_cache=str(tmp_path / "f.json"))
    with pytest.raises(RuntimeError, match="'datasets' package"):
        vae_laion.load_images(config)


def test_disk_space_check(tmp_path):
    laion.check_disk_space(str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="free disk"):
        laion.check_disk_space(str(tmp_path), 1 << 62)


# --- the two runs' data: Fault 1 -----------------------------------------------------


def test_vae_load_images_equals_jax_on_a_warm_cache(tmp_path):
    """JAX's conv-VAE ``load_images`` reads each record once through its
    cache: a second run on the same ``image_cache_dir`` trains on the JPEG
    decodes. The port's equals it byte for byte, cold and warm, and reading
    JAX's warm cache."""
    fields = dict(image_size=48, n_records=10)
    jax_config = jax_vae_laion.VAELaionConfig(
        **fields, image_cache_dir=str(tmp_path / "jax"),
        failed_urls_cache=str(tmp_path / "jax.json"))
    port_config = vae_laion.VAELaionConfig(
        **fields, image_cache_dir=str(tmp_path / "port"),
        failed_urls_cache=str(tmp_path / "port.json"))
    jax_cold, jax_warm = (jax_vae_laion.load_images(jax_config) for _ in range(2))
    port_cold, port_warm = (vae_laion.load_images(port_config) for _ in range(2))
    np.testing.assert_array_equal(port_cold, jax_cold)
    np.testing.assert_array_equal(port_warm, jax_warm)
    assert (jax_cold != jax_warm).any()  # the cache is lossy: warm differs from cold
    assert _cache(tmp_path / "port") == _cache(tmp_path / "jax")
    on_jax = vae_laion.VAELaionConfig(**fields, image_cache_dir=str(tmp_path / "jax"),
                                      failed_urls_cache=str(tmp_path / "jax.json"))
    np.testing.assert_array_equal(vae_laion.load_images(on_jax), jax_warm)


def test_conditional_records_equal_jax(tmp_path):
    """The text-conditional run's images and captions
    (``conditional_diffusion_laion.load_records``) equal what JAX's ``run``
    stacks: ``precache_dataset``, then a warm read of each valid record."""
    n, size = 12, 48
    records = jax_laion.load_laion_dataset(n)
    ds = jax_laion.LAIONImageTextDataset(
        records, cache_dir=str(tmp_path / "jax"), failed_urls_cache=str(tmp_path / "jax.json"),
        image_size=size, normalize=True, on_error="raise", as_uint8=True)
    valid = jax_laion.precache_dataset(ds)
    items = [ds[i] for i in valid]
    config = conditional_diffusion_laion.LaionDiffusionConfig(
        n_records=n, image_size=size, image_cache_dir=str(tmp_path / "port"),
        failed_urls_cache=str(tmp_path / "port.json"))
    images, texts = conditional_diffusion_laion.load_records(config)
    np.testing.assert_array_equal(images, np.stack([x for x, _ in items]))
    assert texts == [t for _, t in items]
    assert _cache(tmp_path / "port") == _cache(tmp_path / "jax")


def test_loader_fixture_digests_are_pillows():
    """``chip_smoke.py``'s laion_loader phase holds the port's decodes and
    resizes of every fixture (one or more of each format the loader reads)
    to these digests on a machine without Pillow: they are Pillow's."""
    import hashlib

    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    names = sorted(k for k in digests if k != "note")
    assert {"laion_loader_444.jpg", "laion_loader_rgba.png", "laion_loader.gif",
            "laion_loader.bmp", "laion_loader_lossy.webp"} <= set(names)
    for name in names:
        image = Image.open(FIXTURES / name).convert("RGB")
        small = image.resize((SIZE, SIZE), Image.BILINEAR)
        assert hashlib.sha256(np.asarray(image).tobytes()).hexdigest() == digests[name]["rgb_sha256"]
        assert (hashlib.sha256(np.asarray(small).tobytes()).hexdigest()
                == digests[name]["rgb64_sha256"])
        assert list(np.asarray(image).shape) == digests[name]["shape"]


def test_chip_smoke_loader_phase_runs_here():
    """The card's laion_loader phase needs no card: it passes on the CPU."""
    import chip_smoke

    assert chip_smoke.LOADER_SIZE == SIZE
    fields = chip_smoke.phase_laion_loader()
    assert fields["valid"] == [0, 1, 2, 3, 4, 5] and fields["failed"] == 3
