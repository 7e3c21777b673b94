"""The LAION image + text pipeline: records, HTTP fetch, the JPEG cache, numpy only.

The port of ``tinydiffusion_tpu/data/laion.py`` (the reference's hardened
loader, vae_laion.py:234-330 and conditional_diffusion_laion.py:58-204)
without its PIL, ``requests``, ``urllib3`` and JAX imports. Kept:

- ``synthesize_caption``, ``synthesize_image`` and ``load_laion_dataset``:
  offline, deterministic ``synthetic://i`` records; online, the Hugging Face
  dataset (``datasets`` is imported there, lazily, and its absence raises
  JAX's ``RuntimeError``);
- ``LAIONImageTextDataset``: the same constructor and ``__getitem__``
  (NHWC; ``normalize``, ``as_uint8``; ``on_error="zero"`` returns literal
  zeros, ``"raise"`` raises ``ValueError``), with the md5-named JPEG cache
  (``<md5(url)>.jpg``, written before any resize at quality 95 by
  ``data/jpeg.py::encode_jpeg``, byte for byte Pillow's file), a corrupted
  cache file deleted and fetched again, the failed-URL set loaded from and
  saved to its JSON file, an all-black image taken as a failure, and a
  fetched image that is not S x S resized as Pillow's ``BILINEAR`` does
  (``obs/images.py::resize_u8``);
- the http(s) fetch, through ``urllib.request`` with the semantics of JAX's
  ``requests`` session: a ``FETCH_TIMEOUT_S`` (5 s) timeout, one retry
  (urllib3's ``Retry(total=1, backoff_factor=1, status_forcelist=[429, 500,
  502, 503, 504])``: connection errors and those statuses, and 413 with a
  ``Retry-After``; no backoff before a first retry; ``Retry-After`` slept as
  urllib3 sleeps it), failure after that retry, any other status, or a
  short body. Bodies are read by ``decode_image``, in the format Pillow's
  ``Image.open`` picks (``data/identify.py``): JPEG (``data/jpeg.py``,
  progressive, CMYK and lossless included), PNG (``data/png.py``, Adam7 and
  16-bit included), GIF, BMP and DIB, WebP, TIFF, ICO and CUR
  (``data/gif.py``, ``bmp.py``, ``webp.py``, ``tiff.py``, ``ico.py``), JPEG
  2000 (``data/jpeg2000.py``), TGA, Netpbm and QOI (``data/tga.py``,
  ``netpbm.py``, ``qoi.py``); other formats fail as Pillow fails on what it
  cannot identify, or by the name Pillow gives them (ROADMAP Queue 3 lists
  the formats Pillow would also read);
- ``check_disk_space`` and ``precache_dataset`` (a ``ThreadPoolExecutor``
  of 8, 250 KB a sample checked first, the sorted valid indices).

Both conv-VAE and text-conditional ``run``s read through the dataset as
JAX's do, so a warm cache hands back the JPEG decodes, byte-equal to
JAX's, and each package reads the other's cache.
"""

from __future__ import annotations

import email.utils
import hashlib
import http.client
import json
import os
import re
import shutil
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

from tinydiffusion_torch.data import identify
from tinydiffusion_torch.data.jpeg import encode_jpeg
from tinydiffusion_torch.obs.images import resize_u8

SYNTHETIC_SCHEME = "synthetic://"

_CLASSES = ("cat", "dog", "horse", "cow")


def synthesize_caption(i: int) -> str:
    """Deterministic caption of record ``i``."""
    return f"a photo of a {_CLASSES[i % len(_CLASSES)]}"


def synthesize_image(i: int, size: int) -> tuple[np.ndarray, str]:
    """Deterministic (size, size, 3) uint8 image of record ``i`` + its caption.

    Class-dependent palette and shape (circle / square / diamond / stripes)
    over a dark diagonal gradient with per-record jitter.
    """
    cls = i % len(_CLASSES)
    rng = np.random.default_rng([9176, int(i)])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)

    base = 0.08 + 0.30 * (0.5 * (xx + yy))
    img = np.stack([base, base, base], axis=-1)

    palettes = np.array(
        [[0.85, 0.45, 0.20],   # cat: orange
         [0.30, 0.55, 0.90],   # dog: blue
         [0.45, 0.75, 0.30],   # horse: green
         [0.85, 0.80, 0.30]],  # cow: yellow
        np.float32,
    )
    color = palettes[cls] * rng.uniform(0.85, 1.1)
    cy, cx = rng.uniform(0.35, 0.65, 2)
    r = rng.uniform(0.18, 0.30)
    dy, dx = yy - cy, xx - cx
    if cls == 0:
        mask = dy * dy + dx * dx < r * r
    elif cls == 1:
        mask = np.maximum(np.abs(dy), np.abs(dx)) < r
    elif cls == 2:
        mask = (np.abs(dy) + np.abs(dx)) < 1.3 * r
    else:
        mask = (np.abs(dy) < r) & (np.sin(xx * 28.0) > 0.0)
    img = np.where(mask[..., None], color, img)
    img = img + rng.normal(0.0, 0.015, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)
    return (img * 255).astype(np.uint8), synthesize_caption(i)


def load_laion_dataset(n_records: int, offline: bool = True) -> list[dict]:
    """Records with the reference's column names (``URL``, ``TEXT``): with
    ``offline``, ``synthetic://i`` and its caption for i < ``n_records``;
    else the first ``n_records`` of the Hugging Face dataset
    ``laion/laion2B-en-aesthetic``, which needs the ``datasets`` package and
    the network (a ``RuntimeError`` without the package, as in JAX)."""
    if offline:
        return [{"URL": f"{SYNTHETIC_SCHEME}{i}", "TEXT": synthesize_caption(i)}
                for i in range(n_records)]
    try:
        from datasets import load_dataset  # the one import of the online path
    except ImportError as e:
        raise RuntimeError(
            "online LAION loading needs the 'datasets' package; "
            "use offline=True in zero-egress environments"
        ) from e
    return list(load_dataset("laion/laion2B-en-aesthetic", split=f"train[:{n_records}]"))


# Bytes of cache a sample: precache_dataset's disk check
# (conditional_diffusion_laion.py:169).
PER_SAMPLE_BYTES = 250 * 1024
# The fetch's timeout in seconds (requests' ``timeout=5``: connect, and each
# read). A test may set it lower.
FETCH_TIMEOUT_S = 5.0
# urllib3's Retry(total=1, status_forcelist=...): one retry, on connection
# errors and on these statuses (and on 413 with a Retry-After, which urllib3
# also retries while it honours that header).
FETCH_RETRIES = 1
RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})
RETRY_AFTER_STATUSES = frozenset({413, 429, 503})
CACHE_QUALITY = 95


def check_disk_space(path: str, required_bytes: int) -> None:
    """RuntimeError when ``path``'s filesystem has less free space
    (conditional_diffusion_laion.py:151-159)."""
    free = shutil.disk_usage(path).free
    if free < required_bytes:
        raise RuntimeError(
            f"Need at least {required_bytes / 1024**3:.2f} GB free disk "
            f"space, have {free / 1024**3:.2f} GB"
        )


def decode_image(data: bytes) -> np.ndarray:
    """An image file's (H, W, 3) uint8 RGB, as Pillow's
    ``Image.open(f).convert("RGB")``. The format is the one Pillow 12.1's
    ``Image.open`` picks (``data/identify.py``: its plugins in their order,
    a failed open passed on to the next); the port reads JPEG (Huffman or
    arithmetic-coded, sequential, progressive or 8-bit lossless), PNG, GIF
    (its first frame), BMP and DIB, WebP (its first frame), TIFF (its first
    image; YCbCr through libtiff's conversion too), ICO and CUR (the image
    Pillow picks), JPEG 2000 (a JP2 file or a raw codestream; sYCC too), TGA,
    Netpbm (PBM, PGM, PPM, PFM) and QOI. Any other format Pillow identifies
    raises ``ValueError`` by its name, as does what Pillow cannot identify
    or load."""
    return identify.decode(data)


def _retry_after_seconds(value: str) -> float:
    """urllib3's ``parse_retry_after``: seconds, or an HTTP date (the time
    left until it, at least 0)."""
    if re.match(r"^\s*[0-9]+\s*$", value):
        return float(int(value))
    parsed = email.utils.parsedate_tz(value)
    if parsed is None:
        raise ValueError(f"Invalid Retry-After header: {value}")
    return max(email.utils.mktime_tz(parsed) - time.time(), 0.0)


def http_get(url: str) -> bytes:
    """The body of ``url`` (http or https), with the retry rule of JAX's
    session (``FETCH_RETRIES``, ``RETRY_STATUSES``, ``Retry-After``) and the
    ``FETCH_TIMEOUT_S`` timeout. Raises on failure."""
    if not url.startswith(("http://", "https://")):
        raise ValueError(f"No connection adapters were found for {url!r}")
    retries = FETCH_RETRIES
    while True:
        try:
            with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as response:
                return response.read()  # a short body raises IncompleteRead
        except urllib.error.HTTPError as e:
            after = e.headers.get("Retry-After") if e.headers is not None else None
            retry = e.code in RETRY_STATUSES or (after is not None
                                                  and e.code in RETRY_AFTER_STATUSES)
            if not retry or retries == 0:
                raise
            retries -= 1
            if after is not None and e.code in RETRY_AFTER_STATUSES:
                seconds = _retry_after_seconds(after)
                if seconds:
                    time.sleep(seconds)
        except (urllib.error.URLError, http.client.RemoteDisconnected, ConnectionError,
                TimeoutError):
            # Connection and read errors before a response: retried, with no
            # backoff before the first retry (urllib3's get_backoff_time).
            if retries == 0:
                raise
            retries -= 1


class _FetchError(Exception):
    pass


class LAIONImageTextDataset:
    """(image, text) pairs with JPEG caching and failure hardening.

    ``normalize=False`` -> float32 [0, 1] (ToTensor); ``normalize=True`` ->
    [-1, 1] (the diffusion transform); ``as_uint8=True`` -> the resized
    uint8 bytes. NHWC throughout.
    """

    def __init__(self, records: list[dict], cache_dir: str, failed_urls_cache: str,
                 image_size: int = 256, normalize: bool = True, on_error: str = "zero",
                 as_uint8: bool = False):
        if on_error not in ("zero", "raise"):
            raise ValueError(f"on_error={on_error!r}; choose 'zero' or 'raise'")
        self.records = list(records)
        self.cache_dir = cache_dir
        self.failed_urls_cache = failed_urls_cache
        self.image_size = image_size
        self.normalize = normalize
        self.on_error = on_error
        self.as_uint8 = as_uint8
        os.makedirs(cache_dir, exist_ok=True)
        parent = os.path.dirname(failed_urls_cache)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.failed_urls = set()
        if os.path.exists(failed_urls_cache):
            try:
                with open(failed_urls_cache) as f:
                    self.failed_urls = set(json.load(f))
            except (json.JSONDecodeError, IOError) as e:
                print(f"Error loading failed URLs cache: {e}")
                self.failed_urls = set()
        # precache_dataset fans __getitem__ out over threads: one lock for the
        # failed set and its file.
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.records)

    def save_failed_urls(self) -> None:
        try:
            with open(self.failed_urls_cache, "w") as f:
                json.dump(sorted(self.failed_urls), f)
        except IOError as e:
            print(f"Error saving failed URLs cache: {e}")

    def _mark_failed(self, url: str) -> None:
        with self._lock:
            self.failed_urls.add(url)
            self.save_failed_urls()

    def _cache_path(self, url: str) -> str:
        url_hash = hashlib.md5(url.encode("utf-8")).hexdigest()
        return os.path.join(self.cache_dir, f"{url_hash}.jpg")

    def _fetch(self, url: str) -> np.ndarray:
        """The image at ``url``: ``synthetic://i`` rendered here, http(s)
        fetched and decoded."""
        if url.startswith(SYNTHETIC_SCHEME):
            return synthesize_image(int(url.split("://", 1)[1]), self.image_size)[0]
        return decode_image(http_get(url))

    def _load_u8(self, idx: int) -> np.ndarray:
        """Resized uint8 (image_size, image_size, 3) or _FetchError."""
        url = self.records[idx]["URL"]
        if url in self.failed_urls:
            raise _FetchError("Failed URL (cached)")
        cache_path = self._cache_path(url)
        image = None
        if os.path.exists(cache_path):
            try:
                with open(cache_path, "rb") as f:
                    image = decode_image(f.read())
            except (OSError, ValueError) as e:
                # Corrupted cache: delete and refetch (vae_laion.py:275-278).
                print(f"Corrupted cache file {cache_path}, refetching: {e}")
                os.remove(cache_path)
                image = None
        if image is None:
            try:
                image = self._fetch(url)
            except Exception as e:
                self._mark_failed(url)
                raise _FetchError(f"download failed: {e}") from e
            try:
                # Written whole under a temporary name, then renamed: a reader
                # never sees half a file.
                tmp = f"{cache_path}.{os.getpid()}.{threading.get_ident()}.tmp"
                with open(tmp, "wb") as f:
                    f.write(encode_jpeg(image, CACHE_QUALITY))
                os.replace(tmp, cache_path)
            except OSError as e:
                print(f"Error caching {url}: {e}")
        if image.shape[:2] != (self.image_size, self.image_size):
            image = resize_u8(image, self.image_size, self.image_size, "bilinear")
        if not image.any():
            # Black image == failure (conditional_diffusion_laion.py:104-137).
            self._mark_failed(url)
            raise _FetchError("black image")
        return image

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str]:
        text = self.records[idx].get("TEXT", "")
        try:
            arr = self._load_u8(idx)
        except _FetchError as e:
            if self.on_error == "raise":
                raise ValueError(f"Failed to load sample {idx}: {e}") from e
            # Literal zeros, not normalised zeros (vae_laion.py:296-304).
            dtype = np.uint8 if self.as_uint8 else np.float32
            return np.zeros((self.image_size, self.image_size, 3), dtype), text
        if self.as_uint8:
            return arr, text
        x = arr.astype(np.float32) / 255.0
        if self.normalize:
            x = x * 2.0 - 1.0
        return x, text


def precache_dataset(ds: LAIONImageTextDataset, max_samples: int | None = None,
                     max_workers: int = 8) -> list[int]:
    """Thread-pool warm-up of the JPEG cache; returns the sorted valid
    indices (conditional_diffusion_laion.py:165-204). Invalid: a fetch
    failure, a black image, or an empty caption."""
    n = min(max_samples or len(ds), len(ds))
    check_disk_space(ds.cache_dir, n * PER_SAMPLE_BYTES)

    def cache_one(idx: int) -> tuple[int, bool]:
        try:
            x, text = ds[idx]
            return idx, bool(text) and bool(np.any(x))
        except Exception:
            return idx, False

    valid = []
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = [ex.submit(cache_one, i) for i in range(n)]
        for fut in as_completed(futures):
            idx, ok = fut.result()
            if ok:
                valid.append(idx)
    return sorted(valid)
