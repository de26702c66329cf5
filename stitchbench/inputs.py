"""Inputs made from ``--seed``: raw images and the JPEG files of a job.

Frozen copies of ``chip_smoke.py``'s job makers (``_config4_job`` and
phase 9's seeded stacks: uniform uint8 noise made on the device;
``_pattern`` and ``_write_files``: photo-like gradients with noise, written
as JPEG at quality 95 with the EXIF orientation tag, from 8 threads).  The
same seed gives the same pixels on the same device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch

Shape = Tuple[int, int, int]          # raw width, raw height, orientation


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for input stream ``stream`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def noise_stacks(shapes: Sequence[Shape], jobs: int, seed: int,
                 device) -> List[np.ndarray]:
    """One (jobs, H, W, 3) uint8 host stack per image slot, uniform noise
    made on ``device`` in one call per slot."""
    out = []
    for k, (w, h, _) in enumerate(shapes):
        t = torch.randint(0, 256, (jobs, h, w, 3),
                          generator=generator(device, seed, k),
                          dtype=torch.uint8, device=device)
        out.append(t.cpu().numpy())
        del t
    return out


def pattern(w: int, h: int, seed: int, device,
            noise_levels: int = 64) -> np.ndarray:
    """A photo-like uint8 HWC image: smooth gradients plus
    ``noise_levels`` of noise, so that its JPEG has a camera's size."""
    g = generator(device, seed, 0)
    y = torch.arange(h, device=device, dtype=torch.int32)[:, None, None]
    x = torch.arange(w, device=device, dtype=torch.int32)[None, :, None]
    c = torch.tensor([3, 5, 7], device=device, dtype=torch.int32)[None, None]
    noise = torch.randint(0, noise_levels, (h, w, 3), generator=g,
                          device=device, dtype=torch.int32)
    img = ((x * c + y * (8 - c)) // 16 + (int(seed) * 37) % 256 + noise) % 256
    return img.to(torch.uint8).cpu().numpy()


def write_jpegs(directory: str, shapes: Sequence[Shape], seeds: Sequence[int],
                device, quality: int = 95) -> List[str]:
    """One JPEG per shape under ``directory``, pixels from
    :func:`pattern`, the orientation in EXIF tag 274; written from 8
    threads.  Returns the paths in order."""
    from PIL import Image

    def write(k):
        w, h, o = shapes[k]
        img = Image.fromarray(pattern(w, h, seeds[k], device))
        exif = img.getexif()
        exif[274] = o
        path = os.path.join(directory, f"img{k:02d}.jpg")
        img.save(path, "JPEG", quality=quality, exif=exif)
        return path

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, range(len(shapes))))


def decode_jpeg(path: str) -> Tuple[np.ndarray, int]:
    """Raw RGB pixels and EXIF orientation of a JPEG, by Pillow alone: the
    reference's own decode."""
    from PIL import Image

    with Image.open(path) as img:
        o = int(img.getexif().get(274, 1) or 1)
        return np.array(img.convert("RGB")), (o if 1 <= o <= 8 else 1)
