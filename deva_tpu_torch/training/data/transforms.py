"""Seed-replayable PIL/numpy augmentation transforms.

A copy of deva_tpu/training/data/transforms.py, with PIL imported inside
the functions that use it (the card's machine has no PIL; the port's
modules import without it). The resample constants are PIL's own values.

The reference uses torchvision transforms (reference:deva/dataset/
vos_dataset.py:60-97); torchvision isn't in this image, so the needed subset
is implemented here on PIL. Randomness comes from the stdlib `random` module
so the reference's seed-replay trick (same seed -> identical geometric
transform for the image and its mask, reference:deva/dataset/utils.py reseed)
works: call random.seed(s) before transforming each element of a pair.
"""
from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

# PIL.Image.NEAREST, BILINEAR, BICUBIC
NEAREST = 0
BILINEAR = 2
BICUBIC = 3


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ColorJitter:
    """brightness/contrast/saturation/hue jitter (factor ranges like
    torchvision: U[max(0, 1-b), 1+b], hue in U[-h, h])."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def __call__(self, img):
        from PIL import ImageEnhance
        ops = []
        if self.b > 0:
            f = random.uniform(max(0, 1 - self.b), 1 + self.b)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.c > 0:
            f = random.uniform(max(0, 1 - self.c), 1 + self.c)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.s > 0:
            f = random.uniform(max(0, 1 - self.s), 1 + self.s)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        if self.h > 0:
            d = random.uniform(-self.h, self.h)
            ops.append(lambda im, d=d: _shift_hue(im, d))
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


def _shift_hue(img, amount: float):
    from PIL import Image
    hsv = np.asarray(img.convert("HSV")).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) +
                   int(amount * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


class RandomGrayscale:
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, img: "PIL.Image.Image") -> "PIL.Image.Image":
        if random.random() < self.p:
            return img.convert("L").convert("RGB")
        return img


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        from PIL import Image
        if random.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


def _inv_affine_coeffs(center, angle, scale, shear) -> Tuple[float, ...]:
    """PIL coeffs mapping OUTPUT -> INPUT for rotate(angle)+shear+scale about
    center (torchvision RandomAffine composition order)."""
    cx, cy = center
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    # forward matrix M = T(c) * R(rot) * Shear(sx, sy) * Scale * T(-c)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [[scale * a, scale * b, 0.0], [scale * c, scale * d, 0.0]]
    det = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    inv = [[m[1][1] / det, -m[0][1] / det], [-m[1][0] / det, m[0][0] / det]]
    # output->input: p_in = inv @ (p_out - c) + c
    c0 = cx - inv[0][0] * cx - inv[0][1] * cy
    c1 = cy - inv[1][0] * cx - inv[1][1] * cy
    return (inv[0][0], inv[0][1], c0, inv[1][0], inv[1][1], c1)


class RandomAffine:
    def __init__(self, degrees: float, shear: Optional[float] = None,
                 scale: Optional[Tuple[float, float]] = None,
                 interpolation=BILINEAR, fill=0):
        self.degrees = degrees
        self.shear = shear
        self.scale = scale
        self.interpolation = interpolation
        self.fill = tuple(fill) if isinstance(fill, (tuple, list)) else fill

    def __call__(self, img):
        from PIL import Image
        angle = random.uniform(-self.degrees, self.degrees)
        scale = random.uniform(*self.scale) if self.scale else 1.0
        shear = (random.uniform(-self.shear, self.shear), 0.0) \
            if self.shear else (0.0, 0.0)
        center = (img.width * 0.5, img.height * 0.5)
        coeffs = _inv_affine_coeffs(center, angle, scale, shear)
        fill = self.fill
        if img.mode in ("L", "P") and isinstance(fill, tuple):
            fill = fill[0]
        return img.transform(img.size, Image.AFFINE, coeffs,
                             resample=self.interpolation, fillcolor=fill)


class RandomResizedCrop:
    def __init__(self, size: Tuple[int, int],
                 scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 interpolation=BILINEAR, antialias: bool = True):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img: "PIL.Image.Image") -> "PIL.Image.Image":
        w, h = img.size
        area = w * h
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = random.randint(0, w - cw)
                y = random.randint(0, h - ch)
                box = (x, y, x + cw, y + ch)
                return img.resize((self.size[1], self.size[0]),
                                  self.interpolation, box=box)
        # fallback: center crop of the valid aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        x, y = (w - cw) // 2, (h - ch) // 2
        return img.resize((self.size[1], self.size[0]), self.interpolation,
                          box=(x, y, x + cw, y + ch))


class Resize:
    """Min-side resize (torchvision Resize(size) semantics)."""

    def __init__(self, size: int, interpolation=BILINEAR,
                 antialias: bool = True):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img: "PIL.Image.Image") -> "PIL.Image.Image":
        w, h = img.size
        if h < w:
            nh, nw = self.size, max(1, round(w * self.size / h))
        else:
            nh, nw = max(1, round(h * self.size / w)), self.size
        if (nw, nh) == (w, h):
            return img
        return img.resize((nw, nh), self.interpolation)


class RandomCrop:
    def __init__(self, size: Tuple[int, int], pad_if_needed: bool = False,
                 fill=0):
        self.size = size
        self.pad_if_needed = pad_if_needed
        self.fill = tuple(fill) if isinstance(fill, (tuple, list)) else fill

    def __call__(self, img):
        from PIL import Image
        th, tw = self.size
        if self.pad_if_needed and (img.width < tw or img.height < th):
            nw, nh = max(img.width, tw), max(img.height, th)
            fill = self.fill
            if img.mode in ("L", "P") and isinstance(fill, tuple):
                fill = fill[0]
            canvas = Image.new(img.mode, (nw, nh), fill)
            canvas.paste(img, ((nw - img.width) // 2,
                               (nh - img.height) // 2))
            img = canvas
        x = random.randint(0, img.width - tw)
        y = random.randint(0, img.height - th)
        return img.crop((x, y, x + tw, y + th))
