"""Host-side "group" spatial transforms over frame clips (the port's own
copy of ``ehgr_tpu/ops/spatial_transforms.py``: the same classes, crop
offsets, resizes and draws from the same ``numpy.random.Generator``).

A clip is a list of PIL images (RGB or L); multi-crop evaluators
(``GroupOverSample`` 10-crop, ``GroupFullResSample`` 3-crop) return a list
of ``n_crops * T`` images, crop-major.  Stochastic transforms keep their
generator as ``rng``: the native decoder's planner
(``ehgr_tpu_torch/data/native_io.py``) walks those attributes and draws
from them exactly as ``__call__`` would.

PIL is imported inside the functions that use it, so the runner imports
without Pillow (the synthetic sources need none).
"""

from __future__ import annotations

import numbers
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from PIL import Image

__all__ = [
    "Compose", "GroupScale", "GroupCenterCrop", "GroupRandomCrop",
    "GroupRandomHorizontalFlip", "GroupMultiScaleCrop", "GroupOverSample",
    "GroupFullResSample", "ToClipArray", "ClipNormalize", "IdentityTransform",
    "fill_fix_offset",
]

# PIL's Resampling.BILINEAR, which ``Image.resize`` also takes as an int
_BILINEAR = 2


def _pil():
    from PIL import Image, ImageOps

    return Image, ImageOps


def _pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return (int(size), int(size))
    return tuple(size)  # type: ignore[return-value]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class IdentityTransform:
    def __call__(self, x):
        return x


class GroupScale:
    """Resize every frame. ``size`` int = short-side resize (aspect kept,
    torchvision.Resize semantics); ``[w, h]`` = exact size
    (ref ``spatial_transforms.py:83-96``; note the reference passes
    ``GroupScale([224, 224])`` for EgoGesture, i.e. square resize)."""

    def __init__(self, size, interpolation=_BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def _resize(self, img: Image.Image) -> Image.Image:
        if isinstance(self.size, numbers.Number):
            w, h = img.size
            short = int(self.size)
            if min(w, h) == short:
                return img
            if w < h:
                ow, oh = short, int(round(short * h / w))
            else:
                ow, oh = int(round(short * w / h)), short
            return img.resize((ow, oh), self.interpolation)
        # list/tuple: reference passes [w, h] to torchvision.Resize which
        # treats it as (h, w); the live configs are square so both agree.
        h, w = _pair(self.size)
        return img.resize((w, h), self.interpolation)

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        return [self._resize(img) for img in img_group]


class GroupCenterCrop:
    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        th, tw = self.size
        out = []
        for img in img_group:
            w, h = img.size
            x1 = int(round((w - tw) / 2.0))
            y1 = int(round((h - th) / 2.0))
            out.append(img.crop((x1, y1, x1 + tw, y1 + th)))
        return out


class GroupRandomCrop:
    def __init__(self, size, rng: Optional[np.random.Generator] = None):
        self.size = _pair(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        w, h = img_group[0].size
        th, tw = self.size
        x1 = int(self.rng.integers(0, w - tw + 1))
        y1 = int(self.rng.integers(0, h - th + 1))
        out = []
        for img in img_group:
            assert img.size[0] == w and img.size[1] == h
            if w == tw and h == th:
                out.append(img)
            else:
                out.append(img.crop((x1, y1, x1 + tw, y1 + th)))
        return out


class GroupRandomHorizontalFlip:
    """Flip the whole clip with p=0.5; optical-flow x-channels are inverted
    (ref ``spatial_transforms.py:46-63``)."""

    def __init__(self, is_flow: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.is_flow = is_flow
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        if self.rng.random() < 0.5:
            Image, ImageOps = _pil()
            ret = [img.transpose(Image.FLIP_LEFT_RIGHT) for img in img_group]
            if self.is_flow:
                for i in range(0, len(ret), 2):
                    ret[i] = ImageOps.invert(ret[i])
            return ret
        return img_group


def fill_fix_offset(more_fix_crop: bool, image_w: int, image_h: int,
                    crop_w: int, crop_h: int) -> List[Tuple[int, int]]:
    """The 5/13 fixed crop-offset grid (ref ``spatial_transforms.py:355-373``)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [
        (0, 0), (4 * w_step, 0), (0, 4 * h_step),
        (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step),
    ]
    if more_fix_crop:
        ret += [
            (0, 2 * h_step), (4 * w_step, 2 * h_step),
            (2 * w_step, 4 * h_step), (2 * w_step, 0),
            (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
            (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step),
        ]
    return ret


class GroupMultiScaleCrop:
    """Scale-jittered fixed-offset crop + resize (ref ``:296-373``).

    Picks a (w, h) crop from scales {1, .875, .75, .66} of the short side
    (|i-j| <= max_distort), a random offset from the 13-point grid, crops
    every frame identically, and resizes to ``input_size``."""

    def __init__(self, input_size, scales=None, max_distort: int = 1,
                 fix_crop: bool = True, more_fix_crop: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.scales = scales if scales is not None else [1, .875, .75, .66]
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop
        self.input_size = _pair(input_size)  # (w, h) like the reference list
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        im_size = img_group[0].size
        crop_w, crop_h, off_w, off_h = self._sample_crop_size(im_size)
        crop_group = [img.crop((off_w, off_h, off_w + crop_w, off_h + crop_h))
                      for img in img_group]
        return [img.resize((self.input_size[0], self.input_size[1]), _BILINEAR)
                for img in crop_group]

    def _sample_crop_size(self, im_size: Tuple[int, int]):
        image_w, image_h = im_size
        base_size = min(image_w, image_h)
        crop_sizes = [int(base_size * x) for x in self.scales]
        crop_h = [self.input_size[1] if abs(x - self.input_size[1]) < 3 else x
                  for x in crop_sizes]
        crop_w = [self.input_size[0] if abs(x - self.input_size[0]) < 3 else x
                  for x in crop_sizes]
        pairs = [(w, h) for i, h in enumerate(crop_h)
                 for j, w in enumerate(crop_w) if abs(i - j) <= self.max_distort]
        crop_pair = pairs[int(self.rng.integers(0, len(pairs)))]
        if not self.fix_crop:
            w_offset = int(self.rng.integers(0, image_w - crop_pair[0] + 1))
            h_offset = int(self.rng.integers(0, image_h - crop_pair[1] + 1))
        else:
            offsets = fill_fix_offset(self.more_fix_crop, image_w, image_h,
                                      crop_pair[0], crop_pair[1])
            w_offset, h_offset = offsets[int(self.rng.integers(0, len(offsets)))]
        return crop_pair[0], crop_pair[1], w_offset, h_offset


class GroupOverSample:
    """10-crop evaluation: 5 fixed offsets x (crop, h-flip) (ref ``:99-136``)."""

    def __init__(self, crop_size, scale_size=None, flip: bool = True):
        self.crop_size = _pair(crop_size)
        self.scale_worker = GroupScale(scale_size) if scale_size else None
        self.flip = flip

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        if self.scale_worker is not None:
            img_group = self.scale_worker(img_group)
        image_w, image_h = img_group[0].size
        crop_h, crop_w = self.crop_size
        offsets = fill_fix_offset(False, image_w, image_h, crop_w, crop_h)
        Image, ImageOps = _pil()
        out: List[Image.Image] = []
        for o_w, o_h in offsets:
            normal, flipped = [], []
            for i, img in enumerate(img_group):
                crop = img.crop((o_w, o_h, o_w + crop_w, o_h + crop_h))
                normal.append(crop)
                if self.flip:
                    fc = crop.copy().transpose(Image.FLIP_LEFT_RIGHT)
                    if img.mode == "L" and i % 2 == 0:
                        flipped.append(ImageOps.invert(fc))
                    else:
                        flipped.append(fc)
            out.extend(normal)
            out.extend(flipped)
        return out


class GroupFullResSample:
    """3-crop evaluation (left/right/center at full height) (ref ``:139-186``);
    the NvGesture test protocol with ``test_crops=3``."""

    def __init__(self, crop_size, scale_size=None, flip: bool = True):
        self.crop_size = _pair(crop_size)
        self.scale_worker = GroupScale(scale_size) if scale_size else None
        self.flip = flip

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        if self.scale_worker is not None:
            img_group = self.scale_worker(img_group)
        image_w, image_h = img_group[0].size
        crop_h, crop_w = self.crop_size
        w_step = (image_w - crop_w) // 4
        h_step = (image_h - crop_h) // 4
        offsets = [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                   (2 * w_step, 2 * h_step)]
        Image, ImageOps = _pil()
        out: List[Image.Image] = []
        for o_w, o_h in offsets:
            normal, flipped = [], []
            for i, img in enumerate(img_group):
                crop = img.crop((o_w, o_h, o_w + crop_w, o_h + crop_h))
                normal.append(crop)
                if self.flip:
                    fc = crop.copy().transpose(Image.FLIP_LEFT_RIGHT)
                    if img.mode == "L" and i % 2 == 0:
                        flipped.append(ImageOps.invert(fc))
                    else:
                        flipped.append(fc)
            out.extend(normal)
            out.extend(flipped)
        return out


class GroupRandomSizedCrop:
    """Inception-style random area (0.08-1.0) + aspect (3/4-4/3) crop resized
    to ``size``; falls back to scale+random-crop after 10 attempts
    (ref ``spatial_transforms.py:376-422``)."""

    def __init__(self, size: int, interpolation=_BILINEAR,
                 rng: Optional[np.random.Generator] = None):
        self.size = int(size)
        self.interpolation = interpolation
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        import math

        w0, h0 = img_group[0].size
        for _ in range(10):
            target_area = self.rng.uniform(0.08, 1.0) * w0 * h0
            aspect = self.rng.uniform(3.0 / 4, 4.0 / 3)
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if self.rng.random() < 0.5:
                w, h = h, w
            if w <= w0 and h <= h0:
                x1 = int(self.rng.integers(0, w0 - w + 1))
                y1 = int(self.rng.integers(0, h0 - h + 1))
                return [img.crop((x1, y1, x1 + w, y1 + h)).resize(
                    (self.size, self.size), self.interpolation)
                    for img in img_group]
        scale = GroupScale(self.size, interpolation=self.interpolation)
        crop = GroupRandomCrop(self.size, rng=self.rng)
        return crop(scale(img_group))


class GroupMultiScaleRotate:
    """Random small rotation applied clip-consistently
    (ref ``spatial_transforms.py:445-457``)."""

    def __init__(self, max_degrees: float = 10.0,
                 rng: Optional[np.random.Generator] = None):
        self.max_degrees = max_degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_group: List[Image.Image]) -> List[Image.Image]:
        deg = float(self.rng.uniform(-self.max_degrees, self.max_degrees))
        return [img.rotate(deg, resample=_BILINEAR) for img in img_group]


class ToClipArray:
    """PIL list -> float32 ``[T, H, W, C]`` in [0, 1] (or [0, 255] with
    ``div=False`` for BNInception-style backbones; ``roll=True`` flips RGB to
    BGR like ``Stack(roll=True)``, ref ``:425-436,483-502``)."""

    def __init__(self, div: bool = True, roll: bool = False):
        self.div = div
        self.roll = roll

    def __call__(self, img_group: List[Image.Image]) -> np.ndarray:
        arrs = []
        for img in img_group:
            a = np.asarray(img)
            if a.ndim == 2:
                a = a[:, :, None]
            if self.roll:
                a = a[:, :, ::-1]
            arrs.append(a)
        clip = np.stack(arrs, axis=0).astype(np.float32)
        if self.div:
            clip /= 255.0
        return clip


class ClipNormalize:
    """Per-channel mean/std normalization on ``[T, H, W, C]`` float arrays
    (GroupNormalize equivalent, ref ``:66-80``)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return (clip - self.mean) / self.std
