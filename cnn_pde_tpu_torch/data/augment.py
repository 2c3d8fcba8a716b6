"""On-device batch augmentation of the ported presets — port of
``cnn_pde_tpu/data/augment.py`` (Resize + RandomCrop as one resampling,
crop-pad, hflip, the rotation and translation warp, colour jitter,
normalisation, random erasing after normalisation), in the JAX chain's
order.

Each op is split into a draw and an apply.  ``draw`` takes every random
number of a batch from one ``torch.Generator``; the ``apply_*`` functions
take those draws as tensors, so a test can hand them the JAX package's own
draws.  Images are NCHW float32 in [0, 1] before normalisation.  Everything
here is plain PyTorch on the images' device: no kernel of the JAX package
computes augmentation either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["AugmentSpec", "draw", "apply", "augment", "apply_resize_crop",
           "apply_crop_pad",
           "apply_hflip", "apply_rotation", "apply_affine",
           "apply_color_jitter", "apply_normalize", "apply_erasing"]

ERASE_SCALE = (0.02, 0.33)
ERASE_RATIO = (0.3, 3.3)


@dataclass(frozen=True)
class AugmentSpec:
    """The torchvision chain of a preset (the JAX ``AugmentSpec``'s fields;
    ``resize_crop`` R > 0 is Resize(R) then RandomCrop back to the image's
    size)."""

    resize_crop: int = 0
    crop_padding: int = 0
    hflip: float = 0.0
    rotation: float = 0.0
    translate: float = 0.0
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    erasing_p: float = 0.0
    mean: Optional[Sequence[float]] = None
    std: Optional[Sequence[float]] = None


def draw(spec: AugmentSpec, shape, generator: torch.Generator,
         device, rows=None) -> dict:
    """Every random number the augmentation of a batch of ``shape``
    (B, C, H, W) needs, one per image, from ``generator`` (which must live
    on ``device``).  ``rows`` = (rank, world): the numbers of a global
    batch of ``world`` blocks of B images, drawn as a single device draws
    them, and the rank's block kept (a data-parallel step)."""
    batch, _, height, width = shape
    rank, world = rows or (0, 1)
    local, batch = batch, batch * world

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)

    def randint(hi):
        return torch.randint(0, hi, (batch,), generator=generator,
                             device=device)

    d = {}
    if spec.resize_crop:
        d["resize_oy"] = randint(spec.resize_crop - height + 1)
        d["resize_ox"] = randint(spec.resize_crop - width + 1)
    if spec.crop_padding:
        d["crop_oy"] = randint(2 * spec.crop_padding + 1)
        d["crop_ox"] = randint(2 * spec.crop_padding + 1)
    if spec.hflip:
        d["flip"] = uniform(0.0, 1.0) < spec.hflip
    if spec.rotation:
        d["angle"] = uniform(-spec.rotation, spec.rotation)
    if spec.translate:  # in pixels: a fraction of the width and the height
        d["tx"] = uniform(-spec.translate, spec.translate) * width
        d["ty"] = uniform(-spec.translate, spec.translate) * height
    for key in ("brightness", "contrast", "saturation"):
        amount = getattr(spec, key)
        if amount:
            d[key] = uniform(1.0 - amount, 1.0 + amount)
    if spec.hue:
        d["hue"] = uniform(-spec.hue, spec.hue)
    if spec.erasing_p:
        d["erase"] = uniform(0.0, 1.0) < spec.erasing_p
        d["erase_area"] = uniform(*ERASE_SCALE)
        d["erase_log_ratio"] = uniform(math.log(ERASE_RATIO[0]),
                                       math.log(ERASE_RATIO[1]))
        d["erase_oy"] = randint(height)
        d["erase_ox"] = randint(width)
    if world > 1:
        d = {k: v[rank * local:(rank + 1) * local] for k, v in d.items()}
    return d


def _tri(coords, n):
    """Bilinear tap weights max(0, 1 − |coord − k|) of fractional source
    coordinates (..., M) against the taps k < n: (..., M, n)."""
    taps = torch.arange(n, dtype=coords.dtype, device=coords.device)
    return (1.0 - (coords[..., None] - taps).abs()).clamp_min(0.0)


def apply_resize_crop(images, oy, ox, resize_to):
    """Resize(``resize_to``) (bilinear) then RandomCrop back to the size
    (H, W) at the integer offsets (oy, ox) of each image, as one separable
    resampling: output pixel (i, j) reads the input at ((i + oy)·H/R,
    (j + ox)·H/R) through the per-axis tri weights, the JAX
    ``_resize_crop``."""
    B, C, H, W = images.shape
    scale = H / resize_to
    ys = (torch.arange(H, dtype=torch.float32, device=images.device)
          + oy[:, None].float()) * scale
    xs = (torch.arange(W, dtype=torch.float32, device=images.device)
          + ox[:, None].float()) * scale
    return torch.einsum("bik,bckl,bjl->bcij", _tri(ys, H), images,
                        _tri(xs, W))


def apply_crop_pad(images, oy, ox, padding):
    """RandomCrop(size, padding): zero-pad by ``padding`` and crop at the
    integer offsets (oy, ox) ∈ [0, 2·padding] of each image."""
    B, C, H, W = images.shape
    padded = F.pad(images, (padding,) * 4)
    rows = oy[:, None] + torch.arange(H, device=images.device)
    cols = ox[:, None] + torch.arange(W, device=images.device)
    b = torch.arange(B, device=images.device)[:, None, None, None]
    c = torch.arange(C, device=images.device)[None, :, None, None]
    return padded[b, c, rows[:, None, :, None], cols[:, None, None, :]]


def apply_hflip(images, flip):
    return torch.where(flip[:, None, None, None], images.flip(-1), images)


def apply_rotation(images, angle):
    """Rotate by ``angle`` degrees about the image centre: bilinear, zero
    fill, centred coordinates (the JAX ``_rotate``/``_affine_warp``)."""
    return apply_affine(images, angle=angle)


def apply_affine(images, angle=None, tx=None, ty=None):
    """Translate(rotate(x)) in one bilinear warp with zero fill and centred
    coordinates, as the JAX augment composes rotation and translation:
    each output pixel (x, y) reads the input at the inverse map
    [[c, s, −(c·tx + s·ty)], [−s, c, −(−s·tx + c·ty)]] of (x, y, 1), with
    c, s the cosine and sine of ``angle`` degrees and (tx, ty) the shift in
    pixels, per image.  A missing angle is 0 and a missing shift 0 (the JAX
    rotation-only and translation-only warps)."""
    B, C, H, W = images.shape
    zero = torch.zeros(B, dtype=images.dtype, device=images.device)
    rad = (zero if angle is None else angle) * math.pi / 180.0
    tx = zero if tx is None else tx
    ty = zero if ty is None else ty
    cos, sin = torch.cos(rad), torch.sin(rad)
    off_x = -(cos * tx + sin * ty)
    off_y = -(-sin * tx + cos * ty)
    cos, sin = cos[:, None, None], sin[:, None, None]
    ys = torch.arange(H, dtype=images.dtype, device=images.device) \
        - (H - 1) / 2.0
    xs = torch.arange(W, dtype=images.dtype, device=images.device) \
        - (W - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    src_x = cos * xx + sin * yy + off_x[:, None, None]
    src_y = -sin * xx + cos * yy + off_y[:, None, None]
    # align_corners=True: pixel k of N sits at 2k/(N-1) - 1
    grid = torch.stack([src_x / ((W - 1) / 2.0), src_y / ((H - 1) / 2.0)],
                       dim=-1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def _luminance(images):
    return (0.299 * images[:, 0] + 0.587 * images[:, 1]
            + 0.114 * images[:, 2])


def _rgb_to_hsv(img):
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h),
                    torch.remainder(h / 6.0, 1.0))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    """Branch-free: channel(n) = v − v·s·clamp(min(k, 4−k), 0, 1) with
    k = (n + 6h) mod 6."""
    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=1)


def apply_color_jitter(images, brightness=None, contrast=None,
                       saturation=None, hue=None):
    """ColorJitter with per-image factors, in torchvision's order:
    brightness, contrast pivoting on the luminance mean, saturation, then
    hue through the arithmetic HSV round trip.  A None factor skips its
    op."""
    x = images
    if brightness is not None:
        x = (x * brightness[:, None, None, None]).clamp(0.0, 1.0)
    if contrast is not None:
        pivot = _luminance(x).mean(dim=(1, 2))[:, None, None, None]
        x = ((x - pivot) * contrast[:, None, None, None] + pivot).clamp(0.0,
                                                                       1.0)
    if saturation is not None:
        gray = _luminance(x)[:, None]
        x = (gray + (x - gray) * saturation[:, None, None, None]).clamp(0.0,
                                                                       1.0)
    if hue is not None:
        h, s, v = _rgb_to_hsv(x)
        h = torch.remainder(h + hue[:, None, None], 1.0)
        x = _hsv_to_rgb(h, s, v).clamp(0.0, 1.0)
    return x


def apply_normalize(images, mean, std):
    """(images − mean)/std per channel; ``mean`` and ``std`` are sequences
    or tensors already on the images' device (the train step's, which a
    CUDA graph can capture: no copy from the host)."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean[:, None, None]) / std[:, None, None]


def apply_erasing(images, erase, area, log_ratio, oy, ox):
    """RandomErasing (one clamped attempt, value 0): a box of
    H·W·``area`` pixels and aspect exp(``log_ratio``) at (oy, ox), on the
    images where ``erase`` is set."""
    B, C, H, W = images.shape
    area = H * W * area
    r = torch.exp(log_ratio)
    h = torch.round(torch.sqrt(area * r)).clamp(1, H).long()
    w = torch.round(torch.sqrt(area / r)).clamp(1, W).long()
    yy = torch.arange(H, device=images.device)[None, :, None]
    xx = torch.arange(W, device=images.device)[None, None, :]
    oy, ox = oy[:, None, None], ox[:, None, None]
    box = ((yy >= oy) & (yy < oy + h[:, None, None]) & (xx >= ox)
           & (xx < ox + w[:, None, None]))
    mask = box & erase[:, None, None]
    return torch.where(mask[:, None], torch.zeros_like(images), images)


def apply(spec: AugmentSpec, images, d: dict):
    """The spec's chain on ``images`` with the draws ``d``."""
    x = images
    if spec.resize_crop:
        x = apply_resize_crop(x, d["resize_oy"], d["resize_ox"],
                              spec.resize_crop)
    if spec.crop_padding:
        x = apply_crop_pad(x, d["crop_oy"], d["crop_ox"], spec.crop_padding)
    if spec.hflip:
        x = apply_hflip(x, d["flip"])
    if spec.rotation or spec.translate:
        x = apply_affine(x, d.get("angle"), d.get("tx"), d.get("ty"))
    if spec.brightness or spec.contrast or spec.saturation or spec.hue:
        x = apply_color_jitter(x, d.get("brightness"), d.get("contrast"),
                               d.get("saturation"), d.get("hue"))
    if spec.mean is not None:
        x = apply_normalize(x, spec.mean, spec.std)
    if spec.erasing_p:
        x = apply_erasing(x, d["erase"], d["erase_area"],
                          d["erase_log_ratio"], d["erase_oy"], d["erase_ox"])
    return x


def augment(spec: AugmentSpec, images, generator: torch.Generator,
            rows=None):
    """Draw from ``generator`` and apply: the train step's augmentation
    (``rows``: see ``draw``)."""
    return apply(spec, images, draw(spec, images.shape, generator,
                                    images.device, rows))
