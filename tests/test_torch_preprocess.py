"""The port's on-device preprocess (``ehgr_tpu_torch/ops/preprocess_device``)
against ``ehgr_tpu.ops.preprocess_device.preprocess_eval_batch`` on the
CPU: the square resize (upsample, downsample, non-square frames) and the
short-side resize then centre crop, from the same uint8 frames (numpy,
seeded), at f32.

JAX's ``jax.image.resize(method='bilinear')`` antialiases when it shrinks;
the port's ``F.interpolate(antialias=True)`` computes the same function,
its pixels within ~6e-3 of JAX's in 0-255 (sums in another order), so the
normalized outputs are held to atol 1e-4."""

import numpy as np
import pytest
import torch

from ehgr_tpu.ops.preprocess_device import \
    preprocess_eval_batch as j_preprocess
from ehgr_tpu_torch.ops import preprocess_device as pp

import jax.numpy as jnp

ATOL = 1e-4
# (frames H, W), square, scale, crop
GEOMETRIES = {"up_4x3_square": ((120, 160), True, 224, 224),
              "down_square": ((300, 300), True, 224, 224),
              "short_side_crop": ((256, 341), False, 256, 224),
              "up_square": ((64, 64), True, 224, 224),
              "short_side_crop_4x3": ((240, 320), False, 256, 224),
              "portrait_short_side": ((50, 38), False, 36, 32),
              "identity": ((32, 32), True, 32, 32)}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_matches_jax(name):
    (h, w), square, scale, crop = GEOMETRIES[name]
    x = np.random.default_rng(len(name)).integers(
        0, 256, (2, 2, h, w, 3), dtype=np.uint8)
    want = np.asarray(j_preprocess(
        jnp.asarray(x), scale_size=scale, crop_size=crop,
        square_resize=square, dtype_name="float32"))
    got = pp.preprocess_eval_batch(torch.from_numpy(x), scale_size=scale,
                                   crop_size=crop, square_resize=square,
                                   dtype=torch.float32)
    assert got.shape == want.shape == (2, 2, crop, crop, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_identity_is_the_normalization_alone():
    x = torch.randint(0, 256, (1, 2, 32, 32, 3), dtype=torch.uint8)
    got = pp.preprocess_eval_batch(x, scale_size=48, crop_size=32,
                                   dtype=torch.float32)
    assert torch.equal(got, pp.normalize_clip(x))


@pytest.mark.parametrize("h,w,th,tw,y0,x0", [
    (7, 9, 4, 4, 2, 2),      # (7-4)/2 = 1.5 -> 2, (9-4)/2 = 2.5 -> 2
    (6, 11, 4, 4, 1, 4)])    # 1.0 -> 1, 3.5 -> 4: half to even
def test_center_crop_rounds_as_python(h, w, th, tw, y0, x0):
    x = torch.arange(h * w).reshape(1, h, w, 1)
    got = pp.center_crop_clip(x, (th, tw))
    assert torch.equal(got, x[:, y0:y0 + th, x0:x0 + tw])
