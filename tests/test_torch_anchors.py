"""Three golden anchors of ``tests/test_regression.py`` on the port, from
the same init as the JAX tests (key 42, N=2, T=4, 32^2, 5 classes, the
linspace input, full-depth ResNet-50, partial BN off, the plain ACTION
formulation): ``GOLD_MTMM_DEPTH``, the ``tsn_mtmm`` global depth output
that the MTMM loss trains, ``GOLD_MTMMSD_GDEPTH``, the ``tsn_mtmm_sd``
global transposed decoder's output (``out[9]``, ``modal='rgb_depth'``)
that the joint loss trains, and ``GOLD_TSN_STAGE4``, ``tsn`` with ACTION on
stage 4 alone.  The JAX variables are converted into the port's model; the
limits are the JAX tests'."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu_torch.models.convert import load_jax_variables
from ehgr_tpu_torch.models.tsn import variant

from test_regression import (GOLD_MTMM_DEPTH, GOLD_MTMMSD_GDEPTH,
                             GOLD_MTMMSD_GDEPTH_IDX, GOLD_TSN,
                             GOLD_TSN_STAGE4)
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T, HW = 5, 4, 32
pytestmark = pytest.mark.usefixtures("single_thread")


def _x():
    return np.linspace(-1, 1, 2 * T * HW * HW * 3,
                       dtype=np.float32).reshape(2, T, HW, HW, 3)


def port_outputs(arch, **kw):
    """The port's ``arch`` on the golden input, with the variables of the
    JAX test's init (``test_regression._build``)."""
    model = j_variant(arch, num_class=CLS, num_segments=T, temporal="action",
                      partial_bn=False, **kw)
    v = jax.jit(lambda r, xx: model.init(r, xx, train=False))(
        {"params": jax.random.key(42)}, jnp.asarray(_x()))
    m = variant(arch, num_class=CLS, num_segments=T, temporal="action",
                partial_bn=False, action_fused=None, device="cpu", **kw)
    load_jax_variables(m, {k: np.asarray(a)
                           for k, a in flatten_dict(v).items()})
    with torch.no_grad():
        return m(torch.from_numpy(_x()))


def test_tsn_mtmm_depth_anchor():
    logits, depth = port_outputs("tsn_mtmm")
    np.testing.assert_allclose(logits.numpy()[0, :5], GOLD_TSN, rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(depth.double().numpy().reshape(-1)[:5],
                               GOLD_MTMM_DEPTH, rtol=2e-2, atol=1e-5)


def test_tsn_mtmm_sd_gdepth_anchor():
    out = port_outputs("tsn_mtmm_sd")
    np.testing.assert_allclose(out[0].numpy()[0, :5], GOLD_TSN, rtol=2e-3,
                               atol=1e-4)
    g = out[9].double().numpy().reshape(-1)
    np.testing.assert_allclose(g[GOLD_MTMMSD_GDEPTH_IDX], GOLD_MTMMSD_GDEPTH,
                               rtol=2e-2)


def test_tsn_action_stage4_anchor():
    logits = port_outputs("tsn", action_stages=(4,))
    np.testing.assert_allclose(logits.numpy()[0, :5], GOLD_TSN_STAGE4,
                               rtol=2e-3, atol=1e-5)
