"""The training slice on the CPU, stage ``mtmm`` (arch ``tsn_mtmm``, CE +
0.01 * MSE of the global depth decoder against the depth resized to 8^2):
K=3 steps of the port's ``make_train_step`` against the JAX one, as
``test_torch_train.py`` does for ``baseline`` (same geometry and checks),
and the converter on the ``tsn_mtmm`` tree against ``export_state_dict``.

Tolerance: the first step's gradients within TOL (1e-3); K steps, and the
accumulated step over four clips, within KINK_TOL.  At this geometry the
decoder's first BN sees layer4 at 1x1, 8 values a channel, and on the
second half of that four-clip batch one of its outputs lies so close to
the ReLU's kink that f32 rounding in the backbone decides its side, and
with it a few percent of the decoder's gradient.
``test_f32_gradients_against_float64`` holds both f32 steps (JAX and the
port) to a float64 run of the port on that batch."""

import numpy as np
import pytest
import torch

from ehgr_tpu.models.torch_import import export_state_dict
from ehgr_tpu_torch.models.convert import state_dict_from_jax
from flax.traverse_util import unflatten_dict

from test_torch_train import (N, check_trajectory, jax_result, jax_run,
                              jax_setup_of, make_batches, one_thread,
                              port_result, port_run)

KINK_TOL = 3e-2


class TestMtmmSteps:
    @pytest.mark.parametrize("accum,mode", [(1, "vjp"), (2, "vjp"),
                                            (1, None)])
    def test_k_steps_match_jax(self, accum, mode):
        port = port_result("tsn_mtmm", "mtmm", accum, mode)
        check_trajectory(jax_result("tsn_mtmm", "mtmm", accum), port,
                         "mtmm", tol=KINK_TOL)
        assert all(np.isfinite(m["depth"]) and m["depth"] > 0
                   for m in port[2])

    def test_first_step_gradients(self):
        check_trajectory(jax_result("tsn_mtmm", "mtmm", 1, k=1),
                         port_result("tsn_mtmm", "mtmm", 1, "vjp", k=1),
                         "mtmm")

    def test_f32_gradients_against_float64(self):
        """One step on the second half of the four-clip batch: the JAX and
        the port's f32 momentum (the gradient plus weight decay) each within
        KINK_TOL of a float64 run of the port (plain formulation: the
        kernels take fp32 and bf16), tensor by tensor."""
        half = [{k: v[N:] for k, v in make_batches(0, True, n=2 * N)[0]
                 .items()}]
        flat0 = jax_result("tsn_mtmm", "mtmm", 1, k=1)[0]
        j_mom = state_dict_from_jax(jax_run(
            "tsn_mtmm", "mtmm", 1, half,
            jax_setup_of("tsn_mtmm", "mtmm", 1))[2]["momentum"])
        with one_thread():
            ref = port_run("tsn_mtmm", "mtmm", 1, None, flat0, half,
                           dtype=torch.float64)[1].opt_state.momentum
        mine = port_run("tsn_mtmm", "mtmm", 1, "vjp", flat0,
                        half)[1].opt_state.momentum
        for name, got in (("jax", j_mom), ("port", mine)):
            for k, r in ref.items():
                r = r.numpy()
                err = np.abs(got[k].double().numpy() - r).max()
                assert err <= KINK_TOL * np.abs(r).max(), (name, k)

    def test_converter_matches_export_state_dict(self):
        """The decoder's keys are the reference's nn.Sequential indices,
        conv4's bias included; every key and value as the JAX exporter
        writes them."""
        flat0 = jax_result("tsn_mtmm", "mtmm", 1)[0]
        want = export_state_dict(unflatten_dict(flat0))
        got = state_dict_from_jax(flat0)
        assert "global_decoder.15.bias" in got
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
