"""Stage 2 (self-distillation) train steps on the CPU, against the JAX
package from the same weights and batches: K=3 ``stage='sd'`` steps of
``tsn_sd`` (a ResNet-50 cut to one bottleneck a stage, as
``tests/test_torch_train.py`` does), the first step's gradients with and
without gradient accumulation, the multi-output eval step, and the
joint stage's refusal.  Kept apart from ``tests/test_torch_sd.py`` so that
the two files run on different test workers.

fp32.  Tolerances: the train steps as ``tests/test_torch_train.py`` holds
them, with the exceptions that KINK_TOL documents."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.preprocess_device import normalize_clip as j_normalize
from ehgr_tpu.train.steps import make_eval_step as j_make_eval_step
from ehgr_tpu_torch.configs import LossConfig, OptimConfig
from ehgr_tpu_torch.models.convert import load_jax_variables
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.preprocess_device import normalize_clip
from ehgr_tpu_torch.train.optim import build_optimizer
from ehgr_tpu_torch.train.steps import (create_train_state, make_eval_step,
                                        make_train_step)

from test_torch_train import (MEAN, STD, N, check_trajectory, jax_result,
                              make_batches, one_thread, port_result,
                              port_run, tiny_resnet)
from test_torch_train import single_thread  # noqa: F401  (a fixture)

CLS, T = 5, 4
# K=3 SD steps: the exits end at 1x1 with 8 values a BN channel, and three
# steps of this random network are only good to ~3% (median) and up to ~40%
# of a tensor against a float64 run of the port, for the JAX and the port's
# f32 runs alike (they sit within 1e-5 of each other's distance there).  So
# the two f32 runs are held to each other at these limits after three
# steps (measured 1.3e-2 and 7.8e-2), and to test_torch_train's TOL after
# one.
KINK_TOL, KINK_MOMENTUM_TOL = 3e-2, 1e-1
# the leaves whose gradient flows through scala1.2's first BN (the stem,
# layer1 and exit 1); see test_accum_gap_is_a_relu_kink
KINK_UPSTREAM = ("base_model.conv1.", "base_model.bn1.",
                 "base_model.layer1.", "scala1.")


def _sd_steps(accum, mode, k=3):
    return (jax_result("tsn_sd", "sd", accum, k=k),
            port_result("tsn_sd", "sd", accum, mode, k=k))


class TestSdSteps:
    @pytest.mark.parametrize("accum,mode", [(1, "vjp"), (1, None)])
    def test_k_steps_match_jax(self, accum, mode):
        """Losses at each step within 1e-4; after three steps the deltas
        within KINK_TOL and the momentum within KINK_MOMENTUM_TOL (see
        their note)."""
        res, port = _sd_steps(accum, mode)
        check_trajectory(res, port, "sd", tol=KINK_TOL,
                         momentum_tol=KINK_MOMENTUM_TOL)
        for i, (got, want) in enumerate(zip(port[2], res[1])):
            for key in ("mid_ce", "kd", "feat"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=f"step {i} {key}")

    @pytest.mark.parametrize("accum", [1, 2])
    def test_first_step_gradients(self, accum):
        """One step, every leaf held to test_torch_train's TOL, except with
        ``accum_steps=2`` the leaves upstream of the ReLU kink that
        ``test_accum_gap_is_a_relu_kink`` shows (KINK_UPSTREAM), held to
        KINK_TOL: there the two f32 runs take that ReLU on opposite sides
        (measured up to 9.9e-3, ``scala1.2.op.2.bias``; every other leaf
        within TOL)."""
        check_trajectory(*_sd_steps(accum, "vjp", k=1), "sd",
                         loose=(KINK_UPSTREAM if accum > 1 else (),
                                KINK_TOL))

    def test_accum_gap_is_a_relu_kink(self):
        """The second microbatch of the ``accum_steps=2`` step puts one
        output of ``scala1.2``'s first BN at -4.8e-8 in a float64 run of
        the port, inside both f32 runs' rounding of it (port +2.0e-6 on one
        thread, JAX -5.2e-6, jitted as its train step is): the two runs take
        its ReLU on opposite sides, and that element's gradient reaches the
        leaves of KINK_UPSTREAM only.  The port's f32 output of that BN is
        no farther from float64 than JAX's (max abs error 3.1e-5 against
        4.6e-5)."""
        flat0 = jax_result("tsn_sd", "sd", 2, k=1)[0]
        rgb = make_batches(0, False, n=N * 2)[0]["rgb"][N:]
        with tiny_resnet():
            jm = j_variant("tsn_sd", num_class=CLS, num_segments=T,
                           partial_bn=False, dropout=0.0, action_fused="vjp")
            _, mut = jax.jit(lambda v, x: jm.apply(
                v, x, train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: m.path[-3:] == (
                    "scala1", "sep2", "bn1")))(
                unflatten_dict(flat0),
                j_normalize(jnp.asarray(rgb), MEAN, STD, dtype=jnp.float32))
        (jax32,), = flatten_dict(mut["intermediates"]).values()
        jax32 = np.asarray(jax32, np.float64).reshape(N * T, -1)
        port = {}
        with one_thread():
            for dtype in (torch.float32, torch.float64):
                with tiny_resnet():
                    m = variant("tsn_sd", num_class=CLS, num_segments=T,
                                partial_bn=False, dropout=0.0, dtype=dtype,
                                device="cpu")
                load_jax_variables(m, flat0)
                m.to(dtype).train()
                m.scala1[2].op[2].register_forward_hook(
                    lambda mod, i, o, dtype=dtype: port.__setitem__(
                        dtype,
                        o.detach().double().reshape(N * T, -1).numpy()))
                m(normalize_clip(torch.as_tensor(rgb), MEAN, STD,
                                 dtype=torch.float32))
        f64, f32 = port[torch.float64], port[torch.float32]
        port_err, jax_err = np.abs(f32 - f64), np.abs(jax32 - f64)
        flips = np.argwhere((f32 > 0) != (jax32 > 0))
        assert len(flips) == 1
        for i, j in flips:
            assert abs(f64[i, j]) <= min(port_err[i, j], jax_err[i, j])
        assert port_err.max() <= jax_err.max()

    def test_eval_step_multi_output_matches_jax(self):
        """``make_eval_step(multi_output=True)``: top-1/5 hits of the final
        head and the three exits, live and EMA weights."""
        from ehgr_tpu.train.steps import TrainState

        res = jax_result("tsn_sd", "sd", 1, k=1)
        batch = make_batches(0, False)[0]
        model, state, _ = port_run("tsn_sd", "sd", 1, "vjp", res[0],
                                   [batch])
        jstate = TrainState(
            step=0, params=_nested(res[2]["params"]),
            batch_stats=_nested(res[2]["batch_stats"]), opt_state=None,
            ema_params=_nested(res[2]["ema_params"]),
            ema_batch_stats=_nested(res[2]["ema_batch_stats"]))
        for use_ema in (False, True):
            got = {k: int(v) for k, v in make_eval_step(
                model, mean=MEAN, std=STD, use_ema=use_ema,
                multi_output=True)(state, batch).items()}
            assert set(got) == {"n"} | {f"{h}_top{k}" for h in
                                        ("final", "mid1", "mid2", "mid3")
                                        for k in (1, 5)}
            with tiny_resnet():
                jm = j_variant("tsn_sd", num_class=CLS, num_segments=T,
                               partial_bn=False, dropout=0.0)
                want = j_make_eval_step(
                    jm, mean=MEAN, std=STD, use_ema=use_ema,
                    multi_output=True)(
                    jstate, {k: jnp.asarray(a) for k, a in batch.items()})
            assert got == {k: int(a) for k, a in want.items()}

    @pytest.mark.usefixtures("single_thread")
    def test_joint_stage_raises(self):
        with tiny_resnet():
            m = variant("tsn_sd", num_class=CLS, num_segments=T,
                        device="cpu")
        opt, _ = build_optimizer(m, OptimConfig())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(m, opt, stage="mtmm_sd", loss_cfg=LossConfig(),
                            ema_decay=0.9, mean=MEAN, std=STD)
        step = make_train_step(m, opt, stage="sd", loss_cfg=LossConfig(),
                               ema_decay=0.9, mean=MEAN, std=STD)
        _, metrics = step(create_train_state(m, opt),
                          make_batches(1, False)[0],
                          torch.Generator().manual_seed(0))
        assert {"ce", "mid_ce", "kd", "feat", "loss"} <= set(metrics)


def _nested(flat):
    """``{(collection, *path): array}`` -> the nested tree of one
    collection (the collection name dropped)."""
    out = {}
    for p, a in flat.items():
        node = out
        for part in p[1:-1]:
            node = node.setdefault(part, {})
        node[p[-1]] = jnp.asarray(a)
    return out
