"""Port parity on the CPU for the MTMM heads and the training pieces around
the step: ``GlobalDepthDecoder``, ``depth_to_target``, every loss, the
optimizer's group labels, the policy SGD update, gradient clipping and the
EMA, each against its ``ehgr_tpu`` counterpart from the same numpy inputs.
fp32; rtol = atol = 1e-5 unless stated (the sums run in another order)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from ehgr_tpu.configs import OptimConfig as JOptimConfig
from ehgr_tpu.models.decoders import GlobalDepthDecoder as JDecoder
from ehgr_tpu.models.tsn import variant as j_variant
from ehgr_tpu.ops.preprocess_device import depth_to_target as j_depth
from ehgr_tpu.train import losses as jl
from ehgr_tpu.train.ema import ema_update as j_ema_update
from ehgr_tpu.train.optim import label_params as j_label_params
from ehgr_tpu.train.optim import sgd_policies
from ehgr_tpu_torch.configs import OptimConfig
from ehgr_tpu_torch.models.convert import state_dict_from_jax, torch_key
from ehgr_tpu_torch.models.decoders import GlobalDepthDecoder
from ehgr_tpu_torch.models.tsn import variant
from ehgr_tpu_torch.ops.preprocess_device import depth_to_target
from ehgr_tpu_torch.train import losses as tl
from ehgr_tpu_torch.train.ema import ema_update
from ehgr_tpu_torch.train.optim import (SgdPolicies, build_optimizer,
                                        clip_gradient, label_params)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy()


class TestGlobalDepthDecoder:
    @pytest.mark.parametrize("train", [False, True])
    def test_matches_jax(self, rng, train):
        """Output (and, training, the BN statistics it leaves) from the
        same weights; the layer4 width is cut to 64 channels."""
        x = rng.standard_normal((4, 3, 3, 64)).astype(np.float32)
        j = JDecoder()
        v = j.init(jax.random.key(0), jnp.asarray(x), train=False)
        flat = {("params" if p[0] == "params" else "batch_stats",
                 "global_decoder") + p[1:]: np.asarray(a)
                for p, a in flatten_dict(v).items()}
        for p in flat:                       # statistics off (0, 1)
            if p[-1] in ("mean", "var", "bias", "scale"):
                flat[p] = rng.uniform(0.5, 1.5, flat[p].shape).astype(
                    np.float32)
        sd = {k[len("global_decoder."):]: t
              for k, t in state_dict_from_jax(flat).items()}
        tm = GlobalDepthDecoder(64, device="cpu")
        tm.load_state_dict(sd, strict=True)
        tm.train(train)
        jv = {"params": {}, "batch_stats": {}}
        for p, a in flat.items():
            node = jv[p[0]]
            for part in p[2:-1]:
                node = node.setdefault(part, {})
            node[p[-1]] = jnp.asarray(a)
        if train:
            want, mut = j.apply(jv, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        else:
            want = j.apply(jv, jnp.asarray(x), train=False)
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape == (4, 1, 24, 24)
        np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                                   np.asarray(want), **TOL)
        if train:
            stats = {k[len("global_decoder."):]: t for k, t in
                     state_dict_from_jax(flatten_dict(
                         {"batch_stats": {"global_decoder":
                                          jax.device_get(
                                              mut["batch_stats"])}})
                     ).items()}
            for k, t in stats.items():
                np.testing.assert_allclose(_np(tm.state_dict()[k]),
                                           t.numpy(), err_msg=k, **TOL)


class TestDepthTarget:
    @pytest.mark.parametrize("hw,size", [(224, 56), (32, 8), (40, 12)])
    def test_matches_jax_gather(self, rng, hw, size):
        d = rng.integers(0, 256, (2, 3, hw, hw, 1), dtype=np.uint8)
        want = np.asarray(j_depth(jnp.asarray(d), size))
        got = depth_to_target(torch.from_numpy(d), size)
        assert got.shape == want.shape == (2, 3, size, size, 1)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)

    def test_same_size_only_scales(self, rng):
        d = rng.integers(0, 256, (1, 2, 8, 8, 1), dtype=np.uint8)
        np.testing.assert_array_equal(
            _np(depth_to_target(torch.from_numpy(d), 8)),
            np.asarray(j_depth(jnp.asarray(d), 8)))


def _loss_inputs(rng):
    n, k = 4, 7
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return dict(logits=f(n, k), labels=rng.integers(0, k, (n,)),
                mids=[f(n, k) for _ in range(3)], fea=f(n, 16),
                mid_feas=[f(n, 16) for _ in range(3)],
                depth=rng.uniform(0, 1, (n, 8, 8, 1)).astype(np.float32),
                depth_gt=rng.uniform(0, 1, (n, 8, 8, 1)).astype(np.float32))


def _call(mod, name, a, arr):
    """Loss ``name`` of module ``mod`` on the inputs ``a`` wrapped by
    ``arr``; returns the total (a scalar)."""
    lab = arr(a["labels"])
    if name == "cross_entropy":
        return mod.cross_entropy(arr(a["logits"]), lab)
    if name == "kd_loss":
        return mod.kd_loss(arr(a["mids"][0]), arr(a["logits"]), 3.0)
    if name == "feature_hint_loss":
        return mod.feature_hint_loss(arr(a["mid_feas"][0]), arr(a["fea"]))
    if name == "depth_loss":
        return mod.depth_loss(arr(a["depth"]), arr(a["depth_gt"]))
    if name == "mtmm_total":
        return mod.mtmm_total(arr(a["logits"]), lab, arr(a["depth"]),
                              arr(a["depth_gt"]))[0]
    mids = [arr(m) for m in a["mids"]]
    feas = [arr(m) for m in a["mid_feas"]]
    if name == "sd_total":
        return mod.sd_total(arr(a["logits"]), mids, lab, arr(a["fea"]),
                            feas)[0]
    return mod.mtmm_sd_total(arr(a["logits"]), mids, lab, arr(a["fea"]),
                             feas, arr(a["depth"]), arr(a["depth_gt"]))[0]


class TestLosses:
    @pytest.mark.parametrize("name", [
        "cross_entropy", "kd_loss", "feature_hint_loss", "depth_loss",
        "mtmm_total", "sd_total", "mtmm_sd_total"])
    def test_value_and_gradient_match_jax(self, rng, name):
        """Value and the gradient with respect to every float input (the
        teachers are detached on both sides)."""
        a = _loss_inputs(rng)
        keys = ("logits", "mids", "fea", "mid_feas", "depth")

        def j_fn(*xs):
            b = dict(a, **dict(zip(keys, xs)))
            return _call(jl, name, b, jnp.asarray)

        j_val, j_grads = jax.value_and_grad(j_fn, argnums=range(5))(
            *(jax.tree.map(jnp.asarray, a[k]) for k in keys))
        leaves = {k: (torch.from_numpy(a[k]).requires_grad_()
                      if isinstance(a[k], np.ndarray) else
                      [torch.from_numpy(m).requires_grad_() for m in a[k]])
                  for k in keys}
        b = dict(a, **leaves)
        val = _call(tl, name, b, lambda v: v if torch.is_tensor(v)
                    else torch.from_numpy(v))
        val.backward()
        np.testing.assert_allclose(val.item(), float(j_val), **TOL)
        for k, jg in zip(keys, j_grads):
            mine = leaves[k] if isinstance(leaves[k], list) else [leaves[k]]
            theirs = jg if isinstance(jg, list) else [jg]
            for m, t in zip(mine, theirs):
                got = np.zeros(m.shape, np.float32) if m.grad is None \
                    else _np(m.grad)
                np.testing.assert_allclose(got, np.asarray(t), err_msg=k,
                                           **TOL)


class TestOptimizer:
    @pytest.mark.parametrize("partial_bn", [False, True])
    def test_labels_match_the_jax_walk(self, partial_bn):
        """Every parameter of the full-width tsn_mtmm gets the group the
        JAX walk gives its flax leaf (keyed through ``torch_key``)."""
        jm = j_variant("tsn_mtmm", num_class=5, num_segments=4,
                       partial_bn=partial_bn)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, 4, 32, 32, 3)), train=False))
        want = {torch_key(p): lab for p, lab in flatten_dict(
            j_label_params(shapes["params"], fc_lr5=True,
                           partial_bn=partial_bn)).items()}
        m = variant("tsn_mtmm", num_class=5, num_segments=4,
                    partial_bn=partial_bn, device="cpu")
        got = label_params(m, fc_lr5=True, partial_bn=partial_bn)
        assert got == want
        assert len(got) == len(list(m.parameters()))
        if partial_bn:
            assert got["base_model.layer1.0.conv1.action_p3_bn1.weight"] \
                == "frozen"
            assert got["base_model.bn1.weight"] == "bn"

    def test_sgd_matches_optax_across_decay(self, rng):
        """Five updates of parameters in every group, one decay boundary
        crossed (steps_per_epoch 1, lr_steps (1, 3))."""
        labels = {f"p{i}": g for i, g in enumerate(
            ("first_conv_weight", "normal_weight", "normal_bias", "bn",
             "custom_weight", "custom_bn", "lr5_weight", "lr10_bias",
             "frozen"))}
        params = {k: rng.standard_normal((3, 4)).astype(np.float32)
                  for k in labels}
        grads = [{k: rng.standard_normal((3, 4)).astype(np.float32)
                  for k in labels} for _ in range(5)]
        kw = dict(base_lr=0.01, momentum=0.9, weight_decay=1e-3,
                  lr_steps=(1, 3), gamma=0.1, steps_per_epoch=1)
        tx = sgd_policies(labels, **kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = tx.init(jp)
        opt = SgdPolicies(labels, **kw)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = opt.init(tp)
        for g in grads:
            upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
            jp = optax.apply_updates(jp, upd)
            opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert ts.step == int(js.step) == 5
        for k in labels:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(_np(ts.momentum[k]),
                                       np.asarray(js.momentum[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(_np(tp["p8"]), params["p8"])  # frozen

    @pytest.mark.parametrize("max_norm", [0.5, 100.0])
    def test_clip_gradient_matches_optax(self, rng, max_norm):
        g = {k: rng.standard_normal((5,)).astype(np.float32)
             for k in ("a", "b")}
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in g.items()}, None)
        got = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        clip_gradient(got, max_norm)
        for k in g:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)

    def test_build_optimizer_reads_the_config(self):
        m = variant("tsn", num_class=5, num_segments=4, device="cpu")
        opt, labels = build_optimizer(
            m, OptimConfig(lr=0.1, clip_gradient=2.0, policies=False))
        assert set(labels.values()) == {"normal_weight"}
        assert opt.clip == 2.0 and opt.group_lr["lr5_weight"] == \
            np.float32(0.5)
        assert JOptimConfig().lr == OptimConfig().lr


def test_ema_matches_jax(rng):
    ema = {k: rng.standard_normal((6,)).astype(np.float32) for k in "ab"}
    new = {k: rng.standard_normal((6,)).astype(np.float32) for k in "ab"}
    want = j_ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                        {k: jnp.asarray(v) for k, v in new.items()}, 0.9999)
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    ema_update(got, {k: torch.from_numpy(v) for k, v in new.items()},
               0.9999)
    for k in ema:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
