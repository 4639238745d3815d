"""Port parity on the CPU: temporal ops, consensus, preprocessing and the
metrics of ``ehgr_tpu_torch`` against their ``ehgr_tpu`` counterparts, from
the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ehgr_tpu import configs as jconfigs
from ehgr_tpu.eval.metrics import ConfusionMatrix as JConfusionMatrix
from ehgr_tpu.eval.metrics import topk_correct as j_topk_correct
from ehgr_tpu.ops import temporal_shift as jts
from ehgr_tpu.ops.consensus import consensus as j_consensus
from ehgr_tpu.ops.preprocess_device import normalize_clip as j_normalize_clip
from ehgr_tpu.ops.preprocess_device import \
    preprocess_eval_batch as j_preprocess_eval_batch
from ehgr_tpu_torch import configs
from ehgr_tpu_torch.eval.metrics import ConfusionMatrix, topk_correct
from ehgr_tpu_torch.ops import temporal_shift as ts
from ehgr_tpu_torch.ops.consensus import consensus
from ehgr_tpu_torch.ops.preprocess_device import (normalize_clip,
                                                  preprocess_eval_batch)

# fp32 on both sides; the sums run in another order
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().float().numpy()


class TestTemporalOps:
    def test_learnable_shift(self, rng):
        x = rng.standard_normal((2, 4, 3, 5, 16)).astype(np.float32)
        w = rng.standard_normal((3, 16)).astype(np.float32)
        want = np.asarray(jts.learnable_shift(jnp.asarray(x), jnp.asarray(w)))
        got = ts.learnable_shift(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(_np(got), want, **TOL)

    @pytest.mark.parametrize("fold_div", [8, 4])
    def test_temporal_shift(self, rng, fold_div):
        x = rng.standard_normal((2, 5, 3, 3, 16)).astype(np.float32)
        want = np.asarray(jts.temporal_shift(jnp.asarray(x), fold_div))
        got = ts.temporal_shift(torch.from_numpy(x), fold_div)
        np.testing.assert_array_equal(_np(got), want)

    @pytest.mark.parametrize("t", [4, 5, 8])
    def test_temporal_pool(self, rng, t):
        x = rng.standard_normal((2, t, 3, 3, 8)).astype(np.float32)
        want = np.asarray(jts.temporal_pool(jnp.asarray(x)))
        got = ts.temporal_pool(torch.from_numpy(x))
        np.testing.assert_array_equal(_np(got), want)

    @pytest.mark.parametrize("c,div", [(16, 8), (12, 4), (64, 8)])
    def test_tsm_shift_init(self, c, div):
        np.testing.assert_array_equal(
            _np(ts.tsm_shift_init(c, div)),
            np.asarray(jts.tsm_shift_init(c, div)))


class TestConsensus:
    @pytest.mark.parametrize("kind", ["avg", "identity"])
    def test_matches_jax(self, rng, kind):
        x = rng.standard_normal((3, 8, 5)).astype(np.float32)
        want = np.asarray(j_consensus(jnp.asarray(x), kind))
        np.testing.assert_allclose(_np(consensus(torch.from_numpy(x), kind)),
                                   want, **TOL)

    def test_unknown_type_raises(self):
        with pytest.raises(ValueError, match="unknown consensus"):
            consensus(torch.zeros(2, 3), "max")


class TestPreprocess:
    def test_normalize_clip_fp32(self, rng):
        x = rng.integers(0, 256, (2, 4, 8, 8, 3), dtype=np.uint8)
        want = np.asarray(j_normalize_clip(jnp.asarray(x)))
        np.testing.assert_allclose(_np(normalize_clip(torch.from_numpy(x))),
                                   want, rtol=1e-6, atol=1e-6)

    def test_preprocess_eval_batch_at_crop_size(self, rng):
        """At crop size the JAX version only normalizes; so does the port
        (bf16: one rounding of the same f32 values, so within 1 ulp)."""
        x = rng.integers(0, 256, (2, 4, 16, 16, 3), dtype=np.uint8)
        want = np.asarray(j_preprocess_eval_batch(
            jnp.asarray(x), crop_size=16), np.float32)
        got = preprocess_eval_batch(torch.from_numpy(x), crop_size=16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -8, atol=1e-6)

    @pytest.mark.parametrize("square", [True, False])
    def test_resize_is_refused(self, square):
        x = torch.zeros((1, 2, 20, 24, 3), dtype=torch.uint8)
        with pytest.raises(NotImplementedError, match="preprocess resize"):
            preprocess_eval_batch(x, crop_size=16, square_resize=square)


class TestMetrics:
    def test_topk_correct_matches_jax(self, rng):
        logits = rng.standard_normal((16, 10)).astype(np.float32)
        labels = rng.integers(0, 10, (16,))
        want = [int(v) for v in j_topk_correct(jnp.asarray(logits),
                                               jnp.asarray(labels), (1, 5))]
        got = [int(v) for v in topk_correct(torch.from_numpy(logits),
                                            torch.from_numpy(labels),
                                            (1, 5))]
        assert got == want

    def test_confusion_matrix_matches_jax(self, rng):
        preds, labels = rng.integers(0, 6, (2, 40))
        a, b = ConfusionMatrix(6), JConfusionMatrix(6)
        a.update(preds, labels)
        b.update(preds, labels)
        np.testing.assert_array_equal(a.m, b.m)
        np.testing.assert_allclose(a.per_class_accuracy, b.per_class_accuracy)
        np.testing.assert_allclose(a.normalized, b.normalized)


class TestConfigs:
    @pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
    def test_presets_copy_the_jax_ones(self, name):
        """The port's own copy carries the data and model settings of every
        JAX preset unchanged."""
        mine, theirs = configs.get_preset(name), jconfigs.get_preset(name)
        assert dataclasses.asdict(mine.data) == \
            dataclasses.asdict(theirs.data)
        assert dataclasses.asdict(mine.model) == \
            dataclasses.asdict(theirs.model)

    def test_validate_rejects_mismatch(self):
        cfg = configs.get_preset("ego_baseline")
        bad = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    num_segments=4))
        with pytest.raises(ValueError, match="clip_len"):
            bad.validate()
