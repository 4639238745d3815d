"""flax -> torch checkpoint EXPORT tests (torch_import.export_state_dict).

The interop direction the import parity tests don't cover: weights trained
in this framework must load into the ACTUAL reference torch models and
reproduce the same outputs.  Verified here by round-tripping
reference-calibrated weights torch -> flax -> torch and comparing the two
torch nets' forwards, plus an exact import(export(x)) == x round trip."""

import importlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ehgr_tpu.compat.torchvision_shim import install as _install_tv
from ehgr_tpu.models.torch_import import (convert_state_dict,
                                          export_state_dict,
                                          load_torch_checkpoint,
                                          save_torch_checkpoint)
from ehgr_tpu.models.tsn import variant

REF = "/root/reference"
N, T, H, CLS = 2, 4, 64, 7


@pytest.fixture(scope="module", autouse=True)
def _torchvision_shim():
    """The torchvision shim, for this module's tests only: it has no
    ``__spec__``, so left in ``sys.modules`` it breaks a later import of
    ``transformers`` in the same process (``find_spec("torchvision")``)."""
    _install_tv()
    yield
    for k in [k for k, v in sys.modules.items()
              if k.split(".")[0] == "torchvision"
              and getattr(v, "__spec__", None) is None]:
        del sys.modules[k]


def _flax(arch, seed=0):
    model = variant(arch, num_class=CLS, num_segments=T,
                    base_model="resnet50", temporal="action",
                    partial_bn=False)
    x0 = jnp.zeros((N, T, H, H, 3), jnp.float32)
    variables = jax.jit(lambda r, x: model.init(r, x, train=False))(
        {"params": jax.random.key(seed)}, x0)
    return model, variables


class TestRoundTrip:
    def test_export_then_import_is_identity(self):
        _, variables = _flax("tsn_sd")
        sd = export_state_dict(variables)
        _, fresh = _flax("tsn_sd", seed=1)
        back, missing = convert_state_dict(sd, fresh)
        assert not missing, missing[:8]
        a = jax.tree_util.tree_leaves_with_path(variables)
        b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(a) == len(b)
        for kp, leaf in a:
            np.testing.assert_array_equal(np.asarray(leaf),
                                          np.asarray(b[kp]),
                                          err_msg=str(kp))

    def test_save_then_load_checkpoint_file(self, tmp_path):
        _, variables = _flax("tsn")
        path = save_torch_checkpoint(str(tmp_path / "m.pth.tar"), variables)
        _, fresh = _flax("tsn", seed=2)
        back, missing = load_torch_checkpoint(path, fresh)
        assert not missing
        np.testing.assert_array_equal(
            np.asarray(variables["params"]["new_fc"]["kernel"]),
            np.asarray(back["params"]["new_fc"]["kernel"]))


class TestReferenceInterop:
    """Exported weights drive the ACTUAL reference torch model."""

    def _ref_net(self):
        if REF not in sys.path:
            sys.path.insert(0, REF)
        mod = importlib.import_module("models.models_SD")
        torch.manual_seed(0)
        net = mod.TSN(CLS, T, "RGB", base_model="resnet50", is_shift=True,
                      shift_div=8, pretrain="", print_spec=False,
                      partial_bn=False)
        net.train()
        gen = np.random.default_rng(99)
        with torch.no_grad():
            for _ in range(8):   # calibrate BN stats away from init blowup
                net(torch.from_numpy(gen.standard_normal(
                    (N, T, 3, H, H)).astype(np.float32)))
        net.eval()
        return net, mod

    def test_reference_model_accepts_and_matches(self):
        net_ref, mod = self._ref_net()
        # torch -> flax (the parity-tested import path)
        model, variables = _flax("tsn_sd")
        variables, missing = convert_state_dict(net_ref.state_dict(),
                                                variables)
        assert not missing
        # flax -> torch into a FRESH reference net
        sd = {k: torch.from_numpy(v) for k, v in
              export_state_dict(variables).items()}
        torch.manual_seed(123)              # different init than net_ref
        net2 = mod.TSN(CLS, T, "RGB", base_model="resnet50", is_shift=True,
                       shift_div=8, pretrain="", print_spec=False,
                       partial_bn=False)
        res = net2.load_state_dict(sd, strict=False)
        # only torch-internal BN counters may be missing; nothing unexpected
        assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
        assert res.unexpected_keys == []
        net2.eval()
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (N, T, 3, H, H)).astype(np.float32))
        with torch.no_grad():
            out_ref = net_ref(x)
            out2 = net2(x)
        for i, (a, b) in enumerate(zip(out_ref, out2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"output {i}")
