"""The benchmark's float32 reference against the program's CPU path at a
tiny size (32x32, 4 frames, 5 classes, float32, the same seeded state
dict): eval logits of both temporal modules and both ACTION formulations,
the training loss with its dropout mask and depth term, and one step's
parameters and EMA (the EMA at decay 0.5, where its blend is far above
float32 rounding)."""

import time

import pytest
import torch

from portbench import session
from portbench.harness import sub_seed
from portbench.kinds import train as train_kind
from portbench.reference.model import TSN
from portbench.reference.train import Ema, Sgd, train_steps
from portbench.tests import tiny
from portbench.traffic import make_pool


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("tiny"))


def setup(root, name, **model):
    c = tiny.cell(root, name)
    c.started = time.time()
    c.model.update(model)
    pool = make_pool(c.traffic, c.model, sub_seed(c.seed, 2), "cpu")
    first = pool[0]["frames" if c.traffic["kind"] == "serve" else "rgb"]
    weights = session.weights_and_stats(
        c, c.traffic["arch"] == "tsn_mtmm", first)
    return c, pool, weights


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name,mode", [(tiny.SERVE, "serve"),
                                       (tiny.TSM_SERVE, "serve"),
                                       (tiny.TRAIN, "train")])
def test_eval_logits(root, name, mode):
    """'mega' (serve) and the plain formulation ('vjp' at eval) of ACTION,
    and TSM."""
    c, pool, weights = setup(root, name)
    arch = "tsn"
    prog = session.program_model(c, arch, mode)
    prog.load_state_dict({k: v for k, v in weights.items()
                          if not k.startswith("global_decoder")})
    prog.eval()
    ref = TSN(c.model, with_depth=False, device="cpu")
    ref.load_state_dict({k: v for k, v in weights.items()
                         if not k.startswith("global_decoder")})
    ref.eval()
    frames = pool[0]["frames" if "frames" in pool[0] else "rgb"]
    x = session.frames_in(c, frames, "cpu")
    with torch.no_grad():
        assert rel(prog(x), ref(x)) < 1e-4


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.TSM_TRAIN])
def test_loss(root, name):
    from ehgr_tpu_torch.configs import LossConfig
    from ehgr_tpu_torch.train.steps import make_loss_fn

    c, pool, weights = setup(root, name)
    tr, m = c.traffic, c.model
    prog = session.program_model(c, tr["arch"], "train")
    prog.load_state_dict(weights)
    loss_fn = make_loss_fn(prog, stage=tr["stage"],
                           loss_cfg=LossConfig(depth_size=8), mean=m["mean"],
                           std=m["std"])
    batch = {k: torch.as_tensor(v) for k, v in pool[0].items()}
    prog.train()
    got = loss_fn(batch, torch.Generator().manual_seed(3))[0]

    ref = TSN(m, with_depth=tr["arch"] == "tsn_mtmm", device="cpu")
    ref.load_state_dict(weights)
    ref.train()
    x, labels, depth, mask = train_kind._batches(
        c, pool, torch.Generator().manual_seed(3),
        tr["arch"] == "tsn_mtmm")[0]
    from portbench.reference.train import loss_of
    want = loss_of(ref(x, mask), labels, depth,
                   c.config["loss"]["depth_weight"])
    # float32 both, in other orders of summation (measured: 2e-5)
    assert abs(float(got.detach()) - float(want.detach())) < \
        1e-4 * float(want.detach())


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.TSM_TRAIN])
def test_one_step_parameters_and_ema(root, name):
    c, pool, weights = setup(root, name)
    c.config["optim"].update(lr=1e-3, ema_decay=0.5)
    tr, m = c.traffic, c.model
    step, state = train_kind._step(c, weights)
    step(state, pool[0], torch.Generator().manual_seed(3))

    with_depth = tr["arch"] == "tsn_mtmm"
    ref = TSN(m, with_depth, device="cpu")
    ref.load_state_dict(weights)
    sgd = Sgd(ref, c.config["optim"])
    ema = Ema(ref, 0.5)
    batches = train_kind._batches(c, pool, torch.Generator().manual_seed(3),
                                  with_depth)[:1]
    train_steps(ref, batches, sgd, ema, c.config["loss"]["depth_weight"]
                if with_depth else 0.0)
    moved = 0
    for k, p in ref.named_parameters():
        want = p.detach() - weights[k]
        got = state.params[k].detach() - weights[k]
        # float32 CPU BN gradients part by ~2% on single leaves; a leaf
        # that moves by a few ulps of its weight reads its rounding
        floor = 1e-6 * float(weights[k].norm())
        assert float((got - want).norm()) <= \
            0.05 * float(want.norm()) + floor, k
        moved += int(float(want.norm()) > floor)
        ema_want = ema.values[k] - weights[k]
        ema_got = state.ema_params[k] - weights[k]
        assert float((ema_got - ema_want).norm()) <= \
            0.05 * float(ema_want.norm()) + floor, k
    assert moved > len(list(ref.parameters())) // 2
    stats = {k: v for k, v in ref.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    for k, v in stats.items():
        assert torch.allclose(state.batch_stats[k], v, rtol=1e-4,
                              atol=1e-5), k
        assert torch.allclose(state.ema_batch_stats[k], ema.values[k],
                              rtol=1e-4, atol=1e-5), k
