"""The port's checkpoints (`lara_tpu_torch/train/checkpoint.py`): a run
saved, restored into a fresh net and continued ends bit for bit where the
same run without the interruption ends, also when the checkpoint falls
between the two micro-steps of one gradient accumulation (the open
accumulation's gradients are saved, as optax MultiSteps keeps them in its
state); the newest five are kept. CPU, f32, exact comparison: the same ops
run in the same order on both paths."""

import dataclasses

import numpy as np
import pytest
import torch

from lara_tpu_torch.config import TrainConfig, config_from_dict
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.train import checkpoint as ckpt
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_train_step
from tests.test_model import synthetic_batch, tiny_config
from tests.test_torch_blend import one_torch_thread  # noqa: F401

TRAIN = TrainConfig(lr=1e-3, warmup_iters=1, grad_accum=2)


def _net(seed):
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    return LaRaNet(cfg, dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(seed))


def _batches():
    return [{k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(B=1, seed=s).items()}
            for s in (0, 1)]


def _run(net, state, batches, micro_steps):
    step = make_train_step(net, state, with_fine=True, grad_accum=TRAIN.grad_accum)
    for i in micro_steps:
        step(batches[i % 2])


@pytest.mark.parametrize("interrupt_at", [1, 2])
def test_resume_equals_no_interruption(tmp_path, interrupt_at, one_torch_thread):  # noqa: F811
    """4 micro-steps (two AdamW updates at grad_accum 2), interrupted after
    `interrupt_at` of them: 1 is inside the first accumulation."""
    batches = _batches()
    net_a = _net(0)
    state_a = TrainState(net_a, TRAIN, max_iters=10)
    _run(net_a, state_a, batches, range(4))

    net_b = _net(0)
    state_b = TrainState(net_b, TRAIN, max_iters=10)
    _run(net_b, state_b, batches, range(interrupt_at))
    path = ckpt.save_checkpoint(str(tmp_path), state_b, epoch=7)
    assert path.endswith(f"step_{interrupt_at:09d}.pt")
    saved = torch.load(path, weights_only=True)
    assert bool(saved["grads"]) == (interrupt_at % TRAIN.grad_accum != 0)

    net_c = _net(1)                                   # other weights, restored over
    state_c = TrainState(net_c, TRAIN, max_iters=10)
    assert ckpt.restore_checkpoint(str(tmp_path), state_c) == 7
    assert state_c.step == interrupt_at
    _run(net_c, state_c, batches, range(interrupt_at, 4))

    assert state_c.step == state_a.step == 4
    for (name, a), c in zip(net_a.named_parameters(), net_c.parameters()):
        assert torch.equal(a, c), name
    opt_a, opt_c = state_a.optimizer.state_dict(), state_c.optimizer.state_dict()
    assert opt_a["state"].keys() == opt_c["state"].keys()
    for k, sa in opt_a["state"].items():
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[f], opt_c["state"][k][f]), (k, f)


def test_keep_five_latest_and_restore_params(tmp_path):
    net = _net(0)
    state = TrainState(net, TRAIN, max_iters=10)
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    for step in (3, 1, 4, 15, 9, 2, 6):
        state.step = step
        ckpt.save_checkpoint(str(tmp_path), state, epoch=step)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == [f"step_{s:09d}.pt" for s in (3, 4, 6, 9, 15)]
    assert ckpt.latest_step(str(tmp_path)) == 15
    params = ckpt.restore_params(str(tmp_path))
    assert params.keys() == net.state_dict().keys()
    assert all(torch.equal(params[k], v) for k, v in net.state_dict().items())
    other = TrainState(_net(1), TRAIN, max_iters=10)
    assert ckpt.restore_checkpoint(str(tmp_path / "step_000000004.pt"), other) == 4
    assert other.step == 4
    assert ckpt.restore_checkpoint(str(tmp_path), other, step=9) == 9
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "missing"), other)
