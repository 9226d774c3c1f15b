"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a test size (the
harness's look for a card skipped), with one fault planted in the
program, and checks ``correct`` against the committed limits: a step that
leaves its state unchanged; half of each batch left out, the mean taken
over the rest; an answer altered where it is produced. (The exchange
between chips has no place in a one-chip cell.)"""

import torch

from bench_h100.harness import core
from conftest import tiny_run


def _train(tmp_path):
    return core.execute(tiny_run("cartnet_adp.train", tmp_path, seconds=0.3))


def _half(loss_fn):
    """``loss_fn`` with the second half of the batch's crystals out of
    the loss mask."""
    def fn(model, batch, cfg, *a, **k):
        keep = batch.graph_id < batch.num_graphs // 2
        return loss_fn(model, batch.__class__(**{
            **batch.__dict__, "non_h_mask": batch.non_h_mask & keep}),
            cfg, *a, **k)
    return fn


def test_sound_training_is_correct(tmp_path):
    assert _train(tmp_path)["correct"] is True


def test_state_left_unchanged(tmp_path, monkeypatch):
    from cartnet_tpu_torch.train import schedule
    monkeypatch.setattr(schedule.OneCycleAdam, "step_where",
                        lambda self, grads, pred: None)
    out = _train(tmp_path)
    assert out["correct"] is False
    assert out["compared"]["change_gap_total"]["value"] == 1.0


def test_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from cartnet_tpu_torch.train import loop
    monkeypatch.setattr(loop, "loss_fn", _half(loop.loss_fn))
    assert _train(tmp_path)["correct"] is False


def test_training_answer_altered(tmp_path, monkeypatch):
    from cartnet_tpu_torch.train import loop
    real = loop.loss_fn

    def altered(*a, **k):
        loss, rest = real(*a, **k)
        return loss * 1.01, rest
    monkeypatch.setattr(loop, "loss_fn", altered)
    assert _train(tmp_path)["correct"] is False


def _infer(tmp_path, monkeypatch, alter=None):
    from cartnet_tpu_torch.models import cartnet
    if alter is not None:
        real = cartnet.CartNet.forward

        def forward(self, batch, *a, **k):
            pred, mask = real(self, batch, *a, **k)
            return alter(pred.clone(), batch), mask
        monkeypatch.setattr(cartnet.CartNet, "forward", forward)
    return core.execute(tiny_run("cartnet_adp.infer", tmp_path,
                                 seconds=0.3))


def test_sound_sweep_is_correct(tmp_path, monkeypatch):
    assert _infer(tmp_path, monkeypatch)["correct"] is True


def test_sweep_half_of_the_batch_left_out(tmp_path, monkeypatch):
    def half(pred, batch):
        out = pred.clone()
        out[batch.graph_id >= batch.num_graphs // 2] = 0.0
        return out
    assert _infer(tmp_path, monkeypatch, half)["correct"] is False


def test_sweep_answer_altered(tmp_path, monkeypatch):
    def one(pred, batch):
        first = torch.nonzero(batch.graph_id == 0)[:, 0]
        pred[first] = pred[first] * 1.01
        return pred
    assert _infer(tmp_path, monkeypatch, one)["correct"] is False
