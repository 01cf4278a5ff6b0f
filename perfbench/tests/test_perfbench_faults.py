"""The check fails what it has to fail, on the CPU at a size a test run
holds: the control (the reference computed in the precision below the
cell's, in the program's place) and each fault the cells can have, planted
under the timed path of a whole run (the harness's look for a chip
skipped): a step that leaves its state unchanged, its loss altered where it
is produced, half of each batch left out (the mean over the rest), the
BatchNorm statistics of the fused conv miscounted, and,
over a group of ranks, the exchange of the gradients left out.  Beside
each, the sound run reads the same number within its limit."""

import dataclasses
import time

import pytest
import torch

from perfbench import checks, harness

CPU = torch.device("cpu")
SEED = 2**31 + 2024


def _small():
    """The f32 ResNet-50 cell at 64 px and a batch of 16 (the CPU's size)."""
    cell = harness.load_cell("rn50-i224-f32-b128", False)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, image_size=64, batch=16,
                                                  resident_images=48))


def _run(cell):
    _, correct, rows = harness.run(cell, SEED, 0.1, False, time.time(), CPU)
    return correct, {name: value for name, value, _ in rows}


@pytest.fixture(scope="module")
def sound():
    return _run(_small())


def test_control_fails_and_the_program_passes():
    """The f32 cell's TF32 control: its first loss and its worst leaf's
    first gradient read past their limits; the program's within them."""
    cell = _small()
    ref = checks.reference_readings(cell, SEED, CPU)
    control = checks.compare(checks.reference_readings(cell, SEED, CPU, "tf32"), ref)
    correct, _ = checks.judge(control, cell.limits)
    assert not correct
    assert control["grad_gap"] > 2 * cell.limits["grad_gap"]
    assert control["loss_gap_1"] > 10 * cell.limits["loss_gap_1"]


def test_sound_run_reads_within_the_limits_the_faults_break(sound):
    limits = _small().limits
    _, numbers = sound
    for name in ("loss_gap_1", "grad_gap"):
        assert numbers[name] <= limits[name], (name, numbers[name])


def test_state_left_unchanged_fails(monkeypatch, sound):
    import semantic_embeddings_torch.train as train

    make_train_step = train.make_train_step

    def frozen(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def unchanged(state, raw, lr, rng):
            saved = {k: v.clone() for k, v in state.model.state_dict().items()}
            velocity = [v.clone() for v in state.velocity]
            state, metrics = step(state, raw, lr, rng)
            state.model.load_state_dict(saved)
            with torch.no_grad():
                for v, old in zip(state.velocity, velocity):
                    v.copy_(old)
            return state, metrics

        return unchanged

    monkeypatch.setattr(train, "make_train_step", frozen)
    correct, numbers = _run(_small())
    assert not correct
    assert numbers["change_gap_median"] > 0.9 > sound[1]["change_gap_median"]


def test_loss_altered_where_produced_fails(monkeypatch, sound):
    """The answer a step gives, its loss, off by a thousandth."""
    import semantic_embeddings_torch.train as train

    make_train_step = train.make_train_step

    def altered(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def off(state, raw, lr, rng):
            state, metrics = step(state, raw, lr, rng)
            return state, dict(metrics, loss=metrics["loss"] * 1.001)

        return off

    monkeypatch.setattr(train, "make_train_step", altered)
    correct, numbers = _run(_small())
    assert not correct
    assert numbers["loss_gap_1"] > 50 * _small().limits["loss_gap_1"] > 50 * sound[1]["loss_gap_1"]


def test_half_of_each_batch_left_out_fails(monkeypatch, sound):
    from semantic_embeddings_torch.data.cifar import InMemoryDataset

    make_prepare = InMemoryDataset.make_prepare

    def halved(self, device, augment_train=True):
        prepare = make_prepare(self, device, augment_train)

        def first_half(raw, rng, train):
            images, labels = prepare(raw, rng, train)
            return images[: len(images) // 2], labels[: len(labels) // 2]

        return first_half

    monkeypatch.setattr(InMemoryDataset, "make_prepare", halved)
    correct, numbers = _run(_small())
    limits = _small().limits
    assert not correct
    assert numbers["grad_gap"] > 5 * limits["grad_gap"] > 5 * sound[1]["grad_gap"]
    assert numbers["change_gap_conv"] > limits["change_gap_conv"] > sound[1]["change_gap_conv"]


def test_statistics_miscounted_fails(monkeypatch, sound):
    """The conv + BatchNorm statistics op's sum of squares over by a
    hundredth in every call: each BatchNorm after a 3x3 conv normalizes by
    a wrong variance, from the first step on."""
    from semantic_embeddings_torch.models import resnet

    fused = resnet.conv3x3_bn_stats

    def miscounted(x, w, top=None, bottom=None):
        y, s, ss = fused(x, w, top, bottom)
        return y, s, ss * 1.01

    monkeypatch.setattr(resnet, "conv3x3_bn_stats", miscounted)
    correct, numbers = _run(_small())
    limits = _small().limits
    assert not correct
    assert numbers["loss_gap_1"] > 10 * limits["loss_gap_1"] > 10 * sound[1]["loss_gap_1"]


def rank_without_exchange(*args):
    """A rank of a group run whose gradients are not exchanged."""
    from semantic_embeddings_torch import parallel

    parallel.reduce_gradients = lambda grads: grads
    harness.rank_main(*args)


def _group(target=None):
    """The f32 ResNet-50 cell over four ranks, a quarter of the batch each."""
    cell = dataclasses.replace(_small(), chips=4)
    _, correct, rows = harness.run_group(cell, SEED, 0.1, False, time.time(), "cpu", target)
    return cell, correct, {name: value for name, value, _ in rows}


def test_exchange_left_out_fails():
    """Four gloo ranks stand in for the four cards; without the gradients'
    all-reduce each rank steps on its own quarter of the batch."""
    cell, _, sound = _group()
    _, correct, broken = _group(rank_without_exchange)
    limit = cell.limits["grad_gap"]
    assert sound["grad_gap"] <= limit
    assert not correct and broken["grad_gap"] > 10 * limit
