"""A run with its timed path broken underneath comes out not correct.

The card check is skipped: the run goes on the CPU at a tiny size, with
the cell's own limits, and a fault planted where the program produces its
answer (``transcribe.ctc_greedy_decode_torch``, which turns each row's
logits into its tokens): each answer's first token altered, or half the
batch's rows left without their tokens. A training run is broken in its
step: the optimizer leaving the state unchanged, or the loss taken over
half of the batch."""

import copy

import pytest
import torch

from portbench import run

# fp32 at a tiny size: the sound run reads far below the cell's limits, so
# what the test sees is the fault, not the rounding of a smaller model
TINY = dict(d_model=32, ssm_layers=2, global_ssm_layers=1, ssm_state_dim=8,
            global_ssm_state_dim=4, attention_dim=16, dtype="float32")
MIX = dict(batch=4, cycle=6, pool_s=60, sample_calls=2,
           lengths={"mean_s": 1.5, "sigma_log": 0.5, "min_s": 0.5, "max_s": 4.0})


def tiny_spec(workload):
    spec = copy.deepcopy(run.cell(workload))
    spec["config"].update(TINY)
    spec["mix"].update(MIX)
    return spec


def altered(decode):
    """Every answer's first token altered (a row without one gets one)."""
    def fault(logits, *a, **k):
        toks, lens = decode(logits, *a, **k)
        toks = toks.clone()
        first = torch.where(lens > 0, toks[:, 0], torch.full_like(toks[:, 0], 3))
        toks[:, 0] = (first + 7) % logits.shape[-1]
        return toks, torch.maximum(lens, torch.ones_like(lens))
    return fault


def half_dropped(decode):
    def fault(logits, *a, **k):
        toks, lens = decode(logits, *a, **k)
        lens = lens.clone()
        lens[lens.shape[0] // 2:] = 0
        return toks, lens
    return fault


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["base.offline", "moe.offline"])
@pytest.mark.parametrize("fault", [None, altered, half_dropped])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch, one_thread):
    import velocity_asr_tpu_torch.transcribe as transcribe

    spec = tiny_spec(workload)
    if any(v is None for v in spec["limits"].values()):
        pytest.skip("the cell's limits are not set yet")
    if fault is not None:
        monkeypatch.setattr(transcribe, "ctc_greedy_decode_torch",
                            fault(transcribe.ctc_greedy_decode_torch))
    out = run.measure(spec, 2**31 + 99, 1.5, False, device="cpu")
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["checks"]


def stuck_optimizer(monkeypatch):
    from velocity_asr_tpu_torch.training import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, grads: True)


def half_batch(monkeypatch):
    from velocity_asr_tpu_torch.training import Trainer

    monkeypatch.setattr(Trainer, "_row_mean", lambda self, per_row: per_row[: max(1, per_row.shape[0] // 2)].mean())


TRAIN_MIX = dict(batch=4, cycle=4, pool_s=60, target_ids=[1, 49],
                 lengths={"mean_s": 1.5, "sigma_log": 0.35, "min_s": 0.5, "max_s": 3.0})


@pytest.mark.parametrize("fault", [None, stuck_optimizer, half_batch])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch, one_thread):
    spec = copy.deepcopy(run.cell("base.train"))
    if any(v is None for v in spec["limits"].values()):
        pytest.skip("the cell's limits are not set yet")
    spec["config"].update(TINY, vocab_size=50)
    spec["mix"].update(TRAIN_MIX)
    if fault is not None:
        fault(monkeypatch)
    out = run.measure(spec, 2**31 + 98, 1.0, False, device="cpu")
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["checks"]
