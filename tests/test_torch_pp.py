"""The port's pipeline parallelism (velocity_asr_tpu_torch/parallel/pp.py)
against the JAX package's on the CPU: the port's stages in a gloo world
of 4 processes (tests/torch_parallel_workers.py, spawned once for the
module), the JAX side on tests/conftest.py's virtual mesh:

- the stack's forward at tests/test_pp.py's (stages, microbatches) grid
  against the JAX stack's (1e-5), its gradients with and without
  checkpointed blocks (1e-4 of the largest gradient), the whole model
  (2e-5), and a Trainer step with two stages against the JAX Trainer at
  tests/test_torch_training.py's update tolerances;
- every parameter's gradient on every rank against the one-process
  gradient at 4 stages and at 2 stages x 2 data shards (1e-5), also of
  a QAT model, its observers within 1e-5 too;
- dropout 0.1 trains, streaming ignores the context, the errors (a stage
  count that does not divide the stack, scan_mode "sp", MoE, mismatched
  tensor and pipeline axes) and ``_resolve_microbatches``'s table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.models.ssm import LocalSSMProcessor as JStack
from velocity_asr_tpu.parallel.pp import _resolve_microbatches as jresolve
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import _flatten, params_to_numpy
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.models.model import create_model
from velocity_asr_tpu_torch.parallel import mesh as tmesh
from velocity_asr_tpu_torch.parallel.dryrun import spawn_world
from velocity_asr_tpu_torch.parallel.pp import _resolve_microbatches, pipeline_parallel

GRAD_EQUAL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pp"))
    return spawn_world(4, W.pp_suite, timeout=240, store_dir=tmp)


def _jax_stack(**kw):
    """The JAX stack with the port stack's weights (seed 0) and its input."""
    mod = JStack(d_model=16, num_layers=4, state_dim=8, dropout=0.0, **kw)
    return mod, {"params": params_to_numpy(W.stack())}, jnp.asarray(W.stack_input())


@pytest.mark.parametrize("stages,microbatches", W.PP_GRID)
def test_pipeline_forward_matches_jax(world, stages, microbatches):
    mod, variables, x = _jax_stack()
    ref = np.asarray(mod.apply(variables, x))
    for r in world:
        np.testing.assert_allclose(r[f"fwd_{stages}_{microbatches}"], ref, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_gradients_match_jax(world, remat):
    mod, variables, x = _jax_stack(use_checkpoint=remat)
    ref = np.asarray(mod.apply(variables, x))
    grads = jax.grad(lambda p: jnp.sum(mod.apply({"params": p}, x) ** 2))(variables["params"])
    names = [n for n, _ in W.stack().named_parameters()]
    ref_grads = dict(zip(names, _port_order(grads)))
    top = max(np.abs(g).max() for g in ref_grads.values())
    for r in world:
        np.testing.assert_allclose(r[f"remat_fwd_{remat}"], ref, rtol=1e-5, atol=1e-5)
        for name, g in r[f"grads_{remat}"].items():
            assert np.abs(g - ref_grads[name]).max() <= 1e-4 * top, name


def _port_order(flax_grads):
    """A flax gradient tree as arrays in the port stack's parameter order
    (each laid out as the port's parameter)."""
    from velocity_asr_tpu_torch.checkpoint import params_from_numpy

    state = params_from_numpy(jax.device_get(flax_grads))
    return [state[n].numpy() for n, _ in W.stack().named_parameters()]


def test_full_model_under_pipeline_matches_jax(world):
    params = params_to_numpy(W.pp_model())
    model = jmodel.create_model(jconfig.VelocityASRConfig(**{**W.PP_TINY,
                                                           "scan_mode": "sequential"}))
    ref = np.asarray(jmodel.forward(model, params, W.mel(1, 4, 64)))
    for r in world:
        np.testing.assert_allclose(r["model_logits"], ref, rtol=2e-5, atol=2e-5)


def test_trainer_pipeline_step_matches_jax(world):
    start = params_to_numpy(W.pp_model())
    b = W.batch(2, frames=32, lengths=(32, 30, 28, 32), target_lengths=(6, 6, 5, 6), vocab=64)
    # the JAX sequential scan: tests/test_torch_parallel.py's note
    jt = jtraining.Trainer(jmodel.create_model(jconfig.VelocityASRConfig(
        **{**W.PP_TINY, "scan_mode": "sequential"})), jtraining.TrainingConfig(**W.TRAIN),
        iter(()), params=start)
    ref = jt.train_step(b)
    r = world[0]
    np.testing.assert_allclose(r["trainer_loss"], ref["loss"], rtol=1e-5)
    model = W.pp_model()
    trainer = ttraining.Trainer(model, ttraining.TrainingConfig(**W.TRAIN), iter(()))
    model.train()
    _, grads = trainer.gradients(b)
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    grads = dict(_flatten(params_to_numpy(model)))
    ours, jax_after = dict(_flatten(r["trainer_params"])), dict(_flatten(jax.device_get(
        jt.params)))
    covered = total = 0
    for key, want in jax_after.items():
        assert np.abs(ours[key] - want).max() <= 2 * 5e-4, key
        big = np.abs(grads[key]) > 1e-5
        np.testing.assert_allclose(ours[key][big], want[big], rtol=0, atol=1e-6, err_msg=key)
        covered += big.sum()
        total += big.size
    assert covered > 0.75 * total and len(names) == len(list(model.parameters()))


@pytest.mark.parametrize("axis", ["grad_pp4", "grad_pp2_dp2", "grad_qat_pp4",
                                  "grad_qat_pp2_dp2"])
def test_every_rank_gets_the_one_process_gradient(world, axis):
    """With QAT the observers too: they run outside the pipelined stack,
    on every stage, over the data axis's global batch."""
    keys = ("loss_rel", "grad_rel", "zero_grad_rel", "norm_rel")
    if "qat" in axis:
        keys += ("stats_rel",)
    for r in world:
        gaps = r[axis]
        assert all(gaps[k] <= GRAD_EQUAL for k in keys), (r["rank"], gaps)


def test_pipeline_with_dropout_trains(world):
    assert all(np.isfinite(r["dropout_loss"]) for r in world)


def test_streaming_ignores_pipeline_context(world):
    mod = W.stack()
    x = torch.tensor(W.stack_input())[:2]
    with torch.no_grad():
        ref, ref_states = mod(x, return_state=True)
    for r in world:
        y, states = r["stream"]
        np.testing.assert_array_equal(y, ref.numpy())
        for got, want in zip(states, ref_states):
            for key in want:
                np.testing.assert_array_equal(got[key], want[key].numpy())


def test_pipeline_errors():
    """In one process: the refusals come before any collective."""
    grid = np.array([[0, 1]], dtype=object)
    mesh = tmesh.Mesh(grid, {("model", 0): object(), ("data", 0): None}, 0)
    x = torch.tensor(W.stack_input())
    with pipeline_parallel(mesh), pytest.raises(ValueError, match="divide"):
        W.stack(num_layers=3)(x)
    with pipeline_parallel(mesh), pytest.raises(ValueError, match="sp"):
        W.stack(scan_mode="sp")(x)
    with pipeline_parallel(mesh), pytest.raises(ValueError, match="MoE"):
        W.stack(moe_experts=2)(x)
    model = create_model(VelocityASRConfig(**W.PP_TINY), device="cpu")
    with pytest.raises(ValueError, match="model axis|equal"):
        ttraining.Trainer(model, ttraining.TrainingConfig(num_model_shards=4,
                                                          num_pipeline_stages=2), iter(()))


@pytest.mark.parametrize("batch,stages,requested", [
    (8, 2, None), (8, 2, 8), (6, 4, None), (1, 4, None), (7, 4, None), (12, 4, 5), (9, 2, 4)])
def test_resolve_microbatches_matches_jax(batch, stages, requested):
    assert _resolve_microbatches(batch, stages, requested) == jresolve(batch, stages, requested)


def test_resolve_microbatches_table():
    assert _resolve_microbatches(batch=8, stages=2, requested=None) == 2
    assert _resolve_microbatches(batch=8, stages=2, requested=8) == 8
    assert _resolve_microbatches(batch=6, stages=4, requested=None) == 3
    assert _resolve_microbatches(batch=1, stages=4, requested=None) == 1
    assert _resolve_microbatches(batch=7, stages=4, requested=None) == 1
