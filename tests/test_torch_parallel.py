"""The port's parallelism (velocity_asr_tpu_torch/parallel) against the
JAX package's on the CPU: the JAX side on the 8-device virtual mesh of
tests/conftest.py, the port's in gloo worlds of 2 and 4 processes
(tests/torch_parallel_workers.py, spawned once each for the module):

- ``from_preset`` field for field, and ``pyproject.toml`` listing every
  package of the port;
- ``order_devices_hierarchical`` on the JAX test's stub devices,
  ``create_mesh``'s refusals, ``shard_batch``'s padding and rows;
- the sequence-parallel scan at worlds 2 and 4 (1e-5, L = 61..64 through
  the padded entry), its gradient against ``jax.grad`` (1e-4 of each
  max), the model with ``scan_mode="sp"`` (2e-4), the refusal without a
  context and a streaming chunk keeping the carried kernel path;
- the TP forward at meshes (1, 2) and (2, 2) (2e-5), TP and DP + TP
  Trainer steps, an EP forward (2e-5), EP and DP micro-steps of a MoE
  model with the global aux, and a 3-row DP step (padding, n_valid),
  each against the JAX Trainer on the same weights at
  tests/test_torch_training.py's update tolerances;
- every parameter's gradient on every rank against the one-process
  gradient, dropout and SpecAugment on, for DP (with and without
  padding), TP and EP (1e-5 of each gradient's max);
- TP and EP checkpoints reloaded bit-equal in one process
  (tests/test_torch_parallel_cli.py runs the CLIs under torchrun);
- QAT over the mesh: DP micro-steps at worlds 2 and 4 and a padded 3-row
  one, TP and DP + TP micro-steps, each against the JAX Trainer on the
  same mesh (the observers over the global batch and the whole
  vocabulary: tests/test_torch_quantize.py's stats tolerances, each
  rank's equal to every other's, and each rank's own rows giving stats
  more than 1% away, the control); every rank's gradients and observers
  against one process (1e-5); a TP checkpoint's observers in the
  one-rank layout, reloaded bit-equal in one process and sharded.

The JAX Trainer references run the JAX package's sequential scan (the
same recurrence as its Pallas tier, which the one-process tests of
tests/test_torch_training.py hold; it compiles in two thirds of the
time).
"""

import dataclasses
import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from test_torch_quantize import ACT_STATS_RTOL, JIT_WEIGHT_RTOL, _check_stats
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.parallel import mesh as jmesh
from velocity_asr_tpu.parallel import sequence_parallel as jsequence_parallel
from velocity_asr_tpu.parallel import sp_scan as jsp
from velocity_asr_tpu.parallel import tp as jtp
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import _flatten, params_to_numpy, quant_stats_from_numpy
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops import scan as tscan
from velocity_asr_tpu_torch.parallel import mesh as tmesh
from velocity_asr_tpu_torch.parallel.dryrun import spawn_world
from velocity_asr_tpu_torch.quantize import load_quant_stats, quant_stats_buffers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_EQUAL = 1e-5  # world-N gradients against one process: fp32 summation order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{2: [rank results], 4: [rank results]} of parallel_suite."""
    out = {}
    for world in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        out[world] = spawn_world(world, W.parallel_suite, (tmp,), timeout=240, store_dir=tmp)
        out[world][0]["tmp"] = tmp
    return out


# ----- the two repairs -------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "base", "large-vocab", "moe"])
def test_from_preset_matches_jax(name):
    ours = VelocityASRConfig.from_preset(name, dropout=0.0)
    ref = jconfig.VelocityASRConfig.from_preset(name, dropout=0.0)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_from_preset_unknown_raises_the_jax_error():
    with pytest.raises(ValueError) as ours:
        VelocityASRConfig.from_preset("huge")
    with pytest.raises(ValueError) as ref:
        jconfig.VelocityASRConfig.from_preset("huge")
    assert str(ours.value) == str(ref.value)


def test_pyproject_lists_every_port_package():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    pkg = os.path.join(ROOT, "velocity_asr_tpu_torch")
    found = {os.path.relpath(d, ROOT).replace(os.sep, ".") for d, _, files in os.walk(pkg)
             if "__init__.py" in files}
    assert {"velocity_asr_tpu_torch.compat", "velocity_asr_tpu_torch.parallel"} <= found
    assert found <= listed


# ----- mesh ------------------------------------------------------------------------


class Dev:
    def __init__(self, id, slice_index=None):
        self.id = id
        self.slice_index = slice_index


@pytest.mark.parametrize("devices", [
    [Dev(0, 0), Dev(4, 1), Dev(1, 0), Dev(5, 1), Dev(2, 0), Dev(6, 1), Dev(3, 0), Dev(7, 1)],
    [Dev(3), Dev(1), Dev(2)],
    [Dev(0, 0), Dev(1, 0), Dev(2, 1)],
], ids=["interleaved", "no-slices", "ragged"])
def test_order_devices_hierarchical_matches_jax(devices):
    ours = tmesh.order_devices_hierarchical(devices)
    assert ours is not devices
    assert [d.id for d in ours] == [d.id for d in jmesh.order_devices_hierarchical(devices)]


def test_create_mesh_refusals():
    devs = [Dev(i) for i in range(8)]
    with pytest.raises(ValueError, match="straddle"):
        tmesh.create_mesh(2, 4, devices=devs, slice_index_of=lambda d: d.id // 2)
    with pytest.raises(ValueError, match="needs more than"):
        tmesh.create_mesh(4, 4, devices=devs)
    with pytest.raises(ValueError, match="needs more than"):
        tmesh.create_mesh(2, 1)  # this process's world is one rank
    with pytest.raises(ValueError, match="process group"):
        tmesh.create_mesh(2, 1, devices=[0, 1])  # no group in this process
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None


def test_shard_batch_rows_match_jax_padding():
    """Each data index's rows are the JAX Trainer's shard of the batch
    padded by repeating row 0; n_valid is the unpadded count."""
    batch = W.batch(3, lengths=(48, 40, 30, 20, 10), target_lengths=(8, 6, 5, 4, 3))
    jt = jtraining.Trainer(jmodel.create_model(jconfig.VelocityASRConfig(**W.SMALL)),
                           jtraining.TrainingConfig(num_data_shards=4), iter(()),
                           params=params_to_numpy(W.small_model()),
                           mesh=jmesh.create_mesh(n_data=4))
    placed, n_valid = jt.shard_batch(batch)
    grid = np.array([[0], [1], [2], [3]], dtype=object)
    for i in range(4):
        rows, ours_valid, shard = tmesh.shard_batch(tmesh.Mesh(grid, {}, i), batch)
        assert ours_valid == n_valid == 5 and (shard.lo, shard.hi) == (2 * i, 2 * i + 2)
        for key, value in rows.items():
            ref = np.concatenate([np.asarray(s.data) for s in sorted(
                placed[key].addressable_shards, key=lambda s: s.index[0].start or 0)])
            np.testing.assert_array_equal(value, ref[2 * i:2 * i + 2], err_msg=key)


# ----- sequence parallelism ----------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("length", W.SP_LENGTHS)
def test_sp_scan_matches_jax(worlds, world, length):
    args = [jnp.asarray(a) for a in W.scan_inputs(length, length)]
    mesh = jmesh.create_mesh(n_data=world)
    fn = jsp.selective_scan_sequence_parallel if length % world == 0 else \
        jsp.selective_scan_sp_padded
    ref = np.asarray(jax.jit(lambda *a: fn(*a, mesh=mesh, axis="data"))(*args))
    for r in worlds[world]:
        np.testing.assert_allclose(r[f"sp_{length}"], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_scan_gradient_matches_jax_grad(worlds, world):
    args = [jnp.asarray(a) for a in W.scan_inputs(7, 64)]
    w = jnp.asarray(np.random.default_rng(8).standard_normal((2, 64, 8)).astype(np.float32))
    mesh = jmesh.create_mesh(n_data=world)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jsp.selective_scan_sp_padded(*a, mesh=mesh) * w),
                             argnums=tuple(range(6))))(*args)
    for r in worlds[world]:
        for ours, ref in zip(r["sp_grads"], grads):
            ref = np.asarray(ref)
            assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("world", [2, 4])
def test_model_level_sp_matches_jax(worlds, world):
    params = params_to_numpy(W.small_model(seed=2, vocab_size=37))
    model = jmodel.create_model(jconfig.VelocityASRConfig(**{**W.SMALL, "vocab_size": 37,
                                                           "scan_mode": "sp"}))
    with jsequence_parallel(jmesh.create_mesh(n_data=world)):
        ref = jax.jit(lambda p, m: jmodel.forward(model, p, m))(params, W.mel(2, 2, 120))
    np.testing.assert_allclose(worlds[world][0]["sp_logits"], np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_sp_mode_needs_a_context_and_streaming_keeps_the_kernel_path():
    x, dt, A, B, C, D = (torch.tensor(a) for a in W.scan_inputs(1, 16))
    with pytest.raises(ValueError, match="sequence_parallel"):
        tscan.selective_scan(x, dt, A, B, C, D, mode="sp")
    h0 = torch.tensor(np.random.default_rng(2).standard_normal((2, 8, 4)).astype(np.float32))
    ours = tscan.selective_scan(x, dt, A, B, C, D, mode="sp", h0=h0, return_state=True)
    ref = tscan.selective_scan(x, dt, A, B, C, D, mode="pallas", h0=h0, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))


def test_sp_mode_over_one_rank_takes_the_kernel_path(monkeypatch):
    """An axis of one rank has no seam to exchange: "sp" runs the plain
    path's one scan (bit-equal to "pallas") and never the sharded scan."""
    from velocity_asr_tpu_torch.parallel import sp_scan as tsp

    def sharded(*args):
        raise AssertionError("the sharded scan ran over an axis of one rank")

    monkeypatch.setattr(tsp, "selective_scan_sp_padded", sharded)
    x, dt, A, B, C, D = (torch.tensor(a) for a in W.scan_inputs(3, 16))
    with tsp.sequence_parallel(tmesh.create_mesh()):
        ours = tscan.selective_scan(x, dt, A, B, C, D, mode="sp")
    assert torch.equal(ours, tscan.selective_scan(x, dt, A, B, C, D, mode="pallas"))


# ----- tensor and expert parallelism, data parallelism ---------------------------------------


def test_tp_refuses_a_dim_the_model_axis_does_not_divide():
    """A 30-token head over 4 model ranks raises, as the JAX package's
    sharding does, and leaves every parameter whole."""
    from velocity_asr_tpu_torch.parallel.tp import shard_params_tp

    model = W.small_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grid = np.array([[0, 1, 2, 3]], dtype=object)
    with pytest.raises(ValueError, match="does not split over 4 model ranks"):
        shard_params_tp(model, tmesh.Mesh(grid, {}, 0))
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert model.ctc_head.tp_group is None


def _jax_trainer(params, mesh=None, **kw):
    cfg = jconfig.VelocityASRConfig(**{**W.SMALL, "scan_mode": "sequential",
                                      **kw.pop("model", {})})
    return jtraining.Trainer(jmodel.create_model(cfg),
                             jtraining.TrainingConfig(**W.TRAIN, **kw), iter(()),
                             params=params, mesh=mesh)


def _one_process_grads(model, b, **train):
    """The port's one-process gradient of `b` as Adam sees it (clipped by
    the global norm), as the flax tree."""
    trainer = ttraining.Trainer(model, ttraining.TrainingConfig(**W.TRAIN, **train), iter(()))
    model.train()
    _, grads = trainer.gradients(b)
    norm = trainer.optimizer.global_norm(grads).item()
    scale = min(1.0, W.TRAIN["grad_clip_norm"] / norm)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g * scale)
    return dict(_flatten(params_to_numpy(model)))


def _assert_update_close(start, ours, ref, grads, lr=1e-3 * 0.5):
    """tests/test_torch_training.py's rule after one update: weights
    whose gradient exceeds 1e-5 within 1e-6, every weight within 2 lr
    (lr: the first update's, warmup 1 of 2). The gradient is the one Adam
    takes, after the clip: its size against Adam's eps (1e-8) is what
    decides how far round-off moves the step."""
    start, ours, ref = (dict(_flatten(t)) for t in (start, ours, ref))
    covered = total = 0
    for key, r in ref.items():
        assert np.abs(ours[key] - r).max() <= 2 * lr, key
        big = np.abs(grads[key]) > 1e-5
        np.testing.assert_allclose(ours[key][big], r[big], rtol=0, atol=1e-6, err_msg=key)
        covered += big.sum()
        total += big.size
    assert covered > 0.75 * total


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax_sharded(worlds, world):
    params = params_to_numpy(W.small_model(seed=3, ssm_layers=1, vocab_size=256))
    model = jmodel.create_model(jconfig.VelocityASRConfig(**{**W.SMALL, "ssm_layers": 1,
                                                           "vocab_size": 256}))
    sharded = jtp.shard_params_tp(params, jmesh.create_mesh(n_data=world // 2, n_model=2))
    ref = jax.jit(lambda p, m: jmodel.forward(model, p, m))(sharded, W.mel(0, 2, 64))
    for r in worlds[world]:
        assert r["tp_head_rows"] == 128
        np.testing.assert_allclose(r["tp_logits"], np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", [2, 4], ids=["tp", "dp-tp"])
def test_tp_trainer_step_matches_jax(worlds, world):
    start = params_to_numpy(W.small_model(seed=4, vocab_size=64))
    b = W.batch(5, vocab=64, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5))
    jt = _jax_trainer(start, jmesh.create_mesh(n_data=world // 2, n_model=2),
                      model={"vocab_size": 64})
    ref = jt.train_step(b)
    r = worlds[world][0]
    np.testing.assert_allclose(r["tp_step"]["loss"], ref["loss"], rtol=1e-5)
    _assert_update_close(start, r["tp_params"], jax.device_get(jt.params),
                         _one_process_grads(W.small_model(seed=4, vocab_size=64), b))


@pytest.mark.parametrize("world", [2, 4])
def test_ep_forward_matches_jax(worlds, world):
    moe = {"moe_experts": 4, "moe_top_k": 2}
    params = params_to_numpy(W.small_model(seed=6, **moe))
    model = jmodel.create_model(jconfig.VelocityASRConfig(**{**W.SMALL, **moe}))
    sharded = jtp.shard_params_tp(params, jmesh.create_mesh(n_data=world // 2, n_model=2))
    ref = jax.jit(lambda p, m: jmodel.forward(model, p, m))(sharded, W.mel(6, 2, 64))
    for r in worlds[world]:
        assert r["ep_experts"] == 2
        np.testing.assert_allclose(r["ep_logits"], np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_moe_step():
    """(start, JAX step, JAX params after it, the port's clipped one-process
    gradient) of the MoE micro-step, JAX with num_model_shards=2."""
    moe = {"moe_experts": 4, "moe_top_k": 2}
    start = params_to_numpy(W.small_model(seed=6, **moe))
    b = W.batch(7, lengths=(48, 40, 44, 36), target_lengths=(8, 6, 7, 5))
    jt = _jax_trainer(start, model=moe, moe_aux_weight=0.5, num_model_shards=2)
    ref = jt.train_step(b)
    return start, ref, jax.device_get(jt.params), _one_process_grads(
        W.small_model(seed=6, **moe), b, moe_aux_weight=0.5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["ep", "dp_moe"])
def test_moe_micro_step_with_global_aux_matches_jax(worlds, jax_moe_step, world, kind):
    start, ref, ref_params, grads = jax_moe_step
    r = worlds[world][0]
    np.testing.assert_allclose(r[f"{kind}_step"]["loss"], ref["loss"], rtol=1e-5)
    _assert_update_close(start, r[f"{kind}_params"], ref_params, grads)


@pytest.fixture(scope="module")
def jax_padded_step():
    start = params_to_numpy(W.small_model(seed=8))
    three = W.batch(9, lengths=(48, 40, 30), target_lengths=(8, 6, 5))
    jt = _jax_trainer(start)  # all 8 devices: 3 rows padded to 8
    ref = jt.train_step(three)
    return start, ref, jax.device_get(jt.params), _one_process_grads(W.small_model(seed=8),
                                                                     three)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_with_padding_matches_jax(worlds, jax_padded_step, world):
    start, ref, ref_params, grads = jax_padded_step
    r = worlds[world][0]
    np.testing.assert_allclose(r["dp3_step"]["loss"], ref["loss"], rtol=1e-5)
    _assert_update_close(start, r["dp3_params"], ref_params, grads)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("axis", ["grad_dp", "grad_dp_pad", "grad_tp", "grad_ep",
                                  "grad_qat_dp", "grad_qat_dp_pad", "grad_qat_tp"])
def test_every_rank_gets_the_one_process_gradient(worlds, world, axis):
    """Dropout 0.1 and SpecAugment on: the world's draws are the one
    process's, so the loss and every parameter's gradient on every rank
    equal the one-process ones up to the order of fp32 sums; with QAT the
    observers too (their ranges over the global batch)."""
    keys = ("loss_rel", "grad_rel", "zero_grad_rel", "norm_rel")
    if "qat" in axis:
        keys += ("stats_rel",)
    for r in worlds[world]:
        gaps = r[axis]
        assert all(gaps[k] <= GRAD_EQUAL for k in keys), (r["rank"], gaps)


@pytest.mark.parametrize("kind,model", [("tp", {"vocab_size": 64}),
                                        ("ep", {"moe_experts": 4, "moe_top_k": 2})])
def test_sharded_checkpoint_reloads_bit_equal_in_one_process(worlds, kind, model):
    r = worlds[4][0]
    trainer = ttraining.Trainer(W.small_model(seed=0, **model),
                                ttraining.TrainingConfig(**W.TRAIN), iter(()))
    trainer.load_checkpoint(os.path.join(r["tmp"], f"{kind}_ckpt"))
    state = trainer.model.state_dict()
    assert state.keys() == r[f"{kind}_saved"].keys()
    for key, value in r[f"{kind}_saved"].items():
        assert torch.equal(state[key], torch.tensor(value)), key
    assert trainer.global_step == 1 and trainer.optimizer.count == 1
    for mu, p in zip(trainer.optimizer.mu, trainer.model.parameters()):
        assert mu.shape == p.shape


# ----- QAT over the mesh ---------------------------------------------------------------


QAT_MESHES = {"dp2": dict(n_data=2), "dp4": dict(n_data=4), "tp4": dict(n_data=2, n_model=2)}


def _jax_first_steps(jt, batches):
    """The JAX Trainer's first micro-step on each batch, each from the
    Trainer's start (one compile: the batches pad to one shape): [(step,
    params, quant_stats)]."""
    start = jax.device_get((jt.params, jt.opt_state, jt.quant_stats))
    out = []
    for b in batches:
        jt.params, jt.opt_state, jt.quant_stats = start
        jt.global_step = 0
        jt._replicate()
        ref = jt.train_step(b)
        out.append((ref, jax.device_get(jt.params), jax.device_get(jt.quant_stats)))
    return out


@pytest.fixture(scope="module")
def jax_qat():
    """steps(mesh) -> the JAX Trainer's QAT micro-steps on that mesh of
    QAT_MESHES from W.qat_model's weights, computed once: the 4-row batch,
    and on "dp2" the 3-row one too (padded to 4)."""
    cache = {}

    def steps(name):
        if name not in cache:
            mesh = jmesh.create_mesh(**QAT_MESHES[name])
            jt = _jax_trainer(params_to_numpy(W.qat_model()), mesh,
                              model={"vocab_size": 64, "qat": True})
            batches = [W.qat_batch()] + [W.qat_three()] * (name == "dp2")
            cache[name] = _jax_first_steps(jt, batches)
        return cache[name]

    return steps


@pytest.fixture(scope="module")
def qat_grads():
    """The port's clipped one-process gradients of W.qat_model on the
    4-row and the 3-row batch (what decides the update's tolerance)."""
    return {rows: _one_process_grads(W.qat_model(), b)
            for rows, b in ((4, W.qat_batch()), (3, W.qat_three()))}


def _stats_model(tree):
    """A QAT model holding a flax quant_stats tree."""
    model = W.qat_model()
    load_quant_stats(model, quant_stats_from_numpy(tree))
    return model


def _activation_gap(tree, jstats) -> float:
    """The largest relative gap of an activation observer's scale or zero
    point between a port stats tree and the JAX one."""
    ref = dict(_flatten(jax.device_get(jstats)))
    return max(float(np.abs(value - ref[key]).max() / np.abs(ref[key]).max())
               for key, value in _flatten(tree)
               if "activation_quantizer" in key and key[-1] in ("scale", "zero_point"))


def _check_qat_step(ranks, prefix, ref, ref_params, ref_stats, grads):
    """Every rank's loss, update and observers against the JAX step, and
    every rank's observers bit-equal to rank 0's."""
    start = params_to_numpy(W.qat_model())
    first = dict(_flatten(ranks[0][f"{prefix}_stats"]))
    for r in ranks:
        np.testing.assert_allclose(r[f"{prefix}_step"]["loss"], ref["loss"], rtol=1e-5)
        _check_stats(ref_stats, _stats_model(r[f"{prefix}_stats"]), ACT_STATS_RTOL,
                     JIT_WEIGHT_RTOL)
        for key, value in _flatten(r[f"{prefix}_stats"]):
            np.testing.assert_array_equal(value, first[key], err_msg=f"rank {r['rank']}: {key}")
        _assert_update_close(start, r[f"{prefix}_params"], ref_params, grads)


@pytest.mark.parametrize("world", [2, 4])
def test_qat_dp_step_matches_jax(worlds, jax_qat, qat_grads, world):
    """QAT over a data axis of every rank: each rank's observers are the
    JAX Trainer's over the global batch (same n_data, same weights), the
    same on every rank, and the loss and update JAX's. The control: each
    rank's own rows alone give activation stats more than 1% away."""
    (ref, ref_params, ref_stats), = jax_qat(f"dp{world}")[:1]
    _check_qat_step(worlds[world], "qat_dp", ref, ref_params, ref_stats, qat_grads[4])
    for r in worlds[world]:
        assert _activation_gap(r["qat_dp_own_rows"], ref_stats) > 0.01, r["rank"]


@pytest.mark.parametrize("world", [2, 4])
def test_qat_dp_step_with_padding_matches_jax(worlds, jax_qat, qat_grads, world):
    """3 rows over the data axis, padded by repeating row 0 as the JAX
    Trainer pads: the observers see row 0 twice, as JAX's do."""
    ref, ref_params, ref_stats = jax_qat("dp2")[1]
    _check_qat_step(worlds[world], "qat_dp3", ref, ref_params, ref_stats, qat_grads[3])


@pytest.mark.parametrize("world", [2, 4], ids=["tp", "dp-tp"])
def test_qat_tp_step_matches_jax(worlds, jax_qat, qat_grads, world):
    """QAT with the head sharded over 2 model ranks: each rank keeps its
    32 channels of the head's weight observer, its output observer spans
    the whole vocabulary and the global batch (JAX's on the (2 data, 2
    model) mesh, which computes the one global batch the port's (1, 2)
    and (2, 2) meshes do: one compile serves both)."""
    (ref, ref_params, ref_stats), = jax_qat("tp4")[:1]
    assert all(r["qat_tp_local_stats"] == (1, 32) for r in worlds[world])
    _check_qat_step(worlds[world], "qat_tp", ref, ref_params, ref_stats, qat_grads[4])


def test_qat_tp_checkpoint_reloads_bit_equal_in_one_process(worlds):
    """The TP QAT checkpoint keeps the one-rank layout, observers too: one
    process reloads parameters and stats bit-equal, and a sharded Trainer
    reloads the same stats."""
    r = worlds[4][0]
    trainer = ttraining.Trainer(W.qat_model(seed=0), ttraining.TrainingConfig(**W.TRAIN),
                                iter(()))
    trainer.load_checkpoint(os.path.join(r["tmp"], "tp_qat_ckpt"))
    state = trainer.model.state_dict()
    assert state.keys() == r["qat_tp_saved"].keys()
    for key, value in r["qat_tp_saved"].items():
        assert torch.equal(state[key], torch.tensor(value)), key
    stats = quant_stats_buffers(trainer.model)
    assert stats.keys() == r["qat_tp_saved_stats"].keys()
    for key, value in r["qat_tp_saved_stats"].items():
        assert torch.equal(stats[key], torch.tensor(value)), key
        for rank in worlds[4]:
            np.testing.assert_array_equal(rank["qat_tp_reloaded_stats"][key], value,
                                          err_msg=f"rank {rank['rank']}: {key}")
    assert stats["ctc_head.proj.weight_quantizer.scale"].shape == (1, 64)


@pytest.mark.parametrize("rows,n_data", [(4, 2), (3, 2), (5, 4)], ids=["even", "padded", "dp4"])
def test_ranks_rounding_rounds_as_each_rank(rows, n_data):
    """The four-card QAT leg's witness: one rank's forward under
    ``dryrun.ranks_rounding`` gives each data rank's rows bit for bit as a
    forward of those rows alone does (padded by row 0 as ``shard_batch``
    pads; the CPU's vector loops round by layout, which the joined
    results keep)."""
    from types import SimpleNamespace

    from velocity_asr_tpu_torch.parallel.dryrun import witness_bit_equal

    trainer = SimpleNamespace(config=ttraining.TrainingConfig(**W.TRAIN),
                              mesh=SimpleNamespace(shape={"data": n_data, "model": 1}),
                              model=SimpleNamespace(ctc_head=SimpleNamespace(tp_group=None)))
    batch = {"mel_spectrogram": np.random.default_rng(rows).standard_normal(
        (rows, 48, 80)).astype(np.float32)}
    with torch.no_grad():
        assert witness_bit_equal(trainer, W.small_model(seed=0, dropout=0.0), batch)
