"""The port's mixture-of-experts (models/moe.py) against the JAX package's.

The same numpy inputs and weights go through both packages; JAX runs
its own MoEFFN and, for the whole model, its sequential oracle scan (the
port the kernel path's plain versions):

- ``MoEFFN`` alone, fp32: outputs atol 1e-5, the aux and ``f_frac``
  atol 1e-6, for top-1, top-2 and k = E, T not a multiple of the group
  (fold padding), several groups, capacity factor 0.5 (drops: the rows
  every choice dropped are exactly 0 in both), and bf16 at 2e-2; its
  input and parameter gradients (router included) within 1e-5 of each
  one's max|grad|;
- the cases of ``tests/test_moe.py`` that apply to one device: k = E
  with ample capacity is the dense mixture, top-1 takes the argmax
  expert, a dropped token passes through its block's residual, one aux
  per MoE layer with the uniform router's floor of 1, upcycling keeps
  the dense forward, int8 leaves the experts float;
- an MoE model: offline with ``feature_lengths`` and a 3-chunk stream
  with its state at atol 1e-4, ``streaming_forward(collect_losses=True)``
  (logits 1e-4, aux 1e-6); a row's routing does not depend on the rows
  batched with it, and a session's chunk step beside an idle slot keeps
  its routes exactly, its logits and state within 1e-5 (fp32 matmuls
  block otherwise at another batch size);
- one fp32 micro-step, dropout off: the loss (rtol 1e-4) and every
  gradient, the routers' included (within 1e-4 of each gradient's
  max|grad|), against ``jax.grad`` of the JAX Trainer's loss, for CTC +
  aux and for the streaming-aware term with its aux; a checkpointed MoE
  micro-step (dropout 0.1, aux on) bit-equal to the plain one;
- the JAX tiling of ``upcycle_dense_to_moe`` bit-equal, and the Trainer's
  refusals.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.models import moe as jmoe
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import _flatten, params_from_numpy, params_to_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models import moe as tmoe
from velocity_asr_tpu_torch.models import ssm as tssm
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.quantize import DynamicInt8Dense

CHUNK = 64  # streaming chunk (mel frames) of the small models
SMALL = dict(d_model=16, ssm_layers=2, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=30,
             dropout=0.0, dtype="float32", stream_summary_tokens=8, stream_memory_chunks=2,
             moe_experts=4, moe_top_k=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(tree))


# ----- MoEFFN ----------------------------------------------------------------------


def _ffn_pair(d=16, hidden=32, experts=4, top_k=2, capacity=1.25, group=128,
              dtype="float32", seed=0):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = jmoe.MoEFFN(d_model=d, hidden=hidden, num_experts=experts, top_k=top_k,
                     capacity_factor=capacity, dropout=0.0, dtype=jdt, group_size=group)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, d)))["params"]
    params = _perturb(params, seed)
    # a sharper router than the init's, so the choices are far from ties
    params["router"]["kernel"] = (np.random.default_rng(seed + 1)
                                  .standard_normal((d, experts)).astype(np.float32))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = tmoe.MoEFFN(d, hidden, experts, top_k, capacity, 0.0, tdt, group)
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port, jdt, tdt


def _jax_ffn(jm, params, x):
    y, state = jm.apply({"params": params}, x, mutable=["losses", "router_stats"])
    (aux,), (f_frac,) = state["losses"]["moe_aux"], state["router_stats"]["f_frac"]
    return np.asarray(y.astype(jnp.float32)), float(aux), np.asarray(f_frac)


@pytest.mark.parametrize("case", [
    dict(id="top2", t=100),
    dict(id="top1", t=100, top_k=1),
    dict(id="top_all", t=100, top_k=4),
    dict(id="fold_padding", t=40, group=16),
    dict(id="several_groups", t=300, batch=3),
    dict(id="drops", t=300, capacity=0.5),
    dict(id="bf16", t=300, dtype="bfloat16"),
], ids=lambda c: c["id"])
def test_moe_ffn_matches_jax(case):
    kw = {k: case[k] for k in ("top_k", "capacity", "group", "dtype") if k in case}
    jm, params, port, jdt, tdt = _ffn_pair(**kw)
    x = np.random.default_rng(7).standard_normal((case.get("batch", 2), case["t"], 16))
    x = x.astype(np.float32)
    ref, ref_aux, ref_f = _jax_ffn(jm, params, jnp.asarray(x).astype(jdt))
    collect = []
    with torch.no_grad():
        out = port(torch.tensor(x).to(tdt), collect=collect)
    assert out.dtype == tdt and out.shape == x.shape
    (aux, f_frac), = collect
    tol = 2e-2 if case.get("dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)
    assert abs(float(aux) - ref_aux) <= 1e-6
    np.testing.assert_allclose(f_frac.numpy(), ref_f, rtol=0, atol=1e-6)
    dropped = np.abs(ref).sum(-1) == 0
    if case["id"] == "drops":
        assert dropped.sum() > 0  # capacity 0.5 drops tokens outright
    np.testing.assert_array_equal(out.float().abs().sum(-1).numpy() == 0, dropped)


def test_moe_ffn_gradients_match_jax():
    """d(sum(w * y) + aux)/d(x, params), fold padding and drops included."""
    jm, params, port, _, _ = _ffn_pair(capacity=0.75, group=32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 70, 16)).astype(np.float32)
    w = rng.standard_normal((2, 70, 16)).astype(np.float32)

    def jloss(p, xx):
        y, st = jm.apply({"params": p}, xx, mutable=["losses"])
        return jnp.sum(jnp.asarray(w) * y) + st["losses"]["moe_aux"][0]

    ref_gp, ref_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    collect = []
    y = port(xt, collect=collect)
    grads = torch.autograd.grad((torch.tensor(w) * y).sum() + collect[0][0],
                                [xt] + list(port.parameters()))
    ours = {"x": grads[0].numpy()}
    clone = copy.deepcopy(port)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads[1:]):
            p.copy_(g)
    ours.update(dict(_flatten(params_to_numpy(clone))))
    theirs = {"x": np.asarray(ref_gx), **dict(_flatten(jax.device_get(ref_gp)))}
    assert set(ours) == set(theirs)
    for key, ref_g in theirs.items():
        assert np.abs(ours[key] - ref_g).max() <= 1e-5 * np.abs(ref_g).max(), key


def test_all_experts_with_ample_capacity_is_the_dense_mixture():
    """k = E and capacity >= S: every token gets sum_e gate_e * FFN_e(x)."""
    _, _, port, _, _ = _ffn_pair(top_k=4, capacity=2.0)
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 50, 16)), dtype=torch.float32)
    with torch.no_grad():
        y = port(x)
        gates = torch.softmax(x @ port.router.weight.T, dim=-1)
        h = torch.nn.functional.gelu(torch.einsum("btd,edh->bteh", x, port.w_in) + port.b_in)
        experts = torch.einsum("bteh,ehd->bted", h, port.w_out) + port.b_out
        dense = (gates[..., None] * experts).sum(2)
    torch.testing.assert_close(y, dense, rtol=0, atol=1e-5)


def test_top1_routes_each_token_to_its_argmax_expert():
    _, _, port, _, _ = _ffn_pair(top_k=1, capacity=4.0)
    x = torch.tensor(np.random.default_rng(4).standard_normal((1, 30, 16)), dtype=torch.float32)
    with torch.no_grad():
        y = port(x)
        best = (x @ port.router.weight.T).argmax(-1)[0]
        for t in range(30):
            e = int(best[t])
            h = torch.nn.functional.gelu(x[0, t] @ port.w_in[e] + port.b_in[e])
            torch.testing.assert_close(y[0, t], h @ port.w_out[e] + port.b_out[e],
                                       rtol=0, atol=1e-5)


def test_dropped_token_passes_through_the_residual():
    """In an MoE block a token every choice dropped adds 0: with the SSM
    branch zeroed, the block's output row equals its input."""
    block = tssm.SSMBlock(16, 4, 2, 4, "pallas", moe_experts=4, moe_top_k=1,
                          moe_capacity_factor=0.25)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        block.ssm.out_proj.weight.zero_()
        x = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(1))
        ffn = block.moe(block.norm2(x))
        out = block(x)
    dropped = ffn.abs().sum(-1)[0] == 0
    assert dropped.sum() > 0
    torch.testing.assert_close(out[0, dropped], x[0, dropped], rtol=0, atol=0)


def test_one_aux_per_moe_layer_and_the_uniform_router_floor():
    model = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu")
    with torch.no_grad():
        for block in model.local_ssm.layers:
            block.moe.router.weight.zero_()  # uniform gates: aux = E * (1 * 1/E) = 1
    collect = []
    with torch.no_grad():
        model(torch.randn(2, 60, 80), collect=collect)
    assert len(collect) == SMALL["ssm_layers"]
    for aux, f_frac in collect:
        assert float(aux) == pytest.approx(1.0, abs=1e-6)
        assert f_frac.tolist() == [1.0, 0.0, 0.0, 0.0]  # first-index argmax


def test_rows_route_independently():
    """A row's tokens are grouped and routed within the row: its output is
    the same alone as beside any other row (so an idle slot of a shared
    streaming step cannot move a session's experts)."""
    _, _, port, _, _ = _ffn_pair(capacity=0.5)
    x = torch.tensor(np.random.default_rng(5).standard_normal((3, 100, 16)), dtype=torch.float32)
    with torch.no_grad():
        together = port(x)
        idle = port(torch.cat([x[:1], torch.zeros(2, 100, 16)]))
        for b in range(3):
            torch.testing.assert_close(port(x[b:b + 1])[0], together[b], rtol=0, atol=0)
    torch.testing.assert_close(idle[0], together[0], rtol=0, atol=0)


def test_idle_slot_of_a_shared_stream_step_keeps_a_sessions_routing(moe_pair, monkeypatch):
    """A session's chunk step beside an idle (zero) slot, as the shared
    streaming step runs it, routes its tokens to the experts it reaches
    alone, and gives its logits and state."""
    _, _, port = moe_pair
    routes = []
    route = tmoe.MoEFFN.route
    monkeypatch.setattr(tmoe.MoEFFN, "route",
                        lambda self, xg, valid: routes.append(route(self, xg, valid)) or routes[-1])
    chunk = torch.randn(1, CHUNK, 80, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        alone, st_alone = port(chunk, time_offset=0, return_state=True)
        alone_routes, routes[:] = list(routes), []
        shared, st_shared = port(torch.cat([chunk, torch.zeros_like(chunk)]),
                                 time_offset=torch.tensor([0, 0]), return_state=True)
    assert len(routes) == len(alone_routes) == SMALL["ssm_layers"]
    for a, b in zip(alone_routes, routes):
        for key in ("idx", "pos", "keep"):
            assert torch.equal(a[key][:, :1], b[key][:, :1]), key
    # the rest within fp32 noise: the matmuls block otherwise at batch 2
    torch.testing.assert_close(shared[:1], alone, rtol=0, atol=1e-5)
    for a, b in zip(st_alone["blocks"], st_shared["blocks"]):
        torch.testing.assert_close(b["ssm"][:1], a["ssm"], rtol=0, atol=1e-5)


def test_upcycle_tiles_as_jax_and_keeps_the_dense_forward():
    dense_cfg = {k: v for k, v in SMALL.items() if not k.startswith("moe")}
    dense = tmodel.create_model(VelocityASRConfig(**dense_cfg), device="cpu",
                                generator=torch.Generator().manual_seed(2))
    tree = params_to_numpy(dense)
    ours = tmoe.upcycle_dense_to_moe(tree, 4, torch.Generator().manual_seed(0))
    theirs = jax.device_get(jmoe.upcycle_dense_to_moe(tree, 4, jax.random.PRNGKey(0)))
    flat_ours, flat_theirs = dict(_flatten(ours)), dict(_flatten(theirs))
    assert set(flat_ours) == set(flat_theirs)
    for key, value in flat_theirs.items():
        if "router" in key:  # drawn from each package's own generator
            assert flat_ours[key].shape == value.shape and np.abs(flat_ours[key]).max() < 0.1
        else:
            np.testing.assert_array_equal(flat_ours[key], value, err_msg=str(key))
    assert tmoe.upcycle_dense_to_moe(ours, 4) == ours  # an MoE tree stays as it is
    moe = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu")
    moe.load_state_dict(params_from_numpy(ours), strict=True)
    mel = torch.randn(2, 120, 80, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(moe(mel), dense(mel), rtol=0, atol=1e-5)


def test_int8_leaves_the_experts_float():
    model = tmodel.create_model(VelocityASRConfig(**SMALL, int8_inference=True), device="cpu")
    assert sum(isinstance(m, DynamicInt8Dense) for m in model.modules()) == 7 + 3 + 1
    assert not any(isinstance(m, DynamicInt8Dense) for m in model.local_ssm.modules())


def test_expert_init_follows_flax_fans():
    """flax's xavier fans of an (E, d, h) kernel count E as receptive
    field: the port's draws stay within that bound and fill it."""
    moe = tmodel.init_parameters(tmoe.MoEFFN(64, 128, 4), torch.Generator().manual_seed(0))
    jp = jax.device_get(jmoe.MoEFFN(d_model=64, hidden=128, num_experts=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)))["params"])
    for name in ("w_in", "w_out"):
        ours = getattr(moe, name).detach().numpy()
        theirs = np.asarray(jp[name])
        bound = tmoe.expert_init_bound(*ours.shape)
        assert np.abs(ours).max() <= bound and np.abs(theirs).max() <= bound
        assert np.abs(ours).max() > 0.97 * bound and np.abs(theirs).max() > 0.97 * bound
        assert ours.std() == pytest.approx(theirs.std(), rel=0.05)
    assert not moe.b_in.detach().any() and not moe.b_out.detach().any()


# ----- the model -------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_pair():
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, CHUNK, 80)))["params"]
    params = _perturb(params, 4)
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **SMALL), device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port


def test_moe_model_offline_matches_jax(moe_pair):
    jm, params, port = moe_pair
    mel = np.random.default_rng(1).standard_normal((2, 300, 80)).astype(np.float32)
    ref, ref_feats = jmodel.forward(jm, params, jnp.asarray(mel), return_features=True)
    logits, feats = tmodel.forward(port, torch.from_numpy(mel), return_features=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert set(feats) == set(ref_feats)
    np.testing.assert_allclose(feats["local_features"].numpy(),
                               np.asarray(ref_feats["local_features"]), rtol=0, atol=1e-4)


def test_moe_stream_steps_match_jax(moe_pair):
    """Three chunks, each routed within itself, the carried state handed on."""
    jm, params, port = moe_pair
    mel = np.random.default_rng(2).standard_normal((2, 3 * CHUNK, 80)).astype(np.float32)
    step = jax.jit(lambda chunk, st, off: jm.apply({"params": params}, chunk, stream_state=st,
                                                   time_offset=off, return_state=True))
    jstate, state = jstream.init_stream_state(jm.config, 2), None
    for c in range(3):
        chunk = mel[:, c * CHUNK:(c + 1) * CHUNK]
        ref, jstate = step(jnp.asarray(chunk), jstate, jnp.int32(c * CHUNK // 2))
        with torch.no_grad():
            out, state = port(torch.from_numpy(chunk), stream_state=state,
                              time_offset=c * CHUNK // 2, return_state=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
        for ours, theirs in zip(state["blocks"], jstate["blocks"]):
            np.testing.assert_allclose(ours["ssm"].numpy(), np.asarray(theirs["ssm"]),
                                       rtol=0, atol=1e-4)


def test_streaming_forward_collects_the_aux_as_jax(moe_pair):
    jm, params, port = moe_pair
    mel = np.random.default_rng(3).standard_normal((2, 3 * CHUNK, 80)).astype(np.float32)
    ref, ref_aux = jstream.streaming_forward(jm, params, jnp.asarray(mel), CHUNK,
                                             collect_losses=True)
    with torch.no_grad():
        logits, aux = tstream.streaming_forward(port, torch.from_numpy(mel), CHUNK,
                                                collect_losses=True)
        plain = tstream.streaming_forward(port, torch.from_numpy(mel), CHUNK)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)


# ----- training ----------------------------------------------------------------------


def _host_batch(seed, frames=300, lengths=(300, 240), target_lengths=(30, 28)):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((len(lengths), frames, 80)).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    targets = np.full((len(lengths), 32), 2, np.int32)
    for i, n in enumerate(target_lengths):
        targets[i, :n] = rng.integers(3, 30, n)
    return {"mel_spectrogram": mel, "targets": targets,
            "input_lengths": np.asarray(lengths, np.int32),
            "target_lengths": np.asarray(target_lengths, np.int32)}


def _audio_batch(seed, samples=(150 * 160 + 37, 120 * 160 + 5), target_lengths=(10, 7)):
    """A device-mel batch of random audio: 3 chunks of CHUNK frames."""
    rng = np.random.default_rng(seed)
    items = [{"audio": (rng.standard_normal(n) * 0.1).astype(np.float32),
              "targets": rng.integers(3, 30, k).astype(np.int32),
              "target_lengths": np.int32(k), "input_lengths": np.int32(1 + n // 160),
              "text": ""} for n, k in zip(samples, target_lengths)]
    return tdata.ASRCollator(frame_bucket=CHUNK)(items)


def _grad_tree(model, grads):
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(g)
    return dict(_flatten(params_to_numpy(clone)))


def assert_step_matches_jax(jm, params, port, batch, **train_kw):
    """One fp32 micro-step (dropout off): the port's loss and gradients
    against jax.grad of the JAX Trainer's loss on the same batch. The JAX
    Trainer runs on one device: over several it pads the batch to their
    count, and the MoE aux averages over the padding rows too."""
    cfg = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, log_interval=100,
               num_data_shards=1, **train_kw)
    jt = jtraining.Trainer(jm, jtraining.TrainingConfig(**cfg), iter([batch]), params=params)
    sharded, n_valid = jt.shard_batch(batch)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, None, sharded, jax.random.PRNGKey(0), True, n_valid)[0]))(
        params)
    tt = ttraining.Trainer(port, ttraining.TrainingConfig(**cfg), iter(()))
    port.train()
    try:
        loss = tt._loss(tt._to_device(batch), torch.Generator())
        grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    finally:
        port.eval()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-4)
    ours = _grad_tree(port, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(port.parameters(), grads)])
    theirs = dict(_flatten(jax.device_get(ref_g)))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for key, g in theirs.items():
        scale = np.abs(g).max()
        scale = top if scale <= 1e-6 * top else scale  # 0 in exact arithmetic
        assert np.abs(ours[key] - g).max() <= 1e-4 * scale, key
    return theirs


def _router_grads(grads):
    return [g for k, g in grads.items() if "router" in k]


def test_ctc_plus_aux_step_matches_jax_grad(moe_pair):
    jm, params, port = moe_pair
    grads = assert_step_matches_jax(jm, params, port, _host_batch(1), moe_aux_weight=0.3)
    assert len(_router_grads(grads)) == 2 and all(np.abs(g).max() > 0
                                                  for g in _router_grads(grads))


def test_streaming_term_with_aux_matches_jax_grad(moe_pair):
    jm, params, port = moe_pair
    grads = assert_step_matches_jax(jm, params, port, _audio_batch(2), moe_aux_weight=0.3,
                                    streaming_chunks=CHUNK, streaming_aux_weight=0.5)
    assert all(np.abs(g).max() > 0 for g in _router_grads(grads))


def test_checkpointed_moe_step_is_bit_equal_to_the_plain_one():
    """Dropout 0.1 and the aux on: the recomputation replays the expert
    dropout and returns the aux's gradient (the routers' included)."""
    batch = _host_batch(3)
    results = []
    for remat in (False, True):
        cfg = VelocityASRConfig(**{**SMALL, "dropout": 0.1, "gradient_checkpointing": remat})
        model = tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        tt = ttraining.Trainer(model, ttraining.TrainingConfig(moe_aux_weight=0.5), iter(()))
        model.train()
        rng = torch.Generator().manual_seed(11)
        loss = tt._loss(tt._to_device(batch), rng)
        results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    names = [n for n, _ in model.named_parameters()]
    for name, a, b in zip(names, grads_a, grads_b):
        assert torch.equal(a, b), name
    assert any("router" in n and b.abs().max() > 0 for n, b in zip(names, grads_b))


@pytest.mark.parametrize("change,error,match", [
    ({"qat": True}, ValueError, "QAT \\+ MoE is not supported"),
    # pipeline stages are ported: with experts they raise the JAX Trainer's error
    ({"num_pipeline_stages": 2}, ValueError, "pipeline parallelism \\+ MoE is not supported"),
])
def test_moe_trainer_refusals(change, error, match):
    model = tmodel.create_model(VelocityASRConfig(**SMALL), device="cpu")
    train = {k: v for k, v in change.items() if k != "qat"}
    if "qat" in change:
        model.config = dataclasses.replace(model.config, qat=True)
    with pytest.raises(error, match=match):
        ttraining.Trainer(model, ttraining.TrainingConfig(**train), iter(()))
