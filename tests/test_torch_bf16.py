"""The port at ``compute_dtype="bfloat16"`` against the JAX package, on the CPU.

Flax's ``dtype`` semantics on both sides: float32 parameters, every dense layer
and convolution in bfloat16, scores, softmaxes and normalisation statistics in
float32. Same weights (flax init through ``convert``), same numpy-seeded inputs.

* Each module of the slice against its flax module with ``dtype=bfloat16``:
  within two bfloat16 ulps of the reference's largest magnitude
  (8e-3 * max|ref|). Flax applies a module operation by operation, and the port
  rounds where it does (``jax.nn.sigmoid`` as ``1 / (1 + exp(-x))`` with each
  operation rounded, Python constants rounded to bfloat16 first), so most
  errors printed here are 0.
* Narrow flagship and baseline synthesis, step by step
  (``make_predict_fn(use_fused=False)`` on both sides), against JAX's
  ``make_predict_fn(use_fused=False)``, 12 decoder steps, with the same decoder
  prenet masks: lengths, flags and step counts exact, and atol 3e-2 on mel,
  stop probabilities and alignments against the reference run operation by
  operation (``jax.disable_jit``: the function as flax defines it). The same
  reference jitted differs from itself run operation by operation, because XLA
  fuses bfloat16 operations and keeps float32 between them: on mel by one
  bfloat16 ulp of the largest frames (0.03125 at |mel| = 4 on this seed). Against
  the jitted run the port is held at atol 3e-2 plus one bfloat16 ulp of the
  reference value (rtol 2**-7) on mel, and at atol 3e-2 on the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import attention as ja
from self_attention_tacotron_tpu.models import encoders as jax_encoders
from self_attention_tacotron_tpu.models import modules as jm
from self_attention_tacotron_tpu.models import self_attention as jsa
from self_attention_tacotron_tpu.models.models import TacotronNetwork as JaxNetwork
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import attention, encoders, modules
from self_attention_tacotron_torch.models import self_attention as sa
from self_attention_tacotron_torch.models.decoders import DecoderConditioning
from self_attention_tacotron_torch.models.models import TacotronNetwork, tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_baseline import NARROW as BASELINE_NARROW
from test_torch_helpers import assert_close, load_from_flax, t
from test_torch_modules import KEY, _perturb, _randn
from test_torch_synthesis import (
    _NARROW,
    B,
    MAX_ITERS,
    S,
    SRC_LENGTHS,
    _jax_prenet_masks,
    _source,
    _threshold_with_early_exit,
)

BF = jnp.bfloat16
# two bfloat16 ulps of the reference's largest magnitude
TOL_MODULE = 8e-3
TOL_SYNTHESIS = 3e-2
ONE_ULP = 2.0 ** -7


def _bf16(module):
    return modules.set_compute_dtype(module, torch.bfloat16)


def _check(name, got, want, tol=TOL_MODULE):
    """got within ``tol * max|want|`` of want; prints the error."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"bf16 {name}: max abs err {err} of max |ref| {scale}, tol {tol * scale}")
    assert err <= tol * scale, (name, err, tol * scale)


# --------------------------------------------------------------------------- #
# Modules
# --------------------------------------------------------------------------- #


def test_embedding_casts_the_float32_table():
    ids = np.array([[0, 3, 5, 9]])
    emb = jm.Embedding(num_symbols=6, embedding_dim=4, dtype=BF)
    variables = emb.init(KEY, jnp.asarray(ids))
    port = _bf16(load_from_flax(modules.Embedding(6, 4), variables))
    got = port(t(ids))
    assert got.dtype == torch.bfloat16 and port.embedding.dtype == torch.float32
    _check("embedding", got, emb.apply(variables, jnp.asarray(ids)), tol=0.0)


def test_prenet_with_injected_masks():
    x = _randn(0, 5, 12)
    rng = np.random.default_rng(1)
    masks = [rng.random((5, 16)) < 0.5, rng.random((5, 8)) < 0.5]
    prenet = jm.PreNet((16, 8), drop_rate=0.5, dtype=BF)
    variables = _perturb(prenet.init({"params": KEY, "dropout": KEY}, jnp.asarray(x)))
    want = prenet.apply(variables, jnp.asarray(x), dropout_masks=[jnp.asarray(m) for m in masks])
    port = _bf16(load_from_flax(modules.PreNet(12, (16, 8), drop_rate=0.5), variables))
    got = port(t(x), dropout_masks=[t(m) for m in masks])
    assert got.dtype == torch.bfloat16
    _check("prenet", got, want)


@pytest.mark.parametrize("kernel_size", [3, 4])
def test_conv1d_bn(kernel_size):
    x = _randn(kernel_size, 2, 9, 6)
    conv = jm.Conv1dBN(kernel_size=kernel_size, out_channels=5, is_training=False, dtype=BF)
    variables = _perturb(conv.init(KEY, jnp.asarray(x)))
    port = _bf16(load_from_flax(modules.Conv1dBN(6, kernel_size, 5), variables))
    _check(f"conv1d_bn k={kernel_size}", port(t(x)), conv.apply(variables, jnp.asarray(x)))


def test_highway():
    x = _randn(0, 3, 7, 8)
    hw = jm.HighwayNet(8, dtype=BF)
    variables = _perturb(hw.init(KEY, jnp.asarray(x)))
    port = _bf16(load_from_flax(modules.HighwayNet(8), variables))
    _check("highway", port(t(x)), hw.apply(variables, jnp.asarray(x)))


def test_gru_cell():
    x, h = _randn(0, 3, 6), _randn(1, 3, 8)
    cell = jm.GRUCell(8, dtype=BF)
    variables = _perturb(cell.init(KEY, jnp.asarray(h), jnp.asarray(x)))
    want, _ = cell.apply(variables, jnp.asarray(h, BF), jnp.asarray(x))
    port = _bf16(load_from_flax(modules.GRUCell(6, 8), variables))
    got, _ = port(t(h).bfloat16(), t(x))
    assert got.dtype == torch.bfloat16
    _check("gru_cell", got, want)


def test_zoneout_lstm_cell_eval():
    x, c, h = _randn(0, 3, 6), _randn(1, 3, 8), _randn(2, 3, 8)
    cell = jm.ZoneoutLSTMCell(8, 0.1, 0.1, is_training=False, dtype=BF)
    carry = (jnp.asarray(c, BF), jnp.asarray(h, BF))
    variables = _perturb(cell.init(KEY, carry, jnp.asarray(x)))
    (want_c, want_h), _ = cell.apply(variables, carry, jnp.asarray(x))
    port = _bf16(load_from_flax(modules.ZoneoutLSTMCell(6, 8, 0.1, 0.1), variables))
    (got_c, got_h), _ = port((t(c).bfloat16(), t(h).bfloat16()), t(x))
    _check("zoneout_lstm c", got_c, want_c)
    _check("zoneout_lstm h", got_h, want_h)


def test_cbhg_step_by_step():
    x = _randn(0, 3, 11, 8)
    lengths = np.array([11, 6, 1])
    cbhg = jm.CBHG(out_units=16, conv_channels=6, max_filter_width=4, projection1_out_channels=7,
                   projection2_out_channels=8, num_highway=2, is_training=False, dtype=BF)
    variables = _perturb(cbhg.init(KEY, jnp.asarray(x), jnp.asarray(lengths)))
    want = cbhg.apply(variables, jnp.asarray(x, BF), jnp.asarray(lengths))
    port = _bf16(load_from_flax(modules.CBHG(8, 16, 6, 4, 7, 8, 2, use_pallas=True), variables))
    with torch.no_grad():
        got = port(t(x).bfloat16(), t(lengths))
    assert got.dtype == torch.bfloat16
    _check("cbhg", got, want)


def _transformer_pair():
    jt = jsa.SelfAttentionTransformer(num_hop=1, num_heads=2, num_units=16, ffn_units=24,
                                      is_training=False, dtype=BF)
    x = _randn(0, 2, 9, 12)
    variables = _perturb(jt.init(KEY, jnp.asarray(x)))
    port = _bf16(load_from_flax(sa.SelfAttentionTransformer(12, 1, 2, 16, 24, use_pallas=True),
                                variables))
    return jt, variables, port, x


def test_transformer_full_sequence_with_mask():
    jt, variables, port, x = _transformer_pair()
    mask = np.arange(9)[None, :] < np.array([9, 5])[:, None]
    want, want_probs = jt.apply(variables, jnp.asarray(x, BF), jnp.asarray(mask))
    with torch.no_grad():
        got, probs = port(t(x).bfloat16(), t(mask))
    assert got.dtype == torch.bfloat16 and probs[0].dtype == torch.float32
    _check("transformer", got, want)
    _check("transformer probabilities", probs[0], want_probs[0])


def test_transformer_incremental_steps():
    jt, variables, port, x = _transformer_pair()
    caches_j = jt.init_cache(2, 9)
    caches = port.init_cache(2, 9, torch.bfloat16)
    for i in range(4):
        want, caches_j = jt.apply(
            variables, jnp.asarray(x[:, i], BF), caches_j, jnp.asarray(i, jnp.int32),
            method=jsa.SelfAttentionTransformer.incremental_step,
        )
        with torch.no_grad():
            got, caches = port.incremental_step(t(x[:, i]).bfloat16(), caches, i)
        _check(f"transformer step {i}", got, want)
    _check("transformer K cache", caches[0][0], caches_j[0][0])
    _check("transformer V cache", caches[0][1], caches_j[0][1])


_ENCODER_KW = {
    "SelfAttentionCBHGEncoder": dict(
        cbhg_out_units=16, conv_channels=6, max_filter_width=4, projection1_out_channels=7,
        projection2_out_channels=8, num_highway=2, prenet_out_units=(12, 8), drop_rate=0.0,
        self_attention_out_units=16, self_attention_num_heads=2, self_attention_ffn_units=24,
    ),
    "EncoderV1": dict(
        cbhg_out_units=16, conv_channels=6, max_filter_width=4, projection1_out_channels=7,
        projection2_out_channels=8, num_highway=2, prenet_out_units=(12, 8), drop_rate=0.0,
    ),
    "ZoneoutEncoderV1": dict(out_units=16, prenet_out_units=(12, 8), drop_rate=0.0,
                             zoneout_factor_cell=0.1, zoneout_factor_output=0.2),
}


@pytest.mark.parametrize("name", sorted(_ENCODER_KW))
def test_encoder(name):
    kw = _ENCODER_KW[name]
    x, lengths = _randn(0, 3, 10, 12), np.array([10, 4, 7])
    jenc = getattr(jax_encoders, name)(is_training=False, use_pallas=True, dtype=BF, **kw)
    args = (jnp.asarray(x), jnp.asarray(lengths))
    variables = _perturb(jenc.init({"params": KEY, "dropout": KEY}, *args))
    want = jenc.apply(variables, *args, rngs={"dropout": KEY})
    port = _bf16(load_from_flax(getattr(encoders, name)(12, use_pallas=True, **kw), variables))
    with torch.no_grad():
        got = port(t(x), t(lengths))
    if name == "SelfAttentionCBHGEncoder":
        _check(f"{name} memory 1", got[0], want[0])
        _check(f"{name} memory 2", got[1], want[1])
        _check(f"{name} probabilities", got[2][0], want[2][0])
    else:
        assert got.dtype == torch.bfloat16
        _check(name, got, want)


@pytest.mark.parametrize("name,agent", [("additive", False), ("forward", True)])
def test_mechanism_three_steps(name, agent):
    Bm, Sm, E, Q, U = 3, 9, 10, 12, 8
    mask = np.arange(Sm)[None, :] < np.array([9, 5, 2])[:, None]
    memory = _randn(0, Bm, Sm, E)
    queries = [_randn(10 + i, Bm, Q) for i in range(3)]
    jmech = ja.attention_factory(
        name, U, JaxHParams(use_forward_attention_transition_agent=agent), dtype=BF)
    port = _bf16(attention.attention_factory(
        name, U, HParams(use_forward_attention_transition_agent=agent), query_units=Q,
        memory_units=E))
    state_j = ja.initial_attention_state(Bm, Sm, initial_alignment=jmech.initial_alignment)
    state = attention.initial_attention_state(Bm, Sm, initial_alignment=port.initial_alignment)
    mem_j = jnp.asarray(memory, BF)
    variables = jmech.init(jax.random.PRNGKey(0), jnp.asarray(queries[0], BF),
                           jnp.zeros((Bm, Sm, U), BF), mem_j, jnp.asarray(mask), state_j)
    key_vars = jmech.init(jax.random.PRNGKey(1), mem_j, method=type(jmech).compute_keys)
    params = dict(variables["params"])
    params["memory_layer"] = key_vars["params"]["memory_layer"]
    variables = _perturb({"params": params})
    load_from_flax(port, variables)
    keys_j = jmech.apply(variables, mem_j, method=type(jmech).compute_keys)
    keys = port.compute_keys(t(memory).bfloat16())
    _check(f"{name} keys", keys, keys_j)
    with torch.no_grad():
        for i, q in enumerate(queries):
            want_ctx, want_probs, state_j = jmech.apply(
                variables, jnp.asarray(q, BF), keys_j, mem_j, jnp.asarray(mask), state_j)
            ctx, probs, state = port(t(q).bfloat16(), keys, t(memory).bfloat16(), t(mask), state)
            assert ctx.dtype == torch.bfloat16 and probs.dtype == torch.float32
            _check(f"{name} step {i} context", ctx, want_ctx)
            _check(f"{name} step {i} alignments", probs, want_probs)
            _check(f"{name} step {i} transition", state.transition, state_j.transition)


def test_decoder_three_steps():
    kw = dict(_NARROW, compute_dtype="bfloat16", use_forward_attention_transition_agent=True)
    jhp = JaxHParams(**kw)
    init_net = JaxNetwork(hparams=JaxHParams(**{**kw, "compute_dtype": "float32"}),
                          is_training=True)
    source = jnp.asarray(_source())
    lengths = jnp.asarray(SRC_LENGTHS)
    variables = _perturb(init_net.init(
        {"params": KEY, "dropout": KEY, "zoneout": KEY},
        source, lengths, jnp.zeros((B, 4, 10)), jnp.full((B,), 4, jnp.int32)))
    jnet = JaxNetwork(hparams=jhp, is_training=False)
    hp = HParams(**kw)
    port = load_from_flax(TacotronNetwork(hp), variables, hp)
    cond_j, _ = jnet.apply(variables, source, lengths, method=JaxNetwork.encode)
    state_j = jnet.apply(variables, cond_j, method=JaxNetwork.decoder_initial_state)
    caches_j = jnet.apply(variables, B, 6, method=JaxNetwork.decoder_init_caches)
    feed_j = jnet.apply(variables, B, method=JaxNetwork.decoder_go_frame)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        cond, _ = port.encode(t(_source(), torch.long), t(SRC_LENGTHS, torch.long))
        for i, (g, w) in enumerate(zip(cond.memories + cond.keys, cond_j.memories + cond_j.keys)):
            assert g.dtype == torch.bfloat16
            _check(f"conditioning {i}", g, w)
        state = port.decoder_initial_state(cond)
        caches = port.decoder_init_caches(B, 6)
        feed = port.decoder_go_frame(B)
        for i in range(3):
            masks = (rng.random((B, 32)) < 0.5, rng.random((B, 16)) < 0.5)
            state_j, (feat_j, aligns_j) = jnet.apply(
                variables, state_j, feed_j, cond_j, tuple(jnp.asarray(m) for m in masks),
                method=JaxNetwork.decoder_step)
            frames_j, stop_j, caches_j = jnet.apply(
                variables, feat_j, caches_j, jnp.asarray(i, jnp.int32),
                method=JaxNetwork.decoder_post_step)
            state, (feat, aligns) = port.decoder_step(state, feed, cond,
                                                      tuple(t(m) for m in masks))
            frames, stop, caches = port.decoder_post_step(feat, caches, i)
            assert feat.dtype == torch.bfloat16 and state.attention_lstm[0].dtype == torch.bfloat16
            _check(f"step {i} feature", feat, feat_j)
            _check(f"step {i} attention LSTM h", state.attention_lstm[1], state_j.attention_lstm[1])
            for k, (g, w) in enumerate(zip(aligns, aligns_j)):
                _check(f"step {i} alignments {k}", g, w)
            _check(f"step {i} mel", frames["mel"], frames_j["mel"])
            _check(f"step {i} stop logits", stop, stop_j)
            feed_j, feed = frames_j["mel"][:, -1, :], frames["mel"][:, -1, :]


# --------------------------------------------------------------------------- #
# Synthesis, step by step
# --------------------------------------------------------------------------- #

CONFIGS = {"flagship": dict(_NARROW), "baseline": dict(BASELINE_NARROW)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_side(request):
    config = CONFIGS[request.param]
    net = jax_factory(JaxHParams(**config)).network(is_training=True)
    source, lengths = jnp.asarray(_source()), jnp.asarray(SRC_LENGTHS)
    variables = dict(net.init(
        {"params": jax.random.PRNGKey(1 if request.param == "baseline" else 0),
         "dropout": jax.random.PRNGKey(1), "zoneout": jax.random.PRNGKey(2)},
        source, lengths, jnp.zeros((B, 4, 10), jnp.float32), jnp.full((B,), 4, jnp.int32),
    ))
    if request.param == "baseline":
        # as test_torch_baseline.py: spread the stop logits of the narrow decoder
        params = dict(variables["params"])
        params["decoder"] = dict(params["decoder"])
        proj = dict(params["decoder"]["output_projection"])
        proj["kernel"] = proj["kernel"] * 8.0
        params["decoder"]["output_projection"] = proj
        variables["params"] = params
    return request.param, config, variables, {"source": source, "source_lengths": lengths}, {}


def _run_jax(jax_side, threshold, jit=True):
    _, config, variables, batch, cache = jax_side
    key = (threshold, jit)
    if key not in cache:
        hp = JaxHParams(**{**config, "compute_dtype": "bfloat16",
                           "stop_token_threshold": threshold})
        predict = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=False)
        rng = jax.random.PRNGKey(11)
        if jit:
            out = predict(variables, batch, rng)
        else:
            with jax.disable_jit():
                out = predict(variables, batch, rng)
        cache[key] = (jax.tree.map(np.asarray, out), _jax_prenet_masks(rng, hp))
    return cache[key]


def _run_torch(jax_side, threshold, masks):
    _, config, variables, _, _ = jax_side
    hp = HParams(**{**config, "compute_dtype": "bfloat16", "stop_token_threshold": threshold})
    net = load_from_flax(tacotron_model_factory(hp).network(device="cpu"), variables, hp)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=False)
    return predict({"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks)


def _compare(label, got, want, mel_rtol=0.0):
    for key, rtol in (("mel", mel_rtol), ("stop_probs", 0.0)):
        err = float(np.abs(got[key].numpy() - want[key]).max())
        print(f"bf16 synthesis {label} {key}: max abs err {err}")
        assert got[key].dtype == torch.float32
        assert_close(got[key], want[key], atol=TOL_SYNTHESIS, rtol=rtol)
    assert len(got["alignments"]) == len(want["alignments"])
    for i, (g, w) in enumerate(zip(got["alignments"], want["alignments"])):
        print(f"bf16 synthesis {label} alignments {i}: max abs err {float(np.abs(g.numpy() - w).max())}")
        assert_close(g, w, atol=TOL_SYNTHESIS)
    for g, w in zip(got["encoder_sa_alignments"], want["encoder_sa_alignments"]):
        assert_close(g, w, atol=TOL_SYNTHESIS)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
    assert int(got["num_steps"]) == int(want["num_steps"])


def test_synthesis_matches_jax_to_the_step_cap(jax_side):
    eager, masks = _run_jax(jax_side, 2.0, jit=False)    # a probability never exceeds 2
    jitted, jit_masks = _run_jax(jax_side, 2.0)
    assert all(np.array_equal(a, b) for a, b in zip(masks, jit_masks))
    got = _run_torch(jax_side, 2.0, masks)
    assert int(eager["num_steps"]) == MAX_ITERS and not eager["finished"].any()
    assert got["mel"].shape == (B, MAX_ITERS * 2, 10) and float(got["mel"].abs().max()) > 0.0
    _compare(f"{jax_side[0]} against JAX operation by operation", got, eager)
    _compare(f"{jax_side[0]} against JAX jitted", got, jitted, mel_rtol=ONE_ULP)


def test_synthesis_early_exit_matches_jax(jax_side):
    """Against the reference run operation by operation: the jitted run's stop
    probabilities are up to 5e-3 from it, more than the gap around any threshold
    that separates the lanes of this seed."""
    threshold = _threshold_with_early_exit(_run_jax(jax_side, 2.0, jit=False)[0]["stop_probs"])
    want, masks = _run_jax(jax_side, threshold, jit=False)
    got = _run_torch(jax_side, threshold, masks)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1     # lanes finish at different steps
    _compare(f"{jax_side[0]} early exit against JAX operation by operation", got, want)
    steps = int(got["num_steps"])
    assert float(got["mel"][:, steps * 2 :].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# Training in bfloat16: the plain path runs, and through the kernels it reaches them
# --------------------------------------------------------------------------- #


def _bf16_trainer():
    from self_attention_tacotron_torch.tools.flagship import training_batch
    from self_attention_tacotron_torch.training.trainer import Trainer

    hp = HParams(**{**_NARROW, "compute_dtype": "bfloat16"})
    torch.manual_seed(0)
    trainer = Trainer(tacotron_model_factory(hp), device="cpu")
    state = trainer.init_state()
    batch = training_batch(np.random.default_rng(2), batch=3, frames=8, longest=S, num_mels=10,
                           shortest=3)
    return trainer, state, batch


def test_bf16_training_step_runs_the_plain_path_on_the_cpu():
    trainer, state, batch = _bf16_trainer()
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"])) and float(metrics["loss"]) > 0
    assert all(p.dtype == torch.float32 for p in state.net.parameters())


def test_bf16_training_through_the_kernels_reaches_the_kernels():
    """On the card with use_pallas_kernels a bfloat16 train step and evaluation step,
    and the teacher-forced pass, go to the kernels' wrappers (no refusal, no silent
    plain scan): a device without kernels, ``meta``, stands in for the card, and
    the wrappers raise for it. What the kernels compute in bfloat16 is held in
    ``test_torch_fused_teacher_bf16.py``, ``test_torch_bigru_train_bf16.py`` and
    ``test_torch_training_bf16.py``."""
    trainer, state, batch = _bf16_trainer()
    trainer.device = torch.device("meta")
    state.net.to("meta")
    with pytest.raises(RuntimeError, match="bigru has no kernel for device meta"):
        trainer.train_step(state, batch)
    with pytest.raises(RuntimeError, match="bigru has no kernel for device meta"):
        trainer.eval_step(state, batch)
    decoder = state.net.decoder
    assert decoder.use_pallas and decoder.fused_teacher_supported()
    mems = tuple(torch.zeros(3, S, u, dtype=torch.bfloat16, device="meta")
                 for u in decoder.memory_units)
    cond = DecoderConditioning(
        memories=mems, keys=decoder.compute_keys(mems),
        masks=tuple(torch.ones(3, S, dtype=torch.bool, device="meta") for _ in mems),
    )
    with pytest.raises(RuntimeError, match="fused_teacher has no kernel for device meta"):
        decoder(cond, torch.zeros(3, 8, 10, device="meta"))
