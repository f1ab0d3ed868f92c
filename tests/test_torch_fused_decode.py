"""The whole-loop decode of the port (``ops/fused_decode.py``) on the CPU.

On the CPU ``fused_decode`` runs its plain PyTorch version,
``fused_decode_reference``, which repeats the CUDA kernel's formulation. It is
held here

* against the port's step-by-step path (``ops/decode_loop.py``) with prenet
  dropout 0.5 and the same injected masks: floats to 1e-5 (float32 sums in
  another order, fed back through 12 decoder steps), integers and flags exact;
* against the JAX package's Pallas kernel itself, which
  ``make_predict_fn(model, use_fused=True)`` runs in interpret mode on the CPU,
  with prenet dropout off on both sides (that kernel draws its own masks and
  cannot take any): same flax weights, same numpy-seeded source; atol 1e-4 on
  mel, stop probabilities and alignments (two float32 implementations over 12
  fed-back steps), lengths, flags and step counts exact.

Every specialisation of the kernel is held so, one variant per pair of flags
(``dual``, ``use_sa``): the flagship's ``DualSourceSelfAttentionDecoder`` (with
the transition agent and a speaker embedding as well), ``DualSourceDecoder``,
the baseline's ``ExtendedDecoder`` and ``SelfAttentionDecoder``; no model class
reaches the last, so it is built by ``TacotronModelBase`` on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import TacotronModelBase as JaxModelBase
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronModelBase, tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_helpers import assert_close, load_from_flax
from test_torch_synthesis import _NARROW

MAX_ITERS = 12
R = 2
B, S = 3, 11
SRC_LENGTHS = np.array([11, 7, 4], np.int32)

VARIANTS = {
    "forward": {},
    "transition_agent": {"attention": "forward_transition_agent"},
    "speaker": {"use_speaker_embedding": True, "num_speakers": 4, "speaker_embedding_dim": 8},
    # dual=1, use_sa=0
    "dual_source_decoder": {"decoder": "DualSourceDecoder"},
    # dual=0, use_sa=0: the baseline
    "extended_decoder": {"tacotron_model": "ExtendedTacotronV1Model", "encoder": "EncoderV1",
                         "decoder": "ExtendedDecoder"},
    # dual=0, use_sa=1
    "self_attention_decoder": {"encoder": "EncoderV1", "decoder": "SelfAttentionDecoder"},
}


# Variants whose narrow seeded decoder keeps its stop probabilities within a few
# hundredths of 0.5, where no threshold separates the lanes with a margin: the
# stop columns of their output projection are scaled by this much, which spreads
# them and leaves the frames as they are (a negative factor turns them, so that
# they rise over the steps on this seed).
SPREAD = {"dual_source_decoder": 8.0, "extended_decoder": -8.0, "self_attention_decoder": 8.0}
# the seed of the flax initialisation, where it is not 0
INIT_SEED = {"dual_source_decoder": 1}


def _sources(variant):
    return 2 if "DualSource" in VARIANTS[variant].get("decoder", "DualSource") else 1


def _model(variant, hp, jax_side=False):
    """The model of ``hp``; ``SelfAttentionDecoder`` is reached by no model class."""
    if hp.decoder == "SelfAttentionDecoder":
        return (JaxModelBase if jax_side else TacotronModelBase)(hp)
    return (jax_factory if jax_side else tacotron_model_factory)(hp)


def _batch(variant, batch=B, seed=7):
    rng = np.random.default_rng(seed)
    lengths = SRC_LENGTHS if batch == B else rng.integers(3, S + 1, size=batch).astype(np.int32)
    out = {
        "source": rng.integers(1, 30, size=(batch, S)).astype(np.int32),
        "source_lengths": lengths,
    }
    if variant == "speaker":
        out["speaker_id"] = rng.integers(0, 4, size=(batch,)).astype(np.int32)
    return out


_flax_cache = {}


def _flax_variables(variant):
    """Flax-initialised weights of the narrow flagship, one set per variant."""
    if variant not in _flax_cache:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant]})
        net = _model(variant, hp, jax_side=True).network(is_training=True)
        batch = {k: jnp.asarray(v) for k, v in _batch(variant).items()}
        variables = net.init(
            {"params": jax.random.PRNGKey(INIT_SEED.get(variant, 0)),
             "dropout": jax.random.PRNGKey(1),
             "zoneout": jax.random.PRNGKey(2)},
            batch["source"], batch["source_lengths"],
            jnp.zeros((B, 4, hp.num_mels), jnp.float32), jnp.full((B,), 4, jnp.int32),
            speaker_id=batch.get("speaker_id"),
        )
        variables = dict(variables)
        if variant in SPREAD:
            params = dict(variables["params"])
            params["decoder"] = dict(params["decoder"])
            proj = dict(params["decoder"]["output_projection"])
            r = _NARROW["outputs_per_step"]
            proj["kernel"] = proj["kernel"].at[:, -r:].multiply(SPREAD[variant])
            params["decoder"]["output_projection"] = proj
            variables["params"] = params
        _flax_cache[variant] = variables
    return _flax_cache[variant]


def _torch_net(variant, **overrides):
    hp = HParams(**{**_NARROW, **VARIANTS[variant], **overrides})
    net = _model(variant, hp).network(device="cpu")
    return load_from_flax(net, _flax_variables(variant), hp)


def _masks(batch=B, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((MAX_ITERS, batch, units)) < 0.5 for units in (32, 16))


def _threshold(stop_probs, gap=4e-3):
    """A threshold, taken from a run's own stop probabilities, at which every lane
    fires before the cap, not all at the same step, and no probability is within
    ``gap / 2`` of it."""
    values = np.sort(np.unique(stop_probs))
    for lo, hi in zip(values[:-1], values[1:]):
        if hi - lo < gap:
            continue
        thr = float((lo + hi) / 2)
        fired = stop_probs > thr
        if not fired.any(axis=1).all():
            continue
        first_step = fired.argmax(axis=1) // R
        if first_step.max() < MAX_ITERS - 2 and len(set(first_step.tolist())) > 1:
            return thr
    raise AssertionError("no threshold separates the lanes; change the seed")


def _compare(got, want, atol):
    """got, want: output dictionaries or DecodeResults brought to dictionaries."""
    for key in ("mel", "stop_probs"):
        assert_close(got[key], np.asarray(want[key]), atol=atol)
    assert len(got["alignments"]) == len(want["alignments"])
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, np.asarray(w), atol=atol)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    assert int(got["num_steps"]) == int(want["num_steps"])
    assert got["lengths"].dtype == torch.int32 and got["finished"].dtype == torch.bool
    steps = int(got["num_steps"])
    for key in ("mel", "stop_probs"):      # nothing is left beyond the exit, not even sigmoid(0)
        assert float(got[key][:, steps * R :].abs().sum()) == 0.0
    for a in got["alignments"]:
        assert float(a[:, steps:].abs().sum()) == 0.0


def _as_dict(result):
    return {
        "mel": result.frames["mel"], "stop_probs": result.stop_probs,
        "alignments": result.alignments, "lengths": result.lengths,
        "finished": result.finished, "num_steps": result.num_steps,
    }


# --------------------------------------------------------------------------- #
# (a) the plain version against the step-by-step path, dropout on
# --------------------------------------------------------------------------- #


def _both_paths(variant, threshold, early_exit=True):
    net = _torch_net(variant, stop_token_threshold=threshold)
    masks, batch = _masks(), _batch(variant)
    stepwise = make_predict_fn(
        net, max_iters=MAX_ITERS, device="cpu", use_fused=False, early_exit=early_exit
    )(batch, prenet_masks=masks)
    with torch.inference_mode():
        cond, _ = net.encode(
            torch.as_tensor(batch["source"]).long(), torch.as_tensor(batch["source_lengths"]).long(),
            None, None if "speaker_id" not in batch else torch.as_tensor(batch["speaker_id"]).long(),
        )
        plain = fd.fused_decode_reference(
            fd.pack_decoder(net.decoder), cond, masks, MAX_ITERS, threshold, early_exit=early_exit
        )
    return _as_dict(plain), stepwise


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_the_step_by_step_path_to_the_cap(variant):
    plain, stepwise = _both_paths(variant, threshold=2.0)   # a probability never exceeds 2
    assert int(stepwise["num_steps"]) == MAX_ITERS and not bool(stepwise["finished"].any())
    assert plain["mel"].shape == (B, MAX_ITERS * R, 10)
    assert [tuple(a.shape) for a in plain["alignments"]] == [(B, MAX_ITERS, S)] * _sources(variant)
    assert float(plain["mel"].abs().max()) > 0.0
    _compare(plain, stepwise, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_the_step_by_step_path_with_early_exit(variant):
    _, full = _both_paths(variant, threshold=2.0)
    threshold = _threshold(full["stop_probs"].numpy())
    plain, stepwise = _both_paths(variant, threshold)
    assert int(stepwise["num_steps"]) < MAX_ITERS and bool(stepwise["finished"].all())
    assert len(set(stepwise["lengths"].tolist())) > 1     # lanes finish at different steps
    _compare(plain, stepwise, atol=1e-5)


def test_without_early_exit_the_plain_version_runs_to_the_cap():
    _, full = _both_paths("forward", threshold=2.0)
    threshold = _threshold(full["stop_probs"].numpy())
    early, _ = _both_paths("forward", threshold)
    late, stepwise = _both_paths("forward", threshold, early_exit=False)
    steps = int(early["num_steps"])
    assert int(late["num_steps"]) == MAX_ITERS > steps
    assert torch.equal(early["lengths"], late["lengths"])
    assert torch.equal(early["mel"][:, : steps * R], late["mel"][:, : steps * R])
    _compare(late, stepwise, atol=1e-5)


# --------------------------------------------------------------------------- #
# (b) against the JAX package's Pallas kernel in interpret mode, dropout off
# --------------------------------------------------------------------------- #

_jax_runs = {}


def _run_jax_fused(variant, threshold):
    key = (variant, threshold)
    if key not in _jax_runs:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant], "decoder_prenet_drop_rate": 0.0,
                           "stop_token_threshold": threshold})
        predict = jax_make_predict_fn(_model(variant, hp, jax_side=True), max_iters=MAX_ITERS,
                                      use_fused=True)
        batch = {k: jnp.asarray(v) for k, v in _batch(variant).items()}
        out = predict(_flax_variables(variant), batch, jax.random.PRNGKey(11))
        _jax_runs[key] = jax.tree.map(np.asarray, out)
    return _jax_runs[key]


def _run_torch_fused(variant, threshold):
    net = _torch_net(variant, decoder_prenet_drop_rate=0.0, stop_token_threshold=threshold)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=True)
    return predict(_batch(variant))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_to_the_cap(variant):
    want = _run_jax_fused(variant, 2.0)
    got = _run_torch_fused(variant, 2.0)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    _compare(got, want, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_with_early_exit(variant):
    threshold = _threshold(_run_jax_fused(variant, 2.0)["stop_probs"])
    want = _run_jax_fused(variant, threshold)
    got = _run_torch_fused(variant, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare(got, want, atol=1e-4)


# --------------------------------------------------------------------------- #
# (c) sequential batch blocks
# --------------------------------------------------------------------------- #


def _decode_blocks(threshold, slice_batch, batch=5):
    net = _torch_net("forward", stop_token_threshold=threshold)
    request = _batch("forward", batch=batch, seed=5)
    with torch.inference_mode():
        cond, _ = net.encode(
            torch.as_tensor(request["source"]).long(),
            torch.as_tensor(request["source_lengths"]).long(),
        )
    return _as_dict(fd.fused_decode(
        fd.pack_decoder(net.decoder), cond, _masks(batch), MAX_ITERS, threshold,
        slice_batch=slice_batch,
    ))


def test_batch_blocks_equal_the_whole_batch():
    whole = _decode_blocks(2.0, slice_batch=None)
    blocks = _decode_blocks(2.0, slice_batch=2)          # blocks of 2, 2 and 1 lanes
    # the CPU's matrix products sum in another order at another batch size
    _compare(blocks, whole, atol=1e-5)


def test_batch_blocks_with_early_exit_keep_the_contract():
    """Per-lane lengths and flags and the frames up to each lane's length are those
    of one launch; ``num_steps`` is the maximum over the blocks; a block's rows
    between its own exit and ``num_steps`` are zero."""
    threshold = _threshold(_decode_blocks(2.0, None)["stop_probs"].numpy())
    whole = _decode_blocks(threshold, slice_batch=None)
    blocks = _decode_blocks(threshold, slice_batch=2)
    assert torch.equal(blocks["lengths"], whole["lengths"])
    assert torch.equal(blocks["finished"], whole["finished"]) and bool(whole["finished"].all())
    assert int(blocks["num_steps"]) == int(whole["num_steps"]) < MAX_ITERS
    exits = []
    for start in range(0, 5, 2):
        lanes = slice(start, min(start + 2, 5))
        own_exit = -(-int(whole["lengths"][lanes].max()) // R)      # the block's last firing step
        exits.append(own_exit)
        assert_close(blocks["mel"][lanes, : own_exit * R], whole["mel"][lanes, : own_exit * R],
                     atol=1e-5)
        assert_close(blocks["alignments"][0][lanes, :own_exit],
                     whole["alignments"][0][lanes, :own_exit], atol=1e-5)
        assert float(blocks["mel"][lanes, own_exit * R :].abs().sum()) == 0.0
        assert float(blocks["stop_probs"][lanes, own_exit * R :].abs().sum()) == 0.0
    assert max(exits) == int(whole["num_steps"]) and min(exits) < max(exits)


# --------------------------------------------------------------------------- #
# (d) which configurations the kernel serves
# --------------------------------------------------------------------------- #


def test_supports_the_flagship_family_only():
    """The four mel decoders are served, in float32 and bfloat16, and
    location-sensitive attention on the two decoders its model classes reach; so
    are the four MgcLf0 decoders (the WORLD heads: the frame M = num_mgcs +
    num_lf0s wide, its lf0 lanes from LF0 = num_mgcs on)."""
    assert fd.supports_fused_decode(HParams(**_NARROW))
    assert fd.supports_fused_decode(HParams(**{**_NARROW, "attention": "forward_transition_agent"}))
    assert fd.supports_fused_decode(HParams(**{**_NARROW, "attention": "location_sensitive"}))
    assert fd.supports_fused_decode(HParams(**{**_NARROW, "decoder": "ExtendedDecoder",
                                               "attention": "location_sensitive"}))
    for variant in VARIANTS:
        assert fd.supports_fused_decode(HParams(**{**_NARROW, **VARIANTS[variant]})), variant
        assert fd.supports_fused_decode(
            HParams(**{**_NARROW, **VARIANTS[variant], "compute_dtype": "bfloat16"})), variant
        mel = {**_NARROW, **VARIANTS[variant]}
        world = HParams(**{**mel, "num_mgcs": 7, "num_lf0s": 13,
                           "decoder": "MgcLf0" + mel["decoder"]})
        assert fd.supports_fused_decode(world), variant
        sizes = fd._hp_sizes(world)
        assert (sizes["M"], sizes["LF0"]) == (20, 7), variant
        assert fd.fused_decode_max_batch(world, MAX_ITERS, S) == fd.MAX_LANES
    assert fd._hp_sizes(HParams(**_NARROW))["LF0"] == 0
    for overrides in (
        {"n_feed_frame": 2},
        {"decoder_prenet_out_units": (32, 16, 16)},
        {"decoder_self_attention_num_hop": 2},
        {"attention": "location_sensitive", "attention_kernel": 30},
        {"decoder": "SelfAttentionDecoder", "attention": "location_sensitive"},
        {"decoder": "MgcLf0SelfAttentionDecoder", "attention": "location_sensitive"},
        {"decoder": "MgcLf0DualSourceSelfAttentionDecoder", "n_feed_frame": 2},
        {"compute_dtype": "float16"},
        {"decoder": "ExtendedDecoder", "attention_out_units": 8, "cbhg_out_units": 24},
    ):
        hp = HParams(**{**_NARROW, **overrides})
        assert not fd.supports_fused_decode(hp), overrides
        assert fd.fused_decode_max_batch(hp, MAX_ITERS, S) == 0


def test_launch_limit_is_lanes_per_sm_and_zero_where_a_block_cannot_fit(monkeypatch):
    """Without a card the limit quoted is the grid plan's on an H100 (one block per
    SM takes up to MAX_LANES lanes); what the built kernel says of its shared memory
    is stood in for here, as no kernel can be built. The limit no longer grows with
    the SM count: every block works on every lane."""
    hp = HParams(**_NARROW)
    assert fd.fused_decode_max_batch(hp, MAX_ITERS, S) == fd.MAX_LANES
    assert fd.grid_plan(fd._hp_sizes(hp), fd.H100_SM_COUNT).max_lanes == fd.MAX_LANES

    class TenSMs:
        multi_processor_count = 10

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: TenSMs)
    sizes = fd._hp_sizes(hp)
    monkeypatch.setattr(fd, "block_shared_memory", lambda *a: (100_000, 200_000))
    assert fd._launch_limit(sizes, S, MAX_ITERS, "card") == fd.MAX_LANES
    monkeypatch.setattr(fd, "block_shared_memory", lambda *a: (200_001, 200_000))
    assert fd._launch_limit(sizes, S, MAX_ITERS, "card") == 0   # a block outgrows an SM


@pytest.mark.parametrize(
    "overrides", [{"n_feed_frame": 2}, {"decoder_prenet_out_units": (32, 16, 16)},
                  {"decoder_self_attention_num_hop": 2}],
    ids=["n_feed_frame", "prenet_layers", "hops"],
)
def test_forcing_the_kernel_on_an_unsupported_configuration_raises(overrides):
    hp = HParams(**{**_NARROW, **overrides})
    net = tacotron_model_factory(hp).network(device="cpu")
    with pytest.raises(ValueError, match="not supported by the fused decode kernel"):
        make_predict_fn(net, device="cpu", use_fused=True)
    make_predict_fn(net, device="cpu")       # auto mode takes the step-by-step loop


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    net = _torch_net("forward")
    request = _batch("forward")
    with torch.inference_mode():
        cond, _ = net.encode(
            torch.as_tensor(request["source"]).long(),
            torch.as_tensor(request["source_lengths"]).long(),
        )
    packed = fd.pack_decoder(net.decoder)
    with pytest.raises(ValueError, match="hand in the masks"):
        fd.fused_decode(packed, cond, None, MAX_ITERS, 0.5)          # dropout is on
    with pytest.raises(ValueError, match="prenet mask"):
        fd.fused_decode(packed, cond, _masks(batch=B + 1), MAX_ITERS, 0.5)
    with pytest.raises(ValueError, match="eval"):
        fd.pack_decoder(net.decoder.train())


# --------------------------------------------------------------------------- #
# (e) make_predict_fn: the two decodes are one function of one generator
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "to_the_cap"])
def test_predict_with_and_without_the_fused_decode_agree(early_exit):
    _, full = _both_paths("forward", threshold=2.0)
    net = _torch_net("forward", stop_token_threshold=_threshold(full["stop_probs"].numpy()))
    outs = []
    for use_fused in (True, False):
        predict = make_predict_fn(
            net, max_iters=MAX_ITERS, device="cpu", use_fused=use_fused, early_exit=early_exit
        )
        outs.append(predict(_batch("forward"), generator=torch.Generator().manual_seed(5)))
    assert float(outs[0]["mel"].abs().max()) > 0.0
    _compare(outs[0], outs[1], atol=1e-5)
    for g, w in zip(outs[0]["encoder_sa_alignments"], outs[1]["encoder_sa_alignments"]):
        assert torch.equal(g, w)


def test_predict_packs_the_weights_once_and_never_leaves_the_fused_decode(monkeypatch):
    """Forced on, every request goes through ``fused_decode`` with the one packed
    buffer made by ``make_predict_fn``; the step-by-step loop is not an alternative
    that a request can end up in."""
    from self_attention_tacotron_torch import synthesis

    packs, decodes = [], []
    pack, decode = synthesis.pack_decoder, synthesis.fused_decode
    monkeypatch.setattr(synthesis, "pack_decoder", lambda d: packs.append(pack(d)) or packs[-1])
    monkeypatch.setattr(
        synthesis, "fused_decode", lambda p, *a, **k: decodes.append(p) or decode(p, *a, **k)
    )

    def no_loop(*args, **kwargs):
        raise AssertionError("the step-by-step loop ran")

    monkeypatch.setattr(synthesis, "decode_incrementally", no_loop)
    predict = make_predict_fn(_torch_net("forward"), max_iters=MAX_ITERS, device="cpu",
                              use_fused=True)
    for seed in (1, 2):
        predict(_batch("forward"), generator=torch.Generator().manual_seed(seed))
    assert len(packs) == 1 and len(decodes) == 2
    assert all(p is packs[0] for p in decodes)
