"""The location-sensitive branch of the port's teacher-forced decode against the JAX package.

Kernel level: the inputs of ``test_torch_fused_teacher.py`` plus the folded
location taps ``w_lsW`` (K, A1) and their bias go through
``teacher_decode_reference`` of the port (the plain version that the CUDA kernels
are held against on the card) and through ``teacher_decode(..., interpret=True)``
of the JAX package with ``src1_kind="location_sensitive"``: features, alignments
and every gradient, ``w_lsW`` and ``ls_bias`` among them, for one source and two,
over cumulative and previous alignments, with train and eval zoneout and a
speaker embedding; float32 at the tolerances of ``test_torch_fused_teacher.py``
(1e-4 absolute on values, gradients 1e-4 relative to the leaf's largest entry).
bfloat16, every case: the port against the JAX function in bfloat16 within a
quarter of the JAX function's own bfloat16-against-float32 gap (per leaf in
||delta|| / ||ref||, in max abs for features and alignments), as
``test_torch_fused_teacher_bf16.py`` holds the forward-attention cases: the
features, the alignments, ``w_lsW``, ``ls_bias`` and the median leaf. Every leaf
is printed (``-s``). Both round at the same points, so most cases agree bit for
bit; in ``dual_previous_speaker_train_zoneout`` one value lands next to a
rounding boundary and rounds one bfloat16 ulp apart (float32 sums in another
order), and that one flip moves the prenet's gradients of a three-lane batch by
about the gap: hence the median leaf, where the forward-attention cases hold
every leaf.

Decoder level: a narrow dual-source self-attention network with
location-sensitive attention, whose teacher-forced pass goes through the
decoder's hand-over to ``ops/fused_teacher.py`` (``location_fold`` under
autograd, then the plain version), against the JAX network on its fused path
(Pallas kernels in interpret mode): the loss and every parameter's gradient,
those of ``location_conv``, ``location_layer`` and ``attention_b`` among them,
which must not be zero; 1e-4 relative to the leaf's largest entry.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.ops import fused_teacher as jax_teacher

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_teacher

from test_torch_fused_teacher import B, D, N, S, SEED
from test_torch_fused_teacher import _hp_like as _forward_hp_like
from test_torch_fused_teacher import _inputs as _forward_inputs
from test_torch_helpers import flat_variables

TAPS = 7
CASES = {
    "single_cumulative": dict(dual=False, ls="cum"),
    "single_previous": dict(dual=False, ls="prev"),
    "dual_cumulative": dict(ls="cum"),
    "dual_previous_speaker_train_zoneout": dict(ls="prev", spk=4, zc=0.3, zo=0.2),
    "single_cumulative_five_taps_eval_zoneout": dict(
        dual=False, ls="cum", taps=5, zc=0.1, zo=0.15, eval_zoneout=True),
}
SHARE_OF_GAP = 0.25
_DIFF_CONDS = ("keys", "mem1", "mem2", "spk")


def _inputs(case, seed=0):
    weights, conds, feeds, cot = _forward_inputs(case, seed)
    rng = np.random.RandomState(seed + 100)
    weights["w_lsW"] = (rng.randn(case.get("taps", TAPS), D["A1"]) * 0.3).astype(np.float32)
    weights["ls_bias"] = (rng.randn(D["A1"]) * 0.3).astype(np.float32)
    return weights, conds, feeds, cot


def _hp_like(case, io_dtype="float32"):
    return dict(_forward_hp_like(case), src1_kind="location_sensitive",
                ls_cumulative=case["ls"] == "cum", ls_kernel=case.get("taps", TAPS),
                io_dtype=io_dtype)


def _jax_run(case, io_dtype):
    """(features, alignments, {leaf: gradient}) of the JAX kernels, as numpy."""
    weights, conds, feeds, cot = _inputs(case)
    io = jnp.bfloat16 if io_dtype == "bfloat16" else jnp.float32
    diff = {k: jnp.asarray(v, io if k != "spk" else jnp.float32)
            for k, v in conds.items() if v is not None and k in _DIFF_CONDS}

    def loss(w, c, f):
        out = jax_teacher.teacher_decode(
            weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c.get("mem2"),
            score_bias=jnp.asarray(conds["score_bias"]), spk=c.get("spk"), feeds=f,
            seed=jnp.asarray(SEED, jnp.int32), hp_like=_hp_like(case, io_dtype), interpret=True,
        )
        return jnp.sum(out[0] * cot["features"]) + jnp.sum(out[1] * cot["aligns"]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, weights), diff, jnp.asarray(feeds)
    )
    leaves = {f"w:{k}": v for k, v in grads[0].items()}
    leaves.update({f"c:{k}": v for k, v in grads[1].items()})
    leaves["feeds"] = grads[2]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(out[0]), f32(out[1]), {k: f32(v) for k, v in leaves.items()}


def _port_run(case, io_dtype):
    weights, conds, feeds, cot = _inputs(case)
    io = torch.bfloat16 if io_dtype == "bfloat16" else torch.float32
    leaf = lambda x, dtype=torch.float32: torch.tensor(x).to(dtype).requires_grad_(True)  # noqa: E731
    w = {k: leaf(v) for k, v in weights.items()}
    c = {k: leaf(v, io if k != "spk" else torch.float32)
         for k, v in conds.items() if v is not None and k in _DIFF_CONDS}
    f = leaf(feeds)
    out = fused_teacher.teacher_decode(
        weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c.get("mem2"),
        score_bias=torch.tensor(conds["score_bias"]), spk=c.get("spk"), feeds=f, seed=SEED,
        hp_like=_hp_like(case, io_dtype),
    )
    loss = (out[0] * torch.tensor(cot["features"])).sum()
    (loss + (out[1] * torch.tensor(cot["aligns"])).sum()).backward()
    grads = {f"w:{k}": v.grad for k, v in w.items()}
    grads.update({f"c:{k}": v.grad for k, v in c.items()})
    grads["feeds"] = f.grad
    f32 = lambda x: None if x is None else x.detach().float().numpy()  # noqa: E731
    return f32(out[0]), f32(out[1]), {k: f32(v) for k, v in grads.items()}


@functools.lru_cache(maxsize=None)
def _both(name, io_dtype="float32"):
    return _jax_run(CASES[name], io_dtype), _port_run(CASES[name], io_dtype)


def _unused(key):
    return key in ("w:w_ta", "w:b_ta")       # no transition agent with this mechanism


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_the_jax_kernel(name):
    want, got = _both(name)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    n_src = 1 if CASES[name].get("dual", True) is False else 2
    sums = got[1].reshape(B, N, n_src, S).sum(axis=-1)
    assert float(np.abs(sums - 1.0).max()) < 1e-5
    # alpha_1 is the softmax itself: nothing on the padded positions of a short lane
    assert float(np.abs(got[1][2, :, 4:S]).max()) == 0.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_gradient_matches_the_jax_kernel(name):
    want, got = _both(name)
    assert float(np.abs(want[2]["w:w_lsW"]).max()) > 0.0 and float(np.abs(want[2]["w:ls_bias"]).max()) > 0.0
    for key, ref in want[2].items():
        if _unused(key):
            assert got[2][key] is None or float(np.abs(got[2][key]).max()) == 0.0
            continue
        scale = max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(got[2][key], ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"{name}: {key}")


def _relative(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_sits_within_a_quarter_of_the_gap(name):
    want, got = _both(name, "bfloat16")
    f32 = _both(name)[0]
    rows = [(label, float(np.abs(got[i] - want[i]).max()), float(np.abs(want[i] - f32[i]).max()))
            for i, label in enumerate(("features", "alignments"))]
    rows += [(key, _relative(got[2][key], ref), _relative(ref, f32[2][key]))
             for key, ref in want[2].items() if not _unused(key)]
    print(f"\nteacher_decode bf16 location-sensitive, {name}: leaf, port against JAX bf16, "
          "JAX bf16 against f32")
    for key, err, gap in rows:
        print(f"  {key:14s} {err:.3e}  {gap:.3e}")
    shares = {key: err / gap for key, err, gap in rows}
    for key in ("features", "alignments", "w:w_lsW", "w:ls_bias"):
        assert shares[key] <= SHARE_OF_GAP, f"{key}: {shares[key]} of the gap"
    assert float(np.median(list(shares.values()))) <= SHARE_OF_GAP, shares


def test_the_kernels_refuse_what_they_do_not_take():
    case = CASES["single_cumulative"]
    weights, conds, feeds, _ = _inputs(case)
    kwargs = dict(
        weights={k: torch.tensor(v) for k, v in weights.items()}, keys=torch.tensor(conds["keys"]),
        mem1=torch.tensor(conds["mem1"]), mem2=None, score_bias=torch.tensor(conds["score_bias"]),
        spk=None, feeds=torch.tensor(feeds), seed=0,
    )
    with pytest.raises(ValueError, match="odd number of taps"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), ls_kernel=6), **dict(
            kwargs, weights=dict(kwargs["weights"], w_lsW=torch.zeros(6, D["A1"]))))
    with pytest.raises(ValueError, match="w_lsW"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), ls_kernel=5), **kwargs)
    with pytest.raises(ValueError, match="transition agent"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), use_ta=True), **kwargs)
    assert fused_teacher.taps_supported(31) and fused_teacher.taps_supported(1)
    assert not fused_teacher.taps_supported(33) and not fused_teacher.taps_supported(30)


@pytest.mark.parametrize("name", ["forward", "single_cumulative"])
def test_the_kernels_weight_buffer_holds_the_location_taps_only_with_them(name):
    """``_pack``, what the kernels read on the card: the folded taps zero-padded to
    ``MAX_TAPS`` rows after every other entry, and no room for them without."""
    case = dict(CASES.get(name, {}), **({} if name in CASES else {"dual": True}))
    weights, conds, feeds, _ = (_inputs if name in CASES else _forward_inputs)(case)
    hp_like = _hp_like(case) if name in CASES else _forward_hp_like(case)
    w = {k: torch.tensor(v) for k, v in weights.items()}
    x2 = fused_teacher._prenet(w, torch.tensor(feeds), 0.0, None, None)
    mem2 = None if conds["mem2"] is None else torch.tensor(conds["mem2"])
    z = fused_teacher._sizes(hp_like, w, torch.tensor(conds["keys"]),
                             torch.tensor(conds["mem1"]), mem2, None, x2)
    flat, v32, offsets = fused_teacher._pack(z, w)
    ls_rows = fused_teacher.MAX_TAPS if name in CASES else 0
    assert flat.numel() == offsets["ls_w"] + ls_rows * ((D["A1"] + 3) // 4 * 4)
    if ls_rows:
        taps = flat[offsets["ls_w"]:].view(ls_rows, -1)
        np.testing.assert_array_equal(taps[:TAPS, : D["A1"]].numpy(), weights["w_lsW"])
        assert float(taps[TAPS:].abs().sum()) == 0.0 and float(taps[:, D["A1"]:].abs().sum()) == 0.0
    for name_w, at in offsets.items():
        assert at % 4 == 0, name_w


# --------------------------------------------------------------------------- #
# The decoder's hand-over: the gradients reach the convolution and the layer
# --------------------------------------------------------------------------- #

_NET = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel",
    encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
    attention="location_sensitive", attention2="additive",
    attention_kernel=5, attention_filters=4, cumulative_weights=True,
    num_symbols=20, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.0,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    self_attention_drop_rate=0.0,
    decoder_prenet_out_units=(16, 8), decoder_prenet_drop_rate=0.0,
    attention_out_units=16, attention1_out_units=12, attention2_out_units=4,
    decoder_out_units=16, decoder_self_attention_out_units=16,
    decoder_self_attention_drop_rate=0.0, zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
    num_mels=6, outputs_per_step=2,
)


def test_the_decoder_hands_the_folded_taps_over_and_every_gradient_reaches_its_parameter(
        monkeypatch):
    rng = np.random.default_rng(0)
    Bn, Sn, T = 2, 12, 8
    src = rng.integers(2, 20, (Bn, Sn)).astype(np.int32)
    lengths = np.array([Sn, Sn - 4], np.int32)
    mel = rng.random((Bn, T, 6)).astype(np.float32)
    batch = {"mel": mel, "target_lengths": np.full((Bn,), T, np.int32),
             "done": np.zeros((Bn, T), np.float32)}

    jmodel = jax_factory(JaxHParams(**_NET))
    jnet = jmodel.network(is_training=True)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(["params", "dropout", "zoneout"])}
    variables = jnet.init(rngs, jnp.asarray(src), jnp.asarray(lengths), jnp.asarray(mel),
                          jnp.asarray(batch["target_lengths"]))
    variables = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        dict(variables))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, _ = jnet.apply(
            dict(variables, params=p), jnp.asarray(src), jnp.asarray(lengths), jnp.asarray(mel),
            jbatch["target_lengths"], mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(5), "zoneout": jax.random.PRNGKey(6)},
        )
        return jmodel.loss(out, jbatch, params=p)["loss"]

    monkeypatch.setattr(jax_teacher, "FORCE_INTERPRET", True)
    calls = []
    original = jax_teacher.teacher_decode
    monkeypatch.setattr(jax_teacher, "teacher_decode",
                        lambda **kw: calls.append(kw["hp_like"]["src1_kind"]) or original(**kw))
    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    assert calls == ["location_sensitive"], calls
    want = {f"params/{k}": np.asarray(v, np.float32) for k, v in
            flax.traverse_util.flatten_dict(dict(want_grads), sep="/").items()}

    hp = HParams(**_NET)
    model = tacotron_model_factory(hp)
    net = model.network(is_training=True, device="cpu")
    convert.load_state(net, convert.flax_to_torch_state(flat_variables(variables), hp, net))
    decoder = net.decoder
    assert decoder.fused_teacher_supported()
    hand_overs = []

    def hand_over(cond, feeds, prenet_masks, seed):
        hand_overs.append(decoder.teacher_operands(cond)["hp_like"]["src1_kind"])
        return decoder._fused_teacher_call(cond, feeds, prenet_masks, seed)

    monkeypatch.setattr(decoder, "_plain_teacher_scan", hand_over)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    out = net(torch.tensor(src).long(), torch.tensor(lengths).long(), tbatch["mel"],
              tbatch["target_lengths"])
    loss = model.loss(out, tbatch, params=list(net.parameters()))["loss"]
    loss.backward()
    assert hand_overs == ["location_sensitive"]
    got = convert.torch_to_flax_flat(net, gradients=True)

    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    location = [k for k in want if "location_conv" in k or "location_layer" in k
                or k.endswith("attention_b")]
    assert len(location) == 4
    for key in location:
        assert float(np.abs(got[key]).max()) > 0.0, key
    for key, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(got[key], ref, atol=1e-4 * scale, rtol=0, err_msg=key)
