"""The port's teacher-forced decode in bfloat16 against the JAX package's fused kernels.

Kernel level: the inputs of ``test_torch_fused_teacher.py`` (every case of its
``CASES``: two sources and one, with and without the transition agent, speaker
embedding, eval zoneout and train zoneout through the shared hash) go through
``teacher_decode_reference`` of the port with ``io_dtype="bfloat16"`` (keys and
memories in bfloat16; the plain version the CUDA kernels are held against on the
card) and through ``teacher_decode(..., interpret=True)`` of the JAX package in
bfloat16: features, alignments and every gradient (each weight, keys, mem1,
mem2, the prenet's feeds, spk).

Decoder level: the port's bfloat16 decoder through ``_fused_teacher_call`` and
``post`` (what ``forward`` does on the card), forward and backward of a fixed
weighted sum, against the JAX bfloat16 decoder on its fused path (Pallas kernels
in interpret mode), run operation by operation as the port's bfloat16 modules
round. The decoders here have no self-attention, so that ``post`` is the output
projection alone: the self-attention block's backward (LayerNorm, attention)
casts its float32 cotangents to bfloat16 after float32 sums in another order
than JAX's autodiff, which moves every leaf upstream of it by up to about 0.3 of
the gap; ``test_torch_training_bf16.py`` holds the flagship with it.

Tolerance: the JAX function in bfloat16 against itself in float32 on the same
inputs is the yardstick (``gap``); the port against the JAX function in bfloat16
must sit within a quarter of it: per gradient leaf in ||delta|| / ||ref||, in max
abs for the features and alignments. A rounding point that differs from the
reference's shows as an error near the gap. ``-s`` prints both per leaf.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.decoders import DecoderConditioning as JaxConditioning
from self_attention_tacotron_tpu.models.models import TacotronNetwork as JaxNetwork
from self_attention_tacotron_tpu.ops import fused_teacher as jax_teacher

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.decoders import DecoderConditioning
from self_attention_tacotron_torch.models.models import TacotronNetwork
from self_attention_tacotron_torch.ops import fused_teacher

from test_torch_fused_teacher import CASES, SEED, _hp_like, _inputs
from test_torch_helpers import load_from_flax, t

SHARE_OF_GAP = 0.25
_DIFF_CONDS = ("keys", "mem1", "mem2", "spk")


def _relative(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_run(case, weights, conds, feeds, cot, bf16: bool):
    """(features, alignments, {leaf: gradient}) of the JAX kernels in one io type."""
    hp_like = dict(_hp_like(case), io_dtype="bfloat16" if bf16 else "float32")
    io = jnp.bfloat16 if bf16 else jnp.float32
    diff = {k: jnp.asarray(v, io if k in ("keys", "mem1", "mem2") else jnp.float32)
            for k, v in conds.items() if v is not None and k in _DIFF_CONDS}

    def loss(w, c, f):
        out = jax_teacher.teacher_decode(
            weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c.get("mem2"),
            score_bias=jnp.asarray(conds["score_bias"]), spk=c.get("spk"), feeds=f,
            seed=jnp.asarray(SEED, jnp.int32), hp_like=hp_like, interpret=True,
        )
        return jnp.sum(out[0] * cot["features"]) + jnp.sum(out[1] * cot["aligns"]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, weights), diff, jnp.asarray(feeds)
    )
    leaves = {f"w:{k}": v for k, v in grads[0].items() if k not in ("w_lsW", "ls_bias")}
    leaves.update({f"c:{k}": v for k, v in grads[1].items()})
    leaves["feeds"] = grads[2]
    return _f32(out[0]), _f32(out[1]), {k: _f32(v) for k, v in leaves.items()}


@functools.lru_cache(maxsize=None)
def _sides(name):
    case = CASES[name]
    weights, conds, feeds, cot = _inputs(case)
    want = _jax_run(case, weights, conds, feeds, cot, bf16=True)
    f32 = _jax_run(case, weights, conds, feeds, cot, bf16=False)

    hp_like = dict(_hp_like(case), io_dtype="bfloat16")
    leaf = lambda x, dtype=torch.float32: torch.tensor(x).to(dtype).requires_grad_(True)  # noqa: E731
    w_t = {k: leaf(v) for k, v in weights.items()}
    c_t = {k: leaf(v, torch.bfloat16 if k != "spk" else torch.float32)
           for k, v in conds.items() if v is not None and k in _DIFF_CONDS}
    f_t = leaf(feeds)
    out = fused_teacher.teacher_decode(
        weights=w_t, keys=c_t["keys"], mem1=c_t["mem1"], mem2=c_t.get("mem2"),
        score_bias=torch.tensor(conds["score_bias"]), spk=c_t.get("spk"), feeds=f_t,
        seed=SEED, hp_like=hp_like,
    )
    loss = (out[0] * torch.tensor(cot["features"])).sum()
    (loss + (out[1] * torch.tensor(cot["aligns"])).sum()).backward()
    types = {"features": out[0].dtype, "aligns": out[1].dtype,
             **{f"c:{k}": v.grad.dtype for k, v in c_t.items()}, "feeds": f_t.grad.dtype,
             **{f"w:{k}": None if v.grad is None else v.grad.dtype for k, v in w_t.items()}}
    grads = {f"w:{k}": v.grad for k, v in w_t.items()}
    grads.update({f"c:{k}": v.grad for k, v in c_t.items()})
    grads["feeds"] = f_t.grad
    got = (_f32(out[0]), _f32(out[1]),
           {k: None if v is None else _f32(v) for k, v in grads.items()})
    return got, want, f32, types


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_teacher_decode_sits_within_a_quarter_of_the_gap(name):
    got, want, f32, types = _sides(name)
    use_ta = CASES[name].get("use_ta", False)
    assert types["features"] == types["aligns"] == torch.float32
    assert types["c:keys"] == types["c:mem1"] == torch.bfloat16
    assert all(v in (None, torch.float32) for k, v in types.items() if k.startswith("w:"))
    rows = []
    for i, label in enumerate(("features", "alignments")):
        rows.append((label, float(np.abs(got[i] - want[i]).max()),
                     float(np.abs(want[i] - f32[i]).max())))
    for key, ref in want[2].items():
        if key in ("w:w_ta", "w:b_ta") and not use_ta:
            assert got[2][key] is None or float(np.abs(got[2][key]).max()) == 0.0
            continue
        rows.append((key, _relative(got[2][key], ref), _relative(ref, f32[2][key])))
    print(f"\nteacher_decode bf16, {name}: leaf, port against JAX bf16, JAX bf16 against f32")
    for key, err, gap in rows:
        print(f"  {key:14s} {err:.3e}  {gap:.3e}")
    for key, err, gap in rows:
        assert gap > 0.0, f"{name}: {key} shows no bfloat16 gap"
        assert err <= SHARE_OF_GAP * gap, f"{name}: {key}: {err:.3e} against a gap of {gap:.3e}"


def test_bf16_gradients_from_rows_round_where_the_kernels_do():
    """``grads_from_rows`` with a bfloat16 gradient row takes the io type from it:
    weight gradients float32 from rounded inputs, keys', memories' and feeds'
    gradients in bfloat16, bias gradients from the float32 running sum."""
    case = CASES["transition_agent_speaker"]
    weights, conds, feeds, _ = _inputs(case, seed=3)
    hp_like = dict(_hp_like(case), io_dtype="bfloat16")
    w = {k: torch.tensor(v) for k, v in weights.items()}
    B, N = feeds.shape[:2]
    x2 = fused_teacher._prenet(w, torch.tensor(feeds), 0.0, None, None, torch.bfloat16)
    keys, mem1, mem2 = (torch.tensor(conds[k]).bfloat16() for k in ("keys", "mem1", "mem2"))
    spk = torch.tensor(conds["spk"])
    z = fused_teacher._sizes(hp_like, w, keys, mem1, mem2, spk, x2)
    S = keys.shape[1]
    layouts = fused_teacher.row_layouts(z, S)
    rng = np.random.default_rng(0)
    carries = torch.tensor(rng.standard_normal((B, N, layouts["carry"][1])), dtype=torch.float32)
    d_brow = torch.tensor(rng.standard_normal((B, layouts["stack"][1])), dtype=torch.float32)
    stack = torch.tensor(rng.standard_normal((B, N, layouts["stack"][1]))).bfloat16()
    aligns = torch.rand(B, N, 2 * S)
    d_keys = torch.randn(B, S, keys.shape[-1])
    got = fused_teacher.grads_from_rows(
        z, True, x2, spk, aligns, carries, stack, d_brow, d_keys,
        torch.randn(B, 2, keys.shape[-1]), torch.randn(B, spk.shape[-1]),
    )
    assert got["keys"].dtype == got["mem1"].dtype == got["feeds"].dtype == torch.bfloat16
    assert all(got[k].dtype == torch.float32 for k in fused_teacher.CORE_WEIGHTS)
    # w_l2: [h1 | h2 of step t-1] against the rounded row, float32 sums of rounded inputs
    cur = fused_teacher._col(carries, layouts["carry"], "h1")
    old = fused_teacher._col(carries, layouts["carry"], "h2")
    old = torch.cat([torch.zeros_like(old[:, :1]), old[:, :-1]], dim=1)
    x = torch.cat([cur, old], dim=-1).bfloat16().float().reshape(B * N, -1)
    g = fused_teacher._col(stack, layouts["stack"], "g_z2").float().reshape(B * N, -1)
    torch.testing.assert_close(got["w_l2"], x.t() @ g, rtol=1e-6, atol=1e-5)
    bias = fused_teacher._col(d_brow, layouts["stack"], "g_z2").sum(dim=0)
    torch.testing.assert_close(got["b_l2"], bias, rtol=0, atol=0)
    torch.testing.assert_close(got["keys"], d_keys.bfloat16(), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# Decoder level
# --------------------------------------------------------------------------- #

B, S, T = 3, 9, 10
LENGTHS = np.array([9, 5, 2], np.int32)
_NARROW = dict(
    decoder="DualSourceSelfAttentionDecoder",
    num_symbols=20, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.0,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    self_attention_drop_rate=0.0,
    decoder_prenet_out_units=(16, 8), decoder_prenet_drop_rate=0.0,
    attention_out_units=16, attention1_out_units=12, attention2_out_units=4,
    decoder_out_units=16, decoder_self_attention_out_units=16,
    decoder_self_attention_drop_rate=0.0, num_mels=6, outputs_per_step=2,
    zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
)
DECODER_CASES = {
    "dual_transition_agent": dict(decoder="DualSourceDecoder",
                                  use_forward_attention_transition_agent=True),
    "single": dict(decoder="ExtendedDecoder"),
}


@functools.lru_cache(maxsize=None)
def _decoder_setup(name):
    kw = dict(_NARROW, **DECODER_CASES[name])
    rng = np.random.default_rng(5)
    source = rng.integers(1, 20, (B, S)).astype(np.int32)
    targets = rng.standard_normal((B, T, 6)).astype(np.float32)
    init_net = JaxNetwork(hparams=JaxHParams(**kw), is_training=True)
    variables = init_net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jnp.asarray(source), jnp.asarray(LENGTHS), jnp.asarray(targets),
        jnp.full((B,), T, jnp.int32),
    )
    variables = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        dict(variables),
    )
    n_src = 1 if kw["decoder"] == "ExtendedDecoder" else 2
    memories = tuple(rng.standard_normal((B, S, 16)).astype(np.float32) for _ in range(n_src))
    mask = np.arange(S)[None, :] < LENGTHS[:, None]
    weights_mel = rng.standard_normal((B, T, 6)).astype(np.float32)
    weights_stop = rng.standard_normal((B, T)).astype(np.float32)
    weights_align = tuple(rng.standard_normal((B, T // 2, S)).astype(np.float32)
                          for _ in range(n_src))
    return kw, variables, memories, mask, targets, (weights_mel, weights_stop, weights_align)


def _jax_decoder_grads(name, dtype):
    """The weighted sum of the JAX decoder's outputs on its fused path, and its
    gradients with respect to the decoder's parameters and the memories."""
    kw, variables, memories, mask, targets, (wm, ws, wa) = _decoder_setup(name)
    jnet = JaxNetwork(hparams=JaxHParams(**dict(kw, compute_dtype=dtype)), is_training=True)
    io = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    masks = tuple(jnp.asarray(mask) for _ in memories)

    def loss(params, mems):
        def decode(m, mems):
            keys = m.decoder.compute_keys(mems)
            cond = JaxConditioning(memories=mems, keys=keys, masks=masks)
            return m.decoder(cond, jnp.asarray(targets))

        frames, stop, aligns, _ = jnet.apply(
            {**variables, "params": params}, mems, method=decode,
            rngs={"dropout": jax.random.PRNGKey(3), "zoneout": jax.random.PRNGKey(4)},
        )
        total = jnp.sum(frames["mel"].astype(jnp.float32) * wm)
        total = total + jnp.sum(stop.astype(jnp.float32) * ws)
        for a, w in zip(aligns, wa):
            total = total + jnp.sum(a.astype(jnp.float32) * w)
        return total

    mems = tuple(jnp.asarray(m, io) for m in memories)
    # operation by operation, as the port's bfloat16 modules round (jitted XLA keeps
    # float32 between fused bfloat16 operations)
    value, (g_params, g_mems) = jax.value_and_grad(loss, argnums=(0, 1))(
        variables["params"], mems)
    flat = {f"params/decoder/{k}": np.asarray(v, np.float32) for k, v in
            flax.traverse_util.flatten_dict(dict(g_params["decoder"]), sep="/").items()}
    flat.update({f"memory{i}": np.asarray(g, np.float32) for i, g in enumerate(g_mems)})
    return float(value), flat


def _port_decoder_grads(name):
    kw, variables, memories, mask, targets, (wm, ws, wa) = _decoder_setup(name)
    hp = HParams(**dict(kw, compute_dtype="bfloat16"))
    port = load_from_flax(TacotronNetwork(hp), variables, hp).train()
    decoder = port.decoder
    assert decoder.fused_teacher_supported() and decoder.compute_dtype == torch.bfloat16
    mems = tuple(t(m).bfloat16().requires_grad_(True) for m in memories)
    keys = decoder.compute_keys(mems)
    cond = DecoderConditioning(memories=mems, keys=keys, masks=tuple(t(mask) for _ in mems))
    feeds = decoder.make_teacher_feeds(t(targets))
    features, aligns = decoder._fused_teacher_call(cond, feeds, None, 0)
    assert features.dtype == torch.bfloat16
    frames, stop, _ = decoder.post(features)
    total = (frames["mel"].float() * t(wm)).sum() + (stop.float() * t(ws)).sum()
    for a, w in zip(aligns, wa):
        total = total + (a.float() * t(w)).sum()
    total.backward()
    total = float(total.detach())
    grads = {f"memory{i}": m.grad.float().numpy() for i, m in enumerate(mems)}
    grads.update({k: np.asarray(v, np.float32) for k, v in
                  convert.torch_to_flax_flat(port, gradients=True).items()})
    return total, grads




@pytest.mark.parametrize("name", sorted(DECODER_CASES))
def test_bf16_decoder_hand_over_sits_within_a_quarter_of_the_gap(name, monkeypatch):
    """Every leaf within a quarter of the gap, but the output projection's bias,
    which the hand-over does not compute: XLA on the CPU sums a bfloat16 bias
    gradient over the (B, N) rows one row at a time in bfloat16, where the port
    sums in float32 and rounds once; that leaf is held to the gap itself."""
    monkeypatch.setattr(jax_teacher, "FORCE_INTERPRET", True)
    calls = []
    original = jax_teacher.teacher_decode

    def spy(**kwargs):
        calls.append(kwargs["hp_like"]["io_dtype"])
        return original(**kwargs)

    monkeypatch.setattr(jax_teacher, "teacher_decode", spy)
    value16, want = _jax_decoder_grads(name, "bfloat16")
    value32, wide = _jax_decoder_grads(name, "float32")
    assert calls == ["bfloat16", "float32"], "the JAX decoder did not take its fused path"
    value, got = _port_decoder_grads(name)
    rows = [("value", abs(value - value16), abs(value16 - value32))]
    for key, ref in want.items():
        if key not in got:
            continue
        rows.append((key, _relative(got[key], ref), _relative(ref, wide[key])))
    compared = [k for k, _, _ in rows]
    assert "memory0" in compared and sum(k.startswith("params/") for k in compared) >= 10
    print(f"\ndecoder bf16 hand-over, {name}: leaf, port against JAX bf16, JAX bf16 against f32")
    for key, err, gap in rows:
        print(f"  {key:60s} {err:.3e}  {gap:.3e}")
    for key, err, gap in rows:
        if gap == 0.0:
            assert err == 0.0, f"{name}: {key}"
            continue
        share = 1.0 if key == "params/decoder/output_projection/bias" else SHARE_OF_GAP
        assert err <= share * gap, f"{name}: {key}: {err:.3e} against a gap of {gap:.3e}"
